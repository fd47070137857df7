#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a)
and runs twenty-one phases; any failure raises, so the exit code is nonzero and
the last line is not the ``ok`` line:

  1. environment: the card's name and power limit, torch/CUDA versions, and
     the kernels' build time;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes of gemma-2b's fused linears and decode step (the dense append
     and attention alone too: bytes exact with a masked row, the fused step
     bitwise equal to the append then the attention), and the three paged
     kernels on a shuffled block pool (pool bytes exact, the fused paged
     step bitwise equal to append-then-attend and to the dense step on the
     same contents), with CUDA-event medians of the kernel, the plain
     version and one library call (rows 3-7 and 9 also their device time
     back to back); the burst append where phase 6's commit runs it, dense
     (8 slots over 1024 positions, a masked slot, rows past the cache's
     end, a block edge) and paged, bytes exact against the same kernel one
     position at a time and the plain version, timed there for rows 5 and
     9's entries in the kernels line (a call, the plain version and the
     bound of the touched blocks' bytes); the GEMV against its mirror
     at bits 2-8, M 1-8, ragged shapes, its bits the same at every M and N,
     and swept over M 1, 4 and 8 at 4, 6 and 8 bits (warm and L2-cold,
     against torch.matmul); the tensor-core GEMM swept over M 32, 128, 256
     and 2560 at 4, 6 and 8 bits (warm and L2-cold, against torch.matmul on
     the dequantized weights, with its ptxas registers and shared memory,
     and the host's time a call at M 128), and where the plan has one CTA walk the K
     ranges, that plan against a cluster of CTAs (bit-equal, both timed);
     the quantized-KV attention split over S (rows 3, 4, 6, 7 and 8) with
     its plan's cluster against one CTA walking the same chunks, dense at S
     512 and 2048 (two rounds of 16 chunks; row 8 at d 512, B 4, 4-bit
     weights, f32 x) and paged at max_seq 1024: outputs and cache bytes
     bit-equal, both timed; rows 3, 4, 6 and 7 also with their device time
     back to back beside SDPA's;
     the fake-quant forward and STE backward at gemma-2b's ``w_gate``
     and tied embedding (per model dimension for the lookup, per vocabulary
     entry for the head), bits 2-8 and 32, f32 and bf16, bytes exact, with
     a call's time and the device time back to back; and
     row 8, the projection-fused step, at gemma-2b's head geometry with d
     512 (B 4 and 8, a position at S), weights 2-8 bits against every state
     width: bit for bit equal to the launches it replaces (the GEMV, the
     torch rotary, the dense step), within tolerance of the plain step run
     on the GEMV's projection and, where no cache byte differs, of its plain
     version; a call and the device time back to back, its and the
     composition's;
  3. full-width gemma-2b in f32: prefill + 8 teacher-forced decode steps
     through the kernels and again through the plain versions, and the
     speculative verify pass against K+1 decode steps;
  4. serving full-width gemma-2b in bf16 (its own dtype) through
     ``ServeEngine``: 8 requests on 4 slots, with the launch counts read
     right after, while the plain versions must show no call;
  5. paged serving of full-width gemma-2b in bf16: 16 chat requests behind
     one 256-token system prompt on 8 slots, through a dense engine and
     three paged ones (unshared, shared, and a 40-block pool under
     backpressure with the invariants checked every step): equal streams,
     sharing and copy-on-write, 18 paged-step launches per decode step;
  6. self-speculative serving of full-width gemma-2b in bf16 from a v6
     policy artifact saved and loaded back (a 4-bit draft at K = 3): the
     chat fleet through a dense engine without speculation and three
     speculative ones (dense, paged, paged over 40 blocks under the
     invariant checker), with acceptance, round times and the launches the
     rounds predict; the paged streams equal the dense speculative ones,
     and those leave the non-speculative streams only at near-ties: where
     a stream parts, the two engines' logits for the two tokens differ by
     no more than the verify pass and the decode steps part on one cache;
  7. the SigmaQuant policy search of full-width gemma-2b in bf16: (a) one
     QAT step's loss and gradients through the kernels and through the
     plain versions, from the same params and batch; (b) the search's main
     path (``launch.search.run``, size_mib <= 1600, 8 pretraining steps, 3
     refinement rounds, seq 64 x batch 8, and the state phase over 4 slots x
     512 positions at a ``state_bytes`` limit of 60 % of the uniform 8-bit
     state) with the controller's trace, each phase's wall time, the QAT
     step median, a profiled step's device-busy and fake-quant shares, peak
     memory and wall time; fake-quant launches exactly 128 per forward and
     255 per training step (its recompute reruns all but the lookup's), STE
     launches 128 per training step, and one fused decode step (row 3)
     per layer for each step of the state env; (c) the artifact saved,
     loaded back, packed with ``quantize_for_serve(artifact)``, checked by
     ``verify_packed_bits`` and served (8 requests) by
     ``ServeEngine(artifact=)`` on its own searched state
     (``verify_state_bits``); (d) the search once more from the same seed,
     and whether its bit vectors (weights and state) agree; (e) the search
     with ``--paged --draft --speculate-k 3``: each phase's wall time and
     iterations, the draft
     env's GEMM and GEMV launches as its steps predict, the v6 artifact
     (state policy, pool, draft policy, K) saved, loaded, packed and served
     to (c)'s requests dense and paged, speculating from the artifact:
     launches as the rounds predict, plain calls 0, the state bits the
     artifact's, paged streams equal to dense ones, predicted against served
     acceptance;
  8. (a) the f32 serving path through row 8: gemma-2b with d_model cut to
     512 (the widest its gate takes), 8 requests of 8-200 prompt tokens on
     4 slots, 32 new each: row 8 launched 18 times per decode step, no
     dense step and no ``wqkv`` GEMV, no plain call, and streams and final
     cache bytes equal to the same engine with ``fuse_projections=False``;
     (b) chunked prefill at full width in bf16: 2 prompts of 1536 tokens and
     6 of 16-48 submitted at once on 4 slots, through whole-prompt and
     256-token chunked admission, dense and paged, with short- and
     long-request TTFT, the step median, tok/s, the largest turn's tokens
     against the budget and peak memory; the paged streams equal the dense
     ones, and chunked ones leave whole-prompt ones only at near-ties (phase
     6's criterion, against the logit gap the two admission paths leave on
     one cache); (c) the dense chunked engine streams through ``on_token``
     callbacks and ``poll()``, in the order of the returned streams;
  9. prompts above 2048 tokens, full width in bf16: (a) the flash attention
     at gemma-2b's geometry, B 1, S 4096, causal, f32 and bf16, against the
     direct path on the card, forward and dq, dk, dv, with forward and
     backward times beside SDPA's; (b) a 4096-token prompt and three short
     ones (seed 20) on 4 slots of 4608 positions, whole-prompt (the flash
     prefill, the GEMM at M = 4 x 4096) and 256-token chunked admission,
     dense and paged, as phase 8 (b), with TTFT, step median and peak
     memory; (c) one QAT step's loss and gradients at seq 4096 (or the
     longest of 3072 and 2560 that fits without recompute) through the flash
     path and the fake-quant kernels, the loss in two chunks, once with each
     layer body recomputed in the backward (``remat=True``) and once
     without: loss and gradients equal, both peaks, wall times and launch
     counts (257 and 131 fake-quant, 129 STE), whether the recomputing step
     fits at 4096;
 10. degradation, faults and tracing: (a) phase 6's artifact, paged over
     40 blocks under the checker, the chat fleet at priority 0 and four
     more at priority 2 from turn 4, one fault at each of ``nan_logit``,
     ``nan_logit_draft``, ``append_failure`` and ``pool_exhaustion``, the
     default shed policy: one request failed by each of the first and the
     third, the draft's falling back, a speculation shed and a preemption,
     no priority-2 victim, resume prefixes and untouched streams equal to
     the same engine's fault-free run up to near-ties, no block leaked; (b)
     ``artifact_mismatch`` refuses construction; (c) phase 4's run with
     ``batch_admission=False`` (equal up to near-ties) and under the tracer
     (identical streams, the Chrome trace saved under ``build/`` and
     validated, phase shares, step medians, measured costs and calibration
     ratios against the artifact's shift-add report; four pairs of untraced
     and traced runs for the tracing overhead);
 11. the paper's CNN path: (a) row 10's forward and STE backward on every
     conv (HWIO) and fc shape of resnet_wide, bits 2-8 and 32, f32 and bf16,
     bytes equal to the plain versions; (b) the three committed checkpoints
     ``artifacts/cnn_{mini,small,wide}_s0`` restored through the port's
     ``checkpoint.restore``, shapes, dtypes and devices checked (the loader
     only: they were trained on the JAX task's prototypes); (c)
     ``benchmarks/table1_sigma_kl.py``'s recipe through the port: resnet_mini
     pretrained 400 steps on the port's own image task (64 classes, noise
     2.2, seed 1), then the controller at top-1 >= 0.88 and size <= 0.55 x
     the int8 MiB: each layer's final bits, sigma and D_KL beside
     ``artifacts/bench/table1.json``'s, spearman(sigma, bits), the final
     top-1, the wall time and QAT step median, fake-quant launches exactly
     10 a forward and STE launches 10 a training step;
 12. the rest of the search and the trainer, at gemma-2b's full width: (a)
     ``launch.search.main`` with phase 7's settings and the state phase, the
     latency limit (0.6 x the uniform 8-bit policy's roofline latency) in the
     size limit's place, ``--backend roofline --decode-batch 4 --trace
     --ckpt``: each phase's wall time, the artifact's roofline latency and
     memory terms, the trace validated with its event count and attributed
     share, the launches the run predicts; the checkpoint's bytes, save and
     restore seconds, its artifact equal to ``--out``'s, its params packed
     and served to phase 7 (c)'s requests, the measured decode step beside
     the roofline's (a calibration ratio, not gated); the checkpoint
     removed; (b) ``launch.report.render_report`` from that artifact alone,
     saved under ``build/`` with its budget, policy and phase sections; (c)
     ``launch.train.main`` on gemma-2b cut to 2 layers (the tied 256000 x
     2048 embedding stays), 8 steps of 8 x 128 at 4 bits, a save every 4
     (keep 1): the step median, fake-quant launches 31 a step (16 a forward,
     15 recomputed) and STE launches 16; then
     the same run through ``TrainLoop`` failing at step 5, which restores
     step 3 and replays: params and optimizer state bit for bit the clean
     run's; (d) ``bop_greedy_policy`` and ``uniform_policy`` on gemma-2b's
     registry, ``hutchinson_layer_traces`` (2 samples) on (c)'s model and
     ``hawq_proxy_policy`` at 0.6 x its 8-bit size (time, peak memory), and
     ``calibrate`` on layer 0's ``w_down`` input at batch 8 x 128 (2^24
     values, ``torch.quantile``'s largest) and 8 x 129 (above it), held to
     numpy's float64 percentile within one order statistic;
 13. deepseek-moe-16b, the MoE family: (a) the expert stacks of the GEMV
     and the GEMM (rows 1e and 2e: one launch for 64 experts) at its
     expert linears (w_gate / w_up: K 2048, N 1408; w_down: K 1408, N
     2048), capacities 8 (the GEMV), 16, 128 and 1280 (the GEMM), bits
     2-8, f32 and bf16: bit for bit equal to the 2-D kernels on every
     expert's slice, within rows 1 and 2's tolerances of the plain
     version, a call, the device time, the plain version, ``torch.bmm``
     on the dequantized bf16 stack and the bound; (b) the full model (28
     layers, 16.9 B parameters, random bf16 weights from the seed) through
     ``launch.serve.main`` under ``--wbits mixed``, packed one stacked leaf
     at a time, a K 8 / V 4 state, phase 4's geometry: step median, TTFT,
     peak memory while packing and serving, packed bytes, launches a
     decode step (three expert GEMVs a layer) and the device-busy share;
     (c) its width cut to 2 layers in f32 through five engines: the
     kernels, the plain versions (streams equal up to near-ties of the
     gap the two leave on one cache), paged, speculative K 2 from a 4-bit
     draft, each run's dropped assignments counted here from the router
     (where capacity drops, the modes may differ: capacity follows the
     batch); (d) the kernel run again, streams and every logits row
     bit-equal;
 14. deepseek-moe-16b's width cut to 2 layers (about 1.6 G parameters):
     (a) one QAT step's loss and gradients in f32 through the kernels, the
     plain versions and the kernels again, every leaf bit-equal, row 10 on
     the (E, K, N) expert stacks as (E*K, N) views (43 fake-quant launches
     a step, 22 of the forward and 21 recomputed, and 22 STE); (b) ``launch.train.main``, 8 steps of 8 x 128 at 4
     bits (the saves skipped: phase 12 holds them), the step median and the
     launches a step; (c) ``launch.search.main`` under ``size_mib=1250``
     (the weight phase, the launches its steps predict), each phase's wall
     and iterations, then its artifact through ``launch.serve.main
     --policy``;
 15. qwen2-vl-2b at full width and depth (28 layers, M-RoPE, untied
     vocabulary 151936): (a) its five packed linears through the GEMV and
     the GEMM against the plain versions, and row 3 at 12 query heads on 2
     KV heads of 128 (a group of 6), bytes exact; (b) ``launch.serve.main
     --wbits mixed`` at phase 4's geometry with a K 8 / V 4 state: step
     median, TTFT, peak memory, packed bytes, the launches a decode step
     and an admission predict, a profiled rerun's busy share; (c)
     ``apply_mrope`` with distinct (t, h, w) positions against its f64
     evaluation, and the served model's prefill from ``embeds=`` equal to
     its token prefill bit for bit;
 16. mamba2-2.7b at full width and depth (64 layers, the SSD scan): (a)
     ``in_proj`` (N 10576), ``out_proj`` and the head (N 50280) against the
     plain versions; (b) as 15 (b), with the recurrent state's bytes a
     slot; (c) its width cut to 2 layers in f32: the kernels against the
     plain versions and chunked admission (the prefix recomputed) against
     whole, streams equal up to near-ties, and a length-1 prompt in a slot
     a longer request left decoding as on a fresh engine;
 17. zamba2-2.7b, the hybrid (54 Mamba2 layers, one shared attention +
     SwiGLU block every 6: 9 applications, 32 heads of 80, a 4096 window):
     (a) its linears (in_proj N 10448, the shared block's, the head) through
     the GEMV and the GEMM; row 3 at 32 KV heads of 80 under the window in
     ``kv_valid``, bytes exact, bit-equal with the rows older than the
     window changed, only the block at ``pos`` requantized; row 8 at the same
     heads, d 512 (bit for bit the launches it replaces) and 2560; (b)
     ``launch.serve.main --wbits mixed`` at full width and depth, phase 4's
     geometry, a K 8 / V 4 state over the 9 entries: launches as predicted
     (the shared block's four linears at each application, row 3 nine
     times a step), the state a slot split into Mamba and KV, a profiled
     rerun; (c) a ``ServeEngine`` in f32 of 2 slots x 4608, a 4161-token
     prompt (the flash prefill under the window) and a short one, 64 new
     tokens, through the kernels and the plain versions (streams up to
     near-ties, first-token logits within rel 1e-2 after 4352-row prefills,
     1e-3 on one state), then on one state a decode step's logits
     bit-equal with the rows older than the window changed and only the
     blocks at ``pos`` requantized; (d) its width cut to 12 layers: one QAT
     step in f32, kernels against plain and again, every leaf bit-equal
     (the shared block recomputed at each of its applications);
     ``launch.train.main`` (8 steps of 8 x 128 at 4 bits);
     ``launch.search.main`` under a size and a state limit, its artifact
     through ``launch.serve.main --policy``;
 18. whisper-tiny at full width and depth (4 + 4 layers, d 384, LayerNorm,
     1500 frames, an untied vocabulary of 51865): (a) its linears (the
     head's odd N included) through the GEMV and the GEMM; (b) packed under
     the mixed policy and fused, ``prefill(tokens, frames)`` at B 4, 32
     greedy tokens through ``decode_step``, kernels against plain versions
     (tokens up to near-ties, logits within rel 5e-2), ``prepare_decode``
     against ``prefill``'s cross K/V, the launches a step, the engine's
     refusal; (c) ``launch.train.main`` (8 steps of 8 x 128 with the frames)
     and ``launch.search.main`` under a size limit, its artifact packed and
     verified, a state limit refused;
 19. the decode-step autotuner (``kernels/autotune.py``) at gemma-2b's state
     geometry (one KV head of 256, block 16): (a) the CUDA candidate (the
     kernel's own launch) of every key at bits 8/8, 8/4, 4/4 and 4/2, dense
     and paged, at S 128 (``autotune_state``'s default 8 blocks), 512 and
     2048 (``autotune_key`` at 32 and 128 blocks), bit for bit against the
     sequential append and attention kernels (outputs and cache bytes), and
     its time; (b) ``launch.search.attach_kernel_configs`` on phase 6's
     artifact without its pool and draft, saved and reloaded, and phase 4's
     geometry (4 slots x 512, bf16, seed 3) served with the tuned table and
     with no table: every served layer's own geometry looks up the tuned
     key (none without the table), identical streams, row 3 launched 576
     times each, the step medians; a traced construction records
     ``kernel_config_replayed``; (c) a table tuned for another
     geometry and a table on a float state refused with ``ArtifactError``,
     a table keyed ``impl="pallas"`` deploys, never matches and gives the
     same streams; (d) ``examples/torch_budget_search_serve.py --tiny
     --paged --speculate``, ``examples/torch_serve_quantized.py`` and
     ``examples/torch_quickstart.py`` on the card, their output under
     ``build/``;
 20. the multi-device layer on one card: (a) ``decoder.prefill_sp`` at
     full width (gemma-2b, 18 layers, bf16, mixed policy) over a 1 x 1
     ``DeviceMesh`` through NCCL (a world of one from a ``FileStore``), B 2
     at 4096 tokens bit for bit against ``prefill`` and at 512 within
     ``SP_DIRECT_REL`` of its direct path, row 2 launched 7 times a layer
     (the wrapper's count and a profile's), both timed; (b) ``python -m
     repro_torch.launch.dryrun`` on the fake world of 256 ranks for
     gemma-2b's and deepseek-moe-16b's decode_32k and whisper-tiny's
     train_4k, each in a bounded subprocess of its own, the three at once,
     each requiring ``1/1 cells OK``, its record and wall time; (c)
     ``examples/torch_elastic_remesh.py`` with its 8 ranks on the card over
     gloo: the backend, the losses, the resume at step 10 on (2, 2);
 21. one ``{"kernels": [...]}`` JSON line (each row's launches summed over
     the main paths that run it), the card's line, and last
     ``{"ok": true, "device": {...}}``.

Phases 5, 6, 8, 10 (c) and 13 hold two engines' streams equal, so their
engines pass a shed policy whose straggler shed cannot fire (it reads the
host clock); phase 6's keeps K fixed as well (its launch counts rest on
it).  Only phase 10 (a) walks the whole ladder.

Every training step recomputes each layer body and each loss chunk in its
backward, as the JAX package's ``jax.checkpoint`` does: its fake-quant
launches are the forward's plus the recomputed regions'
(``_fq_recomputed``: all but the embedding lookup's), its STE launches the
forward's; an evaluation pass launches the forward's.

Weights are random, made from a seeded CUDA generator.  Nothing of JAX is
imported.  Exits 2 without a CUDA device or without the package beside it.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor-core FLOP/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12

ARCH = "gemma-2b"
SEED = 0
#: gemma-2b's fused decode linears: name -> (N, K)
LINEARS = {"wqkv": (2560, 2048), "wo": (2048, 2048), "w_gu": (32768, 2048),
           "w_down": (2048, 16384)}
GEMV_MS = (1, 4, 8)
GEMM_M = 128                      # one admission of 4 prompts padded to 32
#: phase 2's GEMM sweep: verify (32), an admission (128), a chunk (256) and the
#: paged fleet's admission (2560), at the policy's widths; a flush beyond the 50 MB L2
SWEEP_M = (32, 128, 256, 2560)
SWEEP_BITS = (4, 6, 8)
FLUSH_BYTES = 128 << 20
HOST_M = 128                      # where the sweep also times the host's share of a call
SPLIT_MODE_M = (256, 2560, 6144)  # a chunk, the fleet's and the burst's admissions
SERVE_M = 4                       # the serving engine's decode batch (max_slots)
SERVE_SLOTS = 8                   # phases 5 and 6: the chat fleet's slots
SPEC_K = 3                        # phase 6: the draft's burst length
SPEC_M = SERVE_SLOTS * (SPEC_K + 1)   # the verify pass's rows through the GEMM
KV = dict(B=4, n_kv=1, g=8, hd=256, S=512, block=16)
KV_POS = (37, 200, 415, 496)      # last row of a block, first row of one, and between
KV_BITS = ((8, 8), (8, 4), (4, 4), (4, 2))
#: the paged kernels' check: 8 slots over max_seq 1024, a pool of 8 x 64 usable blocks
PG = dict(B=8, n_kv=1, g=8, hd=256, S=1024, block=16, pool=512)
#: write positions on block edges and between; slot 6 is idle (its table row all -1)
PG_POS = (15, 16, 255, 256, 1000, 1023, 500, 600)
PG_IDLE = 6
#: phase 6's commit replay (the burst append): 8 slots over max_seq 1024 at K 8 / V 4
SPEC_KV = dict(B=8, n_kv=1, g=8, hd=256, S=1024, block=16)
#: each slot's burst start (burst index j writes at start + j) and accepted
#: count; slot 2 crosses a block edge, slot 7 accepts nothing and slots 5 and
#: 6 run past S, as idle slots at stale positions do
SPEC_START = (264, 487, 510, 764, 1015, 1021, 1023, 700)
SPEC_ACC = (3, 0, 2, 1, 3, 3, 3, -1)
#: row 8 (the projection-fused step): gemma-2b's head geometry with d cut to 512,
#: the widest the kernel's gate admits; write positions on block edges and at S
PROJ = dict(d=512, n_kv=1, g=8, hd=256, S=512, block=16)
PROJ_POS = {4: (15, 256, 511, 512), 8: (0, 15, 16, 255, 256, 496, 511, 512)}
PROJ_WBITS = (2, 4, 6, 8)
#: time_batch's spin a call for row 8's composition (the GEMV, about ten torch
#: ops of the rotary, row 3): about 1.7 ms at 1.8 GHz, past its host time a call
COMPOSITION_SPIN = int(3e6)
#: phase 2's fake-quant bit-widths (32 is what pretraining passes)
FQ_BITS = (2, 4, 6, 8, 32)
#: phase 7: the search command's arguments (8-bit weights are about 2388 MiB,
#: 4-bit about 1194, so the limit forces mixed bits); ``search_argv`` adds the
#: state phase over STATE_SLOTS x STATE_SEQ, phase 7 (c)'s serving geometry
SEARCH_LIMIT = ["--limit", "size_mib=1600"]
SEARCH_ARGV = ["--arch", ARCH, *SEARCH_LIMIT, "--pretrain-steps", "8",
               "--phase2-iters", "3", "--seq", "64", "--batch", "8", "--seed", str(SEED)]
STATE_SLOTS, STATE_SEQ = 4, 512
#: the state_bytes limit as a share of the uniform 8-bit state (36 entries of
#: 4 x 512 x 256 bytes and their scales, about 18.9 MB): 6 bits pack into the
#: 8-bit container, so only 4- and 2-bit entries pay and the phase must mix
STATE_FRAC = 0.6
#: phase 7 (e): the paged pool and the draft phase on top, at the search's
#: default draft budget (0.6 of the deployed size, predicted acceptance 0.6);
#: 8 calibration prompts keep the draft env's steps on the GEMV (M <= 8)
DRAFT_ARGV = ["--paged", "--draft", "--speculate-k", str(SPEC_K), "--draft-calib", "8"]
REPLACES = {
    "quant_gemv": "src/repro/kernels/quant_gemv/kernel.py:64",
    "quant_matmul": "src/repro/kernels/quant_matmul/kernel.py:68",
    "quant_kv_decode_step": "src/repro/kernels/quant_kv/kernel.py:358",
    "quant_kv_attention_paged": "src/repro/kernels/quant_kv/kernel.py:237",
    "quant_kv_decode_step_paged": "src/repro/kernels/quant_kv/kernel.py:491",
    "quant_kv_append_paged": "src/repro/kernels/quant_kv/kernel.py:737",
    "quant_kv_attention": "src/repro/kernels/quant_kv/kernel.py:103",
    "quant_kv_append": "src/repro/kernels/quant_kv/kernel.py:165",
    "fake_quant": "src/repro/kernels/fake_quant/kernel.py:30",
    "fake_quant_ste_bwd": "src/repro/kernels/fake_quant/ops.py:41",
    "quant_kv_decode_step_proj": "src/repro/kernels/quant_kv/kernel.py:640",
    # quant_gemv_pallas and quant_matmul_pallas under jax.vmap over the experts
    "quant_gemv_experts": "src/repro/kernels/quant_matmul/ops.py:66",
    "quant_matmul_experts": "src/repro/kernels/quant_matmul/ops.py:66",
}
SOURCES = {
    "quant_gemv": "src/repro_torch/csrc/quant_gemv.cu",
    "quant_matmul": "src/repro_torch/csrc/quant_matmul.cu",
    "quant_kv_decode_step": "src/repro_torch/csrc/quant_kv_decode_step.cu",
    "quant_kv_attention_paged": "src/repro_torch/csrc/quant_kv_paged.cu",
    "quant_kv_decode_step_paged": "src/repro_torch/csrc/quant_kv_paged.cu",
    "quant_kv_append_paged": "src/repro_torch/csrc/quant_kv_paged.cu",
    "quant_kv_attention": "src/repro_torch/csrc/quant_kv_dense.cu",
    "quant_kv_append": "src/repro_torch/csrc/quant_kv_dense.cu",
    "fake_quant": "src/repro_torch/csrc/fake_quant.cu",
    "fake_quant_ste_bwd": "src/repro_torch/csrc/fake_quant.cu",
    "quant_kv_decode_step_proj": "src/repro_torch/csrc/quant_kv_proj.cu",
    "quant_gemv_experts": "src/repro_torch/csrc/quant_gemv.cu",
    "quant_matmul_experts": "src/repro_torch/csrc/quant_matmul_experts.cu",
}


def log(*args) -> None:
    print(*args, flush=True)


def rel(out, ref) -> float:
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / (ref.abs().max() + 1e-12))


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, rate: float = BF16_FLOP_S) -> tuple[float, str]:
    """Least time (ms) the card needs: bytes over HBM rate vs ops over the
    peak ``rate`` of their type (bf16 unless said)."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def steady(*, spec_tiers: bool = True):
    """A shed policy whose straggler shed cannot fire: that shed reads the host
    clock, so it could lower K in one engine and not in the twin a phase holds
    it against.  ``spec_tiers=False`` keeps K fixed under pool pressure too."""
    from repro_torch.serve.lifecycle import ShedPolicy

    return ShedPolicy(spec_tiers=spec_tiers, straggler_sheds_spec=False)


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_linears(torch, gen, results: dict) -> None:
    from repro_torch.kernels.quant_gemv.kernel import quant_gemv_cuda
    from repro_torch.kernels.quant_gemv.ref import quant_gemv_ref
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul_cuda
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
    from repro_torch.quant.tensor import quantize_tensor

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    for bits in (4, 6, 8):
        for name, (n, k) in LINEARS.items():
            w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
            qt = quantize_tensor(w, bits)
            del w
            packed, scale = qt.packed, qt.scale
            cases = [("quant_gemv", m, quant_gemv_cuda, quant_gemv_ref) for m in GEMV_MS]
            cases.append(("quant_matmul", GEMM_M, quant_matmul_cuda, quant_matmul_ref))
            for kern, m, run, ref in cases:
                for dt in (torch.float32, torch.bfloat16):
                    x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
                    got = run(x, packed, scale, bits=bits, k=k)
                    want = ref(x, packed, scale, bits, k)
                    torch.cuda.synchronize()
                    err = rel(got, want)
                    r = results[kern]
                    r["max_abs_err"] = max(r["max_abs_err"],
                                           float((got.float() - want.float()).abs().max()))
                    if not err <= tol[dt]:
                        raise AssertionError(f"{kern} {name} bits={bits} M={m} {dt}: "
                                             f"rel {err:.3g} > {tol[dt]}")
                    if dt is torch.bfloat16 and m in (SERVE_M, GEMM_M):
                        wd = qt.dequantize(dt).T.contiguous()          # (N, K), the yardstick's
                        t_k = time_ms(torch, lambda: run(x, packed, scale, bits=bits, k=k))
                        t_p = time_ms(torch, lambda: ref(x, packed, scale, bits, k))
                        t_l = time_ms(torch, lambda: torch.matmul(x, wd.T))
                        nbytes = packed.numel() + 4 * n + 2 * m * k + 2 * m * n
                        b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
                        log(f"  {kern:13s} {name:6s} N={n:5d} K={k:5d} bits={bits} M={m:3d} bf16: "
                            f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  torch.matmul {t_l:.4f} ms  "
                            f"bound {b_ms:.4f} ms ({b_by})  rel {err:.2e}")
                        if bits == 4:  # the bulk of the "mixed" policy: one layer's four linears
                            for key, val in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                                             ("bytes", nbytes), ("flops", 2.0 * m * n * k)):
                                r[key] += val
                        del wd
            if bits == 4:
                # the same 8 rows through the GEMV and, inside the verify pass's
                # 32 rows, through the GEMM: how far the two kernels' sums differ
                x = torch.randn((SPEC_M, k), generator=gen, device="cuda").to(torch.bfloat16)
                gap = float((quant_gemv_cuda(x[:SERVE_SLOTS], packed, scale, bits=bits, k=k)
                             .float() - quant_matmul_cuda(x, packed, scale, bits=bits, k=k)
                             [:SERVE_SLOTS].float()).abs().max())
                results["gemv_gemm_gap"][name] = gap
                t_v = time_ms(torch, lambda: quant_matmul_cuda(x, packed, scale, bits=bits, k=k))
                t_d = time_ms(torch, lambda: quant_gemv_cuda(x[:SERVE_SLOTS], packed, scale,
                                                             bits=bits, k=k))
                log(f"  GEMV (M={SERVE_SLOTS}) vs GEMM (M={SPEC_M}) on {name} bits=4 bf16, "
                    f"the same rows: max abs difference {gap:.4g}; GEMM {t_v:.4f} ms, "
                    f"GEMV {t_d:.4f} ms")
            log(f"  ok {name} bits={bits}: GEMV M={GEMV_MS} and GEMM M={GEMM_M}, f32 and bf16")
            del qt, packed, scale


def time_batch(torch, fn, reps: int = 10, warmup: int = 2, spin: int = int(2e5)) -> float:
    """Mean CUDA-event time (ms) of ``reps`` back-to-back calls of ``fn``, L2
    as the last call left it (warm).  A spin on the device ahead of them
    (``spin`` cycles a call: 2e5 is about 0.1 ms at 1.8 GHz) lets the host
    queue every launch first, so the device runs them without the gaps of
    the host's launch time; a call whose host time is longer (a composition
    of many launches) needs a longer spin."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cold(torch, fn, flush, reps: int = 10) -> float:
    """Median CUDA-event time (ms) of ``fn`` with the L2 flushed before each
    call (``flush`` is larger than the 50 MB L2), as a decode or verify caller
    finds the weights; the flush runs before the start event."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_host(torch, fn, reps: int = 50) -> float:
    """Host time (ms) one call of ``fn`` takes to return: ``reps`` calls
    queued behind a spin on the device, so that none waits for it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e5) * reps)      # about 0.2 ms a call at 1.8 GHz
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return 1e3 * t


def gemm_build_lines() -> list[str]:
    """The GEMM kernels' ptxas registers, shared memory and spills, one line
    per kernel, from this run's build log (token tile NT, container bits CB,
    f32 or bf16 x).  ptxas sees only static shared memory; the ring is
    dynamic, ``Layout<XF32, NT>::kBytes`` in ``csrc/quant_matmul.cu``."""
    import re

    from repro_torch.kernels import _build
    out, name = [], None
    text = _build.BUILD_INFO.get("log") or (Path(_build.BUILD_INFO["path"]).parent
                                            / "build.log").read_text()
    block = text.split("== quant_matmul.cu")
    for line in (block[1].split("\n== ")[0].splitlines() if len(block) > 1 else []):
        m = re.search(r"quant_matmul_kernelILi(\d+)ELb(\d)ELi(\d+)E", line)
        if m and "Compiling entry" in line:
            name = f"CB={m[1]} {'f32' if m[2] == '1' else 'bf16'} NT={m[3]}"
        elif name and ("registers" in line or "spill" in line or "smem" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def sweep_gemm(torch, gen, aside) -> None:
    """The tensor-core GEMM at the row counts the serving paths give it (M 32:
    the verify pass; 128: an admission; 256: a chunk; 2560: the paged fleet's
    admission) x 4, 6 and 8 bits, bf16 x, summed over one layer's four fused
    linears: the kernel warm (back-to-back launches) and cold (L2 flushed),
    its plain version, and torch.matmul on the dequantized bf16 weights, warm
    and cold, against the bound; at M 128 the host's time a call (its extra
    rows from ``aside``)."""
    from repro_torch.kernels.quant_matmul.kernel import plan, quant_matmul_cuda
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
    from repro_torch.quant.tensor import quantize_tensor

    for line in gemm_build_lines():
        log(f"  ptxas {line}")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for bits in SWEEP_BITS:
        qts = {}
        for name, (n, k) in LINEARS.items():
            qt = quantize_tensor(torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5,
                                 bits)
            qts[name] = (qt.packed, qt.scale, qt.dequantize(torch.bfloat16).T.contiguous())
            del qt
        for m in SWEEP_M:
            tot = dict(kernel=0.0, cold=0.0, plain=0.0, lib=0.0, lib_cold=0.0, bytes=0.0,
                       flops=0.0, host=0.0, host_lib=0.0, host_new=0.0)
            for name, (n, k) in LINEARS.items():
                packed, scale, wd = qts[name]
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                run = lambda: quant_matmul_cuda(x, packed, scale, bits=bits, k=k)  # noqa: E731
                lib_mm = lambda: torch.matmul(x, wd.T)                              # noqa: E731
                err = rel(run(), quant_matmul_ref(x, packed, scale, bits, k))
                if not err <= 2e-2:
                    raise AssertionError(f"GEMM sweep {name} bits={bits} M={m}: rel {err:.3g}")
                t = dict(kernel=time_batch(torch, run), cold=time_cold(torch, run, flush),
                         plain=time_batch(torch, lambda: quant_matmul_ref(x, packed, scale,
                                                                          bits, k), reps=3),
                         lib=time_batch(torch, lib_mm), lib_cold=time_cold(torch, lib_mm, flush))
                if m == HOST_M:
                    # host time a call: the tensor maps come from the wrapper's cache
                    # when x's buffer repeats, and are encoded anew when it moves
                    rows = torch.randn((m + 64, k), generator=aside, device="cuda").to(x.dtype)
                    moved = iter(range(10 ** 9))
                    t.update(host=time_host(torch, run), host_lib=time_host(torch, lib_mm),
                             host_new=time_host(torch, lambda: quant_matmul_cuda(
                                 rows[next(moved) % 64:][:m], packed, scale, bits=bits, k=k)))
                    del rows
                nbytes = packed.numel() + 4 * n + 2 * m * k + 2 * m * n
                for key, val in (*t.items(), ("bytes", nbytes), ("flops", 2.0 * m * n * k)):
                    tot[key] += val
                p = plan(m, n, k, torch.bfloat16)
                b_one, by_one = bound(nbytes, 2.0 * m * n * k)
                log(f"    {name:6s} bits={bits} M={m:4d}: kernel {t['kernel']:.4f} ms "
                    f"(cold {t['cold']:.4f})  torch.matmul {t['lib']:.4f} (cold "
                    f"{t['lib_cold']:.4f})  plain {t['plain']:.4f}  bound {b_one:.4f} "
                    f"({by_one})  nt={p.nt} splits={p.splits} cluster={p.cluster} grid={p.grid}")
                del x
            b_ms, b_by = bound(tot["bytes"], tot["flops"])
            verdict = "no slower" if tot["kernel"] <= tot["lib"] else "SLOWER"
            log(f"  GEMM four linears bits={bits} M={m:4d} bf16: kernel {tot['kernel']:.4f} ms "
                f"warm, {tot['cold']:.4f} cold; torch.matmul {tot['lib']:.4f} warm, "
                f"{tot['lib_cold']:.4f} cold; plain {tot['plain']:.4f}; bound {b_ms:.4f} ms "
                f"({b_by}), {100 * b_ms / tot['kernel']:.1f} % of it warm; kernel {verdict} "
                f"than torch.matmul warm")
            if m == HOST_M:
                log(f"  GEMM four linears bits={bits} M={m:4d}: host time a call, summed: "
                    f"kernel {tot['host']:.4f} ms (x at a new address each call "
                    f"{tot['host_new']:.4f}), torch.matmul {tot['host_lib']:.4f}")
        del qts
    del flush


#: check_gemv: (N, K) of wqkv, w_down and ragged shapes (K 1000: rows not
#: 16-byte aligned, byte loads; K 2080: a short last range; N 2561 and 300:
#: a part tile)
GEMV_CHECK = ((2560, 2048), (2048, 16384), (2561, 1000), (300, 2080))


def check_gemv(torch, results: dict) -> None:
    """Row 1's arithmetic on the card: the kernel against its mirror
    (``ref.quant_gemv_mirror``: the plan's K ranges, each summed exactly and
    added in f32 in order, scale last) and its plain version at bits 2, 4, 6,
    8, M 1-8, f32 and bf16, at GEMV_CHECK's shapes: f32 within rel 1e-5 of
    the mirror, bf16 within one bf16 step of it at 99.9 % of outputs or more,
    both within the family tolerance of the plain version (f32 1e-4, bf16
    2e-2).  And a channel's bits do not depend on M (rows 0..M-1 of one x
    against all 8) or N (the first 1000 channels alone).  Its own generator."""
    from repro_torch.kernels.quant_gemv.kernel import plan, quant_gemv_cuda
    from repro_torch.kernels.quant_gemv.ref import quant_gemv_mirror, quant_gemv_ref
    from repro_torch.quant.tensor import quantize_tensor

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for n, k in GEMV_CHECK:
        for bits in (2, 4, 6, 8):
            qt = quantize_tensor(torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5,
                                 bits)
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((8, k), generator=gen, device="cuda").to(dt)
                y8 = quant_gemv_cuda(x, qt.packed, qt.scale, bits=bits, k=k)
                for m in (1, 4, 8):
                    got = y8 if m == 8 else quant_gemv_cuda(x[:m], qt.packed, qt.scale, bits=bits,
                                                            k=k)
                    if not torch.equal(got, y8[:m]):
                        raise AssertionError(f"GEMV N={n} K={k} bits={bits} {dt}: M={m} moves "
                                             f"the bits of its rows")
                    want = quant_gemv_ref(x[:m], qt.packed, qt.scale, bits, k)
                    err = rel(got, want)
                    if not err <= tol[dt]:
                        raise AssertionError(f"GEMV N={n} K={k} bits={bits} M={m} {dt}: rel "
                                             f"{err:.3g} against the plain version")
                    results["quant_gemv"]["max_abs_err"] = max(
                        results["quant_gemv"]["max_abs_err"],
                        float((got.float() - want.float()).abs().max()))
                n1 = min(n, 1000)
                part = quant_gemv_cuda(x, qt.packed[:n1].contiguous(),
                                       qt.scale.reshape(-1)[:n1].contiguous(), bits=bits, k=k)
                if not torch.equal(part, y8[:, :n1]):
                    raise AssertionError(f"GEMV N={n} K={k} bits={bits} {dt}: N moves the bits")
                mir = quant_gemv_mirror(x, qt.packed, qt.scale, bits, k).float()
                got = y8.float()
                if dt is torch.float32:
                    err = rel(got, mir)
                    if not err <= 1e-5:
                        raise AssertionError(f"GEMV N={n} K={k} bits={bits} f32: rel {err:.3g} "
                                             f"against its mirror")
                else:
                    step = torch.exp2(torch.floor(torch.log2(mir.abs().clamp_min(1e-30))) - 7)
                    err = float(((got - mir).abs() > step).float().mean())
                    if not err <= 1e-3:
                        raise AssertionError(f"GEMV N={n} K={k} bits={bits} bf16: {100 * err:.3f} "
                                             f"% of outputs more than one bf16 step from its "
                                             f"mirror")
                worst[dt] = max(worst[dt], err)
                del x, y8, part, mir, got, want
            del qt
        log(f"  ok GEMV N={n} K={k} (splits {plan(8, n, k).splits}, ranges "
            f"{plan(8, n, k).k_ranges()[:2]}...): bits 2-8, M 1-8, f32 and bf16 within the "
            f"family tolerance of the plain version, the same bits whatever M and N")
    log(f"  ok GEMV against its mirror: f32 rel <= {worst[torch.float32]:.2e} (limit 1e-5), "
        f"bf16 {100 * worst[torch.bfloat16]:.3f} % of outputs beyond one bf16 step (limit 0.1 %)")


#: sweep_gemv: the decode batches (1 slot, the dense engine's 4, the fleet's 8) at
#: the policy's widths, bf16 x, and f32 x at the dense engine's batch
SWEEP_GEMV = [(bits, m, "bf16") for bits in SWEEP_BITS for m in GEMV_MS] + [
    (bits, SERVE_M, "f32") for bits in SWEEP_BITS]


def sweep_gemv(torch, seed: int = SEED + 2, cases=None, check: bool = True) -> dict:
    """The GEMV at the decode batches (M 1, 4, 8) x 4, 6 and 8 bits, bf16 x
    (and f32 x at M 4), summed over one gemma-2b layer's four fused linears:
    the kernel's device time back to back (``time_batch``) and with L2
    flushed before each call (``time_cold``: a layer's packed weights, 55 MB
    at 4 bits, exceed the 50 MB L2, as a decode step finds them), and
    torch.matmul on the dequantized weights in x's type the same two ways,
    against the bound.  Its own generator, so no other check's inputs move.
    ``cases`` (keys "bits/M/dtype") limits the sweep; ``check=False`` skips
    the comparison with the plain version (for timing-only variants).  Returns
    ``{"bits/M/dtype": {kernel, cold, lib, lib_cold, bound, bound_by,
    linears: {name: kernel}}}``."""
    from repro_torch.kernels.quant_gemv.kernel import quant_gemv_cuda
    from repro_torch.kernels.quant_gemv.ref import quant_gemv_ref
    from repro_torch.quant.tensor import quantize_tensor

    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    out = {}
    for bits in SWEEP_BITS:
        qts = {}
        for name, (n, k) in LINEARS.items():
            qt = quantize_tensor(torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5,
                                 bits)
            if cases and not any(c.startswith(f"{bits}/") for c in cases):
                continue
            qts[name] = (qt.packed, qt.scale, {d: qt.dequantize(dt).T.contiguous()
                                               for d, dt in dts.items()})
            del qt
        for b, m, dname in SWEEP_GEMV:
            if b != bits or (cases and f"{bits}/{m}/{dname}" not in cases):
                continue
            dt = dts[dname]
            tot = dict(kernel=0.0, cold=0.0, lib=0.0, lib_cold=0.0, bytes=0.0, flops=0.0)
            each = {}
            for name, (n, k) in LINEARS.items():
                packed, scale, wd = qts[name]
                x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
                run = lambda: quant_gemv_cuda(x, packed, scale, bits=bits, k=k)  # noqa: E731
                lib_mm = lambda: torch.matmul(x, wd[dname].T)                   # noqa: E731
                err = rel(run(), quant_gemv_ref(x, packed, scale, bits, k)) if check else 0.0
                if not err <= (1e-4 if dname == "f32" else 2e-2):
                    raise AssertionError(f"GEMV sweep {name} bits={bits} M={m} {dname}: "
                                         f"rel {err:.3g}")
                t = dict(kernel=time_batch(torch, run, reps=20),
                         cold=time_cold(torch, run, flush),
                         lib=time_batch(torch, lib_mm, reps=20),
                         lib_cold=time_cold(torch, lib_mm, flush))
                act = x.element_size()
                nbytes = packed.numel() + 4 * n + act * (m * k + m * n)
                for key, val in (*t.items(), ("bytes", nbytes), ("flops", 2.0 * m * n * k)):
                    tot[key] += val
                each[name] = t["kernel"]
                del x
            b_ms, b_by = bound(tot["bytes"], tot["flops"])
            out[f"{bits}/{m}/{dname}"] = dict(
                kernel=tot["kernel"], cold=tot["cold"], lib=tot["lib"], lib_cold=tot["lib_cold"],
                bound=b_ms, bound_by=b_by, linears=each)
            log(f"  GEMV four linears bits={bits} M={m} {dname}: kernel {tot['kernel']:.4f} ms "
                f"back to back, {tot['cold']:.4f} cold; torch.matmul {tot['lib']:.4f}, "
                f"{tot['lib_cold']:.4f} cold; bound {b_ms:.4f} ms ({b_by}), "
                f"{100 * b_ms / tot['kernel']:.1f} % of it back to back; by linear "
                + ", ".join(f"{nm} {v:.4f}" for nm, v in each.items()))
        del qts
    del flush
    return out


def compare_split_modes(torch, gen) -> None:
    """Where the plan has each CTA walk its K ranges (many output tiles, short
    ranges: wqkv and wo from a few hundred rows up), the same launch with the
    ranges on a cluster instead, at its natural token tile: the same bits,
    and the two times, interleaved over five rounds (median, min-max).  4-bit
    weights, bf16 and f32 x."""
    import dataclasses as dc

    from repro_torch.kernels.quant_matmul.kernel import TOKEN_TILES, plan, quant_matmul_cuda
    from repro_torch.quant.tensor import quantize_tensor

    for name in ("wqkv", "wo"):
        n, k = LINEARS[name]
        qt = quantize_tensor(torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5, 4)
        for dt in (torch.bfloat16, torch.float32):
            for m in SPLIT_MODE_M:
                p = plan(m, n, k, dt)
                if p.cluster != 1 or p.splits == 1:
                    continue
                tiles = TOKEN_TILES[dt]
                q = dc.replace(p, nt=next((t for t in tiles if t >= m), tiles[-1]),
                               cluster=p.splits)
                x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
                runs = {mode: (lambda lp=lp: quant_matmul_cuda(x, qt.packed, qt.scale, bits=4,
                                                               k=k, launch=lp))
                        for mode, lp in (("one CTA", p), ("cluster", q))}
                if not torch.equal(runs["one CTA"](), runs["cluster"]()):
                    raise AssertionError(f"GEMM split modes differ: {name} M={m} {dt}")
                times = {mode: [] for mode in runs}
                for _ in range(5):
                    for mode, run in runs.items():
                        times[mode].append(time_batch(torch, run))
                log(f"  GEMM split modes {name} bits=4 M={m} {str(dt)[6:]}, splits {p.splits}: "
                    + "; ".join(f"{mode} (nt={lp.nt}) {statistics.median(t):.4f} ms "
                                f"[{min(t):.4f}, {max(t):.4f}]"
                                for (mode, t), lp in zip(times.items(), (p, q)))
                    + "; bit-equal")
                del x
        del qt


#: compare_attend_modes: the dense rows at the decode check's S (8 chunks) and at
#: 2048 (32 chunks: two rounds of a 16-CTA cluster); the paged rows on PG's pool
ATTEND_MODE_S = (512, 2048)


def _attend_mode_runs(torch, gen):
    """compare_attend_modes' launches: (row, S, block, B, the cache, run(layer,
    plan)) for rows 3 and 4 at ATTEND_MODE_S (K 8 / V 4, bf16 q, phase 2's
    write positions scaled to S), rows 6 and 7 on PG's shuffled pool, and row
    8 at PROJ's shapes (B 4, w 4 bits, f32 x) at ATTEND_MODE_S with PROJ_POS[4]
    scaled to S (the last one at S: it writes nothing)."""
    from repro_torch.kernels.quant_kv import kernel as kvk
    from repro_torch.kvcache.cache import init_kv_layer, insert_rows
    from repro_torch.models.layers import rope_freqs
    from repro_torch.quant.tensor import quantize_tensor

    dt, kb, vb = torch.bfloat16, 8, 4
    fields = ("k_packed", "k_scale", "v_packed", "v_scale")
    runs = []
    for s in ATTEND_MODE_S:
        c = dict(KV, S=s)
        pos = torch.tensor([min(p * s // KV["S"], s - 1) for p in KV_POS], dtype=torch.int32,
                           device="cuda")
        layer = init_kv_layer(c["B"], s, c["n_kv"], c["hd"], k_bits=kb, v_bits=vb,
                              block=c["block"], device="cuda")
        rows = torch.randn((2, c["B"], s, c["n_kv"], c["hd"]), generator=gen, device="cuda")
        layer = insert_rows(layer, torch.arange(c["B"], device="cuda"), rows[0].to(dt),
                            rows[1].to(dt), valid_len=pos.long())
        mask = torch.where(torch.arange(s, device="cuda")[None, :] <= pos[:, None].long(),
                           0.0, -1e30).float()
        qg = torch.randn((c["B"], c["n_kv"], c["g"], c["hd"]), generator=gen,
                         device="cuda").to(dt)
        kn, vn = (torch.randn((c["B"], c["n_kv"], c["hd"]), generator=gen, device="cuda").to(dt)
                  for _ in range(2))
        kw = dict(k_bits=kb, v_bits=vb, hd=c["hd"], block=c["block"])
        runs.append(("quant_kv_decode_step", s, c["block"], c["B"], layer,
                     lambda lay, lp, pos=pos, qg=qg, kn=kn, vn=vn, mask=mask, kw=kw:
                     kvk.quant_kv_decode_step_cuda(pos, qg, kn, vn, *(getattr(lay, f)
                                                                      for f in fields),
                                                   mask, **kw, launch=lp)))
        runs.append(("quant_kv_attention", s, c["block"], c["B"], layer,
                     lambda lay, lp, qg=qg, mask=mask, kw=kw: kvk.quant_kv_attention_cuda(
                         qg, *(getattr(lay, f) for f in fields), mask, **kw, launch=lp)))
    c = PG
    pg = _paged_layer(torch, gen, kb, vb)
    pos = torch.tensor(PG_POS, dtype=torch.int32, device="cuda")
    mask = torch.where(torch.arange(c["S"], device="cuda")[None, :] <= pos[:, None].long(),
                       0.0, -1e30).float()
    qg = torch.randn((c["B"], c["n_kv"], c["g"], c["hd"]), generator=gen, device="cuda").to(dt)
    kn, vn = (torch.randn((c["B"], c["n_kv"], c["hd"]), generator=gen, device="cuda").to(dt)
              for _ in range(2))
    kw = dict(k_bits=kb, v_bits=vb, hd=c["hd"], block=c["block"])
    tbl = pg.block_table
    runs.append(("quant_kv_decode_step_paged", c["S"], c["block"], c["B"], pg,
                 lambda lay, lp, pos=pos, qg=qg, kn=kn, vn=vn, mask=mask, kw=kw:
                 kvk.quant_kv_decode_step_paged_cuda(pos, tbl, qg, kn, vn, *(getattr(lay, f)
                                                                            for f in fields),
                                                     mask, **kw, launch=lp)))
    runs.append(("quant_kv_attention_paged", c["S"], c["block"], c["B"], pg,
                 lambda lay, lp, qg=qg, mask=mask, kw=kw: kvk.quant_kv_attention_paged_cuda(
                     tbl, qg, *(getattr(lay, f) for f in fields), mask, **kw, launch=lp)))
    c, b = PROJ, 4
    hq = c["n_kv"] * c["g"]
    wq = quantize_tensor(torch.randn((c["d"], (hq + 2 * c["n_kv"]) * c["hd"]), generator=gen,
                                     device="cuda") / c["d"] ** 0.5, 4)
    x = torch.randn((b, c["d"]), generator=gen, device="cuda")
    for s in ATTEND_MODE_S:
        pos = torch.tensor([p * s // c["S"] for p in PROJ_POS[b]], dtype=torch.int32,
                           device="cuda")
        layer = init_kv_layer(b, s, c["n_kv"], c["hd"], k_bits=kb, v_bits=vb, block=c["block"],
                              device="cuda")
        rows = torch.randn((2, b, s, c["n_kv"], c["hd"]), generator=gen, device="cuda")
        layer = insert_rows(layer, torch.arange(b, device="cuda"), rows[0], rows[1],
                            valid_len=pos.long().clamp(max=s))
        mask = torch.where(torch.arange(s, device="cuda")[None, :] <= pos[:, None].long(),
                           0.0, -1e30).float()
        ang = pos[:, None].float() * rope_freqs(c["hd"], 10_000.0, device="cuda")
        kw = dict(w_bits=4, k_bits=kb, v_bits=vb, n_heads=hq, hd=c["hd"], block=c["block"])
        runs.append(("quant_kv_decode_step_proj", s, c["block"], b, layer,
                     lambda lay, lp, pos=pos, mask=mask, cs=torch.cos(ang), sn=torch.sin(ang),
                     kw=kw:
                     kvk.quant_kv_decode_step_proj_cuda(
                         pos, x, wq.packed, wq.scale.reshape(1, -1), cs, sn,
                         *(getattr(lay, f) for f in fields), mask, **kw, launch=lp)))
    return runs


def compare_attend_modes(torch, gen) -> None:
    """Rows 3, 4, 6, 7 and 8 with their plan's cluster against one CTA walking
    the same chunks (``kernel.walk_plan``): outputs, cache bytes and scales
    bit-equal, and both timed (device time of back-to-back launches, median
    of five interleaved rounds, min-max), at ``_attend_mode_runs``' shapes."""
    from repro_torch.kernels.quant_kv import kernel as kvk

    fields = ("k_packed", "k_scale", "v_packed", "v_scale")
    for name, s, block, b, base, run in _attend_mode_runs(torch, gen):
        p = kvk.attend_plan(name, s, block)
        plans = {"cluster": p, "walk": kvk.walk_plan(p)}
        lays = {mode: _clone(base) for mode in plans}
        outs = {mode: run(lays[mode], lp) for mode, lp in plans.items()}
        torch.cuda.synchronize()
        if not torch.equal(outs["cluster"], outs["walk"]):
            raise AssertionError(f"{name} S={s}: cluster and walk outputs differ by "
                                 f"{float((outs['cluster'] - outs['walk']).abs().max()):.3g}")
        for f in fields:
            if not torch.equal(getattr(lays["cluster"], f), getattr(lays["walk"], f)):
                raise AssertionError(f"{name} S={s}: cluster and walk {f} differ")
        times = {mode: [] for mode in plans}
        for _ in range(5):
            for mode, lp in plans.items():
                times[mode].append(time_batch(torch, lambda lp=lp, lay=lays[mode]: run(lay, lp),
                                              reps=20))
        log(f"  attention modes {name} B={b} S={s} ({p.chunks} chunks of {p.chunk}) k8/v4, "
            f"device ms: "
            + "; ".join(f"{mode} (x{plans[mode].cluster}) {statistics.median(t):.4f} "
                        f"[{min(t):.4f}, {max(t):.4f}]" for mode, t in times.items())
            + "; bit-equal")
        del lays, outs


def _kv_layer(torch, gen, k_bits, v_bits, dt):
    from repro_torch.kvcache.cache import init_kv_layer, insert_rows

    c = KV
    layer = init_kv_layer(c["B"], c["S"], c["n_kv"], c["hd"], k_bits=k_bits, v_bits=v_bits,
                          block=c["block"], device="cuda")
    plen = max(KV_POS)
    k = torch.randn((c["B"], plen, c["n_kv"], c["hd"]), generator=gen, device="cuda").to(dt)
    v = torch.randn((c["B"], plen, c["n_kv"], c["hd"]), generator=gen, device="cuda").to(dt)
    lens = torch.tensor(KV_POS, device="cuda")
    return insert_rows(layer, torch.arange(c["B"], device="cuda"), k, v, valid_len=lens)


def _clone(layer):
    return dataclasses.replace(layer, k_packed=layer.k_packed.clone(),
                               k_scale=layer.k_scale.clone(),
                               v_packed=layer.v_packed.clone(), v_scale=layer.v_scale.clone())


def check_decode_step(torch, gen, results: dict) -> None:
    from repro_torch.core.packing import LANES
    from repro_torch.kernels.quant_kv import ops as kv_ops
    from repro_torch.kernels.quant_kv.kernel import quant_kv_decode_step_cuda
    from repro_torch.kernels.quant_kv.ref import quant_kv_decode_step_ref

    c = KV
    hq = c["n_kv"] * c["g"]
    pos = torch.tensor(KV_POS, dtype=torch.int32, device="cuda")
    valid = torch.arange(c["S"], device="cuda")[None, :] <= pos[:, None].long()
    r = results["quant_kv_decode_step"]
    for k_bits, v_bits in KV_BITS:
        for dt in (torch.float32, torch.bfloat16):
            base = _kv_layer(torch, gen, k_bits, v_bits, dt)
            q = torch.randn((c["B"], hq, c["hd"]), generator=gen, device="cuda").to(dt)
            kn = torch.randn((c["B"], 1, c["n_kv"], c["hd"]), generator=gen,
                             device="cuda").to(dt)
            vn = torch.randn((c["B"], 1, c["n_kv"], c["hd"]), generator=gen,
                             device="cuda").to(dt)
            lk, lp = _clone(base), _clone(base)
            ok_, _ = kv_ops.quant_kv_decode_step(q, lk, pos, kn, vn, valid, impl="cuda",
                                                 out_dtype=torch.float32)
            op_, _ = kv_ops.quant_kv_decode_step(q, lp, pos, kn, vn, valid, impl="torch",
                                                 out_dtype=torch.float32)
            torch.cuda.synchronize()
            for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
                if not torch.equal(getattr(lk, f), getattr(lp, f)):
                    diff = int((getattr(lk, f) != getattr(lp, f)).sum())
                    raise AssertionError(f"decode step ({k_bits},{v_bits}) {dt}: {f} differs "
                                         f"from the plain version in {diff} entries")
            err = rel(ok_, op_)
            r["max_abs_err"] = max(r["max_abs_err"], float((ok_ - op_).abs().max()))
            if not err <= 1e-4:
                raise AssertionError(f"decode step ({k_bits},{v_bits}) {dt}: rel {err:.3g}")
            if dt is torch.bfloat16:
                kd, vd = base.dequantize(dt)                        # (B, S, H, hd)
                kd = kd.transpose(1, 2).repeat_interleave(c["g"], dim=1)
                vd = vd.transpose(1, 2).repeat_interleave(c["g"], dim=1)
                q4 = q[:, :, None, :]
                amask = valid[:, None, None, :]
                sdpa = torch.nn.functional.scaled_dot_product_attention
                # the kernel's own wrapper on operands already in its layouts
                # (ops.quant_kv_decode_step adds the mask and reshapes around it)
                qg = q.reshape(c["B"], c["n_kv"], c["g"], c["hd"])
                mask = torch.where(valid, 0.0, -1e30).float()
                k3, v3 = kn[:, 0].contiguous(), vn[:, 0].contiguous()
                def run_k():
                    return quant_kv_decode_step_cuda(
                        pos, qg, k3, v3, lk.k_packed, lk.k_scale, lk.v_packed, lk.v_scale, mask,
                        k_bits=k_bits, v_bits=v_bits, hd=c["hd"], block=c["block"])

                def run_l():
                    return sdpa(q4, kd, vd, attn_mask=amask)

                t_k = time_ms(torch, run_k)
                t_p = time_ms(torch, lambda: quant_kv_decode_step_ref(q, lp, pos, kn, vn, valid))
                t_l = time_ms(torch, run_l)
                d_k, d_l = time_batch(torch, run_k, reps=20), time_batch(torch, run_l, reps=20)
                hdp = {b: -(-c["hd"] // LANES[b]) for b in (k_bits, v_bits)}
                npos = sum(p + 1 for p in KV_POS)
                nblk = sum(p // c["block"] + 1 for p in KV_POS)
                nbytes = c["n_kv"] * (npos * (hdp[k_bits] + hdp[v_bits]) + 8 * nblk
                                      + c["block"] * (hdp[k_bits] + hdp[v_bits]) * c["B"])
                # bf16 q, new rows and output; the validity at one byte a position
                nbytes += 2 * (2 * q.numel() + kn.numel() + vn.numel()) + valid.numel()
                flops = 4.0 * hq * c["hd"] * npos
                b_ms, b_by = bound(nbytes, flops)
                log(f"  quant_kv_decode_step k{k_bits}/v{v_bits} B={c['B']} S={c['S']} "
                    f"hd={c['hd']} g={c['g']} bf16: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
                    f"sdpa {t_l:.4f} ms  bound {b_ms:.5f} ms ({b_by})  rel {err:.2e}; device "
                    f"time back to back: kernel {d_k:.4f} ms  sdpa {d_l:.4f} ms")
                if (k_bits, v_bits) == (8, 4):       # the serving phase's state bits
                    r.update(ms=t_k, plain_ms=t_p, library_ms=t_l, bytes=nbytes, flops=flops)
            log(f"  ok decode step k{k_bits}/v{v_bits} {dt}: cache bytes and scales exact, "
                f"rel {err:.2e}")
            check_dense_halves(torch, base, q, kn, vn, pos, valid, k_bits, v_bits, dt, results)


def _proj_layer(torch, gen, b: int, k_bits: int, v_bits: int):
    """A dense K/V cache of ``b`` slots whose rows below each slot's write
    position hold quantized random rows."""
    from repro_torch.kvcache.cache import init_kv_layer, insert_rows

    c = PROJ
    layer = init_kv_layer(b, c["S"], c["n_kv"], c["hd"], k_bits=k_bits, v_bits=v_bits,
                          block=c["block"], device="cuda")
    k = torch.randn((b, c["S"], c["n_kv"], c["hd"]), generator=gen, device="cuda")
    v = torch.randn((b, c["S"], c["n_kv"], c["hd"]), generator=gen, device="cuda")
    lens = torch.tensor(PROJ_POS[b], device="cuda").clamp(max=c["S"])
    return insert_rows(layer, torch.arange(b, device="cuda"), k, v, valid_len=lens)


def proj_composition(torch, x, wq, layer, pos, valid, *, n_heads: int, step: str):
    """What row 8 replaces, one launch after another: the fused ``wqkv`` GEMV
    (kernel 1), the rotation in torch as the unfused layer runs it, then the
    dense decode step (kernel 3 for ``step="cuda"``, its plain version for
    ``"torch"``).  Returns the step's output (B, hq, hd) f32."""
    from repro_torch.kernels.quant_gemv.kernel import quant_gemv_cuda
    from repro_torch.kernels.quant_kv import ops as kv_ops
    from repro_torch.models.layers import apply_rope

    b, d = x.shape
    _, _, n_kv, hd = layer.shape
    y = quant_gemv_cuda(x, wq.packed, wq.scale, bits=wq.bits, k=d)[:, None]
    nq = n_heads * hd
    q = y[..., :nq].reshape(b, 1, n_heads, hd)
    k = y[..., nq:nq + n_kv * hd].reshape(b, 1, n_kv, hd)
    v = y[..., nq + n_kv * hd:].reshape(b, 1, n_kv, hd)
    q, k = apply_rope(q, pos[:, None]), apply_rope(k, pos[:, None])
    return kv_ops.quant_kv_decode_step(q, layer, pos, k, v, valid, impl=step,
                                       out_dtype=torch.float32)[0][:, 0]


def check_decode_step_proj(torch, gen, results: dict) -> None:
    """Row 8 at gemma-2b's head geometry with d 512 (B 4 and 8, f32 x), every
    weight width against every state width: against the composition it
    replaces (kernel 1, the torch rotation, kernel 3) cache bytes, scales and
    output bit for bit.  Against the plain decode step run on kernel 1's
    projection (``o_q``, the reference that shares kernel 1's levels) cache
    bytes exact and the output within rel 1e-5 (at slots that attend).
    Against its fully plain version scales within rel 1e-6, and the output
    within rel 1e-5 wherever no cache byte differs; where bytes differ (kernel
    1's f32 sum moved a requantized level at a rounding edge, so the plain
    step attends to another level) that rel and the count of bytes are
    logged.  CUDA-event medians and device time back to back, the kernel's
    and the composition's, at B 4, w 4, K 8 / V 4."""
    from repro_torch.core.packing import LANES
    from repro_torch.kernels.quant_kv import ops as kv_ops
    from repro_torch.kernels.quant_kv.kernel import attend_plan, quant_kv_decode_step_proj_cuda
    from repro_torch.kernels.quant_kv.ref import quant_kv_decode_step_proj_ref
    from repro_torch.models.layers import rope_freqs
    from repro_torch.quant.tensor import quantize_tensor

    c = PROJ
    d, hd, n_kv, g = c["d"], c["hd"], c["n_kv"], c["g"]
    hq = n_kv * g
    n = (hq + 2 * n_kv) * hd
    fields = ("k_packed", "k_scale", "v_packed", "v_scale")
    r = results["quant_kv_decode_step_proj"]
    worst = {"scale": 0.0, "out_q": 0.0, "out": 0.0, "bytes": 0}
    for w_bits in PROJ_WBITS:
        wq = quantize_tensor(torch.randn((d, n), generator=gen, device="cuda") / d ** 0.5,
                             w_bits)
        for b, plist in PROJ_POS.items():
            pos = torch.tensor(plist, dtype=torch.int32, device="cuda")
            valid = torch.arange(c["S"], device="cuda")[None, :] <= pos[:, None].long()
            attends = pos < c["S"]
            x = torch.randn((b, d), generator=gen, device="cuda")
            ang = pos[:, None].float() * rope_freqs(hd, 10_000.0, device="cuda")
            cos, sin = torch.cos(ang), torch.sin(ang)
            for k_bits, v_bits in KV_BITS:
                tag = f"proj w{w_bits} k{k_bits}/v{v_bits} B={b}"
                base = _proj_layer(torch, gen, b, k_bits, v_bits)
                lk, lc, lp, lq = (_clone(base) for _ in range(4))
                o_k, _ = kv_ops.quant_kv_decode_step_proj(
                    x, wq.packed, wq.scale, cos, sin, lk, pos, valid, w_bits=w_bits,
                    n_heads=hq, impl="cuda", out_dtype=torch.float32)
                o_c = proj_composition(torch, x, wq, lc, pos, valid, n_heads=hq, step="cuda")
                o_p, _ = kv_ops.quant_kv_decode_step_proj(
                    x, wq.packed, wq.scale, cos, sin, lp, pos, valid, w_bits=w_bits,
                    n_heads=hq, impl="torch", out_dtype=torch.float32)
                o_q = proj_composition(torch, x, wq, lq, pos, valid, n_heads=hq, step="torch")
                torch.cuda.synchronize()
                for f in fields:
                    if not torch.equal(getattr(lk, f), getattr(lc, f)):
                        raise AssertionError(f"{tag}: {f} differs from the composition in "
                                             f"{int((getattr(lk, f) != getattr(lc, f)).sum())} "
                                             f"entries")
                    if not torch.equal(getattr(lk, f), getattr(lq, f)):
                        raise AssertionError(f"{tag}: {f} differs from the plain step on "
                                             f"kernel 1's projection")
                if not torch.equal(o_k, o_c):
                    raise AssertionError(f"{tag}: output differs from the composition by "
                                         f"{float((o_k - o_c).abs().max()):.3g}")
                nbytes_diff = sum(int((getattr(lk, f) != getattr(lp, f)).sum())
                                  for f in ("k_packed", "v_packed"))
                err_s = max(rel(getattr(lk, f), getattr(lp, f)) for f in ("k_scale", "v_scale"))
                err_q = rel(o_k[attends], o_q[attends])
                err_o = rel(o_k[attends], o_p[attends])
                if not (torch.isfinite(o_k).all() and err_s <= 1e-6 and err_q <= 1e-5):
                    raise AssertionError(f"{tag}: scales rel {err_s:.3g} against the plain "
                                         f"version (limit 1e-6), output rel {err_q:.3g} against "
                                         f"the plain step on kernel 1's projection (limit 1e-5)")
                if nbytes_diff == 0 and not err_o <= 1e-5:
                    raise AssertionError(f"{tag}: output rel {err_o:.3g} against the plain "
                                         f"version, no cache byte apart (limit 1e-5)")
                if nbytes_diff:
                    log(f"  {tag}: {nbytes_diff} cache bytes apart from the plain version "
                        f"(kernel 1's levels), output rel {err_o:.3g} against it, {err_q:.3g} "
                        f"against the plain step on kernel 1's projection")
                if not torch.equal(o_k[~attends], torch.zeros_like(o_k[~attends])):
                    raise AssertionError(f"{tag}: the slot at S attended")
                r["max_abs_err"] = max(r["max_abs_err"],
                                       float((o_k[attends] - o_p[attends]).abs().max()))
                worst.update(scale=max(worst["scale"], err_s), out_q=max(worst["out_q"], err_q),
                             bytes=max(worst["bytes"], nbytes_diff))
                if not nbytes_diff:
                    worst["out"] = max(worst["out"], err_o)
                if (w_bits, b, k_bits, v_bits) != (4, 4, 8, 4):
                    continue
                from repro_torch.kernels.quant_gemv.kernel import quant_gemv_cuda

                mask = torch.where(valid, 0.0, -1e30).float()
                scale2 = wq.scale.reshape(1, -1)
                kw = dict(w_bits=w_bits, k_bits=k_bits, v_bits=v_bits, n_heads=hq, hd=hd,
                          block=c["block"])
                def run_k():
                    return quant_kv_decode_step_proj_cuda(
                        pos, x, wq.packed, scale2, cos, sin, lk.k_packed, lk.k_scale,
                        lk.v_packed, lk.v_scale, mask, **kw)

                def run_c():
                    return proj_composition(torch, x, wq, lc, pos, valid, n_heads=hq,
                                            step="cuda")

                t_k, t_c = time_ms(torch, run_k), time_ms(torch, run_c)
                d_k = time_batch(torch, run_k, reps=20)
                d_c = time_batch(torch, run_c, reps=20, spin=COMPOSITION_SPIN)
                t_p = time_ms(torch, lambda: quant_kv_decode_step_proj_ref(
                    x, wq.packed, scale2, cos, sin, lp, pos, valid, w_bits=w_bits,
                    n_heads=hq))
                t_g = time_ms(torch, lambda: quant_gemv_cuda(x, wq.packed, wq.scale,
                                                             bits=w_bits, k=d))
                hdp = {bb: -(-hd // LANES[bb]) for bb in (k_bits, v_bits)}
                live = [int(p) for p in plist if p < c["S"]]
                npos = sum(p + 1 for p in live)
                nblk = sum(p // c["block"] + 1 for p in live)
                nbytes = (wq.packed.numel() + 4 * n + 4 * b * d + 2 * 4 * b * (hd // 2)
                          + n_kv * (npos * (hdp[k_bits] + hdp[v_bits]) + 8 * nblk
                                    + len(live) * c["block"] * (hdp[k_bits] + hdp[v_bits]))
                          + 4 * b * hq * hd + b * c["S"])
                flops = 2.0 * len(live) * (hq + 2 * n_kv) * hd * d + 4.0 * hq * hd * npos
                b_ms, b_by = bound(nbytes, flops, F32_FLOP_S)
                log(f"  quant_kv_decode_step_proj {tag} d={d} S={c['S']} hd={hd} g={g} f32: "
                    f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  composition (GEMV, rotary, "
                    f"kernel 3) {t_c:.4f} ms, of it the GEMV {t_g:.4f} ms  bound {b_ms:.5f} ms "
                    f"({b_by}); device time back to back: kernel {d_k:.4f} ms  composition "
                    f"{d_c:.4f} ms (plan: a cluster of "
                    f"{attend_plan('quant_kv_decode_step_proj', c['S'], c['block']).cluster})")
                r.update(ms=t_k, device_ms=d_k, plain_ms=t_p, library_ms=None,
                         composition_ms=t_c, bytes=nbytes, flops=flops, rate=F32_FLOP_S)
        del wq
    log(f"  ok row 8 at w {PROJ_WBITS} x k/v {KV_BITS} x B {tuple(PROJ_POS)}: cache bytes, "
        f"scales and output equal to the composition (kernel 1, torch rotary, kernel 3) bit "
        f"for bit; against the plain step on kernel 1's projection cache bytes exact, output "
        f"rel <= {worst['out_q']:.2e} (limit 1e-5); against the plain version scales rel <= "
        f"{worst['scale']:.2e} (limit 1e-6), output rel <= {worst['out']:.2e} where no cache "
        f"byte differs (limit 1e-5), at most {worst['bytes']} cache bytes apart elsewhere")


def _dense_bytes(torch, layer, pos, hq: int, act: int) -> tuple[float, float, float]:
    """Bytes the dense attention and the append (both sides) must move, by
    ``_paged_bytes``' rules, and the attention's operations: the attention
    reads the rows each slot attends to (positions 0..pos) and their blocks'
    scales, bf16 q and output and the validity at one byte a position; the
    append reads the touched block's rows before the write offset, its scale
    and the new row, and writes the block, its scale and reads pos."""
    from repro_torch.core.packing import LANES

    b, s, n_kv, hd = layer.shape
    blk = layer.block
    hdp = {bits: -(-hd // LANES[bits]) for bits in (layer.k_bits, layer.v_bits)}
    p = [int(x) for x in pos.tolist()]
    npos = sum(x + 1 for x in p)
    nblk = sum(x // blk + 1 for x in p)
    attn = (n_kv * (npos * (hdp[layer.k_bits] + hdp[layer.v_bits]) + 8 * nblk)
            + 2 * b * hq * hd * act + b * s)
    append = sum(n_kv * (sum(x % blk for x in p) * hdp[bits] + b * (4 + hd * act + blk * hdp[bits]
                                                                      + 4))
                 for bits in (layer.k_bits, layer.v_bits)) + 4 * b
    return attn, append, 4.0 * hq * hd * npos


def check_dense_halves(torch, base, q, kn, vn, pos, valid, k_bits, v_bits, dt, results) -> None:
    """Kernels 5 and 4 (the dense append and attention alone) against their
    plain versions, with slot 1 masked (pos -1) for the append, and the fused
    step (kernel 3) equal to kernel 5 then kernel 4 bit for bit.  In bf16,
    CUDA-event medians and the bounds."""
    from repro_torch.kernels.quant_kv import kernel as kv_kernel
    from repro_torch.kernels.quant_kv import ops as kv_ops
    from repro_torch.kernels.quant_kv import ref as kv_ref

    c = KV
    fields = ("k_packed", "k_scale", "v_packed", "v_scale")
    tag = f"dense k{k_bits}/v{v_bits} {dt}"
    masked = pos.clone()
    masked[1] = -1
    la, lp = _clone(base), _clone(base)
    kv_ops.quant_kv_append(la, masked, kn, vn, impl="cuda")
    kv_ops.quant_kv_append(lp, masked, kn, vn, impl="torch")
    torch.cuda.synchronize()
    r5 = results["quant_kv_append"]
    for f in fields:
        x, y = getattr(la, f), getattr(lp, f)
        r5["max_abs_err"] = max(r5["max_abs_err"], float((x.float() - y.float()).abs().max()))
        if not torch.equal(x, y):
            raise AssertionError(f"{tag} append: {f} differs from the plain version in "
                                 f"{int((x != y).sum())} entries")
        if not torch.equal(x[1], getattr(base, f)[1]):
            raise AssertionError(f"{tag} append: the masked row's {f} was written")
    ls, fused = _clone(base), _clone(base)
    kv_ops.quant_kv_append(ls, pos, kn, vn, impl="cuda")
    o_s = kv_ops.quant_kv_attention(q, ls, valid, impl="cuda", out_dtype=torch.float32)
    o_k, _ = kv_ops.quant_kv_decode_step(q, fused, pos, kn, vn, valid, impl="cuda",
                                         out_dtype=torch.float32)
    o_f = kv_ops.quant_kv_attention(q, fused, valid, impl="cuda", out_dtype=torch.float32)
    o_p = kv_ops.quant_kv_attention(q, fused, valid, impl="torch", out_dtype=torch.float32)
    torch.cuda.synchronize()
    for f in fields:
        if not torch.equal(getattr(ls, f), getattr(fused, f)):
            raise AssertionError(f"{tag}: fused step's {f} differs from append-then-attend")
    if not (torch.equal(o_s, o_k) and torch.equal(o_f, o_k)):
        raise AssertionError(f"{tag}: fused output differs from append-then-attend")
    err = rel(o_f, o_p)
    r4 = results["quant_kv_attention"]
    r4["max_abs_err"] = max(r4["max_abs_err"], float((o_f - o_p).abs().max()))
    if not err <= 1e-4:
        raise AssertionError(f"{tag} attention: rel {err:.3g} against the plain version")
    log(f"  ok {tag}: append bytes and scales exact (masked row untouched), attention rel "
        f"{err:.2e}; fused = append-then-attend bit for bit")
    if dt is not torch.bfloat16:
        return
    hq = q.shape[1]
    qg = q.reshape(c["B"], c["n_kv"], c["g"], c["hd"])
    mask = torch.where(valid, 0.0, -1e30).float()
    kd, vd = fused.dequantize(dt)                                  # (B, S, H, hd)
    kd = kd.transpose(1, 2).repeat_interleave(c["g"], dim=1)
    vd = vd.transpose(1, 2).repeat_interleave(c["g"], dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    plain = _clone(fused)
    kw = dict(k_bits=k_bits, v_bits=v_bits, hd=c["hd"], block=c["block"])
    def run4():
        return kv_kernel.quant_kv_attention_cuda(qg, fused.k_packed, fused.k_scale,
                                                 fused.v_packed, fused.v_scale, mask, **kw)

    def run_l():
        return sdpa(q[:, :, None, :], kd, vd, attn_mask=valid[:, None, None, :])

    t4 = (time_ms(torch, run4), time_ms(torch, lambda: kv_ref.quant_kv_attention_ref(q, plain,
                                                                                    valid)),
          time_ms(torch, run_l))
    device = {"quant_kv_attention": (time_batch(torch, run4, reps=20),
                                     time_batch(torch, run_l, reps=20))}
    # one decode append (the burst kernel at J = 1), both sides in one
    # launch, against ref.py's append; rows 5 and 9's entries in the kernels
    # line are the burst's, where phase 6 launches it (check_burst)
    zero, k1, v1 = torch.zeros_like(pos), kn.contiguous(), vn.contiguous()

    def run5():
        kv_kernel.quant_kv_append_burst_cuda(pos, zero, k1, v1, fused.k_packed, fused.k_scale,
                                             fused.v_packed, fused.v_scale, k_bits=k_bits,
                                             v_bits=v_bits, hd=c["hd"], block=c["block"])

    t5 = (time_ms(torch, run5), time_ms(torch, lambda: kv_ref.quant_kv_append_ref(plain, pos, kn,
                                                                                 vn)), None)
    device["quant_kv_append"] = (time_batch(torch, run5, reps=20),)
    attn_b, append_b, flops = _dense_bytes(torch, fused, pos, hq, q.element_size())
    for name, (t_k, t_p, t_l), nbytes, fl in (("quant_kv_attention", t4, attn_b, flops),
                                              ("quant_kv_append", t5, append_b, 0.0)):
        b_ms, b_by = bound(nbytes, fl)
        lib = "none" if t_l is None else f"{t_l:.4f} ms"
        dev = "; device time back to back: kernel {:.4f} ms".format(device[name][0])
        if len(device[name]) > 1:
            dev += "  sdpa {:.4f} ms".format(device[name][1])
        log(f"  {name} k{k_bits}/v{v_bits} B={c['B']} S={c['S']} hd={c['hd']} g={c['g']} "
            f"bf16: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  sdpa {lib}  "
            f"bound {b_ms:.6f} ms ({b_by}){dev}")
    if (k_bits, v_bits) == (8, 4):                      # the serving phases' state bits
        results["quant_kv_attention"].update(ms=t4[0], plain_ms=t4[1], library_ms=t4[2],
                                             bytes=attn_b, flops=flops)
    del kd, vd


def _burst_paths(torch, base, start, acc, kb, vb):
    """The burst appended three ways from copies of ``base``: the burst kernel
    (one launch), the same kernel one position at a time (J = 1, the slots
    past their ``acc`` masked by ``acc`` -1: the commit's launches before the
    burst) and the plain version.  Returns the three layers and the two
    kernel paths' device times back to back (ms)."""
    from repro_torch.kernels.quant_kv import ops as kv_ops

    def burst(lay, impl):
        kv_ops.quant_kv_append_burst(lay, start, acc, kb, vb, impl=impl)

    def sequential(lay):
        for j in range(kb.shape[1]):
            kv_ops.quant_kv_append_burst(lay, start + j, torch.where(j <= acc, 0, -1),
                                         kb[:, j:j + 1], vb[:, j:j + 1], impl="cuda")

    lb, ls, lp = _clone(base), _clone(base), _clone(base)
    burst(lb, "cuda")
    sequential(ls)
    burst(lp, "torch")
    torch.cuda.synchronize()
    scratch, plain = _clone(base), _clone(base)
    times = dict(device=time_batch(torch, lambda: burst(scratch, "cuda"), reps=20),
                 sequential=time_batch(torch, lambda: sequential(scratch), reps=20),
                 ms=time_ms(torch, lambda: burst(scratch, "cuda")),
                 plain_ms=time_ms(torch, lambda: burst(plain, "torch")))
    return lb, ls, lp, times


def _burst_bytes(layer, start, acc, j_len: int, act: int) -> float:
    """Bytes one layer's burst append must move, both sides: for every block
    the accepted positions touch (inside [0, S), and mapped where the layer
    is paged), its rows before the first of them and its scale read, the
    block and its scale written, and its table entry read where paged; the
    accepted positions' new rows read; ``start`` and ``acc`` read."""
    from repro_torch.core.packing import LANES
    from repro_torch.kvcache.paged import PagedKVLayer

    paged = isinstance(layer, PagedKVLayer)
    b, s, n_kv, hd = layer.shape
    blk = layer.block
    hdp = [-(-hd // LANES[bits]) for bits in (layer.k_bits, layer.v_bits)]
    table = layer.block_table.tolist() if paged else None
    total = 8.0 * b
    for i, (p0, a) in enumerate(zip(start.tolist(), acc.tolist())):
        ps = [p for p in range(p0, p0 + min(a, j_len - 1) + 1)
              if 0 <= p < s and not (paged and table[i][p // blk] < 0)]
        first = {}                        # touched block -> its first write offset
        for p in ps:
            first.setdefault(p // blk, p % blk)
        for w in hdp:
            total += n_kv * (sum(off * w + 8 + blk * w for off in first.values())
                             + len(ps) * hd * act)
        total += 4 * len(first) if paged else 0
    return total


def _record_burst(results: dict, name: str, layer, start, acc, j_len: int, act: int,
                  times: dict) -> str:
    """Rows 5 and 9's entries in the kernels line: the burst append as phase
    6's commit launches it, one layer, bf16 rows.  Returns the bound's text."""
    nbytes = _burst_bytes(layer, start, acc, j_len, act)
    results[name].update(ms=times["ms"], plain_ms=times["plain_ms"], library_ms=None,
                         bytes=nbytes, flops=0.0)
    b_ms, _ = bound(nbytes, 0.0)
    return (f"call {times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, bound {b_ms:.6f} ms "
            f"(bytes); device time back to back {times['device']:.4f} ms, "
            f"{times['sequential']:.4f} one position at a time")


def check_burst(torch, gen, results: dict) -> None:
    """The speculative commit's burst append (rows 5 and 9's kernels, one
    launch a layer) where phase 6 runs it: dense over 8 slots of max_seq 1024
    at K 8 / V 4 with bf16 rows of a (B, K+1, H, hd) burst (slot 2 crosses a
    block edge, slots 4-6 run past S, slot 7 accepts nothing), and paged on
    phase 2's shuffled pool with the bursts' next blocks mapped (slots 0 and
    2 cross a block edge, slot 6 is idle).  Bytes and scales exactly equal to
    the kernel run one position at a time and to the plain version (paged:
    blocks 1..P-1); every block the accepted positions do not touch, the
    masked slots' included, as before; the dense attention over the result
    within rel 1e-4 of its plain version.  Device time of one layer's burst
    against the positions one at a time, and rows 5 and 9's entries in the
    kernels line: the burst's call and plain times and the bound of the
    bytes it must move.  (Slots 5 and 6 run past S in the dense case
    only.)"""
    from repro_torch.kernels.quant_kv import ops as kv_ops
    from repro_torch.kvcache.cache import init_kv_layer, insert_rows

    c = SPEC_KV
    b, h, hd, s, blk = c["B"], c["n_kv"], c["hd"], c["S"], c["block"]
    dt = torch.bfloat16
    fields = ("k_packed", "k_scale", "v_packed", "v_scale")
    start = torch.tensor(SPEC_START, dtype=torch.int32, device="cuda")
    acc = torch.tensor(SPEC_ACC, device="cuda")
    layer = init_kv_layer(b, s, h, hd, k_bits=8, v_bits=4, block=blk, device="cuda")
    k = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt)
    before = insert_rows(layer, torch.arange(b, device="cuda"), k, v, valid_len=start.long())
    kb = torch.randn((b, SPEC_K + 1, h, hd), generator=gen, device="cuda").to(dt)
    vb = torch.randn((b, SPEC_K + 1, h, hd), generator=gen, device="cuda").to(dt)
    lb, ls, lp, t_dense = _burst_paths(torch, before, start, acc, kb, vb)
    dense_line = _record_burst(results, "quant_kv_append", before, start, acc, kb.shape[1],
                               kb.element_size(), t_dense)
    r5 = results["quant_kv_append"]
    for f in fields:
        x, y, z = getattr(lb, f), getattr(ls, f), getattr(lp, f)
        r5["max_abs_err"] = max(r5["max_abs_err"], float((x.float() - z.float()).abs().max()))
        if not (torch.equal(x, y) and torch.equal(x, z)):
            raise AssertionError(f"dense burst: {f} differs from the positions one at a time "
                                 f"in {int((x != y).sum())} entries, from the plain version in "
                                 f"{int((x != z).sum())}")
    touched = torch.zeros((b, s // blk), dtype=torch.bool, device="cuda")
    for i, (p0, a) in enumerate(zip(SPEC_START, SPEC_ACC)):
        for p in range(p0, p0 + a + 1):
            if p < s:
                touched[i, p // blk] = True
    for f in fields:
        x, y = getattr(lb, f), getattr(before, f)
        x, y = x.reshape(b, h, s // blk, -1), y.reshape(b, h, s // blk, -1)
        if not torch.equal(x.transpose(1, 2)[~touched], y.transpose(1, 2)[~touched]):
            raise AssertionError(f"dense burst wrote {f} outside the accepted positions' blocks")
    valid = (torch.arange(s, device="cuda")[None, :]
             <= (start + acc).clamp(max=s - 1)[:, None].long())
    q = torch.randn((b, h * c["g"], hd), generator=gen, device="cuda").to(dt)
    o_c = kv_ops.quant_kv_attention(q, lb, valid, impl="cuda", out_dtype=torch.float32)
    o_p = kv_ops.quant_kv_attention(q, lb, valid, impl="torch", out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = rel(o_c, o_p)
    r4 = results["quant_kv_attention"]
    r4["max_abs_err"] = max(r4["max_abs_err"], float((o_c - o_p).abs().max()))
    if not err <= 1e-4:
        raise AssertionError(f"dense attention at phase 6's shapes: rel {err:.3g}")
    log(f"  ok dense burst at phase 6's shapes (B={b} S={s} hd={hd} k8/v4 bf16, starts "
        f"{SPEC_START}, accepted {SPEC_ACC}): bytes and scales equal to the positions one at a "
        f"time and to the plain version, nothing outside the accepted positions' blocks "
        f"written; attention rel {err:.2e}; one layer's burst: {dense_line}")
    # paged: phase 2's pool from its own generator (no later check's inputs
    # move), the next block of every burst that leaves its block mapped
    pgen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    base = _paged_layer(torch, pgen, 8, 4)
    pc = PG
    tbl = base.block_table.clone()
    free = sorted(set(range(1, pc["pool"])) - set(tbl[tbl >= 0].tolist()))
    pstart = torch.tensor(PG_POS, dtype=torch.int32, device="cuda")
    pacc = torch.tensor(SPEC_ACC, device="cuda").clone()
    pacc[5] = 0        # slot 5 sits at S - 1: paged bursts shrink before max_seq
    for i, (p0, a) in enumerate(zip(PG_POS, pacc.tolist())):
        if i == PG_IDLE:
            continue
        for p in range(p0, min(p0 + a + 1, pc["S"])):
            if tbl[i, p // pc["block"]] < 0:
                tbl[i, p // pc["block"]] = free.pop()
    base.block_table.copy_(tbl)
    kb = torch.randn((pc["B"], SPEC_K + 1, pc["n_kv"], pc["hd"]), generator=pgen,
                     device="cuda").to(dt)
    vb = torch.randn((pc["B"], SPEC_K + 1, pc["n_kv"], pc["hd"]), generator=pgen,
                     device="cuda").to(dt)
    lb, ls, lp, t_paged = _burst_paths(torch, base, pstart, pacc, kb, vb)
    paged_line = _record_burst(results, "quant_kv_append_paged", base, pstart, pacc,
                               kb.shape[1], kb.element_size(), t_paged)
    r9 = results["quant_kv_append_paged"]
    for f in fields:
        x, y, z = getattr(lb, f), getattr(ls, f), getattr(lp, f)
        r9["max_abs_err"] = max(r9["max_abs_err"],
                                float((x[1:].float() - z[1:].float()).abs().max()))
        if not (torch.equal(x, y) and torch.equal(x[1:], z[1:])):
            raise AssertionError(f"paged burst: {f} differs from the positions one at a time "
                                 f"in {int((x != y).sum())} entries, from the plain version in "
                                 f"{int((x[1:] != z[1:]).sum())} (blocks 1..P-1)")
        if not torch.equal(x[0], getattr(base, f)[0]):
            raise AssertionError(f"paged burst wrote {f} into the trash block")
    log(f"  ok paged burst on phase 2's pool (starts {PG_POS}, accepted {pacc.tolist()}, slot "
        f"{PG_IDLE} idle): pool bytes and scales equal to the positions one at a time "
        f"(everywhere) and to the plain version (blocks 1..P-1); one layer's burst: "
        f"{paged_line}")


def _paged_layer(torch, gen, k_bits, v_bits):
    """A paged layer over a pool of random bytes and scales, mapped through a
    shuffled table: slots 2 and 3 share their first 8 blocks (refcount 2),
    slot 4 has one unmapped block inside its valid range, slot 6 is idle."""
    from repro_torch.kvcache.paged import init_paged_layer

    c = PG
    nb = c["S"] // c["block"]
    layer = init_paged_layer(c["pool"], c["B"], c["S"], c["n_kv"], c["hd"], k_bits=k_bits,
                             v_bits=v_bits, block=c["block"], device="cuda")
    for pool, scale in ((layer.k_packed, layer.k_scale), (layer.v_packed, layer.v_scale)):
        pool.copy_(torch.randint(-128, 128, pool.shape, generator=gen, device="cuda",
                                 dtype=torch.int8))
        scale.copy_(torch.rand(scale.shape, generator=gen, device="cuda") * 0.09 + 0.01)
    ids = iter((torch.randperm(c["pool"], generator=gen, device="cuda") + 1).tolist())
    table = torch.full((c["B"], nb), -1, dtype=torch.int32)
    for b, p in enumerate(PG_POS):
        if b != PG_IDLE:
            table[b, : p // c["block"] + 1] = torch.tensor([next(ids) for _ in
                                                            range(p // c["block"] + 1)])
    table[3, :8] = table[2, :8]
    table[4, 30] = -1
    layer.block_table.copy_(table)
    return layer


def _paged_bytes(torch, layer, pos, valid, hq: int,
                 act: int) -> tuple[float, float, float, float]:
    """Bytes the fused step, its attention half and its append half must move on
    this layer's table with ``act``-byte activations in and out, and the
    attention's operations.  Each input is read once and each output written
    once: a pool row is read where some slot attends to it (a row that two
    slots map is read once), a scale where its block holds such a row, the
    validity at one byte a position; the append reads the touched block's
    rows before the write offset, and only slots whose touched entry is
    mapped read a new row and write a block."""
    from repro_torch.core.packing import LANES

    b, s, n_kv, hd = layer.shape
    blk = layer.block
    tbl = layer.block_table.long()
    p = torch.arange(s, device=tbl.device)
    phys = tbl[:, p // blk]                                        # (B, S)
    seen = valid & (phys >= 0)
    raw = tbl.gather(1, (pos.long() // blk)[:, None])[:, 0]
    writers = raw >= 0
    at_pos = (p[None, :] == pos.long()[:, None]) & writers[:, None]

    def rows_blocks(m):
        return (int((phys * blk + p % blk)[m].unique().numel()), int(phys[m].unique().numel()))

    row = n_kv * sum(-(-hd // LANES[bits]) for bits in (layer.k_bits, layer.v_bits))
    scales = n_kv * 8                                              # K and V, f32
    touched = int(writers.sum())           # a live slot's touched block is its own
    new_rows = 2 * touched * n_kv * hd * act
    q_out = 2 * b * hq * hd * act
    fixed = q_out + tbl.numel() * 4 + valid.numel()
    r_all, b_all = rows_blocks(seen)
    r_old, b_old = rows_blocks(seen & ~at_pos)                     # the step writes pos anew
    written = touched * (blk * row + scales)
    attn = r_all * row + b_all * scales + fixed
    step = r_old * row + b_old * scales + fixed + new_rows + written + b * 4
    before = int((pos.long() % blk)[writers].sum())
    append = before * row + touched * scales + new_rows + written + b * 8
    return step, attn, append, 4.0 * hq * hd * int(valid.sum())


def check_paged(torch, gen, results: dict) -> None:
    from repro_torch.kernels.quant_kv import ops as kv_ops
    from repro_torch.kvcache.paged import to_dense

    c = PG
    hq = c["n_kv"] * c["g"]
    pos = torch.tensor(PG_POS, dtype=torch.int32, device="cuda")
    valid = torch.arange(c["S"], device="cuda")[None, :] <= pos[:, None].long()
    live = [b for b in range(c["B"]) if b != PG_IDLE]
    fields = ("k_packed", "k_scale", "v_packed", "v_scale")

    def same(a, b, what, rows=slice(1, None)):
        # block 0 is the trash block: an idle slot's append lands there in the
        # plain version and nowhere on the card, so its bytes are no part of
        # the contract
        for f in fields:
            x, y = getattr(a, f)[rows], getattr(b, f)[rows]
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: {f} differs in {int((x != y).sum())} entries")

    for k_bits, v_bits in KV_BITS:
        for dt in (torch.float32, torch.bfloat16):
            base = _paged_layer(torch, gen, k_bits, v_bits)
            q = torch.randn((c["B"], hq, c["hd"]), generator=gen, device="cuda").to(dt)
            kn, vn = (torch.randn((c["B"], 1, c["n_kv"], c["hd"]), generator=gen,
                                  device="cuda").to(dt) for _ in range(2))
            tag = f"paged k{k_bits}/v{v_bits} {dt}"
            # kernel 7 against its plain version
            lk, lp, ls = _clone(base), _clone(base), _clone(base)
            o_k, _ = kv_ops.quant_kv_decode_step(q, lk, pos, kn, vn, valid, impl="cuda",
                                                 out_dtype=torch.float32)
            o_p, _ = kv_ops.quant_kv_decode_step(q, lp, pos, kn, vn, valid, impl="torch",
                                                 out_dtype=torch.float32)
            torch.cuda.synchronize()
            same(lk, lp, f"{tag} step vs plain")
            err = rel(o_k, o_p)
            if not err <= 1e-4:
                raise AssertionError(f"{tag} step: rel {err:.3g} against the plain version")
            r = results["quant_kv_decode_step_paged"]
            r["max_abs_err"] = max(r["max_abs_err"], float((o_k - o_p).abs().max()))
            # kernel 9 x 2 then kernel 6 equal kernel 7 bit for bit
            kv_ops.quant_kv_append(ls, pos, kn, vn, impl="cuda")
            o_s = kv_ops.quant_kv_attention(q, ls, valid, impl="cuda", out_dtype=torch.float32)
            torch.cuda.synchronize()
            same(lk, ls, f"{tag} fused vs append-then-attend", rows=slice(None))
            if not torch.equal(o_k, o_s):
                raise AssertionError(f"{tag}: fused output differs from append-then-attend")
            # kernel 7 on the pool equals kernel 3 on to_dense of the same pool
            dense = to_dense(base)
            o_d, dense = kv_ops.quant_kv_decode_step(q, dense, pos, kn, vn, valid, impl="cuda",
                                                     out_dtype=torch.float32)
            now = to_dense(lk)
            torch.cuda.synchronize()
            # the idle slot's dense block is written, its paged one is not
            same(now, dense, f"{tag} paged vs dense", rows=live)
            if not torch.equal(o_k[live], o_d[live]):
                raise AssertionError(f"{tag}: paged output differs from the dense kernel's")
            # kernel 6 and kernel 9 alone against their plain versions
            o6 = kv_ops.quant_kv_attention(q, lk, valid, impl="cuda", out_dtype=torch.float32)
            o6p = kv_ops.quant_kv_attention(q, lk, valid, impl="torch", out_dtype=torch.float32)
            la, lap = _clone(base), _clone(base)
            kv_ops.quant_kv_append(la, pos, kn, vn, impl="cuda")
            kv_ops.quant_kv_append(lap, pos, kn, vn, impl="torch")
            torch.cuda.synchronize()
            r9 = results["quant_kv_append_paged"]
            r9["max_abs_err"] = max([r9["max_abs_err"]] + [
                float((getattr(la, f)[1:].float() - getattr(lap, f)[1:].float()).abs().max())
                for f in fields])
            same(la, lap, f"{tag} append vs plain")
            err6 = rel(o6, o6p)
            if not err6 <= 1e-4:
                raise AssertionError(f"{tag} attention: rel {err6:.3g} against the plain version")
            r6 = results["quant_kv_attention_paged"]
            r6["max_abs_err"] = max(r6["max_abs_err"], float((o6 - o6p).abs().max()))
            log(f"  ok {tag}: pool bytes and scales exact at blocks 1..P-1, step rel {err:.2e}, "
                f"attention rel {err6:.2e}; fused = append-then-attend and paged = dense "
                f"bit for bit")
            if dt is torch.bfloat16:
                time_paged(torch, lk, q, kn, vn, pos, valid, k_bits, v_bits, dt, results)


def time_paged(torch, layer, q, kn, vn, pos, valid, k_bits, v_bits, dt, results) -> None:
    """CUDA-event medians of the three paged kernels' wrappers, their plain
    versions, and SDPA on the gathered, dequantized bf16 K/V."""
    from repro_torch.kernels.quant_kv import kernel as kv_kernel
    from repro_torch.kernels.quant_kv import ref as kv_ref
    from repro_torch.kvcache.paged import to_dense

    c = PG
    kw = dict(k_bits=k_bits, v_bits=v_bits, hd=c["hd"], block=c["block"])
    qg = q.reshape(c["B"], c["n_kv"], c["g"], c["hd"])
    mask = torch.where(valid, 0.0, -1e30).float()
    k3, v3 = kn[:, 0].contiguous(), vn[:, 0].contiguous()
    tbl = layer.block_table
    pool = (layer.k_packed, layer.k_scale, layer.v_packed, layer.v_scale)
    plain = _clone(layer)
    kd, vd = to_dense(layer).dequantize(dt)                       # (B, S, H, hd)
    kd = kd.transpose(1, 2).repeat_interleave(c["g"], dim=1)
    vd = vd.transpose(1, 2).repeat_interleave(c["g"], dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_lib = time_ms(torch, lambda: sdpa(q[:, :, None, :], kd, vd,
                                        attn_mask=valid[:, None, None, :]))

    zero = torch.zeros_like(pos)
    k1, v1 = kn.contiguous(), vn.contiguous()

    def append_both():          # one decode append: the burst kernel at J = 1
        kv_kernel.quant_kv_append_burst_paged_cuda(pos, zero, tbl, k1, v1, *pool, **kw)

    def run7():
        return kv_kernel.quant_kv_decode_step_paged_cuda(pos, tbl, qg, k3, v3, *pool, mask, **kw)

    def run6():
        return kv_kernel.quant_kv_attention_paged_cuda(tbl, qg, *pool, mask, **kw)

    d_lib = time_batch(torch, lambda: sdpa(q[:, :, None, :], kd, vd,
                                           attn_mask=valid[:, None, None, :]), reps=20)
    device = {"quant_kv_decode_step_paged": (time_batch(torch, run7, reps=20), d_lib),
              "quant_kv_attention_paged": (time_batch(torch, run6, reps=20), d_lib),
              "quant_kv_append_paged": (time_batch(torch, append_both, reps=20),)}
    times = {
        "quant_kv_decode_step_paged": (
            time_ms(torch, run7),
            time_ms(torch, lambda: kv_ref.quant_kv_decode_step_paged_ref(
                q, plain, pos, kn, vn, valid)), t_lib),
        "quant_kv_attention_paged": (
            time_ms(torch, run6),
            time_ms(torch, lambda: kv_ref.quant_kv_attention_paged_ref(q, plain, valid)),
            t_lib),
        "quant_kv_append_paged": (
            time_ms(torch, append_both),
            time_ms(torch, lambda: kv_ref.quant_kv_append_paged_ref(plain, pos, kn, vn)), None),
    }
    step_b, attn_b, append_b, flops = _paged_bytes(torch, layer, pos, valid, q.shape[1],
                                                   q.element_size())
    sizes = {"quant_kv_decode_step_paged": (step_b, flops),
             "quant_kv_attention_paged": (attn_b, flops), "quant_kv_append_paged": (append_b, 0.0)}
    for name, (t_k, t_p, t_l) in times.items():
        nbytes, fl = sizes[name]
        b_ms, b_by = bound(nbytes, fl)
        lib = "none" if t_l is None else f"{t_l:.4f} ms"
        dev = "; device time back to back: kernel {:.4f} ms".format(device[name][0])
        if len(device[name]) > 1:
            dev += "  sdpa {:.4f} ms".format(device[name][1])
        log(f"  {name} k{k_bits}/v{v_bits} B={c['B']} S={c['S']} hd={c['hd']} g={c['g']} "
            f"bf16: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  sdpa {lib}  "
            f"bound {b_ms:.5f} ms ({b_by}){dev}")
        # row 9's entry is the burst's, where phase 6 launches it (check_burst)
        if (k_bits, v_bits) == (8, 4) and name != "quant_kv_append_paged":
            results[name].update(ms=t_k, plain_ms=t_p, library_ms=t_l, bytes=nbytes, flops=fl)
    del kd, vd


def same_bytes(torch, a, b) -> bool:
    view = torch.int16 if a.dtype is torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def differing_experts(torch, a, b) -> list[int]:
    """The experts (leading index) whose bytes differ between two stacks."""
    view = torch.int16 if a.dtype is torch.bfloat16 else torch.int32
    diff = a.contiguous().view(view) != b.contiguous().view(view)
    return diff.reshape(diff.shape[0], -1).any(-1).nonzero().flatten().tolist()


def check_fake_quant(torch, cfg, gen, results: dict) -> None:
    """Row 10 against its plain versions at gemma-2b's shapes: ``w_gate``
    (d x d_ff, one scale per output column), the tied embedding as the
    lookup fake-quantizes it (one scale per model dimension) and as the head
    does (``emb.T`` from the (V, d) storage, one scale per vocabulary entry):
    bits 2-8 and 32, f32 and bf16, forward and STE backward bytes exactly
    equal.  Times at 4 bits in bf16 (the search's dtype); the library time is
    ``torch.fake_quantize_per_channel_affine`` on the same bf16 weight, which
    multiplies by the reciprocal scale and is not bit-equal, and for the STE
    backward its autograd backward alone."""
    from repro_torch.core.quantizer import qmax, weight_scale
    from repro_torch.kernels.fake_quant.kernel import fake_quant_cuda, fake_quant_ste_bwd_cuda
    from repro_torch.kernels.fake_quant.ref import fake_quant_ref, fake_quant_ste_bwd_ref

    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    cases = (("w_gate", (d, f), False, d ** -0.5), ("embed lookup", (v, d), False, 0.02),
             ("embed head", (v, d), True, 0.02))
    for name, shape, rowwise, std in cases:
        w32 = torch.randn(shape, generator=gen, device="cuda") * std
        g32 = torch.randn(shape, generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            w, g = w32.to(dt), g32.to(dt)
            for bits in FQ_BITS:
                scale = weight_scale(w, bits, channel_axis=0 if rowwise else -1)
                got = fake_quant_cuda(w, scale, bits, rowwise=rowwise)
                ok = same_bytes(torch, got, fake_quant_ref(w, scale, bits))
                del got
                dw = fake_quant_ste_bwd_cuda(w, scale, bits, g, rowwise=rowwise)
                ok = ok and same_bytes(torch, dw, fake_quant_ste_bwd_ref(w, scale, bits, g))
                del dw
                torch.cuda.synchronize()
                if not ok:
                    raise AssertionError(f"fake_quant {name} {tuple(shape)} bits={bits} {dt}: "
                                         f"kernel bytes differ from the plain version")
                if bits != 4 or dt is torch.float32:
                    continue
                n, el = w.numel(), w.element_size()
                zp = torch.zeros(scale.numel(), dtype=torch.int32, device="cuda")
                q = int(qmax(bits))
                t_l = time_ms(torch, lambda: torch.fake_quantize_per_channel_affine(
                    w, scale.reshape(-1), zp, 0 if rowwise else 1, -q, q))
                results["fake_quant"]["library_ms"] += t_l
                # its autograd backward alone, the forward outside the timed window: the
                # gradient through the mask of the rounded value in [-q, q]
                wl = w.detach().clone().requires_grad_(True)
                fq_l = torch.fake_quantize_per_channel_affine(wl, scale.reshape(-1), zp,
                                                              0 if rowwise else 1, -q, q)
                t_lb = time_ms(torch, lambda: torch.autograd.grad(fq_l, wl, g, retain_graph=True))
                results["fake_quant_ste_bwd"]["library_ms"] += t_lb
                del wl, fq_l
                log(f"  fake_quant {name:12s} {tuple(shape)} bits=4 bf16: "
                    f"torch.fake_quantize_per_channel_affine {t_l:.4f} ms, its backward "
                    f"{t_lb:.4f} ms (not bit-equal)")
                def fwd():
                    return fake_quant_cuda(w, scale, bits, rowwise=rowwise)

                def bwd():
                    return fake_quant_ste_bwd_cuda(w, scale, bits, g, rowwise=rowwise)

                times = {
                    "fake_quant": (time_ms(torch, fwd), time_batch(torch, fwd),
                                   time_ms(torch, lambda: fake_quant_ref(w, scale, bits)),
                                   2 * n * el + 4 * scale.numel()),
                    "fake_quant_ste_bwd": (
                        time_ms(torch, bwd), time_batch(torch, bwd),
                        time_ms(torch, lambda: fake_quant_ste_bwd_ref(w, scale, bits, g)),
                        3 * n * el + 4 * scale.numel())}
                for kern, (t_k, d_k, t_p, nbytes) in times.items():
                    b_ms, b_by = bound(nbytes, 0.0)
                    log(f"  {kern:18s} {name:12s} {tuple(shape)} bits=4 bf16: kernel {t_k:.4f} ms"
                        f" (device time back to back {d_k:.4f} ms)  plain {t_p:.4f} ms  bound "
                        f"{b_ms:.4f} ms ({b_by}), {nbytes / t_k / 1e6:.0f} GB/s")
                    r = results[kern]
                    r["ms"] += t_k
                    r["device_ms"] += d_k
                    r["plain_ms"] += t_p
                    r["bytes"] += nbytes
        log(f"  ok fake_quant {name} {tuple(shape)}: forward and STE backward bytes exact, "
            f"bits {FQ_BITS}, f32 and bf16")
        del w32, g32, w, g
        torch.cuda.empty_cache()
    fq, ste = results["fake_quant"], results["fake_quant_ste_bwd"]
    log(f"  row 10 at bits 4 bf16, the three shapes summed: forward {fq['ms']:.4f} ms a call, "
        f"{fq['device_ms']:.4f} ms device time back to back; STE backward {ste['ms']:.4f} and "
        f"{ste['device_ms']:.4f} ms")


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path at full width
# ---------------------------------------------------------------------------


def packed_model(torch, cfg, seed: int):
    """Random full-width weights packed under ``dryrun_policy("mixed")``; the
    float tree is dropped before this returns."""
    from repro_torch.launch.dryrun import dryrun_policy
    from repro_torch.models import decoder
    from repro_torch.quant import apply as qapply

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = decoder.init(cfg, gen, device="cuda")
    policy = dryrun_policy(qapply.layer_specs(params, cfg), "mixed")
    serve = qapply.quantize_for_serve(decoder.unstack_layers(params, cfg), policy, cfg)
    del params
    torch.cuda.empty_cache()
    return serve, policy


def state_policy(cfg, slots: int, seq: int):
    from repro_torch.core.policy import BitPolicy
    from repro_torch.kvcache import state_layer_infos

    infos = state_layer_infos(cfg, slots, seq)
    return BitPolicy.from_bits(infos, {l.name: 8 if l.name.endswith(".k") else 4
                                       for l in infos})


def parity_f32(torch, cfg) -> None:
    from repro_torch.kvcache import insert_state_rows, resolve_state_bits
    from repro_torch.models import decoder
    from repro_torch.quant.apply import fuse_projections

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    serve, _ = packed_model(torch, cfg32, SEED + 1)
    serve = fuse_projections(serve)
    b, seq, steps = 2, 64, 8
    bits = resolve_state_bits(state_policy(cfg32, b, seq), cfg32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab_size, (b, 32), generator=gen, device="cuda")
    lens = torch.tensor([32, 21], device="cuda")
    nxt = torch.randint(0, cfg.vocab_size, (steps, b, 1), generator=gen, device="cuda")
    _, kv = decoder.prefill(serve, cfg32, toks, impl="cuda", logits=False)
    caches = {}
    for impl in ("cuda", "torch"):
        st = decoder.init_cache(cfg32, b, seq, state_bits=bits, device="cuda")
        caches[impl] = insert_state_rows(st, torch.arange(b, device="cuda"), kv, lens)
    worst = 0.0
    for t in range(steps):
        pos = (lens + t).to(torch.int32)
        out = {impl: decoder.decode_step(serve, cfg32, caches[impl], nxt[t], pos,
                                         impl=impl)[0] for impl in ("cuda", "torch")}
        torch.cuda.synchronize()
        err = rel(out["cuda"], out["torch"])
        if not (torch.isfinite(out["cuda"]).all() and err <= 1e-3):
            raise AssertionError(f"f32 full-width decode step {t}: rel {err:.3g}")
        worst = max(worst, err)
    log(f"  ok {cfg.name} f32, {cfg.n_layers} layers: prefill + {steps} decode steps, "
        f"kernels vs plain logits rel <= {worst:.2e} (limit 1e-3)")
    # the verify pass (GEMM over b x (K+1) rows) against K+1 decode steps
    # (GEMV), both through the kernels: in f32 the two compute one function
    burst = torch.randint(0, cfg.vocab_size, (b, SPEC_K + 1), generator=gen, device="cuda")
    pos = lens.to(torch.int32)
    pair = [insert_state_rows(decoder.init_cache(cfg32, b, seq, state_bits=bits, device="cuda"),
                              torch.arange(b, device="cuda"), kv, lens) for _ in range(2)]
    ver, _, _ = decoder.decode_verify(serve, cfg32, pair[0], burst, pos)
    worst = 0.0
    for j in range(SPEC_K + 1):
        step, _ = decoder.decode_step(serve, cfg32, pair[1], burst[:, j:j + 1], pos + j)
        torch.cuda.synchronize()
        err = rel(step[:, 0], ver[:, j])
        if not (torch.isfinite(ver[:, j]).all() and err <= 1e-4):
            raise AssertionError(f"f32 full-width decode_verify position {j}: rel {err:.3g} "
                                 f"against the decode step")
        worst = max(worst, err)
    for x, y in zip(*pair):
        for f in ("k_scale", "v_scale"):
            err = rel(getattr(x, f), getattr(y, f))
            if not err <= 1e-5:
                raise AssertionError(f"f32 full-width decode_verify: cache {f} rel {err:.3g}")
    log(f"  ok {cfg.name} f32: decode_verify (GEMM, M={b * (SPEC_K + 1)}) vs {SPEC_K + 1} "
        f"decode steps (GEMV, M={b}) logits rel <= {worst:.2e} (limit 1e-4), cache scales "
        f"within rel 1e-5")
    del serve, caches, kv, pair, ver, step
    torch.cuda.empty_cache()


def serve_bf16(torch, cfg) -> dict:
    from repro_torch import kernels
    from repro_torch.serve.engine import Request, ServeEngine

    slots, seq, new, n_req = 4, 512, 16, 8
    torch.cuda.reset_peak_memory_stats()
    serve, policy = packed_model(torch, cfg, SEED + 3)
    eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq,
                      state_bits=state_policy(cfg, slots, seq))
    del serve
    log(f"  packed weights {eng.weight_container_bytes() / 1e9:.3f} GB "
        f"(mean {policy.mean_bits():.3f} bits), packed KV state "
        f"{eng.state_container_bytes() / 1e6:.2f} MB")
    gen = torch.Generator().manual_seed(SEED + 4)
    lens = torch.randint(8, 25, (n_req,), generator=gen).tolist()
    reqs = [Request(uid=i, prompt=torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist(),
                    max_new_tokens=new) for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    launches, plain = st["launches"], st["plain_calls"]
    per_linear = 4 * cfg.n_layers
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(quant_gemv=per_linear * st["decode_steps"],
                quant_kv_decode_step=cfg.n_layers * st["decode_steps"],
                quant_matmul=per_linear * st["admissions"])
    if sorted(out) != list(range(n_req)) or any(len(v) != new for v in out.values()):
        raise AssertionError(f"incomplete streams: {[len(v) for v in out.values()]}")
    if not all(0 <= t < cfg.vocab_size for v in out.values() for t in v):
        raise AssertionError("token id out of range")
    if launches != want or any(plain.values()):
        raise AssertionError(f"launches {launches} (want {want}), plain calls {plain}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  ok served {n_req} requests (prompts {min(lens)}-{max(lens)} tokens, {new} new each) "
        f"on {slots} slots: {st['decode_steps']} decode steps, {st['admissions']} admissions")
    log(f"  launches {launches}; plain calls {plain}")
    log(f"  {n_req * new / wall:.2f} tok/s over {wall:.3f} s wall, median decode step "
        f"{st['decode_step_median_s'] * 1e3:.3f} ms, peak allocated {peak / 1e9:.3f} GB")
    profile_steps(torch, eng, reqs[:slots])
    del eng
    torch.cuda.empty_cache()
    return launches


def chat_requests(torch, cfg, n_req: int, new: int) -> list:
    """A fleet of chat requests behind one system prompt: a shared 256-token
    prefix (16 full blocks) plus a private 8-64-token suffix each, except that
    the second request of each wave of 8 repeats the first (a retried
    request), so it shares even its write block and takes a copy-on-write
    split at its first append."""
    from repro_torch.serve.engine import Request

    gen = torch.Generator().manual_seed(SEED + 6)
    prefix = torch.randint(1, cfg.vocab_size, (256,), generator=gen).tolist()
    prompts = []
    for i in range(n_req):
        if i % 8 == 1:
            prompts.append(list(prompts[-1]))
            continue
        n = int(torch.randint(8, 65, (1,), generator=gen))
        prompts.append(prefix + torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist())
    return [Request(uid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]


def serve_paged(torch, cfg) -> dict:
    """Phase 5: the same requests through a dense engine and three paged ones."""
    from repro_torch import kernels
    from repro_torch.serve.engine import ServeEngine

    slots, seq, new, n_req = 8, 1024, 32, 16
    serve, _ = packed_model(torch, cfg, SEED + 5)
    reqs = chat_requests(torch, cfg, n_req, new)
    lens = [len(r.prompt) for r in reqs]
    log(f"  {n_req} requests in two waves of {slots}: prompts {min(lens)}-{max(lens)} tokens "
        f"(one shared 256-token prefix), {new} new tokens each, max_seq {seq}")
    engines = {"a dense": {},
               "b paged, unshared, 512 blocks": dict(paged=True, pool_blocks=512,
                                                     share_prefix=False),
               "c paged, shared, 512 blocks": dict(paged=True, pool_blocks=512),
               "d paged, shared, 40 blocks": dict(paged=True, pool_blocks=40,
                                                  debug_invariants=True)}
    outs, stats, paged_launches = {}, {}, dict.fromkeys(kernels.KERNELS, 0)
    dense_bytes = None
    for key, kw in engines.items():
        # the engines' streams are compared: no straggler shed (it reads the
        # host clock), as in every phase that holds two engines equal
        eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq,
                          state_bits=state_policy(cfg, slots, seq), shed=steady(), **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        peak = torch.cuda.max_memory_allocated()
        launches, plain = st["launches"], st["plain_calls"]
        steps = st["decode_steps"]
        if sorted(out) != list(range(n_req)) or any(len(v) != new for v in out.values()):
            raise AssertionError(f"{key}: incomplete streams {[len(v) for v in out.values()]}")
        if any(plain.values()):
            raise AssertionError(f"{key}: plain calls {plain}")
        step_kernel = "quant_kv_decode_step_paged" if eng.paged else "quant_kv_decode_step"
        other = "quant_kv_decode_step" if eng.paged else "quant_kv_decode_step_paged"
        if launches[step_kernel] != cfg.n_layers * steps or launches[other]:
            raise AssertionError(f"{key}: launches {launches} over {steps} decode steps")
        line = (f"  ok ({key}): {steps} decode steps, {st['admissions']} admissions, "
                f"median decode step {st['decode_step_median_s'] * 1e3:.3f} ms, "
                f"{n_req * new / wall:.2f} tok/s over {wall:.3f} s, peak allocated "
                f"{peak / 1e9:.3f} GB")
        if eng.paged:
            if eng.pool.allocated or eng.pool.reserved:
                raise AssertionError(f"{key}: the pool ends with {eng.pool.allocated} blocks "
                                     f"allocated, {eng.pool.reserved} reserved")
            for name in ("quant_kv_attention_paged", "quant_kv_decode_step_paged",
                         "quant_kv_append_paged"):
                paged_launches[name] += launches[name]
            line += (f"; pool peak {st['pool_peak_allocated']} blocks, shared maps "
                     f"{st['shared_maps']}, copy-on-write {st['cow_copies']}; allocated state "
                     f"{eng.allocated_state_bytes() / 1e6:.3f} MB at peak against the dense "
                     f"container's {dense_bytes / 1e6:.3f} MB")
        else:
            dense_bytes = eng.state_container_bytes()
        log(line)
        log(f"    launches {launches}")
        outs[key], stats[key] = out, st
        if key.startswith("c"):
            profile_steps(torch, eng, reqs[:slots])
        del eng
        torch.cuda.empty_cache()
    a, b, c, d = (outs[k] for k in engines)
    sb, sc, sd = (stats[k] for k in list(engines)[1:])
    if b != a or c != a or d != a:
        diff = [u for u in a if b[u] != a[u] or c[u] != a[u] or d[u] != a[u]]
        raise AssertionError(f"paged streams differ from the dense engine's for uids {diff}")
    if not (sc["shared_maps"] > 0 and sc["cow_copies"] > 0
            and sc["pool_peak_allocated"] < sb["pool_peak_allocated"]):
        raise AssertionError(f"(c) shared {sc['shared_maps']} blocks, copied "
                             f"{sc['cow_copies']}, peak {sc['pool_peak_allocated']} against "
                             f"(b)'s {sb['pool_peak_allocated']}")
    if sd["pool_peak_allocated"] > 40:
        raise AssertionError(f"(d) peak {sd['pool_peak_allocated']} blocks > 40")
    log(f"  ok streams (b) = (c) = (d) = (a); (c) shares and copies on write; (d) completed "
        f"{len(d)} streams in {sd['decode_steps']} decode steps under backpressure with the "
        f"invariants checked every step; every pool ends empty")
    del serve
    torch.cuda.empty_cache()
    return paged_launches


def verify_gap(torch, cfg, serve, reqs, slots: int, seq: int, state) -> float:
    """Largest |logit| difference between ``decode_verify`` (the linears as one
    GEMM over slots x (K+1) rows) and K+1 ``decode_step`` calls (the GEMV) on
    the same cache and burst: how far the two paths' sums may part.  The
    heads of the first ``slots`` requests prefill a dense cache; the burst is
    each request's last prompt token and K random ones.  Phase 3 holds the
    two paths to one function in f32; here each position's logits must also
    agree within rel 5e-2 in bf16 (rounding through 18 layers stays well
    under it, a wrong position, mask or cache write gives order 1), so a
    faulty verify cannot widen the gap it is gated by."""
    from repro_torch.kvcache import insert_state_rows, resolve_state_bits
    from repro_torch.models import decoder
    from repro_torch.quant.apply import fuse_projections

    params = fuse_projections(serve)
    heads = [r.prompt[:-1] for r in reqs[:slots]]
    pad = max(map(len, heads))
    toks = torch.zeros((slots, pad), dtype=torch.int32, device="cuda")
    for i, h in enumerate(heads):
        toks[i, : len(h)] = torch.tensor(h, device="cuda")
    lens = torch.tensor([len(h) for h in heads], device="cuda")
    _, kv = decoder.prefill(params, cfg, toks, logits=False)
    bits = resolve_state_bits(state, cfg)
    caches = [insert_state_rows(decoder.init_cache(cfg, slots, seq, state_bits=bits,
                                                   device="cuda"),
                                torch.arange(slots, device="cuda"), kv, lens) for _ in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    burst = torch.randint(1, cfg.vocab_size, (slots, SPEC_K + 1), generator=gen, device="cuda")
    burst[:, 0] = torch.tensor([r.prompt[-1] for r in reqs[:slots]], device="cuda")
    pos = lens.to(torch.int32)
    ver, _, _ = decoder.decode_verify(params, cfg, caches[0], burst, pos)
    gap = worst = 0.0
    for j in range(SPEC_K + 1):
        step, _ = decoder.decode_step(params, cfg, caches[1], burst[:, j:j + 1], pos + j)
        gap = max(gap, float((step[:, 0].float() - ver[:, j].float()).abs().max()))
        worst = max(worst, rel(ver[:, j], step[:, 0]))
    if not worst <= 5e-2:
        raise AssertionError(f"bf16 decode_verify against the decode steps: rel {worst:.3g}")
    log(f"  verify (GEMM, M={SPEC_M}) vs decode steps (GEMV, M={slots}) on the same cache, "
        f"bf16: logits rel <= {worst:.3g} (limit 5e-2), max |logit difference| {gap:.4g}, "
        f"largest |logit| {float(ver.float().abs().max()):.4g}")
    del params, caches, kv, ver, step
    torch.cuda.empty_cache()
    return gap


def serve_speculative(torch, cfg, linear_gap: dict) -> dict:
    """Phase 6: speculative serving from a saved and reloaded v6 artifact.

    The chat fleet through (a) the dense engine without speculation, (b) the
    dense engine speculating at K = 3 with a uniform 4-bit draft, (c) the
    paged engine with shared prefixes over 512 blocks, speculating, and (d)
    the same over 40 blocks under the invariant checker.  (c) and (d) must
    emit (b)'s streams; (b) may leave (a)'s only at a near-tie, since its
    verify pass sums its linears in the GEMM and (a) in the GEMV.  At every
    first divergence (a)'s logits prefer its token by m_a and (b)'s verify
    logits prefer (b)'s by m_b; m_a + m_b, how far the two paths moved that
    pair of logits, must stay within twice the largest logit difference
    ``verify_gap`` measures between the two paths on one cache (each of the
    two logits may move by that much)."""
    from repro_torch import kernels
    from repro_torch.core.policy import BitPolicy, PolicyArtifact
    from repro_torch.serve.engine import ServeEngine

    slots, seq, new, n_req = SERVE_SLOTS, 1024, 32, 16
    serve, policy = packed_model(torch, cfg, 7)
    specs = policy.layers
    path = ROOT / "build" / "phase6_policy.json"
    path.parent.mkdir(exist_ok=True)
    PolicyArtifact.build(policy, state_policy=state_policy(cfg, slots, seq),
                         pool={"block": 16, "num_blocks": 512},
                         draft_policy=BitPolicy.uniform(specs, 4), draft_k=SPEC_K,
                         meta={"arch": cfg.name, "source": "chip_smoke.py phase 6"}).save(str(path))
    art = PolicyArtifact.load(str(path))
    art.verify_layers(specs)
    if art.version != 6 or art.draft_k != SPEC_K:
        raise AssertionError(f"reloaded artifact v{art.version}, draft_k {art.draft_k}")
    log(f"  artifact v{art.version} saved and reloaded from {path.relative_to(ROOT)}: weights mean "
        f"{art.policy.mean_bits():.3f} bits, K 8 / V 4 state, pool {art.pool}, draft "
        f"{art.draft_policy.mean_bits():.1f} bits at K={art.draft_k}")
    reqs = chat_requests(torch, cfg, n_req, new)
    dense = dataclasses.replace(art, pool=None)
    engines = {"a dense": dict(artifact=dataclasses.replace(dense, draft_policy=None, draft_k=0)),
               "b dense, speculative": dict(artifact=dense),
               "c paged, shared, 512 blocks, speculative": dict(artifact=art),
               "d paged, shared, 40 blocks, speculative": dict(artifact=art, pool_blocks=40,
                                                               debug_invariants=True)}
    outs, runs, rows = {}, {}, {}
    for key, kw in engines.items():
        # K stays at SPEC_K (no shed of either kind): the launches the rounds
        # predict and (d) = (b) rest on it; phase 10 walks the ladder
        eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq,
                          shed=steady(spec_tiers=False), **kw)
        collect = record_logits(torch, eng) if key[0] in "ab" else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        launches, plain = st["launches"], st["plain_calls"]
        if sorted(out) != list(range(n_req)) or any(len(v) != new for v in out.values()):
            raise AssertionError(f"{key}: incomplete streams {[len(v) for v in out.values()]}")
        if any(plain.values()):
            raise AssertionError(f"{key}: plain calls {plain}")
        want = spec_launches(eng, st)
        if launches != want or (eng.speculate and not st["spec_steps"]):
            raise AssertionError(f"{key}: launches {launches}, the rounds predict {want}")
        if collect is not None:
            rows[key[0]] = collect()
        line = (f"  ok ({key}): {len(out)} streams of {new}, {st['decode_steps']} "
                f"{'rounds' if eng.speculate else 'decode steps'}, {st['admissions']} "
                f"admissions, median {'round' if eng.speculate else 'step'} "
                f"{st['decode_step_median_s'] * 1e3:.3f} ms, {n_req * new / wall:.2f} tok/s "
                f"over {wall:.3f} s, peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        if eng.speculate:
            rounds = st["spec_proposed"] / SPEC_K             # slot-rounds of active slots
            line += (f"; acceptance {st['spec_accepted'] / st['spec_proposed']:.4f} "
                     f"({st['spec_accepted']} of {st['spec_proposed']} drafted), "
                     f"{st['spec_accepted'] / st['spec_steps']:.3f} accepted tokens per verify "
                     f"step, {1 + st['spec_accepted'] / rounds:.3f} tokens per slot per verify "
                     f"step")
        if eng.paged:
            if eng.pool.allocated or eng.pool.reserved:
                raise AssertionError(f"{key}: the pool ends with {eng.pool.allocated} blocks "
                                     f"allocated, {eng.pool.reserved} reserved")
            line += (f"; pool peak {st['pool_peak_allocated']} blocks, shared maps "
                     f"{st['shared_maps']}, copy-on-write {st['cow_copies']}, pool ends empty")
        log(line)
        log(f"    launches {launches}")
        outs[key], runs[key] = out, launches
        if key.startswith("b"):
            profile_steps(torch, eng, reqs[:slots])
        del eng
        torch.cuda.empty_cache()
    a, b, c, d = (outs[k] for k in engines)
    if c != b or d != b:
        diff = [u for u in b if c[u] != b[u] or d[u] != b[u]]
        raise AssertionError(f"paged speculative streams differ from (b)'s for uids {diff}")
    gap = verify_gap(torch, cfg, serve, reqs, slots, seq, state_policy(cfg, slots, seq))
    log(f"  phase 2's per-linear GEMV/GEMM gaps "
        f"{ {n: round(v, 5) for n, v in linear_gap.items()} }")
    # (b)'s own top-2 margins, to show how many tokens a gate on them alone
    # would pass at 2 x gap
    top2 = torch.stack([rows["b"][(u, t)] for u in b for t in range(len(b[u]))])
    top2 = torch.topk(top2.float(), 2, dim=-1).values
    every = sorted((top2[:, 0] - top2[:, 1]).tolist())
    inside = sum(m <= 2 * gap for m in every)
    log(f"  verify top-2 margins of (b)'s {len(every)} emitted tokens: min {every[0]:.4g}, "
        f"10th percentile {every[len(every) // 10]:.4g}, median "
        f"{statistics.median(every):.4g}; {inside} ({100 * inside / len(every):.1f}%) "
        f"within 2 x gap = {2 * gap:.4g}")
    # at a first divergence both engines saw the same prefix; (a)'s logits
    # prefer its token by m_a, (b)'s verify logits prefer its own by m_b, so
    # the two paths' logits for that pair of tokens differ by m_a + m_b: a
    # near-tie is one where that stays within 2 x gap (each logit may move
    # by gap), which a fault moving (b) by more than rounding fails
    diverged = 0
    for uid in sorted(a):
        t = next((i for i, (x, y) in enumerate(zip(a[uid], b[uid])) if x != y), None)
        if t is None:
            continue
        diverged += 1
        xa, xb = a[uid][t], b[uid][t]
        la, lb = rows["a"][(uid, t)].float(), rows["b"][(uid, t)].float()
        m_a, m_b = float(la[xa] - la[xb]), float(lb[xb] - lb[xa])
        log(f"    stream {uid}: (b) leaves (a) at token {t} ({xa} -> {xb}): (a) prefers "
            f"{xa} by {m_a:.4g}, (b)'s verify prefers {xb} by {m_b:.4g}, pair moved "
            f"{m_a + m_b:.4g}")
        if m_a < 0 or m_b < 0:
            raise AssertionError(f"stream {uid} token {t}: the kept logits do not rank the "
                                 f"emitted tokens first (m_a {m_a:.4g}, m_b {m_b:.4g})")
        if not m_a + m_b <= 2 * gap:
            raise AssertionError(f"stream {uid} diverges at token {t}: the two paths' logits "
                                 f"for ({xa}, {xb}) differ by {m_a + m_b:.4g} > 2 x {gap:.4g}"
                                 f": not a near-tie")
    log(f"  ok streams (c) = (d) = (b); (b) = (a) in {n_req - diverged} of {n_req} streams, "
        f"every divergence at a near-tie; every pool ends empty")
    del serve
    torch.cuda.empty_cache()
    return runs, gap


def spec_launches(eng, st) -> dict:
    """Launches a run's structure predicts: a decode step is one GEMV per
    packed linear of the deployed tree (4 a layer, fused) and one decode step
    kernel per layer; a speculative round at K is K draft steps (one GEMV per
    packed linear of the draft tree: a group whose members the draft packs
    at different widths stays unfused), one verify (one GEMM per deployed
    linear, one decode step kernel per layer and burst position) and one
    burst append per layer (the commit's replay of the accepted positions,
    both sides); an admission is one GEMM per deployed linear."""
    from repro_torch import kernels

    n = eng.cfg.n_layers
    lin = _packed_linears(eng.params)
    draft = _packed_linears(eng.draft_params) if eng.draft_params is not None else 0
    out = dict.fromkeys(kernels.KERNELS, 0)
    step = "quant_kv_decode_step_paged" if eng.paged else "quant_kv_decode_step"
    append = "quant_kv_append_paged" if eng.paged else "quant_kv_append"
    rounds = st["spec_steps"]
    plain_steps = st["decode_steps"] - rounds
    out["quant_matmul"] = lin * (st["admissions"] + rounds)
    out["quant_gemv"] = lin * plain_steps + draft * SPEC_K * rounds
    out[step] = n * (plain_steps + (2 * SPEC_K + 1) * rounds)
    out[append] = n * rounds
    return out


def record_logits(torch, eng):
    """Wrap the engine so that the logits row behind every token it emits is
    kept on the card: the verify pass's for a speculative round, the decode
    step's for a plain step (a speculative engine takes plain steps where
    the shed ladder sets K to 0).  The returned ``collect()`` maps them to
    ``{(uid, stream index): (V,) logits}``; a resumed request's index counts
    its tokens from before its preemption."""
    calls, rounds = [], []
    in_decode = [False]
    api = eng.api

    def keep(fn, always):
        if fn is None:              # a family without a verify pass (the SSM)
            return None

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if always or in_decode[0]:
                calls.append(out[0])                            # (B, T, V)
            return out
        return wrapped

    def where(active):
        out = {}
        for i in active:
            s = eng.slots[i]
            lc = eng.lifecycles.get(s.req.uid)
            out[i] = (s.req.uid, len(s.generated) + (len(lc.resume_tokens) if lc else 0))
        return out

    spec_step, decode = eng._spec_step, eng._decode

    def note_round(active, *args):
        at = where(active)
        out = spec_step(active, *args)
        rounds.append({i: (uid, start, len(out[0][i])) for i, (uid, start) in at.items()})
        return out

    def note_step(*args):
        at = where(eng._decode_active())
        in_decode[0] = True
        try:
            out = decode(*args)
        finally:
            in_decode[0] = False
        rounds.append({i: (uid, start, 1) for i, (uid, start) in at.items()})
        return out

    def collect() -> dict:
        return {(uid, start + j): logits[i, j]
                for logits, slots in zip(calls, rounds)
                for i, (uid, start, n) in slots.items() for j in range(n)}

    eng._spec_step, eng._decode = note_round, note_step
    eng.api = dataclasses.replace(api, decode_step=keep(api.decode_step, False),
                                  decode_verify=keep(api.decode_verify, True))
    return collect


def profile_steps(torch, eng, reqs):
    """Device time by kernel over a short rerun of ``reqs`` (4 new tokens each),
    and the device's busy share of the wall time, from ``torch.profiler``.
    Only device events (kernels, copies, fills) are summed: an operator's
    own entry repeats the device time of the kernels it launched.  Returns
    the profile (None where it holds no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    short = [dataclasses.replace(r, uid=100 + r.uid, max_new_tokens=4) for r in reqs]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(short)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev, evt.key, evt.count))
    total = sum(r[0] for r in rows)
    if not total:
        log("  profile: no device time in the trace (not measured)")
        return None
    log(f"  profile of {len(short)} requests x 4 tokens: device busy {total / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms wall ({100 * total / wall_us:.1f}%); by kernel:")
    for dev, key, count in sorted(rows, reverse=True)[:10]:
        log(f"    {100 * dev / total:5.1f}%  {dev / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return prof


def profile_admission(torch, eng, cfg) -> dict:
    """Row 2e's device time an admission: 4 prompts of 32 tokens (128 token
    rows, so C 16 in every MoE layer) admitted together under
    ``torch.profiler``, the persistent expert GEMM's kernels read from the
    trace (``build/phase13b_admission_trace.json``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    gen = torch.Generator().manual_seed(SEED + 15)
    reqs = [Request(uid=300 + i, prompt=torch.randint(1, cfg.vocab_size, (32,),
                                                      generator=gen).tolist(),
                    max_new_tokens=2) for i in range(4)]
    before = eng.stats()["admissions"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(reqs)
        torch.cuda.synchronize()
    adm = eng.stats()["admissions"] - before
    path = ROOT / "build" / "phase13b_admission_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    durs = [ev["dur"] for ev in json.loads(path.read_text())["traceEvents"]
            if ev.get("cat") == "kernel" and "quant_matmul_experts_kernel" in ev.get("name", "")]
    ms = sum(durs) / 1e3
    log(f"  row 2e in the profile: {ms:.3f} ms of device time over {len(durs)} launches, "
        f"{adm} admission(s) of 4 x 32 tokens (C 16): {ms / max(adm, 1):.3f} ms an admission")
    return {"row2e_ms": ms, "row2e_launches": len(durs), "row2e_admissions": adm}


def stack_gemv_ms(prof, path: Path) -> tuple[float, int]:
    """Device ms and launches of the GEMV kernel over an expert stack (grid
    z > 1: row 1e, not row 1) in ``prof``, read from its trace's kernel
    events (written to ``path``), whose grids ``key_averages`` drops."""
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    durs = [ev["dur"] for ev in events if ev.get("cat") == "kernel"
            and "quant_gemv_kernel" in ev.get("name", "")
            and ev.get("args", {}).get("grid", [1, 1, 1])[2] > 1]
    return sum(durs) / 1e3, len(durs)


# ---------------------------------------------------------------------------
# phase 7: the policy search at full width
# ---------------------------------------------------------------------------


def _fq_recomputed(cfg, specs, n_chunks: int = 1) -> int:
    """Fake-quant launches the backward's recompute adds to a training step:
    those of the forward inside a checkpointed region, which are all but the
    embedding lookup's: each layer's quantizable weights, the hybrid's shared
    block once at each of its applications, and the head (tied or not) once
    for each of the ``n_chunks`` loss chunks."""
    names = {l.name for l in specs}
    head = "lm_head" in names or (cfg.tie_embeddings and "embed" in names)
    n = len(specs) - ("embed" in names) - ("lm_head" in names) + head * n_chunks
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import n_attn_applications

        n += (n_attn_applications(cfg) - 1) * sum(nm.startswith("shared_attn.") for nm in names)
    return n


def _fq_per_forward(cfg, specs, n_chunks: int = 1) -> int:
    """Fake-quant launches one forward pass from tokens makes (and STE
    launches one backward makes): the recomputed regions' once
    (``_fq_recomputed``), and the embedding lookup's."""
    return _fq_recomputed(cfg, specs, n_chunks) + any(l.name == "embed" for l in specs)


def qat_step_parity(torch, cfg) -> None:
    """Phase 7 (a): one QAT step's loss and gradients from the same params and
    batch, through the kernels, through the plain versions, and through the
    kernels again (to see whether the backward is deterministic)."""
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import TokenTask, global_batch
    from repro_torch.launch.dryrun import dryrun_policy
    from repro_torch.models import decoder, registry
    from repro_torch.quant import apply as qapply
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import value_and_grad

    params = decoder.init(cfg, torch.Generator(device="cuda").manual_seed(SEED + 8),
                          device="cuda")
    specs = qapply.layer_specs(params, cfg)
    policy = dryrun_policy(specs, "mixed")
    bits = qapply.bits_for_scan(policy, params, cfg)
    batch = {k: v.to("cuda") for k, v in global_batch(
        TokenTask(cfg.vocab_size), cfg, ShapeSpec("search", "train", 64, 8), 0).items()}
    api = registry.get_api(cfg)
    per_fwd = _fq_per_forward(cfg, specs)
    step = (per_fwd + _fq_recomputed(cfg, specs), per_fwd)     # the recompute reruns the forward's
    runs = {}
    for key, impl in (("kernels", "auto"), ("plain", "torch"), ("kernels again", "auto")):
        kernels.reset_counts()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(
            lambda p, b, bb, impl=impl: api.loss(p, cfg, b, bits=bb, impl=impl), params, batch,
            bits)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = step if impl == "auto" else (0, 0)
        got = (kernels.LAUNCHES["fake_quant"], kernels.LAUNCHES["fake_quant_ste_bwd"])
        plain = (kernels.PLAIN_CALLS["fake_quant"], kernels.PLAIN_CALLS["fake_quant_ste_bwd"])
        if got != want or plain != ((0, 0) if impl == "auto" else step):
            raise AssertionError(f"phase 7 (a) {key}: launches {got}, plain calls {plain} "
                                 f"(want {step}: {per_fwd} a forward, its regions' again)")
        if not (torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)):
            raise AssertionError(f"phase 7 (a) {key}: non-finite loss or gradient")
        runs[key] = (loss, grads)
        if key == "kernels again":
            dt_kernels = dt
        log(f"  {key}: loss {float(loss):.6f}, loss + gradients in {dt:.3f} s "
            f"(fake-quant launches {got}, plain calls {plain})")
    # the backward is deterministic, so loss and every gradient leaf are held
    # bit for bit: kernels against plain, and run against run
    for a, b in (("kernels", "plain"), ("kernels", "kernels again")):
        (la, ga), (lb, gb) = runs[a], runs[b]
        same = [torch.equal(x, y) for x, y in zip(ga, gb)]
        if not torch.equal(la, lb) or not all(same):
            worst = max(rel(x, y) for x, y in zip(ga, gb))
            raise AssertionError(f"phase 7 (a) {a} vs {b}: loss rel {rel(la, lb):.3g}, "
                                 f"gradients equal in {sum(same)} of {len(same)} leaves, "
                                 f"max rel {worst:.3g}")
        log(f"  ok {a} vs {b}: loss and all {len(same)} gradient leaves bit-equal")
    # the other half of a QAT step: one AdamW update over these gradients
    grads = runs.pop("kernels")[1]
    del runs
    torch.cuda.empty_cache()
    ocfg = opt_mod.OptimizerConfig(lr=1e-3, warmup_steps=10)
    state = opt_mod.init(ocfg, params)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt_mod.apply(ocfg, grads, state, params)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    n = sum(p.numel() for p in opt_mod.leaves(params))
    log(f"  ({smi_line()}) one AdamW update of {n / 1e9:.3f} G parameters: "
        f"{statistics.median(times[1:]) * 1e3:.3f} ms (median of 2 after a warm-up); loss and "
        f"gradients through the kernels {dt_kernels * 1e3:.3f} ms (the second run)")
    del params, grads, state
    torch.cuda.empty_cache()


def _step_hook(torch, record: dict):
    """Wrap ``quant.qat.make_lm_qat_step`` so that each training step of the
    search is timed (host clock, synchronized) and one, ``record["profile_at"]``,
    runs under ``torch.profiler``."""
    from repro_torch.quant import qat

    make = qat.make_lm_qat_step

    def wrapped(*a, **kw):
        step, tcfg = make(*a, **kw)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(record["steps"]) == record["profile_at"]:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    out = step(*args, **kwargs)
                    torch.cuda.synchronize()
                record["profile"] = (prof, time.perf_counter() - t0)
            else:
                out = step(*args, **kwargs)
                torch.cuda.synchronize()
            record["steps"].append(time.perf_counter() - t0)
            return out

        return timed, tcfg

    return qat, make, wrapped


def _device_shares(torch, prof, wall_s: float, step_s: float) -> str:
    from torch.autograd import DeviceType

    total = fq = 0.0
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0.0)
        total += dev
        if "fake_quant" in evt.key:
            fq += dev
        rows.append((dev, evt.key, evt.count))
    if not total:
        return "no device time in the trace (not measured)"
    top = "; ".join(f"{100 * d / total:.1f}% x{c} {k[:60]}" for d, k, c in
                    sorted(rows, reverse=True)[:6])
    return (f"device busy {total / 1e3:.3f} ms: {100 * total / (step_s * 1e6):.1f}% of the "
            f"step median, {100 * total / (wall_s * 1e6):.1f}% of the profiled step's "
            f"{wall_s * 1e3:.3f} ms; fake-quant forward + STE kernels "
            f"{fq / 1e3:.3f} ms ({100 * fq / total:.1f}% of device time); top: {top}")


def search_argv(cfg, extra=(), base=SEARCH_ARGV) -> list[str]:
    """``base`` (``SEARCH_ARGV``) with the state phase (a ``state_bytes`` limit
    at ``STATE_FRAC`` of the uniform 8-bit state over STATE_SLOTS x STATE_SEQ)."""
    from repro_torch.core.policy import BitPolicy
    from repro_torch.cost import ShiftAddCostModel
    from repro_torch.kvcache import state_layer_infos

    u8 = BitPolicy.uniform(state_layer_infos(cfg, STATE_SLOTS, STATE_SEQ), 8)
    limit = STATE_FRAC * ShiftAddCostModel().report(u8).as_costs()["state_bytes"]
    return list(base) + ["--limit", f"state_bytes={limit:.0f}", "--slots", str(STATE_SLOTS),
                         "--kv-max-seq", str(STATE_SEQ), *extra]


def _packed_linears(tree) -> int:
    """Packed linears of a serve tree's layers (one GEMV or GEMM launch each)."""
    from repro_torch.quant import apply as qapply
    from repro_torch.quant.tensor import QuantizedTensor

    return sum(1 for lp in tree["layers"] for _, leaf in qapply._walk(lp)
               if isinstance(leaf, QuantizedTensor))


def _shared_linears(tree, cfg) -> int:
    """Launches of the hybrid's shared block a forward: its packed linears
    (fused wqkv, wo, w_gu, w_down) at each application; 0 for other families."""
    from repro_torch.quant import apply as qapply
    from repro_torch.quant.tensor import QuantizedTensor

    if "shared_attn" not in tree:
        return 0
    from repro_torch.models.hybrid import n_attn_applications

    return n_attn_applications(cfg) * sum(1 for _, leaf in qapply._walk(tree["shared_attn"])
                                          if isinstance(leaf, QuantizedTensor))


def search_launches(cfg, env, phases) -> dict:
    """The launches a search run's structure predicts: 128 fake-quant
    launches a forward of the weight phase (an evaluation), and a training
    step's forward, its recompute (127: all but the lookup's) and 128 STE
    launches; one fused
    decode step (row 3) per KV entry (a layer, or a hybrid's shared-block
    application) for each step of the state env on a quantized state; for
    the draft env, one GEMM per packed linear for its calibration prefill and
    one GEMV per packed linear for each decode step."""
    from repro_torch import kernels
    from repro_torch.kvcache import kv_entry_names

    per_fwd = _fq_per_forward(cfg, env.layer_infos())
    recomputed = _fq_recomputed(cfg, env.layer_infos())
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(fake_quant=per_fwd * (env.train_steps + env.eval_passes)
                + recomputed * env.train_steps,
                fake_quant_ste_bwd=per_fwd * env.train_steps)
    if "state_env" in phases:
        want["quant_kv_decode_step"] = len(kv_entry_names(cfg)) * phases["state_env"].steps
    if "draft_env" in phases:
        denv = phases["draft_env"]
        n_lin = _packed_linears(denv._deployed)
        want.update(quant_matmul=n_lin, quant_gemv=n_lin * denv.steps)
    return want


def search_run(torch, cfg, argv, *, profile: bool):
    """Phase 7 (b), (d) and (e): ``launch.search.run`` from ``argv``, counts
    set to 0 just before and read just after, held to ``search_launches``."""
    from repro_torch import kernels
    from repro_torch.launch import search

    args = search.build_parser().parse_args(argv)
    record = {"steps": [], "profile_at": args.pretrain_steps + 1 if profile else -1}
    qat, make, wrapped = _step_hook(torch, record)
    qat.make_lm_qat_step = wrapped
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        t0 = time.perf_counter()
        artifact, result, env, phases = search.run(args, log=lambda m: log("    " + m))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        qat.make_lm_qat_step = make
    launches, plain = dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)
    want = search_launches(cfg, env, phases)
    if launches != want or any(plain.values()):
        raise AssertionError(f"phase 7 search: launches {launches} (the run's {env.train_steps} "
                             f"training steps, {env.eval_passes} evaluations and its state and "
                             f"draft steps predict {want}), plain calls {plain}")
    if len(record["steps"]) != env.train_steps:
        raise AssertionError(f"{len(record['steps'])} timed steps for {env.train_steps}")
    info = dict(wall=wall, peak=torch.cuda.max_memory_allocated(), launches=launches,
                steps=record["steps"], pretrain=args.pretrain_steps,
                profile=record.get("profile"), phases=phases)
    return artifact, result, env, info


def _phase_walls(artifact) -> str:
    """Each search phase's wall time and controller iterations (provenance)."""
    return "; ".join(f"{name} {ph['wall_s']:.3f} s, {ph['iterations']} iterations, "
                     f"success={ph['success']}"
                     for name, ph in artifact.provenance["phases"].items())


def search_requests(torch, cfg, new: int) -> list:
    """Phase 7 (c) and (e)'s traffic: 8 requests of 8-24 prompt tokens (seed 9)."""
    from repro_torch.serve.engine import Request

    gen = torch.Generator().manual_seed(SEED + 9)
    lens = torch.randint(8, 25, (8,), generator=gen).tolist()
    return [Request(uid=i, prompt=torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist(),
                    max_new_tokens=new) for i, n in enumerate(lens)]


def search_phase(torch, cfg) -> dict:
    """Phase 7 (b)-(d).  Returns the main path's (b) launch counts."""
    from repro_torch import kernels
    from repro_torch.core.policy import PolicyArtifact
    from repro_torch.kvcache import state_layer_infos, verify_state_bits
    from repro_torch.models import decoder
    from repro_torch.quant import apply as qapply
    from repro_torch.quant.tensor import QuantizedTensor
    from repro_torch.serve.engine import ServeEngine

    artifact, result, env, info = search_run(torch, cfg, search_argv(cfg), profile=True)
    r = result
    qat = info["steps"][info["pretrain"]:]
    timed = [t for i, t in enumerate(qat) if i != 1]          # step pretrain + 1 is profiled
    smi = smi_line()
    log(f"  ({smi}) search: success={r.success} abandoned={r.abandoned} acc {r.acc:.4f}, "
        f"{len(r.trace)} controller entries, mean bits {r.policy.mean_bits():.3f}, "
        f"size_mib {r.costs.get('size_mib', float('nan')):.2f} "
        f"(limit {r.budget.items[0].limit:g}), wall {info['wall']:.2f} s")
    log(f"  ({smi}) QAT step median {statistics.median(timed) * 1e3:.3f} ms over "
        f"{len(timed)} steps after pretraining (pretraining steps median "
        f"{statistics.median(info['steps'][1:info['pretrain']]) * 1e3:.3f} ms, first step "
        f"{info['steps'][0] * 1e3:.3f} ms)")
    if info["profile"] is not None:
        prof, wall = info["profile"]
        log(f"  ({smi}) profiled QAT step: "
            f"{_device_shares(torch, prof, wall, statistics.median(timed))}")
    log(f"  ({smi}) peak allocated {info['peak'] / 1e9:.3f} GB")
    per_fwd = _fq_per_forward(cfg, env.layer_infos())
    log(f"  launches {info['launches']}: {env.train_steps} training steps x {per_fwd} STE, "
        f"{env.train_steps + env.eval_passes} forwards ({env.eval_passes} evaluations) x "
        f"{per_fwd} fake-quant and {env.train_steps} recomputes x "
        f"{_fq_recomputed(cfg, env.layer_infos())}, "
        f"{info['phases']['state_env'].steps} state steps x "
        f"{cfg.n_layers} fused decode steps, as predicted; plain calls 0")
    log(f"  ({smi}) search phases: {_phase_walls(artifact)}; state policy mean "
        f"{artifact.state_policy.mean_bits():.3f} bits, state_bytes "
        f"{artifact.report['state_bytes']:.0f} ({artifact.meta['fp_state_bytes']} fp32)")
    bits_b = [e.bits for e in r.trace] + [artifact.state_policy.bits]
    del info["phases"]

    # (c) save, load back, pack, verify, serve
    path = ROOT / "build" / "phase7_policy.json"
    path.parent.mkdir(exist_ok=True)
    artifact.save(str(path))
    art = PolicyArtifact.load(str(path))
    specs = env.layer_infos()
    art.verify_layers(specs)
    if art.version != 6 or art.policy.bits != r.policy.bits or not art.provenance:
        raise AssertionError(f"reloaded artifact v{art.version} differs from the search's")
    params = env.params
    del env
    torch.cuda.empty_cache()
    serve = qapply.quantize_for_serve(decoder.unstack_layers(params, cfg), art, cfg)
    del params
    torch.cuda.empty_cache()
    qapply.verify_packed_bits(serve, art)
    slots, seq, new = STATE_SLOTS, STATE_SEQ, 16
    # the artifact deploys its own searched state policy
    eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq, artifact=art)
    del serve
    verify_state_bits(eng.state, art, surface=state_layer_infos(cfg, slots, seq))
    reqs = search_requests(torch, cfg, new)
    n_req = len(reqs)
    torch.cuda.synchronize()
    kernels.reset_counts()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    st = eng.stats()
    packed = sum(1 for lp in eng.params["layers"] for _, leaf in qapply._walk(lp)
                 if isinstance(leaf, QuantizedTensor))
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(quant_gemv=packed * st["decode_steps"], quant_matmul=packed * st["admissions"],
                quant_kv_decode_step=cfg.n_layers * st["decode_steps"])
    if sorted(out) != list(range(n_req)) or any(len(v) != new for v in out.values()):
        raise AssertionError(f"phase 7 (c): incomplete streams {[len(v) for v in out.values()]}")
    if not all(0 <= t < cfg.vocab_size for v in out.values() for t in v):
        raise AssertionError("phase 7 (c): token id out of range")
    if st["launches"] != want or any(st["plain_calls"].values()):
        raise AssertionError(f"phase 7 (c): launches {st['launches']} (want {want}), "
                             f"plain calls {st['plain_calls']}")
    log(f"  ok (c) artifact v{art.version} saved to {path.relative_to(ROOT)}, loaded, packed "
        f"({eng.weight_container_bytes() / 1e9:.3f} GB, mean {art.policy.mean_bits():.3f} bits), "
        f"verify_packed_bits and verify_state_bits passed (searched state, mean "
        f"{art.state_policy.mean_bits():.3f} bits); served {n_req} requests x {new} tokens on "
        f"{slots} slots: "
        f"{st['decode_steps']} decode steps, {st['admissions']} admissions, median step "
        f"{st['decode_step_median_s'] * 1e3:.3f} ms ({packed} packed linears a step)")
    log(f"    launches {st['launches']}")
    del eng
    torch.cuda.empty_cache()

    # (d) the same search again: do its decisions repeat?
    art2, r2, env2, info2 = search_run(torch, cfg, search_argv(cfg), profile=False)
    del env2, info2["phases"]
    torch.cuda.empty_cache()
    bits_d = [e.bits for e in r2.trace] + [art2.state_policy.bits]
    parted = [i for i, (x, y) in enumerate(zip(bits_b, bits_d)) if x != y]
    same = bits_d == bits_b and r2.policy.bits == r.policy.bits
    log(f"  (d) second search from seed {SEED}: {len(bits_d)} controller entries, wall "
        f"{info2['wall']:.2f} s; bit vectors {'agree at every entry and in the final policy' if same else 'part at entries %s' % parted}; "
        f"acc {r2.acc:.6f} vs {r.acc:.6f}")
    return info["launches"]


def search_draft_phase(torch, cfg) -> None:
    """Phase 7 (e): the search with the state phase over a paged pool and the
    draft phase (``DRAFT_ARGV``), its v6 artifact saved, loaded, packed and
    served to (c)'s requests twice, dense and paged, speculating at the
    artifact's K: the launches the rounds predict, no plain call, the state
    bits the artifact's."""
    from repro_torch import kernels
    from repro_torch.core.policy import PolicyArtifact
    from repro_torch.kvcache import state_layer_infos, verify_state_bits
    from repro_torch.models import decoder
    from repro_torch.quant import apply as qapply
    from repro_torch.serve.engine import ServeEngine

    smi = smi_line()
    artifact, r, env, info = search_run(torch, cfg, search_argv(cfg, DRAFT_ARGV), profile=False)
    phases = info.pop("phases")
    denv, dres = phases["draft_env"], phases["draft_result"]
    log(f"  ({smi}) (e) search with --paged --draft in {info['wall']:.2f} s: "
        f"{_phase_walls(artifact)}; state {phases['state_env'].steps} steps, draft "
        f"{denv.steps} steps (the probe {len(denv.layer_infos())}); peak allocated "
        f"{info['peak'] / 1e9:.3f} GB")
    log(f"    launches {info['launches']}, as predicted; plain calls 0")
    if artifact.draft_policy is None or artifact.pool is None or artifact.state_policy is None:
        raise AssertionError(f"phase 7 (e): the artifact lacks a field: draft "
                             f"{artifact.draft_policy is not None}, pool {artifact.pool}, state "
                             f"{artifact.state_policy is not None}; draft success "
                             f"{dres.success}, acc {dres.acc}")
    predicted = artifact.meta["draft_agreement"]
    log(f"  draft policy: mean {artifact.draft_policy.mean_bits():.3f} bits at K "
        f"{artifact.draft_k}, size {artifact.report['draft_size_mib']:.1f} MiB against the "
        f"deployed {artifact.report['size_mib']:.1f}; predicted acceptance (one-step argmax "
        f"agreement over {denv._ref_argmax.numel()} prompts) {predicted:.4f}, divergence "
        f"{artifact.meta['draft_divergence']:.4f}; pool {artifact.pool} (+"
        f"{artifact.meta['draft_pool_headroom_blocks']} burst-scratch blocks)")
    path = ROOT / "build" / "phase7e_policy.json"
    artifact.save(str(path))
    art = PolicyArtifact.load(str(path))
    art.verify_layers(env.layer_infos())
    if art.version != 6 or art.draft_k != SPEC_K or art.pool != artifact.pool:
        raise AssertionError(f"phase 7 (e): reloaded artifact v{art.version}, K {art.draft_k}, "
                             f"pool {art.pool}")
    params = env.params
    del env, denv, phases, dres
    torch.cuda.empty_cache()
    serve = qapply.quantize_for_serve(decoder.unstack_layers(params, cfg), art, cfg)
    del params
    torch.cuda.empty_cache()
    qapply.verify_packed_bits(serve, art)
    slots, seq, new = STATE_SLOTS, STATE_SEQ, 16
    reqs = search_requests(torch, cfg, new)
    surface = state_layer_infos(cfg, slots, seq)
    outs = {}
    for key, deploy in (("dense", dataclasses.replace(art, pool=None)), ("paged", art)):
        eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq, artifact=deploy,
                          shed=steady(spec_tiers=False))
        verify_state_bits(eng.state, art, surface=surface)
        if not eng.speculate or eng.paged != (key == "paged"):
            raise AssertionError(f"phase 7 (e) {key}: speculate {eng.speculate}, paged "
                                 f"{eng.paged}")
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        want = spec_launches(eng, st)
        if sorted(out) != list(range(len(reqs))) or any(len(v) != new for v in out.values()):
            raise AssertionError(f"phase 7 (e) {key}: incomplete streams")
        if st["launches"] != want or any(st["plain_calls"].values()) or not st["spec_steps"]:
            raise AssertionError(f"phase 7 (e) {key}: launches {st['launches']} (the rounds "
                                 f"predict {want}), plain calls {st['plain_calls']}")
        served = st["spec_accepted"] / st["spec_proposed"]
        log(f"  ok (e) {key}, speculative from the artifact: {len(out)} streams of {new}, "
            f"{st['decode_steps']} rounds, median round {st['decode_step_median_s'] * 1e3:.3f} "
            f"ms, {len(reqs) * new / wall:.2f} tok/s over {wall:.3f} s; served acceptance "
            f"{served:.4f} ({st['spec_accepted']} of {st['spec_proposed']}) against the "
            f"predicted {predicted:.4f}; verify_state_bits passed"
            + (f"; pool peak {st['pool_peak_allocated']} of {art.pool['num_blocks']} blocks"
               if eng.paged else ""))
        log(f"    launches {st['launches']}")
        outs[key] = out
        del eng
        torch.cuda.empty_cache()
    if outs["paged"] != outs["dense"]:
        raise AssertionError("phase 7 (e): paged streams differ from the dense ones")
    log("  ok (e) paged streams = dense streams")
    del serve
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: row 8 on the f32 serving path, chunked prefill and streaming
# ---------------------------------------------------------------------------

#: phase 8 (a): gemma-2b with d_model cut to 512, the widest row 8's gate takes
PROJ_D = 512
#: phase 8 (b): the long x short burst (prompt lengths in submission order)
BURST_LENS = (1536, 24, 40, 1536, 16, 48, 32, 20)
BURST_CHUNK = 256


def serve_row8(torch, cfg) -> dict:
    """Phase 8 (a): the f32 engine through row 8, against the same engine
    with ``fuse_projections=False`` (the GEMV -> rotary -> dense step path)."""
    from repro_torch import kernels
    from repro_torch.serve.engine import Request, ServeEngine

    cfg512 = dataclasses.replace(cfg, d_model=PROJ_D, dtype="float32")
    slots, seq, new, n_req = 4, 512, 32, 8
    log(f"  {cfg.name} cut to d_model {PROJ_D} (from {cfg.d_model}), float32; the rest "
        f"published: {cfg512.n_layers} layers, {cfg512.n_heads} heads over "
        f"{cfg512.n_kv_heads} KV head of {cfg512.resolved_head_dim}, d_ff {cfg512.d_ff}, "
        f"vocab {cfg512.vocab_size}")
    serve, policy = packed_model(torch, cfg512, SEED + 9)
    gen = torch.Generator().manual_seed(SEED + 10)
    lens = torch.randint(8, 201, (n_req,), generator=gen).tolist()
    reqs = [Request(uid=i, prompt=torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist(),
                    max_new_tokens=new) for i, n in enumerate(lens)]
    runs = {}
    for fuse in (True, False):
        eng = ServeEngine(cfg512, serve, max_slots=slots, max_seq=seq, shed=steady(),
                          state_bits=state_policy(cfg512, slots, seq), fuse_projections=fuse)
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        launches, plain, steps = st["launches"], st["plain_calls"], st["decode_steps"]
        n = cfg512.n_layers
        want = dict.fromkeys(kernels.KERNELS, 0)
        if fuse:     # row 8 per layer; wo, w_gu, w_down through the GEMV
            want.update(quant_kv_decode_step_proj=n * steps, quant_gemv=3 * n * steps,
                        quant_matmul=4 * n * st["admissions"])
        else:        # wq, wk, wv, wo, w_gate, w_up, w_down and the dense step
            want.update(quant_kv_decode_step=n * steps, quant_gemv=7 * n * steps,
                        quant_matmul=7 * n * st["admissions"])
        if sorted(out) != list(range(n_req)) or any(len(v) != new for v in out.values()):
            raise AssertionError(f"row 8 engine: incomplete streams "
                                 f"{[len(v) for v in out.values()]}")
        if launches != want or any(plain.values()):
            raise AssertionError(f"row 8 engine (fuse {fuse}): launches {launches}, want {want}; "
                                 f"plain calls {plain}")
        tag = "fused wqkv, row 8" if fuse else "unfused, GEMV + rotary + row 3"
        log(f"  ok ({tag}): {n_req} requests of {min(lens)}-{max(lens)} prompt tokens, {new} new "
            f"each, {slots} slots: {steps} decode steps, {st['admissions']} admissions, median "
            f"step {st['decode_step_median_s'] * 1e3:.3f} ms, {n_req * new / wall:.2f} tok/s over "
            f"{wall:.3f} s; launches per decode step: row 8 "
            f"{launches['quant_kv_decode_step_proj'] / steps:g}, row 3 "
            f"{launches['quant_kv_decode_step'] / steps:g}, GEMV "
            f"{launches['quant_gemv'] / steps:g}")
        runs[fuse] = (out, eng, launches)
    (fo, fused, fl), (uo, unfused, _) = runs[True], runs[False]
    fs, us = fused.state, unfused.state
    if fo != uo:
        raise AssertionError(f"row 8 engine streams differ from the unfused engine's for uids "
                             f"{[u for u in fo if fo[u] != uo[u]]}")
    for i, (a, b) in enumerate(zip(fs, us)):
        for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"row 8 engine: layer {i} cache {f} differs from the "
                                     f"unfused engine's")
    log(f"  ok streams and final cache bytes of the row-8 engine equal the unfused engine's "
        f"(mean {policy.mean_bits():.3f} weight bits, K 8 / V 4 state)")
    profile_steps(torch, fused, reqs[:slots])
    del serve, runs, fused, unfused, fs, us
    torch.cuda.empty_cache()
    return fl


def burst_requests(torch, cfg, new: int) -> list:
    from repro_torch.serve.engine import Request

    gen = torch.Generator().manual_seed(SEED + 11)
    return [Request(uid=i, prompt=torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist(),
                    max_new_tokens=new) for i, n in enumerate(BURST_LENS)]


def prefill_gap(torch, cfg, serve, reqs, slots: int, seq: int, state) -> float:
    """Largest |logit| difference between the two admission paths on one
    request set: the first ``slots`` requests' heads prefilled together,
    padded to the longest (the GEMM over every padded row), against each
    prefilled alone in ``BURST_CHUNK``-token chunks; then one decode step
    from each cache on the last prompt tokens.  How far chunking may move a
    logit, for the near-tie criterion of phase 6."""
    from repro_torch.kvcache import insert_state_rows, resolve_state_bits
    from repro_torch.models import decoder
    from repro_torch.quant.apply import fuse_projections

    params = fuse_projections(serve)
    heads = [r.prompt[:-1] for r in reqs[:slots]]
    pad = max(map(len, heads))
    pad += -pad % 32
    toks = torch.zeros((slots, pad), dtype=torch.int32, device="cuda")
    for i, h in enumerate(heads):
        toks[i, : len(h)] = torch.tensor(h, device="cuda")
    lens = torch.tensor([len(h) for h in heads], dtype=torch.int32, device="cuda")
    bits = resolve_state_bits(state, cfg)
    _, kv = decoder.prefill(params, cfg, toks, logits=False)
    whole = insert_state_rows(decoder.init_cache(cfg, slots, seq, state_bits=bits,
                                                 device="cuda"),
                              torch.arange(slots, device="cuda"), kv, lens)
    del kv
    chunked = decoder.init_cache(cfg, slots, seq, state_bits=bits, device="cuda")
    for i, h in enumerate(heads):
        scr = decoder.init_prefill_scratch(cfg, len(h) + (-len(h) % 32), device="cuda")
        for off in range(0, len(h), BURST_CHUNK):
            c = torch.zeros((1, BURST_CHUNK), dtype=torch.int32, device="cuda")
            piece = h[off:off + BURST_CHUNK]
            c[0, : len(piece)] = torch.tensor(piece, device="cuda")
            scr = decoder.prefill_chunk(params, cfg, scr, c, off)
        chunked = insert_state_rows(chunked, [i], scr, lens[i:i + 1])
    last = torch.tensor([[r.prompt[-1]] for r in reqs[:slots]], device="cuda")
    a, _ = decoder.decode_step(params, cfg, whole, last, lens)
    b, _ = decoder.decode_step(params, cfg, chunked, last, lens)
    gap = float((a.float() - b.float()).abs().max())
    worst = rel(b, a)
    if not worst <= 5e-2:
        raise AssertionError(f"chunked against whole-prompt prefill: first-token logits rel "
                             f"{worst:.3g}")
    log(f"  admission paths on the first {slots} requests, one decode step after: whole-prompt "
        f"(GEMM over {slots} x {pad} rows) vs {BURST_CHUNK}-token chunks, logits rel "
        f"{worst:.3g} (limit 5e-2), max |logit difference| {gap:.4g}")
    del params, whole, chunked
    torch.cuda.empty_cache()
    return gap


def near_ties(a: dict, b: dict, rows_a: dict, rows_b: dict, gap: float, what: str, uids=None,
              upto=None) -> int:
    """Hold stream set ``b`` against ``a`` where they part: at each first
    divergence (token t of a uid) ``a``'s logits prefer its token by m_a and
    ``b``'s prefer its own by m_b, so the two paths moved that pair of logits
    by m_a + m_b, which must stay within 2 x ``gap`` (each logit may move by
    the gap the two paths leave on one cache).  ``upto`` limits a uid's
    comparison to its first tokens.  Returns how many streams parted."""
    parted = 0
    for uid in sorted(a if uids is None else uids):
        n = None if upto is None else upto[uid]
        t = next((i for i, (x, y) in enumerate(zip(a[uid][:n], b[uid][:n])) if x != y), None)
        if t is None:
            continue
        parted += 1
        xa, xb = a[uid][t], b[uid][t]
        la, lb = rows_a[(uid, t)].float(), rows_b[(uid, t)].float()
        m_a, m_b = float(la[xa] - la[xb]), float(lb[xb] - lb[xa])
        log(f"    stream {uid}: {what} at token {t} ({xa} -> {xb}): one prefers {xa} by "
            f"{m_a:.4g}, the other {xb} by {m_b:.4g}, pair moved {m_a + m_b:.4g}")
        if m_a < 0 or m_b < 0 or not m_a + m_b <= 2 * gap:
            raise AssertionError(f"stream {uid} parts at token {t}: the pair moved "
                                 f"{m_a + m_b:.4g} > 2 x {gap:.4g}, not a near-tie")
    return parted


def admission_paths(torch, cfg, serve, reqs, slots: int, seq: int, new: int, *,
                    stream: bool) -> float:
    """Phases 8 (b) and 9 (b): ``reqs`` through whole-prompt and chunked
    admission, dense and paged (a-d); with ``stream`` engine (c) also streams
    its tokens (phase 8 (c)).  The paged streams must equal the dense ones,
    and chunked ones leave whole-prompt ones only at near-ties against the
    logit gap the two admission paths leave on one cache.  Returns that gap."""
    from repro_torch import kernels
    from repro_torch.serve.engine import ServeEngine

    state = state_policy(cfg, slots, seq)
    engines = {"a dense, whole-prompt": {},
               "b paged 512, whole-prompt": dict(paged=True, pool_blocks=512),
               "c dense, chunked": dict(prefill_chunk=BURST_CHUNK),
               "d paged 512, chunked": dict(paged=True, pool_blocks=512,
                                            prefill_chunk=BURST_CHUNK)}
    long_ids = [r.uid for r in reqs if len(r.prompt) > 1000]
    outs, rows, streamed = {}, {}, {}
    for key, kw in engines.items():
        gc.collect()         # record_logits ties an engine into a cycle: free the last one
        torch.cuda.empty_cache()
        eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq, state_bits=state,
                          shed=steady(), **kw)
        collect = record_logits(torch, eng) if key[0] in "ac" else None
        polled = []
        streams = stream and key[0] == "c"
        if streams:
            for r in reqs:
                eng.submit(r, on_token=lambda uid, tok: streamed.setdefault(uid, []).append(tok))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        t0 = time.perf_counter()
        if streams:
            out = eng.run(step_hook=lambda e, step: polled.extend(e.poll()))
        else:
            out = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        polled.extend(eng.poll())
        st = eng.stats()
        launches = st["launches"]
        step_kernel = "quant_kv_decode_step_paged" if eng.paged else "quant_kv_decode_step"
        if sorted(out) != [r.uid for r in reqs] or any(len(v) != new for v in out.values()):
            raise AssertionError(f"{key}: incomplete streams {[len(v) for v in out.values()]}")
        if any(st["plain_calls"].values()):
            raise AssertionError(f"{key}: plain calls {st['plain_calls']}")
        if not (launches["quant_matmul"] and launches["quant_gemv"] and launches[step_kernel]):
            raise AssertionError(f"{key}: launches {launches}")
        if eng.paged and (eng.pool.allocated or eng.pool.reserved):
            raise AssertionError(f"{key}: the pool ends with {eng.pool.allocated} blocks "
                                 f"allocated, {eng.pool.reserved} reserved")
        ttft = {u: eng.lifecycles[u].ttft() for u in out}
        short = torch.tensor([ttft[u] for u in out if u not in long_ids], dtype=torch.float64)
        line = (f"  ok ({key}): {st['decode_steps']} decode steps, {st['admissions']} "
                f"admissions, {st['prefill_chunks']} chunks; TTFT short p50 "
                f"{float(short.quantile(0.5)) * 1e3:.1f} ms p99 "
                f"{float(short.quantile(0.99)) * 1e3:.1f} ms, long "
                f"{', '.join(f'{ttft[u] * 1e3:.1f}' for u in long_ids)} ms; median step "
                f"{st['decode_step_median_s'] * 1e3:.3f} ms, "
                f"{len(reqs) * new / wall:.2f} tok/s over {wall:.3f} s, peak allocated "
                f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        if "scheduler" in st:
            sc = st["scheduler"]
            if sc["max_step_tokens"] > sc["step_token_budget"]:
                raise AssertionError(f"{key}: a turn spent {sc['max_step_tokens']} tokens of "
                                     f"a {sc['step_token_budget']} budget")
            line += (f"; budget {sc['step_token_budget']}, most tokens in a turn "
                     f"{sc['max_step_tokens']}, {sc['planned_turns']} planned turns")
        log(line)
        if streams:
            stream_order = {}
            for uid, tok in polled:
                stream_order.setdefault(uid, []).append(tok)
            if streamed != out or stream_order != out:
                raise AssertionError("(c) streaming: the callbacks or the poll() ring differ "
                                     "from the returned streams")
            log(f"  ok (c) streaming: {sum(map(len, streamed.values()))} on_token callbacks and "
                f"{len(polled)} polled events, in the order of the returned streams")
        if collect is not None:
            rows[key[0]] = collect()
        outs[key] = out
        del eng
        torch.cuda.empty_cache()
    a, b, c, d = (outs[k] for k in engines)
    if b != a or d != c:
        raise AssertionError("paged streams differ from the dense engine's with the same "
                             "admission")
    gap = prefill_gap(torch, cfg, serve, reqs, slots, seq, state)
    parted = near_ties(a, c, rows["a"], rows["c"], gap, "chunked leaves whole-prompt")
    log(f"  ok streams (b) = (a), (d) = (c); chunked = whole-prompt in {len(a) - parted} of "
        f"{len(a)} streams ({parted} parted, each at a near-tie)")
    return gap


def serve_chunked(torch, cfg) -> float:
    """Phase 8 (b) and (c): the long x short burst through whole-prompt and
    chunked admission, dense and paged; engine (c) streams its tokens."""
    slots, seq, new = 4, 2048, 16
    serve, _ = packed_model(torch, cfg, SEED + 12)
    reqs = burst_requests(torch, cfg, new)
    log(f"  {len(reqs)} requests submitted at once, prompts {list(BURST_LENS)} tokens, {new} new "
        f"each, {slots} slots, max_seq {seq}, K 8 / V 4 state")
    gap = admission_paths(torch, cfg, serve, reqs, slots, seq, new, stream=True)
    del serve
    torch.cuda.empty_cache()
    return gap


# ---------------------------------------------------------------------------
# phase 9: prompts above 2048 tokens
# ---------------------------------------------------------------------------

#: phase 9: a prompt past the direct path (gemma-2b's context is 8192)
LONG_S = 4096
#: phase 9 (b): the long prompt beside three short ones, and max_seq
LONG_SEED, LONG_SEQ = 20, 4608


def check_flash(torch, cfg) -> None:
    """Phase 9 (a): ``_flash_attention`` at gemma-2b's attention geometry (B 1,
    S 4096, 8 query heads over 1 KV head of 256, causal) against
    ``_direct_attention`` on the card, the forward and dq, dk, dv through
    autograd, in f32 and bf16; each path's forward and backward timed, and
    SDPA's on the same q, k, v as a library yardstick (not used by the port)."""
    import torch.nn.functional as F
    from repro_torch.models import layers

    hq, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    # rel = max |difference| / max |reference|: f32 at the CPU tests' 3e-5 (9e-5 on the
    # gradients), bf16 at 2e-2 (p and ds are rounded to bf16 before their products)
    limits = {torch.float32: (3e-5, 9e-5), torch.bfloat16: (2e-2, 2e-2)}
    for dtype, (lim_o, lim_g) in limits.items():
        base = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((1, LONG_S, hq, hd), (1, LONG_S, n_kv, hd), (1, LONG_S, n_kv, hd))]
        do = torch.randn((1, LONG_S, hq, hd), generator=gen, device="cuda").to(dtype)
        sdpa_in = [base[0].transpose(1, 2)] + [t.transpose(1, 2).repeat_interleave(
            hq // n_kv, dim=1) for t in base[1:]]
        paths = {"flash": lambda q, k, v: layers._flash_attention(q, k, v, n_kv, causal=True),
                 "direct": lambda q, k, v: layers._direct_attention(q, k, v, n_kv, causal=True),
                 "sdpa": lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True)}
        got, times = {}, {}
        for name, fn in paths.items():
            leaves = [t.clone().requires_grad_(True) for t in (sdpa_in if name == "sdpa"
                                                                else base)]
            torch.cuda.reset_peak_memory_stats()
            out = fn(*leaves)
            out.backward(do.transpose(1, 2) if name == "sdpa" else do)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            got[name] = [t.detach() for t in (out, *(x.grad for x in leaves))]
            with torch.no_grad():
                fwd = time_ms(torch, lambda: fn(*leaves), reps=10)

            def both():
                o = fn(*leaves)
                torch.autograd.grad(o, leaves, do.transpose(1, 2) if name == "sdpa" else do)
            times[name] = (fwd, time_ms(torch, both, reps=10) - fwd, peak)
        errs = [rel(x, y) for x, y in zip(got["flash"], got["direct"])]
        finite = all(bool(torch.isfinite(t).all()) for t in got["flash"])
        if not (finite and errs[0] <= lim_o and max(errs[1:]) <= lim_g):
            raise AssertionError(f"flash vs direct at S {LONG_S} {dtype}: out rel {errs[0]:.3g} "
                                 f"(limit {lim_o:g}), dq/dk/dv rel {errs[1:]} (limit {lim_g:g})")
        sd = rel(got["sdpa"][0].transpose(1, 2), got["direct"][0])
        log(f"  ok flash vs direct, B 1 S {LONG_S} {hq} heads over {n_kv} of {hd}, causal, "
            f"{str(dtype)[6:]}: out rel {errs[0]:.3g} (limit {lim_o:g}), dq {errs[1]:.3g}, "
            f"dk {errs[2]:.3g}, dv {errs[3]:.3g} (limit {lim_g:g}); SDPA's out rel {sd:.3g}")
        log("    " + "; ".join(f"{name} forward {f:.4f} ms, backward {b:.4f} ms, peak "
                                f"{p / 1e9:.3f} GB" for name, (f, b, p) in times.items()))
        del got, base, do, sdpa_in
        torch.cuda.empty_cache()


def serve_long(torch, cfg) -> None:
    """Phase 9 (b): a 4096-token prompt and three of 16-48 tokens, 16 new
    each, on 4 slots of 4608 positions, through whole-prompt admission (the
    flash prefill, the GEMM at M = 4 x 4096) and 256-token chunks, dense and
    paged, as phase 8 (b)."""
    from repro_torch.serve.engine import Request

    slots, new = 4, 16
    serve, _ = packed_model(torch, cfg, SEED + 13)
    gen = torch.Generator().manual_seed(LONG_SEED)
    lens = [LONG_S] + torch.randint(16, 49, (3,), generator=gen).tolist()
    reqs = [Request(uid=i, prompt=torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist(),
                    max_new_tokens=new) for i, n in enumerate(lens)]
    log(f"  {len(reqs)} requests submitted at once, prompts {lens} tokens, {new} new each, "
        f"{slots} slots, max_seq {LONG_SEQ}, K 8 / V 4 state (seed {LONG_SEED})")
    admission_paths(torch, cfg, serve, reqs, slots, LONG_SEQ, new, stream=False)
    del serve
    torch.cuda.empty_cache()


def _long_step(torch, params, cfg, batch, bits, seq: int, remat: bool):
    """One QAT step's loss and gradients at full width, batch 1: the layer
    bodies recomputed in the backward or not (``remat``), the loss in two
    chunks (each recomputed either way).  Run twice; returns the second run's
    loss, gradients and wall time, the peak allocated over both, and each
    run's (fake-quant, STE) launches."""
    from repro_torch import kernels
    from repro_torch.models import decoder
    from repro_torch.train.train_step import value_and_grad

    def loss_fn(p, b, bb):
        hidden = decoder.forward(p, cfg, b["tokens"], bits=bb, remat=remat)
        return decoder.lm_loss_from_hidden(p, cfg, hidden, b["labels"], bits=bb,
                                           loss_chunk=seq // 2)

    free_memory(torch)           # the earlier phases' garbage out of both peaks
    launches = []
    for _ in range(2):
        out = None               # the first run's gradients go before the second starts
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = value_and_grad(loss_fn, params, batch, bits)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches.append((kernels.LAUNCHES["fake_quant"], kernels.LAUNCHES["fake_quant_ste_bwd"]))
        if any(kernels.PLAIN_CALLS.values()):
            raise AssertionError(f"phase 9 (c): plain calls {_nonzero(kernels.PLAIN_CALLS)}")
    return out[0], out[1], dt, torch.cuda.max_memory_allocated(), launches


def long_loss(torch, cfg) -> None:
    """Phase 9 (c): one QAT step's loss and gradients at full width and depth,
    batch 1, through the flash path and the fake-quant kernels (the "mixed"
    policy's bits), the loss in two chunks: with each layer body recomputed
    in the backward (``remat=True``, the default) and without, at the
    longest seq of 4096, 3072 and 2560 at which the run without fits; peaks,
    wall times and launches side by side, losses and gradients equal."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import TokenTask, global_batch
    from repro_torch.launch.dryrun import dryrun_policy
    from repro_torch.models import decoder
    from repro_torch.quant import apply as qapply

    smi = smi_line()
    params = decoder.init(cfg, torch.Generator(device="cuda").manual_seed(SEED + 21),
                          device="cuda")
    specs = qapply.layer_specs(params, cfg)
    bits = qapply.bits_for_scan(dryrun_policy(specs, "mixed"), params, cfg)
    per_fwd = _fq_per_forward(cfg, specs, n_chunks=2)
    want = {False: (per_fwd + 2, per_fwd),          # only the two loss chunks recomputed
            True: (per_fwd + _fq_recomputed(cfg, specs, n_chunks=2), per_fwd)}

    def batch_of(seq):
        return {k: v.to("cuda") for k, v in global_batch(
            TokenTask(cfg.vocab_size), cfg, ShapeSpec("long", "train", seq, 1), 0).items()}

    def fits(seq, remat) -> bool:
        try:
            runs[remat] = _long_step(torch, params, cfg, batch_of(seq), bits, seq, remat)
            return True
        except torch.cuda.OutOfMemoryError:
            return False

    runs, fits_remat = {}, None
    for seq in (LONG_S, 3072, 2560):
        if not fits(seq, False):
            log(f"  ({smi}) remat=False: seq {seq} does not fit in the card's memory; trying a "
                f"shorter one")
            if seq == LONG_S:            # whether the recomputing step fits where this did not
                fits_remat = fits(seq, True)
                runs.clear()
            continue
        # the first run's gradients wait on the host while the second runs
        host = [g.cpu() for g in runs[False][1]]
        runs[False] = runs[False][:1] + (host,) + runs[False][2:]
        runs[True] = _long_step(torch, params, cfg, batch_of(seq), bits, seq, remat=True)
        if seq == LONG_S:
            fits_remat = True
        break
    else:
        raise AssertionError("phase 9 (c): no seq above 2048 fits without remat")
    for remat, (loss, grads, dt, peak, launches) in runs.items():
        if any(got != want[remat] for got in launches):
            raise AssertionError(f"phase 9 (c) remat={remat}: fake-quant and STE launches "
                                 f"{launches} (want {want[remat]} a step)")
        if not (torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)):
            raise AssertionError(f"phase 9 (c) remat={remat}: non-finite loss or gradient")
        cut = "" if seq == LONG_S else f" (not {LONG_S}: it did not fit without remat)"
        log(f"  ({smi}) remat={remat}: QAT step at seq {seq}{cut}, batch 1, {cfg.n_layers} "
            f"layers, two "
            f"loss chunks: loss {float(loss):.6f}, loss + gradients {dt:.3f} s (the second "
            f"call), peak allocated {peak / 1e9:.3f} GB, fake-quant and STE launches "
            f"{launches[-1]} a step")
    (l0, g0), (l1, g1) = runs[False][:2], runs[True][:2]
    # the tied embedding is read by the lookup and both head chunks: its
    # gradient's terms could only be summed in another order (rel 1e-6)
    tied = {i for i, (path, _) in enumerate(qapply._walk(params)) if path == ("embed",)}
    diffs, exact = [], 0
    for i, (a, b) in enumerate(zip(g0, g1)):
        b = b.cpu()
        exact += torch.equal(a, b)
        if not torch.equal(a, b) and (i not in tied or rel(b, a) > 1e-6):
            diffs.append((i, rel(b, a)))
    if not torch.equal(l0.cpu(), l1.cpu()) or diffs:
        raise AssertionError(f"phase 9 (c): remat=True against remat=False: loss "
                             f"{float(l0):.9g} / {float(l1):.9g}, differing leaves {diffs[:5]}")
    p0, p1 = runs[False][3], runs[True][3]
    rest = "" if exact == len(g0) else " (the tied embedding's within rel 1e-6)"
    log(f"  ok ({smi}) remat=True against remat=False at seq {seq}: the loss and {exact} of "
        f"{len(g0)} gradient leaves bit-equal{rest}; peak {p1 / 1e9:.3f} against "
        f"{p0 / 1e9:.3f} GB "
        f"({p1 / p0:.3f}), wall {runs[True][2]:.3f} against {runs[False][2]:.3f} s "
        f"({runs[True][2] / runs[False][2]:.3f}); the remat=True step "
        f"{'fits' if fits_remat else 'does not fit'} at seq {LONG_S}")
    if not p1 < p0:
        raise AssertionError(f"phase 9 (c): remat=True peaks at {p1} B, not below {p0} B")
    del params, runs, g0, g1
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: degradation, faults and tracing
# ---------------------------------------------------------------------------

#: phase 10: the fault sites' steps; the draft's at step 0 (the first round,
#: before the pool's pressure sheds K to 0), the pool's at the first admission
#: turn with free slots and a queue after it, the others once the fleet decodes
FAULTS = {"nan_logit_draft": (0,), "pool_exhaustion": (1,), "nan_logit": (5,),
          "append_failure": (7,)}
LATE_AT, LATE_N, LATE_PRIORITY = 4, 4, 2


def degradation(torch, cfg, gap: float) -> None:
    """Phase 10 (a): phase 6's artifact served paged over 40 blocks under the
    checker, the chat fleet at priority 0 and, at turn 4, four more requests
    at priority 2, with one fault at each of four sites (``FAULTS``), the
    default shed policy (the straggler shed too), against the same engine
    without faults and with the late requests at priority 0 (so that it
    preempts nothing)."""
    from repro_torch import kernels
    from repro_torch.core.policy import PolicyArtifact
    from repro_torch.runtime.resilience import FailureInjector
    from repro_torch.serve.engine import ServeEngine

    slots, seq, new = SERVE_SLOTS, 1024, 32
    art = PolicyArtifact.load(str(ROOT / "build" / "phase6_policy.json"))
    serve, _ = packed_model(torch, cfg, 7)
    fleet = chat_requests(torch, cfg, 16 + LATE_N, new)
    early, late = fleet[:16], fleet[16:]
    log(f"  {len(early)} chat requests at priority 0, {LATE_N} more at turn {LATE_AT}; paged over "
        f"40 blocks, {slots} slots, K {art.draft_k} with a {art.draft_policy.mean_bits():.0f}-bit "
        f"draft; faults {FAULTS}")
    runs = {}
    for key, priority, inj in (("fault-free", 0, None),
                               ("faults", LATE_PRIORITY, FailureInjector(schedule=FAULTS))):
        gc.collect()
        torch.cuda.empty_cache()
        eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq, artifact=art,
                          pool_blocks=40, debug_invariants=True, fault_injector=inj)
        collect = record_logits(torch, eng)

        def hook(e, step, priority=priority):
            if step == LATE_AT and late[0].uid not in e.lifecycles:
                for r in late:
                    e.submit(dataclasses.replace(r, priority=priority))

        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = eng.run(early, step_hook=hook)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        if any(st["plain_calls"].values()) or not st["launches"]["quant_kv_decode_step_paged"]:
            raise AssertionError(f"{key}: launches {st['launches']}, plain {st['plain_calls']}")
        if eng.pool.allocated or eng.pool.reserved or sorted(out) != [r.uid for r in fleet]:
            raise AssertionError(f"{key}: pool ends with {eng.pool.allocated} allocated, "
                                 f"{eng.pool.reserved} reserved; streams {sorted(out)}")
        acts = [e["action"] for e in st["shed_events"]]
        log(f"  ok ({key}): {st['decode_steps']} steps ({st['spec_steps']} speculative), "
            f"{st['completed']} done, {st['failed']} failed, {st['preemptions']} preempted, "
            f"{st['nan_quarantined']} quarantined, {st['nan_draft_fallbacks']} draft fallbacks; "
            f"shed events {acts}; median step {st['decode_step_median_s'] * 1e3:.3f} ms over "
            f"{wall:.3f} s; pool peak {st['pool_peak_allocated']} blocks, ends empty")
        runs[key] = (eng, out, collect(), inj)
        del eng
    (ref_eng, ref, ref_rows, _), (eng, out, rows, inj) = runs["fault-free"], runs["faults"]
    st, lcs = eng.stats(), eng.lifecycles
    if not inj.exhausted:
        raise AssertionError(f"faults fired {inj.fired}, scheduled {FAULTS}")
    if ref_eng.stats()["preemptions"] or ref_eng.stats()["failed"]:
        raise AssertionError("the fault-free run preempted or failed a request")
    diags = [lc.diagnostic for lc in lcs.values() if lc.state.value == "failed"]
    nan = sum("non-finite logits" in d for d in diags)
    append = sum("append bookkeeping" in d for d in diags)
    if (nan, append, len(diags)) != (1, 1, 2) or st["nan_quarantined"] != 1:
        raise AssertionError(f"failures {diags}, quarantined {st['nan_quarantined']}")
    if st["nan_draft_fallbacks"] < 1:
        raise AssertionError("the draft's NaN fell back nowhere")
    acts = {e["action"] for e in st["shed_events"]}
    if not (acts & {"spec_shed", "straggler_shed"} and "preempt" in acts):
        raise AssertionError(f"shed events {st['shed_events']}")
    victims = [u for u, lc in lcs.items() if lc.preemptions]
    if any(lcs[u].priority == LATE_PRIORITY for u in victims):
        raise AssertionError(f"a priority-{LATE_PRIORITY} request was preempted: {victims}")
    for u in victims:
        lc = lcs[u]
        if lc.state.value == "done" and len(out[u]) != new:
            raise AssertionError(f"victim {u}: {len(out[u])} tokens of {new}")
        if out[u][: len(lc.resume_tokens)] != lc.resume_tokens:
            raise AssertionError(f"victim {u}: the stream does not start with its resume tokens")
    untouched = [u for u, lc in lcs.items() if lc.state.value == "done" and not lc.preemptions]
    # a victim's tokens before its preemption, and every casualty's, against the
    # fault-free run; untouched streams whole; all up to near-ties
    upto = {u: len(lcs[u].resume_tokens) if lcs[u].preemptions else len(out[u]) for u in out}
    parted = near_ties(ref, out, ref_rows, rows, gap, "the faults leave the fault-free run",
                       uids=sorted(out), upto=upto)
    log(f"  ok {len(victims)} victims (none at priority {LATE_PRIORITY}), every resume prefix "
        f"and every untouched stream ({len(untouched)}) equal to the fault-free run but {parted} "
        f"parted at near-ties (2 x gap {2 * gap:.4g}); one failure each from nan_logit and "
        f"append_failure, the draft's fell back; no block leaked")
    del runs, ref_eng, eng, serve
    torch.cuda.empty_cache()


def artifact_refusal(torch, cfg) -> None:
    """Phase 10 (b): the ``artifact_mismatch`` fault refuses construction."""
    from repro_torch.core.policy import PolicyArtifact
    from repro_torch.runtime.resilience import FailureInjector
    from repro_torch.serve.engine import ServeEngine

    art = PolicyArtifact.load(str(ROOT / "build" / "phase6_policy.json"))
    serve, _ = packed_model(torch, cfg, 7)
    inj = FailureInjector(schedule={"artifact_mismatch": (0,)})
    try:
        ServeEngine(cfg, serve, max_slots=2, max_seq=1024, artifact=art, fault_injector=inj)
    except ValueError as e:
        if "disagree with the policy artifact" not in str(e) or not inj.exhausted:
            raise
        log(f"  ok artifact_mismatch refused construction: {e}")
    else:
        raise AssertionError("the artifact_mismatch fault did not refuse construction")
    del serve
    torch.cuda.empty_cache()


#: phase 10 (c): untraced and traced runs in pairs, the order swapped each pair
TRACE_PAIRS = 4


def phase4_repeats(torch, cfg, gap: float) -> None:
    """Phase 10 (c): phase 4's dense run from an artifact that carries the
    shift-add cost model's report: batched admission, one prefill a request
    (``batch_admission=False``: equal streams, or near-ties), and then
    ``TRACE_PAIRS`` pairs of an untraced and a traced batched run, the order
    swapped each pair (streams identical, the last Chrome trace saved and
    validated, its phase shares, the step medians of both sides, measured
    costs and calibration ratios)."""
    from repro_torch.core.policy import PolicyArtifact
    from repro_torch.cost.shift_add import ShiftAddCostModel
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve.engine import Request, ServeEngine

    slots, seq, new, n_req = 4, 512, 16, 8
    serve, policy = packed_model(torch, cfg, SEED + 3)
    art = PolicyArtifact.build(policy, state_policy=state_policy(cfg, slots, seq),
                               report=ShiftAddCostModel().report(policy).as_costs())
    gen = torch.Generator().manual_seed(SEED + 4)
    lens = torch.randint(8, 25, (n_req,), generator=gen).tolist()
    reqs = [Request(uid=i, prompt=torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist(),
                    max_new_tokens=new) for i, n in enumerate(lens)]

    def serve_once(key, traced=False, record=False, **kw):
        gc.collect()
        eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq, artifact=art,
                          shed=steady(), **kw)
        collect = record_logits(torch, eng) if record else None
        if traced:
            obs_trace.enable()
        try:
            out = eng.run(reqs)
            torch.cuda.synchronize()
        finally:
            obs_trace.disable()
        st = eng.stats()
        if any(st["plain_calls"].values()) or sorted(out) != list(range(n_req)):
            raise AssertionError(f"{key}: plain calls {st['plain_calls']}, streams {sorted(out)}")
        return out, collect() if record else None, st, eng

    a, rows_a, sa, _ = serve_once("batched", record=True)
    b, rows_b, sb, _ = serve_once("per request", record=True, batch_admission=False)
    parted = near_ties(a, b, rows_a, rows_b, gap, "one prefill a request leaves batched")
    log(f"  ok batch_admission=False: {sb['admissions']} prefills against {sa['admissions']}; "
        f"streams equal in {n_req - parted} of {n_req} ({parted} parted at near-ties); median "
        f"step {sb['decode_step_median_s'] * 1e3:.3f} ms against "
        f"{sa['decode_step_median_s'] * 1e3:.3f}")
    medians = {False: [], True: []}
    for i in range(TRACE_PAIRS):
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            out, _, st, eng = serve_once("traced" if traced else "untraced", traced=traced)
            if out != a:
                raise AssertionError(f"pair {i}, traced {traced}: streams differ from the "
                                     f"first untraced run's")
            medians[traced].append(st["decode_step_median_s"] * 1e3)
            if traced:
                ts, teng = st, eng
    tr = obs_trace.get_tracer()
    path = ROOT / "build" / "phase10_trace.json"
    doc = tr.save(str(path))
    obs_trace.validate_chrome_trace(doc)
    tr.clear()
    rep = teng.trace_report()
    shares = ", ".join(f"{n} {p['fraction_of_step'] * 100:.1f}%" for n, p in rep["phases"].items())
    log(f"  ok traced runs: streams identical to the untraced runs; {len(doc['traceEvents'])} "
        f"events of the last saved to {path.relative_to(ROOT)} and validated; {rep['steps']} "
        f"turns, {rep['attributed_fraction'] * 100:.1f}% in named phases: {shares}")
    wins = sum(t > u for u, t in zip(medians[False], medians[True]))
    log(f"  median decode step over {TRACE_PAIRS} pairs (order swapped each pair): traced "
        f"{statistics.median(medians[True]):.3f} ms {[round(m, 3) for m in medians[True]]}, "
        f"untraced {statistics.median(medians[False]):.3f} ms "
        f"{[round(m, 3) for m in medians[False]]}; traced slower in {wins} of {TRACE_PAIRS} pairs")
    cal = ts.get("calibration", {})
    if "container_bytes" not in cal or "latency_s" not in cal:
        raise AssertionError(f"calibration {cal}")
    log(f"  measured costs {teng.measured_costs()}")
    log("  calibration against the artifact's shift-add report: " + "; ".join(
        f"{m} predicted {r['predicted']:.6g}, measured {r['measured']:.6g}, ratio "
        f"{r['ratio']:.6g}" for m, r in cal.items()))
    del teng, serve
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: the paper's CNN path
# ---------------------------------------------------------------------------

#: benchmarks/common.py's task and stage menu; table1_sigma_kl.py's recipe
CNN_TASK = dict(n_classes=64, noise=2.2, seed=1)
CNN_STAGES = {"mini": ((16, 1), (32, 1), (64, 1)), "small": ((16, 2), (32, 2), (64, 2)),
              "wide": ((24, 2), (48, 2), (96, 2))}
CNN_PRETRAIN = 400
TABLE1 = dict(acc_t=0.88, size_frac=0.55, acc_buffer=0.01, res_buffer=0.10,
              cc=dict(phase1_max_iters=2, phase2_max_iters=10, phase1_qat_epochs=2,
                      phase2_qat_epochs=1, stagnation_patience=4), steps_per_epoch=10)


def _cnn_cfg(name: str):
    from repro_torch.models import cnn

    return cnn.CNNConfig(name=f"resnet_{name}", stages=CNN_STAGES[name],
                         n_classes=CNN_TASK["n_classes"])


def check_cnn_fake_quant(torch, gen) -> None:
    """Phase 11 (a): row 10's forward and STE backward on every conv (HWIO,
    one scale per output channel over H*W*I rows) and the fc of resnet_wide,
    bits 2-8 and 32, f32 and bf16, bytes equal to the plain versions."""
    from repro_torch.core.quantizer import weight_scale
    from repro_torch.kernels.fake_quant.kernel import fake_quant_cuda, fake_quant_ste_bwd_cuda
    from repro_torch.kernels.fake_quant.ref import fake_quant_ref, fake_quant_ste_bwd_ref
    from repro_torch.models import cnn

    cfg = _cnn_cfg("wide")
    specs = cnn.quant_layer_specs(cnn.init(cfg, gen, device="cuda"), cfg)
    shapes = sorted({s.shape for s in specs})
    for shape in shapes:
        fan_in = 1
        for d in shape[:-1]:
            fan_in *= d
        w32 = torch.randn(shape, generator=gen, device="cuda") * (2.0 / fan_in) ** 0.5
        g32 = torch.randn(shape, generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            w, g = w32.to(dt), g32.to(dt)
            for bits in FQ_BITS:
                scale = weight_scale(w, bits, channel_axis=-1)
                ok = same_bytes(torch, fake_quant_cuda(w, scale, bits),
                                fake_quant_ref(w, scale, bits))
                ok = ok and same_bytes(torch, fake_quant_ste_bwd_cuda(w, scale, bits, g),
                                       fake_quant_ste_bwd_ref(w, scale, bits, g))
                if not ok:
                    raise AssertionError(f"fake_quant {shape} bits={bits} {dt}: kernel bytes "
                                         f"differ from the plain version")
    log(f"  ok (a) row 10 forward and STE backward bytes exact on resnet_wide's "
        f"{len(shapes)} distinct conv and fc shapes {shapes}, bits {FQ_BITS}, f32 and bf16")


def restore_checkpoints(torch) -> None:
    """Phase 11 (b): the committed checkpoints restored through the port (the
    loader only: they were trained on the JAX task's prototypes, which the
    port's task does not draw)."""
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.models import cnn
    from repro_torch.train.optimizer import leaves as _leaves

    for name in CNN_STAGES:
        cfg = _cnn_cfg(name)
        root = ROOT / "artifacts" / f"cnn_{name}_s0"
        like = cnn.init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        tree, extra = restore(str(root), like)
        leaves = [(a, b) for a, b in zip(_leaves(tree), _leaves(like))]
        if any(a.shape != b.shape or a.dtype != b.dtype or a.device != b.device
               for a, b in leaves) or not all(torch.isfinite(a).all() for a, _ in leaves):
            raise AssertionError(f"checkpoint {name}: restored leaves differ in shape, dtype or "
                                 f"device, or are not finite")
        log(f"  ok (b) {root.relative_to(ROOT)} step {latest_step(str(root))}: {len(leaves)} "
            f"leaves, {sum(a.numel() for a, _ in leaves)} values, shapes and dtypes as "
            f"{cfg.name}'s; manifest extra {extra}")


def spearman(a, b) -> float:
    """Rank correlation, as benchmarks/table1_sigma_kl.py computes it."""
    import numpy as np

    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = float(np.sqrt((ra ** 2).sum() * (rb ** 2).sum())) or 1.0
    return float((ra * rb).sum() / denom)


def table1_recipe(torch) -> None:
    """Phase 11 (c): benchmarks/table1_sigma_kl.py's recipe through the port:
    resnet_mini pretrained 400 steps on the port's own image task, then the
    controller at top-1 >= 0.88 and size <= 0.55 x the int8 MiB.  Counts set
    to 0 just before pretraining and read after the controller: 10 fake-quant
    launches a forward, 10 STE launches a training step."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import stats
    from repro_torch.core.controller import ControllerConfig, SigmaQuantController
    from repro_torch.core.policy import Targets
    from repro_torch.data.images import ImageTask
    from repro_torch.models import cnn
    from repro_torch.quant.env import CNNQuantEnv

    cfg = _cnn_cfg("mini")
    params = cnn.init(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    env = CNNQuantEnv(params, cfg, ImageTask(**CNN_TASK),
                      steps_per_epoch=TABLE1["steps_per_epoch"], seed=SEED)
    step_fn, times = env._step_fn, []

    def timed(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*a)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    env._step_fn = timed
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    env.pretrain(CNN_PRETRAIN)
    float_acc = env.float_accuracy()
    t_pre = time.perf_counter() - t0
    int8 = sum(s.n_params for s in env.layer_infos()) / 2**20
    targets = Targets(acc_t=TABLE1["acc_t"], res_t=TABLE1["size_frac"] * int8,
                      acc_buffer=TABLE1["acc_buffer"], res_buffer=TABLE1["res_buffer"])
    result = SigmaQuantController(env, targets, ControllerConfig(**TABLE1["cc"])).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)
    n = len(env.layer_infos())
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(fake_quant=n * (env.train_steps + env.eval_passes),
                fake_quant_ste_bwd=n * env.train_steps)
    if launches != want or any(plain.values()):
        raise AssertionError(f"phase 11 (c): launches {launches} (the run's {env.train_steps} "
                             f"training steps and {env.eval_passes} evaluations predict {want}), "
                             f"plain calls {plain}")
    if not 0.5 < float_acc <= 1.0 or not 0.0 <= result.acc <= 1.0:
        raise AssertionError(f"phase 11 (c): float top-1 {float_acc}, final {result.acc}")
    ref = json.loads((ROOT / "artifacts" / "bench" / "table1.json").read_text())
    sig = env.sigmas()
    smi = smi_line()
    log(f"  ({smi}) {cfg.name} pretrained {CNN_PRETRAIN} steps in {t_pre:.2f} s: float top-1 "
        f"{float_acc:.4f} (the committed mini checkpoint: 0.9238 on the JAX task)")
    log(f"  {'layer':<14}{'final':>6}{'sigma':>10}{'D_KL':>11}   table1.json: final, sigma, D_KL")
    bits = []
    for i, (spec, row) in enumerate(zip(env.layer_infos(), ref["rows"])):
        b = result.policy.bits[spec.name]
        dkl = float(stats.quantization_kl(cnn.get_weight(env.params, spec.name), b))
        bits.append(b)
        log(f"  {spec.name:<14}{b:>6}{sig[i]:>10.5f}{dkl:>11.6f}   {row['final_bits']}, "
            f"{row['sigma']:.5f}, {row['d_kl']:.6f}")
    rho = spearman(sig, np.asarray(bits, float))
    steps = statistics.median(times)
    log(f"  ({smi}) spearman(sigma, final bits) {rho:+.3f} (table1.json {ref['spearman_sigma_bits']:+.3f}); "
        f"final top-1 {result.acc:.4f} ({ref['final_acc']:.4f}), size "
        f"{result.resource:.4f} MiB ({ref['final_size_mib']:.4f}; limit {targets.res_t:.4f}), "
        f"success={result.success}, {len(result.trace)} controller entries; wall "
        f"{wall:.2f} s; QAT step median {steps * 1e3:.3f} ms over {len(times)} steps")
    log(f"  launches {launches}: {env.train_steps} training steps x {n} STE, "
        f"{env.train_steps + env.eval_passes} forwards x {n} fake-quant, as predicted; "
        f"plain calls 0")


# ---------------------------------------------------------------------------
# phase 12: the rest of the search (roofline, --trace, --ckpt, the report,
# baselines, calibration) and the trainer
# ---------------------------------------------------------------------------


#: phase 12 (a): the roofline backend's decode batch, and the latency limit as a
#: share of the uniform 8-bit policy's roofline latency (8-bit weights stream
#: about 2.5 GB a step, 4-bit half that: the limit forces mixed containers)
ROOF_BATCH = 4
ROOF_FRAC = 0.6
#: phase 12 (c): the trainer's command (gemma-2b at full width, cut to 2 layers;
#: the 256000 x 2048 tied embedding stays), its checkpoints every 4 steps, and
#: the step the replay run fails at (it restores step 3 and replays 4-7)
TRAIN_ARGV = ["--arch", ARCH, "--layers", "2", "--steps", "8", "--batch", "8", "--seq", "128",
              "--wbits", "4", "--save-every", "4", "--seed", str(SEED)]
TRAIN_FAIL_AT = 5
#: phase 12 (d): the calibration input, layer 0's ``w_down`` input (d_ff 16384
#: values a token) at batch 8: seq 128 gives 8 x 128 x 16384 = 2^24 values,
#: exactly ``torch.quantile``'s largest; 129 crosses it
CALIB_SEQ = (128, 129)


def ttft_samples(torch, eng) -> dict:
    """TTFT p50 and p99 (s) from the engine's raw samples, one a request that
    emitted a token (``lifecycles[uid].ttft()``), by linear interpolation:
    the ``stats()`` histogram's edges double from 1 us, so its percentiles are
    bucket edges, not times."""
    got = [lc.ttft() for lc in eng.lifecycles.values() if lc.ttft() is not None]
    x = torch.tensor(got, dtype=torch.float64)
    return {"p50": float(x.quantile(0.5)), "p99": float(x.quantile(0.99))}


def _nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def roofline_search(torch, cfg) -> dict:
    """Phase 12 (a): the search's ``main`` with the roofline backend, the
    trace and the checkpoint; the checkpoint restored, packed and served."""
    import shutil

    from repro_torch import kernels
    from repro_torch.checkpoint import store as ck
    from repro_torch.core.policy import BitPolicy, PolicyArtifact
    from repro_torch.cost import RooflineCostModel
    from repro_torch.kvcache import state_layer_infos, verify_state_bits
    from repro_torch.launch import search
    from repro_torch.models import decoder
    from repro_torch.obs import calibration as obs_cal
    from repro_torch.obs import search as obs_search
    from repro_torch.obs import trace as obs_trace
    from repro_torch.quant import apply as qapply
    from repro_torch.serve.engine import ServeEngine

    smi = smi_line()
    params = decoder.init(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    specs = qapply.layer_specs(params, cfg)
    del params
    torch.cuda.empty_cache()
    roof = RooflineCostModel(batch=ROOF_BATCH)
    lat8 = roof.report(BitPolicy.uniform(specs, 8)).latency_s
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out, trace, ckpt = (build / "phase12_policy.json", build / "phase12_trace.json",
                        build / "phase12_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    # phase 7's command with the latency limit in the size limit's place
    argv = search_argv(cfg, ["--backend", "roofline", "--decode-batch", str(ROOF_BATCH),
                             "--limit", f"latency_s={ROOF_FRAC * lat8!r}", "--out", str(out),
                             "--trace", str(trace), "--ckpt", str(ckpt)],
                       base=[a for a in SEARCH_ARGV if a not in SEARCH_LIMIT])
    captured, saves = {}, []
    real_run, real_save = search.run, search.ck.save

    def capture(args, **kw):
        captured["run"] = real_run(args, **kw)
        return captured["run"]

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        d = real_save(*a, **kw)
        saves.append(time.perf_counter() - t0)
        return d

    search.run, search.ck.save = capture, timed_save
    try:
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        rc = search.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        search.run, search.ck.save = real_run, real_save
    launches, plain = dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)
    artifact, result, env, phases = captured.pop("run")
    want = search_launches(cfg, env, phases)
    if rc not in (0, 1) or launches != want or any(plain.values()):
        raise AssertionError(f"phase 12 (a): rc {rc}, launches {launches} (the run predicts "
                             f"{want}), plain calls {plain}")
    del env, phases
    torch.cuda.empty_cache()
    tr = obs_trace.get_tracer()
    srep = obs_search.search_trace_report(tr.events())
    doc = json.loads(trace.read_text())
    obs_trace.validate_chrome_trace(doc)
    tr.clear()
    pred = roof.report(artifact.policy)
    log(f"  ({smi}) search --backend roofline in {wall:.2f} s (rc {rc}): {_phase_walls(artifact)}; "
        f"mean {artifact.policy.mean_bits():.3f} bits, state mean "
        f"{artifact.state_policy.mean_bits():.3f} bits")
    log(f"  roofline at decode batch {ROOF_BATCH} (H100 SXM: 989 TFLOP/s, 3.35 TB/s): latency_s "
        f"{artifact.report['latency_s']:.6g} (memory_s {pred.detail['memory_s']:.6g}, compute_s "
        f"{pred.detail['compute_s']:.6g}) against the limit {ROOF_FRAC * lat8:.6g} "
        f"({ROOF_FRAC} x uniform 8-bit {lat8:.6g})")
    log(f"  trace {trace.relative_to(ROOT)}: {len(doc['traceEvents'])} events, validated; "
        f"{srep['attributed_fraction'] * 100:.1f}% of {srep['total_s']:.2f} s attributed to env "
        f"work")
    log(f"    launches {launches}, as predicted; plain calls 0")
    # the checkpoint: the artifact and the params back
    step = ck.latest_step(str(ckpt))
    nbytes = _dir_bytes(ckpt / f"step_{step:08d}")
    store = ck.CheckpointStore(str(ckpt))
    art = store.load_policy_artifact()
    if art.to_json() != PolicyArtifact.load(str(out)).to_json():
        raise AssertionError("phase 12 (a): the checkpoint's artifact differs from --out's")
    like_tree = decoder.init(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, extra = store.restore_latest(like_tree)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    del like_tree
    torch.cuda.empty_cache()
    log(f"  ({smi}) checkpoint step {step}: {nbytes / 1e9:.3f} GB written in {saves[0]:.2f} s "
        f"(save), restored in {t_restore:.2f} s; artifact equal to --out's; float loss "
        f"{extra['float_loss']:.4f}")
    shutil.rmtree(ckpt)
    # (a) continued: pack the restored params and serve phase 7 (c)'s requests
    serve = qapply.quantize_for_serve(decoder.unstack_layers(params, cfg), art, cfg)
    del params
    torch.cuda.empty_cache()
    qapply.verify_packed_bits(serve, art)
    slots, seq, new = STATE_SLOTS, STATE_SEQ, 16
    eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq, artifact=art, shed=steady())
    del serve
    verify_state_bits(eng.state, art, surface=state_layer_infos(cfg, slots, seq))
    reqs = search_requests(torch, cfg, new)
    torch.cuda.synchronize()
    kernels.reset_counts()
    streams = eng.run(reqs)
    torch.cuda.synchronize()
    st = eng.stats()
    packed = _packed_linears(eng.params)
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(quant_gemv=packed * st["decode_steps"], quant_matmul=packed * st["admissions"],
                quant_kv_decode_step=cfg.n_layers * st["decode_steps"])
    if sorted(streams) != list(range(len(reqs))) or any(len(v) != new for v in streams.values()):
        raise AssertionError("phase 12 (a): incomplete streams")
    if st["launches"] != want or any(st["plain_calls"].values()):
        raise AssertionError(f"phase 12 (a): launches {st['launches']} (want {want}), plain "
                             f"calls {st['plain_calls']}")
    cal = obs_cal.calibration_ratios({"latency_s": artifact.report["latency_s"]},
                                     {"latency_s": st["decode_step_median_s"]})
    log(f"  ok served {len(reqs)} requests x {new} tokens on {slots} slots from the restored "
        f"checkpoint: {st['decode_steps']} decode steps, median step "
        f"{st['decode_step_median_s'] * 1e3:.3f} ms against the roofline's "
        f"{artifact.report['latency_s'] * 1e3:.4f} ms (calibration ratio "
        f"{cal['latency_s']['ratio']:.2f}, not gated: the roofline prices weights and state, "
        f"the step pays the host, the head and attention too)")
    log(f"    launches {st['launches']}")
    del eng
    torch.cuda.empty_cache()
    return {"artifact": out, "specs": specs, "search": launches, "serve": st["launches"]}


def render_phase_report(artifact_path: Path) -> None:
    """Phase 12 (b): the explain report from the artifact alone."""
    from repro_torch.core.policy import PolicyArtifact
    from repro_torch.launch import report

    md = report.render_report(PolicyArtifact.load(str(artifact_path)))
    path = ROOT / "build" / "phase12_report.md"
    path.write_text(md + "\n")
    need = ("## Budget", "| latency_s |", "## Policies", "### Weight policy",
            "### Decode-state policy", "### phase: weight", "### phase: state")
    missing = [n for n in need if n not in md]
    if missing:
        raise AssertionError(f"phase 12 (b): the report lacks {missing}")
    log(f"  ok report {path.relative_to(ROOT)}: {len(md.splitlines())} lines, budget, policy "
        f"and phase sections present")


def _first_difference(torch, a, b) -> str:
    from repro_torch.core.baselines import leaf_paths
    from repro_torch.train import optimizer as opt_mod

    for path, x, y in zip(leaf_paths(a), opt_mod.leaves(a), opt_mod.leaves(b)):
        if not isinstance(x, torch.Tensor):
            if x != y:
                return f"{path}: {x} != {y}"
        elif not torch.equal(x, y):
            return f"{path}: max rel {rel(x, y):.3g}"
    return ""


def trainer(torch, cfg) -> dict:
    """Phase 12 (c): ``launch.train.main``, then the same run through
    ``TrainLoop`` with a failure at ``TRAIN_FAIL_AT``, held to the clean run
    bit for bit."""
    import shutil

    from repro_torch import kernels
    from repro_torch.checkpoint import store as ck
    from repro_torch.launch import train
    from repro_torch.quant import apply as qapply
    from repro_torch.runtime.loop import LoopConfig, TrainLoop
    from repro_torch.runtime.resilience import FailureInjector
    from repro_torch.train import optimizer as opt_mod

    smi = smi_line()
    build = ROOT / "build"
    clean_dir, replay_dir = build / "phase12_train_clean", build / "phase12_train_replay"
    for d in (clean_dir, replay_dir):
        shutil.rmtree(d, ignore_errors=True)
    loops, times, built = [], [], []
    real_build, real_loop, real_store = train.build, train.TrainLoop, train.CheckpointStore

    def timed_build(args):
        out = real_build(args)
        built.append(out[0])
        step = out[2]

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return res

        return out[:2] + (timed,) + out[3:]

    class Recording(real_loop):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loops.append(self)

    class KeepOne(real_store):
        def __init__(self, root, **kw):
            super().__init__(root, **dict(kw, keep=1))

    train.build, train.TrainLoop, train.CheckpointStore = timed_build, Recording, KeepOne
    try:
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        rc = train.main(TRAIN_ARGV + ["--ckpt", str(clean_dir)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train.build, train.TrainLoop, train.CheckpointStore = real_build, real_loop, real_store
    launches, plain = dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)
    clean = loops[0]
    args = train.build_parser().parse_args(TRAIN_ARGV + ["--ckpt", str(replay_dir)])
    cfg2 = built[0]
    specs2 = qapply.layer_specs(clean.state[0], cfg2)
    per_fwd, recomputed = _fq_per_forward(cfg2, specs2), _fq_recomputed(cfg2, specs2)
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(fake_quant=(per_fwd + recomputed) * args.steps,
                fake_quant_ste_bwd=per_fwd * args.steps)
    if rc != 0 or launches != want or any(plain.values()) or len(times) != args.steps:
        raise AssertionError(f"phase 12 (c): rc {rc}, launches {launches} (want {want}), plain "
                             f"calls {plain}, {len(times)} timed steps")
    tensors = [x for x in opt_mod.leaves(clean.state) if isinstance(x, torch.Tensor)]
    n_params = sum(p.numel() for p in opt_mod.leaves(clean.state[0]))
    state_bytes = sum(x.numel() * x.element_size() for x in tensors)
    log(f"  ({smi}) launch.train.main: {cfg2.name}, d_model {cfg2.d_model}, vocabulary "
        f"{cfg2.vocab_size}, {cfg2.n_layers} layers ({n_params / 1e6:.1f} M params, state "
        f"{state_bytes / 1e9:.3f} GB with the moments), "
        f"{args.steps} steps of {args.batch} x {args.seq} at {args.wbits} bits in {wall:.2f} s: "
        f"step median {statistics.median(times[1:]) * 1e3:.3f} ms (first {times[0] * 1e3:.3f}); "
        f"losses {[round(h['loss'], 4) for h in clean.history]}")
    log(f"    launches {launches}: {args.steps} steps x {per_fwd} + {recomputed} fake-quant (the "
        f"forward, the recompute) and {per_fwd} STE, as predicted; plain calls 0; checkpoints "
        f"kept {ck.list_steps(str(clean_dir))}")
    shutil.rmtree(clean_dir)
    # the same run with a failure: restore the latest save and replay
    _, _, step, state, batch_fn = real_build(args)
    store = ck.CheckpointStore(str(replay_dir), keep=1)
    kernels.reset_counts()
    t0 = time.perf_counter()
    loop = TrainLoop(step, state, batch_fn, store, LoopConfig(args.steps,
                                                              save_every=args.save_every),
                     injector=FailureInjector(fail_at=(TRAIN_FAIL_AT,)))
    loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replayed = args.steps + TRAIN_FAIL_AT - (TRAIN_FAIL_AT // args.save_every) * args.save_every
    replay = (kernels.LAUNCHES["fake_quant"], kernels.LAUNCHES["fake_quant_ste_bwd"])
    if loop.restarts != 1 or replay != ((per_fwd + recomputed) * replayed, per_fwd * replayed):
        raise AssertionError(f"phase 12 (c) replay: {loop.restarts} restarts, fake-quant and "
                             f"STE launches {replay} (want {(per_fwd + recomputed) * replayed}, "
                             f"{per_fwd * replayed})")
    diff = _first_difference(torch, loop.state, clean.state)
    if diff:
        raise AssertionError(f"phase 12 (c): the replayed run's state differs from the clean "
                             f"run's; first differing leaf {diff}")
    log(f"  ok ({smi}) TrainLoop with a failure at step {TRAIN_FAIL_AT}: restored step "
        f"{(TRAIN_FAIL_AT // args.save_every) * args.save_every - 1}, replayed to step "
        f"{args.steps} ({replayed} steps run) in {wall:.2f} s; final params and optimizer "
        f"state equal the clean run's bit for bit ({len(tensors)} tensors and the step count)")
    shutil.rmtree(replay_dir)
    params = clean.state[0]
    del loop, state, clean, loops
    torch.cuda.empty_cache()
    return {"params": params, "cfg": cfg2, "launches": launches}


def baselines_and_calibration(torch, cfg, specs, trained: dict) -> None:
    """Phase 12 (d): the baseline allocators on gemma-2b's registry, the
    Hutchinson traces of (c)'s 2-layer model and the HAWQ proxy, and
    ``calibrate`` on layer 0's ``w_down`` input."""
    import numpy as np

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import baselines
    from repro_torch.core.policy import BitPolicy
    from repro_torch.data.pipeline import TokenTask, global_batch
    from repro_torch.models import decoder, layers, registry
    from repro_torch.quant import apply as qapply
    from repro_torch.quant import calibration

    smi = smi_line()
    t0 = time.perf_counter()
    u8 = baselines.uniform_policy(specs, 8)
    greedy = baselines.bop_greedy_policy(specs, 0.45 * u8.bops())
    t_greedy = time.perf_counter() - t0
    if greedy.bops() > 0.45 * u8.bops():
        raise AssertionError(f"phase 12 (d): bop-greedy {greedy.bops()} over its budget")
    log(f"  bop-greedy on {cfg.name}'s {len(specs)} layers at 0.45 x uniform 8-bit BOPs: mean "
        f"{greedy.mean_bits():.3f} bits, {greedy.model_size_mib():.1f} MiB (uniform 8: "
        f"{u8.model_size_mib():.1f}), {t_greedy * 1e3:.1f} ms with uniform_policy")
    params, cfg2 = trained["params"], trained["cfg"]
    specs2 = qapply.layer_specs(params, cfg2)
    api = registry.get_api(cfg2)
    batch = {k: torch.as_tensor(np.asarray(v)).to("cuda", torch.long) for k, v in global_batch(
        TokenTask(cfg2.vocab_size, seed=SEED), cfg2, ShapeSpec("hvp", "train", 128, 8), 0).items()}
    stacked = {l.name: (("embed",) if l.name == "embed" else
                        ("layers",) + tuple(l.name.split(".")[1:])) for l in specs2}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    traces = baselines.hutchinson_layer_traces(lambda p: api.loss(p, cfg2, batch), params,
                                               stacked, torch.Generator(device="cuda")
                                               .manual_seed(SEED), n_samples=2)
    torch.cuda.synchronize()
    t_hvp = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(v) for v in traces.values()):
        raise AssertionError(f"phase 12 (d): non-finite traces {traces}")
    budget = 0.6 * BitPolicy.uniform(specs2, 8).model_size_mib()
    hawq = baselines.hawq_proxy_policy(specs2, traces, budget)
    log(f"  ({smi}) hutchinson_layer_traces, 2 samples on (c)'s float loss (batch 8 x 128, "
        f"the stacked leaf's trace for each of its layers): {t_hvp:.2f} s, peak allocated "
        f"{peak / 1e9:.3f} GB; embed {traces['embed']:.4g}, layer000.mlp.w_down "
        f"{traces['layer000.mlp.w_down']:.4g}; hawq proxy at {budget:.1f} MiB: mean "
        f"{hawq.mean_bits():.3f} bits, {hawq.model_size_mib():.1f} MiB, bits "
        f"{dict(sorted(hawq.bits.items()))}")
    # calibration on a real activation: layer 0's w_down input, caught in qdense
    real = layers.qdense
    caught = []

    def catch(w, x, **kw):
        if x.shape[-1] == cfg2.d_ff and not caught:
            caught.append(x.detach())
        return real(w, x, **kw)

    layers.qdense = catch
    try:
        with torch.no_grad():
            toks = global_batch(TokenTask(cfg2.vocab_size, seed=SEED), cfg2,
                                ShapeSpec("calib", "train", max(CALIB_SEQ), 8), 1)["tokens"]
            decoder.forward(params, cfg2, torch.as_tensor(np.asarray(toks)).to("cuda",
                                                                                torch.long))
    finally:
        layers.qdense = real
    act = caught[0]
    for seq in CALIB_SEQ:
        x = act[:, :seq]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = calibration.calibrate([x])
        lo, hi = float(r.lo), float(r.hi)
        t_cal = time.perf_counter() - t0
        # numpy in f64 places the interpolation point exactly; the port places it
        # in f32 as JAX does, which at 2^24 values can move it by one position:
        # the port's value must lie between the order statistics one beyond
        v = np.sort(x.float().reshape(-1).cpu().numpy().astype(np.float64))
        n = v.size
        ref = np.percentile(v, [100 - 99.9, 99.9])
        for got, want, p in ((lo, min(ref[0], 0.0), 100 - 99.9), (hi, max(ref[1], 0.0), 99.9)):
            q = p / 100 * (n - 1)
            band = v[max(int(np.floor(q)) - 1, 0)], v[min(int(np.ceil(q)) + 1, n - 1)]
            if not band[0] - 1e-12 <= got <= band[1] + 1e-12 and got != want:
                raise AssertionError(f"phase 12 (d): calibrate at {n} values: {got} outside "
                                     f"{band} (numpy f64 {want})")
        try:
            torch.quantile(x.float().reshape(-1), 0.999)
            quantile = "takes them"
        except RuntimeError:
            quantile = "refuses them"
        log(f"  ({smi}) calibrate on layer 0's w_down input, 8 x {seq} x {cfg2.d_ff} = {n} "
            f"values ({x.dtype}; torch.quantile {quantile}): [{lo:.6g}, {hi:.6g}] in "
            f"{t_cal * 1e3:.2f} ms; numpy f64 [{min(ref[0], 0.0):.6g}, {max(ref[1], 0.0):.6g}], "
            f"rel {abs(lo - min(ref[0], 0.0)) / max(abs(ref[0]), 1e-30):.2e} / "
            f"{abs(hi - max(ref[1], 0.0)) / max(abs(ref[1]), 1e-30):.2e} (held to the order "
            f"statistics one position beyond numpy's)")
    del params, trained["params"]
    torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# phase 13: deepseek-moe-16b (the MoE family, the expert axis of rows 1 and 2)
# ---------------------------------------------------------------------------


MOE_ARCH = "deepseek-moe-16b"
#: deepseek-moe-16b's expert linears, (N, K): w_gate and w_up, then w_down
MOE_LINEARS = {"w_gate": (1408, 2048), "w_down": (2048, 1408)}
#: capacities: decode and verify (the GEMV), a small and a large admission
#: and a long prefill (the GEMM)
MOE_C = (8, 16, 128, 1280)
MOE_BITS = (2, 4, 6, 8)
#: the kernels line's rows 1e and 2e: a layer's three expert linears at 4 bits in
#: bf16, at the decode capacity (8) and at (b)'s admissions' (16)
MOE_ROW_C = {"quant_gemv_experts": 8, "quant_matmul_experts": 16}
#: (a)'s row-2e lines: an admission's capacity (16), a 1000-token prefill's (128)
#: and a 10900-token prefill's (1280)
MOE_GEMM_C = (16, 128, 1280)
#: the routed buffers' decode: 4 token rows (phase 4's slots) at capacity 8
MOE_TOKENS = SERVE_M
#: tools/gemv_times.py's expert-stack cases ("e/x/bits/dtype", x dense or routed)
SWEEP_EXPERTS = tuple(f"e/{xk}/4/{d}" for xk in ("dense", "routed") for d in ("bf16", "f32"))
#: tools/gemm_times.py's expert-GEMM cases ("g/C/bits/dtype"): row 2e at C 16, 128, 1280
SWEEP_EXPERT_GEMM = tuple(f"g/{c}/{b}/{d}" for c in MOE_GEMM_C for b in (4, 8)
                          for d in ("bf16", "f32"))
#: (b): phase 4's geometry through the serve command line
MOE_SERVE_ARGV = ["--arch", MOE_ARCH, "--wbits", "mixed", "--requests", "8", "--max-new", "16",
                  "--slots", "4", "--max-seq", "256", "--seed", str(SEED + 13)]
#: (c), (d): the same width cut to 2 layers, in f32
MOE_CUT_LAYERS = 2
MOE_SPEC_K = 2


def routed_buffers(torch, cfg, seed: int = SEED + 27, tokens: int = MOE_TOKENS):
    """The expert GEMV's inputs at a decode step of ``tokens`` slots, as
    ``moe.moe_mlp`` builds them: token rows and a router from a numpy
    generator, routed by the port's own ``moe._route`` and ``moe.dispatch``
    into an ``(E, C, d)`` buffer (zeros where an expert holds no token), and
    an ``(E, C, d_ff)`` h for ``w_down`` with rows at the same places (its
    other rows zero, as silu(0) * 0 makes them).  Returns ``({K: buffer},
    live experts)``, f32 on the card."""
    import numpy as np

    from repro_torch.models import moe

    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    xf = torch.from_numpy(rng.standard_normal((tokens, d), dtype=np.float32)).cuda()
    router = torch.from_numpy(rng.standard_normal((d, e), dtype=np.float32) / d ** 0.5).cuda()
    c = moe.capacity(tokens, cfg)
    _, _, eidx = moe._route({"router": router}, xf, cfg)
    _, e_s, t_s, pos, keep = moe.dispatch(eidx, e, c)
    slot = torch.where(keep, e_s * c + pos, e * c)
    rows = {d: xf[t_s],
            f: torch.from_numpy(rng.standard_normal((len(slot), f), dtype=np.float32)).cuda()}
    out = {}
    for k, src in rows.items():
        buf = torch.zeros((e * c + 1, k), device="cuda")
        buf[slot] = src
        out[k] = buf[:e * c].view(e, c, k)
    return out, int((out[d].reshape(e, -1) != 0).any(-1).sum())


def check_experts(torch, gen, results: dict) -> None:
    """Phase 13 (a): the expert stacks of the GEMV and the GEMM at
    deepseek-moe-16b's shapes, 64 experts: each launch byte for byte the 2-D
    kernels on every expert's slice, within rows 1 and 2's tolerances of the
    plain version, and timed (a call, device, plain, ``torch.bmm`` on the
    dequantized bf16 stack a call and its device time, the bound of every
    expert's packed bytes); row 2e's line for a layer's three linears at each
    of ``MOE_GEMM_C`` beside both bounds and ``torch.bmm``'s device time.  Then
    the GEMV on the routed decode buffer (:func:`routed_buffers`), where most
    experts hold no token: the same checks, one launch, and its times beside
    a second bound that counts only the live experts' packed bytes."""
    from repro_torch import configs, kernels
    from repro_torch.kernels.quant_gemv.kernel import quant_gemv_cuda, quant_gemv_experts_cuda
    from repro_torch.kernels.quant_gemv.ref import quant_gemv_experts_ref
    from repro_torch.kernels.quant_matmul.kernel import (quant_matmul_cuda,
                                                         quant_matmul_experts_cuda)
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_experts_ref
    from repro_torch.quant.tensor import quantize_tensor

    moe_cfg = configs.get_config(MOE_ARCH)
    e = moe_cfg.n_experts
    smi = smi_line()
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    routed, live = routed_buffers(torch, moe_cfg)
    c_r = routed[moe_cfg.d_model].shape[1]
    # a layer's three linears at 4 bits in bf16, dense x and routed
    layer = {xk: dict(device_ms=0.0, bytes=0.0, live_bytes=0.0, bmm_ms=0.0)
             for xk in ("dense", "routed")}
    gemm = {c: dict(device_ms=0.0, bmm_ms=0.0, bmm_call=0.0, bytes=0.0, flops=0.0)
            for c in MOE_GEMM_C}
    for name, (n, k) in MOE_LINEARS.items():
        for bits in MOE_BITS:
            w = torch.randn((e, k, n), generator=gen, device="cuda") / k ** 0.5
            qt = quantize_tensor(w, bits)
            del w
            packed, scale = qt.packed, qt.scale                        # (E, N, kp), (1, 1, N)
            wd = qt.dequantize(torch.bfloat16).contiguous()              # (E, K, N), bmm's
            for c in MOE_C:
                kern = "quant_gemv_experts" if c <= 8 else "quant_matmul_experts"
                run, flat, ref = ((quant_gemv_experts_cuda, quant_gemv_cuda,
                                   quant_gemv_experts_ref) if c <= 8 else
                                  (quant_matmul_experts_cuda, quant_matmul_cuda,
                                   quant_matmul_experts_ref))
                for dt in (torch.float32, torch.bfloat16):
                    x = torch.randn((e, c, k), generator=gen, device="cuda").to(dt)
                    got = run(x, packed, scale, bits=bits, k=k)
                    per = torch.stack([flat(x[i], packed[i], scale[0, 0], bits=bits, k=k)
                                       for i in range(e)])
                    want = ref(x, packed, scale, bits, k)
                    torch.cuda.synchronize()
                    if not same_bytes(torch, got, per):
                        raise AssertionError(f"phase 13 (a): {kern} {name} bits={bits} C={c} "
                                             f"{dt}: {differing_experts(torch, got, per)} "
                                             f"differ from the 2-D launch")
                    err = rel(got, want)
                    r = results[kern]
                    r["max_abs_err"] = max(r["max_abs_err"],
                                           float((got.float() - want.float()).abs().max()))
                    if not err <= tol[dt]:
                        raise AssertionError(f"phase 13 (a): {kern} {name} bits={bits} C={c} "
                                             f"{dt}: rel {err:.3g} > {tol[dt]}")
                    t_k = time_ms(torch, lambda: run(x, packed, scale, bits=bits, k=k), reps=10)
                    t_d = time_batch(torch, lambda: run(x, packed, scale, bits=bits, k=k))
                    t_p = time_ms(torch, lambda: ref(x, packed, scale, bits, k), reps=3,
                                  warmup=1)
                    xb = x.to(torch.bfloat16)
                    t_l = time_ms(torch, lambda: torch.bmm(xb, wd), reps=10)
                    t_ld = time_batch(torch, lambda: torch.bmm(xb, wd))
                    act = x.element_size()
                    nbytes = packed.numel() + 4 * n + act * e * c * (k + n)
                    flops = 2.0 * e * c * n * k
                    rate = F32_FLOP_S if dt is torch.float32 else BF16_FLOP_S
                    b_ms, b_by = bound(nbytes, flops, rate)
                    log(f"  ({smi}) {kern:20s} {name:6s} E={e} C={c:4d} N={n} K={k} bits={bits} "
                        f"{str(dt)[6:]:8s}: a call {t_k:.4f} ms, device {t_d:.4f} ms, plain "
                        f"{t_p:.4f} ms, torch.bmm (bf16) {t_l:.4f} ms a call, {t_ld:.4f} ms "
                        f"device, bound {b_ms:.4f} ms ({b_by}), rel {err:.2e}; = the 2-D "
                        f"launches byte for byte")
                    times = 2 if name == "w_gate" else 1
                    if bits == 4 and dt is torch.bfloat16 and c in gemm:
                        for key, val in (("device_ms", t_d), ("bmm_ms", t_ld), ("bmm_call", t_l),
                                         ("bytes", nbytes), ("flops", flops)):
                            gemm[c][key] += times * val
                    if bits == 4 and dt is torch.bfloat16 and c == MOE_ROW_C[kern]:
                        # the kernels line: a layer's three linears (w_gate, w_up, w_down)
                        for key, val in (("ms", t_k), ("device_ms", t_d), ("plain_ms", t_p),
                                         ("library_ms", t_l), ("bytes", nbytes),
                                         ("flops", flops)):
                            r[key] += times * val
                        if kern == "quant_gemv_experts":
                            layer["dense"]["device_ms"] += times * t_d
                            layer["dense"]["bytes"] += times * nbytes
                            layer["dense"]["bmm_ms"] += times * t_ld
                    del x, xb, got, per, want
            # the routed decode buffer: most experts hold no token
            for dt in (torch.float32, torch.bfloat16):
                x = routed[k].to(dt)
                kernels.reset_counts()
                got = quant_gemv_experts_cuda(x, packed, scale, bits=bits, k=k)
                launched = dict(kernels.LAUNCHES)
                per = torch.stack([quant_gemv_cuda(x[i], packed[i], scale[0, 0], bits=bits, k=k)
                                   for i in range(e)])
                want = quant_gemv_experts_ref(x, packed, scale, bits, k)
                torch.cuda.synchronize()
                if launched["quant_gemv_experts"] != 1 or sum(launched.values()) != 1:
                    raise AssertionError(f"phase 13 (a): routed {name} bits={bits} {dt}: "
                                         f"launches {_nonzero(launched)}")
                if not same_bytes(torch, got, per):
                    raise AssertionError(f"phase 13 (a): routed {name} bits={bits} {dt}: "
                                         f"{differing_experts(torch, got, per)} differ from "
                                         f"the 2-D launch")
                err = rel(got, want)
                if not err <= tol[dt]:
                    raise AssertionError(f"phase 13 (a): routed {name} bits={bits} {dt}: rel "
                                         f"{err:.3g} > {tol[dt]}")
                r = results["quant_gemv_experts"]
                r["max_abs_err"] = max(r["max_abs_err"],
                                       float((got.float() - want.float()).abs().max()))
                run = lambda: quant_gemv_experts_cuda(x, packed, scale, bits=bits,  # noqa: E731
                                                      k=k)
                t_k, t_d = time_ms(torch, run, reps=10), time_batch(torch, run)
                xb = x.to(torch.bfloat16)
                t_l = time_ms(torch, lambda: torch.bmm(xb, wd), reps=10)
                t_ld = time_batch(torch, lambda: torch.bmm(xb, wd))
                act = x.element_size()
                rest = 4 * n + act * e * c_r * (k + n)
                flops = 2.0 * e * c_r * n * k
                b_all, _ = bound(packed.numel() + rest, flops)
                b_live, _ = bound(live * packed[0].numel() + rest, flops * live / e)
                log(f"  ({smi}) quant_gemv_experts routed {name:6s} E={e} C={c_r} live {live} "
                    f"N={n} K={k} bits={bits} {str(dt)[6:]:8s}: a call {t_k:.4f} ms, device "
                    f"{t_d:.4f} ms, torch.bmm (bf16) {t_l:.4f} ms a call, {t_ld:.4f} ms device, "
                    f"bound {b_all:.4f} ms (all "
                    f"{e} experts' bytes), {b_live:.4f} ms (the {live} live experts'), rel "
                    f"{err:.2e}; one launch, = the 2-D launches byte for byte")
                if bits == 4 and dt is torch.bfloat16:
                    times = 2 if name == "w_gate" else 1
                    layer["routed"]["device_ms"] += times * t_d
                    layer["routed"]["bytes"] += times * (packed.numel() + rest)
                    layer["routed"]["live_bytes"] += times * (live * packed[0].numel() + rest)
                    layer["routed"]["bmm_ms"] += times * t_ld
                del x, xb, got, per, want
            del qt, packed, scale, wd
            torch.cuda.empty_cache()
        log(f"  ok {name}: C {MOE_C} x bits {MOE_BITS} x f32, bf16, one launch for {e} experts, "
            f"and the routed buffer at C {c_r}")
    dense, rt = layer["dense"], layer["routed"]
    log(f"  ({smi}) row 1e, a layer's three linears at 4 bits, bf16, C {c_r}: device "
        f"{dense['device_ms']:.4f} ms on dense x, {rt['device_ms']:.4f} ms on the routed buffer "
        f"({live} of {e} experts live, {rt['device_ms'] / dense['device_ms']:.3f} of dense); "
        f"bounds {dense['bytes'] / HBM_BYTES_S * 1e3:.4f} ms (every expert's bytes), "
        f"{rt['live_bytes'] / HBM_BYTES_S * 1e3:.4f} ms (the live experts'); torch.bmm device "
        f"{dense['bmm_ms']:.4f} ms dense, {rt['bmm_ms']:.4f} ms routed")
    for c, t in gemm.items():
        tb, to = t["bytes"] / HBM_BYTES_S * 1e3, t["flops"] / BF16_FLOP_S * 1e3
        log(f"  ({smi}) row 2e, a layer's three linears at 4 bits, bf16, C {c}: device "
            f"{t['device_ms']:.4f} ms; torch.bmm (bf16) device {t['bmm_ms']:.4f} ms, a call "
            f"{t['bmm_call']:.4f} ms; bounds {tb:.4f} ms (bytes), {to:.4f} ms (operations); "
            f"{100 * max(tb, to) / t['device_ms']:.1f} % of the larger; kernel "
            f"{'no slower' if t['device_ms'] <= t['bmm_ms'] else 'SLOWER'} than torch.bmm")


def sweep_experts(torch, seed: int = SEED + 28, cases=None, check: bool = True,
                  tiles=()) -> dict:
    """Row 1e at deepseek-moe-16b's decode (64 experts, C 8): a layer's three
    expert linears (``MOE_LINEARS``, ``w_gate`` counted twice for ``w_up``)
    on dense x and on the routed buffer (:func:`routed_buffers`), the
    device time back to back (``time_batch``) summed, against the bound of
    every expert's packed bytes and that of the live experts' alone.
    On the routed buffer it also times three yardsticks: the live experts
    alone as a stack of their own (``compact``: the least the skip could
    reach), 64 experts of zeros (``empty``: what the skipped CTAs cost) and
    the routed stack with its live experts moved to the front (``sorted``:
    the order the kernel's hint gives its CTAs, made by the caller).
    ``cases`` keeps the named keys ("e/dense|routed/bits/dtype", default
    ``SWEEP_EXPERTS``); ``tiles`` also times each linear at those tiles a
    CTA (the plan's split, so the same bits; this tree's ``launch=``).
    Returns ``{key: {kernel, bound, bound_live, live, linears: {name: ms},
    compact, empty, sorted, tiles: {t: {name: ms}}}}``, a linear's
    yardsticks under ``"compact " + name`` and so on."""
    from repro_torch import configs
    from repro_torch.kernels.quant_gemv import kernel as gk
    from repro_torch.kernels.quant_gemv.ref import quant_gemv_experts_ref
    from repro_torch.quant.tensor import quantize_tensor

    cfg = configs.get_config(MOE_ARCH)
    e = cfg.n_experts
    gen = torch.Generator(device="cuda").manual_seed(seed)
    routed, live = routed_buffers(torch, cfg)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    keys = [c for c in (cases or SWEEP_EXPERTS) if c.startswith("e/")]
    out = {}
    for bits in sorted({int(c.split("/")[2]) for c in keys}):
        qts = {}
        for name, (n, k) in MOE_LINEARS.items():
            qt = quantize_tensor(torch.randn((e, k, n), generator=gen, device="cuda") / k ** 0.5,
                                 bits)
            qts[name] = (qt.packed, qt.scale)
            del qt
        for key in keys:
            _, xk, b, dname = key.split("/")
            if int(b) != bits:
                continue
            dt = dts[dname]
            tot = dict(kernel=0.0, bytes=0.0, live_bytes=0.0, compact=0.0, empty=0.0,
                       sorted=0.0)
            each, by_tiles = {}, {t: {} for t in tiles}
            for name, (n, k) in MOE_LINEARS.items():
                packed, scale = qts[name]
                c = routed[k].shape[1]
                x = (routed[k] if xk == "routed" else
                     torch.randn((e, c, k), generator=gen, device="cuda")).to(dt)
                n_live = live if xk == "routed" else e
                run = lambda: gk.quant_gemv_experts_cuda(x, packed, scale, bits=bits,  # noqa
                                                         k=k)
                if check:
                    err = rel(run(), quant_gemv_experts_ref(x, packed, scale, bits, k))
                    if not err <= (1e-4 if dname == "f32" else 2e-2):
                        raise AssertionError(f"expert sweep {key} {name}: rel {err:.3g}")
                times = 2 if name == "w_gate" else 1
                each[name] = time_batch(torch, run, reps=20)
                rest = 4 * n + x.element_size() * e * c * (k + n)
                tot["kernel"] += times * each[name]
                tot["bytes"] += times * (packed.numel() + rest)
                tot["live_bytes"] += times * (n_live * packed[0].numel() + rest)
                stacks = {"": (x, packed)}
                if xk == "routed":
                    held = (x.reshape(e, -1) != 0).any(-1)
                    first = torch.argsort(~held, stable=True)
                    stacks["compact "] = (x[held].contiguous(), packed[held].contiguous())
                    stacks["empty "] = (torch.zeros_like(x), packed)
                    stacks["sorted "] = (x[first].contiguous(), packed[first].contiguous())
                for tag, (xs, ps) in stacks.items():
                    if tag:
                        each[tag + name] = time_batch(torch, lambda: gk.quant_gemv_experts_cuda(
                            xs, ps, scale, bits=bits, k=k), reps=20)
                        tot[tag.strip()] += times * each[tag + name]
                    for t in tiles:
                        launch = dataclasses.replace(gk.plan(c, n, k, xs.shape[0]), tiles=t)
                        by_tiles[t][tag + name] = time_batch(
                            torch, lambda: gk.quant_gemv_experts_cuda(
                                xs, ps, scale, bits=bits, k=k, launch=launch), reps=20)
                del x, stacks
            out[key] = dict(kernel=tot["kernel"], bound=tot["bytes"] / HBM_BYTES_S * 1e3,
                            bound_live=tot["live_bytes"] / HBM_BYTES_S * 1e3,
                            live=live if xk == "routed" else e, linears=each,
                            compact=tot["compact"], empty=tot["empty"],
                            sorted=tot["sorted"], tiles=by_tiles)
            log(f"  row 1e {key}: a layer's three linears {tot['kernel']:.4f} ms back to back "
                f"({out[key]['live']} of {e} experts live; the live ones alone "
                f"{tot['compact']:.4f}, {e} empty {tot['empty']:.4f}, live first "
                f"{tot['sorted']:.4f}); bounds "
                f"{out[key]['bound']:.4f} ms (every expert), {out[key]['bound_live']:.4f} (the "
                f"live ones); by linear "
                + ", ".join(f"{nm} {v:.4f}" for nm, v in each.items())
                + "".join(f"; tiles {t}: " + ", ".join(f"{nm} {v:.4f}" for nm, v in d.items())
                          for t, d in by_tiles.items()))
        del qts
    return out


def sweep_expert_gemm(torch, seed: int = SEED + 29, cases=None, check: bool = True) -> dict:
    """Row 2e at deepseek-moe-16b's admissions and prefills (64 experts): a
    layer's three expert linears (``MOE_LINEARS``, ``w_gate`` counted twice
    for ``w_up``) at each case's C, bits and x type, the kernel's device time
    back to back (``time_batch``) summed, ``torch.bmm``'s on the dequantized
    bf16 stack the same way, and the bounds of the bytes (every expert's
    packed bytes, x and y) and of the operations (bf16 or f32 peak by x's
    type).  ``cases`` keeps the named keys ("g/C/bits/dtype", default
    ``SWEEP_EXPERT_GEMM``).  Returns ``{key: {kernel, bmm, bound_bytes,
    bound_ops, linears: {name: ms}, bmm_linears: {name: ms}}}``."""
    from repro_torch import configs
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul_experts_cuda
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_experts_ref
    from repro_torch.quant.tensor import quantize_tensor

    e = configs.get_config(MOE_ARCH).n_experts
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    keys = [c for c in (cases or SWEEP_EXPERT_GEMM) if c.startswith("g/")]
    out = {}
    for bits in sorted({int(c.split("/")[2]) for c in keys}):
        qts = {}
        for name, (n, k) in MOE_LINEARS.items():
            qt = quantize_tensor(torch.randn((e, k, n), generator=gen, device="cuda") / k ** 0.5,
                                 bits)
            qts[name] = (qt.packed, qt.scale, qt.dequantize(torch.bfloat16).contiguous())
            del qt
        for key in keys:
            _, c, b, dname = key.split("/")
            if int(b) != bits:
                continue
            c, dt = int(c), dts[dname]
            tot = dict(kernel=0.0, bmm=0.0, bytes=0.0, flops=0.0)
            each, each_l = {}, {}
            for name, (n, k) in MOE_LINEARS.items():
                packed, scale, wd = qts[name]
                x = torch.randn((e, c, k), generator=gen, device="cuda").to(dt)
                run = lambda: quant_matmul_experts_cuda(x, packed, scale, bits=bits,  # noqa
                                                        k=k)
                if check:
                    err = rel(run(), quant_matmul_experts_ref(x, packed, scale, bits, k))
                    if not err <= (1e-4 if dname == "f32" else 2e-2):
                        raise AssertionError(f"expert GEMM sweep {key} {name}: rel {err:.3g}")
                xb = x.to(torch.bfloat16)
                times = 2 if name == "w_gate" else 1
                each[name] = time_batch(torch, run)
                each_l[name] = time_batch(torch, lambda: torch.bmm(xb, wd))
                tot["kernel"] += times * each[name]
                tot["bmm"] += times * each_l[name]
                tot["bytes"] += times * (packed.numel() + 4 * n + x.element_size() * e * c * (k + n))
                tot["flops"] += times * 2.0 * e * c * n * k
                del x, xb
            rate = F32_FLOP_S if dt is torch.float32 else BF16_FLOP_S
            out[key] = dict(kernel=tot["kernel"], bmm=tot["bmm"],
                            bound_bytes=tot["bytes"] / HBM_BYTES_S * 1e3,
                            bound_ops=tot["flops"] / rate * 1e3, linears=each, bmm_linears=each_l)
            log(f"  row 2e {key}: a layer's three linears {tot['kernel']:.4f} ms back to back, "
                f"torch.bmm (bf16) {tot['bmm']:.4f} ms; bounds {out[key]['bound_bytes']:.4f} ms "
                f"(bytes), {out[key]['bound_ops']:.4f} ms (operations); by linear "
                + ", ".join(f"{nm} {v:.4f}" for nm, v in each.items()))
        del qts
    return out


def moe_drops(torch, cfg, record: list):
    """Wrap ``models.moe.moe_mlp`` so that every call appends ``(t, C,
    dropped, live)``: the assignments capacity drops and the experts that
    hold one, counted here from the router: each token's top-k experts by
    probability (ties to the lower index), then sum over experts of max(0,
    assignments - C), and the experts with any.  Returns the restore
    function."""
    from repro_torch.models import moe

    real = moe.moe_mlp

    def counted(p, x, cfg_, **kw):
        t = x.shape[0] * x.shape[1]
        probs = torch.softmax(x.reshape(t, -1).float() @ p["router"].float(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :cfg_.top_k]
        per_expert = torch.bincount(top.reshape(-1), minlength=cfg_.n_experts)
        cap = int(t * cfg_.top_k / cfg_.n_experts * cfg_.moe_capacity_factor) + 1
        cap += -cap % 8
        record.append((t, cap, int((per_expert - cap).clamp_min(0).sum()),
                       int((per_expert > 0).sum())))
        return real(p, x, cfg_, **kw)

    moe.moe_mlp = counted

    def restore():
        moe.moe_mlp = real

    return restore


def serve_moe(torch, cfg) -> dict:
    """Phase 13 (b): full-width, full-depth deepseek-moe-16b in bf16 through
    ``launch.serve.main`` (packed leaf by leaf under ``dryrun_policy("mixed")``,
    a K 8 / V 4 state): step median, TTFT, peak memory, device-busy share,
    launches a decode step and the packed bytes."""
    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.serve.engine import Request

    smi = smi_line()
    engines, marks = [], {}
    real_engine = serve.ServeEngine

    class Recording(real_engine):
        def __init__(self, cfg_, params, **kw):
            torch.cuda.synchronize()
            marks["pack_peak"] = torch.cuda.max_memory_allocated()
            marks["packed_s"] = time.perf_counter() - marks["t0"]
            torch.cuda.reset_peak_memory_stats()
            kw["state_bits"] = state_policy(cfg_, kw["max_slots"], kw["max_seq"])
            kw["shed"] = steady()
            super().__init__(cfg_, params, **kw)
            kernels.reset_counts()
            engines.append(self)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve.ServeEngine = Recording
    marks["t0"] = time.perf_counter()
    try:
        rc = serve.main(MOE_SERVE_ARGV)
    finally:
        serve.ServeEngine = real_engine
    torch.cuda.synchronize()
    wall = time.perf_counter() - marks["t0"]
    eng = engines[0]
    st = eng.stats()
    launches, plain = st["launches"], st["plain_calls"]
    serve_peak = torch.cuda.max_memory_allocated()
    layers_, steps, adm = cfg.n_layers, st["decode_steps"], st["admissions"]
    experts = launches["quant_gemv_experts"] + launches["quant_matmul_experts"]
    if rc != 0 or st["completed"] != 8 or any(plain.values()):
        raise AssertionError(f"phase 13 (b): rc {rc}, completed {st['completed']}, plain {plain}")
    if (experts != 3 * layers_ * (steps + adm)
            or launches["quant_gemv_experts"] < 3 * layers_ * steps
            or launches["quant_kv_decode_step"] != layers_ * steps):
        raise AssertionError(f"phase 13 (b): launches {launches} for {steps} decode steps and "
                             f"{adm} admissions (want 3 x {layers_} expert launches a pass, "
                             f"the GEMV's at every decode step)")
    ttft = ttft_samples(torch, eng)
    log(f"  ({smi}) launch.serve.main {' '.join(MOE_SERVE_ARGV)}: rc {rc}, {wall:.2f} s in all, "
        f"{marks['packed_s']:.2f} s to init and pack; packed weights "
        f"{eng.weight_container_bytes() / 1e9:.3f} GB, KV state "
        f"{eng.state_container_bytes() / 1e6:.2f} MB; peak allocated {marks['pack_peak'] / 1e9:.3f}"
        f" GB while packing, {serve_peak / 1e9:.3f} GB serving; depth {layers_} of {layers_} "
        f"(no cut)")
    log(f"  {steps} decode steps, {adm} admissions: step median "
        f"{st['decode_step_median_s'] * 1e3:.3f} ms, TTFT p50 {ttft['p50'] * 1e3:.1f} ms, p99 "
        f"{ttft['p99'] * 1e3:.1f} ms; launches {_nonzero(launches)}")
    per_step = {k: v / steps for k, v in launches.items() if v and k not in (
        "quant_matmul", "quant_matmul_experts")}
    log(f"  launches a decode step (admissions' included in the GEMV counts where C <= 8): "
        f"{ {k: round(v, 2) for k, v in per_step.items()} }")
    gen = torch.Generator().manual_seed(SEED + 14)
    reqs = [Request(uid=i, prompt=torch.randint(1, cfg.vocab_size, (12,), generator=gen).tolist(),
                    max_new_tokens=4) for i in range(4)]
    before = eng.stats()["decode_steps"]
    prof = profile_steps(torch, eng, reqs)
    p_steps = eng.stats()["decode_steps"] - before
    out = {"launches": launches, "step_ms": st["decode_step_median_s"] * 1e3}
    if prof is not None:
        # row 1e's device time a decode step (the rerun's admission at C 8
        # included), and the experts a decode step's MoE calls find live,
        # counted in the same rerun again (no profile: the count syncs)
        ms, n = stack_gemv_ms(prof, ROOT / "build" / "phase13b_trace.json")
        record = []
        restore = moe_drops(torch, cfg, record)
        try:
            eng.run([dataclasses.replace(r, uid=200 + r.uid) for r in reqs])
        finally:
            restore()
        dec = [r[3] for r in record if r[0] <= eng.max_slots]
        out.update(stack_gemv_ms=ms / p_steps, live=sum(dec) / max(len(dec), 1))
        log(f"  row 1e in the profile: {ms:.3f} ms of device time over {n} launches, "
            f"{p_steps} decode steps: {ms / p_steps:.3f} ms a decode step; live experts a "
            f"decode-step MoE call {out['live']:.2f} of {cfg.n_experts} (mean of {len(dec)} "
            f"calls; {len(record)} calls in all)")
        out.update(profile_admission(torch, eng, cfg))
    del eng, engines
    torch.cuda.empty_cache()
    return out


def _moe_cut(torch, cfg):
    """(c)'s model: full width, MOE_CUT_LAYERS layers, f32, packed under the
    mixed policy (layer 0 at 8 bits, layer 1 at 4)."""
    from repro_torch.launch.dryrun import dryrun_policy
    from repro_torch.models import decoder
    from repro_torch.quant import apply as qapply

    cut = dataclasses.replace(cfg, n_layers=MOE_CUT_LAYERS, dtype="float32")
    params = decoder.init(cut, torch.Generator(device="cuda").manual_seed(SEED + 15),
                          device="cuda")
    policy = dryrun_policy(qapply.layer_specs(params, cut), "mixed")
    serve = qapply.pack_for_serve(params, policy, cut)
    torch.cuda.empty_cache()
    return cut, serve


def moe_modes(torch, cfg) -> None:
    """Phase 13 (c) and (d): deepseek-moe-16b's width cut to 2 layers in f32
    through the engine: the kernels against the plain versions, dense against
    paged, speculative K 2 from a 4-bit draft against non-speculative, each
    run's dropped assignments counted; then the kernel run again, its logits
    bit-equal."""
    from repro_torch import kernels
    from repro_torch.kvcache import insert_state_rows, resolve_state_bits
    from repro_torch.models import decoder
    from repro_torch.quant.apply import fuse_projections
    from repro_torch.serve.engine import Request, ServeEngine

    smi = smi_line()
    cut, serve = _moe_cut(torch, cfg)
    slots, seq, new = 4, 256, 16
    gen = torch.Generator().manual_seed(SEED + 16)
    lens = torch.randint(8, 25, (8,), generator=gen).tolist()
    reqs = [Request(uid=i, prompt=torch.randint(1, cut.vocab_size, (n,), generator=gen).tolist(),
                    max_new_tokens=new) for i, n in enumerate(lens)]
    state = state_policy(cut, slots, seq)
    base = dict(max_slots=slots, max_seq=seq, state_bits=state, shed=steady(spec_tiers=False))
    modes = {"kernels": {}, "plain": {"impl": "torch"}, "paged": {"paged": True},
             "speculative": {"speculate": MOE_SPEC_K, "draft_policy": 4},
             "kernels again": {}}
    runs = {}
    for mode, kw in modes.items():
        record = []
        kernels.reset_counts()
        restore = moe_drops(torch, cut, record)
        try:
            eng = ServeEngine(cut, serve, **base, **kw)
            collect = record_logits(torch, eng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.run([dataclasses.replace(r) for r in reqs])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            restore()
        st = eng.stats()
        runs[mode] = dict(out=out, rows=collect(), drops=sum(r[2] for r in record),
                          calls=len(record), st=st)
        extra = (f", spec rounds {st['spec_steps']}, accepted {st['spec_accepted']} of "
                 f"{st['spec_proposed']}" if st["spec_steps"] else "")
        log(f"  ({smi}) {mode:13s}: {wall:.2f} s, {st['decode_steps']} decode steps, "
            f"{st['admissions']} admissions, MoE calls {len(record)}, dropped assignments "
            f"{runs[mode]['drops']} (largest t {max(r[0] for r in record)}, C "
            f"{max(r[1] for r in record)}){extra}; expert launches "
            f"{st['launches']['quant_gemv_experts']} GEMV + "
            f"{st['launches']['quant_matmul_experts']} GEMM, plain "
            f"{st['plain_calls']['quant_gemv_experts']} + "
            f"{st['plain_calls']['quant_matmul_experts']}")
        del eng
    # the gap kernels and plain versions leave on one cache: a decode step's logits
    params = fuse_projections(serve)
    toks = torch.tensor([r.prompt[:8] for r in reqs[:slots]], device="cuda")
    lens_t = torch.full((slots,), 8, dtype=torch.int32, device="cuda")
    _, kv = decoder.prefill(params, cut, toks, logits=False)
    bits = resolve_state_bits(state, cut)
    cache_k = insert_state_rows(decoder.init_cache(cut, slots, seq, state_bits=bits,
                                                   device="cuda"),
                                torch.arange(slots, device="cuda"), kv, lens_t)
    cache_p = insert_state_rows(decoder.init_cache(cut, slots, seq, state_bits=bits,
                                                   device="cuda"),
                                torch.arange(slots, device="cuda"), kv, lens_t)
    last = toks[:, -1:]
    a, _ = decoder.decode_step(params, cut, cache_k, last, lens_t)
    b, _ = decoder.decode_step(params, cut, cache_p, last, lens_t, impl="torch")
    gap = float((a - b).abs().max())
    log(f"  kernels against plain versions on one cache, one decode step: logits rel "
        f"{rel(a, b):.3g}, max |difference| {gap:.4g}")
    if not rel(a, b) <= 1e-4:
        raise AssertionError(f"phase 13 (c): decode step kernels vs plain rel {rel(a, b):.3g}")
    del params, kv, cache_k, cache_p
    k = runs["kernels"]
    parted = near_ties(k["out"], runs["plain"]["out"], k["rows"], runs["plain"]["rows"], gap,
                       "plain versions")
    log(f"  ok kernels vs plain: {parted} of {len(reqs)} streams part, each at a near-tie")
    for mode in ("paged", "speculative"):
        r = runs[mode]
        same = sum(r["out"][u] == k["out"][u] for u in k["out"])
        if k["drops"] or r["drops"]:
            log(f"  {mode} vs dense: {same} of {len(reqs)} streams equal; dropped assignments "
                f"{r['drops']} against {k['drops']}: capacity follows the batch, so the modes "
                f"may differ")
        else:
            parted = near_ties(k["out"], r["out"], k["rows"], r["rows"], gap, mode)
            log(f"  ok {mode} vs dense: no assignment dropped in either; {parted} of "
                f"{len(reqs)} streams part, each at a near-tie")
    again = runs["kernels again"]
    if again["out"] != k["out"] or again["rows"].keys() != k["rows"].keys() or any(
            not torch.equal(again["rows"][key], k["rows"][key]) for key in k["rows"]):
        raise AssertionError("phase 13 (d): two identical runs differ")
    log(f"  ok (d) the kernel run repeated: streams and all {len(k['rows'])} logits rows "
        f"bit-equal (the combine sums without atomics)")
    del serve, runs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 14: deepseek-moe-16b's QAT, trainer and search (full width, 2 layers)
# ---------------------------------------------------------------------------

#: the MoE training model: deepseek-moe-16b's width cut to 2 layers (about 1.6 B
#: parameters; f32 with gradients and Adam moments about 26 GB)
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_ARGV = ["--arch", MOE_ARCH, "--layers", str(MOE_TRAIN_LAYERS), "--steps", "8",
                  "--batch", "8", "--seq", "128", "--wbits", "4", "--seed", str(SEED)]
#: the search on the cut model (8 bits about 1521 MiB, 4 bits about 0.76 GiB): the
#: controller lowers two leaves by 2 bits a round, so the limit takes several
MOE_SEARCH_ARGV = ["--arch", MOE_ARCH, "--limit", "size_mib=1250", "--pretrain-steps", "4",
                   "--phase2-iters", "12", "--seq", "64", "--batch", "8", "--seed", str(SEED)]
MOE_SEARCH_SERVE_ARGV = ["--arch", MOE_ARCH, "--requests", "4", "--max-new", "8",
                         "--slots", "4", "--max-seq", "256", "--seed", str(SEED + 17)]


def _moe_train_cfg(cfg):
    return dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)


class _NoStore:
    """A checkpoint store that writes nothing: phase 14 (b) times the steps,
    and phase 12 (c) already holds the saves (the cut model's state would be
    19 GB on disk)."""

    def __init__(self, root, **kw):
        self.saves = 0

    def latest(self):
        return None

    def save_async(self, step, state, extra=None):
        self.saves += 1

    def wait(self):
        pass


def free_memory(torch) -> None:
    """Collect the earlier phases' garbage (engines hold reference cycles, so
    their tensors can outlive them until the collector runs), then zero the
    peak: a phase's peak memory is then its own."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def moe_qat_step(torch, cfg) -> None:
    """Phase 14 (a): one QAT step's loss and gradients of the cut model in f32
    through the kernels, the plain versions and the kernels again, every leaf
    bit-equal; row 10 runs on the (E, K, N) expert stacks."""
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import TokenTask, batch_on, global_batch
    from repro_torch.launch.dryrun import dryrun_policy
    from repro_torch.models import decoder, registry
    from repro_torch.quant import apply as qapply
    from repro_torch.train.train_step import value_and_grad

    smi = smi_line()
    cut = dataclasses.replace(_moe_train_cfg(cfg), dtype="float32")
    params = decoder.init(cut, torch.Generator(device="cuda").manual_seed(SEED + 18),
                          device="cuda")
    specs = qapply.layer_specs(params, cut)
    stacks = [s for s in specs if s.kind == "expert"]
    bits = qapply.bits_for_scan(dryrun_policy(specs, "mixed"), params, cut)
    batch = batch_on(global_batch(TokenTask(cut.vocab_size), cut,
                                  ShapeSpec("search", "train", 64, 8), 0), "cuda")
    api = registry.get_api(cut)
    per_fwd = _fq_per_forward(cut, specs)
    step = (per_fwd + _fq_recomputed(cut, specs), per_fwd)
    n_params = sum(leaf.numel() for _, leaf in qapply._walk(params))
    runs = {}
    for key, impl in (("kernels", "auto"), ("plain", "torch"), ("kernels again", "auto")):
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(
            lambda p, b, bb, impl=impl: api.loss(p, cut, b, bits=bb, impl=impl), params, batch,
            bits)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = (kernels.LAUNCHES["fake_quant"], kernels.LAUNCHES["fake_quant_ste_bwd"])
        plain = (kernels.PLAIN_CALLS["fake_quant"], kernels.PLAIN_CALLS["fake_quant_ste_bwd"])
        want = (step, (0, 0)) if impl == "auto" else ((0, 0), step)
        if (got, plain) != want:
            raise AssertionError(f"phase 14 (a) {key}: launches {got}, plain calls {plain} "
                                 f"(want {want})")
        if not (torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)):
            raise AssertionError(f"phase 14 (a) {key}: non-finite loss or gradient")
        runs[key] = (loss, grads)
        log(f"  ({smi}) {key}: loss {float(loss):.6f}, loss + gradients in {dt:.3f} s; "
            f"fake-quant and STE launches {got} a step ({per_fwd} a forward, "
            f"{len(stacks)} of them on (E, K, N) stacks; the recompute's {step[0] - per_fwd}), "
            f"plain calls {plain}")
    for a, b in (("kernels", "plain"), ("kernels", "kernels again")):
        (la, ga), (lb, gb) = runs[a], runs[b]
        same = [torch.equal(x, y) for x, y in zip(ga, gb)]
        if not torch.equal(la, lb) or not all(same):
            worst = max(rel(x, y) for x, y in zip(ga, gb))
            raise AssertionError(f"phase 14 (a) {a} vs {b}: loss rel {rel(la, lb):.3g}, "
                                 f"gradients equal in {sum(same)} of {len(same)} leaves, "
                                 f"max rel {worst:.3g}")
        log(f"  ok {a} vs {b}: loss and all {len(same)} gradient leaves bit-equal")
    log(f"  {cut.name} cut to {cut.n_layers} layers, f32: {n_params / 1e9:.3f} G parameters, "
        f"{len(specs)} quantizable leaves a forward, the stacks {[s.shape for s in stacks[:3]]}")
    del params, runs, grads, batch
    torch.cuda.empty_cache()


def cut_trainer(torch, argv, phase: str) -> dict:
    """Phases 14 (b) and 17 (d): ``launch.train.main`` on a cut model, 8 steps
    of 8 x 128 at 4 bits: the step median and the fake-quant launches a step."""
    from repro_torch import kernels
    from repro_torch.launch import train
    from repro_torch.quant import apply as qapply

    smi = smi_line()
    times, built, stores = [], [], []
    real_build, real_store = train.build, train.CheckpointStore

    def timed_build(args):
        out = real_build(args)
        built.append(out)
        step = out[2]

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return res

        return out[:2] + (timed,) + out[3:]

    def no_store(root, **kw):
        stores.append(_NoStore(root))
        return stores[-1]

    train.build, train.CheckpointStore = timed_build, no_store
    try:
        free_memory(torch)
        kernels.reset_counts()
        t0 = time.perf_counter()
        rc = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train.build, train.CheckpointStore = real_build, real_store
    launches, plain = dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)
    cfg2, state = built[0][0], built[0][3]
    specs2 = qapply.layer_specs(state[0], cfg2)
    per_fwd, recomputed = _fq_per_forward(cfg2, specs2), _fq_recomputed(cfg2, specs2)
    steps = len(times)
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(fake_quant=(per_fwd + recomputed) * steps, fake_quant_ste_bwd=per_fwd * steps)
    if rc != 0 or steps != 8 or launches != want or any(plain.values()):
        raise AssertionError(f"{phase}: rc {rc}, {steps} steps, launches {launches} "
                             f"(want {want}), plain calls {plain}")
    n_params = sum(leaf.numel() for _, leaf in qapply._walk(state[0]))
    log(f"  ({smi}) launch.train.main {' '.join(argv)}: rc {rc}, {wall:.2f} s; "
        f"{cfg2.name} {cfg2.n_layers} layers {cfg2.dtype}, {n_params / 1e9:.3f} G parameters; "
        f"step median {statistics.median(times[1:]) * 1e3:.3f} ms (first "
        f"{times[0] * 1e3:.3f}); peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB;"
        f" saves skipped {stores[0].saves}")
    log(f"    launches {_nonzero(launches)}: {steps} steps x {per_fwd} + {recomputed} fake-quant "
        f"(the forward, the recompute) and {per_fwd} STE, as predicted; plain calls 0")
    del built, state
    torch.cuda.empty_cache()
    return launches


def moe_search(torch, cfg) -> None:
    """Phase 14 (c): ``launch.search.main`` on the cut model under a size
    limit (the weight phase; the launches its steps predict), then its
    artifact through ``launch.serve.main --policy``."""
    art = cut_search(torch, _moe_train_cfg(cfg), MOE_SEARCH_ARGV, MOE_SEARCH_SERVE_ARGV,
                     "phase 14 (c)", ("quant_gemv_experts",))
    log(f"    experts at {sorted({b for n, b in art.policy.bits.items() if 'mlp.w_' in n})} "
        f"bits")


def cut_search(torch, cut, argv, serve_argv, phase: str, serve_kernels):
    """``launch.search.main`` on a cut model (the weight phase, and the state
    phase where ``argv`` has a ``state_bytes`` limit; the launches their steps
    predict), then its artifact through ``launch.serve.main --policy``, which
    must launch each of ``serve_kernels``.  Returns the artifact."""
    from repro_torch import configs as configs_mod
    from repro_torch import kernels
    from repro_torch.core.policy import PolicyArtifact
    from repro_torch.kvcache import env as kv_env
    from repro_torch.launch import search, serve

    smi = smi_line()
    out = ROOT / "build" / f"phase{phase.split()[1]}_policy.json"
    out.parent.mkdir(exist_ok=True)

    def cut_config(name):
        return cut if name == cut.name else configs_mod.get_config(name)

    envs, state_envs = [], []
    real_env, real_kv = search.LMQuantEnv, kv_env.KVQuantEnv
    real_s, real_v = search.get_config, serve.get_config

    class Recording(real_env):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            envs.append(self)

    class RecordingKV(real_kv):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            state_envs.append(self)

    search.LMQuantEnv, search.get_config, serve.get_config = Recording, cut_config, cut_config
    kv_env.KVQuantEnv = RecordingKV
    try:
        free_memory(torch)
        kernels.reset_counts()
        t0 = time.perf_counter()
        rc = search.main(argv + ["--out", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)
        env = envs[0]
        want = search_launches(cut, env, {"state_env": state_envs[0]} if state_envs else {})
        if rc not in (0, 1) or launches != want or any(plain.values()):
            raise AssertionError(f"{phase}: rc {rc}, launches {launches} (want {want}), "
                                 f"plain calls {plain}")
        art = PolicyArtifact.load(str(out))
        state = ""
        if art.state_policy is not None:
            state = (f"; state policy mean {art.state_policy.mean_bits():.3f} bits over "
                     f"{len(art.state_policy.layers)} entries, "
                     f"{art.report['state_bytes']:.0f} B ({state_envs[0].steps} state steps)")
        log(f"  ({smi}) launch.search.main {' '.join(argv)} ({cut.n_layers} "
            f"layers): rc {rc}, wall {wall:.2f} s, peak allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; {_phase_walls(art)}; "
            f"{env.train_steps} training steps, {env.eval_passes} evaluations; policy mean "
            f"{art.policy.mean_bits():.3f} bits, size {art.policy.model_size_mib():.1f} MiB"
            f"{state}")
        log(f"    launches {_nonzero(launches)}, as the run's steps predict; plain calls 0")
        engines = []
        real_engine = serve.ServeEngine

        class Keep(real_engine):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                engines.append(self)

        serve.ServeEngine = Keep
        kernels.reset_counts()
        t0 = time.perf_counter()
        try:
            rc = serve.main(serve_argv + ["--policy", str(out)])
        finally:
            serve.ServeEngine = real_engine
        torch.cuda.synchronize()
        st = engines[0].stats()
        if (rc != 0 or st["completed"] != 4 or any(st["plain_calls"].values())
                or not all(st["launches"][k] for k in serve_kernels)):
            raise AssertionError(f"{phase} serving: rc {rc}, {st['completed']} completed, "
                                 f"launches {_nonzero(st['launches'])} (want {serve_kernels}), "
                                 f"plain {_nonzero(st['plain_calls'])}")
        log(f"  ok served the artifact: {time.perf_counter() - t0:.2f} s, packed "
            f"{engines[0].weight_container_bytes() / 1e9:.3f} GB, state bits "
            f"{sorted(set(engines[0].state_bits.values()))}, step median "
            f"{st['decode_step_median_s'] * 1e3:.3f} ms; launches {_nonzero(st['launches'])}")
    finally:
        search.LMQuantEnv, search.get_config, serve.get_config = real_env, real_s, real_v
        kv_env.KVQuantEnv = real_kv
    torch.cuda.empty_cache()
    return art


# ---------------------------------------------------------------------------
# phases 15 and 16: qwen2-vl-2b (M-RoPE) and mamba2-2.7b (SSM) at full width
# ---------------------------------------------------------------------------

VLM_ARCH = "qwen2-vl-2b"
SSM_ARCH = "mamba2-2.7b"
#: each family's packed linears, (N, K): qwen2-vl-2b's fused wqkv (12 + 2 x 2
#: heads of 128), wo, the fused gate/up, w_down and the untied head;
#: mamba2-2.7b's in_proj (z, x, B, C, dt: 2 x 5120 + 2 x 128 + 80), out_proj
#: and the untied head (50280, no multiple of 16)
VLM_LINEARS = {"wqkv": (2048, 1536), "wo": (1536, 1536), "w_gu": (17920, 1536),
               "w_down": (1536, 8960), "lm_head": (151936, 1536)}
SSM_LINEARS = {"in_proj": (10576, 2560), "out_proj": (2560, 5120), "lm_head": (50280, 2560)}
#: qwen2-vl-2b's decode step: B 4 slots over 512 positions, 12 query heads on 2 KV
#: heads of 128 (a group of 6), K 8 / V 4
VLM_KV = dict(B=4, n_kv=2, g=6, hd=128, S=512, block=16)
#: phase 4's geometry through the serve command line
FAMILY_SERVE = ["--wbits", "mixed", "--requests", "8", "--max-new", "16", "--slots", "4",
                "--max-seq", "512"]
#: phase 16 (c): mamba2-2.7b's width cut to 2 layers, in f32
SSM_CUT_LAYERS = 2


def check_family_linears(torch, gen, linears: dict, tag: str, results: dict) -> None:
    """A family's packed linears through the GEMV (M 1, 4, 8) and the GEMM
    (M 128) at 4 and 8 bits, f32 and bf16, against the plain versions (rows
    1 and 2's tolerances); a call and the plain version timed at 4 bits, bf16."""
    from repro_torch.kernels.quant_gemv.kernel import quant_gemv_cuda
    from repro_torch.kernels.quant_gemv.ref import quant_gemv_ref
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul_cuda
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
    from repro_torch.quant.tensor import quantize_tensor

    smi = smi_line()
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    for name, (n, k) in linears.items():
        for bits in (4, 8):
            w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
            qt = quantize_tensor(w, bits)
            del w
            cases = [("quant_gemv", m, quant_gemv_cuda, quant_gemv_ref) for m in GEMV_MS]
            cases.append(("quant_matmul", GEMM_M, quant_matmul_cuda, quant_matmul_ref))
            for kern, m, run, ref in cases:
                for dt in (torch.float32, torch.bfloat16):
                    x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
                    got = run(x, qt.packed, qt.scale, bits=bits, k=k)
                    want = ref(x, qt.packed, qt.scale, bits, k)
                    torch.cuda.synchronize()
                    err = rel(got, want)
                    r = results[kern]
                    r["max_abs_err"] = max(r["max_abs_err"],
                                           float((got.float() - want.float()).abs().max()))
                    if not (torch.isfinite(got).all() and err <= tol[dt]):
                        raise AssertionError(f"{tag}: {kern} {name} N={n} K={k} bits={bits} "
                                             f"M={m} {dt}: rel {err:.3g} > {tol[dt]}")
                    if bits == 4 and dt is torch.bfloat16 and m in (SERVE_M, GEMM_M):
                        t_k = time_ms(torch, lambda: run(x, qt.packed, qt.scale, bits=bits, k=k))
                        t_p = time_ms(torch, lambda: ref(x, qt.packed, qt.scale, bits, k),
                                      reps=5, warmup=1)
                        nbytes = qt.packed.numel() + 4 * n + 2 * m * (k + n)
                        b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
                        log(f"  ({smi}) {kern:12s} {name:8s} N={n:6d} K={k:5d} bits=4 M={m:3d} "
                            f"bf16: a call {t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} "
                            f"ms ({b_by}), rel {err:.2e}")
                    del x, got, want
            del qt
        log(f"  ok {tag} {name} (N {n}, K {k}): GEMV M={GEMV_MS} and GEMM M={GEMM_M}, "
            f"bits 4 and 8, f32 and bf16")
    torch.cuda.empty_cache()


def check_group_of_six(torch, gen, results: dict) -> None:
    """Phase 15 (a): row 3 at qwen2-vl-2b's heads (a query group of 6) against
    its plain version: cache bytes exact, output within rel 1e-5 (f32)."""
    from repro_torch.kernels.quant_kv import ops as kv_ops

    c = VLM_KV
    b, s, h, hq, hd = c["B"], c["S"], c["n_kv"], c["n_kv"] * c["g"], c["hd"]
    for k_bits, v_bits in ((8, 4), (8, 8), (4, 2)):
        base = _kv_layer_of(torch, gen, b, s, h, hd, c["block"], k_bits, v_bits)
        pair = [_clone(base) for _ in range(2)]
        for pos in ((37, 200, 415, 496), (38, 201, 416, 497)):
            posv = torch.tensor(pos, dtype=torch.int32, device="cuda")
            valid = torch.arange(s, device="cuda")[None, :] <= posv[:, None]
            q = torch.randn((b, hq, hd), generator=gen, device="cuda")
            kn = torch.randn((b, 1, h, hd), generator=gen, device="cuda")
            vn = torch.randn((b, 1, h, hd), generator=gen, device="cuda")
            o_k, _ = kv_ops.quant_kv_decode_step(q, pair[0], posv, kn, vn, valid)
            o_p, _ = kv_ops.quant_kv_decode_step(q, pair[1], posv, kn, vn, valid, impl="torch")
            torch.cuda.synchronize()
            for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
                if not torch.equal(getattr(pair[0], f), getattr(pair[1], f)):
                    raise AssertionError(f"phase 15 (a): row 3, group of 6, k{k_bits}/v{v_bits}: "
                                         f"{f} differs from the plain version")
            err = rel(o_k, o_p)
            r = results["quant_kv_decode_step"]
            r["max_abs_err"] = max(r["max_abs_err"], float((o_k - o_p).abs().max()))
            if not err <= 1e-5:
                raise AssertionError(f"phase 15 (a): row 3, group of 6: rel {err:.3g} > 1e-5")
        t_k = time_ms(torch, lambda: kv_ops.quant_kv_decode_step(q, _clone(base), posv, kn, vn,
                                                                 valid))
        log(f"  ok row 3 at {hq} query heads on {h} KV heads of {hd} (a group of 6), B {b}, "
            f"S {s}, k{k_bits}/v{v_bits}: bytes exact, rel {err:.2e}; a call with a cache copy "
            f"{t_k:.4f} ms")
        del base, pair


def _kv_layer_of(torch, gen, b, s, h, hd, block, k_bits, v_bits):
    from repro_torch.kvcache import cache as kvc

    layer = kvc.init_kv_layer(b, s, h, hd, k_bits=k_bits, v_bits=v_bits, block=block,
                              device="cuda")
    k = torch.randn((b, s, h, hd), generator=gen, device="cuda")
    v = torch.randn((b, s, h, hd), generator=gen, device="cuda")
    return kvc.insert_rows(layer, torch.arange(b, device="cuda"), k, v,
                           valid_len=torch.full((b,), s - 16, device="cuda"))


def serve_family(torch, cfg, phase: str, *, kv_state: bool) -> dict:
    """Phases 15 (b) and 16 (b): full width and depth through
    ``launch.serve.main`` at phase 4's geometry (``dryrun_policy("mixed")``;
    a K 8 / V 4 state where the family has KV entries): step median, TTFT,
    peak memory, packed and state bytes, launches a decode step and an
    admission as the linears predict, and a profiled rerun's busy share.
    Returns the engine and its launches."""
    from repro_torch import kernels
    from repro_torch.kvcache import kv_entry_names
    from repro_torch.launch import serve
    from repro_torch.serve.engine import Request

    smi = smi_line()
    argv = ["--arch", cfg.name, *FAMILY_SERVE, "--seed", str(SEED + 19)]
    engines, marks = [], {}
    real_engine = serve.ServeEngine

    class Recording(real_engine):
        def __init__(self, cfg_, params, **kw):
            torch.cuda.synchronize()
            marks["pack_peak"] = torch.cuda.max_memory_allocated()
            marks["packed_s"] = time.perf_counter() - marks["t0"]
            torch.cuda.reset_peak_memory_stats()
            if kv_state:
                kw["state_bits"] = state_policy(cfg_, kw["max_slots"], kw["max_seq"])
            kw["shed"] = steady()
            super().__init__(cfg_, params, **kw)
            kernels.reset_counts()
            engines.append(self)

    free_memory(torch)
    serve.ServeEngine = Recording
    marks["t0"] = time.perf_counter()
    try:
        rc = serve.main(argv)
    finally:
        serve.ServeEngine = real_engine
    torch.cuda.synchronize()
    wall = time.perf_counter() - marks["t0"]
    eng = engines[0]
    st = eng.stats()
    launches, plain = st["launches"], st["plain_calls"]
    steps, adm = st["decode_steps"], st["admissions"]
    n_lin = _packed_linears(eng.params) + _shared_linears(eng.params, cfg)
    head = 0 if cfg.tie_embeddings else 1
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(quant_gemv=(n_lin + head) * steps, quant_matmul=n_lin * adm)
    if kv_state:
        want["quant_kv_decode_step"] = len(kv_entry_names(cfg)) * steps
    if rc != 0 or st["completed"] != 8 or any(plain.values()) or launches != want:
        raise AssertionError(f"{phase}: rc {rc}, completed {st['completed']}, launches "
                             f"{_nonzero(launches)} (want {_nonzero(want)} for {steps} decode "
                             f"steps and {adm} admissions), plain {_nonzero(plain)}")
    ttft = ttft_samples(torch, eng)
    slot_bytes = eng.state_container_bytes() / eng.max_slots
    log(f"  ({smi}) launch.serve.main {' '.join(argv)}: rc {rc}, {wall:.2f} s in all, "
        f"{marks['packed_s']:.2f} s to init and pack; packed weights "
        f"{eng.weight_container_bytes() / 1e9:.3f} GB; decode state "
        f"{eng.state_container_bytes() / 1e6:.2f} MB ({slot_bytes / 1e6:.2f} MB a slot); peak "
        f"allocated {marks['pack_peak'] / 1e9:.3f} GB while packing, "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB serving; depth {cfg.n_layers} of "
        f"{cfg.n_layers} (no cut)")
    if isinstance(eng.state, dict):                    # the hybrid's {"mamba", "attn"}
        parts = {k: sum(t.numel() * t.element_size() for lay in eng.state["mamba"]
                        for t in lay.values()) if k == "mamba" else
                 sum(a.container_bytes() for a in eng.state["attn"]) for k in eng.state}
        log(f"  the state a slot: Mamba {parts['mamba'] / eng.max_slots / 1e6:.2f} MB (f32, "
            f"{len(eng.state['mamba'])} layers), shared-attention KV "
            f"{parts['attn'] / eng.max_slots / 1e6:.2f} MB ({len(eng.state['attn'])} "
            f"applications, K 8 / V 4, {eng.max_seq} positions)")
    log(f"  {steps} decode steps, {adm} admissions: step median "
        f"{st['decode_step_median_s'] * 1e3:.3f} ms, TTFT p50 {ttft['p50'] * 1e3:.1f} ms, p99 "
        f"{ttft['p99'] * 1e3:.1f} ms; launches {_nonzero(launches)} ({n_lin} packed linears"
        f"{' + the head' if head else ''} a step, as predicted); plain calls 0")
    gen = torch.Generator().manual_seed(SEED + 20)
    reqs = [Request(uid=i, prompt=torch.randint(1, cfg.vocab_size, (12,), generator=gen).tolist(),
                    max_new_tokens=4) for i in range(4)]
    profile_steps(torch, eng, reqs)
    return {"engine": eng, "launches": dict(launches)}


def check_mrope(torch, cfg, eng) -> None:
    """Phase 15 (c): ``apply_mrope`` with distinct (t, h, w) positions on the
    card against its plain evaluation in f64 (the f32 angle rounds: the
    limit is 1e-3 at positions below 4096), and against the same function on
    CPU tensors; then a prefill of the served model from ``embeds=`` (the
    packed table's rows) equal to its prefill from the tokens, bit for bit."""
    from repro_torch.models import decoder, layers

    hd = cfg.resolved_head_dim
    sections = layers.mrope_sections(hd)
    g = torch.Generator().manual_seed(SEED + 21)
    x = torch.randn((2, 64, cfg.n_heads, hd), generator=g)
    pos = torch.randint(0, 4096, (3, 2, 64), generator=g)
    out = layers.apply_mrope(x.cuda(), pos.cuda(), sections, cfg.rope_theta)
    cpu = layers.apply_mrope(x, pos, sections, cfg.rope_theta)
    freqs = 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd))
    sec = torch.repeat_interleave(torch.arange(3), torch.tensor(sections))
    ang = pos[sec].permute(1, 2, 0).double() * freqs
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x.double().chunk(2, dim=-1)
    ref = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    err64, err_cpu = rel(out.cpu().double(), ref), rel(out.cpu(), cpu)
    log(f"  apply_mrope (B 2, S 64, {cfg.n_heads} heads of {hd}, sections {sections}, positions "
        f"below 4096): the card against f64 rel {err64:.3g} (limit 1e-3), against the CPU rel "
        f"{err_cpu:.3g}")
    if not (err64 <= 1e-3 and err_cpu <= 1e-3):
        raise AssertionError(f"phase 15 (c): apply_mrope rel {err64:.3g} / {err_cpu:.3g}")
    toks = torch.randint(1, cfg.vocab_size, (2, 32), generator=g).cuda()
    emb = decoder.embed_tokens(eng.params, toks, cfg)
    a, kv_a = decoder.prefill(eng.params, cfg, toks)
    b, kv_b = decoder.prefill(eng.params, cfg, embeds=emb)
    torch.cuda.synchronize()
    if not (torch.equal(a, b) and all(torch.equal(x["k"], y["k"]) for x, y in zip(kv_a, kv_b))):
        raise AssertionError(f"phase 15 (c): prefill from embeds differs (rel {rel(a, b):.3g})")
    log(f"  ok prefill from embeds= (2 x 32, the packed table's rows) equals the token prefill "
        f"bit for bit: logits and all {len(kv_a)} layers' K/V")


def _ssm_cut(torch, cfg):
    from repro_torch.launch.dryrun import dryrun_policy
    from repro_torch.models import mamba2
    from repro_torch.quant import apply as qapply

    cut = dataclasses.replace(cfg, n_layers=SSM_CUT_LAYERS, dtype="float32")
    params = mamba2.init(cut, torch.Generator(device="cuda").manual_seed(SEED + 22),
                         device="cuda")
    serve = qapply.pack_for_serve(params, dryrun_policy(qapply.layer_specs(params, cut),
                                                        "mixed"), cut)
    return cut, serve


def ssm_modes(torch, cfg) -> None:
    """Phase 16 (c): the width cut to 2 layers in f32 through the engine: the
    kernels against the plain versions (streams equal up to near-ties of the
    gap the two leave on one state), chunked admission (the prefix
    recomputed) against whole, and a length-1 prompt in a slot a longer
    request just left against the same prompt on a fresh engine."""
    from repro_torch import kernels
    from repro_torch.models import mamba2
    from repro_torch.serve.engine import Request, ServeEngine

    smi = smi_line()
    cut, serve = _ssm_cut(torch, cfg)
    slots, seq, new = 4, 256, 16
    gen = torch.Generator().manual_seed(SEED + 23)
    lens = torch.randint(8, 25, (8,), generator=gen).tolist()
    reqs = [Request(uid=i, prompt=torch.randint(1, cut.vocab_size, (n,), generator=gen).tolist(),
                    max_new_tokens=new) for i, n in enumerate(lens)]
    base = dict(max_slots=slots, max_seq=seq, shed=steady())
    runs = {}
    for mode, kw in {"kernels": {}, "plain": {"impl": "torch"},
                     "chunked": {"prefill_chunk": 8}}.items():
        kernels.reset_counts()
        eng = ServeEngine(cut, serve, **base, **kw)
        collect = record_logits(torch, eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run([dataclasses.replace(r) for r in reqs])
        torch.cuda.synchronize()
        st = eng.stats()
        runs[mode] = dict(out=out, rows=collect())
        log(f"  ({smi}) {mode:8s}: {time.perf_counter() - t0:.2f} s, {st['decode_steps']} "
            f"decode steps, {st['admissions']} admissions, {st['prefill_chunks']} chunks; "
            f"launches {_nonzero(st['launches'])}, plain {_nonzero(st['plain_calls'])}")
        del eng
    # the gap kernels and plain versions leave on one state: one decode step
    toks = torch.tensor([r.prompt[:8] for r in reqs[:slots]], device="cuda")
    _, st_k = mamba2.prefill(serve, cut, toks, logits=False)
    st_p = [{k: v.clone() for k, v in layer.items()} for layer in st_k]
    last = toks[:, -1:]
    a, _ = mamba2.decode_step(serve, cut, st_k, last, 8)
    b, _ = mamba2.decode_step(serve, cut, st_p, last, 8, impl="torch")
    gap = float((a - b).abs().max())
    log(f"  kernels against plain versions on one state, one decode step: logits rel "
        f"{rel(a, b):.3g}, max |difference| {gap:.4g}")
    if not rel(a, b) <= 1e-4:
        raise AssertionError(f"phase 16 (c): decode step kernels vs plain rel {rel(a, b):.3g}")
    k = runs["kernels"]
    for mode in ("plain", "chunked"):
        parted = near_ties(k["out"], runs[mode]["out"], k["rows"], runs[mode]["rows"], gap, mode)
        log(f"  ok kernels vs {mode}: {parted} of {len(reqs)} streams part, each at a near-tie")
    # a length-1 prompt into the slot a 20-token request just left
    one = dict(max_slots=1, max_seq=seq, shed=steady())
    fresh = ServeEngine(cut, serve, **one).generate([[42]], max_new_tokens=new)[0]
    eng = ServeEngine(cut, serve, **one)
    after = eng.generate([list(range(3, 23)), [42]], max_new_tokens=new)[1]
    if after != fresh:
        raise AssertionError(f"phase 16 (c): the length-1 prompt after another request "
                             f"{after} != on a fresh engine {fresh}")
    log(f"  ok a length-1 prompt in the slot a 20-token request left decodes as on a fresh "
        f"engine ({new} tokens equal): the slot's recurrent rows were reset")
    del serve, runs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 17 and 18: zamba2-2.7b (the hybrid) and whisper-tiny (enc-dec)
# ---------------------------------------------------------------------------

ZAMBA_ARCH = "zamba2-2.7b"
WHISPER_ARCH = "whisper-tiny"
#: zamba2-2.7b's packed linears, (N, K): in_proj (z, x, B, C, dt: 2 x 5120 + 2 x
#: 64 + 80), out_proj, the shared block's fused wqkv (3 x 32 heads of 80), fused
#: gate/up, w_down, and the untied head; whisper-tiny's fused wqkv (3 x 6 heads of
#: 64), w_up, w_down and the untied head (51865: N % 4 = 1)
ZAMBA_LINEARS = {"in_proj": (10448, 2560), "out_proj": (2560, 5120), "wqkv": (7680, 2560),
                 "w_gu": (20480, 2560), "w_down": (2560, 10240), "lm_head": (32000, 2560)}
WHISPER_LINEARS = {"wqkv": (1152, 384), "w_up": (1536, 384), "w_down": (384, 1536),
                   "lm_head": (51865, 384)}
#: the shared attention's decode step: 32 KV heads of 80 (a group of 1) over
#: 4608 positions under the 4096 window; positions before, at and past it
HD80_KV = dict(B=4, n_kv=32, g=1, hd=80, S=4608, block=16, window=4096)
HD80_POS = (300, 4095, 4100, 4607)
#: row 8 at the same heads: d 512 (the widest its gate admits, where it must
#: equal the launches it replaces bit for bit) and zamba2's d 2560
HD80_PROJ_D = (512, 2560)
#: phase 17 (c): 2 slots of 4608, a prompt past the window and a short one
WINDOW_SEQ, WINDOW_PROMPT, WINDOW_NEW = 4608, 4161, 64
#: phase 17 (d): the width cut to 12 layers (two applications of the shared block)
ZAMBA_CUT_LAYERS = 12
ZAMBA_TRAIN_ARGV = ["--arch", ZAMBA_ARCH, "--layers", str(ZAMBA_CUT_LAYERS), "--steps", "8",
                    "--batch", "8", "--seq", "128", "--wbits", "4", "--seed", str(SEED)]
#: 8 bits: about 712 MiB for the cut model; the state at 4 slots x 512, 8 bits:
#: 2 x 2 x 4 x 512 x 32 x 80 bytes (plus scales)
ZAMBA_SEARCH_ARGV = ["--arch", ZAMBA_ARCH, "--limit", "size_mib=600", "--limit",
                     "state_bytes=12600000", "--kv-max-seq", "512", "--pretrain-steps", "4",
                     "--phase2-iters", "4", "--seq", "64", "--batch", "8", "--seed", str(SEED)]
ZAMBA_SEARCH_SERVE_ARGV = ["--arch", ZAMBA_ARCH, "--requests", "4", "--max-new", "8",
                           "--slots", "4", "--max-seq", "512", "--seed", str(SEED + 26)]
#: phase 18: 4 clips, prompts of one length drawn in 4-16, 32 greedy tokens
WHISPER_B, WHISPER_NEW = 4, 32
WHISPER_TRAIN_ARGV = ["--arch", WHISPER_ARCH, "--steps", "8", "--batch", "8", "--seq", "128",
                      "--wbits", "4", "--seed", str(SEED)]
#: 8 bits: about 37 MiB (the 51865 x 384 head and table are 19.9 M each)
WHISPER_SEARCH_ARGV = ["--arch", WHISPER_ARCH, "--limit", "size_mib=30", "--pretrain-steps",
                       "4", "--phase2-iters", "4", "--seq", "64", "--batch", "8",
                       "--seed", str(SEED)]


def _kv_clone_state(torch, state):
    """A deep copy of a decode state (tensors and KV containers)."""
    from repro_torch.kvcache import QuantizedKVLayer

    if isinstance(state, QuantizedKVLayer):
        return _clone(state)
    if isinstance(state, dict):
        return {k: _kv_clone_state(torch, v) for k, v in state.items()}
    if isinstance(state, list):
        return [_kv_clone_state(torch, v) for v in state]
    return state.clone()


def _scramble_outside(torch, layer, pos, window: int, seed: int) -> int:
    """Overwrite, in place, the packed K/V levels of every row older than the
    window of each slot's ``pos`` with other levels; returns the rows touched."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    old = torch.arange(layer.seq, device="cuda")[None, :] <= (pos[:, None].long() - window)
    for side in ("k_packed", "v_packed"):
        t = getattr(layer, side)
        noise = torch.randint(-100, 100, t.shape, generator=g, device="cuda", dtype=torch.int8)
        t.copy_(torch.where(old[:, None, :, None], noise, t))
    return int(old.sum())


def _moved_blocks(a, b, block: int) -> list[set]:
    """Per slot, the sequence blocks whose packed K or V bytes differ."""
    out = []
    for i in range(a.k_packed.shape[0]):
        rows = set()
        for side in ("k_packed", "v_packed"):
            diff = (getattr(a, side)[i] != getattr(b, side)[i]).any(dim=0).any(dim=-1)
            rows |= set(diff.nonzero().flatten().tolist())
        out.append({r // block for r in rows})
    return out


def check_window_kernels(torch, gen, results: dict) -> None:
    """Phase 17 (a): row 3 at zamba2's heads (32 KV heads of 80, a group of
    1) under the 4096 window in ``kv_valid``, K 8 / V 4, 8 / 8 and 4 / 2, f32
    and bf16: cache bytes exact against the plain version and the output
    within rel 1e-4 (phase 2's limit); the output bit-equal when the rows
    older than the window hold other levels; only the block at ``pos``
    requantized.  Row 8 at the same heads and window, d 512 and 2560, weights
    at 4 bits: scales rel 1e-6 and output rel 1e-5 against its plain version
    where no cache byte differs; at d 512 bit for bit the launches it
    replaces."""
    from repro_torch.kernels.quant_kv import ops as kv_ops
    from repro_torch.models.layers import rope_freqs
    from repro_torch.quant.tensor import quantize_tensor

    smi = smi_line()
    c = HD80_KV
    b, s, h, hd, blk, win = c["B"], c["S"], c["n_kv"], c["hd"], c["block"], c["window"]
    hq = h * c["g"]
    pos = torch.tensor(HD80_POS, dtype=torch.int32, device="cuda")
    ar = torch.arange(s, device="cuda")[None, :]
    valid = (ar <= pos[:, None]) & (ar > pos[:, None] - win)
    r = results["quant_kv_decode_step"]
    for k_bits, v_bits in ((8, 4), (8, 8), (4, 2)):
        base = _kv_layer_of(torch, gen, b, s, h, hd, blk, k_bits, v_bits)
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn((b, hq, hd), generator=gen, device="cuda").to(dt)
            kn = torch.randn((b, 1, h, hd), generator=gen, device="cuda").to(dt)
            vn = torch.randn((b, 1, h, hd), generator=gen, device="cuda").to(dt)
            lk, lp, lo = _clone(base), _clone(base), _clone(base)
            n_old = _scramble_outside(torch, lo, pos, win, k_bits * 10 + v_bits)
            o_k, _ = kv_ops.quant_kv_decode_step(q, lk, pos, kn, vn, valid,
                                                 out_dtype=torch.float32)
            o_o, _ = kv_ops.quant_kv_decode_step(q, lo, pos, kn, vn, valid,
                                                 out_dtype=torch.float32)
            o_p, _ = kv_ops.quant_kv_decode_step(q, lp, pos, kn, vn, valid, impl="torch",
                                                 out_dtype=torch.float32)
            torch.cuda.synchronize()
            tag = f"phase 17 (a): row 3 at hd {hd}, k{k_bits}/v{v_bits} {dt}"
            for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
                if not torch.equal(getattr(lk, f), getattr(lp, f)):
                    raise AssertionError(f"{tag}: {f} differs from the plain version")
            err = rel(o_k, o_p)
            r["max_abs_err"] = max(r["max_abs_err"], float((o_k - o_p).abs().max()))
            if not err <= 1e-4:
                raise AssertionError(f"{tag}: rel {err:.3g} > 1e-4")
            if not torch.equal(o_k, o_o):
                raise AssertionError(f"{tag}: the output moved when the {n_old} rows older "
                                     f"than the window changed (rel {rel(o_k, o_o):.3g})")
            moved = _moved_blocks(lk, base, blk)
            want = [{p // blk} for p in HD80_POS]
            if moved != want:
                raise AssertionError(f"{tag}: requantized blocks {moved}, want {want}")
        t_k = time_ms(torch, lambda: kv_ops.quant_kv_decode_step(q, _clone(base), pos, kn, vn,
                                                                 valid))
        log(f"  ok ({smi}) row 3 at {h} KV heads of {hd} (a group of 1), B {b}, S {s}, window "
            f"{win}, k{k_bits}/v{v_bits}, f32 and bf16: bytes exact, rel {err:.2e}; bit-equal "
            f"with the {n_old} rows older than the window changed; only the blocks at pos "
            f"{HD80_POS} requantized; a call with a cache copy {t_k:.4f} ms")
        del base
    r8 = results["quant_kv_decode_step_proj"]
    ang = pos[:, None].float() * rope_freqs(hd, 10_000.0, device="cuda")
    cos, sin = torch.cos(ang), torch.sin(ang)
    base = _kv_layer_of(torch, gen, b, s, h, hd, blk, 8, 4)
    for d in HD80_PROJ_D:
        wq = quantize_tensor(torch.randn((d, 3 * hq * hd), generator=gen, device="cuda")
                             / d ** 0.5, 4)
        x = torch.randn((b, d), generator=gen, device="cuda")
        lk, lp = _clone(base), _clone(base)
        o_k, _ = kv_ops.quant_kv_decode_step_proj(x, wq.packed, wq.scale, cos, sin, lk, pos,
                                                  valid, w_bits=4, n_heads=hq)
        o_p, _ = kv_ops.quant_kv_decode_step_proj(x, wq.packed, wq.scale, cos, sin, lp, pos,
                                                  valid, w_bits=4, n_heads=hq, impl="torch")
        torch.cuda.synchronize()
        tag = f"phase 17 (a): row 8 at hd {hd}, d {d}"
        for f in ("k_scale", "v_scale"):
            if not rel(getattr(lk, f), getattr(lp, f)) <= 1e-6:
                raise AssertionError(f"{tag}: {f} rel {rel(getattr(lk, f), getattr(lp, f)):.3g}")
        diff = sum(int((getattr(lk, f) != getattr(lp, f)).sum()) for f in ("k_packed",
                                                                             "v_packed"))
        err = rel(o_k, o_p)
        r8["max_abs_err"] = max(r8["max_abs_err"], float((o_k - o_p).abs().max()))
        if diff == 0 and not err <= 1e-5:
            raise AssertionError(f"{tag}: rel {err:.3g} > 1e-5 against the plain version")
        note = f"plain rel {err:.2e}" + (f" ({diff} cache bytes at a rounding edge)" if diff
                                         else ", cache bytes exact")
        if d <= 512:
            lc = _clone(base)
            o_c = proj_composition(torch, x, wq, lc, pos, valid, n_heads=hq, step="cuda")
            torch.cuda.synchronize()
            same = torch.equal(o_k, o_c) and all(torch.equal(getattr(lk, f), getattr(lc, f))
                                                 for f in ("k_packed", "k_scale", "v_packed",
                                                           "v_scale"))
            if not same:
                raise AssertionError(f"{tag}: differs from the launches it replaces")
            note += "; bit for bit the GEMV, the rotation and row 3"
        t_k = time_ms(torch, lambda: kv_ops.quant_kv_decode_step_proj(
            x, wq.packed, wq.scale, cos, sin, _clone(base), pos, valid, w_bits=4, n_heads=hq))
        log(f"  ok ({smi}) row 8 at {hq} heads of {hd} ({3 * hd} projected rows a kv head, "
            f"{3 * hd // 16} tiles of 16), d {d}, w 4 bits, K 8 / V 4, window {win}: {note}; a "
            f"call with a cache copy {t_k:.4f} ms")
    del base
    torch.cuda.empty_cache()


def _hybrid_packed(torch, cfg, seed: int):
    from repro_torch.launch.dryrun import dryrun_policy
    from repro_torch.models import hybrid
    from repro_torch.quant import apply as qapply

    params = hybrid.init(cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    return qapply.pack_for_serve(params, dryrun_policy(qapply.layer_specs(params, cfg), "mixed"),
                                 cfg)


def serve_window(torch, cfg) -> dict:
    """Phase 17 (c): the window on the card.  A ``ServeEngine`` at full width
    and depth in f32 (as phases 8 (a) and 16 (c) hold kernels against plain
    versions: in bf16 the two paths' roundings through a 4352-row prefill and
    54 layers part the first logits by rel 0.14), 2 slots of 4608, a K 8 /
    V 4 state: a 4161-token prompt (its prefill takes the flash path under
    the window) and a 12-token one, 64 new tokens each, through the kernels
    and through the plain versions: the first token's logits within rel
    1e-2 (each path's prefill of 4352 rows through 54 layers parts the
    states with depth: logged), streams equal up to near-ties of the largest
    logit difference the run shows where they agree (the recurrent states
    carry that parting step by step), launches as predicted.  Then on
    one state: a decode step through the kernels and the plain versions
    within rel 1e-3 (phase 8's f32 limit); its
    logits bit-equal when the rows older than the window change; only the
    block at ``pos`` requantized in each of the 9 applications' caches."""
    from repro_torch import kernels
    from repro_torch.kvcache import insert_state_rows
    from repro_torch.models import hybrid
    from repro_torch.quant import apply as qapply
    from repro_torch.serve.engine import Request, ServeEngine

    smi = smi_line()
    free_memory(torch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    serve = _hybrid_packed(torch, cfg, SEED + 24)
    pad = min(-(-(WINDOW_PROMPT - 1) // 256) * 256, WINDOW_SEQ)     # the engine's prefill rows
    gen = torch.Generator().manual_seed(SEED + 25)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (WINDOW_PROMPT, 12)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=WINDOW_NEW) for i, p in enumerate(prompts)]
    kw = dict(max_slots=2, max_seq=WINDOW_SEQ, prefill_pad=256, shed=steady(),
              state_bits=state_policy(cfg, 2, WINDOW_SEQ))
    runs = {}
    for mode, extra in (("kernels", {}), ("plain", {"impl": "torch"})):
        kernels.reset_counts()
        eng = ServeEngine(cfg, serve, **kw, **extra)
        collect = record_logits(torch, eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run([dataclasses.replace(r) for r in reqs])
        torch.cuda.synchronize()
        st = eng.stats()
        runs[mode] = dict(out=out, rows=collect(), st=st)
        ttft = ttft_samples(torch, eng)
        log(f"  ({smi}) {mode:7s}: {time.perf_counter() - t0:.2f} s, {st['decode_steps']} "
            f"decode steps (median {st['decode_step_median_s'] * 1e3:.3f} ms), "
            f"{st['admissions']} admission (TTFT p50 {ttft['p50'] * 1e3:.1f} ms, the "
            f"{WINDOW_PROMPT}-token prompt padded to {pad} through the flash path under the "
            f"window); launches {_nonzero(st['launches'])}, plain {_nonzero(st['plain_calls'])}")
        del eng
    st = runs["kernels"]["st"]
    fused = qapply.fuse_projections(serve)             # the tree the engines serve
    n_lin = _packed_linears(fused) + _shared_linears(fused, cfg)
    steps, adm = st["decode_steps"], st["admissions"]
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(quant_gemv=(n_lin + 1) * steps, quant_matmul=n_lin * adm,
                quant_kv_decode_step=hybrid.n_attn_applications(cfg) * steps)
    if st["launches"] != want or any(st["plain_calls"].values()):
        raise AssertionError(f"phase 17 (c): launches {_nonzero(st['launches'])} (want "
                             f"{_nonzero(want)}), plain {_nonzero(st['plain_calls'])}")
    # one state after the engine's prefill (the heads padded to 4352 rows):
    # the gap, the window, the block at pos
    heads = [p[:-1] for p in prompts]
    toks = torch.zeros((2, pad), dtype=torch.long)
    for i, hd_ in enumerate(heads):
        toks[i, :len(hd_)] = torch.tensor(hd_)
    lengths = torch.tensor([len(hd_) for hd_ in heads], dtype=torch.int32, device="cuda")
    last = torch.tensor([[p[-1]] for p in prompts], device="cuda")
    pos = lengths
    states = {}
    for impl in ("auto", "torch"):
        _, new = hybrid.prefill(serve, cfg, toks.cuda(), impl=impl, lengths=lengths,
                                logits=False)
        st0 = hybrid.init_decode_state(cfg, 2, WINDOW_SEQ, torch.float32,
                                       state_bits=[(8, 4)] * hybrid.n_attn_applications(cfg))
        states[impl] = insert_state_rows(st0, [0, 1], new, lengths)
        del new
    state = states["auto"]
    a, st_a = hybrid.decode_step(serve, cfg, _kv_clone_state(torch, state), last, pos)
    b_, _ = hybrid.decode_step(serve, cfg, _kv_clone_state(torch, state), last, pos,
                               impl="torch")
    # the gap the two paths leave end to end: each prefill (the GEMM or its plain
    # version over 4352 rows and 54 layers) and then its first decode step
    drift = [(i, rel(states["torch"]["mamba"][i]["ssm"], state["mamba"][i]["ssm"]))
             for i in range(0, cfg.n_layers, 13)] + [
        (cfg.n_layers - 1, rel(states["torch"]["mamba"][-1]["ssm"], state["mamba"][-1]["ssm"]))]
    p_, _ = hybrid.decode_step(serve, cfg, states.pop("torch"), last, pos, impl="torch")
    torch.cuda.synchronize()
    gap = float((a - p_).abs().max())
    log(f"  the two prefills' Mamba states part with depth (layer: rel) "
        f"{', '.join(f'{i}: {r:.2e}' for i, r in drift)}")
    # kernels against plain versions on one state within phase 8's f32 limit;
    # after each path's own 4352-row prefill through 54 layers the logits
    # part by what the states above carry, held within 1e-2
    if not (rel(a, b_) <= 1e-3 and rel(a, p_) <= 1e-2):
        raise AssertionError(f"phase 17 (c): one decode step, kernels vs plain rel "
                             f"{rel(a, b_):.3g} on one state (limit 1e-3), {rel(a, p_):.3g} "
                             f"each after its own prefill (limit 1e-2), f32")
    poked = _kv_clone_state(torch, state)
    n_old = sum(_scramble_outside(torch, layer, pos, cfg.attn_window, 7 + j)
                for j, layer in enumerate(poked["attn"]))
    c, _ = hybrid.decode_step(serve, cfg, poked, last, pos)
    torch.cuda.synchronize()
    if n_old == 0 or not torch.equal(a, c):
        raise AssertionError(f"phase 17 (c): {n_old} rows older than the window changed and "
                             f"the logits moved (rel {rel(a, c):.3g})")
    blk = state["attn"][0].block
    want_blocks = [{int(p) // blk} for p in pos.tolist()]
    for j, (before, after) in enumerate(zip(state["attn"], st_a["attn"])):
        moved = _moved_blocks(after, before, blk)
        if moved != want_blocks:
            raise AssertionError(f"phase 17 (c): application {j} requantized blocks {moved}, "
                                 f"want {want_blocks}")
    log(f"  ok one decode step at positions {pos.tolist()} (window {cfg.attn_window}): kernels "
        f"vs plain rel {rel(a, b_):.3g} on one state; after each path's own prefill rel "
        f"{rel(a, p_):.3g}, max |difference| {gap:.4g} (the gap); logits bit-equal with the "
        f"{n_old} rows older than the window changed ({len(state['attn'])} applications' "
        f"caches); only the blocks at pos requantized in all of them")
    k, p = runs["kernels"], runs["plain"]
    # where the streams agree the two engines' logits drift apart step by step
    # (the recurrent states carry the prefills' parting): the first token's
    # logits within 1e-2, and a stream may part only at a near-tie of the
    # largest difference the run shows where they still agree
    first = worst = drift = 0.0
    for uid, toks_ in k["out"].items():
        t_end = next((i for i, (x, y) in enumerate(zip(toks_, p["out"][uid])) if x != y),
                     len(toks_))
        for t in range(t_end):
            ra, rb = k["rows"][(uid, t)], p["rows"][(uid, t)]
            worst = max(worst, rel(ra, rb))
            drift = max(drift, float((ra - rb).abs().max()))
            if t == 0:
                first = max(first, rel(ra, rb))
    if not first <= 1e-2:
        raise AssertionError(f"phase 17 (c): first-token logits rel {first:.3g} > 1e-2")
    parted = near_ties(k["out"], p["out"], k["rows"], p["rows"], max(gap, drift), "plain")
    log(f"  ok kernels vs plain: {parted} of 2 streams part, each at a near-tie of the run's "
        f"drift {max(gap, drift):.4g}; first-token logits rel {first:.3g} (limit 1e-2), rel "
        f"<= {worst:.3g} over the {WINDOW_NEW} steps where the streams agree")
    del serve, fused, runs, state, st_a, poked
    torch.cuda.empty_cache()
    return st["launches"]


def _zamba_cut(cfg):
    return dataclasses.replace(cfg, n_layers=ZAMBA_CUT_LAYERS)


def zamba_qat_step(torch, cfg) -> None:
    """Phase 17 (d): one QAT step of the width cut to 12 layers, f32, mixed
    bits, 8 x 64: loss and gradients through the kernels, the plain versions
    and the kernels again, every leaf bit-equal; the shared block's leaves
    are fake-quantized at both applications and their gradients sum both."""
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import TokenTask, batch_on, global_batch
    from repro_torch.launch.dryrun import dryrun_policy
    from repro_torch.models import hybrid, registry
    from repro_torch.quant import apply as qapply
    from repro_torch.train.train_step import value_and_grad

    smi = smi_line()
    free_memory(torch)
    cut = dataclasses.replace(_zamba_cut(cfg), dtype="float32")
    params = hybrid.init(cut, torch.Generator(device="cuda").manual_seed(SEED + 27),
                         device="cuda")
    specs = qapply.layer_specs(params, cut)
    bits = qapply.bits_for_scan(dryrun_policy(specs, "mixed"), params, cut)
    batch = batch_on(global_batch(TokenTask(cut.vocab_size), cut,
                                  ShapeSpec("search", "train", 64, 8), 0), "cuda")
    api = registry.get_api(cut)
    per_fwd = _fq_per_forward(cut, specs)
    step = (per_fwd + _fq_recomputed(cut, specs), per_fwd)
    runs = {}
    for key, impl in (("kernels", "auto"), ("plain", "torch"), ("kernels again", "auto")):
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(
            lambda p, b, bb, impl=impl: api.loss(p, cut, b, bits=bb, impl=impl), params, batch,
            bits)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = (kernels.LAUNCHES["fake_quant"], kernels.LAUNCHES["fake_quant_ste_bwd"])
        plain = (kernels.PLAIN_CALLS["fake_quant"], kernels.PLAIN_CALLS["fake_quant_ste_bwd"])
        want = (step, (0, 0)) if impl == "auto" else ((0, 0), step)
        if (got, plain) != want:
            raise AssertionError(f"phase 17 (d) {key}: launches {got}, plain calls {plain} "
                                 f"(want {want})")
        if not (torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)):
            raise AssertionError(f"phase 17 (d) {key}: non-finite loss or gradient")
        runs[key] = (loss, grads)
        log(f"  ({smi}) QAT step, {key}: loss {float(loss):.6f} in {dt:.3f} s; fake-quant and "
            f"STE launches {got} ({len(specs)} leaves, the shared block's 7 at "
            f"{hybrid.n_attn_applications(cut)} applications: {per_fwd} a forward, the "
            f"recompute's {step[0] - per_fwd}), plain calls {plain}")
    for a, b in (("kernels", "plain"), ("kernels", "kernels again")):
        (la, ga), (lb, gb) = runs[a], runs[b]
        same = [torch.equal(x, y) for x, y in zip(ga, gb)]
        if not torch.equal(la, lb) or not all(same):
            worst = max(rel(x, y) for x, y in zip(ga, gb))
            raise AssertionError(f"phase 17 (d) {a} vs {b}: loss rel {rel(la, lb):.3g}, "
                                 f"gradients equal in {sum(same)} of {len(same)} leaves, "
                                 f"max rel {worst:.3g}")
        log(f"  ok {a} vs {b}: loss and all {len(same)} gradient leaves bit-equal")
    n_params = sum(leaf.numel() for _, leaf in qapply._walk(params))
    log(f"  {cut.name} cut to {cut.n_layers} layers, f32: {n_params / 1e9:.3f} G parameters")
    del params, runs, grads, batch
    torch.cuda.empty_cache()


def whisper_decode(torch, cfg) -> dict:
    """Phase 18 (b): full width and depth under ``dryrun_policy("mixed")``,
    the projections fused as the engine fuses them; ``prefill(tokens,
    frames)`` at B 4 (numpy frames N(0, 0.02), prompts of one length), then
    32 greedy tokens through ``decode_step`` with the kernels and with
    ``impl="torch"``: tokens equal up to near-ties, logits within rel 5e-2
    (bf16) where they agree; ``prepare_decode``'s cross K/V equal to
    ``prefill``'s; the launches a step as the tree predicts; the engine's
    refusal.  Returns the kernel run's launches."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch.dryrun import dryrun_policy
    from repro_torch.models import encdec
    from repro_torch.quant import apply as qapply
    from repro_torch.serve.engine import ServeEngine

    smi = smi_line()
    free_memory(torch)
    params = encdec.init(cfg, torch.Generator(device="cuda").manual_seed(SEED + 28),
                         device="cuda")
    policy = dryrun_policy(qapply.layer_specs(params, cfg), "mixed")
    serve = qapply.fuse_projections(qapply.pack_for_serve(params, policy, cfg))
    try:
        ServeEngine(cfg, serve, device="cuda")
        raise AssertionError("phase 18 (b): ServeEngine took the enc-dec family")
    except NotImplementedError as e:
        log(f"  ServeEngine refuses {cfg.name}: {e}")
    rng = np.random.default_rng(SEED + 29)
    frames = torch.from_numpy((rng.standard_normal((WHISPER_B, cfg.encoder_seq, cfg.d_model))
                               * 0.02).astype(np.float32)).to("cuda")
    s0 = int(rng.integers(4, 17))
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (WHISPER_B, s0))).to("cuda")

    def per_step(tree) -> int:
        """GEMVs a decode step: the head, then a layer's self Q/K/V (one fused
        launch or three) and wo, the cross query (the fused wqkv or wq) and
        wo, and the MLP's two."""
        return 1 + sum((1 if "wqkv" in lp["self_attn"] else 3) + 5 for lp in tree["dec_layers"])

    runs = {}
    for mode, impl in (("kernels", "auto"), ("plain", "torch")):
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, st = encdec.prefill(serve, cfg, toks, frames, impl=impl)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        pre = dict(kernels.LAUNCHES) if impl == "auto" else dict(kernels.PLAIN_CALLS)
        full = encdec.init_cache(cfg, WHISPER_B, s0 + WHISPER_NEW, torch.bfloat16,
                                 device="cuda")
        for f, s_ in zip(full["self"], st["self"]):
            for n_ in ("k", "v"):
                f[n_][:, :s0] = s_[n_]
        full["cross"] = st["cross"]
        kernels.reset_counts()
        tok = logits[:, -1].float().argmax(-1)
        out, rows, times = [tok], [logits[:, -1]], []
        for i in range(WHISPER_NEW - 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, full = encdec.decode_step(serve, cfg, full, tok[:, None], s0 + i, impl=impl)
            tok = logits[:, -1].float().argmax(-1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            out.append(tok)
            rows.append(logits[:, -1])
        dec = dict(kernels.LAUNCHES) if impl == "auto" else dict(kernels.PLAIN_CALLS)
        runs[mode] = dict(out=torch.stack(out, 1).tolist(), rows=torch.stack(rows, 1), pre=pre,
                          dec=dec, cross=st["cross"])
        log(f"  ({smi}) {mode:7s}: prefill of {WHISPER_B} x {s0} tokens over "
            f"{WHISPER_B} x {cfg.encoder_seq} frames {t_pre * 1e3:.2f} ms "
            f"({_nonzero(pre)}); {WHISPER_NEW - 1} decode steps, median "
            f"{statistics.median(times) * 1e3:.3f} ms ({_nonzero(dec)})")
    k, p = runs["kernels"], runs["plain"]
    n_step = per_step(serve)
    if k["dec"]["quant_gemv"] != n_step * (WHISPER_NEW - 1) or any(
            v for n_, v in k["dec"].items() if n_ != "quant_gemv"):
        raise AssertionError(f"phase 18 (b): decode launches {_nonzero(k['dec'])}, want "
                             f"{n_step} GEMVs a step")
    cross = encdec.prepare_decode(serve, cfg, frames)
    torch.cuda.synchronize()
    if not all(torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
               for a, b in zip(cross, k["cross"])):
        raise AssertionError("phase 18 (b): prepare_decode's cross K/V differ from prefill's")
    gap = float((k["rows"][:, 0].float() - p["rows"][:, 0].float()).abs().max())
    kd = {i: row for i, row in enumerate(k["out"])}
    pd = {i: row for i, row in enumerate(p["out"])}
    krows = {(i, t): k["rows"][i, t] for i in kd for t in range(WHISPER_NEW)}
    prows = {(i, t): p["rows"][i, t] for i in pd for t in range(WHISPER_NEW)}
    parted = near_ties(kd, pd, krows, prows, max(gap, 1e-6), "plain")
    worst = 0.0
    for i in kd:
        t_end = next((t for t, (x, y) in enumerate(zip(kd[i], pd[i])) if x != y), WHISPER_NEW)
        for t in range(t_end):
            worst = max(worst, rel(krows[(i, t)], prows[(i, t)]))
    if not worst <= 5e-2:
        raise AssertionError(f"phase 18 (b): logits rel {worst:.3g} > 5e-2 where streams agree")
    packed = sum(leaf.container_bytes() for _, leaf in qapply._walk(serve)
                 if hasattr(leaf, "container_bytes"))
    log(f"  ok kernels vs plain: {parted} of {WHISPER_B} streams part, each at a near-tie "
        f"(prefill logits gap {gap:.4g}); logits rel <= {worst:.3g} where they agree; "
        f"prepare_decode's cross K/V equal prefill's bit for bit; {n_step} GEMVs a decode step "
        f"(the cross query through the fused wqkv), packed {packed / 1e6:.2f} MB")
    launches = dict(k["pre"])
    for n_, v in k["dec"].items():
        launches[n_] = launches.get(n_, 0) + v
    del serve, runs, cross
    torch.cuda.empty_cache()
    return launches


def whisper_search(torch, cfg) -> None:
    """Phase 18 (c): ``launch.search.main`` under a size limit below the 8-bit
    size (the weight phase; a state limit is refused: the family has no KV
    state), its artifact packed and its bits verified."""
    from repro_torch import kernels
    from repro_torch.core.policy import PolicyArtifact
    from repro_torch.launch import search
    from repro_torch.models import encdec
    from repro_torch.quant import apply as qapply

    smi = smi_line()
    out = ROOT / "build" / "phase18_policy.json"
    out.parent.mkdir(exist_ok=True)
    envs = []
    real_env = search.LMQuantEnv

    class Recording(real_env):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            envs.append(self)

    search.LMQuantEnv = Recording
    try:
        free_memory(torch)
        kernels.reset_counts()
        t0 = time.perf_counter()
        rc = search.main(WHISPER_SEARCH_ARGV + ["--out", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        search.LMQuantEnv = real_env
    launches, plain = dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)
    env = envs[0]
    want = search_launches(cfg, env, {})
    if rc not in (0, 1) or launches != want or any(plain.values()):
        raise AssertionError(f"phase 18 (c): rc {rc}, launches {launches} (want {want}), "
                             f"plain calls {plain}")
    art = PolicyArtifact.load(str(out))
    params = encdec.init(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    art.verify_layers(qapply.layer_specs(params, cfg))
    packed = qapply.quantize_for_serve(encdec.unstack_layers(params, cfg), art, cfg)
    qapply.verify_packed_bits(packed, art)
    log(f"  ({smi}) launch.search.main {' '.join(WHISPER_SEARCH_ARGV)}: rc {rc}, wall "
        f"{wall:.2f} s; {_phase_walls(art)}; {env.train_steps} training steps, "
        f"{env.eval_passes} evaluations; policy mean {art.policy.mean_bits():.3f} bits, size "
        f"{art.policy.model_size_mib():.2f} MiB; launches {_nonzero(launches)}, as predicted")
    log(f"  ok the artifact packs and verify_packed_bits holds its {len(art.policy.bits)} "
        f"layers' bits")
    try:
        search.main(WHISPER_SEARCH_ARGV + ["--limit", "state_bytes=1000", "--pretrain-steps",
                                           "0", "--out", str(out)])
        raise AssertionError("phase 18 (c): a state limit was taken")
    except ValueError as e:
        log(f"  a state_bytes limit is refused: {e}")
    del params, packed
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# phase 19: the decode-step autotuner, the engine's replay, the examples
# ---------------------------------------------------------------------------


#: phase 19 (a): gemma-2b's state geometry (one KV head of 256, block 16) at the
#: bit pairs of phase 2 (phase 6's artifact holds K 8 / V 4 at every layer), and
#: the synthetic caches' lengths in blocks: the autotuner's default 8 (S 128),
#: 32 (S 512, phase 4's cache) and 128 (S 2048)
TUNE_BITS = KV_BITS
TUNE_BLOCKS = (8, 32, 128)
TUNE_BLOCK = 16


def autotune_candidates(torch, cfg) -> dict:
    """Phase 19 (a): the CUDA candidate of every key, bit for bit against
    the sequential append -> attention kernels on the same synthetic cache
    (outputs and every cache byte), then timed by ``autotune_key``; returns
    ``{(family, pair, S): us}``."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.quant_kv import ops as kv_ops

    heads, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    out = {}
    for blocks in TUNE_BLOCKS:
        s = TUNE_BLOCK * blocks
        for paged in (False, True):
            keys = autotune.keys_for_state(TUNE_BITS, heads, hd, TUNE_BLOCK, paged=paged,
                                           impl="cuda")
            for key in keys:
                q, layer, pos, kn, vn, valid = autotune._synthetic_inputs(
                    key, batch=8, blocks=blocks, device=torch.device("cuda"))
                seq = kv_ops.quant_kv_append(autotune.clone_layer(layer), pos, kn, vn)
                o_seq = kv_ops.quant_kv_attention(q, seq, valid, out_dtype=torch.float32)
                cands = autotune.enumerate_candidates(key)
                if cands != [{"place": "kernel", "attend": "cluster"}]:
                    raise AssertionError(f"phase 19 (a) {key}: candidates {cands}")
                for cfg_ in cands:
                    o, new = kv_ops.quant_kv_decode_step(q, autotune.clone_layer(layer), pos,
                                                         kn, vn, valid, out_dtype=torch.float32,
                                                         config=cfg_)
                    torch.cuda.synchronize()
                    bad = [f for f in ("k_packed", "v_packed") if not torch.equal(
                        getattr(new, f), getattr(seq, f))] + [
                        f for f in ("k_scale", "v_scale")
                        if not same_bytes(torch, getattr(new, f), getattr(seq, f))]
                    if not same_bytes(torch, o, o_seq) or bad:
                        raise AssertionError(f"phase 19 (a) {key} S {s} {cfg_}: output or "
                                             f"cache {bad} differs from append -> attention")
            if blocks == 8:      # the autotuner's defaults, as the search runs it
                entries = autotune.autotune_state(TUNE_BITS, heads, hd, TUNE_BLOCK,
                                                  paged=paged, impl="cuda")
            else:
                entries = [autotune.autotune_key(k, blocks=blocks) for k in keys]
            for key, e in zip(keys, entries):
                if e["config"] != cands[0] or e["candidates"] != 1:
                    raise AssertionError(f"phase 19 (a) {key}: tuned {e}")
                out[(key.family, (key.k_bits, key.v_bits), s)] = e["micros"]
    for (family, pair, s), us in out.items():
        log(f"  {family} K {pair[0]} / V {pair[1]} S {s}: {us} us a call (20 calls after a "
            f"warm-up)")
    log(f"  ok {len(out)} keys' candidate bit-equal to append -> attention (outputs and "
        f"cache bytes), dense and paged, S {[TUNE_BLOCK * b for b in TUNE_BLOCKS]}")
    return out


def _served_matches(eng, autotune, kernels) -> int:
    """How many of the engine's quantized layers find an installed entry
    under their own geometry, family and resolved impl."""
    n = 0
    for lyr in eng.state:
        family = "decode_step_paged" if hasattr(lyr, "block_table") else "decode_step"
        _, _, heads, hd = lyr.shape
        n += autotune.lookup(family, lyr.k_bits, lyr.v_bits, heads, hd, lyr.block,
                             kernels.resolve_impl("auto", lyr.k_packed.device)) is not None
    return n


def _serve_runs(torch, cfg, serve, reqs, arts: dict, tag: str) -> tuple[dict, dict]:
    """Phase 4's geometry served once per ``arts`` entry ``name: (artifact,
    matched)``, no table installed before each: the number of layers whose
    own geometry finds an installed entry must be ``matched``; the streams
    and launches of each run."""
    from repro_torch import kernels
    from repro_torch.kernels import autotune
    from repro_torch.serve.engine import ServeEngine

    outs, launches = {}, {}
    for name, (art, matched) in arts.items():
        autotune.set_active_configs(None)
        eng = ServeEngine(cfg, serve, max_slots=4, max_seq=512, artifact=art, shed=steady())
        hits = _served_matches(eng, autotune, kernels)
        if hits != matched:
            raise AssertionError(f"phase 19 {tag} ({name}): {hits} served layers find an "
                                 f"installed entry, not {matched}")
        torch.cuda.synchronize()
        kernels.reset_counts()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        st = eng.stats()
        la, plain = st["launches"], st["plain_calls"]
        if (any(plain.values()) or la["quant_kv_decode_step"] != 576
                or la["quant_kv_decode_step"] != cfg.n_layers * st["decode_steps"]):
            raise AssertionError(f"phase 19 {tag} ({name}): launches {la}, plain calls {plain}")
        log(f"  ({name}) {len(autotune.active_configs())} configs installed, {hits} of "
            f"{len(eng.state)} served layers find one; "
            f"{st['decode_steps']} decode steps, row 3 launched {la['quant_kv_decode_step']} "
            f"times; median decode step {st['decode_step_median_s'] * 1e3:.3f} ms")
        outs[name], launches[name] = out, la
        del eng
    first = next(iter(outs.values()))
    if any(o != first for o in outs.values()):
        raise AssertionError(f"phase 19 {tag}: streams differ between {list(outs)}")
    return outs, launches


def replay_serving(torch, cfg) -> dict:
    """Phase 19 (b) and (c): ``attach_kernel_configs`` on phase 6's artifact
    without its pool and draft (its engine (a)), saved and reloaded; phase 4's
    geometry served with the tuned table (every served layer finds its key)
    and with no table (identical streams, row 3 launched 576 times each), a
    traced run (``kernel_config_replayed``); then the refusals and a table
    keyed ``impl="pallas"`` (installs, no layer finds it, the same
    streams)."""
    from repro_torch.checkpoint.store import ArtifactError
    from repro_torch.core.policy import PolicyArtifact
    from repro_torch.kernels import autotune
    from repro_torch.launch.search import attach_kernel_configs
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve.engine import Request, ServeEngine

    art6 = PolicyArtifact.load(str(ROOT / "build" / "phase6_policy.json"))
    dense = dataclasses.replace(art6, pool=None, draft_policy=None, draft_k=0)
    t0 = time.perf_counter()
    tuned = attach_kernel_configs(dense, cfg)
    tune_s = time.perf_counter() - t0
    path = ROOT / "build" / "phase19_policy.json"
    tuned.save(str(path))
    tuned = PolicyArtifact.load(str(path))
    if tuned.meta.get("kernel_autotune_impl") != "cuda" or not tuned.kernel_configs:
        raise AssertionError(f"phase 19 (b): tuned artifact {tuned.kernel_configs}, "
                             f"{tuned.meta}")
    log(f"  attach_kernel_configs on phase 6's artifact (dense) in {tune_s:.2f} s, saved to "
        f"{path.relative_to(ROOT)} and reloaded: " + "; ".join(
            f"{e['key']['family']} K {e['key']['k_bits']} / V {e['key']['v_bits']} -> "
            f"{e['config']} ({e['micros']} us, {e['candidates']} candidates)"
            for e in tuned.kernel_configs))
    bare = dataclasses.replace(tuned, kernel_configs=None)
    serve, _ = packed_model(torch, cfg, SEED + 3)
    gen = torch.Generator().manual_seed(SEED + 4)
    lens = torch.randint(8, 25, (8,), generator=gen).tolist()
    reqs = [Request(uid=i, prompt=torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist(),
                    max_new_tokens=16) for i, n in enumerate(lens)]
    outs, launches = _serve_runs(torch, cfg, serve, reqs,
                                 {"tuned table": (tuned, cfg.n_layers),
                                  "no table": (bare, 0)}, "(b)")
    log("  ok the two runs' streams are identical")
    autotune.set_active_configs(None)
    obs_trace.enable()
    try:
        ServeEngine(cfg, serve, max_slots=4, max_seq=512, artifact=tuned, shed=steady())
        replayed = [e for e in obs_trace.get_tracer().events()
                    if e[1] == "kernel_config_replayed"]
    finally:
        obs_trace.disable()
        obs_trace.get_tracer().clear()
    if len(replayed) != len(tuned.kernel_configs):
        raise AssertionError(f"phase 19 (b): {len(replayed)} kernel_config_replayed events")
    log(f"  ok a traced construction records {len(replayed)} kernel_config_replayed instant(s)")

    # (c) refusals and the reference's impl
    entries = tuned.kernel_configs
    bad = [dict(e, key=dict(e["key"], heads=e["key"]["heads"] + 1)) for e in entries]
    cases = {"tuned for geometry": dataclasses.replace(tuned, kernel_configs=bad),
             "float decode state": dataclasses.replace(tuned, state_policy=None,
                                                       state_registry_hash="")}
    for want, art in cases.items():
        autotune.set_active_configs(None)
        try:
            ServeEngine(cfg, serve, max_slots=4, max_seq=512, artifact=art, shed=steady())
        except ArtifactError as e:
            if want not in str(e) or autotune.active_configs():
                raise
            log(f"  ok refused: {e}")
        else:
            raise AssertionError(f"phase 19 (c): a table '{want}' deployed")
    pallas = dataclasses.replace(tuned, kernel_configs=[
        dict(e, key=dict(e["key"], impl="pallas"), config={"place": "dus", "attend": "substitute"})
        for e in entries])
    p_outs, _ = _serve_runs(torch, cfg, serve, reqs, {"impl pallas table": (pallas, 0)}, "(c)")
    if p_outs["impl pallas table"] != outs["tuned table"]:
        raise AssertionError("phase 19 (c): the pallas-keyed table changed the streams")
    log("  ok a table keyed impl 'pallas' deploys, never matches, and gives the same streams")
    autotune.set_active_configs(None)
    del serve
    torch.cuda.empty_cache()
    return launches["tuned table"]


def examples_on_card(torch) -> None:
    """Phase 19 (d): ``examples/torch_budget_search_serve.py --tiny --paged
    --speculate``, ``examples/torch_serve_quantized.py`` and
    ``examples/torch_quickstart.py`` on the card, their output under
    ``build/`` and checked for their markers (the first: the JAX example
    test's)."""
    import contextlib
    import io

    from repro_torch.kernels import autotune

    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_budget_search_serve
        import torch_quickstart
        import torch_serve_quantized
    finally:
        sys.path.pop(0)
    markers = {"torch_budget_search_serve": ("[kv-budgeted/shift_add]", "[paged] pool",
                                             "served 3 requests on the quantized KV cache",
                                             "[speculative] draft mean_bits="),
               "torch_serve_quantized": ("served 8 requests",),
               "torch_quickstart": ("final: acc=", "shift-add MAC vs INT8 MAC")}
    for mod, argv in ((torch_budget_search_serve, ["--tiny", "--paged", "--speculate"]),
                      (torch_serve_quantized, []), (torch_quickstart, [])):
        name = mod.__name__
        autotune.set_active_configs(None)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        (ROOT / "build" / f"phase19_{name}.log").write_text(text)
        missing = [m for m in markers[name] if m not in text]
        if missing or (name == "torch_budget_search_serve"
                       and text.count("launch.serve --policy") != 2):
            raise AssertionError(f"phase 19 (d) {name}: missing {missing}")
        last = [line for line in text.splitlines()
                if line.startswith(("  served", "served", "[speculative]", "final:"))]
        log(f"  ok {' '.join([f'examples/{name}.py', *argv])} on the card in {wall:.1f} s "
            f"(output in build/phase19_{name}.log): {last[-1].strip()}")

# ---------------------------------------------------------------------------
# phase 20: the multi-device layer on one card
# ---------------------------------------------------------------------------

SP_B = 2
SP_PROMPTS = (4096, 512)           # prefill's flash path (bit for bit) and its direct path
#: logits rel (max |diff| / max |ref|) of prefill_sp (flash) against prefill's
#: direct path at 512 tokens in bf16: phase 9's flash-vs-direct bf16 limit per
#: attention, compounded over the 18 layers
SP_DIRECT_REL = 5e-2
#: phase 20 (b)'s dry-run cells: a dense decode, the MoE family's decode (its
#: dispatch global, its buffer shard-local) and whisper-tiny's training step
DRYRUN_CELLS = (["--arch", "gemma-2b", "--shape", "decode_32k"],
                ["--arch", "deepseek-moe-16b", "--shape", "decode_32k"],
                ["--arch", "whisper-tiny", "--shape", "train_4k"])


def _run_bounded(cmd: list, timeout: float, env: dict | None = None) -> tuple[int, str, float]:
    """Run ``cmd`` in its own session, stopping it and every process it
    started if ``timeout`` passes -> (exit code, output, seconds)."""
    import os
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{' '.join(map(str, cmd))} passed its {timeout:.0f} s limit; "
                             f"its last output: {out[-2000:]}")
    return proc.returncode, out, time.perf_counter() - t0


def _sp_env() -> dict:
    import os

    return dict(os.environ, PYTHONPATH=str(SRC) + (":" + os.environ["PYTHONPATH"]
                                                    if os.environ.get("PYTHONPATH") else ""))


def _sp_profile(torch, fn) -> dict:
    """One profile of ``fn``: launches of row 2's kernel
    (``quant_matmul_kernel``; None where the profile holds no device
    events), the functional all-gathers called (``_c10d_functional``) and
    the all-gathers that ProcessGroupNCCL ran (its ``nccl:`` events), with
    every collective event's name and count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_events = [e for e in events if e.device_type == DeviceType.CUDA]
    gathers = [e for e in events if e.device_type == DeviceType.CPU
               and ("gather" in e.key.lower() or e.key.startswith("nccl"))]
    return {
        "row2": (sum(e.count for e in device_events if "quant_matmul_kernel" in e.key)
                 if device_events else None),
        "functional": sum(e.count for e in gathers
                          if e.key == "_c10d_functional::all_gather_into_tensor"),
        "nccl": sum(e.count for e in gathers if e.key.startswith("nccl:")
                    and "gather" in e.key.lower()),
        "events": {e.key: e.count for e in gathers},
    }


def prefill_sp_on_card(torch, cfg) -> dict:
    """Phase 20 (a): ``decoder.prefill_sp`` at full width (gemma-2b, 18 layers,
    bf16, ``dryrun_policy("mixed")``, random weights) over a 1 x 1
    ``DeviceMesh`` through NCCL, the world of one brought up from a
    ``FileStore`` in a temporary directory: its all-gathers are real NCCL
    calls over a group of one, its linears row 2 through ``qdense``'s
    dispatch.  B 2 at 4096 tokens (bit for bit against ``prefill``, both on
    the flash path) and 512 (``prefill`` on its direct path: logits within
    ``SP_DIRECT_REL``, layer 0's K/V bit for bit), both timed, row 2's
    launches counted by the wrapper and by a profile."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import decoder, layers

    serve, _ = packed_model(torch, cfg, SEED + 40)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    per_pass = 7 * cfg.n_layers          # wq, wk, wv, wo, w_gate, w_up, w_down a layer
    launches = {}
    with tempfile.TemporaryDirectory(prefix="phase20_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_mesh_for((1, 1), ("data", "model"))
            log(f"  world: backend {dist.get_backend()}, mesh {tuple(mesh.shape)} "
                f"{mesh.mesh_dim_names} on {mesh.device_type}")
            for s in SP_PROMPTS:
                tokens = torch.randint(0, cfg.vocab_size, (SP_B, s), generator=gen,
                                       device="cuda")
                with torch.no_grad():
                    kernels.reset_counts()
                    lg, caches = decoder.prefill_sp(serve, cfg, tokens, mesh=mesh)
                    torch.cuda.synchronize()
                    for name, n in kernels.LAUNCHES.items():
                        launches[name] = launches.get(name, 0) + n
                    n_row2 = kernels.LAUNCHES["quant_matmul"]
                    plain = kernels.PLAIN_CALLS["quant_matmul"]
                    ref_l, ref_c = decoder.prefill(serve, cfg, tokens)
                    sp_l = lg.full_tensor()
                    sp_c = [{k: c[k].full_tensor() for k in ("k", "v")} for c in caches]
                    if n_row2 != per_pass or plain:
                        raise AssertionError(f"phase 20 (a) S {s}: row 2 launched {n_row2} "
                                             f"times (expected {per_pass}), {plain} plain calls")
                    if not torch.isfinite(sp_l).all() or sp_l.shape != (SP_B, 1, cfg.vocab_size):
                        raise AssertionError(f"phase 20 (a) S {s}: logits {tuple(sp_l.shape)} "
                                             f"not finite or not (B, 1, V)")
                    if s > layers.FLASH_THRESHOLD:
                        same = torch.equal(sp_l, ref_l) and all(
                            torch.equal(a[k], b[k]) for a, b in zip(sp_c, ref_c)
                            for k in ("k", "v"))
                        if not same:
                            raise AssertionError(f"phase 20 (a) S {s}: prefill_sp differs from "
                                                 f"prefill (logits rel {rel(sp_l, ref_l):.3g})")
                        verdict = "bit for bit equal to prefill (logits and every layer's K/V)"
                    else:
                        r = rel(sp_l, ref_l)
                        kv0 = all(torch.equal(sp_c[0][k], ref_c[0][k]) for k in ("k", "v"))
                        if r > SP_DIRECT_REL or not kv0:
                            raise AssertionError(f"phase 20 (a) S {s}: logits rel {r:.3g} "
                                                 f"(limit {SP_DIRECT_REL:g}), layer 0 K/V "
                                                 f"equal: {kv0}")
                        verdict = (f"logits rel {r:.3g} of prefill's direct path (limit "
                                   f"{SP_DIRECT_REL:g}), layer 0 K/V bit for bit, argmax "
                                   f"{'equal' if torch.equal(sp_l.argmax(-1), ref_l.argmax(-1)) else 'differs'}")
                    del ref_c, sp_c, caches
                    sp_ms = time_ms(torch, lambda: decoder.prefill_sp(serve, cfg, tokens,
                                                                      mesh=mesh), reps=3, warmup=1)
                    ref_ms = time_ms(torch, lambda: decoder.prefill(serve, cfg, tokens), reps=3,
                                     warmup=1)
                    prof = _sp_profile(torch, lambda: decoder.prefill_sp(serve, cfg, tokens,
                                                                         mesh=mesh))
                    # K and V all-gathered a layer, each run by ProcessGroupNCCL
                    want = 2 * cfg.n_layers
                    if prof["functional"] != want or prof["nccl"] != want:
                        raise AssertionError(f"phase 20 (a) S {s}: {prof['functional']} "
                                             f"functional and {prof['nccl']} NCCL all-gathers "
                                             f"in the profile, {want} expected: "
                                             f"{prof['events']}")
                row2 = prof["row2"]
                log(f"  ok prefill_sp B {SP_B} S {s}: {verdict}; row 2 launched {n_row2} times "
                    f"({per_pass} expected, 0 plain calls), profile: "
                    f"{'not measured' if row2 is None else f'{row2} quant_matmul_kernel launches'}"
                    f", all-gathers {prof['functional']} functional = {prof['nccl']} run by NCCL "
                    f"({prof['events']}); prefill_sp {sp_ms:.3f} ms, prefill {ref_ms:.3f} ms")
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    del serve
    torch.cuda.empty_cache()
    return launches


def dryrun_on_card() -> None:
    """Phase 20 (b): ``python -m repro_torch.launch.dryrun`` on each of
    ``DRYRUN_CELLS``, each in a bounded subprocess of its own, the three at
    once (the dry-run runs on meta tensors and the host's cores): the fake
    world of 256 ranks exists in this machine's PyTorch, each cell completes,
    its record is printed."""
    import os
    import signal

    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
                              cwd=ROOT, env=_sp_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for argv in DRYRUN_CELLS]
    try:
        for argv, proc in zip(DRYRUN_CELLS, procs):
            try:
                out, _ = proc.communicate(timeout=max(1.0, 420 - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"phase 20 (b) dry-run {' '.join(argv)} passed its 420 s "
                                     f"limit")
            secs = time.perf_counter() - t0
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            if proc.returncode != 0 or "1/1 cells OK" not in out or not lines:
                raise AssertionError(f"phase 20 (b) dry-run {' '.join(argv)} exit "
                                     f"{proc.returncode}: {out[-3000:]}")
            rec = json.loads(lines[-1])
            log(f"  ok launch.dryrun {' '.join(argv)} within {secs:.1f} s (traced in "
                f"{rec['compile_s']} s, {rec['ops']} ops): per device flops "
                f"{rec['per_device_flops']:.4g}, bytes {rec['per_device_bytes']:.4g}, args "
                f"{rec['arg_bytes_per_device']:.4g} B, live peak "
                f"{rec['peak_bytes_per_device'] - rec['arg_bytes_per_device']:.4g} B, "
                f"collectives {rec['collectives']}, dominant {rec['dominant']} on {rec['hw']}")
            log(f"  record: {lines[-1]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()


def elastic_on_card() -> None:
    """Phase 20 (c): ``examples/torch_elastic_remesh.py`` on the card, its 8
    ranks sharing the GPU over gloo: the backend, the losses, the step it
    resumes at on the re-planned mesh (output in build/phase20_elastic.log)."""
    code, out, secs = _run_bounded([sys.executable, str(ROOT / "examples" /
                                                        "torch_elastic_remesh.py")],
                                   timeout=600, env=_sp_env())
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "phase20_elastic.log").write_text(out)
    need = ("backend: gloo, 8 ranks on cuda (CUDA tensors all-reduced in place)",
            "data-parallel gradient of step 0",
            "replanned mesh: (2, 2)", "resumed cleanly at step 10")
    if code != 0 or any(m not in out for m in need):
        raise AssertionError(f"phase 20 (c) elastic example exit {code}: {out[-3000:]}")
    for ln in out.splitlines():
        if ln.startswith(("backend:", "step ", "data-parallel", "4 devices")):
            log(f"    {ln}")
    log(f"  ok examples/torch_elastic_remesh.py on the card in {secs:.1f} s")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU only",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import configs, kernels
    from repro_torch.kernels import _build

    t_script = time.perf_counter()
    log("== 1. environment")
    smi = smi_line()
    log(f"  {smi}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s "
        f"({'cached' if _build.BUILD_INFO['cached'] else 'nvcc'}): {_build.BUILD_INFO['path']}")
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"    {line.strip()}")

    results = {name: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0,
                          flops=0.0, max_abs_err=0.0) for name in kernels.KERNELS}
    results["gemv_gemm_gap"] = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the sweep's host-time rows and the split-mode comparison draw from their
    # own stream, so every check after them keeps the inputs it had before
    # they were added (with those inputs moved, row 8's check against its
    # plain version failed: PERF.md section 7)
    aside = torch.Generator(device="cuda").manual_seed(SEED + 1)
    log("== 2. kernels against their plain versions")
    t_phase = time.perf_counter()
    check_linears(torch, gen, results)
    check_gemv(torch, results)
    sweep_gemm(torch, gen, aside)
    sweep_gemv(torch)
    compare_split_modes(torch, aside)
    compare_attend_modes(torch, aside)
    check_decode_step(torch, gen, results)
    check_burst(torch, gen, results)
    check_paged(torch, gen, results)
    check_decode_step_proj(torch, gen, results)
    cfg = configs.get_config(ARCH)
    check_fake_quant(torch, cfg, gen, results)
    log(f"  phase 2 took {time.perf_counter() - t_phase:.1f} s")

    log(f"== 3. {cfg.name} full width, f32: kernels against plain versions")
    t_phase = time.perf_counter()
    parity_f32(torch, cfg)
    log(f"  phase 3 took {time.perf_counter() - t_phase:.1f} s")

    log(f"== 4. {cfg.name} full width, {cfg.dtype}: ServeEngine")
    t_phase = time.perf_counter()
    launches = serve_bf16(torch, cfg)
    log(f"  phase 4 took {time.perf_counter() - t_phase:.1f} s")

    log(f"== 5. {cfg.name} full width, {cfg.dtype}: paged ServeEngine")
    t_phase = time.perf_counter()
    paged = serve_paged(torch, cfg)
    for name in ("quant_kv_attention_paged", "quant_kv_decode_step_paged",
                 "quant_kv_append_paged"):
        launches[name] = paged[name]        # phase 5's paged engines (b)-(d)
    log(f"  phase 5 took {time.perf_counter() - t_phase:.1f} s")

    log(f"== 6. {cfg.name} full width, {cfg.dtype}: speculative ServeEngine from a v6 artifact")
    t_phase = time.perf_counter()
    runs, spec_gap = serve_speculative(torch, cfg, results["gemv_gemm_gap"])
    launches["quant_kv_append"] = runs["b dense, speculative"]["quant_kv_append"]
    launches["quant_kv_append_paged"] = sum(           # engines (c) and (d)'s commit replays
        r["quant_kv_append_paged"] for k, r in runs.items() if k[0] in "cd")
    log(f"  phase 6 took {time.perf_counter() - t_phase:.1f} s")

    log(f"== 7. {cfg.name} full width, {cfg.dtype}: the SigmaQuant policy search")
    t_phase = time.perf_counter()
    qat_step_parity(torch, cfg)
    search_launches = search_phase(torch, cfg)
    for name in ("fake_quant", "fake_quant_ste_bwd"):
        launches[name] = search_launches[name]
    log(f"  phase 7 (a)-(d) took {time.perf_counter() - t_phase:.1f} s")
    t_e = time.perf_counter()
    search_draft_phase(torch, cfg)
    log(f"  phase 7 (e) took {time.perf_counter() - t_e:.1f} s; phase 7 "
        f"{time.perf_counter() - t_phase:.1f} s")

    log(f"== 8. {cfg.name}: row 8 on the f32 serving path; chunked prefill and streaming")
    t_phase = time.perf_counter()
    row8 = serve_row8(torch, cfg)
    launches["quant_kv_decode_step_proj"] = row8["quant_kv_decode_step_proj"]
    admit_gap = serve_chunked(torch, cfg)
    log(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s")

    log(f"== 9. {cfg.name} full width, {cfg.dtype}: prompts above 2048 tokens")
    t_phase = time.perf_counter()
    check_flash(torch, cfg)
    serve_long(torch, cfg)
    long_loss(torch, cfg)
    log(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s")

    log(f"== 10. {cfg.name} full width, {cfg.dtype}: degradation, faults and tracing")
    t_phase = time.perf_counter()
    degradation(torch, cfg, max(spec_gap, admit_gap))
    artifact_refusal(torch, cfg)
    phase4_repeats(torch, cfg, admit_gap)
    log(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s")

    log("== 11. the paper's CNN path: resnet_wide's convs, the checkpoints, Table I's recipe")
    t_phase = time.perf_counter()
    check_cnn_fake_quant(torch, gen)
    restore_checkpoints(torch)
    table1_recipe(torch)
    log(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")

    log(f"== 12. {cfg.name}: the roofline search with --trace and --ckpt, the report, the "
        f"trainer, baselines and calibration")
    t_phase = time.perf_counter()
    roof = roofline_search(torch, cfg)
    render_phase_report(roof["artifact"])
    trained = trainer(torch, cfg)
    baselines_and_calibration(torch, cfg, roof["specs"], trained)
    log(f"  phase 12 launches: the search {_nonzero(roof['search'])}; serving the restored "
        f"checkpoint {_nonzero(roof['serve'])}; the trainer {_nonzero(trained['launches'])}")
    log(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")

    moe_cfg = configs.get_config(MOE_ARCH)
    log(f"== 13. {moe_cfg.name}: the expert kernels, full width and depth through "
        f"launch.serve, the modes at 2 layers")
    t_phase = time.perf_counter()
    check_experts(torch, gen, results)
    moe_served = serve_moe(torch, moe_cfg)
    for name in ("quant_gemv_experts", "quant_matmul_experts"):
        launches[name] = moe_served["launches"][name]
    moe_modes(torch, moe_cfg)
    log(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")

    log(f"== 14. {moe_cfg.name} cut to {MOE_TRAIN_LAYERS} layers: QAT through row 10 on the "
        f"expert stacks, launch.train, launch.search and its artifact served")
    t_phase = time.perf_counter()
    moe_qat_step(torch, moe_cfg)
    moe_train = cut_trainer(torch, MOE_TRAIN_ARGV, "phase 14 (b)")
    moe_search(torch, moe_cfg)
    log(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s")

    vlm_cfg = configs.get_config(VLM_ARCH)
    log(f"== 15. {vlm_cfg.name} full width and depth: its linears and row 3 at a group of 6, "
        f"launch.serve, M-RoPE and embeds")
    t_phase = time.perf_counter()
    check_family_linears(torch, gen, VLM_LINEARS, "phase 15 (a)", results)
    check_group_of_six(torch, gen, results)
    vlm = serve_family(torch, vlm_cfg, "phase 15 (b)", kv_state=True)
    check_mrope(torch, vlm_cfg, vlm.pop("engine"))
    torch.cuda.empty_cache()
    log(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")

    ssm_cfg = configs.get_config(SSM_ARCH)
    log(f"== 16. {ssm_cfg.name} full width and depth: its linears, launch.serve, the "
        f"recurrent engine path at {SSM_CUT_LAYERS} layers")
    t_phase = time.perf_counter()
    check_family_linears(torch, gen, SSM_LINEARS, "phase 16 (a)", results)
    ssm = serve_family(torch, ssm_cfg, "phase 16 (b)", kv_state=False)
    del ssm["engine"]
    torch.cuda.empty_cache()
    ssm_modes(torch, ssm_cfg)
    log(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")
    zamba_cfg = configs.get_config(ZAMBA_ARCH)
    log(f"== 17. {zamba_cfg.name}: its linears and rows 3 and 8 at hd 80 under the window, "
        f"launch.serve at full width and depth, the window on the card, QAT, launch.train and "
        f"launch.search at {ZAMBA_CUT_LAYERS} layers")
    t_phase = time.perf_counter()
    check_family_linears(torch, gen, ZAMBA_LINEARS, "phase 17 (a)", results)
    check_window_kernels(torch, gen, results)
    zamba = serve_family(torch, zamba_cfg, "phase 17 (b)", kv_state=True)
    del zamba["engine"]
    torch.cuda.empty_cache()
    zamba_window = serve_window(torch, zamba_cfg)
    zamba_qat_step(torch, zamba_cfg)
    zamba_train = cut_trainer(torch, ZAMBA_TRAIN_ARGV, "phase 17 (d)")
    cut_search(torch, _zamba_cut(zamba_cfg), ZAMBA_SEARCH_ARGV, ZAMBA_SEARCH_SERVE_ARGV,
               "phase 17 (d)", ("quant_gemv", "quant_kv_decode_step"))
    log(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")

    whisper_cfg = configs.get_config(WHISPER_ARCH)
    log(f"== 18. {whisper_cfg.name} full width and depth: its linears, prefill and greedy "
        f"decode through the kernels, launch.train and launch.search")
    t_phase = time.perf_counter()
    check_family_linears(torch, gen, WHISPER_LINEARS, "phase 18 (a)", results)
    whisper = whisper_decode(torch, whisper_cfg)
    whisper_train = cut_trainer(torch, WHISPER_TRAIN_ARGV, "phase 18 (c)")
    whisper_search(torch, whisper_cfg)
    log(f"  phase 18 took {time.perf_counter() - t_phase:.1f} s")
    log(f"== 19. {cfg.name}: the decode-step autotuner, the engine's replay of its table, "
        f"the refusals, the examples")
    t_phase = time.perf_counter()
    autotune_candidates(torch, cfg)
    replayed = replay_serving(torch, cfg)
    examples_on_card(torch)
    log(f"  phase 19 took {time.perf_counter() - t_phase:.1f} s")
    log(f"== 20. {cfg.name}: the multi-device layer on one card: prefill_sp through NCCL and "
        f"row 2, the dry-run, the elastic example")
    t_phase = time.perf_counter()
    sp_launches = prefill_sp_on_card(torch, cfg)
    dryrun_on_card()
    elastic_on_card()
    log(f"  phase 20 took {time.perf_counter() - t_phase:.1f} s")
    # the later main paths' launches join the earlier ones' (each read right
    # after its own run, the counts set to 0 just before it)
    for extra in (moe_train, vlm["launches"], ssm["launches"], zamba["launches"], zamba_window,
                  zamba_train, whisper, whisper_train, replayed, sp_launches):
        for name, n in extra.items():
            launches[name] += n

    log(f"== 21. summary (the script so far: {time.perf_counter() - t_script:.1f} s)")
    rows = []
    for name in kernels.KERNELS:
        r = results[name]
        b_ms, b_by = bound(r["bytes"], r["flops"], r.get("rate", BF16_FLOP_S))
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": rows}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
