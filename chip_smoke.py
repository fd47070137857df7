#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a)
and runs nine phases; any failure raises, so the exit code is nonzero and
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
     the quantized-KV attention split over S (rows 3, 4, 6, 7) with its
     plan's cluster against one CTA walking the same chunks, dense at S 512
     and 2048 (two rounds of 16 chunks) and paged at max_seq 1024: outputs
     and cache bytes bit-equal, both timed; rows 3, 4, 6 and 7 also with
     their device time back to back beside SDPA's;
     the fake-quant forward and STE backward at gemma-2b's ``w_gate``
     and tied embedding (per model dimension for the lookup, per vocabulary
     entry for the head), bits 2-8 and 32, f32 and bf16, bytes exact; and
     row 8, the projection-fused step, at gemma-2b's head geometry with d
     512 (B 4 and 8, a position at S), weights 2-8 bits against every state
     width: bit for bit equal to the launches it replaces (the GEMV, the
     torch rotary, the dense step), within tolerance of the plain step run
     on the GEMV's projection and, where no cache byte differs, of its plain
     version;
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
     refinement rounds, seq 64 x batch 8) with the controller's trace, the
     QAT step median, a profiled step's device-busy and fake-quant shares,
     peak memory and wall time, and fake-quant launches exactly 128 per
     forward and STE launches 128 per training step; (c) the artifact saved,
     loaded back, packed with ``quantize_for_serve(artifact)``, checked by
     ``verify_packed_bits`` and served (8 requests) by
     ``ServeEngine(artifact=)``; (d) the search once more from the same
     seed, and whether its bit vectors agree;
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
  9. one ``{"kernels": [...]}`` JSON line, the card's line, and last
     ``{"ok": true, "device": {...}}``.

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
#: phase 2's fake-quant bit-widths (32 is what pretraining passes)
FQ_BITS = (2, 4, 6, 8, 32)
#: phase 7: the search command's arguments (8-bit weights are about 2388 MiB,
#: 4-bit about 1194, so the limit forces mixed bits)
SEARCH_ARGV = ["--arch", ARCH, "--limit", "size_mib=1600", "--pretrain-steps", "8",
               "--phase2-iters", "3", "--seq", "64", "--batch", "8", "--seed", str(SEED)]
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


def time_batch(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean CUDA-event time (ms) of ``reps`` back-to-back calls of ``fn``, L2
    as the last call left it (warm).  A spin on the device ahead of them lets
    the host queue every launch first, so the device runs them without the
    gaps of the host's launch time."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e5) * reps)      # about 0.1 ms a launch at 1.8 GHz
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
                log(f"    {name:6s} bits={bits} M={m:4d}: kernel {t['kernel']:.4f} ms "
                    f"(cold {t['cold']:.4f})  torch.matmul {t['lib']:.4f} (cold "
                    f"{t['lib_cold']:.4f})  plain {t['plain']:.4f}  nt={p.nt} splits={p.splits} "
                    f"cluster={p.cluster} grid={p.grid}")
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


def compare_attend_modes(torch, gen) -> None:
    """Rows 3, 4, 6 and 7 with their plan's cluster against one CTA walking the
    same chunks (``kernel.walk_plan``): outputs, cache bytes and scales
    bit-equal, and both timed (device time of back-to-back launches, median
    of five interleaved rounds, min-max).  K 8 / V 4, bf16 q; the dense rows
    at ATTEND_MODE_S with phase 2's write positions scaled to S, the paged
    rows on PG's shuffled pool."""
    from repro_torch.kernels.quant_kv import kernel as kvk
    from repro_torch.kvcache.cache import init_kv_layer, insert_rows

    dt, kb, vb = torch.bfloat16, 8, 4
    fields = ("k_packed", "k_scale", "v_packed", "v_scale")
    cases = []
    for s in ATTEND_MODE_S:
        c = dict(KV, S=s)
        pos = torch.tensor([min(p * s // KV["S"], s - 1) for p in KV_POS], dtype=torch.int32,
                           device="cuda")
        layer = init_kv_layer(c["B"], s, c["n_kv"], c["hd"], k_bits=kb, v_bits=vb,
                              block=c["block"], device="cuda")
        rows = torch.randn((2, c["B"], s, c["n_kv"], c["hd"]), generator=gen, device="cuda")
        layer = insert_rows(layer, torch.arange(c["B"], device="cuda"), rows[0].to(dt),
                            rows[1].to(dt), valid_len=pos.long())
        cases.append(("dense", c, pos, layer, None))
    pg = _paged_layer(torch, gen, kb, vb)
    cases.append(("paged", PG, torch.tensor(PG_POS, dtype=torch.int32, device="cuda"), pg,
                  pg.block_table))
    for kind, c, pos, base, tbl in cases:
        s = c["S"]
        valid = torch.arange(s, device="cuda")[None, :] <= pos[:, None].long()
        mask = torch.where(valid, 0.0, -1e30).float()
        qg = torch.randn((c["B"], c["n_kv"], c["g"], c["hd"]), generator=gen,
                         device="cuda").to(dt)
        kn, vn = (torch.randn((c["B"], c["n_kv"], c["hd"]), generator=gen, device="cuda").to(dt)
                  for _ in range(2))
        kw = dict(k_bits=kb, v_bits=vb, hd=c["hd"], block=c["block"])
        if kind == "dense":
            rows = {"quant_kv_decode_step": lambda lay, lp: kvk.quant_kv_decode_step_cuda(
                        pos, qg, kn, vn, *(getattr(lay, f) for f in fields), mask, **kw,
                        launch=lp),
                    "quant_kv_attention": lambda lay, lp: kvk.quant_kv_attention_cuda(
                        qg, *(getattr(lay, f) for f in fields), mask, **kw, launch=lp)}
        else:
            rows = {"quant_kv_decode_step_paged":
                    lambda lay, lp: kvk.quant_kv_decode_step_paged_cuda(
                        pos, tbl, qg, kn, vn, *(getattr(lay, f) for f in fields), mask, **kw,
                        launch=lp),
                    "quant_kv_attention_paged":
                    lambda lay, lp: kvk.quant_kv_attention_paged_cuda(
                        tbl, qg, *(getattr(lay, f) for f in fields), mask, **kw, launch=lp)}
        for name, run in rows.items():
            p = kvk.attend_plan(name, s, c["block"])
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
                    times[mode].append(time_batch(torch, lambda lp=lp, lay=lays[mode]:
                                                  run(lay, lp), reps=20))
            log(f"  attention modes {name} B={c['B']} S={s} ({p.chunks} chunks of {p.chunk}) "
                f"k{kb}/v{vb} bf16, device ms: "
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
    logged.  CUDA-event medians at B 4, w 4, K 8 / V 4."""
    from repro_torch.core.packing import LANES
    from repro_torch.kernels.quant_kv import ops as kv_ops
    from repro_torch.kernels.quant_kv.kernel import quant_kv_decode_step_proj_cuda
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
                t_k = time_ms(torch, lambda: quant_kv_decode_step_proj_cuda(
                    pos, x, wq.packed, scale2, cos, sin, lk.k_packed, lk.k_scale,
                    lk.v_packed, lk.v_scale, mask, **kw))
                t_p = time_ms(torch, lambda: quant_kv_decode_step_proj_ref(
                    x, wq.packed, scale2, cos, sin, lp, pos, valid, w_bits=w_bits,
                    n_heads=hq))
                t_c = time_ms(torch, lambda: proj_composition(
                    torch, x, wq, lc, pos, valid, n_heads=hq, step="cuda"))
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
                    f"({b_by})")
                r.update(ms=t_k, plain_ms=t_p, library_ms=None, composition_ms=t_c,
                         bytes=nbytes, flops=flops, rate=F32_FLOP_S)
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


def check_fake_quant(torch, cfg, gen, results: dict) -> None:
    """Row 10 against its plain versions at gemma-2b's shapes: ``w_gate``
    (d x d_ff, one scale per output column), the tied embedding as the
    lookup fake-quantizes it (one scale per model dimension) and as the head
    does (``emb.T`` from the (V, d) storage, one scale per vocabulary entry):
    bits 2-8 and 32, f32 and bf16, forward and STE backward bytes exactly
    equal.  Times at 4 bits in bf16 (the search's dtype); the library time is
    ``torch.fake_quantize_per_channel_affine`` on the same bf16 weight, which
    multiplies by the reciprocal scale and is not bit-equal."""
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
                log(f"  fake_quant {name:12s} {tuple(shape)} bits=4 bf16: "
                    f"torch.fake_quantize_per_channel_affine {t_l:.4f} ms (not bit-equal)")
                times = {
                    "fake_quant": (time_ms(torch, lambda: fake_quant_cuda(w, scale, bits,
                                                                          rowwise=rowwise)),
                                   time_ms(torch, lambda: fake_quant_ref(w, scale, bits)),
                                   2 * n * el + 4 * scale.numel()),
                    "fake_quant_ste_bwd": (
                        time_ms(torch, lambda: fake_quant_ste_bwd_cuda(w, scale, bits, g,
                                                                       rowwise=rowwise)),
                        time_ms(torch, lambda: fake_quant_ste_bwd_ref(w, scale, bits, g)),
                        3 * n * el + 4 * scale.numel())}
                for kern, (t_k, t_p, nbytes) in times.items():
                    b_ms, b_by = bound(nbytes, 0.0)
                    log(f"  {kern:18s} {name:12s} {tuple(shape)} bits=4 bf16: kernel {t_k:.4f} ms"
                        f"  plain {t_p:.4f} ms  bound {b_ms:.4f} ms ({b_by}), "
                        f"{nbytes / t_k / 1e6:.0f} GB/s")
                    r = results[kern]
                    r["ms"] += t_k
                    r["plain_ms"] += t_p
                    r["bytes"] += nbytes
        log(f"  ok fake_quant {name} {tuple(shape)}: forward and STE backward bytes exact, "
            f"bits {FQ_BITS}, f32 and bf16")
        del w32, g32, w, g
        torch.cuda.empty_cache()
    results["fake_quant_ste_bwd"]["library_ms"] = None


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
        eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq,
                          state_bits=state_policy(cfg, slots, seq), **kw)
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
        eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq, **kw)
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
        want = spec_launches(cfg, st, eng.paged)
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
    return runs


def spec_launches(cfg, st, paged: bool) -> dict:
    """Launches a run's structure predicts: a decode step is 4 fused linears
    (GEMV) and one decode step kernel per layer; a speculative round at K
    is K such draft steps, one verify (4 GEMMs per layer, one decode step
    kernel per layer and burst position) and one burst append per layer (the
    commit's replay of the accepted positions, both sides); an admission is
    4 GEMMs per layer."""
    from repro_torch import kernels

    n = cfg.n_layers
    out = dict.fromkeys(kernels.KERNELS, 0)
    step = "quant_kv_decode_step_paged" if paged else "quant_kv_decode_step"
    append = "quant_kv_append_paged" if paged else "quant_kv_append"
    rounds = st["spec_steps"]
    plain_steps = st["decode_steps"] - rounds
    out["quant_matmul"] = 4 * n * (st["admissions"] + rounds)
    out["quant_gemv"] = 4 * n * (plain_steps + SPEC_K * rounds)
    out[step] = n * (plain_steps + (2 * SPEC_K + 1) * rounds)
    out[append] = n * rounds
    return out


def record_logits(torch, eng):
    """Wrap the engine so that the logits row behind every token it emits is
    kept on the card: the decode step's for a plain engine, the verify
    pass's for a speculative one.  The returned ``collect()`` maps them to
    ``{(uid, token index): (V,) logits}``."""
    calls, rounds = [], []
    name = "decode_verify" if eng.speculate else "decode_step"
    fn = getattr(eng.api, name)

    def keep(*args, **kw):
        out = fn(*args, **kw)
        calls.append(out[0])                                    # (B, T, V)
        return out

    def where(active):
        return {i: (eng.slots[i].req.uid, len(eng.slots[i].generated)) for i in active}

    if eng.speculate:
        spec_step = eng._spec_step

        def note_round(active, tokens_h, pos_h, k):
            at = where(active)
            out = spec_step(active, tokens_h, pos_h, k)
            rounds.append({i: (uid, start, len(out[i])) for i, (uid, start) in at.items()})
            return out

        eng._spec_step = note_round
    else:
        decode = eng._decode

        def note_step(tokens_h, pos_h):
            at = where(eng._decode_active())
            out = decode(tokens_h, pos_h)
            rounds.append({i: (uid, start, 1) for i, (uid, start) in at.items()})
            return out

        eng._decode = note_step

    def collect() -> dict:
        return {(uid, start + j): logits[i, j]
                for logits, slots in zip(calls, rounds)
                for i, (uid, start, n) in slots.items() for j in range(n)}

    eng.api = dataclasses.replace(eng.api, **{name: keep})
    return collect


def profile_steps(torch, eng, reqs) -> None:
    """Device time by kernel over a short rerun of ``reqs`` (4 new tokens each),
    and the device's busy share of the wall time, from ``torch.profiler``.
    Only device events (kernels, copies, fills) are summed: an operator's
    own entry repeats the device time of the kernels it launched."""
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
        return
    log(f"  profile of {len(short)} requests x 4 tokens: device busy {total / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms wall ({100 * total / wall_us:.1f}%); by kernel:")
    for dev, key, count in sorted(rows, reverse=True)[:10]:
        log(f"    {100 * dev / total:5.1f}%  {dev / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


# ---------------------------------------------------------------------------
# phase 7: the policy search at full width
# ---------------------------------------------------------------------------


def _fq_per_forward(cfg, specs) -> int:
    """Fake-quant launches one forward pass makes: one per quantizable weight,
    and the tied embedding twice (the lookup and the head)."""
    return len(specs) + (1 if cfg.tie_embeddings and "embed" in {l.name for l in specs} else 0)


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
    runs = {}
    for key, impl in (("kernels", "auto"), ("plain", "torch"), ("kernels again", "auto")):
        kernels.reset_counts()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(
            lambda p, b, bb, impl=impl: api.loss(p, cfg, b, bits=bb, impl=impl), params, batch,
            bits)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = (per_fwd, per_fwd) if impl == "auto" else (0, 0)
        got = (kernels.LAUNCHES["fake_quant"], kernels.LAUNCHES["fake_quant_ste_bwd"])
        plain = (kernels.PLAIN_CALLS["fake_quant"], kernels.PLAIN_CALLS["fake_quant_ste_bwd"])
        if got != want or plain != ((0, 0) if impl == "auto" else (per_fwd, per_fwd)):
            raise AssertionError(f"phase 7 (a) {key}: launches {got}, plain calls {plain}")
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


def search_run(torch, cfg, *, profile: bool):
    """Phase 7 (b) (and (d)): ``launch.search.run`` from the search command's
    arguments, counts set to 0 just before and read just after."""
    from repro_torch import kernels
    from repro_torch.launch import search

    args = search.build_parser().parse_args(SEARCH_ARGV)
    record = {"steps": [], "profile_at": args.pretrain_steps + 1 if profile else -1}
    qat, make, wrapped = _step_hook(torch, record)
    qat.make_lm_qat_step = wrapped
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        t0 = time.perf_counter()
        artifact, result, env = search.run(args, log=lambda m: log("    " + m))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        qat.make_lm_qat_step = make
    launches, plain = dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)
    per_fwd = _fq_per_forward(cfg, env.layer_infos())
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(fake_quant=per_fwd * (env.train_steps + env.eval_passes),
                fake_quant_ste_bwd=per_fwd * env.train_steps)
    if launches != want or any(plain.values()):
        raise AssertionError(f"phase 7 search: launches {launches} (the run's {env.train_steps} "
                             f"training steps and {env.eval_passes} evaluations predict {want}), "
                             f"plain calls {plain}")
    if len(record["steps"]) != env.train_steps:
        raise AssertionError(f"{len(record['steps'])} timed steps for {env.train_steps}")
    info = dict(wall=wall, peak=torch.cuda.max_memory_allocated(), launches=launches,
                steps=record["steps"], pretrain=args.pretrain_steps,
                profile=record.get("profile"))
    return artifact, result, env, info


def search_phase(torch, cfg) -> dict:
    """Phase 7 (b)-(d).  Returns the main path's (b) launch counts."""
    from repro_torch import kernels
    from repro_torch.core.policy import PolicyArtifact
    from repro_torch.models import decoder
    from repro_torch.quant import apply as qapply
    from repro_torch.quant.tensor import QuantizedTensor
    from repro_torch.serve.engine import Request, ServeEngine

    artifact, result, env, info = search_run(torch, cfg, profile=True)
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
        f"{per_fwd} fake-quant, as predicted; plain calls 0")
    bits_b = [e.bits for e in r.trace]

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
    slots, seq, new, n_req = 4, 512, 16, 8
    # the state phase is not ported: the deployment adds phase 4's K 8 / V 4 state
    deploy = dataclasses.replace(art, state_policy=state_policy(cfg, slots, seq))
    eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq, artifact=deploy)
    del serve
    gen = torch.Generator().manual_seed(SEED + 9)
    lens = torch.randint(8, 25, (n_req,), generator=gen).tolist()
    reqs = [Request(uid=i, prompt=torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist(),
                    max_new_tokens=new) for i, n in enumerate(lens)]
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
        f"verify_packed_bits passed; served {n_req} requests x {new} tokens on {slots} slots: "
        f"{st['decode_steps']} decode steps, {st['admissions']} admissions, median step "
        f"{st['decode_step_median_s'] * 1e3:.3f} ms ({packed} packed linears a step)")
    log(f"    launches {st['launches']}")
    del eng
    torch.cuda.empty_cache()

    # (d) the same search again: do its decisions repeat?
    _, r2, env2, info2 = search_run(torch, cfg, profile=False)
    del env2
    torch.cuda.empty_cache()
    bits_d = [e.bits for e in r2.trace]
    parted = [i for i, (x, y) in enumerate(zip(bits_b, bits_d)) if x != y]
    same = bits_d == bits_b and r2.policy.bits == r.policy.bits
    log(f"  (d) second search from seed {SEED}: {len(bits_d)} controller entries, wall "
        f"{info2['wall']:.2f} s; bit vectors {'agree at every entry and in the final policy' if same else 'part at entries %s' % parted}; "
        f"acc {r2.acc:.6f} vs {r.acc:.6f}")
    return info["launches"]


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
        eng = ServeEngine(cfg512, serve, max_slots=slots, max_seq=seq,
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


def serve_chunked(torch, cfg) -> dict:
    """Phase 8 (b) and (c): the long x short burst through whole-prompt and
    chunked admission, dense and paged; engine (c) streams its tokens."""
    from repro_torch import kernels
    from repro_torch.serve.engine import ServeEngine

    slots, seq, new = 4, 2048, 16
    serve, _ = packed_model(torch, cfg, SEED + 12)
    reqs = burst_requests(torch, cfg, new)
    state = state_policy(cfg, slots, seq)
    log(f"  {len(reqs)} requests submitted at once, prompts {list(BURST_LENS)} tokens, {new} new "
        f"each, {slots} slots, max_seq {seq}, K 8 / V 4 state")
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
        eng = ServeEngine(cfg, serve, max_slots=slots, max_seq=seq, state_bits=state, **kw)
        collect = record_logits(torch, eng) if key[0] in "ac" else None
        polled = []
        if key[0] == "c":
            for r in reqs:
                eng.submit(r, on_token=lambda uid, tok: streamed.setdefault(uid, []).append(tok))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        t0 = time.perf_counter()
        if key[0] == "c":
            out = eng.run(step_hook=lambda e, step: polled.extend(e.poll()))
        else:
            out = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        polled.extend(eng.poll())
        st = eng.stats()
        if sorted(out) != list(range(len(reqs))) or any(len(v) != new for v in out.values()):
            raise AssertionError(f"{key}: incomplete streams {[len(v) for v in out.values()]}")
        if any(st["plain_calls"].values()):
            raise AssertionError(f"{key}: plain calls {st['plain_calls']}")
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
        if key[0] == "c":
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
    parted = 0
    for uid in sorted(a):
        t = next((i for i, (x, y) in enumerate(zip(a[uid], c[uid])) if x != y), None)
        if t is None:
            continue
        parted += 1
        xa, xc = a[uid][t], c[uid][t]
        la, lc = rows["a"][(uid, t)].float(), rows["c"][(uid, t)].float()
        m_a, m_c = float(la[xa] - la[xc]), float(lc[xc] - lc[xa])
        log(f"    stream {uid}: chunked leaves whole-prompt at token {t} ({xa} -> {xc}): "
            f"whole prefers {xa} by {m_a:.4g}, chunked prefers {xc} by {m_c:.4g}, pair moved "
            f"{m_a + m_c:.4g}")
        if m_a < 0 or m_c < 0 or not m_a + m_c <= 2 * gap:
            raise AssertionError(f"stream {uid} parts at token {t}: the pair moved "
                                 f"{m_a + m_c:.4g} > 2 x {gap:.4g}, not a near-tie")
    log(f"  ok streams (b) = (a), (d) = (c); chunked = whole-prompt in {len(a) - parted} of "
        f"{len(a)} streams ({parted} parted, each at a near-tie)")
    del serve
    torch.cuda.empty_cache()
    return {"parted": parted}


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

    results = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0,
                          max_abs_err=0.0) for name in kernels.KERNELS}
    results["gemv_gemm_gap"] = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the sweep's host-time rows and the split-mode comparison draw from their
    # own stream, so every check after them keeps the inputs it had before
    # they were added (with those inputs moved, row 8's check against its
    # plain version failed: PERF.md section 7)
    aside = torch.Generator(device="cuda").manual_seed(SEED + 1)
    log("== 2. kernels against their plain versions")
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

    log(f"== 3. {cfg.name} full width, f32: kernels against plain versions")
    parity_f32(torch, cfg)

    log(f"== 4. {cfg.name} full width, {cfg.dtype}: ServeEngine")
    launches = serve_bf16(torch, cfg)

    log(f"== 5. {cfg.name} full width, {cfg.dtype}: paged ServeEngine")
    paged = serve_paged(torch, cfg)
    for name in ("quant_kv_attention_paged", "quant_kv_decode_step_paged",
                 "quant_kv_append_paged"):
        launches[name] = paged[name]        # phase 5's paged engines (b)-(d)

    log(f"== 6. {cfg.name} full width, {cfg.dtype}: speculative ServeEngine from a v6 artifact")
    t_phase = time.perf_counter()
    runs = serve_speculative(torch, cfg, results["gemv_gemm_gap"])
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
    log(f"  phase 7 took {time.perf_counter() - t_phase:.1f} s")

    log(f"== 8. {cfg.name}: row 8 on the f32 serving path; chunked prefill and streaming")
    t_phase = time.perf_counter()
    row8 = serve_row8(torch, cfg)
    launches["quant_kv_decode_step_proj"] = row8["quant_kv_decode_step_proj"]
    serve_chunked(torch, cfg)
    log(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s")

    log("== 9. summary")
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
