#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a)
and runs five phases; any failure raises, so the exit code is nonzero and
the last line is not the ``ok`` line:

  1. environment: the card's name and power limit, torch/CUDA versions, and
     the kernels' build time;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes of gemma-2b's fused linears and decode step, with CUDA-event
     medians of the kernel, the plain version and one library call;
  3. full-width gemma-2b in f32: prefill + 8 teacher-forced decode steps
     through the kernels and again through the plain versions;
  4. serving full-width gemma-2b in bf16 (its own dtype) through
     ``ServeEngine``: 8 requests on 4 slots, with the launch counts read
     right after, while the plain versions must show no call;
  5. one ``{"kernels": [...]}`` JSON line, the card's line, and last
     ``{"ok": true, "device": {...}}``.

Weights are random, made from a seeded CUDA generator.  Nothing of JAX is
imported.  Exits 2 without a CUDA device or without the package beside it.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16 tensor-core FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12

ARCH = "gemma-2b"
SEED = 0
#: gemma-2b's fused decode linears: name -> (N, K)
LINEARS = {"wqkv": (2560, 2048), "wo": (2048, 2048), "w_gu": (32768, 2048),
           "w_down": (2048, 16384)}
GEMV_MS = (1, 4, 8)
GEMM_M = 128                      # one admission of 4 prompts padded to 32
SERVE_M = 4                       # the serving engine's decode batch (max_slots)
KV = dict(B=4, n_kv=1, g=8, hd=256, S=512, block=16)
KV_POS = (37, 200, 415, 496)      # last row of a block, first row of one, and between
KV_BITS = ((8, 8), (8, 4), (4, 4), (4, 2))
REPLACES = {
    "quant_gemv": "src/repro/kernels/quant_gemv/kernel.py:64",
    "quant_matmul": "src/repro/kernels/quant_matmul/kernel.py:68",
    "quant_kv_decode_step": "src/repro/kernels/quant_kv/kernel.py:358",
}
SOURCES = {
    "quant_gemv": "src/repro_torch/csrc/quant_gemv.cu",
    "quant_matmul": "src/repro_torch/csrc/quant_matmul.cu",
    "quant_kv_decode_step": "src/repro_torch/csrc/quant_kv_decode_step.cu",
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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) the card needs: bytes over HBM rate vs ops over bf16 peak."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOP_S * 1e3
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
            log(f"  ok {name} bits={bits}: GEMV M={GEMV_MS} and GEMM M={GEMM_M}, f32 and bf16")
            del qt, packed, scale


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
                t_k = time_ms(torch, lambda: quant_kv_decode_step_cuda(
                    pos, qg, k3, v3, lk.k_packed, lk.k_scale, lk.v_packed, lk.v_scale, mask,
                    k_bits=k_bits, v_bits=v_bits, hd=c["hd"], block=c["block"]))
                t_p = time_ms(torch, lambda: quant_kv_decode_step_ref(q, lp, pos, kn, vn, valid))
                t_l = time_ms(torch, lambda: sdpa(q4, kd, vd, attn_mask=amask))
                hdp = {b: -(-c["hd"] // LANES[b]) for b in (k_bits, v_bits)}
                npos = sum(p + 1 for p in KV_POS)
                nblk = sum(p // c["block"] + 1 for p in KV_POS)
                nbytes = c["n_kv"] * (npos * (hdp[k_bits] + hdp[v_bits]) + 8 * nblk
                                      + c["block"] * (hdp[k_bits] + hdp[v_bits]) * c["B"])
                nbytes += 2 * (q.numel() + kn.numel() + vn.numel()) + 4 * q.numel()
                flops = 4.0 * hq * c["hd"] * npos
                b_ms, b_by = bound(nbytes, flops)
                log(f"  quant_kv_decode_step k{k_bits}/v{v_bits} B={c['B']} S={c['S']} "
                    f"hd={c['hd']} g={c['g']} bf16: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
                    f"sdpa {t_l:.4f} ms  bound {b_ms:.5f} ms ({b_by})  rel {err:.2e}")
                if (k_bits, v_bits) == (8, 4):       # the serving phase's state bits
                    r.update(ms=t_k, plain_ms=t_p, library_ms=t_l, bytes=nbytes, flops=flops)
            log(f"  ok decode step k{k_bits}/v{v_bits} {dt}: cache bytes and scales exact, "
                f"rel {err:.2e}")


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
    del serve, caches, kv
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
    want = {"quant_gemv": per_linear * st["decode_steps"],
            "quant_kv_decode_step": cfg.n_layers * st["decode_steps"],
            "quant_matmul": per_linear * st["admissions"]}
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


def profile_steps(torch, eng, reqs) -> None:
    """Device time by kernel over a short rerun of ``reqs`` (4 new tokens each),
    and the device's busy share of the wall time, from ``torch.profiler``."""
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
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    log("== 2. kernels against their plain versions")
    check_linears(torch, gen, results)
    check_decode_step(torch, gen, results)

    cfg = configs.get_config(ARCH)
    log(f"== 3. {cfg.name} full width, f32: kernels against plain versions")
    parity_f32(torch, cfg)

    log(f"== 4. {cfg.name} full width, {cfg.dtype}: ServeEngine")
    launches = serve_bf16(torch, cfg)

    log("== 5. summary")
    rows = []
    for name in kernels.KERNELS:
        r = results[name]
        b_ms, b_by = bound(r["bytes"], r["flops"])
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
