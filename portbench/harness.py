"""One run of one cell: set-up, the measured window, the metrics, the check.

``run_cell`` builds the program from the seed (weights made on the device,
packed under the configuration's policy file), drives it through the closed
loop, reads the end-to-end metrics from the client's record (``--trace 0``)
or the per-layer metrics from the engine's spans and the device trace
(``--trace 1``), frees the program and hands what it served to
``check.py``.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib.util
import time

import torch

from . import check as check_mod
from . import batches as batches_mod
from . import profile, stats, weights
from .cell import HERE, ROOT, Cell
from .serve import ClosedLoop, Record
from .traffic import Traffic

#: seconds at the end of a traced run's window that the device trace covers
PROFILE_SECONDS = 6.0
OUT_DIR = ROOT / "build" / "portbench"


def model_config(config: dict):
    """The program's ``ArchConfig``: the registry's entry for the
    configuration's ``arch`` with every size the file states."""
    from repro_torch.configs import get_config

    base = get_config(config["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    return dataclasses.replace(base, **{k: v for k, v in config["model"].items() if k in fields})


@dataclasses.dataclass
class Served:
    """What the program did, for the metrics and the check."""
    seed: int
    model: dict                      # the configuration's sizes, as a dict
    bits: dict
    rec: Record
    batches: batches_mod.Batches
    lifecycles: dict
    spans: list
    trace: profile.DeviceTrace | None
    plain_calls: int
    setup_s: float
    memory_peak: int
    pack_peak: int
    setup_parts: dict


def serve(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, *,
          device: str = "cuda", cfg_hook=None, window_turns: int | None = None) -> Served:
    """Build the program from the seed and drive it through the cell's loop
    (``window_turns``: close the window after that many turns, not seconds)."""
    from repro_torch import kernels
    from repro_torch.core.policy import BitPolicy
    from repro_torch.models import registry
    from repro_torch.obs import trace as obs_trace
    from repro_torch.quant import apply as qapply
    from repro_torch.serve.engine import ServeEngine

    cuda = torch.device(device).type == "cuda"
    cfg = model_config(cell.config)
    if cfg_hook is not None:
        cfg = cfg_hook(cfg)
    policy = BitPolicy.from_json(cell.policy_json)
    skeleton = registry.get_api(cfg).init(cfg, torch.Generator(), device="meta")
    marks = {"start": time.perf_counter()}
    params = weights.fill(skeleton, seed, device)
    if cuda:
        torch.cuda.synchronize()
    marks["weights"] = time.perf_counter()
    missing = [s.name for s in qapply.layer_specs(params, cfg) if s.name not in policy.bits]
    if missing:
        raise ValueError(f"the policy file has no bits for {missing[:4]}")
    packed = qapply.pack_for_serve(params, policy, cfg)
    del params, skeleton
    pack_peak = 0
    if cuda:
        torch.cuda.synchronize()
        pack_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks["packed"] = time.perf_counter()
    mix = cell.mix
    eng = ServeEngine(cfg, packed, max_slots=int(mix["slots"]), max_seq=int(mix["max_seq"]),
                      prefill_pad=int(cell.config["engine"]["prefill_pad"]),
                      state_bits=policy if policy.state_layers() else None, device=device)
    del packed
    marks["engine"] = time.perf_counter()
    kernels.reset_counts()
    capture = profile.Capture(OUT_DIR) if (trace and cuda) else None
    tracer = obs_trace.get_tracer()
    if trace:
        obs_trace.enable()
    loop = ClosedLoop(eng, Traffic(mix, seed, cfg.vocab_size), mix, seconds, capture=capture,
                      profile_seconds=PROFILE_SECONDS if capture is not None else 0.0,
                      window_turns=window_turns)
    recorder = batches_mod.Recorder(lambda: loop.turn)
    recorder.install(eng)
    # what set-up made stays: the collector's later passes skip it
    gc.collect()
    gc.freeze()
    rec = loop.run()
    gc.unfreeze()
    if cuda:
        torch.cuda.synchronize()
    spans = tracer.events() if trace else []
    obs_trace.disable()
    tracer.clear()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    dtrace = capture.read() if capture is not None and capture.t0 is not None else None
    batches = batches_mod.assign(recorder.calls, rec)
    del recorder
    out = Served(seed=seed, model=dataclasses.asdict(cfg), bits=dict(policy.bits), rec=rec,
                 batches=batches, lifecycles=dict(eng.lifecycles), spans=spans, trace=dtrace,
                 plain_calls=sum(kernels.PLAIN_CALLS.values()) if cuda else 0,
                 setup_s=rec.t_open - t_start,
                 memory_peak=memory_peak, pack_peak=pack_peak,
                 setup_parts={"imports": marks["start"] - t_start,
                              "weights": marks["weights"] - marks["start"],
                              "pack": marks["packed"] - marks["weights"],
                              "engine": marks["engine"] - marks["packed"],
                              "clients_join": rec.t_open - marks["engine"]})
    del eng, loop
    gc.collect()                     # the engine and the loop's callbacks hold each other
    if cuda:
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# end-to-end metrics: the client's record, all the work over all the time
# ---------------------------------------------------------------------------


def window_samples(s: Served) -> dict:
    """Tokens, TTFTs and inter-token gaps of the window."""
    rec = s.rec
    lo, hi = rec.t_open, rec.t_close

    def inside(t):
        return lo <= t < hi

    n_tokens = sum(1 for ts in rec.token_t.values() for t in ts if inside(t))
    ttft, sent = [], []
    for uid, t in rec.sent_t.items():
        if not inside(t):
            continue
        sent.append(uid)
        lc = s.lifecycles[uid]
        first = lc.first_token_t
        if first is None or first > rec.t_close_mono:
            ttft.append(rec.t_close_mono - lc.enqueued_t)   # still waiting: its age then
        else:
            ttft.append(first - lc.enqueued_t)
    itl = [b - a for ts in rec.token_t.values() for a, b in zip(ts, ts[1:])
           if inside(a) and inside(b)]
    return {"tokens": n_tokens, "seconds": hi - lo, "ttft": ttft, "itl": itl, "sent": sent}


def end_to_end(s: Served, wanted: list[dict]) -> dict:
    w = window_samples(s)
    values = {
        "output_tok_s": lambda: stats.rate(w["tokens"], w["seconds"]),
        "ttft_p95_ms": lambda: 1e3 * stats.percentile(w["ttft"], 95),
        "itl_p95_ms": lambda: 1e3 * stats.percentile(w["itl"], 95),
        "setup_s": lambda: s.setup_s,
    }
    out = {}
    for m in wanted:
        if m["name"] not in values:
            raise KeyError(f"no reading for end-to-end metric {m['name']!r}")
        out[m["name"]] = {"value": float(values[m["name"]]()), "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# per-layer metrics: one reader a metric, under metrics/<name>.py
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Context:
    """What a per-layer reader may read."""
    model: dict
    bits: dict
    rec: Record
    batches: batches_mod.Batches
    spans: list            # the engine tracer's events, (ph, name, cat, track, ts, dur, args)
    trace: profile.DeviceTrace | None
    span_turns: range      # turns the span metrics read: the window before the device trace
    trace_turns: range     # turns the device trace covers: the window's last ones
    slots: int
    window: dict           # ``window_samples``: the window's tokens, TTFTs and gaps

    def turn_of(self, t: float) -> int:
        """The loop turn a host time falls in."""
        return bisect.bisect_right(self.rec.turn_t, t) - 1

    def phase_spans(self, name: str, turns: range) -> list[tuple[int, float]]:
        """(turn, seconds) of each engine phase span ``name`` in ``turns``."""
        out = []
        for ph, n, cat, _track, ts, dur, _args in self.spans:
            if ph == "X" and n == name and cat in ("phase", "step"):
                turn = self.turn_of(ts + 0.5 * dur)
                if turn in turns:
                    out.append((turn, dur))
        return out


def context(s: Served, slots: int) -> Context:
    rec = s.rec
    split = rec.turn_profile if s.trace is not None else rec.turn_close
    return Context(model=s.model, bits=s.bits, rec=rec, batches=s.batches, spans=s.spans,
                   trace=s.trace, span_turns=range(rec.turn_open, split),
                   trace_turns=range(split, rec.turn_close), slots=slots,
                   window=window_samples(s))


def load_reader(name: str):
    """``metrics/<name>.py``, loaded from its file (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer(ctx: Context, wanted: list[dict]) -> dict:
    out = {}
    for m in wanted:
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(ctx: Context) -> dict | None:
    """The device ops that took most time, and the idle stretches by the
    engine phase the host was in, over the traced turns."""
    tr = ctx.trace
    if tr is None:
        return None
    by_op: dict[str, float] = {}
    for name, s0, s1 in tr.ops:
        by_op[name] = by_op.get(name, 0.0) + (s1 - s0)
    phases = sorted((ts, ts + dur, n) for ph, n, cat, _t, ts, dur, _a in ctx.spans
                    if ph == "X" and cat == "phase" and n != "hook")
    by_phase: dict[str, float] = {}
    starts = [p[0] for p in phases]
    for g0, g1 in stats.gaps([(a, b) for _, a, b in tr.ops], tr.t0, tr.t1):
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        name = phases[i][2] if i >= 0 and phases[i][1] >= mid else "between phases"
        if not tr.aligned:
            name = "unaligned clock"
        by_phase[name] = by_phase.get(name, 0.0) + (g1 - g0)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_phase.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v] for n, v in top], "idle_gaps": [[n, v] for n, v in idle]}


def device_block(s: Served, kind: str) -> dict:
    out = {"platform": "gpu", "kind": kind, "count": 1, "memory_peak_bytes": int(s.memory_peak)}
    if s.trace is not None:
        tr = s.trace
        out["busy_s"] = stats.busy_seconds([(a, b) for _, a, b in tr.ops], tr.t0, tr.t1)
        out["window_s"] = tr.t1 - tr.t0
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, *,
             device: str = "cuda", kind: str = "", cfg_hook=None,
             window_turns: int | None = None) -> tuple[dict, list[str]]:
    """The result line and the lines for standard error of one run."""
    served = serve(cell, seed, seconds, trace, t_start, device=device, cfg_hook=cfg_hook,
                   window_turns=window_turns)
    w = window_samples(served)
    slots = int(cell.mix["slots"])
    if (trace and torch.device(device).type == "cuda"
            and (served.trace is None or not served.trace.ops)):
        raise RuntimeError("the profiler saw no device time in the traced turns")
    if trace:
        ctx = context(served, slots)
        metrics = per_layer(ctx, cell.per_layer)
        extra = {"breakdown": breakdown(ctx)} if served.trace is not None else {}
    else:
        metrics = end_to_end(served, cell.end_to_end)
        extra = {}
    t_check = time.perf_counter()
    checks, info = check_mod.check(cell, served, device=device)
    checks["plain_calls"] = {"value": served.plain_calls, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    failed = sum(1 for u in w["sent"] if served.lifecycles[u].state.value in
                 ("failed", "timed_out"))
    result = {"correct": bool(correct), "attempted": len(w["sent"]), "failed": failed,
              "metrics": metrics, "device": device_block(served, kind), **extra,
              "checks": checks}
    notes = [f"window {w['seconds']:.3f} s, {w['tokens']} tokens, {len(w['sent'])} requests sent, "
             f"{len(served.rec.finished())} finished in the run, "
             f"{len(served.batches.decodes)} decode steps and "
             f"{len(served.batches.admissions)} admissions recorded, "
             f"check {time.perf_counter() - t_check:.1f} s, "
             f"packing peak {served.pack_peak} B",
             "set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in served.setup_parts.items()),
             "reference readings not compared: " + ", ".join(f"{k} {v}" for k, v in info.items())]
    if served.trace is not None:
        tr = served.trace
        notes.append(f"device trace: turns {ctx.trace_turns.start}-{ctx.trace_turns.stop - 1}, "
                     f"{len(tr.ops)} device ops, {tr.launches} launch calls, "
                     f"{'host clock' if tr.aligned else 'its own clock (no alignment)'}")
    notes += [f"{k}: {v['value']} (limit {v['limit']})" for k, v in checks.items()]
    return result, notes
