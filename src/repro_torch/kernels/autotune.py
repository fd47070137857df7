"""Offline autotuner for the fused decode-step kernels (port of
``repro/kernels/autotune.py``, the same names and the same artifact schema).

The fused decode step (``kernels/quant_kv/ops.quant_kv_decode_step``) admits
several launches that are *bitwise equivalent*: the same packed levels,
scales and attention outputs, with other dispatch counts and memory traffic.
This module times them once and records the winner, so that a deployment
replays it:

* :class:`KernelKey` names a tuning point.
* :func:`enumerate_candidates` lists the bitwise-safe knobs for it.
* :func:`autotune_key` times each candidate on synthetic buffers of the
  keyed geometry and returns the winner (+ its time, for the artifact).
* :func:`autotune_state` sweeps every distinct key a deployed state policy
  induces and returns a config table for ``PolicyArtifact`` v5's
  ``kernel_configs`` field.
* :func:`set_active_configs` installs a table process-wide; the plain op
  consults :func:`lookup` on each call without a ``config``.

The knob spaces, one per impl:

* ``"torch"`` (the plain versions: the CPU, and the kernels' oracle on the
  card) is the reference's ``"xla"`` space, in the same order:
  ``place`` in {"select", "dus"} (paged: "scatter") x ``attend`` in
  {"reunpack", "substitute"}.
* ``"cuda"`` (the Hopper kernels, rows 3 and 7) has one candidate, as the
  reference's Pallas kernel does: ``{"place": "kernel", "attend":
  "cluster"}``, the launch ``kernel.attend_plan`` picks at whatever S is
  served.  Both keys are the reference's, so its ``validate_configs``
  accepts a port table.  The key carries no S, so a split chosen on the
  tuner's synthetic S could not follow the S a deployment serves.

A key whose impl is the reference's ("xla", "pallas", "interpret") is
validated and installed like any other and never matches a port call.
Only knobs pinned bit for bit to the sequential append -> attend
composition are enumerated, so a stale or mis-keyed table can cost speed
but never change a token.
"""
from __future__ import annotations

import dataclasses
import time

import torch

_FAMILIES = ("decode_step", "decode_step_paged")
#: the impls the port can time (``kernels.IMPLS`` without "auto")
PORT_IMPLS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class KernelKey:
    """Identity of one fused decode-step tuning point."""

    family: str          # "decode_step" | "decode_step_paged"
    k_bits: int
    v_bits: int
    heads: int           # KV heads
    head_dim: int
    block: int           # quantization block (tokens per scale group)
    impl: str            # resolved impl the config was timed on

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelKey":
        return cls(family=str(d["family"]), k_bits=int(d["k_bits"]),
                   v_bits=int(d["v_bits"]), heads=int(d["heads"]),
                   head_dim=int(d["head_dim"]), block=int(d["block"]),
                   impl=str(d["impl"]))

    def __post_init__(self):
        if self.family not in _FAMILIES:
            raise ValueError(f"unknown kernel family {self.family!r}")


def resolved_backend_impl(device=None) -> str:
    """The impl ``impl="auto"`` resolves to for tensors on ``device`` (None:
    the card, which must exist)."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import resolve_impl

    return resolve_impl("auto", resolve_device(device))


def enumerate_candidates(key: KernelKey) -> list[dict]:
    """Bitwise-safe candidates for one tuning point, in timing order.

    ``"torch"``: ``place`` (how the requantized touched block re-enters the
    packed cache: a full-width select over the block rows, or a per-slot
    index write; a paged pool is a scatter either way) x ``attend``
    (``"reunpack"`` unpacks the updated cache, ``"substitute"`` unpacks the
    old one and splices in the pre-pack integer levels; pack/unpack is exact
    on the clipped grid, so the levels are identical).

    ``"cuda"``: the kernels' own launch, the one candidate.
    """
    if key.impl == "torch":
        if key.family == "decode_step_paged":
            return [{"place": "scatter", "attend": "reunpack"},
                    {"place": "scatter", "attend": "substitute"}]
        return [{"place": p, "attend": a}
                for p in ("select", "dus")
                for a in ("reunpack", "substitute")]
    if key.impl == "cuda":
        return [{"place": "kernel", "attend": "cluster"}]
    raise ValueError(f"the port times impls {PORT_IMPLS}, not {key.impl!r} (a table "
                     f"tuned on it still installs; it never matches a port call)")


def _device_of(key: KernelKey) -> torch.device:
    """Where a key's candidates are timed: the card for "cuda", else the CPU."""
    return torch.device("cuda" if key.impl == "cuda" else "cpu")


def _synthetic_inputs(key: KernelKey, *, batch: int, blocks: int, device):
    """Deterministic synthetic buffers of the keyed geometry (a generator
    seeded 0), the cache warmed with one real row a slot."""
    from repro_torch.kernels.quant_kv import ops as kv_ops
    from repro_torch.kvcache import cache as kvcache
    from repro_torch.kvcache import paged as kvpaged

    b, h, hd, block = batch, key.heads, key.head_dim, key.block
    s = block * blocks
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((b, 4 * h, hd), generator=gen, device=device)
    k_new = torch.randn((b, 1, h, hd), generator=gen, device=device)
    v_new = torch.randn((b, 1, h, hd), generator=gen, device=device)
    pos = torch.full((b,), s // 2 + 1, dtype=torch.int32, device=device)
    kv_valid = torch.arange(s, device=device)[None, :] <= pos[:, None]
    if key.family == "decode_step_paged":
        layer = kvpaged.init_paged_layer(b * blocks, b, s, h, hd, k_bits=key.k_bits,
                                         v_bits=key.v_bits, block=block, device=device)
        kvpaged.with_table(layer, torch.arange(1, b * blocks + 1, dtype=torch.int32
                                               ).reshape(b, blocks))
    else:
        layer = kvcache.init_kv_layer(b, s, h, hd, k_bits=key.k_bits, v_bits=key.v_bits,
                                      block=block, device=device)
    # warm the cache with real contents so the dequantization is representative
    seed = torch.randn((b, 1, h, hd), generator=gen, device=device)
    kv_ops.quant_kv_append(layer, pos - 1, seed, seed, impl="torch")
    return q, layer, pos, k_new, v_new, kv_valid


def clone_layer(layer):
    """A copy of a dense or paged layer with its own buffers (the steps
    write the cache in place)."""
    bufs = ("k_packed", "k_scale", "v_packed", "v_scale") + (
        ("block_table",) if hasattr(layer, "block_table") else ())
    return dataclasses.replace(layer, **{f: getattr(layer, f).clone() for f in bufs})


def _time_calls(fn, repeats: int, device: torch.device) -> float:
    """Seconds a call: CUDA events around ``repeats`` back-to-back calls on
    the card, ``time.perf_counter`` on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) / repeats


def autotune_key(key: KernelKey, *, batch: int = 8, blocks: int = 8,
                 repeats: int = 20) -> dict:
    """Time every candidate for ``key``; return the winner + evidence.

    Returns ``{"key": ..., "config": ..., "micros": ..., "candidates": n}``,
    the shape stored per entry in ``PolicyArtifact.kernel_configs``.  Runs
    on the card for ``impl="cuda"``, else on the CPU.  Each candidate
    starts from a copy of the same warmed cache.
    """
    from repro_torch.kernels.quant_kv import ops as kv_ops
    from repro_torch.obs import trace as obs_trace

    dev = _device_of(key)
    tracer = obs_trace.get_tracer()
    q, layer, pos, k_new, v_new, kv_valid = _synthetic_inputs(
        key, batch=batch, blocks=blocks, device=dev)
    cands = enumerate_candidates(key)
    best_cfg, best_t = None, float("inf")
    for cfg in cands:
        lyr = clone_layer(layer)

        def call(cfg=cfg, lyr=lyr):
            return kv_ops.quant_kv_decode_step(q, lyr, pos, k_new, v_new, kv_valid,
                                               impl=key.impl, config=cfg)

        with tracer.span("autotune_compile", cat="kernel", track="kernel",
                         args={"key": key.to_dict(), "config": cfg}):
            call()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        with tracer.span("autotune_candidate", cat="kernel", track="kernel") as sp:
            t = _time_calls(call, repeats, dev)
            sp.annotate(key=key.to_dict(), config=cfg, repeats=repeats,
                        micros=round(t * 1e6, 2))
        if t < best_t:
            best_cfg, best_t = cfg, t
    tracer.instant("autotune_winner", cat="kernel", track="kernel",
                   args={"key": key.to_dict(), "config": best_cfg,
                         "micros": round(best_t * 1e6, 2)})
    return {"key": key.to_dict(), "config": best_cfg,
            "micros": round(best_t * 1e6, 2), "candidates": len(cands)}


def keys_for_state(state_bits, heads: int, head_dim: int, block: int,
                   *, paged: bool, impl: str | None = None) -> list[KernelKey]:
    """Distinct tuning points a deployed state policy induces, in first-seen
    order (``impl`` None: :func:`resolved_backend_impl`)."""
    impl = impl or resolved_backend_impl()
    family = "decode_step_paged" if paged else "decode_step"
    seen, out = set(), []
    for kb, vb in state_bits:
        key = KernelKey(family=family, k_bits=int(kb), v_bits=int(vb),
                        heads=heads, head_dim=head_dim, block=block,
                        impl=impl)
        if key not in seen:
            seen.add(key)
            out.append(key)
    return out


def autotune_state(state_bits, heads: int, head_dim: int, block: int,
                   *, paged: bool, impl: str | None = None,
                   repeats: int = 20) -> list[dict]:
    """Tune every distinct key for a state policy -> artifact-ready list."""
    return [autotune_key(k, repeats=repeats)
            for k in keys_for_state(state_bits, heads, head_dim, block,
                                    paged=paged, impl=impl)]


# -- active-config registry ---------------------------------------------------
# Installed at deploy time (ServeEngine) or after a search; consulted by the
# plain fused step on every call that passes no config.  Keyed by the
# KernelKey's fields as a plain tuple, so that lookup builds no KernelKey.

#: (family, k_bits, v_bits, heads, head_dim, block, impl) -> config
_ACTIVE: dict[tuple, dict] = {}


def set_active_configs(entries) -> None:
    """Install artifact ``kernel_configs`` entries (or ``None`` to clear)."""
    _ACTIVE.clear()
    for e in entries or ():
        _ACTIVE[dataclasses.astuple(KernelKey.from_dict(e["key"]))] = dict(e["config"])


def active_configs() -> dict[KernelKey, dict]:
    return {KernelKey(*t): cfg for t, cfg in _ACTIVE.items()}


def lookup(family: str, k_bits: int, v_bits: int, heads: int, head_dim: int,
           block: int, impl: str) -> dict | None:
    return _ACTIVE.get((family, k_bits, v_bits, heads, head_dim, block, impl))


def validate_configs(entries, *, heads: int, head_dim: int, block: int,
                     bit_pairs) -> None:
    """Refuse artifact configs whose geometry doesn't match the deployment.

    Raises ``ValueError`` naming the first mismatch; the engine wraps it in
    ``ArtifactError``.  Keys for bit pairs the deployed policy doesn't use
    are tolerated (a policy edit shouldn't invalidate the whole table), but
    a wrong ``heads``/``head_dim``/``block`` means the table was tuned for a
    different model/cache geometry and must not be replayed.
    """
    for e in entries or ():
        key = KernelKey.from_dict(e["key"])
        if (key.heads, key.head_dim, key.block) != (heads, head_dim, block):
            raise ValueError(
                f"kernel config {key} was tuned for geometry "
                f"(heads={key.heads}, head_dim={key.head_dim}, "
                f"block={key.block}) but the deployment has "
                f"(heads={heads}, head_dim={head_dim}, block={block})")
        if cfg_missing := [k for k in ("place", "attend")
                           if k not in e.get("config", {})]:
            raise ValueError(
                f"kernel config {key} is missing knobs {cfg_missing}")
    del bit_pairs  # informational only; extra keys are tolerated
