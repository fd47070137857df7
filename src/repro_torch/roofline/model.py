"""Three-term roofline model (port of ``repro/roofline/model.py``).

    compute    = FLOPs            / (chips x peak FLOP/s)
    memory     = HBM bytes        / (chips x HBM B/s)
    collective = collective bytes / (chips x link B/s)

The step's lower bound is max(terms) (perfect overlap) and its upper bound is
the sum (no overlap).  The port prices against :data:`H100_SXM`; the JAX
package's ``TPU_V5E`` has no twin here.  ``fraction_of_roofline`` divides by
the peak of the spec the terms were computed with (the reference divides by
``TPU_V5E.peak_flops`` whatever spec it was given; the two agree on a spec of
TPU values).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops: float       # bf16 FLOP/s per chip
    hbm_bw: float           # bytes/s per chip
    ici_bw: float           # bytes/s per link per chip


#: NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): 989 TFLOP/s bf16 on
#: the tensor cores and 3.35 TB/s of HBM3.  The link rate is NVLink 4's 450 GB/s
#: per direction (900 GB/s is both directions together); on one card the
#: collective term is zero.
H100_SXM = HwSpec(name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float            # global FLOPs (= per-device x chips)
    hbm_bytes: float        # global bytes accessed
    coll_bytes: float       # global collective bytes on the wire
    n_chips: int
    peak_flops: float       # per chip, of the spec the terms were priced on

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Best-case step time (perfect overlap of the three engines)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def fraction_of_roofline(self, model_flops: float) -> float:
        """Useful-FLOPs MFU at the roofline-bound step time."""
        if self.bound_s <= 0:
            return 0.0
        return model_flops / (self.n_chips * self.peak_flops * self.bound_s)


def roofline_terms(per_device_flops: float, per_device_bytes: float,
                   per_device_coll_bytes: float, n_chips: int,
                   hw: HwSpec = H100_SXM) -> RooflineTerms:
    """Terms from the per-device work: compute_s = per-device FLOPs / per-chip
    peak, the same as global FLOPs / (chips x peak)."""
    return RooflineTerms(
        compute_s=per_device_flops / hw.peak_flops,
        memory_s=per_device_bytes / hw.hbm_bw,
        collective_s=per_device_coll_bytes / hw.ici_bw,
        flops=per_device_flops * n_chips,
        hbm_bytes=per_device_bytes * n_chips,
        coll_bytes=per_device_coll_bytes * n_chips,
        n_chips=n_chips,
        peak_flops=hw.peak_flops)


def model_flops(cfg, shape, *, train: bool) -> float:
    """Useful model FLOPs: 6·N·D (train) / 2·N_active·D (inference) per token.

    N counts active parameters (MoE: shared + top_k routed experts); a decode
    shape processes one new token per sequence.
    """
    n_active = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def active_params(cfg) -> float:
    """Parameter count with MoE experts discounted to the activated top-k."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) + (cfg.n_heads * hd) * d
    gated = cfg.mlp in ("swiglu", "geglu")
    ffn_one = (3 if gated else 2) * d * f
    ffn = (cfg.n_shared_experts + cfg.top_k) * ffn_one if cfg.n_experts else ffn_one
    if cfg.family == "ssm":
        d_in = cfg.d_inner
        # in_proj (z, x, B, C, dt) + out_proj; conv and A/D negligible
        body = L * (d * (2 * d_in + 2 * cfg.ssm_state + cfg.ssm_nheads) + d_in * d)
    elif cfg.family == "hybrid":
        d_in = cfg.d_inner
        mamba = d * (2 * d_in + 2 * cfg.ssm_state + cfg.ssm_nheads) + d_in * d
        n_attn = L // max(cfg.attn_every, 1)
        body = L * mamba + n_attn * (attn + ffn)
    elif cfg.family in ("encdec", "audio"):
        body = (L + cfg.n_encoder_layers) * (attn + ffn) + L * attn  # + cross-attn
    else:
        body = L * (attn + ffn)
    embed = v * d * (1 if cfg.tie_embeddings else 2)
    return float(body + embed)
