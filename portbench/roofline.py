"""The work a served model and its traffic need, and the chip's peaks.

The counts are of the model and the traffic, whatever implements them:
weights are counted at their policy bits (``K * N * bits / 8`` bytes and
one f32 scale an output channel), K/V at the state's bits over the valid
positions (one f32 scale a head and block of 16 positions and side), the
SSM state in f32, read and written once a token.  Flops are two a
multiply-add.  A least time is the larger of flops at the bf16 peak and
bytes at the bandwidth.

Peaks: NVIDIA H100 SXM data sheet, dense, without sparsity.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12         # HBM3 bytes/s
KV_BLOCK = 16                # positions a K/V scale covers


@dataclasses.dataclass(frozen=True)
class Linear:
    """One weight as a turn needs it: ``experts`` stacked copies of a (K, N) matrix."""
    name: str
    k: int
    n: int
    bits: int
    experts: int = 0          # 0: a dense linear; E: a stack that tokens are routed to
    uses: int = 1             # applications a token pass makes of it (a shared block)

    def weight_bytes(self) -> float:
        e = max(self.experts, 1)
        return e * self.k * self.n * self.bits / 8.0 + 4.0 * self.n


def capacity(tokens: int, m: dict) -> int:
    """Slots of each expert's buffer for a call of ``tokens`` tokens (the
    configuration's capacity factor, rounded up to a multiple of 8)."""
    c = int(tokens * m["top_k"] / m["n_experts"] * m["moe_capacity_factor"]) + 1
    return -(-c // 8) * 8


def head_dim(m: dict) -> int:
    return m["head_dim"] or m["d_model"] // m["n_heads"]


def _attn(m: dict, prefix: str, bits: dict, uses: int = 1) -> list[Linear]:
    d, hd = m["d_model"], head_dim(m)
    nq, nkv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    return [Linear(prefix + "attn.wqkv", d, nq + 2 * nkv, bits[prefix + "attn.wq"], uses=uses),
            Linear(prefix + "attn.wo", nq, d, bits[prefix + "attn.wo"], uses=uses)]


def _mlp(prefix: str, d: int, f: int, bits: dict, uses: int = 1) -> list[Linear]:
    return [Linear(prefix + "w_gu", d, 2 * f, bits[prefix + "w_gate"], uses=uses),
            Linear(prefix + "w_down", f, d, bits[prefix + "w_down"], uses=uses)]


def linears(m: dict, bits: dict) -> list[Linear]:
    """Every packed linear of a token pass, the LM head last; the MoE
    layers' expert stacks carry ``experts``.  Q/K/V and gate/up are counted
    as the fused pairs the engine runs (same bits by construction)."""
    d = m["d_model"]
    out: list[Linear] = []
    if m["family"] == "moe":
        f = m["d_ff"]
        for i in range(m["n_layers"]):
            p = f"layer{i:03d}."
            out += _attn(m, p, bits)
            out += _mlp(p + "mlp.shared.", d, m["n_shared_experts"] * f, bits)
            out += [Linear(p + "mlp.w_gate", d, f, bits[p + "mlp.w_gate"], m["n_experts"]),
                    Linear(p + "mlp.w_up", d, f, bits[p + "mlp.w_up"], m["n_experts"]),
                    Linear(p + "mlp.w_down", f, d, bits[p + "mlp.w_down"], m["n_experts"])]
    elif m["family"] == "ssm":
        din, n, h = m["ssm_expand"] * d, m["ssm_state"], m["ssm_expand"] * d // m["ssm_head_dim"]
        for i in range(m["n_layers"]):
            p = f"layer{i:03d}."
            out += [Linear(p + "in_proj", d, 2 * din + 2 * n + h, bits[p + "in_proj"]),
                    Linear(p + "out_proj", din, d, bits[p + "out_proj"])]
    else:
        raise NotImplementedError(f"no work count for family {m['family']!r}")
    out.append(Linear("lm_head", d, m["vocab_size"], bits["lm_head"]))
    return out


def attention_layers(m: dict) -> int:
    return 0 if m["family"] == "ssm" else m["n_layers"]


def ssm_layers(m: dict) -> int:
    return m["n_layers"] if m["family"] == "ssm" else 0


def kv_bytes_per_position(m: dict, k_bits: int, v_bits: int) -> float:
    """One position of one attention layer's cache, both sides, scales included."""
    hd, kv = head_dim(m), m["n_kv_heads"]
    return kv * hd * (k_bits + v_bits) / 8.0 + 2 * kv * 4.0 / KV_BLOCK


def ssm_state_bytes(m: dict) -> float:
    """One slot's recurrent state of one layer in f32: the scan state and the conv history."""
    d = m["d_model"]
    din, n = m["ssm_expand"] * d, m["ssm_state"]
    h = din // m["ssm_head_dim"]
    return 4.0 * (h * m["ssm_head_dim"] * n + (m["ssm_conv_width"] - 1) * (din + 2 * n))


def _flops_per_token(m: dict, lins: list[Linear], with_head: bool) -> float:
    total = 0.0
    for lin in lins:
        if lin.name == "lm_head" and not with_head:
            continue
        mult = m["top_k"] if lin.experts else 1
        total += 2.0 * lin.k * lin.n * mult * lin.uses
    if m["family"] == "moe":
        total += 2.0 * m["d_model"] * m["n_experts"] * m["n_layers"]       # the router
    if ssm_layers(m):
        din = m["ssm_expand"] * m["d_model"]
        # the scan: update and read-out of an (H, P, N) state, and the short conv
        total += ssm_layers(m) * (4.0 * din * m["ssm_state"]
                                  + 2.0 * m["ssm_conv_width"] * (din + 2 * m["ssm_state"]))
    return total


def _attn_flops(m: dict, attended: float) -> float:
    """QK and PV over ``attended`` (query, key) pairs summed over tokens, all attention layers."""
    if not attention_layers(m):
        return 0.0
    return 4.0 * m["n_heads"] * head_dim(m) * attended * attention_layers(m)


def _weights_bytes(lins: list[Linear], with_head: bool) -> float:
    return sum(l.weight_bytes() for l in lins if with_head or l.name != "lm_head")


def kv_bits(bits: dict, m: dict) -> tuple[int, int]:
    """The state bits of the first attention entry (the policies here are
    uniform); (0, 0) where the family has no K/V cache."""
    if not attention_layers(m):
        return 0, 0
    return bits["layer000.state.k"], bits["layer000.state.v"]


def _kv_bytes(m: dict, bits: dict) -> float:
    """One position of the cache over all attention layers."""
    if not attention_layers(m):
        return 0.0
    return kv_bytes_per_position(m, *kv_bits(bits, m)) * attention_layers(m)


def decode_work(m: dict, bits: dict, positions: list[int]) -> tuple[float, float]:
    """(flops, bytes) of one decode step: a token at each of ``positions``
    (every slot the engine steps), the LM head included."""
    lins = linears(m, bits)
    t = len(positions)
    attended = sum(p + 1 for p in positions)
    flops = t * _flops_per_token(m, lins, True) + _attn_flops(m, attended)
    nbytes = _weights_bytes(lins, True) + attended * _kv_bytes(m, bits)
    if m["family"] == "moe":
        nbytes += 4.0 * m["d_model"] * m["n_experts"] * m["n_layers"]      # the f32 router
    nbytes += 2.0 * t * ssm_state_bytes(m) * ssm_layers(m)
    return flops, nbytes


def prefill_work(m: dict, bits: dict, lengths: list[int]) -> tuple[float, float]:
    """(flops, bytes) of one admission's prefill of heads of ``lengths`` tokens
    (the valid tokens only; no LM head: the engine samples from the decode step)."""
    lins = linears(m, bits)
    t = sum(lengths)
    attended = sum(n * (n + 1) / 2.0 for n in lengths)
    flops = t * _flops_per_token(m, lins, False) + _attn_flops(m, attended)
    nbytes = _weights_bytes(lins, False) + t * _kv_bytes(m, bits)
    if m["family"] == "moe":
        nbytes += 4.0 * m["d_model"] * m["n_experts"] * m["n_layers"]
    nbytes += len(lengths) * ssm_state_bytes(m) * ssm_layers(m)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def gemm_bound(lin: Linear, rows: int) -> float:
    """Least seconds of one dense linear over ``rows`` activation rows in bf16
    (weights at their bits, x read and the output written once)."""
    flops = 2.0 * rows * lin.k * lin.n
    nbytes = lin.weight_bytes() + 2.0 * rows * (lin.k + lin.n)
    return least_seconds(flops, nbytes)


def expert_gemv_bound(lin: Linear, cap: int) -> float:
    """Least seconds of one expert stack on its ``(E, cap, K)`` buffer: every
    expert's packed weights, the buffer read and the output written once."""
    e = lin.experts
    flops = 2.0 * e * cap * lin.k * lin.n
    nbytes = lin.weight_bytes() + 2.0 * e * cap * (lin.k + lin.n)
    return least_seconds(flops, nbytes)


def kv_decode_step_bound(m: dict, bits: dict, positions: list[int]) -> float:
    """Least seconds of one attention layer's fused decode step (row 3) over
    a row at each of ``positions``: each row reads the cache's valid
    positions once, writes back the 16-position block its token's K/V lands
    in, reads its query and new K/V in bf16 and writes its output in bf16."""
    hd, hq, hk = head_dim(m), m["n_heads"], m["n_kv_heads"]
    kb, vb = kv_bits(bits, m)
    per_pos = kv_bytes_per_position(m, kb, vb)
    attended = sum(p + 1 for p in positions)
    rows = len(positions)
    nbytes = (attended + KV_BLOCK * rows) * per_pos + 2.0 * rows * hd * (2 * hq + 2 * hk)
    flops = 4.0 * hq * hd * attended
    return least_seconds(flops, nbytes)
