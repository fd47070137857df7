"""roofline.py's counts against counts made by hand for one layer of each configuration."""
import json

import pytest

from . import _paths  # noqa: F401
from portbench import roofline
from portbench.cell import HERE


def _conf(name):
    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    bits = json.loads((HERE / "configs" / conf["policy"]).read_text())["bits"]
    return conf["model"], bits


def test_deepseek_layer_by_hand():
    m, bits = _conf("deepseek-moe-16b")
    one = dict(m, n_layers=1)
    b = 8                                              # layer 0 of the mixed policy
    d, f, e, k, v = 2048, 1408, 64, 6, 102400
    lins = {l.name: l for l in roofline.linears(one, bits)}
    assert lins["layer000.attn.wqkv"].k == d and lins["layer000.attn.wqkv"].n == 3 * 16 * 128
    assert lins["layer000.mlp.w_gate"].experts == e
    stack = roofline.Linear("x", d, f, b, e)
    assert stack.weight_bytes() == e * d * f * b / 8 + 4 * f       # one scale a channel over E
    per_token = 2 * (d * 3 * d + d * d                 # q, k, v and o: 16 heads of 128
                     + 3 * d * 2 * f                   # the shared experts, width 2 x 1408
                     + k * 3 * d * f                   # six routed experts
                     + d * e                           # the router
                     + d * v)                          # the LM head
    positions = [99, 199]
    attended = 100 + 200
    flops, nbytes = roofline.decode_work(one, bits, positions)
    assert flops == pytest.approx(2 * per_token + 4 * 16 * 128 * attended)
    weights = ((d * 3 * d + d * d + 3 * d * 2 * f) * b / 8 + 4 * (3 * d + d + 4 * f + d)
               + 3 * (e * d * f * b / 8) + 4 * (2 * f + d)
               + d * v * 8 / 8 + 4 * v)
    kv = attended * (16 * 128 * (8 + 4) / 8 + 2 * 16 * 4 / 16)
    assert nbytes == pytest.approx(weights + kv + 4 * d * e)
    # an admission of two heads: no LM head, K/V written once a token
    flops, nbytes = roofline.prefill_work(one, bits, [10, 20])
    assert flops == pytest.approx(30 * (per_token - 2 * d * v)
                                  + 4 * 16 * 128 * (55 + 210))
    assert roofline.capacity(64, m) == 8 and roofline.capacity(128, m) == 16


def test_mamba2_layer_by_hand():
    m, bits = _conf("mamba2-2.7b")
    one = dict(m, n_layers=1, family="ssm", ssm_conv_width=4)
    b = 8
    d, din, n, h, v = 2560, 5120, 128, 80, 50288
    per_token = 2 * (d * (2 * din + 2 * n + h) + din * d          # in and out projections
                     + d * v)                                     # the LM head
    per_token += 4 * din * n + 2 * 4 * (din + 2 * n)             # the scan and the conv
    flops, nbytes = roofline.decode_work(one, bits, [9, 99])
    assert flops == pytest.approx(2 * per_token)                  # no attention
    state = 4 * (h * 64 * n + 3 * (din + 2 * n))
    assert roofline.ssm_state_bytes(one) == state
    weights = ((d * (2 * din + 2 * n + h) + din * d) * b / 8 + 4 * ((2 * din + 2 * n + h) + d)
               + d * v + 4 * v)
    assert nbytes == pytest.approx(weights + 2 * 2 * state)       # each state read and written
    flops, nbytes = roofline.prefill_work(one, bits, [10, 20])
    assert flops == pytest.approx(30 * (per_token - 2 * d * v))
    assert nbytes == pytest.approx(weights - d * v - 4 * v + 2 * state)


def test_row3_bound_by_hand():
    m, bits = _conf("deepseek-moe-16b")
    positions = [0, 99, 499]
    per_pos = 16 * 128 * (8 + 4) / 8 + 2 * 16 * 4 / 16          # K8/V4 and the block scales
    nbytes = (1 + 100 + 500 + 3 * 16) * per_pos + 3 * 128 * (2 * 2 * 16 + 2 * 2 * 16)
    assert roofline.kv_decode_step_bound(m, bits, positions) == pytest.approx(nbytes / 3.35e12)


def test_least_time_takes_the_larger_bound():
    assert roofline.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    lin = roofline.Linear("w", 2048, 2048, 4)
    rows = 4096
    assert roofline.gemm_bound(lin, rows) == pytest.approx(2 * rows * 2048 * 2048 / 989e12)
