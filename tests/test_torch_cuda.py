"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and the CUDA toolkit; without a card they skip.
Run them on one with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  They cover the edges that ``chip_smoke.py``'s
full-width shapes do not reach: ragged N, K padded inside the last byte
(the GEMV's byte-wise path), M = 9 at the GEMV/GEMM switch, 2-bit lanes,
and a decode step at a reduced head width.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.quant_gemv.ref import quant_gemv_ref
from repro_torch.kernels.quant_kv import ops as kv_ops
from repro_torch.kernels.quant_matmul.ops import quant_matmul
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
from repro_torch.kvcache import cache as tcache
from repro_torch.quant.tensor import quantize_tensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(out, ref):
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / (ref.abs().max() + 1e-12))


@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (3, 33, 17), (8, 130, 75), (9, 64, 40),
                                   (40, 37, 70)])
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_linear_kernels_match_plain(cuda, bits, m, k, n, dtype):
    g = torch.Generator(device=cuda).manual_seed(bits * 100 + m + k)
    qt = quantize_tensor(torch.randn((k, n), generator=g, device=cuda) * 0.1, bits)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    scale = qt.scale.reshape(1, -1)
    kernels.reset_counts()
    got = quant_matmul(x, qt.packed, scale, bits, k)
    ref = (quant_gemv_ref if m <= 8 else quant_matmul_ref)(x, qt.packed, scale, bits, k)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == dtype
    assert _rel(got, ref) <= (1e-5 if dtype is torch.float32 else 2e-2)
    assert kernels.LAUNCHES["quant_gemv" if m <= 8 else "quant_matmul"] == 1


@pytest.mark.parametrize("k_bits,v_bits", [(8, 8), (8, 4), (4, 2), (2, 2), (6, 4)])
def test_decode_step_kernel_matches_plain_bytes_exactly(cuda, k_bits, v_bits):
    b, s, h, hq, hd, block = 3, 64, 2, 4, 32, 8
    rng = np.random.default_rng(k_bits * 10 + v_bits)
    lens = torch.tensor([7, 8, 40], device=cuda)
    k = torch.from_numpy(rng.normal(size=(b, 40, h, hd)).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.normal(size=(b, 40, h, hd)).astype(np.float32)).to(cuda)
    base = tcache.init_kv_layer(b, s, h, hd, k_bits=k_bits, v_bits=v_bits, block=block,
                                device=cuda)
    base = tcache.insert_rows(base, torch.arange(b, device=cuda), k, v, valid_len=lens)
    layers = [dataclasses.replace(base, **{f: getattr(base, f).clone() for f in
                                           ("k_packed", "k_scale", "v_packed", "v_scale")})
              for _ in range(2)]
    for step in range(3):
        pos = (lens + step).to(torch.int32)
        valid = torch.arange(s, device=cuda)[None, :] <= pos[:, None]
        q = torch.from_numpy(rng.normal(size=(b, hq, hd)).astype(np.float32)).to(cuda)
        kn = torch.from_numpy(rng.normal(size=(b, 1, h, hd)).astype(np.float32)).to(cuda)
        vn = torch.from_numpy(rng.normal(size=(b, 1, h, hd)).astype(np.float32)).to(cuda)
        o_k, _ = kv_ops.quant_kv_decode_step(q, layers[0], pos, kn, vn, valid)
        o_p, _ = kv_ops.quant_kv_decode_step(q, layers[1], pos, kn, vn, valid, impl="torch")
        torch.cuda.synchronize()
        for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
            assert torch.equal(getattr(layers[0], f), getattr(layers[1], f)), (step, f)
        assert _rel(o_k, o_p) <= 1e-5


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    qt = quantize_tensor(torch.randn((64, 16), device=cuda), 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quant_matmul(torch.zeros((4, 64), dtype=torch.float16, device=cuda), qt.packed,
                     qt.scale, 4, 64)
    layer = tcache.init_kv_layer(1, 16, 1, 24, k_bits=8, v_bits=8, block=8, device=cuda)
    with pytest.raises(ValueError, match="hd % 16"):
        kv_ops.quant_kv_decode_step(torch.zeros((1, 2, 24), device=cuda), layer, 0,
                                    torch.zeros((1, 1, 1, 24), device=cuda),
                                    torch.zeros((1, 1, 1, 24), device=cuda),
                                    torch.ones((1, 16), dtype=torch.bool, device=cuda))
