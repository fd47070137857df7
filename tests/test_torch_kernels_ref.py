"""Port parity: the three kernels' plain PyTorch versions against the JAX ops.

The same seeded numpy inputs go through the JAX package's public dispatch
(``impl="xla"``, its jnp oracle, and ``impl="interpret"``, the Pallas kernel
body on the CPU) and through the port's dispatch on CPU tensors, which runs
the plain version (``ref.py``).  f32 throughout: only the summation order
differs, so outputs agree to rel 1e-5 and the KV cache bytes and scales
bit for bit (against ``"interpret"``, scales to one ulp: see
``_assert_same_cache``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_gemv.ops import quant_gemv as jquant_gemv
from repro.kernels.quant_kv import ops as jkv_ops
from repro.kernels.quant_matmul.ops import quant_matmul as jquant_matmul
from repro.kvcache import cache as jcache
from repro.quant.tensor import quantize_tensor as jquantize_tensor
from repro_torch import kernels
from repro_torch.kernels.quant_gemv.ops import quant_gemv
from repro_torch.kernels.quant_kv import ops as kv_ops
from repro_torch.kernels.quant_matmul.ops import quant_matmul, resolve_kernel
from repro_torch.kvcache import cache as tcache

torch.set_num_threads(2)

BITS = (2, 4, 6, 8)
JAX_IMPLS = ("xla", "interpret")


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _weights(bits, k, n, seed):
    w = (np.random.default_rng(seed).normal(size=(k, n)) * 0.05).astype(np.float32)
    qt = jquantize_tensor(jnp.asarray(w), bits)
    packed = np.array(qt.packed)                 # writable copies for torch.from_numpy
    scale = np.array(qt.scale).reshape(1, -1)
    return packed, scale


def _x(m, k, seed):
    return np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32)


# -- quant_matmul (M > 8, the GEMM) and quant_gemv (M <= 8) -------------------


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("m,k,n", [(48, 256, 128), (130, 512, 128)])
def test_quant_matmul_plain_matches_jax(m, k, n, bits, impl):
    packed, scale = _weights(bits, k, n, seed=bits * 7 + m)
    x = _x(m, k, seed=m + bits)
    ref = jquant_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale), bits, k,
                        impl=impl)
    kernels.reset_counts()
    out = quant_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                       torch.from_numpy(scale), bits, k)
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert _rel(out.numpy(), ref) <= 1e-5
    assert kernels.PLAIN_CALLS["quant_matmul"] == 1
    assert sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("m", [1, 4, 8])
def test_quant_gemv_plain_matches_jax(m, bits, impl):
    k, n = 256, 136
    packed, scale = _weights(bits, k, n, seed=100 + bits)
    x = _x(m, k, seed=m)
    ref = jquant_gemv(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale), bits, k,
                      impl=impl)
    kernels.reset_counts()
    out = quant_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                       torch.from_numpy(scale), bits, k)
    assert _rel(out.numpy(), ref) <= 1e-5
    assert kernels.PLAIN_CALLS["quant_gemv"] == 1
    direct = quant_gemv(torch.from_numpy(x), torch.from_numpy(packed),
                        torch.from_numpy(scale), bits, k, impl="torch")
    np.testing.assert_array_equal(direct.numpy(), out.numpy())


def test_resolve_kernel_keeps_the_gemv_rule():
    assert resolve_kernel("auto", 8, "cpu") == ("torch", "gemv")
    assert resolve_kernel("auto", 9, "cpu") == ("torch", "gemm")
    assert resolve_kernel("auto", 1, torch.device("cuda")) == ("cuda", "gemv")
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_kernel("xla", 4, "cpu")


# -- quant_kv_decode_step (dense) ----------------------------------------------

B, S, H, HQ, HD, BLOCK = 3, 32, 2, 4, 16, 8
LENS = (7, 15, 16)        # the first appends land at a block's last row, the next in a new block
STEPS = 3


def _kv_inputs(seed):
    rng = np.random.default_rng(seed)
    prompt_k = rng.normal(size=(B, max(LENS), H, HD)).astype(np.float32)
    prompt_v = rng.normal(size=(B, max(LENS), H, HD)).astype(np.float32)
    steps = [(rng.normal(size=(B, HQ, HD)).astype(np.float32),
              rng.normal(size=(B, 1, H, HD)).astype(np.float32) * 1.5,
              rng.normal(size=(B, 1, H, HD)).astype(np.float32))
             for _ in range(STEPS)]
    return prompt_k, prompt_v, steps


def _assert_same_cache(tl, jl, *, scale_rtol=0.0):
    """Packed bytes bit-exact; scales bit-exact unless ``scale_rtol`` is given.

    The Pallas body run in interpret mode is jitted, and XLA then computes
    ``amax / qmax`` as a multiply by the reciprocal: its scales can sit one
    ulp off the IEEE division that the jnp path and the port both do (the
    JAX package's own parity test allows the same, rtol 1e-6).
    """
    for name in ("k_packed", "v_packed"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
                                      err_msg=name)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
                                   rtol=scale_rtol, atol=0, err_msg=name)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("k_bits,v_bits", [(8, 8), (8, 4), (4, 2), (6, 4)])
def test_quant_kv_decode_step_plain_matches_jax(k_bits, v_bits, impl):
    pk, pv, steps = _kv_inputs(seed=k_bits * 10 + v_bits)
    lens = np.asarray(LENS, np.int32)
    jl = jcache.init_kv_layer(B, S, H, HD, k_bits=k_bits, v_bits=v_bits, block=BLOCK)
    jl = jcache.insert_rows(jl, jnp.arange(B), jnp.asarray(pk), jnp.asarray(pv),
                            jnp.asarray(lens))
    tl = tcache.init_kv_layer(B, S, H, HD, k_bits=k_bits, v_bits=v_bits, block=BLOCK,
                              device="cpu")
    tl = tcache.insert_rows(tl, torch.arange(B), torch.from_numpy(pk), torch.from_numpy(pv),
                            torch.from_numpy(lens))
    _assert_same_cache(tl, jl)
    kernels.reset_counts()
    for t, (q, kn, vn) in enumerate(steps):
        pos = lens + t
        valid = np.arange(S)[None, :] <= pos[:, None]
        jo, jl = jkv_ops.quant_kv_decode_step(
            jnp.asarray(q), jl, jnp.asarray(pos), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(valid), impl=impl)
        to, tl = kv_ops.quant_kv_decode_step(
            torch.from_numpy(q), tl, torch.from_numpy(pos), torch.from_numpy(kn),
            torch.from_numpy(vn), torch.from_numpy(valid))
        _assert_same_cache(tl, jl, scale_rtol=1e-6 if impl == "interpret" else 0.0)
        assert to.shape == (B, HQ, HD)
        assert _rel(to.numpy(), jo) <= 1e-5
    assert kernels.PLAIN_CALLS["quant_kv_decode_step"] == STEPS
    assert kernels.LAUNCHES["quant_kv_decode_step"] == 0


@pytest.mark.parametrize("bits", BITS)
def test_append_token_and_requantize_block_match_jax(bits):
    pk, pv, steps = _kv_inputs(seed=40 + bits)
    lens = np.asarray(LENS, np.int32)
    jl = jcache.insert_rows(jcache.init_kv_layer(B, S, H, HD, k_bits=bits, v_bits=bits,
                                                 block=BLOCK),
                            jnp.arange(B), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(lens))
    tl = tcache.insert_rows(tcache.init_kv_layer(B, S, H, HD, k_bits=bits, v_bits=bits,
                                                 block=BLOCK, device="cpu"),
                            torch.arange(B), torch.from_numpy(pk), torch.from_numpy(pv),
                            torch.from_numpy(lens))
    for t, (_, kn, vn) in enumerate(steps):
        pos = lens + t
        jl = jcache.append_token(jl, jnp.asarray(pos), jnp.asarray(kn), jnp.asarray(vn))
        tl = tcache.append_token(tl, torch.from_numpy(pos), torch.from_numpy(kn),
                                 torch.from_numpy(vn))
        _assert_same_cache(tl, jl)
    rng = np.random.default_rng(bits)
    blk = rng.normal(size=(B, H, BLOCK, HD)).astype(np.float32)
    new = rng.normal(size=(B, H, HD)).astype(np.float32)
    off = np.asarray([0, 3, BLOCK - 1], np.int32)
    jp, js = jcache.requantize_block(jnp.asarray(blk), jnp.asarray(new), jnp.asarray(off), bits)
    tp, ts = tcache.requantize_block(torch.from_numpy(blk), torch.from_numpy(new),
                                     torch.from_numpy(off), bits)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_kv_decode_step_4d_query_and_scalar_pos():
    pk, pv, steps = _kv_inputs(seed=3)
    q, kn, vn = steps[0]
    layers = []
    for _ in range(2):
        tl = tcache.init_kv_layer(B, S, H, HD, k_bits=8, v_bits=4, block=BLOCK, device="cpu")
        layers.append(tcache.insert_rows(tl, torch.arange(B), torch.from_numpy(pk),
                                         torch.from_numpy(pv), torch.full((B,), 5)))
    valid = torch.arange(S)[None, :].expand(B, S) <= 5
    o4, _ = kv_ops.quant_kv_decode_step(torch.from_numpy(q)[:, None], layers[0], 5,
                                        torch.from_numpy(kn), torch.from_numpy(vn), valid)
    o3, _ = kv_ops.quant_kv_decode_step(torch.from_numpy(q), layers[1], torch.full((B,), 5),
                                        torch.from_numpy(kn), torch.from_numpy(vn), valid)
    assert o4.shape == (B, 1, HQ, HD)
    np.testing.assert_array_equal(o4[:, 0].numpy(), o3.numpy())
    _assert_same_cache(layers[0], layers[1])


def test_place_block_writes_only_the_touched_block():
    tl = tcache.init_kv_layer(2, 16, 1, 8, k_bits=8, v_bits=8, block=4, device="cpu")
    blk = torch.full((2, 1, 4, 8), 7, dtype=torch.int8)
    sc = torch.full((2, 1, 1, 1), 0.5)
    kv_ops.place_block(tl.k_packed, tl.k_scale, blk, sc, torch.tensor([5, 12]), 4)
    got = tl.k_packed[:, 0, :, 0]
    assert got[0].tolist() == [0] * 4 + [7] * 4 + [0] * 8
    assert got[1].tolist() == [0] * 12 + [7] * 4
    np.testing.assert_array_equal(tl.k_scale[0, 0, :, 0].numpy(),
                                  np.float32([1e-12, 0.5, 1e-12, 1e-12]))


# -- dispatch: impl="cuda" on CPU tensors is an error, never a fallback --------


def test_cuda_impl_on_cpu_tensors_raises():
    packed, scale = _weights(4, 64, 16, seed=0)
    args = (torch.zeros(2, 64), torch.from_numpy(packed), torch.from_numpy(scale), 4, 64)
    for m in (2, 16):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            quant_matmul(torch.zeros(m, 64), *args[1:], impl="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        quant_gemv(*args, impl="cuda")
    tl = tcache.init_kv_layer(B, S, H, HD, k_bits=8, v_bits=8, block=BLOCK, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kv_ops.quant_kv_decode_step(torch.zeros(B, HQ, HD), tl, 0, torch.zeros(B, 1, H, HD),
                                    torch.zeros(B, 1, H, HD), torch.ones(B, S, dtype=torch.bool),
                                    impl="cuda")
    assert sum(kernels.LAUNCHES.values()) == 0
