"""Port parity of row 8, the projection-fused decode step (``wqkv`` GEMV +
rotary + append + attend), and of the f32 serving path that reaches it.

The same seeded numpy inputs go through the JAX package's
``quant_kv_decode_step_proj(impl="interpret")`` (the Pallas kernel body on
the CPU) and through the port's op with ``impl="torch"``, its plain
version, at the JAX parity test's shapes; then through the JAX ``xla``
composition (``_qkv`` -> append -> attention).  The gates, the layer branch
and the serving engine (whose JAX twin takes row 8 in every decode step)
are held to the JAX package's answers too.  f32 throughout.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.packing import VALID_BITS
from repro.core.policy import BitPolicy as JBitPolicy
from repro.kernels.quant_kv import ops as jkv_ops
from repro.kvcache import cache as jcache
from repro.kvcache import paged as jpaged
from repro.models import decoder as jdecoder
from repro.models import layers as jlayers
from repro.quant import apply as japply
from repro.quant.tensor import QuantizedTensor as JQuantizedTensor
from repro.quant.tensor import quantize_tensor as jquantize_tensor
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BitPolicy
from repro_torch.kernels.quant_kv import ops as kv_ops
from repro_torch.kvcache import cache as tcache
from repro_torch.kvcache import paged as tpaged
from repro_torch.kvcache import state_layer_infos
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import layers as tlayers
from repro_torch.quant import apply as tapply
from repro_torch.quant.tensor import QuantizedTensor
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(2)

# the JAX package's parity shapes (tests/test_kernel_parity.py)
B, S, H, HQ, HD, BLOCK, D = 3, 32, 2, 4, 16, 8, 64
POS = (12, 7, 3)
THETA = 10_000.0


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _assert_same_cache(tl, jl, *, scale_rtol=0.0):
    """Packed bytes bit-exact; scales bit-exact unless ``scale_rtol`` is given
    (the interpret-mode Pallas body computes ``amax / qmax`` as a multiply by
    the reciprocal, one ulp off the IEEE division: ROADMAP queue 3)."""
    for name in ("k_packed", "v_packed"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
                                      err_msg=name)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
                                   rtol=scale_rtol, atol=0, err_msg=name)


def _inputs(w_bits, k_bits, v_bits):
    """x, the fused wqkv packed by the JAX quantizer, and a cache holding
    quantized rows below each slot's write position, in both packages."""
    rng = np.random.default_rng(w_bits * 100 + k_bits * 10 + v_bits)
    x = rng.normal(size=(B, D)).astype(np.float32)
    w = (rng.normal(size=(D, (HQ + 2 * H) * HD)) * 0.05).astype(np.float32)
    pk = rng.normal(size=(B, max(POS), H, HD)).astype(np.float32)
    pv = rng.normal(size=(B, max(POS), H, HD)).astype(np.float32)
    jw = jquantize_tensor(jnp.asarray(w), w_bits)
    lens = np.asarray(POS, np.int32)
    jl = jcache.insert_rows(jcache.init_kv_layer(B, S, H, HD, k_bits=k_bits, v_bits=v_bits,
                                                 block=BLOCK),
                            jnp.arange(B), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(lens))
    tl = tcache.insert_rows(tcache.init_kv_layer(B, S, H, HD, k_bits=k_bits, v_bits=v_bits,
                                                 block=BLOCK, device="cpu"),
                            torch.arange(B), torch.from_numpy(pk), torch.from_numpy(pv),
                            torch.from_numpy(lens))
    return x, jw, jl, tl


def _angles(pos):
    """cos/sin at each slot's position, as both packages' layers build them."""
    ang = pos[:, None].astype(np.float32) * np.asarray(jlayers.rope_freqs(HD, THETA))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _port_step(x, jw, tl, w_bits):
    pos = np.asarray(POS, np.int32)
    valid = np.arange(S)[None, :] <= pos[:, None]
    ang = torch.from_numpy(pos)[:, None].float() * tlayers.rope_freqs(HD, THETA)
    return kv_ops.quant_kv_decode_step_proj(
        torch.from_numpy(x), torch.from_numpy(np.array(jw.packed)),
        torch.from_numpy(np.array(jw.scale)), torch.cos(ang), torch.sin(ang), tl,
        torch.from_numpy(pos), torch.from_numpy(valid), w_bits=w_bits, n_heads=HQ,
        impl="torch", out_dtype=torch.float32)


class _ProjCfg:
    n_heads = HQ
    n_kv_heads = H
    resolved_head_dim = HD
    rope = "default"
    rope_theta = THETA
    qk_norm = False


# -- the op: port plain version against JAX row 8 and the xla composition -----


@pytest.mark.parametrize("kv_bits", VALID_BITS)
@pytest.mark.parametrize("w_bits", VALID_BITS)
def test_proj_step_matches_jax_row8_and_composition(w_bits, kv_bits):
    pos = np.asarray(POS, np.int32)
    valid = np.arange(S)[None, :] <= pos[:, None]
    mirror = VALID_BITS[-1 - VALID_BITS.index(kv_bits)]   # 2 <-> 8, 4 <-> 6
    for k_bits, v_bits in ((kv_bits, kv_bits), (kv_bits, mirror)):
        x, jw, jl, tl = _inputs(w_bits, k_bits, v_bits)
        cos, sin = _angles(pos)
        assert jkv_ops.can_fuse_qkv(jl, D, w_bits, "interpret")
        jo, jnew = jkv_ops.quant_kv_decode_step_proj(
            jnp.asarray(x), jw.packed, jw.scale, jnp.asarray(cos), jnp.asarray(sin), jl,
            jnp.asarray(pos), jnp.asarray(valid), w_bits=w_bits, n_heads=HQ,
            impl="interpret", out_dtype=jnp.float32)
        # the xla composition the fused kernel replaces
        q4, kn, vn = jlayers._qkv({"wqkv": jw}, jnp.asarray(x)[:, None, :], _ProjCfg(),
                                  jnp.asarray(pos)[:, None], qimpl="xla")
        jseq = jkv_ops.quant_kv_append(jl, jnp.asarray(pos), kn, vn, impl="xla")
        jo_seq = jkv_ops.quant_kv_attention(q4[:, 0], jseq, jnp.asarray(valid), impl="xla",
                                            out_dtype=jnp.float32)
        kernels.reset_counts()
        to, tl = _port_step(x, jw, tl, w_bits)
        assert to.shape == (B, HQ, HD) and to.dtype == torch.float32
        assert kernels.PLAIN_CALLS["quant_kv_decode_step_proj"] == 1
        assert sum(kernels.LAUNCHES.values()) == 0
        _assert_same_cache(tl, jnew, scale_rtol=1e-6)
        assert _rel(to.numpy(), jo) <= 1e-5
        _assert_same_cache(tl, jseq)
        assert _rel(to.numpy(), jo_seq) <= 1e-6


def test_proj_step_equals_the_port_composition():
    """On the CPU the plain version IS the unfused layer path: the plain GEMV,
    the torch rotary, the plain decode step, bit for bit."""
    x, jw, _, tl = _inputs(4, 8, 4)
    seq = tcache.init_kv_layer(B, S, H, HD, k_bits=8, v_bits=4, block=BLOCK, device="cpu")
    for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
        getattr(seq, f).copy_(getattr(tl, f))
    wq = QuantizedTensor(packed=torch.from_numpy(np.array(jw.packed)),
                         scale=torch.from_numpy(np.array(jw.scale)), bits=4,
                         shape=(D, (HQ + 2 * H) * HD))
    pos = torch.tensor(POS, dtype=torch.int32)
    q, kn, vn = tlayers._qkv({"wqkv": wq}, torch.from_numpy(x)[:, None], _ProjCfg(), pos[:, None])
    o_seq, _ = tlayers.decode_attend_one(seq, q, kn, vn, pos, _ProjCfg())
    o, tl = _port_step(x, jw, tl, 4)
    np.testing.assert_array_equal(o.numpy(), o_seq[:, 0].numpy())
    for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
        assert torch.equal(getattr(tl, f), getattr(seq, f)), f


def test_proj_step_refuses_paged_and_cuda_on_cpu():
    x, jw, _, tl = _inputs(4, 8, 8)
    pl = tpaged.init_paged_layer(8, B, S, H, HD, k_bits=8, v_bits=8, block=BLOCK, device="cpu")
    args = (torch.from_numpy(x), torch.from_numpy(np.array(jw.packed)),
            torch.from_numpy(np.array(jw.scale)), torch.ones(B, HD // 2),
            torch.zeros(B, HD // 2))
    valid = torch.ones(B, S, dtype=torch.bool)
    with pytest.raises(TypeError, match="PagedKVLayer"):
        kv_ops.quant_kv_decode_step_proj(*args, pl, torch.tensor(POS), valid, w_bits=4,
                                         n_heads=HQ, impl="torch")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kv_ops.quant_kv_decode_step_proj(*args, tl, torch.tensor(POS), valid, w_bits=4,
                                         n_heads=HQ, impl="cuda")
    assert sum(kernels.LAUNCHES.values()) == 0


# -- the gates ------------------------------------------------------------------

IMPL_PAIRS = (("cuda", "pallas"), ("torch", "xla"))


@pytest.mark.parametrize("paged", (False, True))
@pytest.mark.parametrize("timpl,jimpl", IMPL_PAIRS)
def test_can_fuse_qkv_matches_jax(timpl, jimpl, paged):
    if paged:
        jl = jpaged.init_paged_layer(8, B, S, H, HD, k_bits=8, v_bits=8, block=BLOCK)
        tl = tpaged.init_paged_layer(8, B, S, H, HD, k_bits=8, v_bits=8, block=BLOCK,
                                     device="cpu")
    else:
        jl = jcache.init_kv_layer(B, S, H, HD, k_bits=8, v_bits=8, block=BLOCK)
        tl = tcache.init_kv_layer(B, S, H, HD, k_bits=8, v_bits=8, block=BLOCK, device="cpu")
    seen = set()
    for d, w_bits in itertools.product((64, 510, 512, 520, 2048), VALID_BITS):
        want = jkv_ops.can_fuse_qkv(jl, d, w_bits, jimpl)
        assert kv_ops.can_fuse_qkv(tl, d, w_bits, timpl) == want, (d, w_bits)
        seen.add(want)
    assert seen == ({False} if paged or timpl == "torch" else {True, False})
    # "auto" resolves by the cache's device: the plain path on the CPU
    assert not kv_ops.can_fuse_qkv(tl, 64, 4, "auto")


def _gate_cfgs():
    base = jconfigs.get_config("gemma-2b").reduced()
    tbase = tconfigs.get_config("gemma-2b").reduced()
    out = []
    for d, rope, qk_norm in itertools.product((64, 512, 520, 2048), ("default", "none"),
                                              (False, True)):
        kw = dict(d_model=d, rope=rope, qk_norm=qk_norm)
        out.append((dataclasses.replace(base, **kw), dataclasses.replace(tbase, **kw)))
    return out


@pytest.mark.parametrize("timpl,jimpl", IMPL_PAIRS)
def test_can_fuse_step_proj_matches_jax(timpl, jimpl):
    jl = jcache.init_kv_layer(2, S, 1, 32, k_bits=8, v_bits=4, block=BLOCK)
    tl = tcache.init_kv_layer(2, S, 1, 32, k_bits=8, v_bits=4, block=BLOCK, device="cpu")
    jpl = jpaged.init_paged_layer(8, 2, S, 1, 32, k_bits=8, v_bits=4, block=BLOCK)
    tpl = tpaged.init_paged_layer(8, 2, S, 1, 32, k_bits=8, v_bits=4, block=BLOCK, device="cpu")
    fused = 0
    for (jcfg, tcfg), w_bits, (jdt, tdt), b, bits, paged, leaf in itertools.product(
            _gate_cfgs(), VALID_BITS, ((jnp.float32, torch.float32),
                                       (jnp.bfloat16, torch.bfloat16)),
            (1, 8, 9), (None, {"wqkv": 4}), (False, True), ("wqkv", "wq")):
        d = jcfg.d_model
        lanes = {2: 4, 4: 2, 6: 1, 8: 1}[w_bits]
        shape = (d, 8)
        jw = JQuantizedTensor(packed=jnp.zeros((8, -(-d // lanes)), jnp.int8),
                              scale=jnp.ones((1, 8)), bits=w_bits, shape=shape)
        tw = QuantizedTensor(packed=torch.zeros((8, -(-d // lanes)), dtype=torch.int8),
                             scale=torch.ones((1, 8)), bits=w_bits, shape=shape)
        jx = jnp.zeros((b, 1, d), jdt)
        tx = torch.zeros((b, 1, d), dtype=tdt)
        want = jlayers._can_fuse_step_proj({leaf: jw}, jcfg, jpl if paged else jl, bits,
                                           jimpl, jx)
        got = tlayers._can_fuse_step_proj({leaf: tw}, tcfg, tpl if paged else tl, bits,
                                          timpl, tx)
        assert got == want, (d, jcfg.rope, jcfg.qk_norm, w_bits, jdt, b, bits, paged, leaf)
        fused += got
    # the grid reaches both answers where the kernel is the impl
    assert (fused > 0) == (timpl == "cuda")


# -- the layer: the port's fused branch against JAX's (interpret) ---------------


def _serve_models(**change):
    """Reduced gemma-2b (f32, d 128, 4 heads over 1 KV head of 32, or the
    fields in ``change``) packed under the mixed policy, as JAX and port
    parameter trees."""
    jcfg = dataclasses.replace(jconfigs.get_config("gemma-2b").reduced(), **change)
    tcfg = dataclasses.replace(tconfigs.get_config("gemma-2b").reduced(), **change)
    jp = jdecoder.init(jcfg, jax.random.key(5))
    specs = tapply.layer_specs(params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"),
                               tcfg)
    policy = dryrun_policy(specs, "mixed")
    jserve = japply.quantize_for_serve(jdecoder.unstack_layers(jp, jcfg),
                                       JBitPolicy.from_json(policy.to_json()), jcfg)
    tserve = params_from_numpy(jax.tree.map(np.asarray, jserve), device="cpu")
    return jcfg, tcfg, jserve, tserve


def test_layer_fused_branch_matches_jax_interpret():
    jcfg, tcfg, jserve, tserve = _serve_models()
    hd = tcfg.resolved_head_dim
    rng = np.random.default_rng(9)
    pos = np.asarray((12, 7, 3), np.int32)
    pk = rng.normal(size=(B, max(POS), tcfg.n_kv_heads, hd)).astype(np.float32)
    pv = rng.normal(size=(B, max(POS), tcfg.n_kv_heads, hd)).astype(np.float32)
    x = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    jfused, tfused = japply.fuse_projections(jserve), tapply.fuse_projections(tserve)
    for li in range(tcfg.n_layers):            # layer 0 at 8 bits, layer 1 at 4
        jp = jfused["layers"][li]["attn"]
        tp = tfused["layers"][li]["attn"]
        jl = jcache.insert_rows(jcache.init_kv_layer(B, S, tcfg.n_kv_heads, hd, k_bits=8,
                                                     v_bits=4, block=BLOCK),
                                jnp.arange(B), jnp.asarray(pk), jnp.asarray(pv),
                                jnp.asarray(pos))
        tl = tcache.insert_rows(tcache.init_kv_layer(B, S, tcfg.n_kv_heads, hd, k_bits=8,
                                                     v_bits=4, block=BLOCK, device="cpu"),
                                torch.arange(B), torch.from_numpy(pk), torch.from_numpy(pv),
                                torch.from_numpy(pos))
        assert jlayers._can_fuse_step_proj(jp, jcfg, jl, None, "interpret", jnp.asarray(x))
        jy, jl = jlayers.attention_decode_quant(jp, jnp.asarray(x), jl, jnp.asarray(pos), jcfg,
                                                qimpl="interpret")
        kernels.reset_counts()
        to, tl = tlayers._decode_step_proj_fused(tp, torch.from_numpy(x), tl,
                                                 torch.from_numpy(pos)[:, None], tcfg,
                                                 window=0, impl="torch")
        assert kernels.PLAIN_CALLS["quant_kv_decode_step_proj"] == 1
        _assert_same_cache(tl, jl, scale_rtol=1e-6)
        ty = tlayers.qdense(tp["wo"], to.reshape(B, 1, -1))
        assert _rel(ty.numpy(), jy) <= 1e-5


# -- the engine: the port's f32 serving path against the JAX engine on row 8 --


def test_engine_streams_match_jax_row8_engine():
    """The JAX interpret engine runs row 8 in every decode step (the mixed
    policy fuses wqkv in both layers); the port's engine on the CPU runs the
    unfused plain path, as the JAX package does off the kernels.  Greedy
    streams identical.  head_dim 64: the JAX interpret GEMM that prefills
    takes N = 128 or a multiple of it, and the fused wqkv is (4 + 2) x hd."""
    jcfg, tcfg, jserve, tserve = _serve_models(head_dim=64)
    slots, seq, new = 4, 64, 6
    infos = state_layer_infos(tcfg, slots, seq)
    state = BitPolicy.from_bits(infos, {l.name: 8 if l.name.endswith(".k") else 4
                                        for l in infos})
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, tcfg.vocab_size, size=n).tolist() for n in (5, 17, 9)]
    jeng = JServeEngine(jcfg, jserve, max_slots=slots, max_seq=seq, qimpl="interpret",
                        state_bits=JBitPolicy.from_json(state.to_json()))
    want = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=new)
                     for i, p in enumerate(prompts)])
    kernels.reset_counts()
    eng = ServeEngine(tcfg, tserve, max_slots=slots, max_seq=seq, state_bits=state,
                      device="cpu")
    got = eng.run([Request(uid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)])
    assert got == want and all(len(v) == new for v in got.values())
    st = eng.stats()
    # on CPU tensors the gate is closed: the unfused plain path, no row 8
    assert st["plain_calls"]["quant_kv_decode_step_proj"] == 0
    assert st["plain_calls"]["quant_kv_decode_step"] == tcfg.n_layers * st["decode_steps"]
    assert sum(st["launches"].values()) == 0
