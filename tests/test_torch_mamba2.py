"""Port parity of the SSM family's model (``models/mamba2.py``), on the CPU.

Twins of ``tests/test_mamba2.py`` on the port: the chunked SSD scan against
the sequential recurrence oracle (rtol / atol 2e-4), its chunk invariance,
a prefill's state continued by decode steps against the full forward, and
finite gradients.  Each ported function against its JAX twin on the same
numpy-seeded inputs and the JAX package's weights (carried by ``convert``),
f32, within rel 1e-5 (the ``_rel`` of ``tests/test_kernel_parity.py``):
``_split_proj`` and ``init_state`` exactly, ``_causal_conv``,
``_segsum_exp``, ``ssd_chunked`` (both groupings of its carried-in term),
``block_forward`` with ``lengths`` and its state, ``block_decode``,
``forward``, ``prefill`` and ``decode_step`` of reduced mamba2-2.7b, packed
and fp.  A right-padded prefill's state equals the unpadded one, as
``tests/test_kvcache.py`` holds it for the JAX package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import BitPolicy as JBitPolicy
from repro.models import mamba2 as jm
from repro.models import registry as jreg
from repro.quant import apply as japply
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BitPolicy
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import mamba2 as tm
from repro_torch.models import registry as treg
from repro_torch.quant import apply as tapply
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(2)

ARCH = "mamba2-2.7b"

_jssd = jax.jit(jm.ssd_chunked, static_argnums=(6,))
_jblock = jax.jit(jm.block_forward, static_argnums=(2,),
                  static_argnames=("qimpl", "return_state"))
_jblock_decode = jax.jit(jm.block_decode, static_argnums=(3,), static_argnames=("qimpl",))
_jprefill = jax.jit(jm.prefill, static_argnums=(1,), static_argnames=("qimpl",))
_jdecode = jax.jit(jm.decode_step, static_argnums=(1,), static_argnames=("qimpl",))


def _rel(out, ref) -> float:
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _ssd_inputs(seed, bsz, seq, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, seq, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, seq, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    b_in = (rng.standard_normal((bsz, seq, n)) * 0.5).astype(np.float32)
    c_in = (rng.standard_normal((bsz, seq, n)) * 0.5).astype(np.float32)
    d_skip = np.full(h, 0.3, np.float32)
    return x, dt, a_log, b_in, c_in, d_skip


def ssd_sequential_oracle(x, dt, a_log, b_in, c_in, d_skip):
    """h = h * exp(dt A) + dt x B^T; y = C h + D x, token by token in f64."""
    bsz, s, h, p = x.shape
    a = -np.exp(np.asarray(a_log, np.float64))
    x, dt, b_in, c_in, d_skip = (np.asarray(v, np.float64) for v in (x, dt, b_in, c_in, d_skip))
    state = np.zeros((bsz, h, p, b_in.shape[-1]))
    ys = []
    for t in range(s):
        da = np.exp(dt[:, t] * a)
        upd = dt[:, t][..., None, None] * x[:, t][..., None] * b_in[:, t][:, None, None, :]
        state = state * da[..., None, None] + upd
        ys.append(np.einsum("bhpn,bn->bhp", state, c_in[:, t]) + x[:, t] * d_skip[None, :, None])
    return np.stack(ys, axis=1), state


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("seq", [16, 32])
def test_ssd_chunked_matches_the_sequential_oracle(chunk, seq):
    ins = _ssd_inputs(seq * chunk, 2, seq, 3, 4, 5)
    y, final = tm.ssd_chunked(*(_t(a) for a in ins), chunk)
    y_ref, final_ref = ssd_sequential_oracle(*ins)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(final.numpy(), final_ref, rtol=2e-4, atol=2e-4)


def test_ssd_chunk_invariance():
    x, dt, _, b_in, c_in, _ = _ssd_inputs(1, 1, 24, 2, 4, 3)
    a_log, d = torch.zeros(2), torch.zeros(2)
    y1, _ = tm.ssd_chunked(_t(x), _t(dt), a_log, _t(b_in), _t(c_in), d, 4)
    y2, _ = tm.ssd_chunked(_t(x), _t(dt), a_log, _t(b_in), _t(c_in), d, 12)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 32, 3, 4, 5), (2, 32, 4, 8, 4), (1, 64, 8, 32, 16)],
                         ids=["n>p", "n<p", "reduced"])
def test_ssd_chunked_matches_jax(shape):
    """N > P groups the carried-in term as (C with the states) then the
    decay, N < P as (C with the decay) then the states, as ``jnp.einsum``
    picks; both within rel 1e-5."""
    bsz, seq, h, p, n = shape
    ins = _ssd_inputs(sum(shape), bsz, seq, h, p, n)
    for chunk in (8, 32):
        y, final = tm.ssd_chunked(*(_t(a) for a in ins), chunk)
        jy, jfinal = _jssd(*(jnp.asarray(a) for a in ins), chunk)
        assert _rel(y.numpy(), jy) <= 1e-5 and _rel(final.numpy(), jfinal) <= 1e-5


def test_segsum_exp_and_causal_conv_match_jax():
    rng = np.random.default_rng(2)
    da = (-np.abs(rng.standard_normal((2, 3, 16))) * 3).astype(np.float32)
    out = tm._segsum_exp(_t(da)).numpy()
    ref = np.asarray(jm._segsum_exp(jnp.asarray(da)))
    assert _rel(out, ref) <= 1e-5 and not np.triu(out[0, 0], 1).any()
    xc = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = (rng.standard_normal((4, 12)) * 0.2).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    assert _rel(tm._causal_conv(_t(xc), _t(w), _t(b)).numpy(),
                jm._causal_conv(jnp.asarray(xc), jnp.asarray(w), jnp.asarray(b))) <= 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_config(ARCH).reduced()
    tcfg = tconfigs.get_config(ARCH).reduced()
    jp = jm.init(jcfg, jax.random.key(2))
    return jcfg, tcfg, jp, _port(jp)


def test_init_split_and_state_match_jax(model):
    jcfg, tcfg, jp, tp = model
    mine = tm.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(mine)[0]}
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert flat.keys() == jflat.keys()
    for k, a in jflat.items():
        assert tuple(flat[k].shape) == a.shape and str(flat[k].dtype) == f"torch.{a.dtype}", k
    np.testing.assert_allclose(mine["layers"]["A_log"].numpy(),
                               np.asarray(jp["layers"]["A_log"]), rtol=1e-6)
    z = np.random.default_rng(0).standard_normal((2, 3, 2 * 256 + 2 * 16 + 8)).astype(np.float32)
    for a, b in zip(tm._split_proj(tcfg, _t(z)), jm._split_proj(jcfg, jnp.asarray(z))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    st, jst = tm.init_state(tcfg, 3, device="cpu"), jm.init_state(jcfg, 3)
    for k in ("conv", "ssm"):
        assert st[k].shape == jst[k].shape and not st[k].any()


def test_block_forward_and_decode_match_jax(model):
    jcfg, tcfg, jp, tp = model
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = {k: v[0] for k, v in tp["layers"].items()}
    x = (np.random.default_rng(3).standard_normal((2, 24, tcfg.d_model)) * 0.5).astype(np.float32)
    lengths = np.asarray([24, 13], np.int32)
    jy, jst = _jblock(jl, jnp.asarray(x), jcfg, qimpl="xla", return_state=True,
                      lengths=jnp.asarray(lengths))
    ty, tst = tm.block_forward(tl, _t(x), tcfg, return_state=True, lengths=_t(lengths))
    assert _rel(ty.numpy(), jy) <= 1e-5
    for k in ("conv", "ssm"):
        assert _rel(tst[k].numpy(), jst[k]) <= 1e-5
    xs = x[:, :1]
    for _ in range(3):
        jy, jst = _jblock_decode(jl, jnp.asarray(xs), jst, jcfg, qimpl="xla")
        ty, tst = tm.block_decode(tl, _t(xs), tst, tcfg)
        assert _rel(ty.numpy(), jy) <= 1e-5
        for k in ("conv", "ssm"):
            assert _rel(tst[k].numpy(), jst[k]) <= 1e-5
        xs = np.asarray(jy)


def test_block_prefill_state_matches_decode_continuation():
    """forward(x[:16])'s state then 4 decode steps == forward(x[:20])'s tail."""
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), ssm_chunk=4)
    p = {k: v[0] for k, v in tm.block_init(torch.Generator().manual_seed(2), tcfg, lead=(1,),
                                           device="cpu").items()}
    x = torch.randn((2, 20, tcfg.d_model), generator=torch.Generator().manual_seed(3)) * 0.5
    y_full = tm.block_forward(p, x, tcfg)
    _, state = tm.block_forward(p, x[:, :16], tcfg, return_state=True)
    outs = []
    for t in range(16, 20):
        y_step, state = tm.block_decode(p, x[:, t:t + 1], state, tcfg)
        outs.append(y_step[:, 0])
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(), y_full[:, 16:20].numpy(),
                               rtol=5e-3, atol=5e-3)


def test_ssd_gradients_finite():
    tcfg = tconfigs.get_config(ARCH).reduced()
    p = {k: v[0].requires_grad_() for k, v in tm.block_init(
        torch.Generator().manual_seed(4), tcfg, lead=(1,), device="cpu").items()}
    x = torch.randn((2, 64, tcfg.d_model), generator=torch.Generator().manual_seed(5))
    torch.sum(tm.block_forward(p, x, tcfg) ** 2).backward()
    # the block norm ``ln`` is applied outside block_forward: no gradient
    # (``jax.grad`` gives it zeros)
    assert p["ln"].grad is None
    for name, leaf in p.items():
        if name != "ln":
            assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), name


def test_forward_and_loss_gradients_match_jax(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    lab = rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    specs = tapply.layer_specs(tp, tcfg)
    assert {s.name.split(".")[-1] for s in specs} == {"in_proj", "out_proj", "embed", "lm_head"}
    assert [s.name for s in specs] == [s.name for s in japply.layer_specs(jp, jcfg)]
    bits = {s.name: int(rng.choice([2, 4, 8])) for s in specs}
    tpol = BitPolicy.from_bits(specs, bits)
    jpol = JBitPolicy.from_json(tpol.to_json())
    jb, tb = japply.bits_for_scan(jpol, jp, jcfg), tapply.bits_for_scan(tpol, tp, tcfg)
    jh = jax.jit(lambda p, t, b: jm.forward(p, jcfg, t, bits=b, qimpl="xla"))(
        jp, jnp.asarray(toks), jb)
    th = tm.forward(tp, tcfg, _t(toks), bits=tb)
    assert _rel(th.detach().numpy(), jh) <= 1e-5
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(lab)}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b, bb: jreg.get_api(jcfg).loss(p, jcfg, b, bits=bb)))(jp, batch, jb)
    tl, tg = value_and_grad(lambda p, b: treg.get_api(tcfg).loss(p, tcfg, b, bits=tb), tp,
                            {"tokens": _t(toks).long(), "labels": _t(lab).long()})
    assert _rel(tl, jl) <= 1e-5
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        assert _rel(b, a) <= 1e-4, jax.tree_util.keystr(path)


@pytest.fixture(scope="module")
def served(model):
    jcfg, tcfg, jp, tp = model
    policy = dryrun_policy(tapply.layer_specs(tp, tcfg), "mixed")
    jserve = japply.quantize_for_serve(jm.unstack_layers(jp, jcfg),
                                       JBitPolicy.from_json(policy.to_json()), jcfg)
    return jcfg, tcfg, jserve, _port(jserve)


@pytest.mark.parametrize("packed", (False, True), ids=["fp", "packed"])
def test_prefill_and_decode_steps_match_jax(model, served, packed):
    if packed:
        jcfg, tcfg, jsp, tsp = served
    else:
        jcfg, tcfg, jp, tp = model
        jsp, tsp = jm.unstack_layers(jp, jcfg), tm.unstack_layers(tp, tcfg)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    lengths = np.asarray([32, 19], np.int32)
    jlog, jst = _jprefill(jsp, jcfg, jnp.asarray(toks), qimpl="xla",
                          lengths=jnp.asarray(lengths))
    tlog, tst = tm.prefill(tsp, tcfg, _t(toks), lengths=_t(lengths))
    assert _rel(tlog.numpy(), jlog) <= 1e-5
    for t, j in zip(tst, jst):
        assert _rel(t["ssm"].numpy(), j["ssm"]) <= 1e-5
        assert _rel(t["conv"].numpy(), j["conv"]) <= 1e-5
    for _ in range(3):
        tok = rng.integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jst = _jdecode(jsp, jcfg, jst, jnp.asarray(tok), 0, qimpl="xla")
        tlog, tst = tm.decode_step(tsp, tcfg, tst, _t(tok), 0)
        assert _rel(tlog.numpy(), jlog) <= 1e-5


def test_padded_prefill_state_equals_the_exact_state(served):
    _, tcfg, _, tsp = served
    api = treg.get_api(tcfg)
    prompt = [3, 1, 4, 1, 5]
    _, st_pad = api.prefill(tsp, tcfg, torch.tensor([prompt + [0] * 11]),
                            lengths=torch.tensor([len(prompt)]))
    _, st_exact = api.prefill(tsp, tcfg, torch.tensor([prompt]))
    for a, b in zip(st_pad, st_exact):
        np.testing.assert_allclose(a["ssm"].numpy(), b["ssm"].numpy(), rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(a["conv"].numpy(), b["conv"].numpy(), rtol=1e-4, atol=2e-4)
    toks = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    _, st_a = api.prefill(tsp, tcfg, toks)
    _, st_b = api.prefill(tsp, tcfg, toks, lengths=torch.tensor([8]))
    for a, b in zip(st_a, st_b):
        np.testing.assert_allclose(a["ssm"].numpy(), b["ssm"].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a["conv"].numpy(), b["conv"].numpy(), rtol=1e-5, atol=1e-5)
