"""The core STE and the activation quantizer of ``repro_torch.core.quantizer``
held against ``repro.core.quantizer`` on the same seeded numpy inputs:
``fake_quant``'s forward and its STE mask bit for bit (the gradient of
``sum(fake_quant(w) * g)`` is ``g`` times the mask), ``activation_range``
and ``fake_quant_activation`` at bits 2-8, and the sigma scale mode.
Tolerance: the ``core`` family's, rel 1e-6 on float outputs (here every
float output matches exactly as well)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as jq
from repro_torch.core import quantizer as tq

BITS = (2, 3, 4, 5, 6, 7, 8)


def _w(seed: int, shape=(48, 40)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[:, 3] = 0.0                            # an all-zero channel
    w[5, 7] = 0.9                            # an outlier that sets its channel's scale
    return w


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("channel_axis", [-1, 0, None])
def test_fake_quant_forward_and_ste_mask_equal_jax(bits, channel_axis):
    w = _w(bits)
    g = np.random.default_rng(100 + bits).standard_normal(w.shape).astype(np.float32)

    def jloss(wj):
        return jnp.sum(jq.fake_quant(wj, jnp.asarray(bits), channel_axis, "max") * g)

    j_out = np.asarray(jq.fake_quant(jnp.asarray(w), jnp.asarray(bits), channel_axis, "max"))
    j_grad = np.asarray(jax.grad(jloss)(jnp.asarray(w)))

    wt = torch.from_numpy(w).requires_grad_()
    t_out = tq.fake_quant(wt, torch.tensor(bits), channel_axis, "max")
    (t_out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(t_out.detach().numpy(), j_out)
    np.testing.assert_array_equal(wt.grad.numpy() != 0, j_grad != 0)     # the mask
    np.testing.assert_array_equal(wt.grad.numpy(), j_grad)


def test_fake_quant_bf16_and_sigma_mode():
    w = _w(9)
    for dt_j, dt_t in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        j = np.asarray(jq.fake_quant(jnp.asarray(w, dt_j), jnp.asarray(4), -1, "max"),
                       np.float32)
        t = tq.fake_quant(torch.from_numpy(w).to(dt_t), 4, -1, "max").float().numpy()
        np.testing.assert_array_equal(t, j)
    js = np.asarray(jq.weight_scale(jnp.asarray(w), 6, mode="sigma", sigma_k=3.0))
    ts = tq.weight_scale(torch.from_numpy(w), 6, mode="sigma", sigma_k=3.0).numpy()
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown scale mode"):
        tq.weight_scale(torch.from_numpy(w), 4, mode="mse")


@pytest.mark.parametrize("percentile", [99.9, 99.0, 90.0])
def test_activation_range_equals_jax(percentile):
    x = np.random.default_rng(7).standard_normal((16, 250)).astype(np.float32) * 3.0
    jlo, jhi = jq.activation_range(jnp.asarray(x), percentile)
    tlo, thi = tq.activation_range(torch.from_numpy(x), percentile)
    assert tlo.dtype == thi.dtype == torch.float32
    assert float(tlo) == float(jlo) and float(thi) == float(jhi)
    # a constant batch: hi is lifted above lo by the f32 tiny
    c = np.full((4, 8), 0.25, np.float32)
    assert float(tq.activation_range(torch.from_numpy(c))[1]) == float(
        jq.activation_range(jnp.asarray(c))[1])


@pytest.mark.parametrize("bits", BITS)
def test_fake_quant_activation_equals_jax(bits):
    x = np.random.default_rng(bits).standard_normal((8, 64)).astype(np.float32)
    j = np.asarray(jq.fake_quant_activation(jnp.asarray(x), bits))
    t = tq.fake_quant_activation(torch.from_numpy(x), bits).numpy()
    np.testing.assert_array_equal(t, j)
    # calibrated constants, and the identity gradient
    j2 = np.asarray(jq.fake_quant_activation(jnp.asarray(x), bits, lo=jnp.float32(-1.5),
                                             hi=jnp.float32(2.0)))
    xt = torch.from_numpy(x).requires_grad_()
    t2 = tq.fake_quant_activation(xt, bits, lo=-1.5, hi=2.0)
    np.testing.assert_array_equal(t2.detach().numpy(), j2)
    t2.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))
