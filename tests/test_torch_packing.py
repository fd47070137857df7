"""Port parity, bit-exact: packing, quantizer, quantize_for_serve, configs, policies.

The same seeded numpy inputs go through the JAX package (the reference) and
``repro_torch``; packed bytes, levels and scales must match bit for bit.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import packing as jpacking
from repro.core.policy import BitPolicy as JBitPolicy
from repro.models import decoder as jdecoder
from repro.quant import apply as japply
from repro.quant.tensor import QuantizedTensor as JQT
from repro.quant.tensor import quantize_tensor as jquantize_tensor
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import packing as tpacking
from repro_torch.core.policy import BitPolicy as TBitPolicy
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import decoder as tdecoder
from repro_torch.quant import apply as tapply
from repro_torch.quant.tensor import QuantizedTensor as TQT
from repro_torch.quant.tensor import quantize_tensor as tquantize_tensor

torch.set_num_threads(2)

BITS = (2, 4, 6, 8)


def _levels(bits, shape, seed):
    q = 2 ** (bits - 1) - 1
    return np.random.default_rng(seed).integers(-q, q + 1, size=shape).astype(np.int32)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(13,), (5, 7), (2, 3, 11), (4, 1, 2, 16)])
def test_pack_unpack_bytes_match_jax(bits, shape):
    lev = _levels(bits, shape, seed=bits * 31 + len(shape))
    jp = np.asarray(jpacking.pack(jnp.asarray(lev), bits))
    tp = tpacking.pack(torch.from_numpy(lev), bits)
    assert tp.dtype == torch.int8
    np.testing.assert_array_equal(tp.numpy(), jp)
    k = shape[-1]
    np.testing.assert_array_equal(tpacking.unpack(tp, bits, k).numpy(), lev)
    np.testing.assert_array_equal(
        tpacking.unpack(tp, bits, k).numpy(), np.asarray(jpacking.unpack(jnp.asarray(jp), bits, k)))
    assert tpacking.container_bytes(shape, bits) == jpacking.container_bytes(shape, bits)


@pytest.mark.parametrize("bits", BITS)
def test_concat_rows_matches_jax(bits):
    parts = [_levels(bits, (n, 9), seed=n) for n in (3, 5, 2)]
    jp = [jpacking.pack(jnp.asarray(p), bits) for p in parts]
    tp = [tpacking.pack(torch.from_numpy(p), bits) for p in parts]
    np.testing.assert_array_equal(tpacking.concat_rows(tp, bits).numpy(),
                                  np.asarray(jpacking.concat_rows(jp, bits)))
    with pytest.raises(ValueError, match="equal packed-K"):
        tpacking.concat_rows([tp[0], tpacking.pack(torch.zeros(2, 40, dtype=torch.int32), bits)],
                             bits)


def test_check_bits_rejects_off_grid_widths():
    for bad in (0, 3, 5, 16):
        with pytest.raises(ValueError, match="bits must be one of"):
            tpacking.check_bits(bad)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(37, 24), (64, 33)])
def test_quantize_tensor_matches_jax(bits, shape):
    rng = np.random.default_rng(bits + shape[1])
    w = (rng.normal(size=shape) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                       # an all-zero channel hits the 1e-12 floor
    jq = jquantize_tensor(jnp.asarray(w), bits)
    tq = tquantize_tensor(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.shape == jq.shape and tq.bits == jq.bits
    np.testing.assert_array_equal(tq.dequantize().numpy(), np.asarray(jq.dequantize()))


def _jax_params(cfg, seed=0):
    return jdecoder.init(cfg, jax.random.key(seed))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
def test_quantize_for_serve_and_fusion_match_jax(arch):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jp = _jax_params(jcfg)
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    jspecs = japply.layer_specs(jp, jcfg)
    tspecs = tapply.layer_specs(tp, tcfg)
    assert [dataclasses.astuple(s) for s in tspecs] == [dataclasses.astuple(s) for s in jspecs]
    policy = dryrun_policy(tspecs, "mixed")
    assert len(set(policy.bits.values())) > 1          # really mixed
    jpol = JBitPolicy.from_json(policy.to_json())
    jserve = japply.fuse_projections(
        japply.quantize_for_serve(jdecoder.unstack_layers(jp, jcfg), jpol, jcfg))
    tserve = tapply.fuse_projections(tapply.quantize_for_serve(
        params_from_numpy(_np_tree(jdecoder.unstack_layers(jp, jcfg)), device="cpu"),
        policy, tcfg))
    jleaves = dict(japply._walk(jserve))
    tleaves = dict(tapply._walk(tserve))
    assert sorted(jleaves) == sorted(tleaves)
    n_packed = 0
    for path, jl in jleaves.items():
        tl = tleaves[path]
        if isinstance(jl, JQT):
            assert isinstance(tl, TQT), path
            assert (tl.bits, tl.shape) == (jl.bits, jl.shape), path
            np.testing.assert_array_equal(tl.packed.numpy(), np.asarray(jl.packed), err_msg=str(path))
            np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale), err_msg=str(path))
            n_packed += 1
        else:
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl), err_msg=str(path))
    assert n_packed >= 1 + 4 * jcfg.n_layers                # embed + fused layer leaves
    assert tapply.packed_policy_bits(tserve) == japply.packed_policy_bits(jserve)


def test_fuse_projections_keeps_mixed_bit_groups_apart():
    cfg = tconfigs.get_config("gemma-2b").reduced()
    tp = params_from_numpy(_np_tree(_jax_params(jconfigs.get_config("gemma-2b").reduced())),
                           device="cpu")
    specs = tapply.layer_specs(tp, cfg)
    bits = {s.name: 4 for s in specs}
    bits["layer000.attn.wk"] = 8
    serve = tapply.fuse_projections(tapply.quantize_for_serve(
        tdecoder.unstack_layers(tp, cfg), TBitPolicy.from_bits(specs, bits), cfg))
    assert "wqkv" not in serve["layers"][0]["attn"] and "w_gu" in serve["layers"][0]["mlp"]
    assert "wqkv" in serve["layers"][1]["attn"]


def test_dryrun_policy_matches_jax():
    """The port's copy of ``dryrun_policy`` gives the JAX one's bits.

    ``repro.launch.dryrun`` sets XLA_FLAGS when imported; the backend is up
    before the import and the variable is restored after it, so nothing else
    in this process or its children sees 512 host devices.
    """
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import dryrun_policy as jdryrun_policy
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    for arch in ("gemma-2b", "qwen3-8b"):
        jcfg = jconfigs.get_config(arch).reduced()
        jspecs = japply.layer_specs(_jax_params(jcfg), jcfg)
        tspecs = tapply.layer_specs(params_from_numpy(_np_tree(_jax_params(jcfg)), device="cpu"),
                                    tconfigs.get_config(arch).reduced())
        for scheme in ("mixed", "uniform4"):
            assert dryrun_policy(tspecs, scheme).bits == jdryrun_policy(jspecs, scheme).bits


def test_configs_match_jax_field_by_field():
    jall = jconfigs.all_configs()
    tall = tconfigs.all_configs()
    assert list(tall) == list(jall)
    for name in jall:
        assert dataclasses.asdict(tall[name]) == dataclasses.asdict(jall[name]), name
        assert dataclasses.asdict(tall[name].reduced()) == dataclasses.asdict(jall[name].reduced())
    assert {k: dataclasses.astuple(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}


def test_policy_json_crosses_both_ways():
    cfg = jconfigs.get_config("gemma-2b").reduced()
    jspecs = japply.layer_specs(_jax_params(cfg), cfg)
    jpol = JBitPolicy.uniform(jspecs, 4).with_bits(jspecs[0].name, 8)
    tpol = TBitPolicy.from_json(jpol.to_json())
    assert tpol.bits == jpol.bits
    assert tpol.container_bytes() == jpol.container_bytes()
    assert tpol.mean_bits() == jpol.mean_bits()
    back = JBitPolicy.from_json(tpol.to_json())
    assert back.bits == jpol.bits and back.layers == jpol.layers
