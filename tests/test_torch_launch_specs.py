"""The port's cell inputs and abstract states against the JAX package's:
``configs.applicable_shapes`` / ``smoke_shape``, ``launch.specs``'
``train_batch``, ``prefill_inputs`` and ``decode_inputs`` (abstract: meta
tensors with the reference's keys, shapes and dtypes, every family and
shape), the abstract decode states of every family (and the refusal of a
quantized one in both packages), ``abstract_quantized``, and
``data.pipeline.host_batch`` (the hosts' slices concatenate to
``global_batch``) with ``PipelineState``."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import registry as jregistry
from repro.quant.tensor import abstract_quantized as j_abstract_quantized
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.dist.sharding import map_with_path
from repro_torch.launch import specs
from repro_torch.models import registry
from repro_torch.quant.tensor import abstract_quantized

ARCHS = sorted(configs.ARCH_MODULES)


def _jkey(entry) -> str:
    if isinstance(entry, jax.tree_util.DictKey):
        return f"[{entry.key!r}]"
    if isinstance(entry, jax.tree_util.SequenceKey):
        return f"[{entry.idx}]"
    return f".{entry.name}"


def _tkey(entry) -> str:
    if hasattr(entry, "key"):
        return f"[{entry.key!r}]"
    if hasattr(entry, "idx"):
        return f"[{entry.idx}]"
    return f".{entry.name}"


def jax_shapes(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"".join(map(_jkey, p)): (tuple(x.shape), np.dtype(x.dtype).name) for p, x in flat}


def port_shapes(tree) -> dict:
    out = {}

    def rec(path, x):
        assert x.device.type == "meta", ("".join(map(_tkey, path)), x.device)
        out["".join(map(_tkey, path))] = (tuple(x.shape), str(x.dtype).removeprefix("torch."))

    map_with_path(rec, tree)
    return out


def test_applicable_and_smoke_shapes_equal_jax():
    for arch in ARCHS:
        assert [s for s in configs.applicable_shapes(configs.get_config(arch))] == [
            configs.ShapeSpec(*vars(s).values())
            for s in jconfigs.applicable_shapes(jconfigs.get_config(arch))], arch
    for kind in ("train", "prefill", "decode"):
        assert vars(configs.smoke_shape(kind)) == vars(jconfigs.smoke_shape(kind))
    with pytest.raises(KeyError):
        configs.smoke_shape("serve")


def _cells():
    for arch in ARCHS:
        for s in configs.applicable_shapes(configs.get_config(arch)):
            yield arch, s.name
        for kind in ("train", "prefill", "decode"):
            yield arch, "smoke_" + kind


def _shape(name):
    if name.startswith("smoke_"):
        return configs.smoke_shape(name.removeprefix("smoke_")), \
            jconfigs.smoke_shape(name.removeprefix("smoke_"))
    return configs.SHAPES[name], jconfigs.SHAPES[name]


@pytest.mark.parametrize("arch,shape_name", list(_cells()))
def test_abstract_inputs_equal_jax(arch, shape_name):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shape, jshape = _shape(shape_name)
    fns = {"train": ("train_batch",), "prefill": ("prefill_inputs",),
           "decode": ("decode_inputs",)}[shape.kind]
    for fn in fns:
        mine = port_shapes(getattr(specs, fn)(cfg, shape, abstract=True))
        ref = jax_shapes(getattr(jspecs, fn)(jcfg, jshape, abstract=True))
        assert mine == ref, (fn, set(mine.items()) ^ set(ref.items()))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_decode_states_equal_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    api, japi = registry.get_api(cfg), jregistry.get_api(jcfg)
    mine = port_shapes(api.init_decode_state(cfg, 3, 40, torch.float32, True))
    ref = jax_shapes(japi.init_decode_state(jcfg, 3, 40, jax.numpy.float32, True))
    assert mine == ref
    if cfg.family in ("dense", "moe", "vlm", "hybrid"):
        n = (len(api.init_decode_state(cfg, 1, 8, torch.float32, True)["attn"])
             if cfg.family == "hybrid" else cfg.n_layers)
        for a, kw in ((api, {}), (japi, {})):
            with pytest.raises(NotImplementedError, match="abstract quantized decode state"):
                a.init_decode_state(cfg if a is api else jcfg, 1, 8, None, True,
                                    state_bits=[(8, 8)] * n, **kw)


def test_abstract_quantized_equals_jax():
    for shape, bits in (((64, 32), 4), ((8, 100, 48), 6), ((2048, 256000), 8), ((7, 5), 2)):
        mine = abstract_quantized(shape, bits)
        ref = j_abstract_quantized(shape, bits)
        assert mine.packed.is_meta and mine.scale.is_meta
        assert tuple(mine.packed.shape) == ref.packed.shape and mine.packed.dtype == torch.int8
        assert tuple(mine.scale.shape) == ref.scale.shape and mine.scale.dtype == torch.float32
        assert (mine.bits, mine.shape) == (ref.bits, ref.shape)


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-vl-2b", "whisper-tiny"])
def test_host_batch_slices_concatenate_to_the_global_batch(arch):
    cfg = configs.get_config(arch).reduced()
    task = pipeline.TokenTask(vocab_size=cfg.vocab_size, seed=3)
    shape = configs.ShapeSpec("t", "train", 16, 8)
    full = pipeline.global_batch(task, cfg, shape, 5)
    for n_hosts in (1, 2, 4, 8):
        parts = [pipeline.host_batch(task, cfg, shape, 5, h, n_hosts) for h in range(n_hosts)]
        assert all(p[k].shape[0] == 8 // n_hosts for p in parts for k in p)
        for k in full:
            assert torch.equal(torch.cat([p[k] for p in parts]), full[k]), (n_hosts, k)
    st = pipeline.PipelineState()
    assert st.step == 0 and st.next().next() == pipeline.PipelineState(2)


def test_concrete_inputs_draw_from_the_generator():
    cfg = configs.get_config("gemma-2b").reduced()
    shape = configs.smoke_shape("decode")
    a = specs.decode_inputs(cfg, shape, abstract=False,
                            generator=torch.Generator().manual_seed(1))
    b = specs.decode_inputs(cfg, shape, abstract=False,
                            generator=torch.Generator().manual_seed(1))
    assert torch.equal(a["token"], b["token"]) and a["token"].dtype == torch.int32
    assert int(a["pos"]) == shape.seq_len - 1
    assert a["state"][0]["k"].shape == (2, 64, cfg.n_kv_heads, 32)
    assert int(a["token"].max()) < cfg.vocab_size
    tb = specs.train_batch(cfg, configs.smoke_shape("train"), abstract=False,
                           generator=torch.Generator().manual_seed(2))
    assert tb["tokens"].shape == tb["labels"].shape == (2, 32)
    with pytest.raises(ValueError, match="generator"):
        specs.prefill_inputs(cfg, shape, abstract=False)
