"""Port parity of M-RoPE and the VLM family (qwen2-vl-2b), on the CPU.

``apply_mrope`` with distinct (t, h, w) positions agrees with the JAX
package's within rel 1e-6 at head dims 32 and 128 (cos and sin may round
an ulp apart); the text path (2-D positions) equals the explicit
broadcast.  Reduced qwen2-vl-2b (2 layers, d 128, 4 / 2 heads of 32) with
the JAX package's weights, packed under ``dryrun_policy("mixed")``:
``prefill`` and ``decode_step`` logits from tokens and from ``embeds``
within rel 1e-5 in f32, ``lm_loss`` from ``embeds`` within rel 1e-5, and
the engines' greedy streams identical, whole and chunked.  The data
pipeline's embedding batches share only the distribution with the JAX
package's (``jax.random`` has no torch twin).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import BitPolicy as JBitPolicy
from repro.models import decoder as jdecoder
from repro.models import layers as jlayers
from repro.quant import apply as japply
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.lifecycle import ShedPolicy as JShedPolicy
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch import train as ttrain
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import decoder as tdecoder
from repro_torch.models import layers as tlayers
from repro_torch.models import registry
from repro_torch.quant import apply as tapply
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.lifecycle import ShedPolicy
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(2)

ARCH = "qwen2-vl-2b"
B, P = 2, 12

_jprefill = jax.jit(jdecoder.prefill, static_argnums=(1,), static_argnames=("qimpl",))
_jdecode = jax.jit(jdecoder.decode_step, static_argnums=(1,), static_argnames=("qimpl",))


def _rel(out, ref) -> float:
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


@pytest.mark.parametrize("hd", (32, 128))
def test_apply_mrope_matches_jax_with_distinct_positions(hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 9)).astype(np.int32)
    sections = tlayers.mrope_sections(hd)
    half = hd // 2
    assert sections == (half - 2 * (half // 3), half // 3, half // 3) and sum(sections) == half
    out = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections, 1e6)
    ref = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
    assert _rel(out.numpy(), ref) <= 1e-6
    # each band reads its own position row: moving the h and w rows moves
    # only the later bands
    moved = pos.copy()
    moved[1:] += 7
    out2 = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(moved), sections, 1e6)
    t_band = sections[0]
    for lo, hi in ((0, t_band), (half, half + t_band)):
        np.testing.assert_array_equal(out2[..., lo:hi].numpy(), out[..., lo:hi].numpy())
    assert not np.array_equal(out2.numpy(), out.numpy())


def test_text_path_equals_the_broadcast_positions():
    tcfg = tconfigs.get_config(ARCH).reduced()
    pos2 = tlayers.position_ids(2, 6, device="cpu") + 3
    pos3 = tlayers.position_ids(2, 6, "mrope", device="cpu") + 3
    assert pos3.shape == (3, 2, 6) and all(torch.equal(p, pos2) for p in pos3)
    np.testing.assert_array_equal(pos3.numpy(), np.asarray(jlayers.position_ids(2, 6, "mrope")) + 3)
    rng = np.random.default_rng(0)
    hd = tcfg.resolved_head_dim
    q = torch.from_numpy(rng.standard_normal((2, 6, 4, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 6, 2, hd)).astype(np.float32))
    q2, k2, _ = tlayers._qkv_post({}, q, k, k, tcfg, pos2)
    q3, k3, _ = tlayers._qkv_post({}, q, k, k, tcfg, pos3)
    assert torch.equal(q2, q3) and torch.equal(k2, k3)
    want = tlayers.apply_mrope(q, pos3, tlayers.mrope_sections(hd), tcfg.rope_theta)
    assert torch.equal(q2, want)


@pytest.fixture(scope="module")
def served():
    jcfg = jconfigs.get_config(ARCH).reduced()
    tcfg = tconfigs.get_config(ARCH).reduced()
    assert tcfg.rope == "mrope" and tcfg.input_kind == "embeddings"
    jp = jdecoder.init(jcfg, jax.random.key(6))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    policy = dryrun_policy(tapply.layer_specs(tp, tcfg), "mixed")
    jserve = japply.fuse_projections(japply.quantize_for_serve(
        jdecoder.unstack_layers(jp, jcfg), JBitPolicy.from_json(policy.to_json()), jcfg))
    tserve = params_from_numpy(jax.tree.map(np.asarray, jserve), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jserve=jserve, tserve=tserve)


def test_registry_serves_the_vlm_family(served):
    api = registry.get_api(served["tcfg"])
    assert api.prefill is tdecoder.prefill and api.decode_verify is tdecoder.decode_verify


def test_prefill_and_decode_logits_match_jax_from_tokens_and_embeds(served):
    jcfg, tcfg, jserve, tserve = (served[k] for k in ("jcfg", "tcfg", "jserve", "tserve"))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (B, P)).astype(np.int32)
    emb = (rng.standard_normal((B, P, tcfg.d_model)) * 0.02).astype(np.float32)
    for kw, tkw in (({"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}),
                    ({"embeds": jnp.asarray(emb)}, {"embeds": torch.from_numpy(emb)})):
        jlog, jkv = _jprefill(jserve, jcfg, qimpl="xla", **kw)
        tlog, tkv = tdecoder.prefill(tserve, tcfg, **tkw)
        assert _rel(tlog.numpy(), jlog) <= 1e-5
        for j, t in zip(jkv, tkv):
            assert _rel(t["k"].numpy(), j["k"]) <= 1e-5 and _rel(t["v"].numpy(), j["v"]) <= 1e-5
    # decode steps on an fp cache from the tokens' prefill, by token and by embeds
    seq = 32
    jc = jdecoder.init_cache(jcfg, B, seq, jnp.float32)
    tc = tdecoder.init_cache(tcfg, B, seq, torch.float32, device="cpu")
    for j, t, (jk, tk) in zip(jc, tc, zip(*(_jprefill(jserve, jcfg, jnp.asarray(toks),
                                                       qimpl="xla")[1],
                                             tdecoder.prefill(tserve, tcfg,
                                                              torch.from_numpy(toks))[1]))):
        j["k"] = j["k"].at[:, :P].set(jk["k"])
        j["v"] = j["v"].at[:, :P].set(jk["v"])
        t["k"][:, :P] = tk["k"]
        t["v"][:, :P] = tk["v"]
    pos = np.asarray([P, P], np.int32)
    for step in range(3):
        tok = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        if step == 1:
            e1 = (rng.standard_normal((B, 1, tcfg.d_model)) * 0.02).astype(np.float32)
            jlog, jc = _jdecode(jserve, jcfg, jc, jnp.asarray(tok), jnp.asarray(pos),
                                embeds=jnp.asarray(e1), qimpl="xla")
            tlog, tc = tdecoder.decode_step(tserve, tcfg, tc, torch.from_numpy(tok),
                                            torch.from_numpy(pos), embeds=torch.from_numpy(e1))
        else:
            jlog, jc = _jdecode(jserve, jcfg, jc, jnp.asarray(tok), jnp.asarray(pos),
                                qimpl="xla")
            tlog, tc = tdecoder.decode_step(tserve, tcfg, tc, torch.from_numpy(tok),
                                            torch.from_numpy(pos))
        assert _rel(tlog.numpy(), jlog) <= 1e-5
        pos = pos + 1


def test_lm_loss_from_embeds_matches_jax(served):
    jcfg, tcfg, jp, tp = (served[k] for k in ("jcfg", "tcfg", "jp", "tp"))
    rng = np.random.default_rng(4)
    emb = (rng.standard_normal((B, 16, tcfg.d_model)) * 0.02).astype(np.float32)
    lab = rng.integers(0, tcfg.vocab_size, (B, 16)).astype(np.int32)
    jl = jax.jit(lambda p, e, y: jdecoder.lm_loss(p, jcfg, labels=y, embeds=e))(
        jp, jnp.asarray(emb), jnp.asarray(lab))
    batch = tpipe.batch_on({"embeds": emb, "labels": lab}, "cpu")
    assert batch["embeds"].dtype == torch.float32 and batch["labels"].dtype == torch.long
    tl = registry.get_api(tcfg).loss(tp, tcfg, batch)
    assert _rel(tl.detach().numpy(), jl) <= 1e-5


def test_a_leaf_the_loss_does_not_read_gets_a_zero_gradient(served):
    """Under ``embeds`` inputs the token table is not read: ``jax.grad``
    gives it zeros, and so does the port's ``value_and_grad`` (it raised)."""
    jcfg, tcfg, jp, tp = (served[k] for k in ("jcfg", "tcfg", "jp", "tp"))
    rng = np.random.default_rng(5)
    emb = (rng.standard_normal((1, 8, tcfg.d_model)) * 0.02).astype(np.float32)
    lab = rng.integers(0, tcfg.vocab_size, (1, 8)).astype(np.int32)
    jg = jax.jit(jax.grad(lambda p, y, e: jdecoder.lm_loss(p, jcfg, labels=y, embeds=e)))(
        jp, jnp.asarray(lab), jnp.asarray(emb))
    _, tg = value_and_grad(lambda p, b: registry.get_api(tcfg).loss(p, tcfg, b), tp,
                           tpipe.batch_on({"embeds": emb, "labels": lab}, "cpu"))
    assert not np.asarray(jg["embed"]).any()
    assert torch.equal(tg[0], torch.zeros_like(tp["embed"]))   # "embed" sorts first
    for a, b in zip(jax.tree.leaves(jg)[1:], tg[1:]):
        assert _rel(b, a) <= 1e-4


def test_embedding_batches_share_the_references_distribution():
    tcfg = tconfigs.get_config(ARCH).reduced()
    task = tpipe.TokenTask(vocab_size=tcfg.vocab_size, seed=1)
    shape = ShapeSpec("s", "train", 64, 8)
    a = tpipe.global_batch(task, tcfg, shape, 3)
    b = tpipe.global_batch(task, tcfg, shape, 3)
    assert set(a) == {"embeds", "labels"} and a["embeds"].shape == (8, 64, tcfg.d_model)
    assert a["embeds"].dtype == torch.float32 and torch.equal(a["embeds"], b["embeds"])
    assert not torch.equal(a["embeds"], tpipe.global_batch(task, tcfg, shape, 4)["embeds"])
    assert abs(float(a["embeds"].std()) - 0.02) < 2e-3
    # the same token at two places reads the same table row
    toks = task.sequence_batch(tpipe._generator(1, 3), 8, 64)[:, :-1]
    i, j = np.argwhere(toks.numpy() == toks[0, 0].item())[-1]
    assert torch.equal(a["embeds"][i, j], a["embeds"][0, 0])


def _engines(served, **kw):
    args = dict(max_slots=3, max_seq=64, prefill_pad=8, state_bits=8, **kw)
    jeng = JServeEngine(served["jcfg"], served["jserve"], qimpl="xla",
                        shed=JShedPolicy(straggler_sheds_spec=False), **args)
    eng = ServeEngine(served["tcfg"], served["tserve"], device="cpu",
                      shed=ShedPolicy(straggler_sheds_spec=False), **args)
    return jeng, eng


@pytest.mark.parametrize("chunk", (None, 4))
def test_engine_streams_match_jax(served, chunk):
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 512, n).tolist() for n in (5, 17, 1, 11, 9)]
    jeng, eng = _engines(served, prefill_chunk=chunk)
    want = jeng.generate(prompts, max_new_tokens=6)
    assert eng.generate(prompts, max_new_tokens=6) == want
    assert eng.stats()["decode_steps"] == jeng.stats()["decode_steps"]


def test_serve_and_train_cli_run_the_vlm_family(capsys, tmp_path):
    assert tserve_cli.main(["--arch", ARCH, "--reduced", "--requests", "3", "--max-new", "4",
                            "--wbits", "mixed", "--device", "cpu"]) == 0
    assert "3 requests, 12 new tokens" in capsys.readouterr().out
    assert ttrain.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2", "--seq",
                        "16", "--wbits", "4", "--device", "cpu", "--ckpt",
                        str(tmp_path / "ck")]) == 0
    assert "'loss':" in capsys.readouterr().out
