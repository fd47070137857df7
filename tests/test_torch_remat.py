"""Recompute in the backward (``remat``), on the CPU, in every model family.

The JAX package checkpoints each layer scan's body (``jax.checkpoint(...,
policy=nothing_saveable)`` under ``remat=True``, the default) and each chunk
of its LM loss; the port's forwards take ``remat: bool = True`` and run the
same regions under ``torch.utils.checkpoint`` (non-reentrant).  Reduced
gemma-2b (dense), deepseek-moe-16b (MoE), mamba2-2.7b, zamba2-2.7b (its
shared block inside the recomputed body), whisper-tiny (both stacks) and
qwen2-vl-2b (from ``embeds=``), in f32, with the JAX package's weights
carried over by ``convert``, a mixed 2-8 bit policy and numpy-seeded
inputs:

  * the loss and every gradient leaf with ``remat=True`` are bit for bit
    those with ``remat=False`` (the loss in two chunks);
  * the port's ``api.loss`` and its gradient stay within each family's
    tolerance of the JAX package's (that family's parity tests' limits);
  * a grad-free forward never enters ``torch.utils.checkpoint``;
  * the plain fake-quant calls of one training step are ``per_fwd +
    recomputed`` and the STE calls ``per_fwd``, by ``chip_smoke.py``'s own
    rule (``_fq_per_forward``, ``_fq_recomputed``); an evaluation is
    ``per_fwd``;
  * under ``roofline.hlo_cost.CostMode`` a forward and backward peaks lower
    with ``remat=True``, and the chunked loss at 4 chunks peaks below the
    whole sequence's f32 logits plus the params, the hidden state and the
    labels.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro import configs as jconfigs
from repro.core import policy as jpol
from repro.models import registry as jreg
from repro.quant import apply as japply
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.models import decoder, encdec, hybrid, mamba2
from repro_torch.models import registry as treg
from repro_torch.quant import apply as tapply
from repro_torch.roofline import hlo_cost
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 16
#: (loss rel, gradient rel) against the JAX package, as each family's parity
#: tests hold them: dense gradients 1e-4 (``test_torch_search.py``), the SSM
#: scan's 1e-4 (``test_torch_mamba2.py``; the hybrid's Mamba leaves too,
#: ``test_torch_hybrid.py``), MoE and whisper 1e-5
TOL = {"gemma-2b": (1e-5, 1e-4), "deepseek-moe-16b": (1e-5, 1e-5), "mamba2-2.7b": (1e-5, 1e-4),
       "zamba2-2.7b": (1e-5, 1e-4), "whisper-tiny": (1e-5, 1e-5), "qwen2-vl-2b": (1e-5, 1e-4)}
ARCHS = sorted(TOL)


def _rel(out, ref) -> float:
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batch(cfg, seed: int) -> dict:
    """numpy inputs: tokens (or ``embeds`` for the VLM), labels, and the
    frames for whisper."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)) * 0.02
                         ).astype(np.float32)
    return out


def _tb(batch: dict) -> dict:
    return {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v).long()
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jp = jreg.get_api(jcfg).init(jcfg, jax.random.key(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    specs = tapply.layer_specs(tp, tcfg)
    rng = np.random.default_rng(7)
    tpolicy = tpol.BitPolicy.from_bits(specs, {s.name: int(rng.choice([2, 4, 6, 8]))
                                               for s in specs})
    jpolicy = jpol.BitPolicy.from_json(tpolicy.to_json())
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, specs=specs,
                jbits=japply.bits_for_scan(jpolicy, jp, jcfg),
                tbits=tapply.bits_for_scan(tpolicy, tp, tcfg), batch=_batch(tcfg, 11))


def _hidden(params, cfg, batch, bits, remat):
    """The family's forward to the final hidden state, ``remat`` passed on."""
    if cfg.family == "audio":
        enc = encdec.encode(params, cfg, batch["frames"], bits=bits, remat=remat)
        return encdec.decode_train(params, cfg, batch["tokens"], enc, bits=bits, remat=remat)
    fwd = {"ssm": mamba2.forward, "hybrid": hybrid.forward}.get(cfg.family, decoder.forward)
    return fwd(params, cfg, batch.get("tokens"), batch.get("embeds"), bits=bits, remat=remat)


def _loss(params, cfg, batch, bits, remat):
    """The forward, then the chunked loss in two chunks."""
    hidden = _hidden(params, cfg, batch, bits, remat)
    return decoder.lm_loss_from_hidden(params, cfg, hidden, batch["labels"], bits=bits,
                                       loss_chunk=S // 2)


def _shared_leaves(cfg, params) -> set:
    """The leaves read in more than one checkpointed region: the tied
    embedding (the lookup and every head chunk) and the hybrid's shared
    block (every application)."""
    paths = [p for p, _ in tapply._walk(params)]
    out = {i for i, p in enumerate(paths) if p[0] == "shared_attn"}
    if cfg.tie_embeddings:
        out |= {i for i, p in enumerate(paths) if p == ("embed",)}
    return out


def test_remat_keeps_the_loss_and_every_gradient(family):
    """Bit for bit; a leaf read in two regions (the tied embedding,
    zamba2's shared block) may only move by the order its gradient's terms
    are summed in, so it is held within rel 1e-6 (on this torch each is
    bit for bit too)."""
    cfg, tp, bits, batch = family["tcfg"], family["tp"], family["tbits"], _tb(family["batch"])
    runs = {r: value_and_grad(lambda p, b, r=r: _loss(p, cfg, b, bits, r), tp, batch)
            for r in (False, True)}
    (l0, g0), (l1, g1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    shared = _shared_leaves(cfg, tp)
    assert len(g0) == len(g1) == len(topt.leaves(tp))
    for i, (a, b) in enumerate(zip(g0, g1)):
        if i in shared:
            assert _rel(b, a) <= 1e-6, i
        else:
            assert torch.equal(a, b), i
    assert all(torch.isfinite(g).all() for g in g1)


def test_the_loss_and_gradients_stay_within_the_jax_tolerance(family):
    """The port's ``api.loss`` (its forwards' default, ``remat=True``)
    against the JAX package's, whose scan bodies and loss chunks are
    checkpointed too."""
    jcfg, tcfg, batch = family["jcfg"], family["tcfg"], family["batch"]
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b, bb: jreg.get_api(jcfg).loss(p, jcfg, b, bits=bb)))(
        family["jp"], {k: jnp.asarray(v) for k, v in batch.items()}, family["jbits"])
    tl, tg = value_and_grad(
        lambda p, b: treg.get_api(tcfg).loss(p, tcfg, b, bits=family["tbits"]),
        family["tp"], _tb(batch))
    loss_tol, grad_tol = TOL[family["arch"]]
    assert _rel(tl, jl) <= loss_tol
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(jleaves) == len(tg)
    for (path, a), b in zip(jleaves, tg):
        key = jax.tree_util.keystr(path)
        assert tuple(b.shape) == a.shape, key
        if family["arch"] == "qwen2-vl-2b" and key == "['embed']":
            assert not np.asarray(a).any() and not b.any()   # embeds: the table is not read
            continue
        assert _rel(b, a) <= grad_tol, key


def test_a_grad_free_forward_enters_no_checkpoint(family, monkeypatch):
    """Evaluation and serving run the bodies directly: with
    ``torch.utils.checkpoint.checkpoint`` made to raise, the grad-free
    forward and loss give what they gave before; with grad on, it is
    entered (so the patch is the one the forwards call)."""
    cfg, tp, bits, batch = family["tcfg"], family["tp"], family["tbits"], _tb(family["batch"])
    with torch.no_grad():
        want_h = _hidden(tp, cfg, batch, bits, True)
        want_l = treg.get_api(cfg).loss(tp, cfg, batch, bits=bits)

    def refuse(*a, **kw):
        raise AssertionError("entered torch.utils.checkpoint")

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", refuse)
    with torch.no_grad():
        assert torch.equal(_hidden(tp, cfg, batch, bits, True), want_h)
        assert torch.equal(treg.get_api(cfg).loss(tp, cfg, batch, bits=bits), want_l)
    with pytest.raises(AssertionError, match="entered torch.utils.checkpoint"):
        value_and_grad(lambda p, b: treg.get_api(cfg).loss(p, cfg, b, bits=bits), tp, batch)


def test_fake_quant_calls_of_a_training_step_and_an_evaluation(family):
    """One training step: ``per_fwd + recomputed`` fake-quant calls (the
    recompute runs every region's again: each layer's weights, the shared
    block at each application, the head once a loss chunk) and ``per_fwd``
    STE calls; an evaluation ``per_fwd``; both by ``chip_smoke.py``'s rule."""
    cs = _chip_smoke()
    cfg, tp, bits, batch = family["tcfg"], family["tp"], family["tbits"], _tb(family["batch"])
    for n_chunks, loss_fn in ((1, lambda p, b: treg.get_api(cfg).loss(p, cfg, b, bits=bits)),
                              (2, lambda p, b: _loss(p, cfg, b, bits, True))):
        per_fwd = cs._fq_per_forward(cfg, family["specs"], n_chunks)
        if "embeds" in batch:
            per_fwd -= 1          # no lookup: the embeddings come in
        recomputed = cs._fq_recomputed(cfg, family["specs"], n_chunks)
        assert 0 < recomputed < per_fwd + 1
        kernels.reset_counts()
        value_and_grad(loss_fn, tp, batch)
        assert kernels.PLAIN_CALLS["fake_quant"] == per_fwd + recomputed, n_chunks
        assert kernels.PLAIN_CALLS["fake_quant_ste_bwd"] == per_fwd, n_chunks
        kernels.reset_counts()
        with torch.no_grad():
            loss_fn(tp, batch)
        assert kernels.PLAIN_CALLS["fake_quant"] == per_fwd, n_chunks
        assert kernels.PLAIN_CALLS["fake_quant_ste_bwd"] == 0
    kernels.reset_counts()


def _peak(fn) -> float:
    mode = hlo_cost.CostMode()
    with mode:
        fn()
    return mode.trace.peak_live_bytes


def test_remat_lowers_the_live_peak(family):
    """A forward and backward under ``CostMode``: the storages alive
    together peak lower when each layer body is recomputed."""
    cfg, tp, bits, batch = family["tcfg"], family["tp"], family["tbits"], _tb(family["batch"])
    peaks = {r: _peak(lambda r=r: value_and_grad(lambda p, b: _loss(p, cfg, b, bits, r), tp,
                                                   batch))
             for r in (False, True)}
    assert 0 < peaks[True] < peaks[False], peaks


def test_the_chunked_loss_keeps_one_chunk_of_logits():
    """Reduced gemma-2b (tied 512 x 128 head), a QAT loss over S = 4 x
    ``loss_chunk``: the peak stays below the whole sequence's f32 logits
    (B * S * V * 4 bytes) plus the bytes of the params, the hidden state
    and the labels; keeping every chunk's logits (and fake-quantized head)
    for the backward goes above it."""
    cfg = tconfigs.get_config("gemma-2b").reduced()
    params = decoder.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    bits = tapply.bits_for_scan(
        tpol.BitPolicy.uniform(tapply.layer_specs(params, cfg), 4), params, cfg)
    chunk, b = 32, 2
    s = 4 * chunk
    gen = torch.Generator().manual_seed(4)
    hidden = torch.randn(b, s, cfg.d_model, generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)

    def step():
        h = hidden.clone().requires_grad_()
        value_and_grad(lambda p, y: decoder.lm_loss_from_hidden(p, cfg, h, y, bits=bits,
                                                                loss_chunk=chunk),
                       params, labels)

    nbytes = sum(t.numel() * t.element_size() for t in topt.leaves(params))
    limit = (b * s * cfg.vocab_size * 4 + nbytes + hidden.numel() * 4
             + labels.numel() * labels.element_size())
    peak = _peak(step)
    assert peak < limit, (peak, limit)
