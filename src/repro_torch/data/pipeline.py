"""Deterministic synthetic token pipeline (port of ``repro/data/pipeline.py``).

A learnable synthetic language: a Zipfian unigram prior mixed with a fixed
bigram permutation (``next = perm[cur]`` with probability 1 - noise, else a
Zipf draw).  A model that learns the permutation drives its loss from
``log V`` down to ``entropy_floor()``.

The JAX package draws from ``jax.random``, which has no PyTorch twin; the
port draws the same process from a CPU ``torch.Generator`` keyed by
``(seed, step)`` and moves the batch to the device afterwards, so a batch
is the same on the card and on the CPU.  Every batch is a pure function of
``(seed, step)``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def _generator(*key: int) -> torch.Generator:
    seed = np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) & (2**63 - 1))


@functools.lru_cache(maxsize=4)
def _perm(vocab: int, seed: int) -> torch.Tensor:
    return torch.randperm(vocab, generator=_generator(seed ^ 0x5EED))


@functools.lru_cache(maxsize=4)
def _zipf_probs(vocab: int, alpha: float) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32)
    return torch.softmax((-alpha * torch.log(ranks)).double(), dim=0)


@dataclasses.dataclass(frozen=True)
class TokenTask:
    """Synthetic language: ``next = perm[cur]`` w.p. 1 - noise, else a Zipf draw."""

    vocab_size: int
    seed: int = 0
    zipf_alpha: float = 1.2
    noise: float = 0.25

    def _perm(self) -> torch.Tensor:
        return _perm(self.vocab_size, self.seed)

    def _zipf_logits(self) -> torch.Tensor:
        ranks = torch.arange(1, self.vocab_size + 1, dtype=torch.float32)
        return -self.zipf_alpha * torch.log(ranks)

    def _probs(self) -> torch.Tensor:
        return _zipf_probs(self.vocab_size, self.zipf_alpha)

    def sequence_batch(self, generator: torch.Generator, batch: int, seq_len: int) -> torch.Tensor:
        """(B, S+1) int64 token stream on the CPU; callers split inputs/labels."""
        perm = self._perm()
        probs = self._probs()
        first = torch.multinomial(probs, batch, replacement=True, generator=generator)
        noise_draws = torch.multinomial(probs, batch * seq_len, replacement=True,
                                        generator=generator).reshape(batch, seq_len)
        use_noise = torch.rand((batch, seq_len), generator=generator) < self.noise
        out = torch.empty((batch, seq_len + 1), dtype=torch.int64)
        out[:, 0] = cur = first
        for t in range(seq_len):
            cur = torch.where(use_noise[:, t], noise_draws[:, t], perm[cur])
            out[:, t + 1] = cur
        return out

    def entropy_floor(self) -> float:
        """Per-token cross-entropy of the generating process (loss floor)."""
        p = np.exp(self._zipf_logits().double().numpy())
        p /= p.sum()
        h_prior = -(p * np.log(p)).sum()
        e = self.noise
        h_bern = -(e * np.log(max(e, 1e-12)) + (1 - e) * np.log(max(1 - e, 1e-12)))
        return float(h_bern + e * h_prior)


@dataclasses.dataclass(frozen=True)
class PipelineState:
    """The whole restore state of the input layer (checkpointed as one int)."""

    step: int = 0

    def next(self) -> "PipelineState":
        return PipelineState(self.step + 1)


def global_batch(task: TokenTask, cfg, shape, step: int) -> dict:
    """The full batch at ``step`` on the CPU: ``{"tokens", "labels"}`` (B, S)
    int64; for ``input_kind == "embeddings"`` (the VLM's frontend stub)
    ``{"embeds" (B, S, d), "labels"}``, the token stream looked up in a table
    of N(0, 0.02) entries; for the encoder-decoder families ``{"frames" (B,
    encoder_seq, d), "tokens", "labels"}``, the frames N(0, 0.02) (the audio
    frontend's stub).  Tables and frames are drawn from the step's own
    generator: only the distribution is the JAX package's ``jax.random``
    draw's."""
    stream = task.sequence_batch(_generator(task.seed, step), shape.global_batch, shape.seq_len)
    dt = getattr(torch, cfg.dtype)
    if cfg.input_kind == "embeddings":
        table = torch.randn((task.vocab_size, cfg.d_model),
                            generator=_generator(task.seed, step, 1)) * 0.02
        return {"embeds": table[stream[:, :-1]].to(dt), "labels": stream[:, 1:]}
    if cfg.family in ("audio", "encdec"):
        frames = torch.randn((shape.global_batch, cfg.encoder_seq, cfg.d_model),
                             generator=_generator(task.seed, step, 1)) * 0.02
        return {"frames": frames.to(dt), "tokens": stream[:, :-1], "labels": stream[:, 1:]}
    return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}


def host_batch(task: TokenTask, cfg, shape, step: int, host_id: int, n_hosts: int) -> dict:
    """This host's slice of the global batch (batch axis split over hosts):
    rows ``host_id * B / n_hosts`` onwards of :func:`global_batch`, so the
    hosts' slices concatenate to it exactly."""
    full = global_batch(task, cfg, shape, step)
    per = shape.global_batch // n_hosts
    return {k: v[host_id * per:(host_id + 1) * per] for k, v in full.items()}


def batch_on(raw: dict, device) -> dict:
    """A batch's arrays as tensors on ``device``: token ids and labels as
    int64, embeddings in their own dtype."""
    out = {}
    for k, v in raw.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        out[k] = t.to(device) if t.is_floating_point() else t.to(device, torch.long)
    return out
