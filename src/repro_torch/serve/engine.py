"""Batched serving engine with continuous batching over fixed decode slots.

The minimal port of ``repro/serve/engine.py``:

  * ``max_slots`` decode slots share one ``(B, S, ...)`` decode state.
  * Admission: every queued request that fits a free slot is admitted in
    ONE batch — the prompts minus their last tokens right-pad to the group
    max rounded to ``prefill_pad`` and prefill in a single call; each row is
    quantized into its slot.  The next decode step replays the last prompt
    token at ``pos = len-1``, which yields the first sampled token.
  * Decode: all ``max_slots`` rows step in lockstep with a vector of
    per-slot positions.  ``tokens_h``/``pos_h`` persist across turns, so an
    idle slot steps at its last values, exactly as the JAX engine does (the
    cache bytes stay comparable between the two).
  * Completion on eos / ``max_new_tokens`` / a full cache frees the slot,
    and the queue refills it (continuous batching).

Left for later slices: policy artifacts, paging, speculation, chunked
prefill, lifecycle / shedding / deadlines, fault injection, tracing and NaN
quarantine.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch import kernels, kvcache
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.quant import apply as qapply
from .sampling import sample


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int = -1              # -1: never stop early


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    pos: int = 0                  # next write position
    generated: list[int] = dataclasses.field(default_factory=list)

    @property
    def free(self) -> bool:
        return self.req is None


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            t = _first_tensor(v)
            if t is not None:
                return t
        return None
    return getattr(tree, "packed", None)


class ServeEngine:
    def __init__(self, cfg, params: dict, *, max_slots: int = 4, max_seq: int = 256,
                 prefill_pad: int = 32, impl: str = "auto", temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 state_dtype=torch.float32, fuse_projections: bool = True, state_bits=None,
                 kv_block: int | None = None, device=None):
        self.device = resolve_device(device)
        leaf = _first_tensor(params)
        if leaf is not None and leaf.device.type != self.device.type:
            raise ValueError(f"params lie on {leaf.device} but the engine serves on "
                             f"{self.device}")
        self.cfg = cfg
        self.api = registry.get_api(cfg)
        self.packed_bits = qapply.packed_policy_bits(params)
        # fuse packed Q/K/V and gate/up groups: one kernel launch per group
        self.params = qapply.fuse_projections(params) if fuse_projections else params
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.prefill_pad = prefill_pad
        self.impl = impl
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        resolved = kvcache.resolve_state_bits(state_bits, cfg)
        self.state = self.api.init_decode_state(cfg, max_slots, max_seq, state_dtype,
                                                state_bits=resolved, block=kv_block,
                                                device=self.device)
        #: state-entry name -> packed bits
        self.state_bits = kvcache.packed_state_bits(self.state)
        self.slots = [_Slot() for _ in range(max_slots)]
        self._queue: list[Request] = []
        self._pending_token: dict[int, int] = {}
        self._counts = {"decode_steps": 0, "admissions": 0, "prefill_tokens": 0,
                        "completed": 0}
        #: host seconds of each decode step, the token transfer included
        self._step_s: list[float] = []

    # -- admission ---------------------------------------------------------
    def _admit(self, assignments: list[tuple[int, Request]]) -> None:
        """Admit requests into free slots; one padded prefill for the batch."""
        with_head: list[tuple[int, list[int]]] = []
        for slot_id, req in assignments:
            if not 1 <= len(req.prompt) < self.max_seq:
                raise ValueError(f"request {req.uid}: prompt length {len(req.prompt)} "
                                 f"must be in [1, {self.max_seq})")
            slot = self.slots[slot_id]
            slot.req, slot.generated = req, []
            slot.pos = len(req.prompt) - 1
            self._pending_token[slot_id] = req.prompt[-1]   # replayed next step
            if len(req.prompt) > 1:
                with_head.append((slot_id, req.prompt[:-1]))
        if not with_head:
            return
        pad = min(_round_up(max(len(h) for _, h in with_head), self.prefill_pad),
                  self.max_seq)
        toks = np.zeros((len(with_head), pad), np.int32)
        for row, (_, head) in enumerate(with_head):
            toks[row, : len(head)] = head
        lengths = torch.tensor([len(h) for _, h in with_head], dtype=torch.int32,
                               device=self.device)
        _, st = self.api.prefill(self.params, self.cfg,
                                 torch.tensor(toks, device=self.device), impl=self.impl,
                                 lengths=lengths, logits=False)
        self.state = kvcache.insert_state_rows(self.state, [s for s, _ in with_head], st,
                                               lengths)
        self._counts["admissions"] += 1
        self._counts["prefill_tokens"] += sum(len(h) for _, h in with_head)

    # -- decode ------------------------------------------------------------
    def _decode(self, tokens_h: np.ndarray, pos_h: np.ndarray) -> np.ndarray:
        """One lockstep step over every slot; ONE (B,) int32 transfer to the host."""
        logits, self.state = self.api.decode_step(
            self.params, self.cfg, self.state, torch.tensor(tokens_h, device=self.device),
            torch.tensor(pos_h, device=self.device), impl=self.impl)
        last = logits[:, -1]
        if self.temperature > 0.0:
            toks = sample(last, self._gen, temperature=self.temperature, top_k=self.top_k,
                          top_p=self.top_p)
        else:
            toks = sample(last)
        return toks.cpu().numpy()

    # -- main loop -----------------------------------------------------------
    def run(self, requests: list[Request] = ()) -> dict[int, list[int]]:
        """Continuous-batching loop until every request completes -> ``{uid: tokens}``."""
        self._queue.extend(requests)
        results: dict[int, list[int]] = {}
        self._pending_token = {}
        tokens_h = np.zeros((self.max_slots, 1), np.int32)
        pos_h = np.zeros((self.max_slots,), np.int32)
        while self._queue or self._active():
            free = [i for i, s in enumerate(self.slots) if s.free]
            if free and self._queue:
                self._admit([(i, self._queue.pop(0)) for i in free[: len(self._queue)]])
            act = self._active()
            for i in act:
                s = self.slots[i]
                tokens_h[i, 0] = self._pending_token.get(
                    i, s.generated[-1] if s.generated else 0)
                pos_h[i] = s.pos
            t0 = time.perf_counter()
            toks = self._decode(tokens_h, pos_h)
            self._step_s.append(time.perf_counter() - t0)
            self._counts["decode_steps"] += 1
            for i in act:
                s = self.slots[i]
                self._pending_token.pop(i, None)
                tok = int(toks[i])
                s.generated.append(tok)
                s.pos += 1
                if (tok == s.req.eos_id or len(s.generated) >= s.req.max_new_tokens
                        or s.pos >= self.max_seq - 1):
                    results[s.req.uid] = list(s.generated)
                    self.slots[i] = _Slot()
                    self._counts["completed"] += 1
        return results

    def _active(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.free]

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 16) -> list[list[int]]:
        reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new_tokens)
                for i, p in enumerate(prompts)]
        out = self.run(reqs)
        return [out[i] for i in range(len(prompts))]

    def stats(self) -> dict:
        """Engine counters, the median decode step time and the process-wide
        kernel launch and plain-call counts.  ``admissions`` counts batched
        prefill calls."""
        median = statistics.median(self._step_s) if self._step_s else None
        return {**self._counts, "decode_step_median_s": median,
                "launches": dict(kernels.LAUNCHES), "plain_calls": dict(kernels.PLAIN_CALLS)}

    def weight_container_bytes(self) -> int:
        """Device bytes the packed weights occupy (quantized leaves only)."""
        return sum(leaf.container_bytes() for _, leaf in qapply._walk(self.params)
                   if hasattr(leaf, "container_bytes"))

    def state_container_bytes(self) -> int:
        """Device bytes the decode state occupies."""
        return sum(layer.container_bytes() if hasattr(layer, "container_bytes")
                   else sum(t.numel() * t.element_size() for t in layer.values())
                   for layer in self.state)
