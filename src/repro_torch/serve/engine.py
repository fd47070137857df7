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
  * ``paged=True`` serves from a block pool (``kvcache/paged.py``): blocks
    map on demand at admission and at block boundaries, a prompt whose
    head matches a resident slot's maps that slot's blocks (refcounted) and
    copies a shared block before its first write (copy-on-write), every
    admission reserves the blocks its decode can still need, and a request
    the pool cannot cover waits at the head of the queue until completions
    free blocks.
  * ``artifact=`` deploys a ``PolicyArtifact``: the packed weights and the
    built decode state are verified against it, its state policy builds the
    quantized cache, its pool geometry the paged one, and a draft policy
    (v4 and later) turns speculation on at its ``draft_k``.
  * ``speculate=K`` with a ``draft_policy`` makes each decode round a
    self-speculative burst: a re-packing of the same weights at the draft
    bits proposes K tokens, ``decode_verify`` checks all K+1 positions in
    one weight pass, and ``spec/loop.py`` rewinds the quantized cache to
    the accepted prefix.  Greedy streams equal the non-speculative ones.
    The burst K is the configured K throughout (the JAX engine's shed
    ladder, which lowers it under pool pressure, is not ported), shrunk
    only near ``max_seq``.

Left for later slices: chunked prefill, lifecycle / shedding / deadlines,
fault injection, tracing, NaN quarantine and the v5 kernel configs.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch import kernels, kvcache
from repro_torch.kvcache import paged as kvpaged
from repro_torch.device import resolve_device
from repro_torch.core.policy import PolicyArtifact
from repro_torch.models import registry
from repro_torch.quant import apply as qapply
from repro_torch.spec import loop as spec_loop
from repro_torch.spec.draft import build_draft_params
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
                 kv_block: int | None = None, paged: bool = False, pool_blocks: int | None = None,
                 share_prefix: bool = True, speculate: int | None = None, draft_policy=None,
                 artifact: PolicyArtifact | None = None, debug_invariants: bool = False,
                 device=None):
        self.device = resolve_device(device)
        leaf = _first_tensor(params)
        if leaf is not None and leaf.device.type != self.device.type:
            raise ValueError(f"params lie on {leaf.device} but the engine serves on "
                             f"{self.device}")
        self.cfg = cfg
        self.api = registry.get_api(cfg)
        # the policy this engine claims to serve: refuse packed bits that differ
        self.artifact = artifact
        self.packed_bits = qapply.packed_policy_bits(params)
        if artifact is not None:
            qapply.verify_packed_bits(params, artifact)
        # fuse packed Q/K/V and gate/up groups: one kernel launch per group
        self.params = qapply.fuse_projections(params) if fuse_projections else params
        # self-speculation: explicit speculate/draft_policy win, else a
        # draft-carrying artifact turns it on at its searched K
        explicit_draft = draft_policy is not None
        if draft_policy is None and artifact is not None and artifact.draft_policy is not None:
            draft_policy = artifact.draft_policy
            if speculate is None:
                speculate = artifact.draft_k
        if explicit_draft and speculate is None:
            raise ValueError("draft_policy given without speculate=K (pass speculate, or "
                             "deploy a v4 artifact that records K)")
        self.speculate = int(speculate or 0)
        self.draft_params = None
        self.draft_bits: dict[str, int] = {}
        if self.speculate:
            if draft_policy is None:
                raise ValueError("speculate=K needs a draft_policy (or a draft-carrying v4 "
                                 "artifact)")
            if self.api.decode_verify is None:
                raise NotImplementedError(f"family {cfg.family!r} cannot self-speculate: its "
                                          f"decode state has no burst-rewindable KV form")
            # the draft derives from the UNFUSED tree, so a heterogeneous draft
            # policy never splits a fused leaf; equal-bit groups fuse after
            draft, self.draft_bits = build_draft_params(params, draft_policy, cfg)
            self.draft_params = qapply.fuse_projections(draft) if fuse_projections else draft
        #: the live burst length: the configured K (no shed ladder yet)
        self._k_live = self.speculate
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.prefill_pad = prefill_pad
        self.impl = impl
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # explicit state_bits win, else the artifact's state policy
        if state_bits is None and artifact is not None:
            state_bits = artifact.state_policy
        resolved = kvcache.resolve_state_bits(state_bits, cfg)
        # an artifact with pool geometry deploys the paged cache
        if artifact is not None and artifact.pool is not None:
            paged = True
            pool_blocks = pool_blocks or int(artifact.pool["num_blocks"])
            kv_block = kv_block or int(artifact.pool["block"])
        if paged and resolved is None:
            raise ValueError("paged KV cache requires a quantized state (state_bits or an "
                             "artifact state policy)")
        self.paged = paged
        self.share_prefix = share_prefix
        self._debug_invariants = debug_invariants
        self.state = self.api.init_decode_state(cfg, max_slots, max_seq, state_dtype,
                                                state_bits=resolved, block=kv_block,
                                                paged=paged, pool_blocks=pool_blocks,
                                                device=self.device)
        if paged:
            blk = self.state[0].block
            if artifact is not None and artifact.pool is not None and (
                    blk != int(artifact.pool["block"])):
                raise ValueError(f"artifact pool block {artifact.pool['block']} does not "
                                 f"divide max_seq={max_seq}; serve with a max_seq multiple "
                                 f"of the searched block length")
            self.pool = kvcache.BlockPool(self.state[0].num_blocks - 1)
            self._kv_blk = blk
            self._host_tables = np.full((max_slots, max_seq // blk), -1, np.int32)
            #: slot -> logical blocks it maps from another slot (shared prefix)
            self._shared_blocks: dict[int, set[int]] = {}
            #: slot -> blocks reserved for its remaining growth
            self._reserved: dict[int, int] = {}
            self._tables_dirty = False
        else:
            self.pool = None
        #: state-entry name -> packed bits
        self.state_bits = kvcache.packed_state_bits(self.state)
        if artifact is not None:
            # slots and max_seq may differ from the search's: the surface
            # check compares entries and head geometry only
            surface = (kvcache.state_layer_infos(cfg, max_slots, max_seq)
                       if artifact.state_policy is not None else None)
            kvcache.verify_state_bits(self.state, artifact, surface=surface)
        #: quantized layers need the burst snapshot/replay commit; fp ones do not
        self._quant_state = any(isinstance(layer, (kvcache.QuantizedKVLayer,
                                                   kvcache.PagedKVLayer))
                                for layer in self.state)
        self.slots = [_Slot() for _ in range(max_slots)]
        self._queue: list[Request] = []
        self._pending_token: dict[int, int] = {}
        self._counts = {"decode_steps": 0, "admissions": 0, "prefill_tokens": 0,
                        "completed": 0, "spec_steps": 0, "spec_proposed": 0,
                        "spec_accepted": 0}
        #: host seconds of each decode step (a speculative round under
        #: speculation), the token transfer included
        self._step_s: list[float] = []

    # -- paged block bookkeeping -------------------------------------------
    def _push_tables(self) -> None:
        """Copy the host block tables into the device table (shared by the layers)."""
        if not self._tables_dirty:
            return
        for layer in {id(layer.block_table): layer for layer in self.state}.values():
            kvpaged.with_table(layer, self._host_tables)
        self._tables_dirty = False

    def _last_pos(self, req: Request, k: int) -> int:
        """Highest position the request can ever write: at least the replay
        append at ``len - 1`` (the loop decodes once even for
        ``max_new_tokens <= 0``), at most ``max_seq - 2`` (``run``'s stop),
        plus burst headroom ``k``: a speculative round writes up to K
        positions past the committed one (at most ``max_seq - 1``)."""
        length = len(req.prompt)
        last = min(max(length - 1, length - 2 + req.max_new_tokens), self.max_seq - 2)
        return min(last + k, self.max_seq - 1)

    def _map_slot_blocks(self, slot_id: int, req: Request) -> bool:
        """Map blocks covering positions ``[0, len(prompt) - 1]`` for a slot and
        RESERVE its decode growth (the blocks its appends will cross into,
        plus one copy-on-write split if its write block is shared), so an
        admitted request never fails mid-decode.

        A block whose occupied rows are identical to a block another slot
        maps (a shared prefix, block-aligned) maps the SAME physical block
        with a bumped refcount.  Returns False, touching nothing, when the
        pool cannot cover prompt + growth.
        """
        blk = self._kv_blk
        prompt = req.prompt
        w_new = len(prompt) - 1                   # head rows written at admission
        tb_first = w_new // blk                   # block the replay append hits
        tb_last = self._last_pos(req, self._k_live) // blk
        donor, common = None, 0
        if self.share_prefix:
            for other, slot in enumerate(self.slots):
                if other == slot_id or slot.free:
                    continue
                lcp = 0
                for a, b in zip(prompt, slot.req.prompt):
                    if a != b:
                        break
                    lcp += 1
                if lcp > common:
                    donor, common = other, lcp
        plan: list[tuple[int, int | None]] = []  # (logical block, donor's block id)
        n_fresh = 0
        for j in range(tb_first + 1):
            end_new = min(w_new, (j + 1) * blk)
            src = None
            if donor is not None and self._host_tables[donor, j] >= 0:
                w_d = self.slots[donor].pos
                # same occupancy, inside the common prefix: the donor's bytes
                # ARE this slot's bytes
                if min(w_d, (j + 1) * blk) == end_new and end_new <= common:
                    src = int(self._host_tables[donor, j])
            plan.append((j, src))
            n_fresh += src is None
        growth = (tb_last - tb_first) + (plan[tb_first][1] is not None)
        if self.pool.available < n_fresh + growth:
            return False
        row = self._host_tables[slot_id]
        shared: set[int] = set()
        for j, src in plan:
            if src is not None:
                row[j] = self.pool.incref(src)
                shared.add(j)
            else:
                row[j] = self.pool.alloc()
        self.pool.reserve(growth)
        self._reserved[slot_id] = growth
        self._shared_blocks[slot_id] = shared
        self._tables_dirty = True
        return True

    def _grow_alloc(self, slot_id: int) -> int:
        """Allocate one block against ``slot_id``'s admission-time reservation."""
        n = self._reserved.get(slot_id, 0)
        if n > 0:
            self.pool.unreserve(1)
            self._reserved[slot_id] = n - 1
        return self.pool.alloc()

    def _cow_payer(self, slot_id: int, tb: int, bid: int) -> int:
        """The slot whose reservation pays for ``slot_id`` splitting shared block ``bid``.

        The split was reserved by the slots that mapped ``bid`` from a donor.
        If ``slot_id`` is one of them it pays; if it allocated ``bid`` itself,
        the sharer processed last pays, since it keeps ``bid`` once the others
        split and so needs no split of its own.
        """
        if tb in self._shared_blocks.get(slot_id, ()):
            return slot_id
        sharers = [j for j in range(self.max_slots)
                   if j != slot_id and (self._host_tables[j] == bid).any()]
        keeper = max(sharers)
        col = int(np.flatnonzero(self._host_tables[keeper] == bid)[0])
        self._shared_blocks[keeper].discard(col)
        return keeper

    def _ensure_append_blocks(self, active: list[int], span: int = 1) -> None:
        """Before a decode step, every block an active slot can write this
        step, positions ``[pos, pos + span - 1]`` (``span = K_eff + 1`` under
        speculation), must be mapped (allocate at a block boundary) and owned
        by that slot alone (copy a shared block first: copy-on-write)."""
        cow_src, cow_dst = [], []
        for i in active:
            pos = self.slots[i].pos
            last = min(pos + span - 1, self.max_seq - 1)
            for tb in range(pos // self._kv_blk, last // self._kv_blk + 1):
                bid = int(self._host_tables[i, tb])
                if bid < 0:
                    self._host_tables[i, tb] = self._grow_alloc(i)
                    self._tables_dirty = True
                elif self.pool.refcount(bid) > 1:
                    fresh = self._grow_alloc(self._cow_payer(i, tb, bid))
                    self.pool.cow_copies += 1
                    self.pool.decref(bid)
                    self._host_tables[i, tb] = fresh
                    cow_src.append(bid)
                    cow_dst.append(fresh)
                    self._tables_dirty = True
        if cow_src:
            for layer in self.state:
                kvpaged.copy_blocks(layer, cow_src, cow_dst)
        self._push_tables()

    def _free_slot_blocks(self, slot_id: int) -> None:
        for bid in self._host_tables[slot_id]:
            if bid >= 0:
                self.pool.decref(int(bid))
        self._host_tables[slot_id] = -1
        self.pool.unreserve(self._reserved.pop(slot_id, 0))
        self._shared_blocks.pop(slot_id, None)
        self._tables_dirty = True

    def _required_growth(self, slot_id: int, k: int) -> int:
        """Blocks an active slot still needs reserved to finish under burst
        headroom ``k``: unmapped blocks in its remaining write span, plus one
        split per block there that it maps from a donor and that is still
        shared."""
        slot = self.slots[slot_id]
        blk = self._kv_blk
        shared = self._shared_blocks.get(slot_id, set())
        need = 0
        for tb in range(slot.pos // blk, self._last_pos(slot.req, k) // blk + 1):
            bid = int(self._host_tables[slot_id, tb])
            if bid < 0 or (tb in shared and self.pool.refcount(bid) > 1):
                need += 1
        return need

    def _row_tables(self, with_head: list[tuple[int, list[int]]], pad: int) -> np.ndarray:
        """Physical write destination per (prefill row, logical block); -1 skips
        the write (pad blocks past the head, and shared blocks whose bytes a
        donor already holds or writes in this very batch)."""
        blk = self._kv_blk
        npb = -(-pad // blk)
        out = np.full((len(with_head), npb), -1, np.int32)
        for r, (slot_id, head) in enumerate(with_head):
            shared = self._shared_blocks.get(slot_id, set())
            for j in range(min(npb, -(-len(head) // blk))):
                if j not in shared:
                    out[r, j] = self._host_tables[slot_id, j]
        return out

    def _insert_rows_paged(self, with_head, st_new, lengths, pad: int) -> None:
        row_tables = self._row_tables(with_head, pad)
        for layer, new in zip(self.state, st_new):
            kvpaged.insert_prefill_rows(layer, row_tables, new["k"], new["v"],
                                        valid_len=lengths)

    def _release_slot(self, slot_id: int) -> None:
        if self.paged:
            self._free_slot_blocks(slot_id)
        self.slots[slot_id] = _Slot()
        self._pending_token.pop(slot_id, None)

    # -- admission ---------------------------------------------------------
    def _admit(self, assignments: list[tuple[int, Request]]) -> list[Request]:
        """Admit requests into free slots; one padded prefill for the batch.

        Returns the requests the paged pool could not cover, for the caller
        to requeue.
        """
        with_head: list[tuple[int, list[int]]] = []
        rejected: list[Request] = []
        for slot_id, req in assignments:
            if not 1 <= len(req.prompt) < self.max_seq:
                raise ValueError(f"request {req.uid}: prompt length {len(req.prompt)} "
                                 f"must be in [1, {self.max_seq})")
            slot = self.slots[slot_id]
            slot.req, slot.generated = req, []
            slot.pos = len(req.prompt) - 1
            if self.paged and not self._map_slot_blocks(slot_id, req):
                self.slots[slot_id] = _Slot()
                rejected.append(req)
                continue
            self._pending_token[slot_id] = req.prompt[-1]   # replayed next step
            if len(req.prompt) > 1:
                with_head.append((slot_id, req.prompt[:-1]))
        if self.paged:
            self._push_tables()
        if not with_head:
            return rejected
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
        if self.paged:
            self._insert_rows_paged(with_head, st, lengths, pad)
        else:
            self.state = kvcache.insert_state_rows(self.state, [s for s, _ in with_head], st,
                                                   lengths)
        self._counts["admissions"] += 1
        self._counts["prefill_tokens"] += sum(len(h) for _, h in with_head)
        return rejected

    # -- decode ------------------------------------------------------------
    def _decode(self, tokens_h: np.ndarray, pos_h: np.ndarray) -> np.ndarray:
        """One lockstep step over every slot; ONE (B,) int32 transfer to the host."""
        logits, self.state = self.api.decode_step(
            self.params, self.cfg, self.state, torch.tensor(tokens_h, device=self.device),
            torch.tensor(pos_h, device=self.device), impl=self.impl)
        return self._sample(logits[:, -1]).cpu().numpy()

    # -- speculative decode ------------------------------------------------
    def _burst_len(self, active: list[int]) -> int:
        """Burst K of this round: the live K, shrunk so no slot's burst writes
        past ``max_seq - 1`` (active slots sit at ``pos <= max_seq - 2``, so
        it is >= 1 whenever speculation is on)."""
        max_pos = max(self.slots[i].pos for i in active)
        return max(min(self._k_live, self.max_seq - 1 - max_pos), 0)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature > 0.0:
            return sample(logits, self._gen, temperature=self.temperature, top_k=self.top_k,
                          top_p=self.top_p)
        return sample(logits)

    def _spec_step(self, active: list[int], tokens_h: np.ndarray, pos_h: np.ndarray,
                   k: int) -> dict[int, list[int]]:
        """One round: snapshot -> K draft ``decode_step``s -> restore ->
        ``decode_verify`` -> ``accept_tokens`` -> ``commit_state``.  Every slot
        steps, idle ones at their last token and position as in the JAX
        engine.  ONE host transfer: the accepted counts and the (B, K+1)
        tokens.  Returns each active slot's emitted tokens (1..K+1: the
        accepted draft prefix and the bonus token)."""
        tokens = torch.tensor(tokens_h, device=self.device)
        pos = torch.tensor(pos_h, device=self.device)
        saved = spec_loop.snapshot_state(self.state, pos, k) if self._quant_state else None
        tok, d_toks, d_logits = tokens, [], []
        for j in range(k):
            logits, self.state = self.api.decode_step(self.draft_params, self.cfg, self.state,
                                                      tok, pos + j, impl=self.impl)
            t = self._sample(logits[:, -1])
            d_toks.append(t)
            if self.temperature > 0.0:
                d_logits.append(logits[:, -1])
            tok = t[:, None]
        d_toks = torch.stack(d_toks, dim=1)                                  # (B, K)
        if saved is not None:
            spec_loop.restore_state(self.state, saved, pos, k)
        burst = torch.cat([tokens, d_toks], dim=1)                           # (B, K+1)
        logits, self.state, burst_kv = self.api.decode_verify(self.params, self.cfg, self.state,
                                                              burst, pos, impl=self.impl)
        acc, out = spec_loop.accept_tokens(
            logits, d_toks, torch.stack(d_logits, dim=1) if d_logits else None, self._gen,
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p)
        if saved is not None:
            spec_loop.commit_state(self.state, saved, pos, acc, burst_kv, k, impl=self.impl)
        host = torch.cat([acc[:, None], out], dim=1).cpu().numpy()           # the transfer
        self._counts["spec_steps"] += 1
        emitted = {}
        for i in active:
            a = int(host[i, 0])
            emitted[i] = [int(t) for t in host[i, 1:a + 2]]
            self._counts["spec_proposed"] += k
            self._counts["spec_accepted"] += a
        return emitted

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
                rejected = self._admit([(i, self._queue.pop(0))
                                        for i in free[: len(self._queue)]])
                # paged backpressure: what the pool could not cover waits at
                # the head of the queue for completions to free blocks
                self._queue[:0] = rejected
                if rejected and not self._active():
                    raise RuntimeError(
                        f"request needs more KV blocks than the whole pool holds "
                        f"({self.pool.num_blocks}); raise pool_blocks")
            act = self._active()
            k_eff = self._burst_len(act) if self._k_live else 0
            if self.paged:
                # map and copy-on-write every block the round can write
                self._ensure_append_blocks(act, span=k_eff + 1)
            for i in act:
                s = self.slots[i]
                tokens_h[i, 0] = self._pending_token.get(
                    i, s.generated[-1] if s.generated else 0)
                pos_h[i] = s.pos
            t0 = time.perf_counter()
            if k_eff > 0:
                emitted = self._spec_step(act, tokens_h, pos_h, k_eff)
            else:
                toks = self._decode(tokens_h, pos_h)
                emitted = {i: [int(toks[i])] for i in act}
            self._step_s.append(time.perf_counter() - t0)
            self._counts["decode_steps"] += 1
            for i in act:
                s = self.slots[i]
                self._pending_token.pop(i, None)
                for tok in emitted[i]:
                    s.generated.append(tok)
                    s.pos += 1
                    if (tok == s.req.eos_id or len(s.generated) >= s.req.max_new_tokens
                            or s.pos >= self.max_seq - 1):
                        # a burst stops at its first terminal token: the rest
                        # is dropped and the slot frees this very step
                        results[s.req.uid] = list(s.generated)
                        self._release_slot(i)
                        self._counts["completed"] += 1
                        break
            if self._debug_invariants:
                self.check_invariants()
        return results

    def _active(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.free]

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 16) -> list[list[int]]:
        reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new_tokens)
                for i, p in enumerate(prompts)]
        out = self.run(reqs)
        return [out[i] for i in range(len(prompts))]

    # -- debug invariants ----------------------------------------------------
    def check_invariants(self) -> None:
        """Re-derive the paged engine's accounting from scratch and raise
        ``AssertionError`` on the first violation (after every step under
        ``debug_invariants=True``):

        * refcount conservation: every usable block's refcount equals the
          number of host-table entries mapping it, and allocated + free
          partition the pool (no leak, no double free);
        * reservation accounting: the pool's reserved total is the sum of the
          per-slot ledgers, and each active slot's ledger equals its remaining
          growth (an admitted request can always finish);
        * zero-beyond-write: in the block holding an active slot's last
          written row, every row past the write offset holds zero levels, so
          a freed block's previous occupant cannot leak into a later request.
        """
        if not self.paged:
            return
        pool = self.pool
        refs = np.zeros(pool.num_blocks + 1, np.int64)
        for row in self._host_tables:
            for bid in row[row >= 0]:
                refs[int(bid)] += 1
        for bid in range(1, pool.num_blocks + 1):
            if pool.refcount(bid) != refs[bid]:
                raise AssertionError(f"block {bid}: pool refcount {pool.refcount(bid)} != "
                                     f"{refs[bid]} host-table mappings (leak or double free)")
        mapped = int((refs[1:] > 0).sum())
        if pool.allocated != mapped:
            raise AssertionError(f"pool accounts {pool.allocated} allocated blocks but the "
                                 f"tables map {mapped}")
        if pool.allocated + pool.free_count != pool.num_blocks:
            raise AssertionError(f"allocated {pool.allocated} + free {pool.free_count} != "
                                 f"pool size {pool.num_blocks}")
        ledger = sum(self._reserved.values())
        if pool.reserved != ledger:
            raise AssertionError(f"pool reserves {pool.reserved} blocks but per-slot ledgers "
                                 f"sum to {ledger}")
        blk = self._kv_blk
        layer = self.state[0]
        for i, s in enumerate(self.slots):
            if s.free:
                if self._reserved.get(i, 0):
                    raise AssertionError(f"free slot {i} still holds a growth reservation "
                                         f"({self._reserved[i]} blocks)")
                continue
            need = self._required_growth(i, self._k_live)
            if self._reserved.get(i, 0) != need:
                raise AssertionError(f"slot {i} (uid {s.req.uid}): reserved "
                                     f"{self._reserved.get(i, 0)} blocks but needs {need}")
            off = s.pos % blk
            if s.pos == 0 or off == 0:
                continue  # the last write filled its block exactly
            bid = int(self._host_tables[i, (s.pos - 1) // blk])
            if bid < 0 or pool.refcount(bid) > 1:
                continue  # shared blocks hold a donor's bytes, not this slot's
            for side in (layer.k_packed, layer.v_packed):   # one layer is probe enough
                if bool(side[bid, :, off:].any()):
                    raise AssertionError(f"slot {i} block {bid}: non-zero levels beyond write "
                                         f"offset {off} (stale bytes would leak)")

    def stats(self) -> dict:
        """Engine counters, the median decode step time (a whole round under
        speculation), the process-wide kernel launch and plain-call counts,
        the speculation counters and, when paged, the pool's.  ``admissions``
        counts batched prefill calls; ``spec_proposed``/``spec_accepted`` sum
        K and the accepted draft tokens over the active slots of each round."""
        median = statistics.median(self._step_s) if self._step_s else None
        out = {**self._counts, "decode_step_median_s": median,
               "launches": dict(kernels.LAUNCHES), "plain_calls": dict(kernels.PLAIN_CALLS),
               "draft_bits": dict(self.draft_bits), "speculate_live_k": self._k_live}
        if self.paged:
            out.update(pool_allocated=self.pool.allocated,
                       pool_peak_allocated=self.pool.peak_allocated,
                       cow_copies=self.pool.cow_copies, shared_maps=self.pool.shared_maps)
        return out

    def weight_container_bytes(self) -> int:
        """Device bytes the packed weights occupy (quantized leaves only)."""
        return sum(leaf.container_bytes() for _, leaf in qapply._walk(self.params)
                   if hasattr(leaf, "container_bytes"))

    def state_container_bytes(self) -> int:
        """Device bytes the decode state occupies (dense containers, or the whole pool)."""
        return sum(layer.container_bytes() if hasattr(layer, "container_bytes")
                   else sum(t.numel() * t.element_size() for t in layer.values())
                   for layer in self.state)

    def allocated_state_bytes(self, *, peak: bool = True) -> int:
        """Paged: bytes of the live blocks (the peak by default), what a state
        budget prices.  Dense: the whole container (every slot pre-pays
        ``max_seq``)."""
        if not self.paged:
            return self.state_container_bytes()
        n = self.pool.peak_allocated if peak else self.pool.allocated
        return sum(layer.allocated_bytes(n) for layer in self.state)
