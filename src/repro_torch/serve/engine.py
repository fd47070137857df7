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
  * ``prefill_chunk=C`` admits a prompt in the PREFILLING state and
    prefills its head in ``C``-token chunks interleaved with decode turns
    under a per-step token budget (``serve/scheduler.py``): decode slots are
    charged first, so a long prompt no longer stalls them for a whole
    prefill.  The chunks carry fp K/V scratch; the live cache is written
    once, at the final insert, so the tokens equal the whole-prompt ones.
  * Every request runs a lifecycle (``serve/lifecycle.py``): QUEUED ->
    PREFILL -> DECODE -> DONE, CANCELLED (``cancel``) or TIMED_OUT
    (``Request.deadline_s`` / ``ttft_budget_s``), finalized exactly once.
    ``submit(req, on_token=)`` streams each committed token to a callback
    and to the ``poll()`` ring; ``metrics`` holds the TTFT (first committed
    token) and inter-token histograms.

Left for later slices: the shed ladder, preemption, fault injection, the
engine's spans, NaN quarantine and the v5 kernel configs.
"""
from __future__ import annotations

import collections
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
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.quant import apply as qapply
from repro_torch.spec import loop as spec_loop
from repro_torch.spec.draft import build_draft_params
from .lifecycle import TERMINAL_STATES, LifecycleError, RequestLifecycle, RequestState
from .sampling import sample
from .scheduler import ChunkScheduler, SchedulerConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int = -1              # -1: never stop early
    deadline_s: float | None = None      # end-to-end budget from submission
    ttft_budget_s: float | None = None   # first-token budget from submission


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    pos: int = 0                  # next write position (chunked prefill:
                                  # head tokens prefilled so far)
    generated: list[int] = dataclasses.field(default_factory=list)
    #: monotonic time of the last committed token (inter-token latency)
    last_token_t: float | None = None
    #: mid-chunked-prefill: excluded from the decode dispatch, and (paged)
    #: its device table row is masked to -1 until the final insert
    prefilling: bool = False

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
                 prefill_chunk: int | None = None, step_token_budget: int | None = None,
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
        # chunked prefill: prompts admit in the PREFILLING state and prefill in
        # <= prefill_chunk pieces interleaved with decode turns under a
        # per-step token budget
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None:
            if step_token_budget is None:
                # tightest legal budget: a full decode house plus one chunk
                step_token_budget = max_slots + prefill_chunk
            self._scheduler = ChunkScheduler(SchedulerConfig(prefill_chunk, step_token_budget),
                                             max_slots)
        else:
            if step_token_budget is not None:
                raise ValueError("step_token_budget has no meaning without prefill_chunk "
                                 "(chunked prefill disabled)")
            self._scheduler = None
        #: slot -> per-layer fp K/V scratch (1, S_scr, H, hd) carried across
        #: chunks; the live cache is written once, at the final insert
        self._scratch: dict[int, list] = {}
        #: streaming: uid -> on_token callback, and the poll() ring of
        #: (uid, token) committed since the last drain
        self._on_token: dict[int, object] = {}
        self._token_events: collections.deque = collections.deque(maxlen=65536)
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
        self.lifecycles: dict[int, RequestLifecycle] = {}
        self._cancel_requested: set[int] = set()
        self._counts = {"decode_steps": 0, "admissions": 0, "prefill_tokens": 0,
                        "prefill_chunks": 0, "completed": 0, "cancelled": 0, "timed_out": 0, "spec_steps": 0, "spec_proposed": 0,
                        "spec_accepted": 0}
        #: time to the first committed token and between committed tokens
        self.metrics = obs_metrics.MetricsRegistry()
        self.metrics.histogram("ttft_s")
        self.metrics.histogram("itl_s")
        self._tracer = obs_trace.get_tracer()
        #: uid -> perf_counter start of the request's current lifecycle
        #: segment (while the tracer is enabled)
        self._lc_marks: dict[int, float] = {}
        #: host seconds of each decode step (a speculative round under
        #: speculation), the token transfer included
        self._step_s: list[float] = []

    # -- paged block bookkeeping -------------------------------------------
    def _push_tables(self) -> None:
        """Copy the host block tables into the device table (shared by the layers).

        Rows of slots still mid-chunked-prefill push as -1: their mapped
        blocks hold no bytes until the final insert, and the lockstep decode
        must keep sending those slots' idle writes to the trash block.  The
        real row pushes once the prefill completes (``_finish_prefill``).
        """
        if not self._tables_dirty:
            return
        tbl = self._host_tables
        masked = [i for i, s in enumerate(self.slots) if s.prefilling]
        if masked:
            tbl = tbl.copy()
            tbl[masked] = -1
        for layer in {id(layer.block_table): layer for layer in self.state}.values():
            kvpaged.with_table(layer, tbl)
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
                # a prefilling slot cannot donate: its blocks hold no bytes
                # until the final insert
                if other == slot_id or slot.free or slot.prefilling:
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

    def _map_chunked_blocks(self, slot_id: int, req: Request) -> bool:
        """Reserve a chunked admission's whole block need upfront; map nothing yet.

        A chunked slot takes no shared-prefix donor (its bytes land only at
        the final insert), so its whole span, head blocks plus decode growth
        plus burst headroom (``_last_pos``), is a plain reservation.  Each
        chunk then maps the blocks it filled through ``_grow_alloc``, which
        keeps ``_reserved[slot] == _required_growth(slot, k)`` at every
        progress point.  Returns False, touching nothing, when the pool
        cannot cover the span.
        """
        total = self._last_pos(req, self._k_live) // self._kv_blk + 1
        if self.pool.available < total:
            return False
        self.pool.reserve(total)
        self._reserved[slot_id] = total
        self._shared_blocks[slot_id] = set()
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

    # -- lifecycle bookkeeping (serve/lifecycle.py) --------------------------
    def _observe_transition(self, lc: RequestLifecycle, old: RequestState,
                            new: RequestState, now: float, diagnostic: str) -> None:
        """Lifecycle observer: with the tracer enabled, close the span of the
        segment that just ended on the request's own track and mark terminal
        states with an instant; keyed off the same validated transitions the
        resource accounting uses."""
        tr = self._tracer
        if not tr.enabled:
            self._lc_marks.pop(lc.uid, None)
            return
        t = time.perf_counter()
        track = f"req/{lc.uid}"
        t0 = self._lc_marks.pop(lc.uid, None)
        if t0 is not None:
            tr.complete(old.value, ts=t0, dur=t - t0, cat="request", track=track,
                        args={"uid": lc.uid})
        if new in TERMINAL_STATES:
            tr.instant(new.value, cat="request", track=track,
                       args={"uid": lc.uid, "diagnostic": diagnostic or lc.diagnostic})
        else:
            if new is RequestState.QUEUED:   # admission rollback
                tr.instant("requeued", cat="request", track=track,
                           args={"uid": lc.uid, "diagnostic": diagnostic})
            self._lc_marks[lc.uid] = t

    def submit(self, req: Request, on_token=None) -> RequestLifecycle:
        """Enqueue a request (usable mid-``run`` from a step hook) and create
        its lifecycle record; admission is FIFO.

        ``on_token(uid, token)``: an optional streaming callback, fired for
        every token the moment it commits (a speculative burst's tokens one
        by one, in order).  Tokens also land in the ``poll()`` ring.
        """
        existing = self.lifecycles.get(req.uid)
        if existing is not None and not existing.terminal:
            raise LifecycleError(f"request uid {req.uid} is already live "
                                 f"({existing.state.value})")
        lc = RequestLifecycle(uid=req.uid, deadline_s=req.deadline_s,
                              ttft_budget_s=req.ttft_budget_s, enqueued_t=time.monotonic())
        lc.observer = self._observe_transition
        tr = self._tracer
        if tr.enabled:
            self._lc_marks[req.uid] = time.perf_counter()
            tr.instant("submit", cat="request", track=f"req/{req.uid}",
                       args={"uid": req.uid, "prompt_tokens": len(req.prompt),
                             "max_new_tokens": req.max_new_tokens})
        self.lifecycles[req.uid] = lc
        if on_token is not None:
            self._on_token[req.uid] = on_token
        self._queue.append(req)
        return lc

    def poll(self):
        """Drain committed-but-unread tokens: yields ``(uid, token)`` in commit
        order.  Call between ``run()`` calls or from a step hook; the ring
        keeps the most recent 65536 events."""
        while self._token_events:
            yield self._token_events.popleft()

    def cancel(self, uid: int) -> None:
        """Request cancellation; it takes effect at the next loop turn (the
        request may complete first: cancelling a terminal request is a no-op)."""
        self._cancel_requested.add(uid)

    def _release_slot(self, slot_id: int) -> None:
        """Free a slot's compute and paged resources (no lifecycle change)."""
        if self.paged:
            self._free_slot_blocks(slot_id)
        self.slots[slot_id] = _Slot()
        self._pending_token.pop(slot_id, None)
        self._scratch.pop(slot_id, None)

    def _finalize(self, slot_id: int | None, req: Request, state: RequestState,
                  results: dict[int, list[int]], diagnostic: str = "") -> None:
        """Move a request to a terminal state and free its resources.

        The lifecycle transition is the free-exactly-once guard: a second
        finalization raises ``LifecycleError`` before any slot, block or
        reservation is touched twice.
        """
        lc = self.lifecycles.get(req.uid)
        gen = list(self.slots[slot_id].generated) if slot_id is not None else []
        if lc is not None:
            lc.transition(state, time.monotonic(), diagnostic)
            lc.tokens = lc.resume_tokens + gen
            results[req.uid] = lc.tokens
        else:
            results[req.uid] = gen
        if slot_id is not None:
            self._release_slot(slot_id)
        self._on_token.pop(req.uid, None)
        self._counts[{RequestState.DONE: "completed", RequestState.CANCELLED: "cancelled",
                      RequestState.TIMED_OUT: "timed_out"}[state]] += 1

    def _reap(self, now: float, results: dict[int, list[int]]) -> None:
        """Apply pending cancellations and deadline / TTFT expiries, queued and
        resident alike, before this turn's admission."""
        for uid in sorted(self._cancel_requested):
            lc = self.lifecycles.get(uid)
            if lc is None or lc.terminal:
                self._cancel_requested.discard(uid)
                continue
            qi = next((j for j, r in enumerate(self._queue) if r.uid == uid), None)
            if qi is not None:
                self._finalize(None, self._queue.pop(qi), RequestState.CANCELLED, results,
                               diagnostic="cancelled while queued")
            else:
                si = next((i for i, s in enumerate(self.slots)
                           if not s.free and s.req.uid == uid), None)
                if si is not None:
                    self._finalize(si, self.slots[si].req, RequestState.CANCELLED, results,
                                   diagnostic="cancelled mid-decode")
            self._cancel_requested.discard(uid)
        for j in range(len(self._queue) - 1, -1, -1):
            req = self._queue[j]
            lc = self.lifecycles.get(req.uid)
            why = lc.expired(now) if lc is not None else None
            if why is not None:
                self._finalize(None, self._queue.pop(j), RequestState.TIMED_OUT, results,
                               diagnostic=f"{why} budget exceeded while queued")
        for i, s in enumerate(self.slots):
            if s.free:
                continue
            lc = self.lifecycles.get(s.req.uid)
            why = lc.expired(now) if lc is not None else None
            if why is not None:
                self._finalize(i, s.req, RequestState.TIMED_OUT, results,
                               diagnostic=f"{why} budget exceeded mid-decode")

    # -- admission ---------------------------------------------------------
    def _admit(self, assignments: list[tuple[int, Request]]) -> list[Request]:
        """Admit requests into free slots; one padded prefill for the batch.

        Under chunked prefill a request with a head enters the PREFILLING
        state instead and prefills over later turns (``_run_chunks``).
        Returns the requests the paged pool could not cover, for the caller
        to requeue (their lifecycles go back to QUEUED).
        """
        with_head: list[tuple[int, list[int]]] = []
        rejected: list[Request] = []
        admitted: list[Request] = []
        now = time.monotonic()
        for slot_id, req in assignments:
            if not 1 <= len(req.prompt) < self.max_seq:
                raise ValueError(f"request {req.uid}: prompt length {len(req.prompt)} "
                                 f"must be in [1, {self.max_seq})")
            lc = self.lifecycles.get(req.uid)
            if lc is not None:
                lc.transition(RequestState.PREFILL, now)
            slot = self.slots[slot_id]
            slot.req, slot.generated = req, []
            w = len(req.prompt) - 1
            if self._scheduler is not None and w >= 1:
                # chunked admission: zero progress, no pending replay token
                # (that keeps the slot out of the decode dispatch); the
                # request stays in PREFILL until its final chunk inserts
                slot.pos = 0
                slot.prefilling = True
                if self.paged and not self._map_chunked_blocks(slot_id, req):
                    self.slots[slot_id] = _Slot()
                    if lc is not None:
                        lc.transition(RequestState.QUEUED, now)
                    rejected.append(req)
                    continue
                pad = min(_round_up(w, self.prefill_pad), self.max_seq)
                self._scratch[slot_id] = self.api.init_prefill_scratch(self.cfg, pad,
                                                                       device=self.device)
                continue
            slot.pos = w
            if self.paged and not self._map_slot_blocks(slot_id, req):
                self.slots[slot_id] = _Slot()
                if lc is not None:                  # pool too full: back to the queue
                    lc.transition(RequestState.QUEUED, now)
                rejected.append(req)
                continue
            admitted.append(req)
            self._pending_token[slot_id] = req.prompt[-1]   # replayed next step
            if len(req.prompt) > 1:
                with_head.append((slot_id, req.prompt[:-1]))
        if self.paged:
            self._push_tables()
        if with_head:
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
                self.state = kvcache.insert_state_rows(self.state, [s for s, _ in with_head],
                                                       st, lengths)
            self._counts["admissions"] += 1
            self._counts["prefill_tokens"] += sum(len(h) for _, h in with_head)
        now = time.monotonic()
        for req in admitted:
            lc = self.lifecycles.get(req.uid)
            if lc is not None:
                lc.transition(RequestState.DECODE, now)
        return rejected

    # -- chunked prefill -----------------------------------------------------
    def _run_chunks(self, n_decode: int) -> None:
        """Run this turn's budgeted prefill chunks (planned by the scheduler).

        Each chunk is one ``prefill_chunk`` call of ``C`` tokens (the last
        one padded) that carries the slot's fp K/V scratch; the live cache
        is written only at the final insert, through the same insert path
        and valid-length masking as a whole-prompt admission.
        """
        prefilling = [(i, len(s.req.prompt) - 1 - s.pos) for i, s in enumerate(self.slots)
                      if not s.free and s.prefilling]
        plan = self._scheduler.plan(self._counts["decode_steps"], n_decode, prefilling)
        blk = self._kv_blk if self.paged else 0
        for slot_id, n in plan:
            s = self.slots[slot_id]
            req = s.req
            w = len(req.prompt) - 1
            p = s.pos
            toks = np.zeros((1, self.prefill_chunk), np.int32)
            toks[0, :n] = req.prompt[p:p + n]
            self._scratch[slot_id] = self.api.prefill_chunk(
                self.params, self.cfg, self._scratch[slot_id],
                torch.tensor(toks, device=self.device), p, impl=self.impl)
            s.pos = p + n
            self._counts["prefill_tokens"] += n
            self._counts["prefill_chunks"] += 1
            lc = self.lifecycles.get(req.uid)
            if lc is not None:
                lc.prefill_progress = s.pos
            if self.paged:
                # map the blocks this chunk filled against the admission's
                # reservation; the partial block stays unmapped, so the ledger
                # keeps matching _required_growth
                for tb in range(p // blk, s.pos // blk):
                    self._host_tables[slot_id, tb] = self._grow_alloc(slot_id)
            if s.pos >= w:
                self._finish_prefill(slot_id, self._scratch[slot_id])

    def _finish_prefill(self, slot_id: int, st) -> None:
        """The final chunk landed: insert the carried K/V into the live cache
        and hand the slot to this turn's decode (the plan already charged its
        first decode token)."""
        s = self.slots[slot_id]
        prompt = s.req.prompt
        w = len(prompt) - 1
        lengths = torch.tensor([w], dtype=torch.int32, device=self.device)
        if self.paged:
            blk = self._kv_blk
            for tb in range((w - 1) // blk + 1):
                if self._host_tables[slot_id, tb] < 0:
                    self._host_tables[slot_id, tb] = self._grow_alloc(slot_id)
            pad = st[0]["k"].shape[1]            # the scratch's padded head length
            self._insert_rows_paged([(slot_id, prompt[:-1])], st, lengths, pad)
            self._tables_dirty = True      # the real row replaces the -1 mask
        else:
            self.state = kvcache.insert_state_rows(self.state, [slot_id], st, lengths)
        s.prefilling = False
        s.pos = w
        self._pending_token[slot_id] = prompt[-1]   # replayed next step
        self._scratch.pop(slot_id, None)
        lc = self.lifecycles.get(s.req.uid)
        if lc is not None:
            lc.transition(RequestState.DECODE, time.monotonic())

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
    def run(self, requests: list[Request] = (), *, step_hook=None) -> dict[int, list[int]]:
        """Continuous-batching loop until every submitted request reaches a
        terminal lifecycle state -> ``{uid: tokens}`` for every request that
        ended during this call (partial streams for CANCELLED / TIMED_OUT;
        ``lifecycles[uid]`` has the state and its diagnostic).

        ``step_hook(engine, step)`` fires once per loop turn before the reap
        and the admission (mid-run ``submit``, ``cancel`` or ``poll``).
        """
        for req in requests:
            self.submit(req)
        results: dict[int, list[int]] = {}
        self._pending_token = {}
        tokens_h = np.zeros((self.max_slots, 1), np.int32)
        pos_h = np.zeros((self.max_slots,), np.int32)
        while self._queue or self._active():
            self._turn(results, tokens_h, pos_h, step_hook)
        return results

    def _active(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.free]

    def _decode_active(self) -> list[int]:
        """Slots the decode steps this turn: active and not mid-chunked-prefill."""
        return [i for i, s in enumerate(self.slots) if not s.free and not s.prefilling]

    def _turn(self, results: dict[int, list[int]], tokens_h: np.ndarray, pos_h: np.ndarray,
              step_hook) -> None:
        """One loop turn: hook -> reap -> admission -> prefill chunks -> decode
        (or a speculative round) -> commit."""
        if step_hook is not None:
            step_hook(self, self._counts["decode_steps"])
        self._reap(time.monotonic(), results)
        free = [i for i, s in enumerate(self.slots) if s.free]
        if free and self._queue:
            rejected = self._admit([(i, self._queue.pop(0)) for i in free[: len(self._queue)]])
            # paged backpressure: what the pool could not cover waits at the
            # head of the queue for completions to free blocks
            self._queue[:0] = rejected
            if rejected and not self._active():
                raise RuntimeError(
                    f"request needs more KV blocks than the whole pool holds "
                    f"({self.pool.num_blocks}); raise pool_blocks")
        act = self._decode_active()
        if self._scheduler is not None:
            # decode slots are charged first; chunks fill the rest of the
            # per-step budget, and a slot whose final chunk lands joins this
            # very turn's decode (its first decode token was charged with it)
            self._run_chunks(len(act))
            act = self._decode_active()
        if not act:
            if self._debug_invariants:
                self.check_invariants()        # pure-prefill turns are checked too
            return
        k_eff = self._burst_len(act) if self._k_live else 0
        if self.paged:
            # map and copy-on-write every block the round can write
            self._ensure_append_blocks(act, span=k_eff + 1)
        for i in act:
            s = self.slots[i]
            tokens_h[i, 0] = self._pending_token.get(i, s.generated[-1] if s.generated else 0)
            pos_h[i] = s.pos
        t0 = time.perf_counter()
        if k_eff > 0:
            emitted = self._spec_step(act, tokens_h, pos_h, k_eff)
        else:
            toks = self._decode(tokens_h, pos_h)
            emitted = {i: [int(toks[i])] for i in act}
        self._step_s.append(time.perf_counter() - t0)
        self._counts["decode_steps"] += 1
        self._commit(act, emitted, results)
        if self._debug_invariants:
            self.check_invariants()

    def _commit(self, act: list[int], emitted: dict[int, list[int]],
                results: dict[int, list[int]]) -> None:
        """Apply one step's (or round's) tokens: record TTFT and inter-token
        gaps, stream each token, finalize completed requests."""
        now = time.monotonic()
        ttft_hist = self.metrics.histogram("ttft_s")
        itl_hist = self.metrics.histogram("itl_s")
        for i in act:
            s = self.slots[i]
            self._pending_token.pop(i, None)
            lc = self.lifecycles.get(s.req.uid)
            first_of_turn = True
            for tok in emitted[i]:
                if lc is not None and lc.first_token_t is None:
                    # TTFT is the first COMMITTED token, not a chunk landing
                    lc.first_token_t = now
                    ttft_hist.observe(now - lc.enqueued_t)
                if s.last_token_t is not None:
                    # a burst's tokens land together: only the first gap of
                    # the turn is a real inter-token wait
                    itl_hist.observe((now - s.last_token_t) if first_of_turn else 0.0)
                s.last_token_t = now
                first_of_turn = False
                s.generated.append(tok)
                s.pos += 1
                self._token_events.append((s.req.uid, tok))
                cb = self._on_token.get(s.req.uid)
                if cb is not None:
                    cb(s.req.uid, tok)
                if (tok == s.req.eos_id or len(s.generated) >= s.req.max_new_tokens
                        or s.pos >= self.max_seq - 1):
                    # a burst stops at its first terminal token: the rest is
                    # dropped and the slot frees this very step
                    self._finalize(i, s.req, RequestState.DONE, results)
                    break

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
        K and the accepted draft tokens over the active slots of each round.
        Under chunked prefill ``scheduler`` sums the planner's records;
        ``latency`` summarizes the TTFT and inter-token histograms."""
        median = statistics.median(self._step_s) if self._step_s else None
        out = {**self._counts, "decode_step_median_s": median,
               "launches": dict(kernels.LAUNCHES), "plain_calls": dict(kernels.PLAIN_CALLS),
               "draft_bits": dict(self.draft_bits), "speculate_live_k": self._k_live}
        if self._scheduler is not None:
            recs = self._scheduler.records
            out["scheduler"] = {
                "prefill_chunk": self.prefill_chunk,
                "step_token_budget": self._scheduler.cfg.step_token_budget,
                "planned_turns": len(recs),
                "chunk_tokens": sum(r.chunk_tokens for r in recs),
                "max_step_tokens": max((r.decode_tokens + r.chunk_tokens + r.finish_tokens
                                        for r in recs), default=0),
            }
        for name in ("ttft_s", "itl_s"):
            hist = self.metrics.histogram(name)
            if hist.count:
                out.setdefault("latency", {})[name] = hist.summary()
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
