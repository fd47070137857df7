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
    The burst K is the live K of the shed ladder (below), shrunk near
    ``max_seq``.
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
    and to the ``poll()`` ring; ``metrics`` holds the counters behind
    ``stats()``, the loop-turn time and the TTFT (first committed token) and
    inter-token histograms.
  * Admission is priority-first, FIFO within a priority class.  Under pool
    pressure the engine walks a shed ladder (``ShedPolicy``): the live
    speculation K steps down (K -> K//2 -> ... -> 0), releasing the bursts'
    block reservations, and then the lowest-priority resident strictly below
    the best waiting priority is preempted: its generated tokens ride back to
    the queue as prompt suffix (``RequestLifecycle.resume_tokens``).  A
    pressure-free turn climbs back one tier; a dispatch slower than 3 x the
    rolling median (``StragglerMonitor``) sheds one tier, never below K 1.
  * Non-finite logits are flagged per slot on the device, in the step that
    samples them, and the flags come back in the tokens' own transfer: a
    poisoned slot samples from zeroed logits and only its request FAILS; a
    poisoned draft falls back to the verify token for that slot.  A
    ``FailureInjector`` drives these paths and the other serve fault sites.
  * With the process tracer enabled, every loop turn records a ``step`` span
    split into named phases and every request its lifecycle spans;
    ``trace_report()`` decomposes the traced step time, ``measured_costs()``
    feeds the calibration ratios ``stats()`` reports against an artifact's
    predicted costs.  Tracing adds no synchronization and changes no token.

  * An artifact's v5 ``kernel_configs`` (``kernels/autotune.py``) are
    validated against the built cache's geometry and installed before the
    first step; the fused decode step replays them.
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
from repro_torch.obs import calibration as obs_calibration
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.quant import apply as qapply
from repro_torch.runtime.resilience import FailureInjector, StepTimer, StragglerMonitor
from repro_torch.spec import loop as spec_loop
from repro_torch.spec.draft import build_draft_params
from .lifecycle import (TERMINAL_STATES, LifecycleError, RequestLifecycle, RequestState,
                        ShedPolicy, spec_ladder)
from .sampling import sample
from .scheduler import ChunkScheduler, SchedulerConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int = -1              # -1: never stop early
    priority: int = 0             # higher admits first / preempts lower
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


#: integer counters ``stats()`` exposes (``wall_s`` rides as a float counter
#: beside them); ``admissions`` counts batched prefill calls
_COUNTER_KEYS = ("prefill_tokens", "prefill_chunks", "decode_steps", "loop_turns",
                 "admissions", "completed", "spec_steps", "spec_proposed", "spec_accepted",
                 "preemptions", "failed", "cancelled", "timed_out", "nan_quarantined",
                 "nan_draft_fallbacks")

#: step-phase span names in loop order; ``hook`` only with a ``step_hook``,
#: ``prefill_chunk`` only under chunked prefill
_PHASE_NAMES = ("hook", "reap", "admission", "prefill_chunk", "prep", "dispatch",
                "device_sync", "commit", "bookkeeping")


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
                 state_dtype=torch.float32, batch_admission: bool = True,
                 fuse_projections: bool = True, state_bits=None,
                 kv_block: int | None = None, paged: bool = False, pool_blocks: int | None = None,
                 share_prefix: bool = True, speculate: int | None = None, draft_policy=None,
                 artifact: PolicyArtifact | None = None,
                 shed: ShedPolicy | None = ShedPolicy(),
                 fault_injector: FailureInjector | None = None, debug_invariants: bool = False,
                 prefill_chunk: int | None = None, step_token_budget: int | None = None,
                 device=None):
        if cfg.family in ("audio", "encdec"):
            raise NotImplementedError(
                "enc-dec serving goes through registry.prefill/decode_step directly "
                "(cross-attention KV needs the frames input at admission)")
        self.device = resolve_device(device)
        leaf = _first_tensor(params)
        if leaf is not None and leaf.device.type != self.device.type:
            raise ValueError(f"params lie on {leaf.device} but the engine serves on "
                             f"{self.device}")
        self.cfg = cfg
        self.api = registry.get_api(cfg)
        self._injector = fault_injector
        # the policy this engine claims to serve: refuse packed bits that differ
        self.artifact = artifact
        self.packed_bits = qapply.packed_policy_bits(params)
        if artifact is not None:
            if self._fault("artifact_mismatch", step=0):
                # the deploy-time refusal itself, with one leaf's bits tampered
                name = next(iter(self.packed_bits), None)
                raise ValueError(f"packed leaf bitwidths disagree with the policy artifact "
                                 f"(injected artifact_mismatch fault): {name}=-1")
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
                                          f"decode state has no burst-rewindable KV form "
                                          f"(DESIGN.md §13)")
            # the draft derives from the UNFUSED tree, so a heterogeneous draft
            # policy never splits a fused leaf; equal-bit groups fuse after
            draft, self.draft_bits = build_draft_params(params, draft_policy, cfg)
            self.draft_params = qapply.fuse_projections(draft) if fuse_projections else draft
        # graceful degradation: the live burst K walks the shed ladder under
        # pool pressure; tier 0 is full service
        self._shed_policy = shed
        self._spec_ladder = spec_ladder(self.speculate)
        self._shed_tier = 0
        self._k_live = self.speculate
        self._straggler = StragglerMonitor()
        self._shed_events: list[dict] = []
        self.batch_admission = batch_admission
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
        #: slot -> its padded prompt head (1, pad) while it prefills in chunks;
        #: a family without ``prefill_chunk`` re-prefills it each chunk
        self._chunk_head: dict[int, np.ndarray] = {}
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
        # autotuned fused decode-step configs (v5): validated against this
        # deployment's cache geometry and installed process-wide before the
        # first step, so serving replays the searched launches
        self._install_kernel_configs()
        #: quantized layers need the burst snapshot/replay commit; fp ones do
        #: not.  As in the JAX engine, only a list state (the decoder
        #: families') counts: a hybrid's dict state never does, so its
        #: measured_costs() carry no state_bytes
        self._quant_state = any(isinstance(layer, (kvcache.QuantizedKVLayer,
                                                   kvcache.PagedKVLayer))
                                for layer in (self.state if isinstance(self.state, list)
                                              else []))
        self.slots = [_Slot() for _ in range(max_slots)]
        self._queue: list[Request] = []
        self._pending_token: dict[int, int] = {}
        self.lifecycles: dict[int, RequestLifecycle] = {}
        self._cancel_requested: set[int] = set()
        # the metrics registry is the source of truth behind stats(): the
        # counters, the whole loop turn's time, the time to the first
        # committed token and between committed tokens
        self.metrics = obs_metrics.MetricsRegistry()
        for name in _COUNTER_KEYS:
            self.metrics.counter(name)
        self.metrics.counter("wall_s")
        self.metrics.histogram("step_time_s")
        self.metrics.histogram("ttft_s")
        self.metrics.histogram("itl_s")
        self._tracer = obs_trace.get_tracer()
        #: uid -> perf_counter start of the request's current lifecycle
        #: segment (while the tracer is enabled)
        self._lc_marks: dict[int, float] = {}
        #: host seconds of each decode step (a speculative round under
        #: speculation), the token transfer included
        self._step_s: list[float] = []

    # -- autotuned kernel configs --------------------------------------------
    def _install_kernel_configs(self) -> None:
        """Replay a v5 artifact's autotuned fused decode-step configs.

        Every recorded candidate is bitwise equivalent, so a wrong table can
        only cost speed; but a table tuned for another cache geometry means
        the artifact does not describe this deployment, and a table on a
        float state has no fused quantized step to configure: both raise
        ``ArtifactError`` and install nothing.  Keys for bit pairs the
        deployed policy does not use are tolerated.
        """
        from repro_torch.checkpoint.store import ArtifactError
        from repro_torch.kernels import autotune

        entries = self.artifact.kernel_configs if self.artifact is not None else None
        if not entries:
            return
        qlayers = [layer for layer in (self.state if isinstance(self.state, list) else [])
                   if isinstance(layer, (kvcache.QuantizedKVLayer, kvcache.PagedKVLayer))]
        if not qlayers:
            raise ArtifactError("policy artifact carries kernel_configs but the engine built "
                                "a float decode state (no fused quantized decode step exists "
                                "to configure)")
        lyr = qlayers[0]
        try:
            autotune.validate_configs(entries, heads=lyr.shape[2], head_dim=lyr.shape[3],
                                      block=lyr.block,
                                      bit_pairs={(q.k_bits, q.v_bits) for q in qlayers})
        except ValueError as e:
            raise ArtifactError(f"policy artifact kernel_configs do not fit this "
                                f"deployment: {e}") from e
        autotune.set_active_configs(entries)
        # the replayed configs land in the trace beside the step times, so a
        # timeline shows which searched launch each step ran
        tr = obs_trace.get_tracer()
        if tr.enabled:
            for e in entries:
                tr.instant("kernel_config_replayed", cat="kernel", track="kernel",
                           args=dict(e))

    # -- observability ---------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        self.metrics.counter(name).inc(n)

    def _nsteps(self) -> int:
        return int(self.metrics.counter("decode_steps").value)

    def _span(self, name: str, **args):
        """A step-phase span: a trace event and a ``phase/<name>`` histogram
        sample while the tracer is enabled, the shared no-op span otherwise."""
        tr = self._tracer
        if not tr.enabled:
            return obs_trace.NOOP_SPAN
        return tr.span(name, cat="phase", track="engine",
                       hist=self.metrics.histogram("phase/" + name), args=args or None)

    # -- fault injection (runtime/resilience.py) -------------------------------
    def _fault(self, site: str, step: int | None = None) -> bool:
        """Consume-once poll of the injector at a serve fault site."""
        if self._injector is None:
            return False
        return self._injector.fires(site, self._nsteps() if step is None else step)

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
                    self._shared_blocks.get(i, set()).discard(tb)
                    cow_src.append(bid)
                    cow_dst.append(fresh)
                    self._tables_dirty = True
        if cow_src:
            for layer in self.state:
                kvpaged.copy_blocks(layer, cow_src, cow_dst)
            self._settle_shares()
        self._push_tables()

    def _settle_shares(self) -> None:
        """A block mapped from a donor that is left with one holder needs no
        split: drop it from that holder's shared set and, if it lies in the
        holder's remaining write span, release the split's reservation.

        Only a donor that leaves before its sharers' first append (a
        preemption or an append failure between admission and dispatch), or
        a split by one of two sharers after their donor left, leaves such a
        block; completions never do, since every split of a shared write
        block happens at the step after the admission that shared it."""
        blk = self._kv_blk
        for j, shared in self._shared_blocks.items():
            for tb in sorted(shared):
                if self.pool.refcount(int(self._host_tables[j, tb])) != 1:
                    continue
                shared.discard(tb)
                s = self.slots[j]
                if (not s.free and s.pos // blk <= tb
                        <= self._last_pos(s.req, self._k_live) // blk):
                    self.pool.unreserve(1)
                    self._reserved[j] -= 1

    def _free_slot_blocks(self, slot_id: int) -> None:
        for bid in self._host_tables[slot_id]:
            if bid >= 0:
                self.pool.decref(int(bid))
        self._host_tables[slot_id] = -1
        self.pool.unreserve(self._reserved.pop(slot_id, 0))
        self._shared_blocks.pop(slot_id, None)
        self._tables_dirty = True
        self._settle_shares()

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

    # -- graceful degradation ----------------------------------------------------
    def _set_live_k(self, k: int) -> bool:
        """Change the live burst K, resyncing every active slot's growth
        reservation to the new headroom.  Shrinking always succeeds (it
        releases reservations: the point of the ladder); growing back is
        refused (False) when the pool cannot cover the larger headroom for
        every active slot, so restoring speculation never strands one."""
        if k == self._k_live:
            return True
        if self.paged:
            deltas = {i: self._required_growth(i, k) - self._reserved.get(i, 0)
                      for i, s in enumerate(self.slots) if not s.free}
            grow = sum(d for d in deltas.values() if d > 0)
            shrink = -sum(d for d in deltas.values() if d < 0)
            if grow > self.pool.available + shrink:
                return False
            for i, d in sorted(deltas.items(), key=lambda kv: kv[1]):
                if d < 0:                      # releases first: they free headroom
                    self.pool.unreserve(-d)
                elif d > 0:
                    self.pool.reserve(d)
                self._reserved[i] = self._reserved.get(i, 0) + d
        self._k_live = k
        return True

    def _shed_event(self, action: str, **extra) -> None:
        ev = {"action": action, "step": self._nsteps(), "tier": self._shed_tier,
              "k": self._k_live, **extra}
        self._shed_events.append(ev)
        self._tracer.instant("shed:" + action, cat="degradation", track="engine", args=ev)

    def _maybe_shed(self, waiting: list[Request]) -> bool:
        """ONE degradation action for this turn (True if state changed): step
        the speculation ladder down a tier, or, the ladder exhausted, preempt
        for the best waiting priority; else plain backpressure."""
        pol = self._shed_policy
        if pol is None:
            return False
        if pol.spec_tiers and self._shed_tier < len(self._spec_ladder) - 1:
            if self._set_live_k(self._spec_ladder[self._shed_tier + 1]):
                self._shed_tier += 1
                self._shed_event("spec_shed")
                return True
        return self._preempt_for(waiting)

    def _preempt_for(self, waiting: list[Request]) -> bool:
        """Preempt the lowest-priority resident strictly below the best waiting
        priority (equal priorities never thrash), under pool pressure and under
        slot pressure alike."""
        pol = self._shed_policy
        if pol is None or not pol.preempt or not waiting:
            return False
        best = max(r.priority for r in waiting)
        victims = [i for i, s in enumerate(self.slots) if not s.free and s.req.priority < best]
        if not victims:
            return False
        # lowest priority first; ties preempt the least-progressed slot
        victim = min(victims, key=lambda i: (self.slots[i].req.priority,
                                             len(self.slots[i].generated)))
        self._preempt(victim)
        return True

    def _relax_shed(self) -> None:
        """Pressure-free turn: climb back one tier if the pool can cover the
        larger burst headroom of every active slot."""
        pol = self._shed_policy
        if pol is None or not pol.restore or self._shed_tier == 0:
            return
        if self._set_live_k(self._spec_ladder[self._shed_tier - 1]):
            self._shed_tier -= 1
            self._shed_event("restore")

    def _preempt(self, slot_id: int) -> None:
        """Send a victim back to QUEUED: its prompt plus its generated tokens
        become the resumed request's prompt (replayed through the normal
        prefill and shared-prefix path), and its token budget shrinks by what
        it produced, so the resumed stream picks up where it stopped."""
        s = self.slots[slot_id]
        req = s.req
        lc = self.lifecycles.get(req.uid)
        if lc is not None:
            lc.transition(RequestState.QUEUED, time.monotonic(),
                          diagnostic="preempted under pool pressure")
            lc.preemptions += 1
            lc.resume_tokens.extend(s.generated)
            lc.prefill_progress = 0          # a mid-chunk victim restarts its prefill
        self._count("preemptions")
        self._shed_event("preempt", uid=req.uid, at_tokens=len(s.generated))
        resumed = dataclasses.replace(req, prompt=req.prompt + s.generated,
                                      max_new_tokens=req.max_new_tokens - len(s.generated))
        self._release_slot(slot_id)
        self._queue.append(resumed)

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
        t = tr.now()
        track = f"req/{lc.uid}"
        t0 = self._lc_marks.pop(lc.uid, None)
        if t0 is not None:
            tr.complete(old.value, ts=t0, dur=t - t0, cat="request", track=track,
                        args={"uid": lc.uid})
        if new in TERMINAL_STATES:
            tr.instant(new.value, cat="request", track=track,
                       args={"uid": lc.uid, "diagnostic": diagnostic or lc.diagnostic,
                             "preemptions": lc.preemptions})
        else:
            if new is RequestState.QUEUED:   # preemption or admission rollback
                tr.instant("requeued", cat="request", track=track,
                           args={"uid": lc.uid, "diagnostic": diagnostic})
            self._lc_marks[lc.uid] = t

    def submit(self, req: Request, on_token=None) -> RequestLifecycle:
        """Enqueue a request (usable mid-``run`` from a step hook) and create
        its lifecycle record; admission is priority-first, FIFO within a
        priority class.

        ``on_token(uid, token)``: an optional streaming callback, fired for
        every token the moment it commits (a speculative burst's tokens one
        by one, in order).  Tokens also land in the ``poll()`` ring.
        """
        existing = self.lifecycles.get(req.uid)
        if existing is not None and not existing.terminal:
            raise LifecycleError(f"request uid {req.uid} is already live "
                                 f"({existing.state.value})")
        lc = RequestLifecycle(uid=req.uid, priority=req.priority, deadline_s=req.deadline_s,
                              ttft_budget_s=req.ttft_budget_s, enqueued_t=time.monotonic())
        lc.observer = self._observe_transition
        tr = self._tracer
        if tr.enabled:
            self._lc_marks[req.uid] = tr.now()
            tr.instant("submit", cat="request", track=f"req/{req.uid}",
                       args={"uid": req.uid, "priority": req.priority,
                             "prompt_tokens": len(req.prompt),
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
        self._chunk_head.pop(slot_id, None)

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
        self._count({RequestState.DONE: "completed", RequestState.FAILED: "failed",
                     RequestState.CANCELLED: "cancelled",
                     RequestState.TIMED_OUT: "timed_out"}[state])

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
                head = np.zeros((1, pad), np.int32)
                head[0, :w] = req.prompt[:-1]
                self._chunk_head[slot_id] = head
                if self.api.init_prefill_scratch is not None:
                    self._scratch[slot_id] = self.api.init_prefill_scratch(self.cfg, pad,
                                                                           device=self.device)
                continue
            slot.pos = w
            if w == 0 and self.api.prefill_chunk is None:
                # a length-1 prompt runs no prefill: attention caches are
                # causally masked, but a recurrent state is not, so the slot's
                # rows zero and the request decodes from the initial state
                # instead of the previous occupant's
                self._reset_recurrent_rows(slot_id)
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
            self._count("admissions")
            self._count("prefill_tokens", sum(len(h) for _, h in with_head))
        now = time.monotonic()
        for req in admitted:
            lc = self.lifecycles.get(req.uid)
            if lc is not None:
                lc.transition(RequestState.DECODE, now)
        return rejected

    def _reset_recurrent_rows(self, slot_id: int) -> None:
        """Zero one slot's row in every plain state tensor with a leading slot
        axis; quantized and paged KV containers are left alone (attention
        masks their stale rows)."""
        def walk(node):
            if isinstance(node, (kvcache.QuantizedKVLayer, kvcache.PagedKVLayer)):
                return
            if isinstance(node, dict):
                for v in node.values():
                    walk(v)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v)
            elif isinstance(node, torch.Tensor) and node.ndim and \
                    node.shape[0] == self.max_slots:
                node[slot_id].zero_()
        walk(self.state)

    # -- chunked prefill -----------------------------------------------------
    def _run_chunks(self, n_decode: int) -> None:
        """Run this turn's budgeted prefill chunks (planned by the scheduler).

        Decoder families run one ``prefill_chunk`` call of ``C`` tokens a
        chunk (the last one padded) that carries the slot's fp K/V scratch.
        A family without it (a recurrent state, whose chunked scan cannot
        split a prefill bitwise) recomputes the prefix: the whole padded head
        prefills with ``lengths=[progress]`` each chunk and only the last
        state is kept.  Either way the live cache or state is written only at
        the final insert, through the same insert path and valid-length
        masking as a whole-prompt admission.
        """
        prefilling = [(i, len(s.req.prompt) - 1 - s.pos) for i, s in enumerate(self.slots)
                      if not s.free and s.prefilling]
        plan = self._scheduler.plan(self._nsteps(), n_decode, prefilling)
        blk = self._kv_blk if self.paged else 0
        for slot_id, n in plan:
            s = self.slots[slot_id]
            req = s.req
            w = len(req.prompt) - 1
            p = s.pos
            with self._span("prefill_chunk", uid=req.uid, offset=p, n=n):
                if self.api.prefill_chunk is not None:
                    toks = np.zeros((1, self.prefill_chunk), np.int32)
                    toks[0, :n] = req.prompt[p:p + n]
                    self._scratch[slot_id] = self.api.prefill_chunk(
                        self.params, self.cfg, self._scratch[slot_id],
                        torch.tensor(toks, device=self.device), p, impl=self.impl)
                    st = self._scratch[slot_id]
                else:
                    # lengths masks the tokens past the progress out of the
                    # state, so one head shape serves every chunk
                    _, st = self.api.prefill(
                        self.params, self.cfg,
                        torch.tensor(self._chunk_head[slot_id], device=self.device),
                        impl=self.impl, logits=False,
                        lengths=torch.tensor([p + n], dtype=torch.int32, device=self.device))
            s.pos = p + n
            self._count("prefill_tokens", n)
            self._count("prefill_chunks")
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
                self._finish_prefill(slot_id, st)

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
            pad = self._chunk_head[slot_id].shape[1]
            self._insert_rows_paged([(slot_id, prompt[:-1])], st, lengths, pad)
            self._tables_dirty = True      # the real row replaces the -1 mask
        else:
            self.state = kvcache.insert_state_rows(self.state, [slot_id], st, lengths)
        s.prefilling = False
        s.pos = w
        self._pending_token[slot_id] = prompt[-1]   # replayed next step
        self._scratch.pop(slot_id, None)
        self._chunk_head.pop(slot_id, None)
        lc = self.lifecycles.get(s.req.uid)
        if lc is not None:
            lc.transition(RequestState.DECODE, time.monotonic())

    # -- decode ------------------------------------------------------------
    def _guard(self, logits: torch.Tensor, inject: torch.Tensor | None, dims):
        """Per-slot non-finite flag over ``dims`` of ``logits`` (B, ...), and the
        logits with a flagged slot's rows zeroed, so a poisoned slot cannot
        move its neighbours' sampling.  ``inject`` is the fault injector's
        per-slot NaN needle, added only when an injector is set."""
        lead = (-1,) + (1,) * (logits.dim() - 1)
        if inject is not None:
            logits = logits + inject.reshape(lead)
        bad = ~torch.isfinite(logits).all(dim=dims)
        return torch.where(bad.reshape(lead), 0.0, logits), bad

    def _needle(self, inject: np.ndarray | None) -> torch.Tensor | None:
        return None if inject is None else torch.tensor(inject, device=self.device)

    def _decode(self, tokens_h: np.ndarray, pos_h: np.ndarray,
                inject: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
        """One lockstep step over every slot -> (tokens (B,), non-finite flags
        (B,)): ONE (B, 2) int32 transfer to the host carries both."""
        with self._span("dispatch"):
            logits, self.state = self.api.decode_step(
                self.params, self.cfg, self.state, torch.tensor(tokens_h, device=self.device),
                torch.tensor(pos_h, device=self.device), impl=self.impl)
            last, bad = self._guard(logits[:, -1], self._needle(inject), -1)
            out = torch.stack([self._sample(last), bad.to(torch.int32)], dim=1)
        with self._span("device_sync"):
            host = out.cpu().numpy()                                   # the transfer
        return host[:, 0], host[:, 1].astype(bool)

    # -- speculative decode ------------------------------------------------
    def _burst_len(self, active: list[int]) -> int:
        """Burst K of this round: the live K, shrunk so no slot's burst writes
        past ``max_seq - 1`` (active slots sit at ``pos <= max_seq - 2``, so
        it is >= 1 whenever speculation is live)."""
        max_pos = max(self.slots[i].pos for i in active)
        return max(min(self._k_live, self.max_seq - 1 - max_pos), 0)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature > 0.0:
            return sample(logits, self._gen, temperature=self.temperature, top_k=self.top_k,
                          top_p=self.top_p)
        return sample(logits)

    def _spec_step(self, active: list[int], tokens_h: np.ndarray, pos_h: np.ndarray, k: int,
                   inject_draft: np.ndarray | None = None,
                   inject_verify: np.ndarray | None = None):
        """One round: snapshot -> K draft ``decode_step``s -> restore ->
        ``decode_verify`` -> ``accept_tokens`` -> ``commit_state``.  Every slot
        steps, idle ones at their last token and position as in the JAX
        engine.  A slot whose draft logits go non-finite (sticky over the
        burst) or whose verify logits do accepts nothing: with acc 0 it emits
        the verify pass's first token, the non-speculative one.  ONE host
        transfer: the accepted counts, the (B, K+1) tokens and both flags.
        Returns each active slot's emitted tokens (1..K+1: the accepted draft
        prefix and the bonus token) and the (B,) draft and verify flags."""
        with self._span("dispatch", k=k):
            tokens = torch.tensor(tokens_h, device=self.device)
            pos = torch.tensor(pos_h, device=self.device)
            saved = spec_loop.snapshot_state(self.state, pos, k) if self._quant_state else None
            needle = self._needle(inject_draft)
            tok, d_toks, d_logits = tokens, [], []
            draft_bad = torch.zeros(tokens.shape[0], dtype=torch.bool, device=self.device)
            for j in range(k):
                logits, self.state = self.api.decode_step(self.draft_params, self.cfg,
                                                          self.state, tok, pos + j,
                                                          impl=self.impl)
                last = logits[:, -1]
                if j == 0 and needle is not None:
                    last = last + needle[:, None]
                # sticky over the burst: a poisoned slot's proposals stay finite
                draft_bad = draft_bad | ~torch.isfinite(last).all(dim=-1)
                last = torch.where(draft_bad[:, None], 0.0, last)
                t = self._sample(last)
                d_toks.append(t)
                if self.temperature > 0.0:
                    d_logits.append(last)
                tok = t[:, None]
            d_toks = torch.stack(d_toks, dim=1)                              # (B, K)
            if saved is not None:
                spec_loop.restore_state(self.state, saved, pos, k)
            burst = torch.cat([tokens, d_toks], dim=1)                       # (B, K+1)
            logits, self.state, burst_kv = self.api.decode_verify(
                self.params, self.cfg, self.state, burst, pos, impl=self.impl)
            logits, verify_bad = self._guard(logits, self._needle(inject_verify), (1, 2))
            acc, out = spec_loop.accept_tokens(
                logits, d_toks, torch.stack(d_logits, dim=1) if d_logits else None, self._gen,
                temperature=self.temperature, top_k=self.top_k, top_p=self.top_p)
            acc = torch.where(draft_bad | verify_bad, torch.zeros_like(acc), acc)
            if saved is not None:
                spec_loop.commit_state(self.state, saved, pos, acc, burst_kv, k, impl=self.impl)
            flags = torch.stack([draft_bad, verify_bad], dim=1).to(out.dtype)
            out = torch.cat([acc[:, None].to(out.dtype), out, flags], dim=1)
        with self._span("device_sync"):
            host = out.cpu().numpy()                                         # the transfer
        self._count("spec_steps")
        emitted = {}
        for i in active:
            a = int(host[i, 0])
            emitted[i] = [int(t) for t in host[i, 1:a + 2]]
            self._count("spec_proposed", k)
            self._count("spec_accepted", a)
        return emitted, host[:, -2].astype(bool), host[:, -1].astype(bool)

    # -- main loop -----------------------------------------------------------
    def run(self, requests: list[Request] = (), *, step_hook=None) -> dict[int, list[int]]:
        """Continuous-batching loop until every submitted request reaches a
        terminal lifecycle state -> ``{uid: tokens}`` for every request that
        ended during this call (partial streams for FAILED / CANCELLED /
        TIMED_OUT; ``lifecycles[uid]`` has the state and its diagnostic).

        ``step_hook(engine, step)`` fires once per loop turn before the reap
        and the admission (mid-run ``submit``, ``cancel`` or ``poll``).  With
        the process tracer enabled (``obs.trace.enable()``) each turn also
        records a ``step`` span split into the named phases of ``_turn``, and
        each request its lifecycle spans (``trace_report()``).
        """
        t0 = time.perf_counter()
        for req in requests:
            self.submit(req)
        results: dict[int, list[int]] = {}
        self._pending_token = {}
        tokens_h = np.zeros((self.max_slots, 1), np.int32)
        pos_h = np.zeros((self.max_slots,), np.int32)
        step_hist = self.metrics.histogram("step_time_s")
        while self._queue or self._active():
            tr = self._tracer
            step_idx = self._nsteps()
            step_span = (tr.span("step", cat="step", track="engine",
                                 hist=self.metrics.histogram("traced_step_s"),
                                 args={"step": step_idx})
                         if tr.enabled else obs_trace.NOOP_SPAN)
            with step_span:
                self._count("loop_turns")
                with StepTimer() as turn:
                    dispatch_dt = self._turn(results, tokens_h, pos_h, step_hook)
                step_hist.observe(turn.dt)
                with self._span("bookkeeping"):
                    if dispatch_dt is not None:
                        self._after_dispatch(step_idx, dispatch_dt)
                    if tr.enabled:
                        tr.counter("queue_depth", len(self._queue))
                        tr.counter("active_slots", sum(not s.free for s in self.slots))
                        if self.paged:
                            tr.counter("pool_available", self.pool.available)
        self.metrics.counter("wall_s").inc(time.perf_counter() - t0)
        return results

    def _active(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.free]

    def _decode_active(self) -> list[int]:
        """Slots the decode steps this turn: active and not mid-chunked-prefill."""
        return [i for i, s in enumerate(self.slots) if not s.free and not s.prefilling]

    def _turn(self, results: dict[int, list[int]], tokens_h: np.ndarray, pos_h: np.ndarray,
              step_hook) -> float | None:
        """One loop turn: hook -> reap -> admission (and the shed ladder) ->
        prefill chunks -> prep -> dispatch -> device_sync -> commit.  Returns
        the dispatch's host seconds, the transfer included (the straggler
        signal), or None when no decode ran."""
        if step_hook is not None:
            with self._span("hook"):
                step_hook(self, self._nsteps())
        with self._span("reap"):
            self._reap(time.monotonic(), results)
        with self._span("admission"):
            # fill free slots, highest priority first (a stable sort: FIFO
            # within a priority class)
            free = [i for i, s in enumerate(self.slots) if s.free]
            pressure = False
            if free and self._queue:
                self._queue.sort(key=lambda r: -r.priority)
                if self._fault("pool_exhaustion"):
                    # injected pool pressure: refuse the whole admission turn,
                    # so the ladder reacts as it would to a full pool
                    pressure = True
                else:
                    assignments = [(i, self._queue.pop(0)) for i in free[: len(self._queue)]]
                    if self.batch_admission:
                        rejected = self._admit(assignments)
                    else:                      # one padded prefill a request
                        rejected = []
                        for pair in assignments:
                            rejected += self._admit([pair])
                    # paged backpressure: what the pool could not cover waits
                    # at the head of the queue (and the ladder sheds below)
                    self._queue[:0] = rejected
                    pressure = bool(rejected)
                    if rejected and not self._active():
                        raise RuntimeError(
                            f"request needs more KV blocks than the whole pool holds "
                            f"({self.pool.num_blocks}); raise pool_blocks")
            if pressure:
                # shrink the speculation headroom, then preempt by priority
                self._maybe_shed(self._queue)
            elif self._queue:
                # slot pressure: a strictly higher-priority waiter may preempt
                self._preempt_for(self._queue)
            else:
                self._relax_shed()
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
            return None
        if self.paged and self._fault("append_failure"):
            # the slot's paged append bookkeeping died: that request alone fails
            victim = act[0]
            self._finalize(victim, self.slots[victim].req, RequestState.FAILED, results,
                           diagnostic="paged append bookkeeping failure (injected fault)")
            act = self._decode_active()
            if not act:
                return None
        k_eff = self._burst_len(act) if self._k_live else 0
        with self._span("prep"):
            if self.paged:
                # map and copy-on-write every block the round can write
                self._ensure_append_blocks(act, span=k_eff + 1)
            for i in act:
                s = self.slots[i]
                tokens_h[i, 0] = self._pending_token.get(i, s.generated[-1] if s.generated
                                                         else 0)
                pos_h[i] = s.pos
            # per-slot NaN needles, only with an injector (none in production)
            inject = inj_draft = None
            if self._injector is not None:
                inject = np.zeros((self.max_slots,), np.float32)
                if self._fault("nan_logit"):
                    inject[act[0]] = np.float32("nan")
        step = self._nsteps()
        with StepTimer() as timer:
            if k_eff > 0:
                if self._injector is not None:
                    inj_draft = np.zeros((self.max_slots,), np.float32)
                    if self._fault("nan_logit_draft"):
                        inj_draft[act[0]] = np.float32("nan")
                emitted, draft_bad, verify_bad = self._spec_step(act, tokens_h, pos_h, k_eff,
                                                                 inj_draft, inject)
            else:
                toks, verify_bad = self._decode(tokens_h, pos_h, inject)
                draft_bad = None
                emitted = {i: [int(toks[i])] for i in act}
        self._step_s.append(timer.dt)
        self._count("decode_steps")
        with self._span("commit"):
            self._commit(act, emitted, draft_bad, verify_bad, step, results)
        return timer.dt

    def _commit(self, act: list[int], emitted: dict[int, list[int]], draft_bad, verify_bad,
                step: int, results: dict[int, list[int]]) -> None:
        """Apply one step's (or round's) tokens: quarantine poisoned slots,
        record TTFT and inter-token gaps, stream each token, finalize
        completed requests."""
        now = time.monotonic()
        tr = self._tracer
        ttft_hist = self.metrics.histogram("ttft_s")
        itl_hist = self.metrics.histogram("itl_s")
        for i in act:
            s = self.slots[i]
            self._pending_token.pop(i, None)
            if verify_bad[i]:
                # numerical quarantine: only the poisoned request fails (its
                # sampling saw zeroed logits, its neighbours' streams did not move)
                self._count("nan_quarantined")
                if tr.enabled:
                    tr.instant("nan_quarantine", cat="anomaly", track=f"req/{s.req.uid}",
                               args={"uid": s.req.uid, "step": step})
                self._finalize(i, s.req, RequestState.FAILED, results,
                               diagnostic=f"non-finite logits at decode step {step}")
                continue
            if draft_bad is not None and draft_bad[i]:
                # poisoned draft, healthy verify: this round already fell back
                # to the non-speculative token for this slot
                self._count("nan_draft_fallbacks")
            lc = self.lifecycles.get(s.req.uid)
            first_of_turn = True
            for tok in emitted[i]:
                if lc is not None and lc.first_token_t is None:
                    # TTFT is the first COMMITTED token, not a chunk landing
                    lc.first_token_t = now
                    ttft_hist.observe(now - lc.enqueued_t)
                    if tr.enabled:
                        tr.instant("first_token", cat="request", track=f"req/{lc.uid}",
                                   args={"uid": lc.uid, "ttft_s": now - lc.enqueued_t})
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

    def _after_dispatch(self, step: int, dt: float) -> None:
        """After a dispatch: a straggler step sheds one speculation tier (never
        below K 1: only pool pressure turns speculation off), then the
        invariant sweep under ``debug_invariants``."""
        if (self._straggler.observe(step, dt)
                and self._shed_policy is not None
                and self._shed_policy.straggler_sheds_spec
                and self._k_live > 1
                and self._set_live_k(self._spec_ladder[self._shed_tier + 1])):
            self._shed_tier += 1
            self._shed_event("straggler_shed", dt=dt)
        if self._debug_invariants:
            self.check_invariants()

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
        """A view over ``self.metrics``: the counters (``admissions`` counts
        batched prefill calls; ``spec_proposed``/``spec_accepted`` sum K and
        the accepted draft tokens over the active slots of each round), the
        median decode step (a whole round under speculation, the tokens'
        transfer included), the process-wide kernel launch and plain-call
        counts, the shed ladder's events and tier, a ``health`` section as the
        JAX engine's, and, where they apply, the scheduler's records, the
        TTFT and inter-token summaries, the pool's counters and the
        calibration ratios against the artifact's predicted costs."""
        out = {k: int(self.metrics.counter(k).value) for k in _COUNTER_KEYS}
        out.update(wall_s=self.metrics.counter("wall_s").value,
                   decode_step_median_s=(statistics.median(self._step_s) if self._step_s
                                         else None),
                   launches=dict(kernels.LAUNCHES), plain_calls=dict(kernels.PLAIN_CALLS),
                   draft_bits=dict(self.draft_bits), speculate_live_k=self._k_live,
                   shed_tier=self._shed_tier, shed_events=[dict(e) for e in self._shed_events])
        step_hist = self.metrics.histogram("step_time_s")
        out["health"] = {
            "step_time_median_s": step_hist.percentile(50) if step_hist.count else 0.0,
            "dispatch_time_median_s": self._straggler.median(),
            "straggler_flagged": len(self._straggler.flagged),
            "shed_tier": self._shed_tier,
            "speculate_live_k": self._k_live,
            "queue_depth": len(self._queue),
            "active_slots": sum(not s.free for s in self.slots),
            "prefilling_slots": sum(s.prefilling for s in self.slots),
            "pool_available": self.pool.available if self.paged else None,
        }
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
        if self.artifact is not None and self.artifact.report:
            cal = obs_calibration.calibration_ratios(self.artifact.report,
                                                     self.measured_costs())
            if cal:
                out["calibration"] = cal
        return out

    def trace_report(self) -> dict:
        """Decompose the traced loop-turn time into the named phases, from the
        ``phase/*`` histograms the spans feed while the tracer is enabled, over
        the ``traced_step_s`` parent spans.  ``attributed_fraction`` is the
        share of the turns' time inside named phases (the rest is loop glue
        between spans)."""
        total_hist = self.metrics.histogram("traced_step_s")
        total = total_hist.sum
        phases = {}
        attributed = 0.0
        for name in _PHASE_NAMES:
            h = self.metrics.get("phase/" + name)
            if h is None or h.count == 0:
                continue
            phases[name] = {"total_s": h.sum, "count": h.count, "mean_us": h.mean * 1e6,
                            "p99_us": h.percentile(99) * 1e6,
                            "fraction_of_step": (h.sum / total) if total else 0.0}
            attributed += h.sum
        report = {
            "steps": total_hist.count,
            "total_s": total,
            "phases": dict(sorted(phases.items(), key=lambda kv: -kv[1]["total_s"])),
            "attributed_s": attributed,
            "attributed_fraction": (attributed / total) if total else 0.0,
            "unattributed_fraction": (1.0 - attributed / total) if total else 0.0,
        }
        if total_hist.count == 0:
            report["note"] = ("no traced steps recorded: enable the tracer "
                              "(repro_torch.obs.trace.enable()) before run()")
        return report

    def measured_costs(self) -> dict:
        """Deployment-side measurements of the artifact's predicted metrics,
        the calibration input: ``container_bytes`` from the packed weights,
        ``state_bytes`` from the cache (only for a quantized state: an fp
        cache is not what the search priced), and ``latency_s`` as the mean
        traced dispatch + device_sync time a decode step, once traced steps
        exist."""
        out = {"container_bytes": float(self.weight_container_bytes())}
        if self._quant_state:
            out["state_bytes"] = float(self.state_container_bytes())
        disp = self.metrics.get("phase/dispatch")
        sync = self.metrics.get("phase/device_sync")
        if disp is not None and disp.count:
            out["latency_s"] = float(disp.mean + (sync.mean if sync is not None and sync.count
                                                  else 0.0))
        return out

    def weight_container_bytes(self) -> int:
        """Device bytes the packed weights occupy (quantized leaves only)."""
        return sum(leaf.container_bytes() for _, leaf in qapply._walk(self.params)
                   if hasattr(leaf, "container_bytes"))

    def state_container_bytes(self) -> int:
        """Device bytes the decode state occupies (dense containers, or the
        whole pool): every leaf of the state, a KV container counted whole."""
        def walk(node) -> int:
            if hasattr(node, "container_bytes"):
                return node.container_bytes()
            if isinstance(node, dict):
                return sum(walk(v) for v in node.values())
            if isinstance(node, (list, tuple)):
                return sum(walk(v) for v in node)
            return node.numel() * node.element_size()

        return walk(self.state)

    def allocated_state_bytes(self, *, peak: bool = True) -> int:
        """Paged: bytes of the live blocks (the peak by default), what a state
        budget prices.  Dense: the whole container (every slot pre-pays
        ``max_seq``)."""
        if not self.paged:
            return self.state_container_bytes()
        n = self.pool.peak_allocated if peak else self.pool.allocated
        return sum(layer.allocated_bytes(n) for layer in self.state)
