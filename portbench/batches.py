"""The batches the engine ran, read where it hands them to the model.

``Recorder`` stands between ``ServeEngine`` and its model API: every
``prefill`` and ``decode_step`` call is kept with the loop turn it fell in,
its token tensor and its lengths or positions.  The tensors stay where the
engine made them and are not copied, so recording adds no device work.
After the run ``assign`` reads them back and ties each row to the request it
carried, by its contents: a prefill row holds a request's prompt head; a
decode row holds the request's last prompt token and then each token it was
served, at consecutive positions, in one row of consecutive decode calls.
A decode row that carries no request is idle.

The plain reference needs the batches themselves, since the MoE layer's
capacity drops depend on which tokens share a call.  Reading them from the
calls, and not from a rule of the engine's, leaves the engine free to batch,
pad and order its rows as it likes.  A prefill row that holds no request's
prompt head, and a served token that no decode row produced, are counted in
``unmatched``, which ``correct`` compares.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Admission:
    turn: int
    rows: list[tuple[int, int | None]]   # (row, uid; None: no request's head)
    pad: int                        # the call's padded head length


@dataclasses.dataclass
class Decode:
    turn: int
    slots: list[tuple[int | None, int, int]]   # per row: (uid or None if idle, token, pos)
    js: list[int]                              # per row: index of the token it produces, -1 idle


@dataclasses.dataclass
class Batches:
    calls: list[Admission | Decode]            # in the order the engine made them
    unmatched: list[str]                       # rows the contents tie to no request

    @property
    def admissions(self) -> list[Admission]:
        return [c for c in self.calls if isinstance(c, Admission)]

    @property
    def decodes(self) -> list[Decode]:
        return [c for c in self.calls if isinstance(c, Decode)]

    def admissions_in(self, turns: range) -> list[Admission]:
        return [a for a in self.admissions if a.turn in turns]

    def decodes_in(self, turns: range) -> list[Decode]:
        return [d for d in self.decodes if d.turn in turns]


class Recorder:
    """Keeps every ``prefill`` and ``decode_step`` call an engine makes."""

    def __init__(self, turn_of):
        self.turn_of = turn_of                 # () -> the loop turn now
        self.calls: list[tuple[str, int, object, object]] = []

    def install(self, engine) -> None:
        api = engine.api
        prefill, decode_step = api.prefill, api.decode_step

        def recorded_prefill(params, cfg, tokens=None, *args, lengths=None, **kw):
            self.calls.append(("prefill", self.turn_of(), tokens, lengths))
            return prefill(params, cfg, tokens, *args, lengths=lengths, **kw)

        def recorded_decode_step(params, cfg, state, token, pos, *args, **kw):
            self.calls.append(("decode", self.turn_of(), token, pos))
            return decode_step(params, cfg, state, token, pos, *args, **kw)

        engine.api = dataclasses.replace(api, prefill=recorded_prefill,
                                         decode_step=recorded_decode_step)


def _inputs(job, served: list[int], j: int) -> tuple[int, int] | None:
    """(token, position) of request's decode ``j``: its last prompt token,
    then the token served before; None past the tokens it was served."""
    if j >= len(served):
        return None
    n = len(job.prompt)
    return (job.prompt[-1] if j == 0 else served[j - 1]), n - 1 + j


def assign(calls, rec) -> Batches:
    """Every recorded call, its rows tied to the requests of ``rec``."""
    heads: dict[tuple[int, ...], list[int]] = {}
    starts: dict[tuple[int, int], list[int]] = {}
    for uid in sorted(rec.jobs):
        job = rec.jobs[uid]
        if len(job.prompt) > 1:
            heads.setdefault(tuple(job.prompt[:-1]), []).append(uid)
        else:                                  # no head: it decodes from its only token
            starts.setdefault((job.prompt[0], 0), []).append(uid)
    out, unmatched = [], []
    current: dict[int, tuple[int, int]] = {}   # decode row -> (uid, j) it carried last
    for kind, turn, tokens, aux in calls:
        toks = tokens.tolist()
        if kind == "prefill":
            lengths = aux.tolist() if aux is not None else [len(r) for r in toks]
            rows = []
            for r, (row, n) in enumerate(zip(toks, lengths)):
                waiting = heads.get(tuple(row[:n]), [])
                if not waiting:
                    unmatched.append(f"turn {turn}: prefill row {r} of {n} tokens")
                    rows.append((r, None))
                    continue
                uid = waiting.pop(0)
                rows.append((r, uid))
                job = rec.jobs[uid]
                starts.setdefault((job.prompt[-1], len(job.prompt) - 1), []).append(uid)
            out.append(Admission(turn=turn, rows=rows, pad=len(toks[0])))
            continue
        pos = aux.tolist()
        slots, js = [], []
        for i, (t, p) in enumerate(zip((r[0] for r in toks), pos)):
            uid, j = current.get(i, (None, -1))
            if uid is not None and _inputs(rec.jobs[uid], rec.tokens[uid], j + 1) == (t, p):
                j += 1
            elif starts.get((t, p)):
                uid, j = starts[(t, p)].pop(0), 0
            else:
                uid, j = None, -1
            if uid is None:
                current.pop(i, None)
            else:
                current[i] = (uid, j)
            slots.append((uid, t, p))
            js.append(j)
        out.append(Decode(turn=turn, slots=slots, js=js))
    made: dict[int, int] = {}
    for d in out:
        if isinstance(d, Decode):
            for (uid, _, _), j in zip(d.slots, d.js):
                if uid is not None:
                    made[uid] = max(made.get(uid, 0), j + 1)
    unmatched += [f"request {u}: {len(ts) - made.get(u, 0)} of its {len(ts)} tokens from no "
                  f"decode row" for u, ts in rec.tokens.items() if made.get(u, 0) < len(ts)]
    return Batches(calls=out, unmatched=unmatched)
