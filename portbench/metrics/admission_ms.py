"""Milliseconds of an admission: the engine's ``admission`` phase span
(``_admit`` and the batched prefill it calls), averaged over the window's
turns that admitted a prompt, before the device trace.  Moves
``output_tok_s``: every slot waits for a turn's admission, so it sets the
time to first token and the gap between tokens alike (``ttft_p95_ms.host``,
``itl_p95_ms.host``)."""


def read(ctx):
    admitted = {a.turn for a in ctx.batches.admissions}
    spans = [d for t, d in ctx.phase_spans("admission", ctx.span_turns) if t in admitted]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
