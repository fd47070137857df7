"""Host milliseconds of a decode turn: the engine's ``step`` span less its
``device_sync`` span (``obs/trace`` phases), averaged over the window's
decode turns before the device trace.  Moves ``output_tok_s``."""


def read(ctx):
    steps = dict(ctx.phase_spans("step", ctx.span_turns))
    syncs = dict(ctx.phase_spans("device_sync", ctx.span_turns))
    turns = [t for t in syncs if t in steps]
    if not turns:
        return None
    return 1e3 * sum(steps[t] - syncs[t] for t in turns) / len(turns)
