"""Kernel launches the host makes a decode turn: the profiler's launch calls
(``cudaLaunchKernel``, ``cuLaunchKernel``, their ``Ex`` forms and graph
launches) over the traced turns, divided by the decode calls the engine made
in them.  Moves ``output_tok_s``."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.launches:
        return None
    n = len(ctx.batches.decodes_in(ctx.trace_turns))
    return ctx.trace.launches / n if n else None
