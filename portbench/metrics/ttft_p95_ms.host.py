"""The 95th percentile of the time to first token, as ``ttft_p95_ms``
reads it, in a cell where its spread from run to run is too wide for an
end-to-end bound (PERF.md §2).  Read in the traced run, whose last seconds
run under the profiler.  Moves ``output_tok_s``."""
from portbench import stats


def read(ctx):
    return 1e3 * stats.percentile(ctx.window["ttft"], 95) if ctx.window["ttft"] else None
