"""The 95th percentile of the gap between tokens, as ``itl_p95_ms`` reads
it, in a cell where its spread from run to run is too wide for an
end-to-end bound (PERF.md §2).  Read in the traced run, whose last seconds
run under the profiler.  Moves ``output_tok_s``."""
from portbench import stats


def read(ctx):
    return 1e3 * stats.percentile(ctx.window["itl"], 95) if ctx.window["itl"] else None
