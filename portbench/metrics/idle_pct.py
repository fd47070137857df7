"""Share of the traced turns' wall time in which no operation ran on the
device: the union of the device trace's kernel, copy and set intervals, so
that overlapping ones count once.  Moves ``output_tok_s``."""
from portbench import stats


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    busy = stats.busy_seconds([(a, b) for _, a, b in tr.ops], tr.t0, tr.t1)
    return 100.0 * (1.0 - busy / (tr.t1 - tr.t0))
