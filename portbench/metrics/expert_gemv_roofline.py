"""Row 1e's share of its roofline: the least time of the expert-stack GEMV
launches of the traced turns (every expert's packed weights at its layer's
bits and the scales, the ``(E, C, K)`` buffer read and the output written,
at the bandwidth; ``roofline.expert_gemv_bound``) over the device time of
``quant_gemv_kernel`` in the trace.  Each call the engine made to the model
(``batches.py``) runs its experts at that call's capacity; row 1e is the
one at a capacity of 8 or less.  Read only where every launch of that
kernel is an expert stack: at more than 8 rows the dense linears run the
GEMM.  Moves ``output_tok_s``."""
from portbench import roofline

KERNEL = "quant_gemv_kernel"


def read(ctx):
    m = ctx.model
    if ctx.trace is None or m["family"] != "moe" or ctx.slots <= 8:
        return None
    device = sum(e - s for name, s, e in ctx.trace.ops if KERNEL in name)
    stacks = [lin for lin in roofline.linears(m, ctx.bits) if lin.experts]
    calls = [len(a.rows) * a.pad for a in ctx.batches.admissions_in(ctx.trace_turns)]
    calls += [len(d.slots) for d in ctx.batches.decodes_in(ctx.trace_turns)]
    bound = 0.0
    for tokens in calls:
        cap = roofline.capacity(tokens, m)
        if cap <= 8:
            bound += sum(roofline.expert_gemv_bound(lin, cap) for lin in stacks)
    if device <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device
