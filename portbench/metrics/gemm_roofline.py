"""Row 2's share of its roofline: the least time of the dense linears' GEMM
launches of the traced turns (the larger of their flops at the bf16 peak and
their bytes at the bandwidth, at each call's M: every row of a decode call,
rows times the padded head at a prefill; ``roofline.gemm_bound``) over the
device time of ``quant_matmul_kernel`` in the trace.  The calls are those
the engine made to the model (``batches.py``).  Moves ``output_tok_s``."""
from portbench import roofline

KERNEL = "quant_matmul_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    m = ctx.model
    device = sum(e - s for name, s, e in ctx.trace.ops if KERNEL in name)
    dense = [lin for lin in roofline.linears(m, ctx.bits) if not lin.experts]
    bound = 0.0
    for a in ctx.batches.admissions_in(ctx.trace_turns):
        rows = len(a.rows) * a.pad
        if rows > 8:
            bound += sum(roofline.gemm_bound(lin, rows) * lin.uses for lin in dense
                         if lin.name != "lm_head")
    for d in ctx.batches.decodes_in(ctx.trace_turns):
        rows = len(d.slots)
        if rows > 8:
            bound += sum(roofline.gemm_bound(lin, rows) * lin.uses for lin in dense)
    if device <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device
