"""The whole step's share of the chip's peaks: the least time of the traced
turns' work (each decode call and each admission the larger of its flops at
the bf16 peak and its bytes at the bandwidth, counting the rows that carry
a request and their valid tokens only; ``roofline.decode_work`` and
``roofline.prefill_work``) over the traced turns' wall time.  The calls are
those the engine made to the model (``batches.py``).  Moves
``output_tok_s``."""
from portbench import roofline


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    m, bits = ctx.model, ctx.bits
    least = 0.0
    for a in ctx.batches.admissions_in(ctx.trace_turns):
        lengths = [len(ctx.rec.jobs[uid].prompt) - 1 for _, uid in a.rows if uid is not None]
        if lengths:
            least += roofline.least_seconds(*roofline.prefill_work(m, bits, lengths))
    for d in ctx.batches.decodes_in(ctx.trace_turns):
        positions = [pos for uid, _, pos in d.slots if uid is not None]
        if positions:
            least += roofline.least_seconds(*roofline.decode_work(m, bits, positions))
    if least <= 0:
        return None
    return 100.0 * least / (tr.t1 - tr.t0)
