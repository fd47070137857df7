"""Row 3's share of its roofline: the least time of the fused decode-step
attention launches of the traced turns (one a layer and decode call: each
row reads its cache's valid positions at the state's bits once, writes back
the block its token lands in, reads its query and new K/V and writes its
output in bf16; ``roofline.kv_decode_step_bound``) over the device time of
``quant_kv_decode_step_kernel`` in the trace.  The rows and their positions
are those of the calls the engine made to the model (``batches.py``), idle
rows included.  Moves ``output_tok_s``."""
from portbench import roofline

KERNEL = "quant_kv_decode_step_kernel"


def read(ctx):
    m = ctx.model
    if ctx.trace is None or not roofline.attention_layers(m):
        return None
    device = sum(e - s for name, s, e in ctx.trace.ops if KERNEL in name)
    bound = sum(roofline.kv_decode_step_bound(m, ctx.bits, [p for _, _, p in d.slots])
                for d in ctx.batches.decodes_in(ctx.trace_turns))
    bound *= roofline.attention_layers(m)
    if device <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device
