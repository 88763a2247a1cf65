"""The prefill's model FLOPs (``yardstick.prefill_flops``) over the
traced window, as a share of the card's bf16 datasheet peak."""
from portbench import yardstick as Y

UNIT = "%"
LAYER = "whole prefill: models/causal_lm.py prefill"
MOVES = "prefill_tokens_per_s"
BETTER = "higher"
SOURCE = "device_trace"


def read(ctx):
    if ctx.entry != "lm_prefill":
        return None
    flops = Y.prefill_flops(ctx.model, ctx.batch, ctx.seq) * ctx.items
    return 100.0 * flops / ctx.window_s / Y.PEAK_FLOPS_BF16
