"""The training step's model FLOPs (``yardstick.train_flops``: the
forward's three times, attention over its causal pairs) over the traced
window, as a share of the card's bf16 datasheet peak."""
from portbench import yardstick as Y

UNIT = "%"
LAYER = "whole training step: launch/train.py lm_train_step"
MOVES = "train_step_ms"
BETTER = "higher"
SOURCE = "device_trace"


def read(ctx):
    if ctx.entry != "lm_train":
        return None
    flops = Y.train_flops(ctx.model, ctx.batch, ctx.seq) * ctx.items
    return 100.0 * flops / ctx.window_s / Y.PEAK_FLOPS_BF16
