"""The share of the traced window in which no operation ran on the
device, in a training cell."""
UNIT = "%"
LAYER = "device"
MOVES = "train_step_ms"
BETTER = "lower"
SOURCE = "device_trace"


def read(ctx):
    if ctx.entry != "lm_train":
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
