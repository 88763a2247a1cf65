"""The share of the traced window in which no operation ran on the
device, in a prefill cell."""
UNIT = "%"
LAYER = "device"
MOVES = "prefill_tokens_per_s"
BETTER = "lower"
SOURCE = "device_trace"


def read(ctx):
    if ctx.entry != "lm_prefill":
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
