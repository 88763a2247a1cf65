"""K5's device time as a share of the device's busy time in a prefill."""
UNIT = "%"
LAYER = "K5: csrc/flash_attention_sm90.cu"
MOVES = "prefill_tokens_per_s"
BETTER = "lower"
SOURCE = "device_trace"
K5 = r"\b(flash_fwd_sm90_kernel|flash_short_kernel|flash_fwd_kernel)\b"


def read(ctx):
    if ctx.entry != "lm_prefill":
        return None
    k5_s, n = ctx.trace.kernel_s(K5)
    if n == 0:
        return None
    return 100.0 * k5_s / ctx.busy_s
