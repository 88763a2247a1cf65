"""K5's share of its roofline in a prefill: the least time of its launches
(``yardstick.k5_bound_s`` of one layer's call, at the bf16 peak or HBM's
rate, times the launches) over their device time, read by kernel name
(the sm90, short and float32 kernels)."""
from portbench import yardstick as Y

UNIT = "%"
LAYER = "K5: csrc/flash_attention_sm90.cu"
MOVES = "prefill_tokens_per_s"
BETTER = "higher"
SOURCE = "device_trace"
K5 = r"\b(flash_fwd_sm90_kernel|flash_short_kernel|flash_fwd_kernel)\b"


def read(ctx):
    if ctx.entry != "lm_prefill":
        return None
    k5_s, n = ctx.trace.kernel_s(K5)
    if n == 0:
        return None
    return 100.0 * n * Y.k5_bound_s(ctx.model, ctx.batch, ctx.seq) / k5_s
