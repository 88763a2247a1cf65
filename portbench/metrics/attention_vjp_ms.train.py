"""Device ms a step of the kernels launched inside the
``flash_attention_vjp`` scope: K5's backward, the plain attention
recomputed and differentiated."""
UNIT = "ms"
LAYER = "kernels/flash_attention.py plain VJP recompute"
MOVES = "train_step_ms"
BETTER = "lower"
SOURCE = "program_span"
SPANS = frozenset({"flash_attention_vjp"})


def read(ctx):
    if ctx.entry != "lm_train":
        return None
    return 1e3 * ctx.trace.launched_in_s("flash_attention_vjp") / ctx.items
