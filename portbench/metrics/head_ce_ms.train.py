"""Device ms a step of the kernels launched inside the ``fused_head_ce``
scopes: the chunked LM head and cross-entropy, forward and backward."""
UNIT = "ms"
LAYER = "models/layers.py fused_head_cross_entropy"
MOVES = "train_step_ms"
BETTER = "lower"
SOURCE = "program_span"
SPANS = frozenset({"fused_head_ce"})


def read(ctx):
    if ctx.entry != "lm_train":
        return None
    return 1e3 * ctx.trace.launched_in_s("fused_head_ce") / ctx.items
