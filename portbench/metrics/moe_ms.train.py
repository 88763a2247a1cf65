"""Device ms a step of the MoE layers (``models/moe.py moe_ffn``): the
kernels launched inside a ``moe_ffn`` scope (the forward, and its remat
recompute) or inside the ``moe_ffn.bwd`` range and outside every
``lm_layer`` scope (the layer's backward nodes: the range also holds the
whole layer's recompute, in an ``lm_layer`` scope, whose MoE part the
first rule counts).  Where the trace lacks any of the three spans (a
program without them), nothing is read."""
UNIT = "ms"
LAYER = "models/moe.py moe_ffn"
MOVES = "train_step_ms"
BETTER = "lower"
SOURCE = "program_span"
SPANS = frozenset({"moe_ffn", "moe_ffn.bwd", "lm_layer"})


def read(ctx):
    tr = ctx.trace
    if ctx.entry != "lm_train" or \
            not SPANS <= {name for _, name in tr.spans}:
        return None
    total = 0
    for s, e, _, corr in tr.device:
        op = tr.ops.get(corr)
        if op is not None and (tr._inside(op, "moe_ffn") or (
                tr._inside(op, "moe_ffn.bwd")
                and not tr._inside(op, "lm_layer"))):
            total += e - s
    return 1e-6 * total / ctx.items
