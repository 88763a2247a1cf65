"""Device ms a step of the per-call weight casts (``models/layers.py
cast``): the kernels launched inside the ``weight_cast`` scopes, in the
forward and the remat recompute (each cast's backward, the bf16 gradient
back to float32, is not in it).  Where the trace holds no such scope (a
program without it), nothing is read."""
UNIT = "ms"
LAYER = "models/layers.py per-call weight casts"
MOVES = "train_step_ms"
BETTER = "lower"
SOURCE = "program_span"
SPANS = frozenset({"weight_cast"})


def read(ctx):
    if ctx.entry != "lm_train" or \
            "weight_cast" not in {name for _, name in ctx.trace.spans}:
        return None
    return 1e3 * ctx.trace.launched_in_s("weight_cast") / ctx.items
