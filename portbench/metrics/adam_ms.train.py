"""Device ms a step of the kernels launched inside the ``adam_update``
scope (``launch/train.py``): the Adam update over every leaf."""
UNIT = "ms"
LAYER = "optim/adam.py adam_update"
MOVES = "train_step_ms"
BETTER = "lower"
SOURCE = "program_span"
SPANS = frozenset({"adam_update"})


def read(ctx):
    if ctx.entry != "lm_train":
        return None
    return 1e3 * ctx.trace.launched_in_s("adam_update") / ctx.items
