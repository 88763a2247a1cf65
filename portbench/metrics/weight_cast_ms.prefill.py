"""Device ms a prefill of the float32 to bf16 weight casts the layers make
at every call: the kernels launched inside an ``aten::_to_copy`` op whose
input is a float32 matrix (a weight; activations are three-dimensional).
Read from the items traced with their input shapes, after the main
trace."""
UNIT = "ms"
LAYER = "models/layers.py per-call weight casts"
MOVES = "prefill_tokens_per_s"
BETTER = "lower"
SOURCE = "device_trace"
SHAPED = frozenset({"aten::_to_copy"})


def read(ctx):
    if ctx.entry != "lm_prefill" or not ctx.shaped_items:
        return None
    return 1e3 * ctx.shaped.launched_in_s("aten::_to_copy", _weight) / \
        ctx.shaped_items


def _weight(shapes_dtypes):
    shapes, dtypes = shapes_dtypes
    return bool(shapes) and len(shapes[0]) == 2 and dtypes[0] == "float"
