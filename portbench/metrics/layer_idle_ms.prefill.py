"""Device-idle ms a prefill inside the layer loop: the idle gaps between
device events (the breakdown's rule) whose next event was launched by an
op inside an ``lm_layer`` scope (``models/layers.py scan_layers``), so
the host's launches inside the 62 layers, apart from the gaps at the
request's edges (embedding, head, the synchronise).  Where the trace
holds no such scope (a program without it), nothing is read."""
UNIT = "ms"
LAYER = "models/layers.py scan_layers"
MOVES = "prefill_tokens_per_s"
BETTER = "lower"
SOURCE = "program_span"
SPANS = frozenset({"lm_layer"})


def read(ctx):
    tr = ctx.trace
    if ctx.entry != "lm_prefill" or \
            "lm_layer" not in {name for _, name in tr.spans}:
        return None
    total, end = 0, None
    for s, e, _, corr in tr.device:
        if end is not None and s > end:
            op = tr.ops.get(corr)
            if op is not None and tr._inside(op, "lm_layer"):
                total += s - end
        end = e if end is None else max(end, e)
    return 1e-6 * total / ctx.items
