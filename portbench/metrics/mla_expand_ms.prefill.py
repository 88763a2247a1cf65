"""Device ms a prefill of MLA's expansion (``models/mla.py
_expanded_attention``): the kernels launched inside the ``mla_expand``
scopes, from the latents to K5's operands (the ``wuk`` and ``wuv``
products and the concatenations of q and k).  Where the trace holds no
such scope (a program without it), nothing is read."""
UNIT = "ms"
LAYER = "models/mla.py latent expansion"
MOVES = "prefill_tokens_per_s"
BETTER = "lower"
SOURCE = "program_span"
SPANS = frozenset({"mla_expand"})


def read(ctx):
    if ctx.entry != "lm_prefill" or \
            "mla_expand" not in {name for _, name in ctx.trace.spans}:
        return None
    return 1e3 * ctx.trace.launched_in_s("mla_expand") / ctx.items
