"""Logical-axis sharding rules (MaxText-style) for the LM model zoo.

Counterpart of the reference package's ``models/sharding.py``: its rule
tables, ``rules_for``, ``use_rules``, ``current_rules``, ``spec`` and
``specs_from_logical``, copied without JAX.  Params and caches are
annotated with LOGICAL axis names (each model's ``logical`` /
``cache_logical`` trees); a rules table maps them to mesh axes.  The
production meshes are ``(16,16) ("data","model")`` and ``(2,16,16)
("pod","data","model")`` (``launch/mesh.py::make_production_mesh``).

Default mapping (single-pod):
    batch   -> data            (DP)
    embed   -> data            (FSDP-style weight storage sharding)
    vocab / heads / kv_heads / ff / expert -> model   (TP / EP)
    seq     -> None            (replicated; long-decode caches override to data)

Multi-pod adds ``batch -> (pod, data)``.

The specs say how a tree WOULD be laid out on a mesh: the dry run
(``launch/dryrun.py``) turns them into per-device bytes, and its
partitioned form lays the trees out as DTensors.  That side, with the
reference's ``constrain`` (a ``with_sharding_constraint`` hint inside
the models, at the reference's sites), is ``models/partition.py``: this
module stays free of torch.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

_state = threading.local()


class PartitionSpec(tuple):
    """One entry per array dim: a mesh axis name, a tuple of them, or None
    (replicated); dims past the last entry are replicated.  The reference's
    ``jax.sharding.PartitionSpec`` as a plain tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

SINGLE_POD_RULES: dict[str, object] = {
    "batch": "data",
    "embed": "data",
    "act_embed": None,
    "res_seq": None,   # sequence-parallel residual stream (hillclimb lever)
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "expert": "model",
    "seq": None,
    "kv_seq": None,
    "conv": None,
    "state": None,
    "capacity": None,
    "_": None,
}

MULTI_POD_RULES = dict(SINGLE_POD_RULES, batch=("pod", "data"))

# decode: shard the KV/latent cache sequence dim over `model` (batch stays on
# `data`): decode memory is cache-dominated
DECODE_OVERRIDES = {"kv_seq": "model", "kv_heads": None}

# long-context decode (global_batch=1): batch cannot shard; spread the cache
# sequence dim over BOTH axes instead.
LONG_CONTEXT_OVERRIDES = {"batch": None, "kv_seq": ("data", "model"),
                          "kv_heads": None}


def rules_for(multi_pod: bool = False, long_context: bool = False,
              decode: bool = False) -> dict:
    r = dict(MULTI_POD_RULES if multi_pod else SINGLE_POD_RULES)
    if decode:
        r.update(DECODE_OVERRIDES)
    if long_context:
        r.update(LONG_CONTEXT_OVERRIDES)
        if multi_pod:
            r["kv_seq"] = ("pod", "data", "model")
    return r


@contextmanager
def use_rules(rules: dict | None):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def current_rules() -> dict | None:
    return getattr(_state, "rules", None)


def spec(*logical: str | None, rules: dict | None = None) -> PartitionSpec:
    """PartitionSpec from logical dim names under the active rules."""
    r = rules if rules is not None else current_rules()
    if r is None:
        return P()
    return P(*[r.get(ax, None) if ax is not None else None for ax in logical])


def map_logical(fn, tree):
    """``fn`` on every logical-dims tuple of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: map_logical(fn, v) for k, v in tree.items()}
    return fn(tree)


def specs_from_logical(logical_tree, rules: dict):
    """Map a tree of logical-dim tuples to PartitionSpecs."""
    return map_logical(lambda dims: spec(*dims, rules=rules), logical_tree)


def add_layer_axis(tree):
    """The tree's dims with a leading unsharded axis (a stacked L axis)."""
    return map_logical(lambda dims: (None,) + tuple(dims), tree)
