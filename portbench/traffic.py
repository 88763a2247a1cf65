"""The benchmark's one traffic generator and its weight maker.

Every input comes from ``--seed`` through :func:`derive`, so the same seed
gives the same tokens and weights, and every seed gives the same sizes.
A cell's traffic is the ``params`` of its file under
``portbench/workloads/`` (batch, sequence length, ...); the generator
reads them and knows no cell by name.
"""
from __future__ import annotations

import hashlib

import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of inputs, from the run's seed (any
    whole number) and the stream's tags."""
    text = ":".join(str(t) for t in (seed, *tags))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") & (2 ** 63 - 1)


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def tokens(seed: int, index: int, batch: int, seq: int, vocab: int,
           device) -> torch.Tensor:
    """Request or step ``index``'s (batch, seq) int64 token ids, uniform
    over the vocabulary, drawn on ``device``."""
    g = generator(device, seed, "tokens", index)
    return torch.randint(0, vocab, (batch, seq), generator=g, device=device)


def leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def rebuild(like, values: dict, prefix=()):
    """``like``'s nested dicts with each leaf replaced by ``values[path]``.
    (Recursion at module level: a nested function that calls itself is a
    reference cycle, which would hold the tensors until the cyclic
    collector runs.)"""
    if isinstance(like, dict):
        return {k: rebuild(v, values, prefix + (k,)) for k, v in like.items()}
    return values[prefix]


def make_weights(shapes, seed: int, device, std: float = 0.02):
    """Float32 weights for a tree of shaped leaves (meta tensors): every
    norm's scale (a leaf whose key ends in ``norm``) ones, every other
    leaf N(0, std^2), all of them views into one buffer drawn by one call
    on ``device``."""
    items = list(leaves(shapes))
    normal = [(p, t) for p, t in items if not p[-1].endswith("norm")]
    n = sum(t.numel() for _, t in normal)
    flat = torch.randn(n, generator=generator(device, seed, "weights"),
                       device=device)
    flat.mul_(std)
    out, off = {}, 0
    for p, t in normal:
        out[p] = flat[off:off + t.numel()].view(t.shape)
        off += t.numel()
    for p, t in items:
        if p[-1].endswith("norm"):
            out[p] = torch.ones(t.shape, device=device)
    return rebuild(shapes, out)
