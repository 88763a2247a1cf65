"""Fault-tolerant checkpointing: self-contained npz + manifest.

Layout of a checkpoint directory (identical to the reference package's, so
checkpoints and serve bundles cross between the two in both directions)::

    <root>/step_<n>/
        manifest.json     # step, tree structure, shapes/dtypes, user metadata
        arrays.npz        # flat leaves keyed "leaf_00000", ...
    <root>/LATEST         # atomic pointer file (write-tmp + rename)

Trees are nested dicts / lists / tuples of arrays (numpy arrays or torch
tensors).  They are flattened with the reference's path strings and leaf
order: dict keys sorted, a dict key written as ``['name']``, a sequence index
as ``[i]``, joined with ``/`` — e.g. ``"['params']/['u']/['W']/[0]"``.
``None`` is an empty subtree.

Guarantees:
* atomic publication — a crash mid-save never corrupts LATEST;
* keep-last-k garbage collection;
* structure-checked restore with a clear error on mismatch (unless
  ``allow_restructure=True``);
* durable-state integrity — every save stamps per-array CRC32s + a manifest
  digest + the parent-generation chain edge into the manifest
  (:mod:`repro_torch.checkpoint.integrity`).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import warnings
from typing import Any

import numpy as np

Pytree = Any


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch.Tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _walk(tree, prefix: tuple):
    """(path parts, leaf) pairs in the reference's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (f"[{k!r}]",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (f"[{i}]",))
    else:
        yield prefix, tree


def _flatten_with_paths(tree: Pytree):
    pairs = list(_walk(tree, ()))
    return ["/".join(p) for p, _ in pairs], [v for _, v in pairs]


def _treedef_str(tree) -> str:
    """The reference's ``str(treedef)`` form, e.g.
    ``PyTreeDef({'params': {'u': {'W': [*, *], 'a': *}}})`` (informational:
    restore checks paths, never this string)."""
    def rec(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {rec(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(rec(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(rec(v) for v in t) + \
                ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({rec(tree)})"


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from leaves in flatten order."""
    it = iter(leaves)

    def rec(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: rec(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(rec(v) for v in t)
        return next(it)
    return rec(like)


def save(root: str, step: int, tree: Pytree, metadata: dict | None = None,
         keep: int = 3, integrity: bool = True) -> str:
    """Atomically write a checkpoint for ``step``; returns the checkpoint dir.

    ``integrity=True`` (the default) stamps per-array checksums, a manifest
    digest, and the parent-generation name into the manifest so restore-time
    verification and generation fallback work."""
    os.makedirs(root, exist_ok=True)
    # a crash mid-save leaves its .tmp_step_* workdir behind; sweep orphans
    # BEFORE creating our own (single-writer contract: one saver per root)
    _sweep_orphan_tmps(root)
    paths, leaves = _flatten_with_paths(tree)
    leaves = [_to_numpy(x) for x in leaves]
    tmp = tempfile.mkdtemp(dir=root, prefix=f".tmp_step_{step}_")
    try:
        arrays = {f"leaf_{i:05d}": x for i, x in enumerate(leaves)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": int(step),
            "paths": paths,
            "treedef": _treedef_str(tree),
            "shapes": [list(x.shape) for x in leaves],
            "dtypes": [str(x.dtype) for x in leaves],
            "metadata": metadata or {},
        }
        if integrity:
            from repro_torch.checkpoint import integrity as integ

            gens = _step_dirs(root)
            manifest["integrity"] = integ.build_integrity(
                manifest, os.path.join(tmp, "arrays.npz"),
                parent=gens[-1][1] if gens else None)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        final = os.path.join(root, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    ptr_tmp = os.path.join(root, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(ptr_tmp, os.path.join(root, "LATEST"))
    _gc(root, keep)
    return final


def _gc(root: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def _sweep_orphan_tmps(root: str) -> None:
    """Remove half-written ``.tmp_step_*`` dirs a crashed save left behind
    (single-writer contract: the only live tmp dir belongs to a save()
    currently on this call stack, and save() sweeps before creating it)."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return
    for d in names:
        if d.startswith(".tmp_step_"):
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def _readable_step_dir(root: str, name: str) -> int | None:
    """Step number iff ``name`` is a well-formed, READABLE step dir: parsable
    name, manifest.json present and parsable JSON.  None otherwise."""
    try:
        n = int(name.split("_", 1)[1])
    except (IndexError, ValueError):
        return None
    try:
        with open(os.path.join(root, name, "manifest.json")) as f:
            json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    return n


def _step_dirs(root: str) -> list[tuple[int, str]]:
    """Readable ``(step, dirname)`` pairs under ``root``, oldest first.
    Unreadable/partially-written step dirs are warned about and SKIPPED."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    out = []
    for d in sorted(names):
        if not d.startswith("step_"):
            continue
        n = _readable_step_dir(root, d)
        if n is None:
            warnings.warn(f"skipping unreadable checkpoint dir {root}/{d}",
                          RuntimeWarning, stacklevel=2)
            continue
        out.append((n, d))
    return sorted(out)


def latest_step(root: str) -> int | None:
    ptr = os.path.join(root, "LATEST")
    if os.path.isdir(root):
        _sweep_orphan_tmps(root)
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    n = _readable_step_dir(root, name) if name.startswith("step_") else None
    if n is None:
        # LATEST pointing at a GC'd/half/unreadable dir: fall back to the
        # newest readable one (warn + continue, never crash the scan)
        cands = _step_dirs(root)
        if not cands:
            return None
        n = cands[-1][0]
    return n


def restore(root: str, like: Pytree, step: int | None = None,
            allow_restructure: bool = False) -> tuple[Pytree, dict]:
    """Restore into the structure of ``like``; returns (tree of numpy
    arrays, metadata)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = os.path.join(root, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        leaves = [data[f"leaf_{i:05d}"]
                  for i in range(len(manifest["paths"]))]

    want_paths, want_leaves = _flatten_with_paths(like)
    if manifest["paths"] != want_paths:
        if not allow_restructure:
            raise ValueError(
                "checkpoint structure mismatch:\n"
                f"  stored {manifest['paths'][:5]}...\n  wanted {want_paths[:5]}..."
            )
        by_path = dict(zip(manifest["paths"], leaves))
        leaves = [by_path.get(p, w) for p, w in zip(want_paths, want_leaves)]
    return _unflatten(like, leaves), manifest["metadata"]


def raw_leaves(root: str, step: int | None = None) -> tuple[dict[str, np.ndarray], dict]:
    """Path-keyed leaves without a template."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = os.path.join(root, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        leaves = {p: data[f"leaf_{i:05d}"]
                  for i, p in enumerate(manifest["paths"])}
    return leaves, manifest
