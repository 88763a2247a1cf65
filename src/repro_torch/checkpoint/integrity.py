"""Durable-state integrity: checksums, verification, generation fallback.

Long runs see storage faults — torn writes, truncated files, bit rot — as
routine events, and both recovery paths in this repo (the supervisor's
bitwise-replay rollback and the serving stack's bundle load) previously
assumed the artifact they read back was valid.  This module closes that gap
on the existing npz+manifest checkpoint format (:mod:`repro_torch.checkpoint.ckpt`)
WITHOUT changing it on disk beyond one extra manifest key:

* **per-array checksums** — ``ckpt.save`` stamps an ``integrity`` block into
  ``manifest.json``: a CRC32 per stored leaf plus a SHA-256 digest of the
  rest of the manifest, so bit rot in either file is detected at restore,
  with the failing array NAMED in the error.  The CRCs are HARVESTED from
  the zip central directory of the just-written ``arrays.npz`` (``zipfile``
  computes them during the write anyway), so stamping costs microseconds
  regardless of tree size — recomputing them would double the write cost of
  large checkpoints through this container's ~0.5 GB/s zlib;
* **verify-on-restore** — :func:`verify_step_dir` re-reads the npz and
  recomputes every checksum; any mismatch / unreadable member / missing file
  raises :class:`CorruptCheckpointError`.  Pre-integrity checkpoints (no
  ``integrity`` block) verify as ``"legacy"`` — accepted, since there is
  nothing to check against;
* **generation fallback** — checkpoints already form an append-only chain of
  ``step_*`` generations (keep-last-k, each manifest records its ``parent``
  generation).  :func:`latest_verified_step` walks the chain newest-first,
  **quarantines** corrupt generations (rename to ``.quarantine_*`` — never
  delete, the bytes stay for forensics) and returns the newest generation
  that verifies.  :func:`verified_restore` / :func:`verified_raw_leaves` are
  the drop-in wrappers the supervisor rollback, elastic resume, and bundle
  load route through, so a poisoned latest checkpoint costs one generation of
  progress instead of the run.

The clean path is bitwise-unchanged: verification only READS; the restore
itself is still :func:`repro_torch.checkpoint.ckpt.restore` (asserted bitwise in
``tests/test_integrity.py``).  Measured write overhead is bounded at 5% by
``benchmarks/chaos_soak.py``.
"""
from __future__ import annotations

import hashlib
import json
import os
import zipfile
import zlib
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

# "crc32-npz": CRCs are the npz zip members' own (over the serialized .npy
# member bytes, harvested from the central directory).  "crc32" is the
# legacy data-bytes scheme — still verifiable, no longer written.
ALGO = "crc32-npz"


class IntegrityError(RuntimeError):
    """Base for durable-state integrity failures."""


class CorruptCheckpointError(IntegrityError):
    """A checkpoint/bundle generation failed verification.

    ``path`` is the step directory, ``reason`` the human-readable cause, and
    ``array`` (when the corruption localizes) the failing npz member name."""

    def __init__(self, path: str, reason: str, array: str | None = None):
        self.path, self.reason, self.array = str(path), reason, array
        at = f" (array {array!r})" if array else ""
        super().__init__(f"corrupt checkpoint {path}{at}: {reason}")


class NoVerifiedCheckpointError(IntegrityError):
    """Every candidate generation failed verification (or none exist).

    ``failures`` keeps the per-generation :class:`CorruptCheckpointError`
    list, newest first, so callers can surface WHICH array/file rotted
    instead of just "nothing verified"."""

    def __init__(self, msg: str, failures=()):
        super().__init__(msg)
        self.failures = list(failures)


@dataclass
class RestoreInfo:
    """What the generation walk found: the step restored, how many corrupt
    generations were skipped to reach it, and what got quarantined."""

    step: int
    fallback_depth: int = 0                 # 0 = newest generation verified
    status: str = "verified"                # "verified" | "legacy"
    quarantined: list = field(default_factory=list)  # [(dirname, reason)]


# -------------------------------------------------------------- construction

def _array_bytes(x) -> bytes:
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def array_checksum(x) -> str:
    """CRC32 (hex) over an array's raw data bytes — the legacy ``"crc32"``
    integrity unit (verification-only; the write path harvests zip CRCs)."""
    return f"{zlib.crc32(_array_bytes(x)) & 0xFFFFFFFF:08x}"


def npz_member_crcs(npz_path: str) -> dict[str, str]:
    """Member-name -> CRC32 (hex) from the npz's zip central directory.

    ``zipfile`` computed these while ``np.savez`` wrote the file, so this is
    a directory read — microseconds, independent of array bytes.  Keys drop
    the ``.npy`` suffix to match the manifest's leaf naming."""
    with zipfile.ZipFile(npz_path) as z:
        return {(i.filename[:-4] if i.filename.endswith(".npy")
                 else i.filename): f"{i.CRC & 0xFFFFFFFF:08x}"
                for i in z.infolist()}


def manifest_digest(manifest: dict) -> str:
    """SHA-256 over the canonical JSON of the manifest MINUS its own
    integrity block.  ``json.dumps`` serializes tuples/lists identically, so
    the digest survives the write->parse round trip."""
    clean = {k: v for k, v in manifest.items() if k != "integrity"}
    return hashlib.sha256(
        json.dumps(clean, sort_keys=True).encode()).hexdigest()


def npz_structure_crc(npz_path: str) -> str:
    """CRC32 over every NON-member-data byte of the npz zip container.

    Member DATA is covered by the per-member zip CRCs; this covers the rest
    — local headers, gaps, the central directory, the end record — i.e. the
    bytes ``zipfile`` never validates on read (local mod-times, duplicated
    CRC/name fields, ...).  Together the two leave no byte of the file
    unchecked.  The structure is a few KB regardless of array bytes, so
    both stamping and verifying it are O(headers), not O(data)."""
    import struct

    with zipfile.ZipFile(npz_path) as z:
        infos = sorted(z.infolist(), key=lambda i: i.header_offset)
    crc, pos = 0, 0
    with open(npz_path, "rb") as f:
        for i in infos:
            f.seek(i.header_offset)
            hdr = f.read(30)  # local header: name/extra lens at 26/28
            if len(hdr) < 30 or hdr[:4] != b"PK\x03\x04":
                raise zipfile.BadZipFile(
                    f"bad local header for {i.filename!r}")
            n, m = struct.unpack("<HH", hdr[26:30])
            data_start = i.header_offset + 30 + n + m
            f.seek(pos)
            crc = zlib.crc32(f.read(data_start - pos), crc)
            pos = data_start + i.compress_size
        f.seek(pos)
        crc = zlib.crc32(f.read(), crc)  # central directory + end record
    return f"{crc & 0xFFFFFFFF:08x}"


def build_integrity(manifest: dict, npz_path: str,
                    parent: str | None = None) -> dict:
    """The ``integrity`` block ``ckpt.save`` stamps into the manifest:
    per-array CRC32s (harvested from the just-written npz), the container
    structure CRC, the manifest digest, and the parent generation name (the
    append-only chain edge)."""
    return {
        "algo": ALGO,
        "arrays": npz_member_crcs(npz_path),
        "structure_crc32": npz_structure_crc(npz_path),
        "manifest_sha256": manifest_digest(manifest),
        "parent": parent,
    }


# -------------------------------------------------------------- verification

def verify_step_dir(d: str) -> str:
    """Verify one generation directory end to end.

    Returns ``"verified"`` (integrity block present, everything checks) or
    ``"legacy"`` (pre-integrity checkpoint: structurally readable, nothing to
    check against).  Raises :class:`CorruptCheckpointError` naming the
    failing file/array otherwise.  Read-only — never mutates the directory.
    """
    man_path = os.path.join(d, "manifest.json")
    npz_path = os.path.join(d, "arrays.npz")
    if not os.path.exists(man_path):
        raise CorruptCheckpointError(d, "manifest.json missing")
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CorruptCheckpointError(
            d, f"manifest.json unreadable: {e}") from e
    if not isinstance(manifest, dict) or "paths" not in manifest:
        raise CorruptCheckpointError(d, "manifest.json malformed (no paths)")
    integ = manifest.get("integrity")
    if not os.path.exists(npz_path):
        raise CorruptCheckpointError(d, "arrays.npz missing")
    if integ is None:
        # legacy artifact: confirm the npz at least opens, then accept
        try:
            with np.load(npz_path) as data:
                list(data.files)
        except Exception as e:
            raise CorruptCheckpointError(
                d, f"arrays.npz unreadable: {e}") from e
        return "legacy"
    want_digest = integ.get("manifest_sha256")
    if want_digest != manifest_digest(manifest):
        raise CorruptCheckpointError(
            d, "manifest digest mismatch (manifest.json corrupted)")
    legacy_algo = integ.get("algo") == "crc32"  # data-bytes CRCs, recompute
    try:
        stored = {} if legacy_algo else npz_member_crcs(npz_path)
        data = np.load(npz_path)
    except Exception as e:
        raise CorruptCheckpointError(d, f"arrays.npz unreadable: {e}") from e
    try:
        if not legacy_algo:
            # pass 1 — directory CRCs vs the manifest record: a rotten
            # directory entry or a swapped-in foreign npz fails HERE, with
            # the offending array named (cheap: no data read yet)
            for name, want in integ["arrays"].items():
                if name not in stored:
                    raise CorruptCheckpointError(
                        d, "array missing from arrays.npz", array=name)
                if stored[name] != want:
                    raise CorruptCheckpointError(
                        d, f"checksum mismatch ({stored[name]} != {want})",
                        array=name)
            # pass 2 — the container bytes zipfile never validates on read
            # (local headers, gaps, the directory itself)
            want_struct = integ.get("structure_crc32")
            if (want_struct is not None
                    and npz_structure_crc(npz_path) != want_struct):
                raise CorruptCheckpointError(
                    d, "zip structure checksum mismatch (npz headers/"
                       "directory corrupted)")
        # pass 3 — read every recorded member: zipfile verifies its internal
        # CRC over the actual data bytes (bit rot / truncation / torn tail),
        # and pass 1 pinned WHICH bytes those CRCs must describe
        for name, want in integ["arrays"].items():
            if name not in data.files:
                raise CorruptCheckpointError(
                    d, "array missing from arrays.npz", array=name)
            try:
                arr = data[name]
            except Exception as e:  # truncated/torn member: zlib/zipfile err
                raise CorruptCheckpointError(
                    d, f"array unreadable: {e}", array=name) from e
            if legacy_algo and array_checksum(arr) != want:
                raise CorruptCheckpointError(
                    d, f"checksum mismatch ({array_checksum(arr)} != {want})",
                    array=name)
    finally:
        data.close()
    return "verified"


# ----------------------------------------------------- quarantine + fallback

QUARANTINE_PREFIX = ".quarantine_"


def quarantine(d: str, reason: str = "corrupt") -> str:
    """Move a corrupt generation aside — RENAME, never delete.  The hidden
    ``.quarantine_*`` name is invisible to every ``step_*`` scan (restore,
    GC, LATEST fallback) but keeps the bytes on disk for forensics."""
    root, name = os.path.split(os.path.normpath(d))
    target = os.path.join(root, QUARANTINE_PREFIX + name)
    n = 0
    while os.path.exists(target):
        n += 1
        target = os.path.join(root, f"{QUARANTINE_PREFIX}{name}.{n}")
    os.rename(d, target)
    return target


def generations(root: str) -> list[tuple[int, str]]:
    """Readable ``(step, dirname)`` generations, NEWEST FIRST (the fallback
    walk order).  Delegates the unreadable-dir skip to ``ckpt._step_dirs``."""
    from repro_torch.checkpoint import ckpt

    return list(reversed(ckpt._step_dirs(root)))


def latest_verified_step(root: str, max_fallback: int | None = None,
                         do_quarantine: bool = True,
                         on_event: Callable | None = None) -> RestoreInfo:
    """Walk the generation chain newest-first; return the first generation
    that verifies, quarantining every corrupt one passed on the way.

    ``max_fallback`` bounds how many corrupt generations may be skipped
    (None = all available); ``on_event(kind, **fields)`` receives a
    ``corruption`` callback per quarantined generation and one ``fallback``
    callback when the verified generation is not the newest (the supervisor
    wires this to :meth:`repro_torch.obs.Obs.emit`).  Raises
    :class:`NoVerifiedCheckpointError` when nothing survives.
    """
    gens = generations(root)
    if not gens:
        raise NoVerifiedCheckpointError(f"no checkpoint generations under {root}")
    info = RestoreInfo(step=-1)
    failures = []
    for depth, (step, name) in enumerate(gens):
        if max_fallback is not None and depth > max_fallback:
            break
        d = os.path.join(root, name)
        try:
            status = verify_step_dir(d)
        except CorruptCheckpointError as e:
            where = quarantine(d, e.reason) if do_quarantine else d
            info.quarantined.append((name, str(e)))
            failures.append(e)
            if on_event is not None:
                on_event("corruption", target="ckpt", reason=str(e),
                         path=os.path.basename(where))
            continue
        info.step, info.fallback_depth, info.status = step, depth, status
        if depth and on_event is not None:
            on_event("fallback", target="ckpt", depth=depth)
        return info
    raise NoVerifiedCheckpointError(
        f"no verified checkpoint under {root} within "
        f"{len(info.quarantined)} generation(s): "
        + "; ".join(r for _n, r in info.quarantined), failures=failures)


# ------------------------------------------------------------ restore wrappers

def verified_restore(root: str, like, step: int | None = None,
                     allow_restructure: bool = False,
                     max_fallback: int | None = None,
                     on_event: Callable | None = None):
    """Verify-then-restore: the durable replacement for ``ckpt.restore``.

    With ``step`` given, that exact generation must verify (no fallback —
    an explicit step is a contract).  Without it, the generation walk picks
    the newest verified one.  Returns ``(tree, metadata, RestoreInfo)``;
    the restore itself is the unmodified ``ckpt.restore``, so a clean
    artifact restores bitwise-identically to the pre-integrity path."""
    from repro_torch.checkpoint import ckpt

    if step is not None:
        d = os.path.join(root, f"step_{step:010d}")
        status = verify_step_dir(d)
        info = RestoreInfo(step=step, status=status)
    else:
        info = latest_verified_step(root, max_fallback=max_fallback,
                                    on_event=on_event)
    tree, meta = ckpt.restore(root, like, step=info.step,
                              allow_restructure=allow_restructure)
    return tree, meta, info


def verified_raw_leaves(root: str, step: int | None = None,
                        max_fallback: int | None = None,
                        on_event: Callable | None = None):
    """Verified counterpart of ``ckpt.raw_leaves`` (elastic resume's entry).
    Returns ``(leaves, manifest, RestoreInfo)``."""
    from repro_torch.checkpoint import ckpt

    if step is not None:
        status = verify_step_dir(os.path.join(root, f"step_{step:010d}"))
        info = RestoreInfo(step=step, status=status)
    else:
        info = latest_verified_step(root, max_fallback=max_fallback,
                                    on_event=on_event)
    leaves, manifest = ckpt.raw_leaves(root, step=info.step)
    return leaves, manifest, info
