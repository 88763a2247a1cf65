"""Frozen field artifacts: export a trained cPINN/XPINN, load it anywhere.

Counterpart of the reference package's ``serve/export.py``, on the same
on-disk format: an exported bundle is a :mod:`repro_torch.checkpoint.ckpt`
checkpoint directory (npz + manifest, atomic publication, keep-last-k) whose
manifest metadata freezes everything needed to rebuild an inference-ready
object — the per-field :class:`~repro_torch.core.nets.MLPConfig` stack,
per-subdomain activation codes and width masks, the decomposition geometry
plus ``n_iface``, and the PDE identity + constructor fields.  Bundles
therefore cross between the two packages in both directions.

``load_bundle`` returns a :class:`FieldBundle` with CPU float32 tensors;
feed it to :class:`repro_torch.serve.engine.FieldEngine`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.checkpoint import ckpt, integrity
from repro_torch.core.domain import (
    CartesianDecomposition, Decomposition, PolygonDecomposition, Topology,
    build_topology,
)
from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig, act_code,
                                   params_from_numpy, uniform_model_act)
from repro_torch.core.pdes import PDE, REGISTRY

FORMAT = "repro.serve.bundle/1"   # shared with the reference package


class CorruptBundleError(RuntimeError):
    """An exported bundle failed verification or could not be decoded.

    ``file`` names the failing file inside the bundle generation, ``array``
    the failing npz member (when the corruption localizes), and ``field``
    the bundle field that member belongs to (``params/u``, ...)."""

    def __init__(self, root: str, reason: str, file: str | None = None,
                 array: str | None = None, field: str | None = None):
        self.root, self.reason = str(root), reason
        self.file, self.array, self.field = file, array, field
        at = "".join([f" file={file}" if file else "",
                      f" array={array}" if array else "",
                      f" field={field}" if field else ""])
        super().__init__(f"corrupt bundle under {root}{at}: {reason}")


def _leaf_field(manifest: dict | None, array: str | None) -> str | None:
    """Map an npz member name (``leaf_00017``) back to the bundle field its
    path names."""
    if manifest is None or array is None or not array.startswith("leaf_"):
        return None
    try:
        path = manifest["paths"][int(array.split("_", 1)[1])]
    except (KeyError, IndexError, ValueError):
        return None
    return path


@dataclass
class FieldBundle:
    """Everything the inference engine needs, trainer-free.

    ``params`` are the STACKED per-subdomain parameters (leading n_sub axis;
    tensors, or numpy arrays that the engine converts); ``act_codes`` is an
    (n_sub,) int vector; ``width_masks`` the optional per-net (n_sub, width)
    capacity masks."""

    model_cfg: SubdomainModelConfig
    params: Any
    decomp: Decomposition
    act_codes: np.ndarray | None = None
    width_masks: dict | None = None
    pde: PDE | None = None
    n_iface: int = 16
    metadata: dict = dataclasses.field(default_factory=dict)

    @property
    def n_sub(self) -> int:
        return self.decomp.n_sub

    def topology(self) -> Topology:
        """Rebuild the exchange topology frozen with the bundle."""
        return build_topology(self.decomp, self.n_iface)


# ------------------------------------------------------------- geometry specs

def decomp_spec(decomp: Decomposition) -> dict:
    if isinstance(decomp, CartesianDecomposition):
        return {"kind": "cartesian", "bounds": [list(b) for b in decomp.bounds],
                "nx": decomp.nx, "ny": decomp.ny}
    if isinstance(decomp, PolygonDecomposition):
        return {"kind": "polygon",
                "polygons": [p.tolist() for p in decomp.polygons],
                "tol": decomp.tol}
    raise TypeError(f"cannot serialize decomposition {type(decomp).__name__}")


def decomp_from_spec(spec: dict) -> Decomposition:
    if spec["kind"] == "cartesian":
        return CartesianDecomposition(spec["bounds"], spec["nx"], spec["ny"])
    if spec["kind"] == "polygon":
        return PolygonDecomposition([np.asarray(p) for p in spec["polygons"]],
                                    tol=spec.get("tol", 1e-9))
    raise ValueError(f"unknown decomposition kind {spec['kind']!r}")


def _pde_spec(pde: PDE | None) -> dict | None:
    if pde is None:
        return None
    return {"name": pde.name, "fields": dataclasses.asdict(pde)}


def _pde_from_spec(spec: dict | None) -> PDE | None:
    if spec is None:
        return None
    return REGISTRY[spec["name"]](**spec["fields"])


def _normalize_codes(act_codes, model_cfg: SubdomainModelConfig,
                     n_sub: int) -> np.ndarray:
    if act_codes is None:
        return np.full((n_sub,), act_code(uniform_model_act(model_cfg)),
                       np.int32)
    if hasattr(act_codes, "detach"):
        act_codes = act_codes.detach().cpu().numpy()
    return np.array([act_code(c) if isinstance(c, str) else int(c)
                     for c in np.asarray(act_codes).tolist()], np.int32)


# ------------------------------------------------------------- export / load

def export_bundle(root: str, params: Any, model_cfg: SubdomainModelConfig,
                  decomp: Decomposition, act_codes=None,
                  width_masks: dict | None = None, pde: PDE | None = None,
                  n_iface: int = 16, step: int = 0,
                  metadata: dict | None = None) -> str:
    """Freeze a field into a self-contained serve artifact.

    ``params`` is the stacked params tree (tensors or numpy arrays); returns
    the checkpoint directory written (atomic, like any checkpoint save)."""
    n_sub = decomp.n_sub
    codes = _normalize_codes(act_codes, model_cfg, n_sub)
    tree = {"params": params}
    if width_masks is not None:
        tree["width_masks"] = width_masks
    meta = {
        "format": FORMAT,
        "model": {name: dataclasses.asdict(c)
                  for name, c in model_cfg.nets.items()},
        "act_codes": codes.tolist(),
        "width_mask_nets": (sorted(width_masks) if width_masks else []),
        "decomp": decomp_spec(decomp),
        "pde": _pde_spec(pde),
        "n_iface": int(n_iface),
        "user": metadata or {},
    }
    return ckpt.save(root, step, tree, metadata=meta)


def _params_template(model_cfg: SubdomainModelConfig, n_sub: int) -> dict:
    out = {}
    for name, c in model_cfg.nets.items():
        out[name] = {
            "W": [np.zeros((n_sub, fi, fo), np.float32)
                  for fi, fo in c.layer_dims],
            "b": [np.zeros((n_sub, fo), np.float32)
                  for _, fo in c.layer_dims],
            "a": np.zeros((n_sub, c.depth), np.float32),
        }
    return out


def load_bundle(root: str, step: int | None = None, verify: bool = True,
                max_fallback: int = 0) -> FieldBundle:
    """Load an exported bundle into an inference-ready :class:`FieldBundle`.

    ``verify=True`` (the default) checks the generation's integrity envelope
    BEFORE constructing anything: any corruption raises
    :class:`CorruptBundleError` naming the failing file/array/field, and a
    corrupt bundle never reaches the engine.  ``max_fallback`` > 0 lets the
    load walk back through older generations, skipping corrupt ones
    (read-only: nothing is quarantined); the default 0 makes a corrupt
    newest generation a hard, typed failure.
    """
    def _from_ckpt_err(e: integrity.CorruptCheckpointError,
                       cause: BaseException) -> CorruptBundleError:
        gen = os.path.basename(e.path)
        which = ("arrays.npz" if e.array or "arrays.npz" in e.reason
                 else "manifest.json")
        man = None
        try:
            with open(os.path.join(e.path, "manifest.json")) as f:
                man = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            pass
        err = CorruptBundleError(root, e.reason, file=f"{gen}/{which}",
                                 array=e.array,
                                 field=_leaf_field(man, e.array))
        err.__cause__ = cause
        return err

    try:
        if step is None:
            if not integrity.generations(root):
                raise FileNotFoundError(f"no bundle under {root}")
            if verify:
                step = integrity.latest_verified_step(
                    root, max_fallback=max_fallback,
                    do_quarantine=False).step
            else:
                step = ckpt.latest_step(root)
        elif verify:
            integrity.verify_step_dir(os.path.join(root, f"step_{step:010d}"))
        with open(os.path.join(root, f"step_{step:010d}",
                               "manifest.json")) as f:
            meta = json.load(f)["metadata"]
    except integrity.NoVerifiedCheckpointError as e:
        if e.failures:  # surface the newest generation's localized failure
            raise _from_ckpt_err(e.failures[0], e)
        raise CorruptBundleError(root, str(e)) from e
    except integrity.CorruptCheckpointError as e:
        raise _from_ckpt_err(e, e)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError, KeyError) as e:
        if isinstance(e, FileNotFoundError) and e.filename is None:
            raise   # the typed no-bundle miss above, not a decode failure
        raise CorruptBundleError(root, f"manifest unreadable: {e}",
                                 file="manifest.json") from e
    if meta.get("format") != FORMAT:
        raise ValueError(f"{root} is not a serve bundle "
                         f"(format={meta.get('format')!r})")
    model_cfg = SubdomainModelConfig(
        nets={name: MLPConfig(**fields) for name, fields in meta["model"].items()})
    decomp = decomp_from_spec(meta["decomp"])
    n_sub = decomp.n_sub
    like = {"params": _params_template(model_cfg, n_sub)}
    if meta["width_mask_nets"]:
        widths = {name: model_cfg.nets[name].width
                  for name in meta["width_mask_nets"]}
        like["width_masks"] = {name: np.zeros((n_sub, w), np.float32)
                               for name, w in widths.items()}
    try:
        tree, _ = ckpt.restore(root, like, step=step)
    except Exception as e:
        # legacy (pre-integrity) bundle with a rotten npz: the verify pass
        # had nothing to check, so the decode error surfaces here — typed
        raise CorruptBundleError(root, f"arrays.npz undecodable: {e}",
                                 file="arrays.npz") from e
    return FieldBundle(
        model_cfg=model_cfg,
        params=params_from_numpy(tree["params"]),
        decomp=decomp,
        act_codes=np.asarray(meta["act_codes"], np.int32),
        width_masks=(params_from_numpy(tree["width_masks"])
                     if meta["width_mask_nets"] else None),
        pde=_pde_from_spec(meta["pde"]),
        n_iface=meta["n_iface"],
        metadata=meta["user"],
    )
