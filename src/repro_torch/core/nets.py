"""Per-subdomain PINN networks (paper §3 + adaptive activations of refs [26, 27]).

PyTorch counterpart of the reference package's ``core/nets.py``.  Every
subdomain may use a different network; with uniform stacked shapes the
semantics are kept by:

* a per-subdomain integer activation code selecting tanh / sin / cos (Table 3),
* trainable per-layer adaptive slopes ``a`` (phi(a * z), ref [26]),
* per-subdomain width masks (narrower nets mask the extra columns).

Parameters for one subdomain are a dict ``{"W": [..], "b": [..], "a": ..}``;
stacked parameters carry a leading ``n_sub`` axis on every leaf — the same
nested layout (and the same checkpoint paths) as the reference, so weights
cross as numpy arrays through :func:`params_from_numpy` /
:func:`params_to_numpy`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

ACT_TANH, ACT_SIN, ACT_COS = 0, 1, 2
_ACT_NAMES = {"tanh": ACT_TANH, "sin": ACT_SIN, "cos": ACT_COS}


def act_name(code: int | str) -> str:
    """Concrete activation code/name -> canonical name (inverse of _ACT_NAMES).
    Used by the fused-kernel dispatch, which specializes on the name."""
    if isinstance(code, str):
        if code not in _ACT_NAMES:
            raise ValueError(f"unknown activation {code!r}")
        return code
    return {v: k for k, v in _ACT_NAMES.items()}[int(code)]


def act_code(name: str | int) -> int:
    """Canonical name/code -> concrete activation code (inverse of act_name)."""
    return _ACT_NAMES[act_name(name)]


def activation(z: torch.Tensor, code) -> torch.Tensor:
    """Branchless activation select (``code`` a scalar or a tensor that
    broadcasts against ``z``)."""
    code = torch.as_tensor(code, device=z.device)
    return torch.where(code == ACT_TANH, torch.tanh(z),
                       torch.where(code == ACT_SIN, torch.sin(z),
                                   torch.cos(z)))


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int
    out_dim: int
    width: int
    depth: int  # number of HIDDEN layers (paper's "L hidden layers")
    adaptive: bool = True          # trainable slope a (ref [26]); a=1 frozen otherwise
    slope_scale: float = 1.0       # paper's scaled slope n*a uses a fixed scale n
    act: str = "tanh"              # model-declared activation (per-subdomain
                                   # act_codes override it)

    @property
    def layer_dims(self) -> list[tuple[int, int]]:
        dims = [self.in_dim] + [self.width] * self.depth + [self.out_dim]
        return list(zip(dims[:-1], dims[1:]))


def init_mlp(cfg: MLPConfig, generator: torch.Generator,
             dtype=torch.float32) -> dict:
    """Xavier/Glorot normal init drawn from ``generator`` (on the CPU)."""
    Ws, bs = [], []
    for fan_in, fan_out in cfg.layer_dims:
        std = float(np.sqrt(2.0 / (fan_in + fan_out)))
        Ws.append(torch.randn((fan_in, fan_out), generator=generator,
                              dtype=dtype) * std)
        bs.append(torch.zeros((fan_out,), dtype=dtype))
    a = torch.ones((cfg.depth,), dtype=dtype)  # one slope per hidden layer
    return {"W": Ws, "b": bs, "a": a}


def mlp_apply(cfg: MLPConfig, params: dict, x: torch.Tensor,
              act_code=ACT_TANH, width_mask: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Forward pass; last layer linear (paper §3).  ``x`` (..., n, in_dim);
    stacked params broadcast over the leading axes."""
    h = x
    n_layers = len(params["W"])
    for i, (W, b) in enumerate(zip(params["W"], params["b"])):
        h = h @ W + b[..., None, :]
        if i < n_layers - 1:  # hidden layers only
            a = params["a"][..., i, None, None] if cfg.adaptive else 1.0
            h = activation(cfg.slope_scale * a * h, act_code)
            if width_mask is not None:
                h = h * width_mask[..., None, :]
    return h


@dataclass(frozen=True)
class SubdomainModelConfig:
    """The full per-subdomain model: one net per FIELD (forward problems have a
    single field net; the §7.6 inverse problem uses two — 'u' and 'k')."""

    nets: dict[str, MLPConfig] = field(default_factory=dict)

    @property
    def out_dim(self) -> int:
        return sum(c.out_dim for c in self.nets.values())

    @property
    def field_slices(self) -> dict[str, slice]:
        out, ofs = {}, 0
        for name, c in self.nets.items():
            out[name] = slice(ofs, ofs + c.out_dim)
            ofs += c.out_dim
        return out


def uniform_model_act(cfg: SubdomainModelConfig) -> str:
    """The single activation declared by ALL field nets of a model config."""
    acts = {c.act for c in cfg.nets.values()}
    if len(acts) != 1:
        raise ValueError(
            f"field nets declare mixed activations {sorted(acts)}; model_apply "
            "evaluates all nets with one activation code")
    (act,) = acts
    if act not in _ACT_NAMES:
        raise ValueError(f"unknown activation {act!r}")
    return act


def init_model(cfg: SubdomainModelConfig, generator: torch.Generator) -> dict:
    return {name: init_mlp(c, generator) for name, c in cfg.nets.items()}


def model_apply(cfg: SubdomainModelConfig, params: dict, x: torch.Tensor,
                act_code=ACT_TANH, width_masks: dict | None = None
                ) -> torch.Tensor:
    """Concatenated field outputs, (..., n, sum(out_dim))."""
    outs = []
    for name, c in cfg.nets.items():
        wm = None if width_masks is None else width_masks.get(name)
        outs.append(mlp_apply(c, params[name], x, act_code, wm))
    return torch.cat(outs, dim=-1)


def scalar_field_fn(cfg, params, act_code, width_masks=None):
    """Closure x -> (out_dim,) for a SINGLE point (x of shape (dim,)): the
    form the per-point PDE oracles differentiate with ``torch.func.jvp``
    (batched over points and subdomains by ``torch.func.vmap``)."""

    def fn(x1: torch.Tensor) -> torch.Tensor:
        return model_apply(cfg, params, x1[None, :], act_code,
                           width_masks)[0]

    return fn


def _stack_trees(trees: list):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in t0}
    if isinstance(t0, list):
        return [_stack_trees([t[i] for t in trees]) for i in range(len(t0))]
    return torch.stack(trees)


def stacked_init(cfg: SubdomainModelConfig, n_sub: int,
                 generator: torch.Generator | int,
                 act_codes: Sequence[str | int] | None = None,
                 device=None) -> tuple[dict, torch.Tensor]:
    """Independent init per subdomain, stacked on a leading axis, plus the
    per-subdomain activation-code vector (paper Table 3 heterogeneity).

    ``generator`` is a CPU ``torch.Generator`` or an int seed for one."""
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    params = _stack_trees([init_model(cfg, generator) for _ in range(n_sub)])
    if act_codes is None:
        codes = np.full((n_sub,), _ACT_NAMES[uniform_model_act(cfg)], np.int32)
    else:
        codes = np.array(
            [_ACT_NAMES[c] if isinstance(c, str) else int(c) for c in act_codes],
            np.int32)
        if len(codes) != n_sub:
            raise ValueError(f"{len(codes)} act codes for {n_sub} subdomains")
    params = map_tree(lambda t: t.to(device), params) if device else params
    return params, torch.as_tensor(codes, device=device)


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def map_trees(fn, *trees):
    """``fn`` over the matching leaves of several trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: map_trees(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(map_trees(fn, *(t[i] for t in trees))
                        for i in range(len(t0)))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list / tuple tree in the reference's
    flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _unflatten(t, it):
    if isinstance(t, dict):
        out = {k: _unflatten(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_unflatten(v, it) for v in t)
    return next(it)


def tree_unflatten(like, leaves):
    """Rebuild ``like``'s structure from leaves in :func:`tree_leaves`
    order.  No recursive closure: one that refers to itself is a reference
    cycle, which would keep ``leaves`` (an LM step's gradients) alive until
    the cyclic collector runs."""
    return _unflatten(like, iter(leaves))


def params_from_numpy(tree, device=None, dtype=torch.float32):
    """The reference's stacked params (numpy arrays, or anything
    ``np.asarray`` takes; tensors pass through) -> the port's tensors on
    ``device``."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype)
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)
    return map_tree(conv, tree)


def params_to_numpy(tree):
    """The port's tensors -> numpy arrays (the reference's input form);
    numpy leaves pass through."""
    return map_tree(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else np.asarray(t), tree)
