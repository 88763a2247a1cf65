"""Memory-limited BFGS (paper §6: the Sandblaster distributed L-BFGS reference).

Counterpart of the reference package's ``optim/lbfgs.py``, with its
semantics kept exactly.  Standard PINN practice (and the paper's lineage,
Raissi et al.) is Adam for the bulk of training, then L-BFGS for
refinement.

* a fixed-size history of ``m`` curvature pairs kept as stacked tensors in
  a circular buffer, and the classic two-loop recursion over it;
* γ from the newest pair, or 1/|g| before any pair exists (a unit-length
  first direction);
* a backtracking Armijo search over a fixed ladder of ``n_probes`` step
  sizes ``max_step * 0.5**j``: every probe is evaluated, the first
  acceptable one is taken, and the step is REJECTED when none is (monotone
  by construction);
* a pair is kept only when ``s·y > eps`` (the curvature condition).

Every decision is a ``torch.where`` on the device, so an iteration does not
wait for the card.  The probes need no gradient: they run under
``torch.no_grad``, one loss evaluation each (on a card, the fused PINN
losses then take the forward-only kernel K2), where the reference batches
them with ``jax.vmap``.  The gradients (two per iteration, at the start
and at the accepted point, as in the reference) go through autograd (K3
forward, K4 backward on the fused path).

The flat parameter vector follows the reference's flatten order: dict keys
sorted, lists in order (``nets.tree_leaves``), so ``s``, ``y`` and
``prev_flat`` compare element by element with the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.nets import tree_leaves, tree_unflatten

Pytree = Any


@dataclass(frozen=True)
class LBFGSConfig:
    history: int = 10
    max_step: float = 1.0
    armijo_c1: float = 1e-4
    n_probes: int = 14         # backtracking ladder: max_step * 0.5**j
    eps: float = 1e-10


def _flatten(tree: Pytree):
    """(flat float32 vector, unflatten) in the reference's leaf order."""
    leaves = tree_leaves(tree)
    shapes = [l.shape for l in leaves]
    sizes = [l.numel() for l in leaves]
    flat = (torch.cat([l.reshape(-1) for l in leaves]) if leaves
            else torch.zeros((0,)))

    def unflatten(v):
        return tree_unflatten(tree, [p.reshape(sh) for p, sh in
                                     zip(torch.split(v, sizes), shapes)])
    return flat, unflatten


def _value_and_grad(loss_fn: Callable, params: Pytree):
    """(loss, flat gradient) of ``loss_fn`` at ``params`` (detached)."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    g = torch.cat([(torch.zeros_like(t) if gr is None else gr).reshape(-1)
                   for gr, t in zip(grads, leaves)])
    return loss.detach(), g


def init_lbfgs(params: Pytree, cfg: LBFGSConfig = LBFGSConfig()) -> dict:
    flat, _ = _flatten(params)
    flat = flat.detach()
    n = flat.shape[0]
    z = dict(dtype=flat.dtype, device=flat.device)
    return {
        "s": torch.zeros((cfg.history, n), **z),   # param deltas
        "y": torch.zeros((cfg.history, n), **z),   # grad deltas
        "rho": torch.zeros((cfg.history,), **z),
        "count": torch.zeros((), dtype=torch.int32, device=flat.device),
        "prev_flat": flat.clone(),
        "prev_grad": torch.zeros_like(flat),
    }


def _two_loop(g, s, y, rho, count, m, eps):
    """Standard L-BFGS two-loop recursion over a circular history buffer."""
    ar = torch.arange(m, device=g.device)
    idxs = ((count - 1 - ar) % m).long()            # newest -> oldest
    valid = ar < torch.clamp(count, max=m)
    q, alphas = g, []
    for i in range(m):
        j = idxs[i]
        a = torch.where(valid[i], rho[j] * torch.dot(s[j], q), 0.0)
        q = q - a * y[j] * valid[i]
        alphas.append(a)

    # initial Hessian scaling: gamma = s.y/y.y of the newest pair; before any
    # curvature pair exists, 1/|g| (unit-norm first direction so the Armijo
    # ladder's largest probe is a max_step-length move, not |g|*max_step)
    jn = ((count - 1) % m).long()
    yy = torch.dot(y[jn], y[jn])
    g_norm = torch.sqrt(torch.dot(q, q))
    gamma = torch.where(count > 0, torch.dot(s[jn], y[jn]) / (yy + eps),
                        1.0 / (g_norm + eps))
    r = gamma * q
    for i in range(m):
        ii = m - 1 - i                              # oldest -> newest
        j = idxs[ii]
        b = torch.where(valid[ii], rho[j] * torch.dot(y[j], r), 0.0)
        r = r + (alphas[ii] - b) * s[j] * valid[ii]
    return r


def lbfgs_step(loss_fn: Callable, params: Pytree, state: dict,
               cfg: LBFGSConfig = LBFGSConfig()):
    """One L-BFGS iteration. loss_fn: params -> scalar tensor.  Returns
    (params, state, loss), every one on the params' device."""
    flat, unflatten = _flatten(params)
    flat = flat.detach()
    loss, g = _value_and_grad(loss_fn, params)
    m = cfg.history

    d = -_two_loop(g, state["s"], state["y"], state["rho"], state["count"],
                   m, cfg.eps)
    # safeguard: fall back to steepest descent on a non-descent direction
    descent = torch.dot(d, g)
    g_norm = torch.sqrt(torch.dot(g, g)) + cfg.eps
    d = torch.where(descent < 0, d, -g / g_norm)
    descent = torch.where(descent < 0, descent, -g_norm)

    # backtracking Armijo search over a fixed ladder of step sizes, every
    # probe evaluated (no gradient: the forward-only kernels on a card)
    steps = cfg.max_step * 0.5 ** torch.arange(
        cfg.n_probes, dtype=flat.dtype, device=flat.device)
    with torch.no_grad():
        losses = torch.stack([loss_fn(unflatten(flat + steps[j] * d))
                              for j in range(cfg.n_probes)])
    ok = losses <= loss + cfg.armijo_c1 * steps * descent
    # first acceptable probe; if none, REJECT the step (monotone by
    # construction; the curvature pair degenerates to zero and is skipped)
    first = torch.argmax(ok.to(torch.int32))
    any_ok = torch.any(ok)
    t = torch.where(any_ok, steps[first], 0.0)
    new_flat = flat + t * d
    new_loss = torch.where(any_ok, losses[first], loss)

    new_params = unflatten(new_flat)
    _, new_g = _value_and_grad(loss_fn, new_params)
    s_vec, y_vec = new_flat - flat, new_g - g
    sy = torch.dot(s_vec, y_vec)
    slot = (state["count"] % m).long()
    keep = sy > cfg.eps                              # curvature condition

    def put(buf, v):
        new = buf.clone()
        new[slot] = v
        return torch.where(keep, new, buf)

    new_state = {
        "s": put(state["s"], s_vec),
        "y": put(state["y"], y_vec),
        "rho": put(state["rho"], 1.0 / (sy + cfg.eps)),
        "count": state["count"] + keep.to(torch.int32),
        "prev_flat": new_flat,
        "prev_grad": new_g,
    }
    return new_params, new_state, new_loss


def lbfgs_refine(loss_fn: Callable, params: Pytree, steps: int,
                 cfg: LBFGSConfig = LBFGSConfig()):
    """Run ``steps`` L-BFGS iterations (the PINN refinement phase).
    Returns (params, losses as floats)."""
    state = init_lbfgs(params, cfg)
    losses = []
    for _ in range(steps):
        params, state, loss = lbfgs_step(loss_fn, params, state, cfg)
        losses.append(float(loss))
    return params, losses
