"""The port's L-BFGS (``repro_torch.optim.lbfgs``) against the JAX package's
(``repro.optim.lbfgs``), on the CPU.

L-BFGS makes discrete choices: the first acceptable Armijo probe, and
whether a curvature pair is kept (``s·y > eps``).  A float32 difference in
the last bit can flip either, after which two trajectories part.  So a
whole trajectory is held only on the quadratic, where the choices have
margin; on Rosenbrock and the monotone case every iteration is held from
the reference's own state (params and L-BFGS state crossed as numpy
arrays, key by key), and on a PINN loss one ``lbfgs_step`` from an
identical state with a full history.

Tolerances (float32): losses within 1e-5 relative plus 1e-6 of the first
loss (a loss that fell by six orders of magnitude is rounding of terms of
the first loss's size); params, ``s``, ``y`` and the chosen step within
1e-5; ``rho = 1/(s·y)`` within 1e-4 relative (a quotient of a float32 dot
product); counts exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro_torch.core  # noqa: F401  (the package's import order)
from repro.optim import lbfgs as jlbfgs
from repro_torch.core.nets import tree_leaves
from repro_torch.optim import LBFGSConfig, init_lbfgs, lbfgs_refine, \
    lbfgs_step
from repro_torch.optim import lbfgs

LOSS_RTOL, LOSS_ATOL_OF_FIRST = 1e-5, 1e-6
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), tree)


def _close_losses(got, want, first):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=LOSS_RTOL,
                               atol=LOSS_ATOL_OF_FIRST * abs(first))


_TARGET = np.arange(5.0, dtype=np.float32)
_A = np.random.default_rng(0).normal(0, 1, (8, 8)).astype(np.float32)
_Q = np.asarray(jnp.asarray(_A) @ jnp.asarray(_A).T + 0.1 * jnp.eye(8))

# the reference's three cases (tests/test_lbfgs_euler.py:11-33):
# (jax loss, torch loss, initial params, iterations)
CASES = {
    "quadratic": (lambda p: jnp.sum((p["w"] - _TARGET) ** 2),
                  lambda p: torch.sum((p["w"] - torch.tensor(_TARGET)) ** 2),
                  {"w": np.zeros(5, np.float32)}, 15),
    "rosenbrock": (lambda p: jnp.sum(100 * (p["x"][1:] - p["x"][:-1] ** 2)
                                     ** 2 + (1 - p["x"][:-1]) ** 2),
                   lambda p: torch.sum(100 * (p["x"][1:] - p["x"][:-1] ** 2)
                                       ** 2 + (1 - p["x"][:-1]) ** 2),
                   {"x": np.zeros(4, np.float32)}, 80),
    "monotone": (lambda p: 0.5 * p["x"] @ _Q @ p["x"] + jnp.sum(
                     jnp.sin(p["x"])),
                 lambda p: 0.5 * p["x"] @ torch.tensor(_Q) @ p["x"]
                 + torch.sum(torch.sin(p["x"])),
                 {"x": np.ones(8, np.float32)}, 25),
}


def test_quadratic_trajectory_matches_reference():
    """The whole 15-iteration trajectory (the choices have margin on a
    quadratic), and the reference's own assertions."""
    jl, tl, p0, n = CASES["quadratic"]
    _, want = jlbfgs.lbfgs_refine(jl, jax.tree.map(jnp.asarray, p0), n)
    p, got = lbfgs_refine(tl, _t(p0), n)
    _close_losses(got, want, want[0])
    assert got[-1] < 1e-8
    np.testing.assert_allclose(p["w"].numpy(), _TARGET, atol=1e-4)


@pytest.mark.parametrize("case", ["rosenbrock", "monotone"])
def test_every_iteration_from_the_reference_state(case):
    """Each iteration from the reference's state (params and L-BFGS state
    crossed key by key): the same loss, the same choices (count), the same
    new params; then the port's own run passes the reference's
    assertions."""
    jl, tl, p0, n = CASES[case]
    jp = jax.tree.map(jnp.asarray, p0)
    js = jlbfgs.init_lbfgs(jp)
    jstep = jax.jit(lambda p, s: jlbfgs.lbfgs_step(jl, p, s))
    first = None
    for _ in range(n):
        tp, ts, tloss = lbfgs_step(tl, _t(jp), _t(js))
        jp, js, jloss = jstep(jp, js)
        first = float(jloss) if first is None else first
        _close_losses([float(tloss)], [float(jloss)], first)
        assert int(ts["count"]) == int(js["count"])
        np.testing.assert_allclose(ts["prev_flat"].numpy(),
                                   np.asarray(js["prev_flat"]), **TOL)
    _, losses = lbfgs_refine(tl, _t(p0), n)
    if case == "rosenbrock":
        assert losses[-1] < 1e-2 * losses[0]
    assert all(b <= a + 1e-6 for a, b in zip(losses, losses[1:]))


def test_flatten_order_is_the_reference_s():
    """Dict keys sorted, lists in order: ``prev_flat`` lines up with the
    reference's element by element, whatever the insertion order."""
    rng = np.random.default_rng(1)
    tree = {"u": {"b": [rng.normal(size=3).astype(np.float32)],
                  "W": [rng.normal(size=(2, 3)).astype(np.float32),
                        rng.normal(size=(3, 1)).astype(np.float32)],
                  "a": rng.normal(size=2).astype(np.float32)},
            "k": {"a": np.ones(1, np.float32)}}
    want = np.asarray(jlbfgs.init_lbfgs(jax.tree.map(jnp.asarray,
                                                     tree))["prev_flat"])
    got = init_lbfgs(_t(tree))
    np.testing.assert_array_equal(got["prev_flat"].numpy(), want)
    assert got["s"].shape == (10, want.size) and got["count"].dtype == \
        torch.int32
    flat, unflatten = lbfgs._flatten(_t(tree))
    back = unflatten(flat)
    for a, b in zip(tree_leaves(back), tree_leaves(_t(tree))):
        assert torch.equal(a, b)


def _burgers(width=12, depth=2, n_res=128, n_bnd=32):
    """The vanilla Burgers PINN loss on both sides (the reference's
    L-BFGS recipe at a small size) and the reference's init."""
    from repro.core import Burgers1D as JBurgers
    from repro.core import CartesianDecomposition as JCart
    from repro.core.losses import LossWeights as JW
    from repro.core.losses import vanilla_pinn_loss as jvanilla
    from repro.core.nets import ACT_TANH
    from repro.core.nets import MLPConfig as JMLP
    from repro.core.nets import SubdomainModelConfig as JCfg
    from repro.core.nets import init_model
    from repro.data import make_vanilla_batch as jbatch

    from repro_torch.core import Burgers1D, CartesianDecomposition
    from repro_torch.core import losses
    from repro_torch.core.nets import MLPConfig, SubdomainModelConfig
    from repro_torch.data import make_vanilla_batch

    jcfg = JCfg(nets={"u": JMLP(2, 1, width, depth)})
    tcfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, width, depth)})
    jb = jbatch(JCart(((-1, 1), (0, 1)), 1, 1), JBurgers(), n_res, n_bnd,
                np.random.default_rng(0))
    tb = make_vanilla_batch(CartesianDecomposition(((-1, 1), (0, 1)), 1, 1),
                            Burgers1D(), n_res, n_bnd,
                            np.random.default_rng(0))
    jpde, tpde = JBurgers(), Burgers1D()
    jl = lambda p: jvanilla(jpde, jcfg, JW(), p, ACT_TANH, None, jb)[0]
    path = losses.ResidualPath(act="tanh")
    tl = lambda p: losses.vanilla_pinn_loss(tpde, tcfg, losses.LossWeights(),
                                            p, 0, None, tb, path)[0]
    p0 = jax.tree.map(np.asarray, init_model(jcfg, jax.random.PRNGKey(0)))
    return jl, tl, p0


def test_one_step_on_a_pinn_loss_with_a_full_history():
    """One ``lbfgs_step`` from an identical state whose history is full
    (the reference's after 12 iterations): s, y, rho, count, the new
    params and the chosen step (t = (new - old)·d / d·d, d from each
    package's own two-loop recursion)."""
    jl, tl, p0 = _burgers()
    cfg = LBFGSConfig()
    jp = jax.tree.map(jnp.asarray, p0)
    js = jlbfgs.init_lbfgs(jp)
    jstep = jax.jit(lambda p, s: jlbfgs.lbfgs_step(jl, p, s))
    for _ in range(12):
        jp, js, _ = jstep(jp, js)
    assert int(js["count"]) >= cfg.history   # the circular buffer wrapped
    tp0, ts0 = _t(jp), _t(js)
    jp2, js2, jloss = jstep(jp, js)
    tp2, ts2, tloss = lbfgs_step(tl, tp0, ts0)
    _close_losses([float(tloss)], [float(jloss)], float(jloss))
    assert int(ts2["count"]) == int(js2["count"])
    for k in ("s", "y", "prev_flat", "prev_grad"):
        np.testing.assert_allclose(ts2[k].numpy(), np.asarray(js2[k]), **TOL)
    np.testing.assert_allclose(ts2["rho"].numpy(), np.asarray(js2["rho"]),
                               rtol=1e-4, atol=1e-5)

    def chosen(two_loop, flat, new, g, st):
        d = -np.asarray(two_loop(g, st["s"], st["y"], st["rho"],
                                 st["count"], cfg.history, cfg.eps))
        return float(np.dot(np.asarray(new) - np.asarray(flat), d)
                     / np.dot(d, d))

    jflat = np.asarray(js["prev_flat"])
    jg = jax.grad(jl)(jp)
    jgf = jnp.concatenate([x.reshape(-1) for x in jax.tree.leaves(jg)])
    t_ref = chosen(jlbfgs._two_loop, jflat, js2["prev_flat"], jgf, js)
    tgf = lbfgs._value_and_grad(tl, tp0)[1]
    t_port = chosen(lbfgs._two_loop, jflat, ts2["prev_flat"], tgf, ts0)
    assert t_ref > 0
    np.testing.assert_allclose(t_port, t_ref, **TOL)


@pytest.mark.slow
def test_lbfgs_refines_pinn_after_adam():
    """The reference's recipe (``tests/test_lbfgs_euler.py:37-63``) on the
    port's fused path (plain versions on the CPU), from the reference's
    init: vanilla Burgers, ``MLPConfig(2, 1, 20, 3)``, 512 + 64 points,
    300 Adam steps at 2e-3, then 60 L-BFGS iterations: monotone, and below
    0.9 x the Adam loss."""
    from repro_torch.core.nets import params_from_numpy, tree_unflatten
    from repro_torch.optim import adam

    _, tl, p0 = _burgers(width=20, depth=3, n_res=512, n_bnd=64)
    params = params_from_numpy(p0, "cpu")
    opt = adam.init_adam(params)
    for _ in range(300):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        loss = tl(p)
        grads = tree_unflatten(p, torch.autograd.grad(loss, leaves))
        params, opt = adam.adam_update(grads, opt, params, 2e-3)
        adam_loss = float(loss.detach())
    _, losses = lbfgs_refine(tl, params, 60)
    assert losses[-1] < 0.9 * adam_loss, (adam_loss, losses[-1])
    assert all(b <= a + 1e-6 for a, b in zip(losses, losses[1:]))


def test_optim_imports_first_in_a_fresh_process():
    """``import repro_torch.optim`` before anything else of the port (it
    failed on a circular import through ``core.trainer`` before core was
    loaded first)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parent.parent / "src")
    env = dict(os.environ, PYTHONPATH=src)
    for mod in ("repro_torch.optim", "repro_torch.optim.lbfgs"):
        res = subprocess.run([sys.executable, "-c", f"import {mod}"],
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
