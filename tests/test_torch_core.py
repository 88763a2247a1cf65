"""PyTorch port's core modules against the JAX package (CPU): the PDEs'
batched bundle interface, the networks, and the checkpoint tree format.

Inputs are numpy arrays from a seed handed to both packages.  Tolerance
1e-6 (rtol and atol) in float32: the same elementwise formulas, evaluated
by two frameworks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import nets as jnets
from repro.core import pdes as jpdes
from repro_torch.checkpoint import ckpt
from repro_torch.core import nets, pdes

TOL = dict(rtol=1e-6, atol=1e-6)

# JAX keeps one eager-dispatch callable per primitive and dtype.  If the
# first eager float32 fill of a process runs inside a vmap (the reference's
# stacked init makes its zeros there), that callable stays off the fast path
# and every later eager jnp.ones/zeros retraces, which the reference's
# CompileWatcher counts.  Making that first fill here, at collection, keeps
# the reference's trace counts in this process independent of which test
# file ran before them.
jnp.zeros((1,), jnp.float32).block_until_ready()


@pytest.mark.parametrize("name", sorted(jpdes.REGISTRY))
def test_pde_bundle_interface_matches(name):
    pde, jpde = pdes.REGISTRY[name](), jpdes.REGISTRY[name]()
    assert dataclasses.asdict(pde) == dataclasses.asdict(jpde)
    assert pde.d2_dirs == jpde.d2_dirs
    assert type(pde).supports_derivs() and type(jpde).supports_derivs()
    rng = np.random.default_rng(len(name))
    n, dim, F = 17, pde.input_dim, pde.n_fields
    x = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    u = rng.uniform(0.5, 1.5, (n, F)).astype(np.float32)   # Euler: rho > 0
    du = rng.normal(size=(dim, n, F)).astype(np.float32)
    d2u = rng.normal(size=(dim, n, F)).astype(np.float32)
    t = torch.from_numpy
    got_r = pde.residual_from_derivs(t(x), t(u), t(du), t(d2u)).numpy()
    got_f = pde.flux_from_derivs(t(x), t(u), t(du)).numpy()
    want_r = jpde.residual_from_derivs(x, u, du, d2u)
    want_f = jpde.flux_from_derivs(x, u, du)
    np.testing.assert_allclose(got_r, want_r, **TOL)
    np.testing.assert_allclose(got_f, want_f, **TOL)
    assert got_r.shape == (n, pde.n_eq) and got_f.shape == (n, pde.n_eq, dim)
    # a leading subdomain axis broadcasts through unchanged
    two = lambda a: t(np.stack([a, a]))
    got_b = pde.residual_from_derivs(two(x), two(u), two(du), two(d2u))
    np.testing.assert_allclose(got_b[1].numpy(), got_r, **TOL)
    ex, jex = pde.exact(x.astype(np.float64)), jpde.exact(x.astype(np.float64))
    if jex is None:
        assert ex is None
    else:
        np.testing.assert_array_equal(ex, jex)


def _jax_params(cfg, n_sub, seed):
    jcfg = jnets.SubdomainModelConfig(nets={
        k: jnets.MLPConfig(**dataclasses.asdict(c))
        for k, c in cfg.nets.items()})
    params, codes = jnets.stacked_init(jcfg, n_sub, jax.random.PRNGKey(seed))
    return jcfg, jax.tree.map(np.asarray, params), np.asarray(codes)


@pytest.mark.parametrize("adaptive", [True, False])
def test_model_apply_matches_with_transferred_weights(adaptive):
    cfg = nets.SubdomainModelConfig(nets={
        "u": nets.MLPConfig(2, 1, 10, 3, adaptive=adaptive, slope_scale=2.0),
        "k": nets.MLPConfig(2, 2, 6, 1, adaptive=adaptive, slope_scale=2.0)})
    jcfg, jparams, _ = _jax_params(cfg, 3, 0)
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda a: (a + rng.uniform(-0.2, 0.2, a.shape)).astype(np.float32),
        jparams)       # slopes away from 1, biases away from 0
    params = nets.params_from_numpy(jparams)
    x = rng.uniform(-1, 1, (3, 11, 2)).astype(np.float32)
    mask = {"u": (rng.uniform(size=(3, 10)) < 0.6).astype(np.float32)}
    for code in (0, 1, 2):
        got = nets.model_apply(cfg, params, torch.from_numpy(x), code,
                               {"u": torch.from_numpy(mask["u"])})
        for q in range(3):
            want = jnets.model_apply(
                jcfg, jax.tree.map(lambda a: a[q], jparams), jnp.asarray(x[q]),
                code, {"u": jnp.asarray(mask["u"][q])})
            np.testing.assert_allclose(got[q].numpy(), np.asarray(want),
                                       **TOL)
    back = nets.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)


def test_stacked_init_layout_and_seed():
    cfg = nets.SubdomainModelConfig(nets={"u": nets.MLPConfig(2, 1, 24, 4)})
    params, codes = nets.stacked_init(cfg, 4, 7)
    _, jparams, jcodes = _jax_params(cfg, 4, 7)
    assert jax.tree.structure(nets.params_to_numpy(params)) == \
        jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(nets.params_to_numpy(params)),
                    jax.tree.leaves(jparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    W1 = params["u"]["W"][1]
    assert abs(float(W1.std()) - (2 / 48) ** 0.5) < 0.03   # Glorot normal
    again, _ = nets.stacked_init(cfg, 4, torch.Generator().manual_seed(7))
    assert torch.equal(again["u"]["W"][2], params["u"]["W"][2])
    _, mixed = nets.stacked_init(cfg, 4, 0, ["sin", "cos", 0, "tanh"])
    assert mixed.tolist() == [1, 2, 0, 0]
    assert [nets.act_name(c) for c in range(3)] == ["tanh", "sin", "cos"]
    assert nets.act_code("cos") == jnets.act_code("cos") == 2


def test_checkpoint_tree_format_matches():
    """Same leaf paths, order and tree string as ``jax.tree_util``, and the
    tree restores into the template's structure."""
    tree = {"params": {"u": {"W": [np.ones((2, 3)), np.zeros((3, 1))],
                             "b": (np.ones(3),), "a": np.ones(2)}},
            "width_masks": {"u": np.ones(3)}, "none": None,
            "step": [np.int32(4)]}
    paths, leaves = ckpt._flatten_with_paths(tree)
    jpaths, jleaves = jckpt._flatten_with_paths(tree)
    assert paths == jpaths
    assert all(a is b for a, b in zip(leaves, jleaves))
    assert ckpt._treedef_str(tree) == str(jax.tree_util.tree_structure(tree))
    back = ckpt._unflatten(tree, leaves)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
