"""PyTorch port of the MoE block against the JAX package: ``init``'s tree,
``moe_ffn`` (grouping, capacity, drops, the stable sort, gates, the
load-balance term) and its gradients, the top-k tie-break, and
``moe_shard_map``'s refusal without an expert-parallel context, on the
same numpy inputs and the reference's
weights carried across (``params_from_numpy``).

Tolerances (float32): the output within 1e-5 of max |out|, the aux term
within 1e-6 (its counts are exact; the frameworks sum the probabilities
in another order), every gradient leaf within 1e-5 of max(1, max |want|).
Routes (the experts chosen) must be identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.models import moe as JM
from repro_torch.configs import ARCHS
from repro_torch.core.nets import tree_leaves, tree_unflatten
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import moe as TM

NAMES = ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")
# the reduced configs' 4 experts, top-2 and 1 shared expert hide the
# published ratio: deepseek-moe-16b's 64 routed experts, top-6, 2 shared
PUBLISHED = {"n_experts": 64, "top_k": 6, "n_shared_experts": 2}
OUT_TOL, AUX_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module's tests run: the test workers
    are the parallelism."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(ratio, dtype="float32", **over):
    over = {**(PUBLISHED if ratio == "published" else {}), **over}
    return (dataclasses.replace(J_ARCHS["deepseek-moe-16b"].reduced(),
                                dtype=dtype, **over),
            dataclasses.replace(ARCHS["deepseek-moe-16b"].reduced(),
                                dtype=dtype, **over))


def _layer(jcfg, seed=0):
    """One MoE layer's reference params (numpy) and the port's copy."""
    lp = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(seed), jcfg))
    return lp, params_from_numpy(lp, "cpu")


def _x(B, S, d, seed=1):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def _dropped(cfg, p, x) -> int:
    """Slots past capacity in the port's dispatch of x (B, S, d)."""
    B, S, d = x.shape
    G = TM._n_groups(B * S)
    _, _, idx = TM.route(cfg, p, x.reshape(G, -1, d))
    counts = torch.nn.functional.one_hot(idx.reshape(G, -1),
                                         cfg.n_experts).sum(1)
    C = TM.capacity(cfg, B * S // G)
    return int((counts - C).clamp(min=0).sum())


# ------------------------------------------------------------------- init

@pytest.mark.parametrize("name", NAMES)
def test_init_tree_matches_reference_at_the_published_ratio(name):
    """``init`` at the published expert ratio (the reduced widths, 64
    experts, top-6, 2 shared): the reference's keys, shapes and float32
    leaves; deepseek's tree holds the dense ``prelude``."""
    over = PUBLISHED if name.startswith("deepseek") else {}
    jcfg = dataclasses.replace(J_ARCHS[name].reduced(), **over)
    cfg = dataclasses.replace(ARCHS[name].reduced(), **over)
    want = jax.eval_shape(j_build(jcfg).init, jax.random.PRNGKey(0))
    got = build_model(cfg, "cpu").init(0)
    flat = lambda t: {jax.tree_util.keystr(p): tuple(l.shape) for p, l in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(got) == flat(want)
    assert all(t.dtype == torch.float32 for t in tree_leaves(got))
    assert ("prelude" in got) == name.startswith("deepseek")
    if "prelude" in got:    # d_ff_dense wide, one layer
        assert got["prelude"]["mlp"]["wi"].shape == (1, 64, 10944)
        assert got["layers"]["router"].shape == (1, 64, cfg.n_experts)


def test_groups_and_capacity_are_the_references():
    for T in (1, 2, 4, 63, 64, 127, 128, 2048, 4096, 65536):
        assert TM._n_groups(T) == JM._n_groups(T), T
    assert (TM._n_groups(2048), TM._n_groups(128), TM._n_groups(127)) == \
        (32, 2, 1)
    for ratio in ("reduced", "published"):
        for cf in (0.5, 1.0, 1.25, 64.0):
            jcfg, cfg = _cfgs(ratio, capacity_factor=cf)
            for t in (1, 4, 37, 64, 1000):
                assert TM.capacity(cfg, t) == JM.capacity(jcfg, t)
    _, pub = _cfgs("published")
    assert TM.capacity(pub, 64) == 8 and TM.capacity(pub, 4) == 4


# --------------------------------------------------------------- moe_ffn

@pytest.mark.parametrize("ratio", ["reduced", "published"])
@pytest.mark.parametrize("cf", [1.25, 0.5, 64.0])
@pytest.mark.parametrize("B,S", [(2, 32), (2, 64), (2, 512)],
                         ids=["T64-G1", "T128-G2", "T1024-G16"])
def test_moe_ffn_matches_reference(B, S, cf, ratio):
    jcfg, cfg = _cfgs(ratio, capacity_factor=cf)
    lp, p = _layer(jcfg)
    x = _x(B, S, cfg.d_model)
    want, waux = jax.jit(functools.partial(JM.moe_ffn, jcfg))(
        jax.tree.map(jnp.asarray, lp), jnp.asarray(x))
    got, aux = TM.moe_ffn(cfg, p, torch.as_tensor(x))
    want = np.asarray(want)
    assert got.shape == want.shape == x.shape
    err = float(np.abs(got.numpy() - want).max()) / float(np.abs(want).max())
    assert err <= OUT_TOL, err
    assert abs(float(aux) - float(waux)) <= AUX_TOL
    if cf == 0.5:
        assert _dropped(cfg, p, torch.as_tensor(x)) > 0
    if cf == 64.0:
        assert _dropped(cfg, p, torch.as_tensor(x)) == 0


@pytest.mark.parametrize("ratio", ["reduced", "published"])
def test_moe_ffn_gradients_match_reference(ratio):
    """With slots dropped (capacity 0.5): the gradients of <out, g> + aux
    in x and in every param leaf (router through the gates and p_e)."""
    jcfg, cfg = _cfgs(ratio, capacity_factor=0.5)
    lp, p = _layer(jcfg, seed=2)
    # the leaves moe_ffn reads (the layer's attention and norms it does not)
    lp = {k: lp[k] for k in ("router", "experts", "shared")}
    p = {k: p[k] for k in lp}
    x = _x(2, 64, cfg.d_model, seed=3)
    g = _x(2, 64, cfg.d_model, seed=4)

    def j_obj(params, x):
        out, aux = JM.moe_ffn(jcfg, params, x)
        return jnp.sum(out * g) + aux

    wgp, wgx = jax.jit(jax.grad(j_obj, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, lp), jnp.asarray(x))
    leaves = [t.clone().requires_grad_() for t in tree_leaves(p)]
    xt = torch.tensor(x, requires_grad=True)
    out, aux = TM.moe_ffn(cfg, tree_unflatten(p, leaves), xt)
    grads = torch.autograd.grad(torch.sum(out * torch.as_tensor(g)) + aux,
                                leaves + [xt])
    assert _dropped(cfg, p, torch.as_tensor(x)) > 0
    for got, want in zip(grads, jax.tree.leaves(wgp) + [wgx]):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max()) / \
            max(1.0, float(np.abs(want).max()))
        assert err <= GRAD_TOL, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ratio", ["reduced", "published"])
def test_top_k_ties_take_the_lower_expert(ratio, dtype):
    """Router columns duplicated in pairs, so the probabilities tie
    exactly, with distinct expert weights: the port picks the experts that
    ``jax.lax.top_k`` picks (the lower index first) and gives the same
    output."""
    jcfg, cfg = _cfgs(ratio, dtype)
    lp, _ = _layer(jcfg, seed=5)
    E = cfg.n_experts
    lp["router"] = np.repeat(lp["router"][:, :E // 2], 2, axis=1)
    p = params_from_numpy(lp, "cpu")
    x = _x(2, 32, cfg.d_model, seed=6)
    xj = jnp.asarray(x).astype(jcfg.dtype)
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    xg = xj.reshape(1, 64, -1)
    probs = jax.nn.softmax((xg @ jnp.asarray(lp["router"]).astype(xj.dtype))
                           .astype(jnp.float32), axis=-1)
    pn = np.asarray(probs)
    assert np.array_equal(pn[..., 0::2], pn[..., 1::2])     # exact ties
    _, want_idx = jax.lax.top_k(probs, cfg.top_k)
    _, _, idx = TM.route(cfg, p, xt.reshape(1, 64, -1))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    want, _ = JM.moe_ffn(jcfg, jax.tree.map(jnp.asarray, lp), xj)
    got, _ = TM.moe_ffn(cfg, p, xt)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.float().numpy() - want).max()) / \
        float(np.abs(want).max())
    assert err <= (OUT_TOL if dtype == "float32" else 3e-2), err


def test_moe_shard_map_raises():
    """``moe_shard_map=True`` with no expert-parallel context raises a
    ValueError naming the missing context; it never falls back to
    ``moe_ffn`` (tests/test_torch_moe_ep.py runs it in one)."""
    cfg = dataclasses.replace(ARCHS["deepseek-moe-16b"].reduced(),
                              moe_shard_map=True)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    with pytest.raises(ValueError, match="expert-parallel context"):
        model.prefill(params, {"tokens": torch.zeros((1, 8),
                                                     dtype=torch.long)})
