"""Expert parallelism in the PyTorch port (``moe_ffn_shardmap``, the
``models/expert_parallel.py`` contexts, ``launch/mesh.py``'s grid) against
the JAX package's ``moe_ffn_shardmap`` on a (2, 4) ``("data", "model")``
mesh of 8 fake CPU devices, on the same numpy inputs.

The reference runs in a subprocess on a ``jax.sharding.Mesh`` (``Auto``
axes) under ``use_rules(rules_for())``; ``jax.make_mesh``'s ``Explicit``
axes fail in ``layers.embed`` before any MoE code (ROADMAP Queue 3).  The
port runs its one-process twin (``EPPlan(2, 4)``) here and 8 ``gloo``
ranks on a (2, 4) grid (``run_ranks``), each holding its data shard and 2
of the 8 experts.  The reduced deepseek config with 8 experts, top-2: at
the default capacity factor 1.25 tokens drop, at 8.0 none do.

Tolerances (float32): outputs, the aux term and the loss within 1e-5 of
max(1, max |want|), every gradient leaf (x's included) within 1e-4 of
max(1, max |want|); the ranks against the twin alike.  The gradient of a
data rank is its share of the data-parallel mean: the ranks' objectives
average to the reference's, so their gradients are averaged.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.nets import params_from_numpy, tree_leaves, \
    tree_unflatten
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import lm_train_step
from repro_torch.models import build_model
from repro_torch.models import expert_parallel as EP
from repro_torch.models import moe as TM
from repro_torch.optim import adam as adam_lib
from repro_torch.utils import collectives as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, M = 2, 4
CFS = (1.25, 8.0)
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
B, S = 4, 16
AUX_W = 0.5          # the layer objective: <out, cot> + AUX_W * aux
STEPS, LR = 2, 1e-3  # lm_train_step on the grid against the twin


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cf, **over):
    return dataclasses.replace(
        ARCHS["deepseek-moe-16b"].reduced(n_heads=4, n_kv_heads=4,
                                          vocab=512, n_experts=8, top_k=2),
        dtype="float32", capacity_factor=cf, **over)


def _model_cfg(cf):
    return _cfg(cf, n_layers=3, moe_shard_map=True)   # prelude + 2 MoE


def _flat(tree, prefix=""):
    """A tree of dicts as {"a/b/c": leaf}, in ``tree_leaves``' order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _inputs() -> dict:
    """The numpy inputs both packages read: one MoE layer's params (the
    leaves the MoE reads), x and a cotangent, the 3-layer model's params
    and a batch whose ``loss_mask`` counts differ across the two data
    shards."""
    rng = np.random.default_rng(1)
    cfg = _cfg(1.25)
    gen = torch.Generator().manual_seed(0)
    lp = TM.init(gen, cfg)
    lp = {k: lp[k] for k in ("router", "experts", "shared")}
    params = build_model(_model_cfg(1.25), "cpu").init(0)
    mask = np.ones((B, S), np.float32)
    mask[D // 2 * (B // D):] = rng.integers(0, 2, (B - B // D, S))
    inp = {"x": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
           "cot": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
           "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "loss_mask": mask}
    inp.update({f"layer/{k}": v.numpy() for k, v in _flat(lp).items()})
    inp.update({f"model/{k}": v.numpy() for k, v in _flat(params).items()})
    return inp


REF_CODE = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import build_model
from repro.models import moe as JM
from repro.models.sharding import rules_for, use_rules
from repro.utils import set_mesh

inp = dict(np.load(sys.argv[1]))
CFS = eval(sys.argv[3])
AUX_W = float(sys.argv[4])

def nest(prefix):
    out = {}
    for key, v in inp.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return out

def flat(tree, prefix):
    return {prefix + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
base = dataclasses.replace(get_config("deepseek-moe-16b").reduced(
    n_heads=4, n_kv_heads=4, vocab=512, n_experts=8, top_k=2),
    dtype="float32")
out = {}
x, cot = jnp.asarray(inp["x"]), jnp.asarray(inp["cot"])
batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "labels", "loss_mask")}
for cf in CFS:
    cfg = dataclasses.replace(base, capacity_factor=cf)

    def obj(p, x):
        o, aux = JM.moe_ffn_shardmap(cfg, p, x)
        return jnp.sum(o * cot) + AUX_W * aux, (o, aux)

    model = build_model(dataclasses.replace(cfg, n_layers=3,
                                            moe_shard_map=True))
    with set_mesh(mesh), use_rules(rules_for()):
        (_, (o, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            obj, argnums=(0, 1), has_aux=True))(nest("layer/"), x)
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(
            nest("model/"), batch)
    out[f"{cf}/out"], out[f"{cf}/aux"] = np.asarray(o), np.asarray(aux)
    out[f"{cf}/gx"], out[f"{cf}/loss"] = np.asarray(gx), np.asarray(loss)
    out.update(flat(gp, f"{cf}/glayer/"))
    out.update(flat(grads, f"{cf}/gmodel/"))
np.savez(sys.argv[2], **out)
"""


def _start_reference(inp_path, out_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", REF_CODE, inp_path, out_path, repr(CFS),
         repr(AUX_W)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


# ------------------------------------------------------------ the port's side

def _layer_run(cfg, lp, x, cot):
    """The layer objective <out, cot> + AUX_W * aux under the current
    context, its value parts and gradients in (leaves..., x).  On a rank:
    x its data shard, the objective D * <out, cot> + AUX_W * aux (so the
    data ranks' objectives average to the reference's), the gradients
    averaged over the data group (x's rows are this rank's alone)."""
    ep = EP.current_ep()
    n_d = ep.data if isinstance(ep, EP.EPRank) else 1
    leaves = [t.clone().requires_grad_() for t in tree_leaves(lp)]
    xt = x.clone().requires_grad_()
    out, stats = TM.moe_ffn_shardmap(cfg, tree_unflatten(lp, leaves), xt)
    parts = EP.reduce_data(stats)
    aux = cfg.n_experts * torch.sum(parts[0] * parts[1])
    obj = n_d * torch.sum(out * cot) + AUX_W * aux
    *grads, gx = torch.autograd.grad(obj, leaves + [xt])
    _, grads = EP.mean_over_data(obj, grads)
    # x's rows live on one data rank: its share of the mean is 1 / D
    return out.detach(), aux.detach(), grads + [gx / n_d]


def _model_run(cfg, params, batch):
    """``CausalLM.loss`` and its gradients under the current context
    (averaged over the data group on a rank), then the global norm."""
    model = build_model(cfg, "cpu")
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    loss = model.loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    loss, grads = EP.mean_over_data(loss, list(grads))
    gtree = tree_unflatten(params, grads)
    gn = EP.global_norm(gtree)
    if gn is None:
        gn = torch.sqrt(sum(torch.sum(g ** 2) for g in grads))
    return loss.detach(), gtree, gn


def _train(cfg, params, batch):
    """STEPS of ``lm_train_step`` under the current context."""
    model = build_model(cfg, "cpu")
    opt = adam_lib.init_adam(params)
    losses = []
    for s in range(STEPS):
        params, opt, loss, _ = lm_train_step(model, params, opt, batch, s,
                                             LR, STEPS)
        losses.append(float(loss))
    return losses, params


def _torch_inputs(inp):
    lp = params_from_numpy(_nest(inp, "layer/"), "cpu")
    params = params_from_numpy(_nest(inp, "model/"), "cpu")
    batch = {k: torch.as_tensor(inp[k]).long() if k != "loss_mask"
             else torch.as_tensor(inp[k]) for k in
             ("tokens", "labels", "loss_mask")}
    return lp, params, batch


def _np(tree):
    return {k: v.detach().numpy() for k, v in _flat(tree).items()}


def _by_group(record) -> dict:
    return {g: {k: [v["count"], v["bytes"]] for k, v in kinds.items()}
            for g, kinds in C.by_group(record).items()}


def _recorded_steps(p_r, b_r) -> dict:
    """The collectives of the rank's prefill and of its first training
    step (the dry run's cells: tokens and labels, no loss mask), recorded
    by group."""
    model = build_model(_model_cfg(1.25), "cpu")
    out = {}
    with C.CollectiveRecorder() as rec:
        model.prefill(p_r, {"tokens": b_r["tokens"]})
    out["prefill"] = _by_group(rec.record)
    batch = {k: b_r[k] for k in ("tokens", "labels")}
    with C.CollectiveRecorder() as rec:
        lm_train_step(model, p_r, adam_lib.init_adam(p_r), batch, 0, LR,
                      STEPS)
    out["train"] = _by_group(rec.record)
    return out


def _ep_rank(grid, inp_path):
    """One rank of the (2, 4) grid: the layer and the model at both
    capacity factors on its data shard and its experts, with and without
    the backward all-reduce of ``copy_to_model``."""
    inp = dict(np.load(inp_path))
    lp, params, batch = _torch_inputs(inp)
    ep = grid.expert_parallel()
    sl = slice(ep.d * (B // D), (ep.d + 1) * (B // D))
    x, cot = torch.as_tensor(inp["x"])[sl], torch.as_tensor(inp["cot"])[sl]
    lp_r = EP.shard_experts(lp, ep.m, ep.model, axis=0)
    p_r = EP.shard_experts(params, ep.m, ep.model)
    out = {"d": ep.d, "m": ep.m}
    with EP.use_ep(ep):
        b_r = ep.shard_batch(batch)
        for cf in CFS:
            o, aux, g = _layer_run(_cfg(cf), lp_r, x, cot)
            loss, gtree, gn = _model_run(_model_cfg(cf), p_r, b_r)
            losses, trained = _train(_model_cfg(cf), p_r, b_r)
            out[cf] = {"out": o.numpy(), "aux": float(aux),
                       "g": [t.numpy() for t in g], "loss": float(loss),
                       "gmodel": _np(gtree), "gn": float(gn),
                       "losses": losses, "trained": _np(trained)}
        out["recorded"] = _recorded_steps(p_r, b_r)
        # module 5 undone: x enters with no backward all-reduce
        ep.copy_to_model = lambda t: t
        out["no_copy_gx"] = _layer_run(_cfg(1.25), lp_r, x, cot)[2][-1] \
            .numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs (a subprocess) and the 8 ranks' (spawned
    meanwhile) on the same inputs."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    inp = _inputs()
    inp_path, ref_path = str(tmp / "inp.npz"), str(tmp / "ref.npz")
    np.savez(inp_path, **inp)
    proc = _start_reference(inp_path, ref_path)
    try:
        mesh = mesh_lib.make_grid_mesh(D, M, str(tmp / "store"), "cpu",
                                       timeout_s=120)
        ranks = mesh_lib.run_ranks(mesh, _ep_rank, inp_path, deadline_s=300)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return {"inp": inp, "ref": dict(np.load(ref_path)), "ranks": ranks}


def _err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _twin_layer(inp, cf):
    lp, _, _ = _torch_inputs(inp)
    with EP.use_ep(EP.EPPlan(D, M)):
        return _layer_run(_cfg(cf), lp, torch.as_tensor(inp["x"]),
                          torch.as_tensor(inp["cot"]))


def _twin_model(inp, cf):
    _, params, batch = _torch_inputs(inp)
    with EP.use_ep(EP.EPPlan(D, M)):
        return _model_run(_model_cfg(cf), params, batch)


def _kept(cfg, x) -> int:
    """(token, slot) pairs the reference keeps: per data shard, at most C
    per expert."""
    lp, _, _ = _torch_inputs(_inputs())
    _, _, idx = TM.route(cfg, lp, torch.as_tensor(x).reshape(B * S, -1))
    C = TM.capacity(cfg, B * S // D)
    counts = torch.nn.functional.one_hot(idx.reshape(D, -1),
                                         cfg.n_experts).sum(1)
    return int(counts.clamp(max=C).sum())


# ------------------------------------------------------------------ the twin

@pytest.mark.parametrize("cf", CFS)
def test_twin_matches_reference_moe_ffn_shardmap(runs, cf):
    """EPPlan(2, 4): the layer's output, aux and the gradients of <out,
    cot> + aux in every leaf and in x; tokens drop at 1.25, none at 8."""
    inp, ref = runs["inp"], runs["ref"]
    out, aux, grads = _twin_layer(inp, cf)
    assert _err(out, ref[f"{cf}/out"]) <= OUT_TOL
    assert abs(float(aux) - float(ref[f"{cf}/aux"])) <= OUT_TOL
    lp, _, _ = _torch_inputs(inp)
    names = list(_flat(lp))
    for name, g in zip(names + ["x"], grads):
        want = ref[f"{cf}/gx"] if name == "x" else ref[f"{cf}/glayer/{name}"]
        assert _err(g, want) <= GRAD_TOL, name
    kept = _kept(_cfg(cf), inp["x"])
    assert (kept < B * S * 2) == (cf == 1.25), kept


@pytest.mark.parametrize("cf", CFS)
def test_twin_causal_lm_loss_and_grads_match_reference(runs, cf):
    """``CausalLM.loss`` with ``moe_shard_map=True`` (2 MoE layers, a
    ``loss_mask`` whose counts differ across the data shards) and every
    gradient, against the reference's ``value_and_grad(model.loss)``."""
    ref = runs["ref"]
    loss, gtree, _ = _twin_model(runs["inp"], cf)
    assert abs(float(loss) - float(ref[f"{cf}/loss"])) <= OUT_TOL
    got = _np(gtree)
    assert len(got) == len([k for k in ref if k.startswith(f"{cf}/gmodel/")])
    for name, g in got.items():
        assert _err(g, ref[f"{cf}/gmodel/{name}"]) <= GRAD_TOL, name


# ----------------------------------------------------------------- the ranks

def _gather_layer(ranks, cf, names):
    """The ranks' layer gradients as one tree: the expert leaves
    concatenated over m (data rank 0's), x's over d (model rank 0's),
    the rest from rank 0; and the ranks' outputs over d."""
    by = {(r["d"], r["m"]): r[cf] for r in ranks}
    grads = {}
    for i, name in enumerate(names):
        if name.startswith("experts/"):
            grads[name] = np.concatenate([by[0, m]["g"][i] for m in range(M)])
        else:
            grads[name] = by[0, 0]["g"][i]
    grads["x"] = np.concatenate([by[d, 0]["g"][-1] for d in range(D)])
    out = np.concatenate([by[d, 0]["out"] for d in range(D)])
    return out, grads, by


def _gather_model(ranks, cf, key):
    by = {(r["d"], r["m"]): r[cf][key] for r in ranks}
    return {name: (np.concatenate([by[0, m][name] for m in range(M)], axis=1)
                   if "/experts/" in name else by[0, 0][name])
            for name in by[0, 0]}


@pytest.mark.parametrize("cf", CFS)
def test_grid_ranks_layer_equals_twin_and_reference(runs, cf):
    """8 ``gloo`` ranks: each rank's output rows, the aux term, and every
    gradient (experts gathered over the model ranks, x's over the data
    ranks) equal the twin's and the reference's; every model rank of a
    data shard agrees on the replicated gradients."""
    inp, ref = runs["inp"], runs["ref"]
    lp, _, _ = _torch_inputs(inp)
    names = list(_flat(lp))
    out, grads, by = _gather_layer(runs["ranks"], cf, names)
    t_out, t_aux, t_grads = _twin_layer(inp, cf)
    assert _err(out, t_out) <= OUT_TOL and _err(out, ref[f"{cf}/out"]) \
        <= OUT_TOL
    for r in by.values():
        assert abs(r["aux"] - float(t_aux)) <= OUT_TOL
    for (name, g), tg in zip(grads.items(), t_grads):
        want = ref[f"{cf}/gx"] if name == "x" else ref[f"{cf}/glayer/{name}"]
        assert _err(g, tg) <= GRAD_TOL and _err(g, want) <= GRAD_TOL, name
    for d in range(D):
        for m in range(1, M):
            for i, name in enumerate(names):
                if not name.startswith("experts/"):
                    assert _err(by[d, m]["g"][i], by[0, 0]["g"][i]) \
                        <= GRAD_TOL, (d, m, name)


@pytest.mark.parametrize("cf", CFS)
def test_grid_ranks_loss_and_grads_equal_twin(runs, cf):
    """The ranks' ``CausalLM.loss`` (averaged over the data group) and
    every gradient (experts gathered) equal the twin's and the
    reference's; the global norm, the expert leaves summed over the model
    group, equals the twin's on every rank."""
    ref = runs["ref"]
    t_loss, t_gtree, t_gn = _twin_model(runs["inp"], cf)
    grads = _gather_model(runs["ranks"], cf, "gmodel")
    t_np = _np(t_gtree)
    assert set(grads) == set(t_np)
    for r in runs["ranks"]:
        assert abs(r[cf]["loss"] - float(t_loss)) <= OUT_TOL
        assert abs(r[cf]["loss"] - float(ref[f"{cf}/loss"])) <= OUT_TOL
        assert abs(r[cf]["gn"] - float(t_gn)) <= OUT_TOL * float(t_gn)
    for name, g in grads.items():
        assert _err(g, t_np[name]) <= GRAD_TOL, name
        assert _err(g, ref[f"{cf}/gmodel/{name}"]) <= GRAD_TOL, name


@pytest.mark.parametrize("cf", CFS)
def test_grid_ranks_train_like_the_twin(runs, cf):
    """Two ``lm_train_step``s on the grid (data mean, the model group's
    norm, Adam on each rank's shard) against two on the twin: the losses
    step by step and the final params (experts gathered)."""
    _, params, batch = _torch_inputs(runs["inp"])
    with EP.use_ep(EP.EPPlan(D, M)):
        t_losses, t_params = _train(_model_cfg(cf), params, batch)
    got = _gather_model(runs["ranks"], cf, "trained")
    t_np = _np(t_params)
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[cf]["losses"], t_losses, rtol=0,
                                   atol=OUT_TOL)
    for name, p in got.items():
        assert _err(p, t_np[name]) <= GRAD_TOL, name


def test_dropping_the_backward_all_reduce_breaks_x_grad(runs):
    """Without ``copy_to_model``'s backward all-reduce each rank's x
    gradient holds only its own experts' share: far from the reference's
    (this test fails if the all-reduce stops mattering)."""
    ref = runs["ref"]
    gx = np.concatenate([r["no_copy_gx"] for r in runs["ranks"]
                         if r["m"] == 0])
    good = np.concatenate([r[1.25]["g"][-1] for r in runs["ranks"]
                           if r["m"] == 0])
    want = ref["1.25/gx"]
    assert _err(good, want) <= GRAD_TOL
    assert _err(gx, want) > GRAD_TOL
    # a share, not a rounding: off by a large part of the gradient itself
    assert np.abs(gx - want).max() > 0.25 * np.abs(want).max()


def test_remat_recompute_runs_in_the_forward_s_context(runs):
    """A remat recompute runs the layers again during the backward, on a
    card in the autograd engine's own thread, where the caller's
    thread-local context is not set: the layers keep the context their
    forward ran in.  Here the backward runs after the context is left."""
    ref = runs["ref"]
    _, params, batch = _torch_inputs(runs["inp"])
    cfg = dataclasses.replace(_model_cfg(1.25), remat=True)
    model = build_model(cfg, "cpu")
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    with EP.use_ep(EP.EPPlan(D, M)):
        loss = model.loss(tree_unflatten(params, leaves), batch)
    assert EP.current_ep() is None
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss) - float(ref["1.25/loss"])) <= OUT_TOL
    for name, g in zip(_flat(params), grads):
        assert _err(g, ref[f"1.25/gmodel/{name}"]) <= GRAD_TOL, name


def test_shard_experts_cuts_the_draws_of_a_full_init():
    """``init(seed, experts=(m, M))`` draws what ``init(seed)`` draws and
    keeps rank m's experts; ``shard_experts`` cuts a full tree alike; the
    other leaves are the full tree's."""
    cfg = _model_cfg(1.25)
    model = build_model(cfg, "cpu")
    full = model.init(0)
    for m in range(M):
        part = model.init(0, experts=(m, M))
        cut = EP.shard_experts(full, m, M)
        for (name, a), b, c in zip(_flat(part).items(),
                                   tree_leaves(cut), tree_leaves(full)):
            assert torch.equal(a, b), name
            if "/experts/" in name:
                assert a.shape[1] == cfg.n_experts // M
                assert torch.equal(a, c[:, m * 2:(m + 1) * 2])
            else:
                assert torch.equal(a, c)
    with pytest.raises(ValueError, match="do not split"):
        EP.shard_experts(full, 0, 3)


def test_moe_shard_map_checks_the_experts_it_holds():
    """The twin needs every expert and a rank its E/M: a tree of the wrong
    size raises instead of dispatching to experts it does not hold."""
    cfg = _cfg(1.25)
    lp, _, _ = _torch_inputs(_inputs())
    x = torch.as_tensor(_inputs()["x"])
    with EP.use_ep(EP.EPPlan(D, M)):
        with pytest.raises(ValueError, match="wants 8"):
            TM.moe_ffn_shardmap(cfg, EP.shard_experts(lp, 0, M, axis=0), x)
    with EP.use_ep(EP.EPPlan(D, 3)):
        with pytest.raises(ValueError, match="do not split"):
            TM.moe_ffn_shardmap(cfg, lp, x)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_partitioned_dry_run_predicts_every_rank_s_collectives(runs, kind):
    """The partitioned dry run of the (2, 4) cell (``moe_shard_map``, the
    rules replicating every param but the experts, as the ranks hold
    them) issues, as rank 0, exactly the collectives every ``gloo`` rank
    recorded in its prefill and in its first training step: group, kind,
    count and bytes."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.sharding import SINGLE_POD_RULES

    extra = {k: None for k in SINGLE_POD_RULES if k not in ("batch",
                                                           "expert")}
    _, rec = dryrun.lower_cell(
        "deepseek-moe-16b", None, cfg_override=_model_cfg(1.25),
        mesh=mesh_lib.make_production_mesh(shape=(D, M)),
        shape_override=ShapeConfig("ep", S, B, kind), partitioned=True,
        extra_rules=extra)
    got = {g: {k: [v["count"], v["bytes"]] for k, v in kinds.items()}
           for g, kinds in rec["collectives_by_group"].items()}
    assert got and set(got) <= {"data", "model"}
    for r in runs["ranks"]:
        assert r["recorded"][kind] == got, (r["d"], r["m"])
    with pytest.raises(ValueError, match="replicate"):
        dryrun.lower_cell(
            "deepseek-moe-16b", None, cfg_override=_model_cfg(1.25),
            mesh=mesh_lib.make_production_mesh(shape=(D, M)),
            shape_override=ShapeConfig("ep", S, B, kind), partitioned=True)
