"""The port's sharding rules and trees (``repro_torch.models.sharding``, the
models' ``logical`` / ``param_specs`` / ``cache_specs``, ``batch_struct``
and ``launch.dryrun.batch_specs``) against the JAX package's, at the
published sizes of every arch, and the per-device argument bytes of every
(arch x shape) cell on both production meshes against JAX's
``NamedSharding(AbstractMesh, spec).shard_shape``.

Specs compare exactly, a JAX ``PartitionSpec`` turned into a tuple.  No
param is drawn: the port's trees are meta tensors, the reference's
``jax.eval_shape`` structs.
"""
import itertools
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.models import batch_struct as j_batch_struct
from repro.models import build_model as j_build
from repro.models import sharding as JS
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import batch_struct, build_model
from repro_torch.models import sharding as S

# (multi_pod, long_context, decode)
VARIANTS = list(itertools.product((False, True), repeat=3))
KINDS = {"train": J_SHAPES["train_4k"], "prefill": J_SHAPES["prefill_32k"],
         "decode": J_SHAPES["decode_32k"]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_dryrun():
    """The reference's ``launch.dryrun``: its import sets XLA_FLAGS to 512
    host devices, so the backend is started first and the variable put
    back (no later JAX start or subprocess sees it)."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdr
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return jdr


def _jtuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda v: isinstance(v, JP))


def _ptuples(tree):
    return S.map_logical(tuple, tree)


def _jflat(structs, specs):
    """{path: (shape, dtype, spec)} of a reference tree and its specs."""
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda v: isinstance(v, JP))
    paths = jax.tree_util.tree_flatten_with_path(structs)[0]
    assert len(paths) == len(spec_leaves)
    return {tuple(k.key for k in path): (tuple(s.shape), str(s.dtype), sp)
            for (path, s), sp in zip(paths, spec_leaves)}


def _pflat(tree, specs, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_pflat(tree[k], specs[k], path + (k,)))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."),
                   specs)}


def test_rule_tables_equal_the_reference():
    assert S.SINGLE_POD_RULES == JS.SINGLE_POD_RULES
    assert S.MULTI_POD_RULES == JS.MULTI_POD_RULES
    assert S.DECODE_OVERRIDES == JS.DECODE_OVERRIDES
    assert S.LONG_CONTEXT_OVERRIDES == JS.LONG_CONTEXT_OVERRIDES
    for v in VARIANTS:
        assert S.rules_for(*v) == JS.rules_for(*v), v
    rules = S.rules_for(multi_pod=True)
    assert tuple(S.spec("batch", None, "vocab", rules=rules)) == \
        tuple(JS.spec("batch", None, "vocab", rules=JS.rules_for(True)))
    assert S.spec("batch") == S.P() and S.current_rules() is None
    with S.use_rules(rules):
        assert S.current_rules() is rules
        assert S.spec("batch", "embed") == (("pod", "data"), "data")
    assert S.current_rules() is None


@pytest.mark.parametrize("arch", list(ARCHS))
def test_trees_and_specs_equal_the_reference(arch):
    """``logical``, ``param_specs`` and ``cache_specs`` under every rule
    variant, and the meta param tree's shapes and dtypes against
    ``jax.eval_shape`` of the reference's init."""
    jm, pm = j_build(J_ARCHS[arch]), build_model(ARCHS[arch], "meta")
    assert _ptuples(pm.logical()) == jm.logical()
    for v in VARIANTS:
        rules, jrules = S.rules_for(*v), JS.rules_for(*v)
        assert _ptuples(pm.param_specs(rules)) == \
            _jtuples(jm.param_specs(jrules)), v
        assert _ptuples(pm.cache_specs(rules)) == \
            _jtuples(jm.cache_specs(jrules)), v
    rules = S.rules_for()
    want = _jflat(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))),
                  jm.param_specs(JS.rules_for()))
    got = _pflat(dryrun.param_structs(pm), pm.param_specs(rules))
    assert {k: v[:2] for k, v in got.items()} == \
        {k: v[:2] for k, v in want.items()}
    want = _jflat(jm.cache_struct(4, 64), jm.cache_specs(JS.rules_for()))
    got = _pflat(pm.cache_struct(4, 64), pm.cache_specs(rules))
    assert {k: v[:2] for k, v in got.items()} == \
        {k: v[:2] for k, v in want.items()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_struct_and_specs_equal_the_reference(arch):
    jdr = _ref_dryrun()
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    for kind, shape in KINDS.items():
        jb = j_batch_struct(jcfg, shape, kind)
        pb = batch_struct(cfg, SHAPES[shape.name], kind)
        assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for k, t in pb.items()} == \
            {k: (tuple(s.shape), str(s.dtype)) for k, s in jb.items()}
        assert all(t.device.type == "meta" for t in pb.values())
        for v in VARIANTS:
            assert _ptuples(dryrun.batch_specs(pb, S.rules_for(*v))) == \
                _jtuples(jdr.batch_specs(jb, JS.rules_for(*v))), (kind, v)


def _ref_arguments(jm, jcfg, shape, jrules):
    """The reference dry run's step arguments: [(structs, specs)]."""
    p = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    ps = jm.param_specs(jrules)
    jb = j_batch_struct(jcfg, shape)
    bs = {k: JS.spec(*dryrun._BATCH_LOGICAL[k], rules=jrules) for k in jb}
    if shape.kind == "train":
        opt = {"m": p, "v": p, "count": jax.ShapeDtypeStruct((), jnp.int32)}
        return [(p, ps), (opt, {"m": ps, "v": ps, "count": JP()}), (jb, bs)]
    if shape.kind == "prefill":
        return [(p, ps), (jb, bs)]
    return [(p, ps), (jm.cache_struct(shape.global_batch, shape.seq_len),
                      jm.cache_specs(jrules)), (jb, bs)]


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_argument_bytes_on_the_production_meshes(arch, multi_pod):
    """Every supported shape: each leaf's per-device shard equals JAX's
    ``shard_shape`` wherever the mesh axes divide its dims, and a cell
    whose leaves all divide has the same per-device argument bytes."""
    plan = make_production_mesh(multi_pod=multi_pod)
    amesh = AbstractMesh(plan.shape, plan.axes)
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    jm, pm = j_build(jcfg), build_model(cfg, "meta")
    n_cells = n_whole = 0
    for name, shape in SHAPES.items():
        if not cfg.supports(shape):
            continue
        n_cells += 1
        long_ctx, decode = name == "long_500k", shape.kind == "decode"
        rules = S.rules_for(multi_pod, long_ctx, decode)
        jrules = JS.rules_for(multi_pod, long_ctx, decode)
        args = dryrun.cell_arguments(pm, shape, rules)
        jargs = _ref_arguments(jm, jcfg, J_SHAPES[name], jrules)
        assert len(args) == len(jargs)
        got_bytes = sum(dryrun._device_bytes(plan, t, s) for t, s in args)
        want_bytes, whole = 0, True
        for (t, s), (jt, js) in zip(args, jargs):
            got, want = _pflat(t, s), _jflat(jt, js)
            assert {k: v[:2] for k, v in got.items()} == \
                {k: v[:2] for k, v in want.items()}, (name, )
            for path, (shp, dt, jspec) in want.items():
                assert tuple(got[path][2]) == tuple(jspec), (name, path)
                try:
                    jshard = NamedSharding(amesh, jspec).shard_shape(shp)
                except ValueError:
                    whole = False
                    continue
                assert plan.shard_shape(shp, got[path][2]) == tuple(jshard), \
                    (name, path)
                n = 1
                for d in jshard:
                    n *= d
                want_bytes += n * jnp.dtype(dt).itemsize
        if whole:
            n_whole += 1
            assert got_bytes == want_bytes, name
    assert n_cells and n_whole, (n_cells, n_whole)
