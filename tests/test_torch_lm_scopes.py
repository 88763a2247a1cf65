"""The port's scope helper (``obs.profiling.scope``) and the ranges it opens
inside the LM layer loop, on the CPU: no ``record_function`` call outside
the helper, the shared no-op where nothing reads the scopes, the scope
path under the collective recorder with the profiler off, the
``lm_layer`` / ``moe_ffn`` / ``moe_ffn.bwd`` / ``mla_expand`` /
``weight_cast`` ranges of a training step and a prefill, the MoE layer's
backward nodes between the ``moe_ffn.bwd`` bracket, and the same numbers
with the profiler on and off."""
import ast
import collections
import dataclasses
import os

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.nets import tree_leaves
from repro_torch.launch.train import lm_train_step
from repro_torch.models import build_model, make_batch
from repro_torch.obs import profiling
from repro_torch.optim import adam as adam_lib
from repro_torch.utils.collectives import CollectiveRecorder

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch")
EVAL = "autograd::engine::evaluate_function: "


def _cpu_profile(**kw):
    return profile(activities=[ProfilerActivity.CPU], **kw)


# ---------------------------------------------------------------- the helper

def test_no_record_function_call_outside_the_helper():
    found = []
    for root, _, files in os.walk(SRC):
        for f in files:
            path = os.path.join(root, f)
            if not f.endswith(".py") or path.endswith(
                    os.path.join("obs", "profiling.py")):
                continue
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call):
                    fn = node.func
                    name = fn.attr if isinstance(fn, ast.Attribute) else \
                        getattr(fn, "id", None)
                    if name == "record_function":
                        found.append(f"{os.path.relpath(path, SRC)}:"
                                     f"{node.lineno}")
    assert found == []


def test_scope_is_one_shared_no_op_where_nothing_reads_it(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: opened.append(name))
    assert not torch.autograd._profiler_enabled()
    assert torch._C._len_torch_dispatch_stack() == 0
    for phase in ("lm_layer", "weight_cast", "comm", "adam_update"):
        ctx = profiling.scope(phase)
        assert ctx is profiling._NOOP
        with ctx:
            pass
    assert opened == []
    # nothing is inserted in the graph either
    x = torch.ones(3, requires_grad=True)
    y, finish = profiling.backward_scope("moe_ffn.bwd", x)
    assert y is x and finish(x, x) == (x, x)


def test_scope_opens_a_range_under_the_profiler():
    with _cpu_profile() as prof:
        with profiling.scope("lm_layer"):
            with profiling.scope("weight_cast"):
                torch.ones(2).to(torch.bfloat16)
    names = [e.name for e in prof.events()]
    assert names.count("lm_layer") == names.count("weight_cast") == 1


@pytest.fixture(scope="module")
def fake_group():
    """This process as rank 0 of a fake two-rank group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_the_recorder_reads_nested_scopes_with_the_profiler_off(fake_group):
    assert not torch.autograd._profiler_enabled()
    with CollectiveRecorder() as rec:
        with profiling.scope("lm_layer"), profiling.scope("moe_ffn"):
            dist.all_reduce(torch.ones(3), group=fake_group)
        dist.all_reduce(torch.ones(2), group=fake_group)
    assert [c.scope for c in rec.record if c.kind] == ["lm_layer/moe_ffn", ""]


@pytest.mark.parametrize("phase", ["moe", "lm-layer", "weight-cast"])
def test_unknown_phases_raise(phase):
    with pytest.raises(ValueError, match="unknown profiling phase"):
        profiling.scope(phase)
    with pytest.raises(ValueError, match="unknown profiling phase"):
        profiling.backward_scope(phase, torch.ones(2, requires_grad=True))


# ------------------------------------------------------------ the LM scopes

def _moe():
    """deepseek-moe-16b at its CPU size: a dense layer 0 and two MoE
    layers, each layer rematerialised."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              n_layers=3, remat=True)
    model = build_model(cfg, torch.device("cpu"))
    batch = make_batch(cfg, ShapeConfig("t", 32, 2, "train"), "train",
                       seed=0)
    return cfg, model, model.init(0), batch


def _mla():
    cfg = get_config("minicpm3-4b").reduced()
    model = build_model(cfg, torch.device("cpu"))
    batch = make_batch(cfg, ShapeConfig("p", 32, 2, "prefill"), "prefill",
                       seed=0)
    return cfg, model, model.init(0), batch


def _counts(prof):
    names = set(profiling.PORT_SCOPES.values())
    return collections.Counter(e.name for e in prof.events()
                               if e.name in names)


def _inside(e, r) -> bool:
    return e.thread == r.thread and \
        r.time_range.start <= e.time_range.start and \
        e.time_range.end <= r.time_range.end


def _float_matrix_casts_outside_weight_cast(prof) -> list:
    ev = prof.events()
    casts = [e for e in ev if e.name == "weight_cast"]
    return [e.input_shapes[0] for e in ev
            if e.name == "aten::_to_copy" and e.input_shapes
            and len(e.input_shapes[0]) == 2 and e.input_dtypes[0] == "float"
            and not any(_inside(e, c) for c in casts)]


def test_a_training_step_opens_each_layer_moe_and_bracket_scope():
    cfg, model, params, batch = _moe()
    opt = adam_lib.init_adam(params)
    n_moe = cfg.n_layers - cfg.first_dense
    with _cpu_profile(record_shapes=True) as prof:
        lm_train_step(model, params, opt, batch, 0, 1e-3, 10)
    c = _counts(prof)
    assert c["lm_layer"] == 2 * cfg.n_layers          # forward, recompute
    assert c["moe_ffn"] == 2 * n_moe
    assert c["moe_ffn.bwd"] == n_moe
    assert c["adam_update"] == 1 and c["weight_cast"] > 0
    assert _float_matrix_casts_outside_weight_cast(prof) == []


def _bracket_bodies(loss):
    """For each ``moe_ffn.bwd`` bracket of ``loss``'s graph, the latest MoE
    layer first: the names of the backward nodes that the MoE forward
    created, walked from the outputs' opening node down to the input's
    closing one (nodes made before the layer, the parameters' selects and
    accumulators, are not the MoE's)."""
    nodes, stack = set(), [loss.grad_fn]
    while stack:
        n = stack.pop()
        if n is not None and n not in nodes:
            nodes.add(n)
            stack.extend(f for f, _ in n.next_functions)
    bodies = []
    for top in sorted((n for n in nodes if n.name() == "_OpenRangeBackward"),
                      key=lambda n: -n._sequence_nr()):
        close, stack, seen = None, [top], set()
        while stack:
            n = stack.pop()
            if n is None or n in seen:
                continue
            seen.add(n)
            if n.name() == "_CloseRangeBackward":
                close = n
            else:
                stack.extend(f for f, _ in n.next_functions)
        lo, hi = close._sequence_nr(), top._sequence_nr()
        body, stack, seen = collections.Counter(), \
            [f for f, _ in top.next_functions], set()
        while stack:
            n = stack.pop()
            if n is None or n in seen or not lo < n._sequence_nr() < hi:
                continue
            seen.add(n)
            body[n.name()] += 1
            stack.extend(f for f, _ in n.next_functions)
        bodies.append(body)
    return bodies


def test_the_moe_backward_bracket_holds_the_layer_s_backward_nodes():
    cfg, model, params, batch = _moe()
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    with _cpu_profile() as prof:
        loss = model.loss(params, batch)
        bodies = _bracket_bodies(loss)
        torch.autograd.grad(loss, leaves)
    ev = prof.events()
    brackets = sorted((e for e in ev if e.name == "moe_ffn.bwd"),
                      key=lambda e: e.time_range.start)
    layers = [e for e in ev if e.name == "lm_layer"]
    evals = [e for e in ev if e.name.startswith(EVAL)
             and not any(_inside(e, lay) for lay in layers)]
    assert len(brackets) == len(bodies) == cfg.n_layers - cfg.first_dense
    for bracket, body in zip(brackets, bodies):
        held = collections.Counter(e.name[len(EVAL):] for e in evals
                                   if _inside(e, bracket))
        assert sum(body.values()) > 20 and held == body


def test_a_prefill_opens_each_layer_and_expansion_scope():
    cfg, model, params, batch = _mla()
    with torch.no_grad(), _cpu_profile(record_shapes=True) as prof:
        model.prefill(params, batch)
    c = _counts(prof)
    assert c["lm_layer"] == c["mla_expand"] == cfg.n_layers
    assert c["weight_cast"] > 0 and c["moe_ffn"] == 0
    assert _float_matrix_casts_outside_weight_cast(prof) == []


def _train_numbers(on: bool):
    _, model, params, batch = _moe()
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    with (_cpu_profile() if on else profiling._NOOP):
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        new, _, _, _ = lm_train_step(model, params,
                                     adam_lib.init_adam(params), batch, 0,
                                     1e-3, 10)
    return [loss.detach()] + list(grads) + tree_leaves(new)


def test_numbers_are_bitwise_the_same_with_the_profiler_on_and_off():
    off, on = _train_numbers(False), _train_numbers(True)
    assert len(off) == len(on)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    _, model, params, batch = _mla()
    with torch.no_grad():
        plain = model.prefill(params, batch)
        with _cpu_profile():
            traced = model.prefill(params, batch)
    assert torch.equal(plain, traced)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_backward_scopes_open_on_the_engine_s_device_thread(card):
    """On the card the backward runs on the autograd engine's device
    thread: the profiler's state reaches it, so the VJP, head and MoE
    backward scopes open there, and the numbers are those of a run with
    the profiler off."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              n_layers=3, remat=True)
    model = build_model(cfg, card)
    batch = make_batch(cfg, ShapeConfig("t", 64, 2, "train"), "train",
                       seed=0, device=card)
    params = model.init(0)
    leaves = tree_leaves(params)

    def step():
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        torch.cuda.synchronize(card)
        return [loss.detach()] + list(grads)

    off = step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on = step()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    ev = prof.events()
    main = next(e.thread for e in ev if e.name == "moe_ffn")
    engine = collections.Counter(e.name for e in ev if e.thread != main)
    assert engine["flash_attention_vjp"] == cfg.n_layers
    assert engine["fused_head_ce"] == 1
    assert engine["moe_ffn.bwd"] == cfg.n_layers - cfg.first_dense
    assert engine["lm_layer"] == cfg.n_layers      # the recomputes
