"""The benchmark's plain reference against the port's plain CPU path.

At small sizes (the port's own ``reduced()`` and the tests' small
configurations) and in float32 on both sides, the reference's logits,
loss and gradients, and its first three training steps, agree with
``repro_torch``'s (whose kernels take their plain versions on CPU
tensors).  The reference itself imports nothing of the
port; this test imports both.
"""
from __future__ import annotations

import pytest
import torch

from portbench import program, traffic
from portbench.entries import lm_train
from portbench.reference import lm as ref
from portbench.tests.small import reduced_model, small_model

ARCHS = ["deepseek-moe-16b", "minicpm3-4b"]
SIZES = {"small": small_model, "reduced": reduced_model}


def _setup(arch, size, seed=11, B=2, S=24):
    torch.manual_seed(0)
    m = SIZES[size](arch, dtype="float32")
    model = program.build_model(m, torch.device("cpu"))
    params = traffic.make_weights(program.param_shapes(model), seed, "cpu")
    toks = traffic.tokens(seed, 0, B, S + 1, m["vocab"], "cpu")
    return m, model, params, toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_logits_match_the_port(arch, size):
    m, model, params, tokens, _ = _setup(arch, size)
    got = model.prefill(params, {"tokens": tokens})[..., :m["vocab"]]
    B, S = tokens.shape
    rows = (torch.arange(B).repeat_interleave(S), torch.arange(S).repeat(B))
    want = ref.logits_at(params, tokens, rows, m)
    torch.testing.assert_close(got.reshape(B * S, -1), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_loss_and_gradients_match_the_port(arch, size):
    m, model, params, tokens, labels = _setup(arch, size)
    leaves = [t for _, t in traffic.leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    got = model.loss(params, {"tokens": tokens, "labels": labels})
    g_got = torch.autograd.grad(got, leaves)
    want = ref.loss(params, tokens, labels, m)
    g_want = torch.autograd.grad(want, leaves)
    assert abs(float(got.detach()) - float(want.detach())) < 1e-5
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b"])
def test_reference_training_steps_match_the_port(arch):
    """The harness's own check of the train entry, in float32: the three
    numbers it compares read at rounding."""
    m = small_model(arch, dtype="float32")
    cell = {"params": {"batch": 2, "seq": 32, "peak_lr": 3e-2,
                       "total_steps": 100}}
    runner = lm_train.Runner(cell, m, 5, torch.device("cpu"))
    runner.setup()
    for i in runner.checked:
        runner.item(i)
    runner.close_window()
    r = runner.readings()
    assert r["loss_gap"] < 1e-5
    assert r["grad_gap"] < 1e-4
    assert r["change_gap"] < 1e-3
