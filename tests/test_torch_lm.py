"""PyTorch port of the LLM prefill-and-serve path against the JAX package:
configs, the param tree, ``CausalLM.prefill`` / ``decode_step`` and the
greedy ``launch.serve.generate`` of llama3.2-1b (dense GQA), minicpm3-4b
(MLA) and rwkv6-3b at reduced size, with the reference's params carried
across key by key (``models.params_from_numpy``).

Tolerances, relative to max |logit| of the reference's prefill:
* float32: 1e-5.  The two frameworks sum in another order; measured up to
  4e-7 (prefill and 16 decode steps, both archs).
* bf16: 3e-2.  bf16 is rounded at other places in the two frameworks (XLA
  fuses elementwise chains and rounds once, torch rounds after each op);
  measured up to 8e-3.
* the port's own decode against its prefill: 2e-3, the reference's bound
  (``tests/test_models.py:87``), in float32.
Greedy tokens must be identical in float32.
"""
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import active_param_count as j_active
from repro.configs.base import param_count as j_count
from repro.launch.serve import generate as j_generate
from repro.models import build_model as j_build
from repro.models import make_batch as j_make_batch
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import (ShapeConfig, active_param_count,
                                      param_count)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import wkv6 as WK
from repro_torch.launch import serve
from repro_torch.models import (build_model, make_batch, params_from_numpy,
                                params_to_numpy)

ARCH_NAMES = ("llama3.2-1b", "minicpm3-4b", "rwkv6-3b")
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module's tests run: the test workers
    are the parallelism."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, dtype="float32"):
    """The reduced config in both packages, the reference's params (seed 0)
    and the same params carried into the port on the CPU."""
    jcfg = dataclasses.replace(J_ARCHS[name].reduced(), dtype=dtype)
    cfg = dataclasses.replace(ARCHS[name].reduced(), dtype=dtype)
    jm, model = j_build(jcfg), build_model(cfg, "cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, model, params


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


# ------------------------------------------------------------------ configs

def test_configs_are_copies_of_the_reference():
    assert list(ARCHS) == list(J_ARCHS)
    for name, cfg in ARCHS.items():
        want = J_ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want), name
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(want.reduced()), name
        assert (cfg.hd, cfg.padded_vocab) == (want.hd, want.padded_vocab)
        assert param_count(cfg) == j_count(want), name
        assert active_param_count(cfg) == j_active(want), name
        for shape in SHAPES.values():
            assert cfg.supports(shape) == want.supports(J_SHAPES[shape.name])
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    with pytest.raises(KeyError):
        get_config("gpt-5")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_init_tree_matches_reference(name):
    """The port's init: the reference's keys, shapes and float32 leaves."""
    jcfg = J_ARCHS[name].reduced()
    want = jax.eval_shape(j_build(jcfg).init, jax.random.PRNGKey(0))
    got = build_model(ARCHS[name].reduced(), "cpu").init(0)
    flat_w = {jax.tree_util.keystr(p): (tuple(l.shape), l.dtype)
              for p, l in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): (tuple(l.shape), l.dtype)
              for p, l in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_g.keys() == flat_w.keys()
    for k, (shape, dtype) in flat_w.items():
        assert flat_g[k][0] == shape, k
        assert flat_g[k][1] == torch.float32 and dtype == jnp.float32


def test_params_and_batches_carry_across():
    jm, jp, model, params = _pair("llama3.2-1b")
    back = params_to_numpy(params)
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                         jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))
    jshape = JShapeConfig("tiny", 64, 2, "prefill")
    shape = ShapeConfig("tiny", 64, 2, "prefill")
    for kind in ("prefill", "decode", "train"):
        want = j_make_batch(jm.cfg, jshape, kind, seed=3)
        got = make_batch(model.cfg, shape, kind, seed=3)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_match_reference(name, dtype):
    """Prefill logits (a 37-token prompt for the attention families: two
    ragged attention blocks; 32 for rwkv: two WKV chunks) and 16 decode
    steps from an empty cache against the reference."""
    jm, jp, model, params = _pair(name, dtype)
    S = 32 if name.startswith("rwkv") else 37
    toks = _tokens(model.cfg, 2, S)
    want = _np(jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)}))
    got = model.prefill(params, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, S, model.cfg.padded_vocab)
    scale = float(np.abs(want).max())
    err = float(np.abs(_np(got) - want).max()) / scale
    assert err <= TOL[dtype], err
    jcache, cache = jm.init_cache(2, 16), model.init_cache(2, 16)
    jdec = jax.jit(jm.decode_step)
    derr = 0.0
    for t in range(16):
        cur = toks[:, t:t + 1]
        jl, jcache = jdec(jp, jcache, {"tokens": jnp.asarray(cur, jnp.int32)},
                          t)
        pl, cache = model.decode_step(params, cache,
                                      {"tokens": torch.as_tensor(cur)}, t)
        derr = max(derr, float(np.abs(_np(pl) - _np(jl)).max()) / scale)
    assert derr <= TOL[dtype], derr


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_matches_own_prefill(name):
    """The port's 16 decode steps reproduce its own float32 prefill within
    the reference's bound (2e-3 of max |logit|)."""
    _, _, model, params = _pair(name)
    toks = torch.as_tensor(_tokens(model.cfg, 2, 16, seed=2))
    full = model.prefill(params, {"tokens": toks})
    cache = model.init_cache(2, 16)
    outs = []
    for t in range(16):
        logits, cache = model.decode_step(params, cache,
                                          {"tokens": toks[:, t:t + 1]}, t)
        outs.append(logits[:, 0])
    rel = float((torch.stack(outs, 1) - full).abs().max()) / \
        float(full.abs().max())
    assert rel < 2e-3, rel


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_generate_matches_reference_tokens(name):
    jm, jp, model, params = _pair(name)
    prompts = _tokens(model.cfg, 3, 8, seed=4)
    want = np.asarray(j_generate(jm, jp, jnp.asarray(prompts, jnp.int32),
                                 24, 16))
    got = serve.generate(model, params, torch.as_tensor(prompts), 24, 16)
    assert got.shape == (3, 24)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rwkv_prefill_ragged_beyond_the_chunk_fails_like_reference():
    """T > ssm_chunk and T % ssm_chunk != 0: the reference's
    ``_wkv6_chunked`` reshape fails, and so does the port's plain path
    (ROADMAP Queue 3); the kernel on a card takes any T."""
    jm, jp, model, params = _pair("rwkv6-3b")
    toks = _tokens(model.cfg, 1, model.cfg.ssm_chunk + 4)
    with pytest.raises(TypeError):
        jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with pytest.raises(RuntimeError):
        model.prefill(params, {"tokens": torch.as_tensor(toks)})


def test_prefill_on_cpu_takes_the_plain_versions():
    """CPU tensors: no kernel launch and no plain-on-CUDA count."""
    for name in ARCH_NAMES:
        _, _, model, params = _pair(name)
        before = (dict(FA.launches), dict(WK.launches))
        model.prefill(params, {"tokens": torch.as_tensor(
            _tokens(model.cfg, 1, 16))})
        assert (dict(FA.launches), dict(WK.launches)) == before
        assert not any(FA.plain_calls.values())
        assert not any(WK.plain_calls.values())


# ------------------------------------------------------------------ entry

def test_build_model_families_and_device():
    for name, cfg in ARCHS.items():
        if cfg.family in ("dense", "mla", "rwkv"):
            assert build_model(cfg.reduced(), "cpu").device.type == "cpu"
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                build_model(cfg.reduced(), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(ARCHS["llama3.2-1b"].reduced())


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_serve_main_on_cpu(name):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", name, "--device", "cpu", "--batch", "2",
                         "--prompt-len", "5", "--gen", "3"])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])["serve"]
    assert rc == 0 and report["shape"] == [2, 8] and report["reduced"]
    assert report["new_tokens"] == 6 and report["tokens_per_s"] > 0
    assert serve._parser().parse_args([]).reduced is True
    assert serve._parser().parse_args(["--no-reduced"]).reduced is False
