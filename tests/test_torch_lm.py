"""PyTorch port of the LLM prefill-and-serve path against the JAX package:
configs, the param tree, ``CausalLM.prefill`` / ``decode_step`` and the
greedy ``launch.serve.generate`` of llama3.2-1b (dense GQA), minicpm3-4b
(MLA), rwkv6-3b, deepseek-moe-16b (MoE with a dense prelude),
phi3.5-moe, llava-next-mistral-7b (VLM; tokens only here, its patch path
in ``test_torch_vlm.py``), zamba2-1.2b (Mamba2 + shared attention; its
tail stage in ``test_torch_zamba.py``) and seamless-m4t-large-v2
(encoder-decoder: prompts carry frames, decode caches carry the cross K/V
of the encoded frames; the family's own parts in
``test_torch_encdec.py``) at reduced size, with the
reference's params carried across key by key
(``models.params_from_numpy``).

Tolerances, relative to max |logit| of the reference's prefill:
* float32: 1e-5.  The two frameworks sum in another order; measured up to
  4e-7 (prefill and 16 decode steps, both archs).
* bf16: 3e-2.  bf16 is rounded at other places in the two frameworks (XLA
  fuses elementwise chains and rounds once, torch rounds after each op);
  measured up to 8e-3.
* the port's own decode against its prefill: 2e-3, the reference's bound
  (``tests/test_models.py:87``), in float32; for MoE with capacity
  dropping off (``capacity_factor=64``) 1e-4, the reference's bound
  (``tests/test_models.py:90-94``): a prefill drops tokens past capacity,
  a one-token decode step never does.
Greedy tokens must be identical in float32.

MoE routes are discrete.  Against the reference, the port's router runs
on its own activations and its chosen experts are recorded; the values
are then compared with the reference's routes replayed into the port, so
a route that flips on a last-bit difference cannot hide the values of
every later position.  In float32 every route must be the reference's;
in bf16 (router logits rounded to bf16, as in the reference) a differing
route must be a near-tie: its margin within ROUTE_ULPS bf16 ulps of the
token's largest |logit|.
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
from repro.models import layers as JL
from repro.models import make_batch as j_make_batch
from repro.models import moe as JMOE
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import (ShapeConfig, active_param_count,
                                      param_count)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import wkv6 as WK
from repro_torch.launch import serve
from repro_torch.models import (build_model, make_batch, params_from_numpy,
                                params_to_numpy)
from repro_torch.models import moe as TMOE

ARCH_NAMES = ("llama3.2-1b", "minicpm3-4b", "rwkv6-3b", "deepseek-moe-16b",
              "phi3.5-moe-42b-a6.6b", "llava-next-mistral-7b", "zamba2-1.2b",
              "seamless-m4t-large-v2")
# the chunked scans (WKV6, Mamba2's SSD) take T up to ssm_chunk or a
# multiple of it, as in the reference
SSM_FAMILIES = ("rwkv", "hybrid")
MOE_NAMES = tuple(n for n in ARCH_NAMES if ARCHS[n].family == "moe")
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DROP_FREE_TOL = 1e-4
ROUTE_ULPS = 4


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


def _prompt(cfg, toks):
    """A prefill batch of numpy arrays: the tokens and, for the
    encoder-decoder, float32 frames (B, S // enc_ratio, d_model)."""
    out = {"tokens": toks}
    if cfg.family == "encdec":
        B, S = toks.shape
        out["frames"] = np.random.default_rng(5).normal(
            size=(B, max(1, S // cfg.enc_ratio), cfg.d_model)).astype(
                np.float32)
    return out


def _j_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else None)
            for k, v in batch.items()}


def _t_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j_cache(jm, jp, batch, B, T):
    """The reference's empty decode cache; the encoder-decoder's with its
    cross K/V filled from the encoded frames (``tests/test_models.py``)."""
    cache = jm.init_cache(B, T)
    if jm.cfg.family != "encdec":
        return cache
    cfg = jm.cfg
    mem = jm.encode(jp, jnp.asarray(batch["frames"]))
    cks, cvs = [], []
    for l in range(cfg.n_dec_layers):
        lp = jax.tree.map(lambda v: v[l], jp["dec"])
        _, mk, mv = JL.gqa_project(lp["cross_attn"], mem, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.hd, mem.dtype)
        cks.append(mk)
        cvs.append(mv)
    return {**cache, "cross_k": jnp.stack(cks), "cross_v": jnp.stack(cvs)}


def _t_cache(model, params, batch, B, T):
    """The port's counterpart of :func:`_j_cache`."""
    cache = model.init_cache(B, T)
    if model.cfg.family != "encdec":
        return cache
    return model.fill_cross_cache(params, cache,
                                  torch.as_tensor(batch["frames"]))


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

def _replay_routes(monkeypatch):
    """Record the reference's MoE routes as its ``moe_ffn`` runs (a debug
    callback, in layer order) and replay them into the port's ``route``
    calls in the same order.  Returns the port's calls as (its own
    experts, its probabilities, the reference's experts)."""
    ref, calls = [], []
    j_ffn, t_route = JMOE.moe_ffn, TMOE.route

    def j_wrap(cfg, p, x):
        B, S, d = x.shape
        xg = x.reshape(JMOE._n_groups(B * S), -1, d)
        logits = (xg @ p["router"].astype(x.dtype)).astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
        jax.debug.callback(lambda i: ref.append(np.asarray(i)), idx,
                           ordered=True)
        return j_ffn(cfg, p, x)

    def t_wrap(cfg, p, xg):
        probs, _, idx = t_route(cfg, p, xg)
        jax.effects_barrier()
        want = torch.tensor(ref[len(calls)], dtype=torch.int64)
        calls.append((idx, probs, want))
        gate = torch.gather(probs, -1, want)
        return probs, gate / torch.clamp(gate.sum(-1, keepdim=True),
                                         min=1e-9), want

    monkeypatch.setattr(JMOE, "moe_ffn", j_wrap)
    monkeypatch.setattr(TMOE, "route", t_wrap)
    return calls


def _route_flips(calls, dtype) -> int:
    """(call, token) routes where the port's own experts differ from the
    reference's: none in float32; in bf16 each a near-tie (see the module
    docstring).  Returns their count."""
    flips = 0
    for own, probs, want in calls:
        diff = (own.sort(-1).values != want.sort(-1).values).any(-1)
        flips += int(diff.sum())
        if not diff.any():
            continue
        assert dtype == "bfloat16", f"float32 routes differ: {diff.sum()}"
        logp = torch.log(probs[diff])
        margin = torch.gather(logp, -1, own[diff]).min(-1).values - \
            torch.gather(logp, -1, want[diff]).min(-1).values
        # the token's logits up to a shift: log p, shifted to max 0
        ulp = 2.0 ** (torch.floor(torch.log2(
            (logp - logp.max(-1, keepdim=True).values).abs().max(-1)
            .values.clamp(min=1e-30))) - 7)
        assert bool((margin <= ROUTE_ULPS * ulp).all()), (margin, ulp)
    return flips


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_match_reference(name, dtype, monkeypatch):
    """Prefill logits (a 37-token prompt for the attention families: two
    ragged attention blocks; 32 for rwkv and zamba2: two chunks) and 16 decode
    steps from an empty cache against the reference (MoE: with the
    reference's routes replayed, every differing route a near-tie)."""
    calls = _replay_routes(monkeypatch) if name in MOE_NAMES else None
    jm, jp, model, params = _pair(name, dtype)
    S = 32 if ARCHS[name].family in SSM_FAMILIES else 37
    batch = _prompt(model.cfg, _tokens(model.cfg, 2, S))
    toks = batch["tokens"]
    want = _np(jax.jit(jm.prefill)(jp, _j_batch(batch)))
    got = model.prefill(params, _t_batch(batch))
    assert got.shape == (2, S, model.cfg.padded_vocab)
    scale = float(np.abs(want).max())
    err = float(np.abs(_np(got) - want).max()) / scale
    assert err <= TOL[dtype], err
    jcache = _j_cache(jm, jp, batch, 2, 16)
    cache = _t_cache(model, params, batch, 2, 16)
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
    if calls is not None:   # prefill and 16 steps, every MoE layer
        assert len(calls) == 17 * (model.cfg.n_layers -
                                   model.cfg.first_dense)
        _route_flips(calls, dtype)


@pytest.mark.parametrize("name", [n for n in ARCH_NAMES
                                  if n not in MOE_NAMES])
def test_decode_matches_own_prefill(name):
    """The port's 16 decode steps reproduce its own float32 prefill within
    the reference's bound (2e-3 of max |logit|)."""
    _, _, model, params = _pair(name)
    batch = _prompt(model.cfg, _tokens(model.cfg, 2, 16, seed=2))
    toks = torch.as_tensor(batch["tokens"])
    full = model.prefill(params, _t_batch(batch))
    cache = _t_cache(model, params, batch, 2, 16)
    outs = []
    for t in range(16):
        logits, cache = model.decode_step(params, cache,
                                          {"tokens": toks[:, t:t + 1]}, t)
        outs.append(logits[:, 0])
    rel = float((torch.stack(outs, 1) - full).abs().max()) / \
        float(full.abs().max())
    assert rel < 2e-3, rel


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_decode_matches_own_prefill_drop_free(name):
    """With capacity dropping off (``capacity_factor=64``) the port's 16
    MoE decode steps reproduce its own float32 prefill within 1e-4 of max
    |logit| (the reference's bound), at the reduced and at the published
    expert ratio (64 experts, top-6, 2 shared)."""
    for over in ({}, {"n_experts": 64, "top_k": 6, "n_shared_experts": 2}):
        cfg = dataclasses.replace(ARCHS[name].reduced(), dtype="float32",
                                  capacity_factor=64.0, **over)
        model = build_model(cfg, "cpu")
        params = model.init(0)
        toks = torch.as_tensor(_tokens(cfg, 2, 16, seed=2))
        full = model.prefill(params, {"tokens": toks})
        cache = model.init_cache(2, 16)
        assert ("prelude" in cache) == bool(cfg.first_dense)
        outs = []
        for t in range(16):
            logits, cache = model.decode_step(params, cache,
                                              {"tokens": toks[:, t:t + 1]}, t)
            outs.append(logits[:, 0])
        rel = float((torch.stack(outs, 1) - full).abs().max()) / \
            float(full.abs().max())
        assert rel < DROP_FREE_TOL, (over, rel)


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
        model.prefill(params, _t_batch(_prompt(model.cfg,
                                               _tokens(model.cfg, 1, 16))))
        assert (dict(FA.launches), dict(WK.launches)) == before
        assert not any(FA.plain_calls.values())
        assert not any(WK.plain_calls.values())


# ------------------------------------------------------------------ entry

def test_build_model_families_and_device():
    """Every family of the reference's configs builds (all seven are
    ported), on the device asked for."""
    assert {cfg.family for cfg in ARCHS.values()} == {
        "dense", "vlm", "mla", "moe", "rwkv", "hybrid", "encdec"}
    for name, cfg in ARCHS.items():
        assert build_model(cfg.reduced(), "cpu").device.type == "cpu"
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
