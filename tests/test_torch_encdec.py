"""PyTorch port of the encoder-decoder family (``models/encdec.py``;
seamless-m4t-large-v2, reduced: 2 encoder + 2 decoder layers) against the
JAX package, on the same numpy inputs and the reference's weights carried
across (``params_from_numpy``): the param and cache trees, ``layer_norm``
and ``gelu_mlp``, ``encode``, the cross cache, prefill, 16 decode steps,
``loss`` and its gradients, and the routing of every full attention call
to K5's entries with its own ``causal`` flag (on the CPU the wrappers take
the plain versions; a card takes the same route to the kernel).

Tolerances (the bars of ``test_torch_lm.py`` / ``test_torch_lm_train.py``):
* ``layer_norm`` and ``gelu_mlp``: 1e-6 of max |want| (one float32 op
  chain each; ``jax.nn.gelu`` is the tanh approximation, and the exact
  erf GELU would be ~1e-3 off);
* the encoder's memory, the cross cache, prefill and 16 decode steps: 1e-5
  of max |want| in float32, 3e-2 in bf16; greedy tokens identical in
  float32; the port's decode against its own prefill 2e-3 (the reference's
  bound, ``tests/test_models.py:87``);
* loss 1e-5 relative, every gradient leaf 1e-4 of max(1, max |want|).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.models import layers as JL
from repro_torch.configs import ARCHS
from repro_torch.core.nets import tree_leaves, tree_unflatten
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models.encdec import EncDecModel

NAME = "seamless-m4t-large-v2"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_TOL = 1e-4
OP_TOL = 1e-6
DECODE_TOL = 2e-3
S, F = 37, 9          # decoder tokens (two ragged query blocks), frames


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module's tests run: the test workers
    are the parallelism."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype="float32", **over):
    jcfg = dataclasses.replace(J_ARCHS[NAME].reduced(), dtype=dtype, **over)
    cfg = dataclasses.replace(ARCHS[NAME].reduced(), dtype=dtype, **over)
    jm, model = j_build(jcfg), build_model(cfg, "cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, model, params


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _rel(got, want) -> float:
    want = _np(want)
    return float(np.abs(_np(got) - want).max()) / max(
        1e-30, float(np.abs(want).max()))


def _inputs(cfg, B=2, seed=1):
    """Tokens (B, S) and float32 frames (B, F, d_model) from one seed."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (B, S)),
            rng.normal(size=(B, F, cfg.d_model)).astype(np.float32))


def _j_cross_cache(jm, jp, frames, B, T):
    """The reference's decode cache with its cross K/V filled as its
    ``tests/test_models.py`` fills it."""
    cfg = jm.cfg
    mem = jm.encode(jp, jnp.asarray(frames))
    cks, cvs = [], []
    for l in range(cfg.n_dec_layers):
        lp = jax.tree.map(lambda v: v[l], jp["dec"])
        _, mk, mv = JL.gqa_project(lp["cross_attn"], mem, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.hd, mem.dtype)
        cks.append(mk)
        cvs.append(mv)
    cache = dict(jm.init_cache(B, T))
    cache["cross_k"], cache["cross_v"] = jnp.stack(cks), jnp.stack(cvs)
    return cache


# ------------------------------------------------------------ the pieces

def test_tree_and_caches_match_reference():
    """``build_model`` gives an ``EncDecModel``: the reference's param
    tree (``enc`` / ``dec`` stacked, ``enc_norm`` / ``final_norm``
    unstacked) with float32 leaves, its cache tree and dtypes, and 2 + 2 x
    2 full attention calls a forward, all under remat with ``cfg.remat``."""
    jm, jp, model, params = _pair(remat=True)
    assert isinstance(model, EncDecModel)
    assert (model.attn_calls, model.attn_remat) == (6, True)
    flat = lambda t: {jax.tree_util.keystr(p): tuple(np.shape(l)) for p, l in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert flat(model.init(0)) == flat(want) == flat(params)
    assert all(t.dtype == torch.float32 for t in tree_leaves(model.init(0)))
    for dtype in ("float32", "bfloat16"):
        jm, _, model, _ = _pair(dtype)
        jc, c = jm.init_cache(2, 16), model.init_cache(2, 16)
        assert flat(c) == flat(jc)
        assert c["cross_k"].shape[2] == 4   # max(1, 16 // enc_ratio)
        for k, w in jc.items():
            assert str(c[k].dtype) == f"torch.{w.dtype}" and \
                not c[k].any(), k


def test_layer_norm_and_gelu_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, size=(2, 7, 64)).astype(np.float32)
    w, b = (rng.normal(size=(64,)).astype(np.float32) for _ in range(2))
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = L.layer_norm(*(torch.as_tensor(a) for a in (x, w, b)))
    assert got.dtype == torch.float32 and _rel(got, want) <= OP_TOL
    # bf16 in, bf16 out: normalised in float32 and cast back
    xb = torch.as_tensor(x).to(torch.bfloat16)
    assert L.layer_norm(xb, torch.as_tensor(w), torch.as_tensor(b)).dtype \
        == torch.bfloat16
    # the MLP's tree and values, biases drawn non-zero
    jp = JL.init_gelu_mlp(jax.random.PRNGKey(1), 64, 128)
    tp = L.init_gelu_mlp(torch.Generator().manual_seed(1), 64, 128)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    jp = {k: np.asarray(v) + (0.1 * rng.normal(size=v.shape)).astype(
        np.float32) for k, v in jp.items()}
    want = JL.gelu_mlp({k: jnp.asarray(v) for k, v in jp.items()},
                       jnp.asarray(x))
    got = L.gelu_mlp(params_from_numpy(jp), torch.as_tensor(x))
    assert _rel(got, want) <= OP_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_cross_cache_match_reference(dtype):
    """The encoder's memory and the cross cache built from it (the
    reference's serve / test construction) against the reference's."""
    jm, jp, model, params = _pair(dtype)
    _, frames = _inputs(model.cfg)
    want = jm.encode(jp, jnp.asarray(frames))
    got = model.encode(params, torch.as_tensor(frames))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, F, 64)
    assert _rel(got, want) <= TOL[dtype]
    jc = _j_cross_cache(jm, jp, frames, 2, 16)
    c = model.fill_cross_cache(params, model.init_cache(2, 16),
                               torch.as_tensor(frames))
    for k in ("cross_k", "cross_v"):
        assert c[k].shape == (2, 2, F, 4, 16)
        assert _rel(c[k], jc[k]) <= TOL[dtype], k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill of S = 37 tokens over F = 9 frames, then 16 decode steps
    against the cross cache: every step's logits against the reference's,
    the greedy tokens identical (float32), the port's decode against its
    own prefill (2e-3) and the self caches after 16 steps."""
    jm, jp, model, params = _pair(dtype)
    toks, frames = _inputs(model.cfg)
    want = _np(jax.jit(jm.prefill)(jp, {
        "tokens": jnp.asarray(toks, jnp.int32),
        "frames": jnp.asarray(frames)}))
    got = model.prefill(params, {"tokens": torch.as_tensor(toks),
                                 "frames": torch.as_tensor(frames)})
    assert got.shape == (2, S, model.cfg.padded_vocab)
    scale = float(np.abs(want).max())
    assert float(np.abs(_np(got) - want).max()) / scale <= TOL[dtype]
    jcache = _j_cross_cache(jm, jp, frames, 2, 16)
    cache = model.fill_cross_cache(params, model.init_cache(2, 16),
                                   torch.as_tensor(frames))
    jdec = jax.jit(jm.decode_step)
    jouts, outs = [], []
    for t in range(16):
        cur = toks[:, t:t + 1]
        jl, jcache = jdec(jp, jcache, {"tokens": jnp.asarray(cur, jnp.int32)},
                          t)
        pl, cache = model.decode_step(params, cache,
                                      {"tokens": torch.as_tensor(cur)}, t)
        jouts.append(_np(jl)[:, 0])
        outs.append(_np(pl)[:, 0])
    jouts, outs = np.stack(jouts, 1), np.stack(outs, 1)
    assert float(np.abs(outs - jouts).max()) / scale <= TOL[dtype]
    if dtype == "float32":
        nv = model.cfg.vocab
        np.testing.assert_array_equal(outs[..., :nv].argmax(-1),
                                      jouts[..., :nv].argmax(-1))
        assert float(np.abs(outs - _np(got)[:, :16]).max()) / \
            float(np.abs(_np(got)).max()) < DECODE_TOL
        for k in ("self_k", "self_v"):
            assert _rel(cache[k], jcache[k]) <= TOL[dtype], k


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(remat):
    """Loss and gradients against ``jax.value_and_grad``, both stacks
    under per-layer remat or not; each of the 6 full attention calls goes
    through K5's training entry, one VJP recompute each."""
    jm, jp, model, params = _pair(remat=remat)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, model.cfg.vocab, (2, 32)),
             "labels": rng.integers(0, model.cfg.vocab, (2, 32)),
             "frames": rng.normal(size=(2, 8, 64)).astype(np.float32)}
    want, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    FA.reset_launch_counts()
    loss = model.loss(tree_unflatten(params, leaves),
                      {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert FA.recomputes["flash_attention_vjp"] == model.attn_calls == 6
    assert sum(FA.launches.values()) == 0        # CPU: the plain versions
    assert float(loss.detach()) == pytest.approx(float(want),
                                                 rel=TOL["float32"])
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(grads)
    for g, w in zip(grads, jl):
        w = np.asarray(w)
        err = float(np.abs(_np(g) - w).max()) / max(1.0, float(np.abs(w).max()))
        assert err <= GRAD_TOL, err


# ------------------------------------------------------------ K5's routes

def _record(monkeypatch, *names):
    """Wrap K5's entries ``names`` in ``FA``: each call appends (entry,
    causal, S, T) and goes on to the entry."""
    calls = []
    for name in names:
        fn = getattr(FA, name)

        def wrapped(q, k, v, *, causal=True, block_q=512, _n=name, _f=fn):
            calls.append((_n, causal, q.shape[1], k.shape[1]))
            return _f(q, k, v, causal=causal, block_q=block_q)

        monkeypatch.setattr(FA, name, wrapped)
    return calls


def test_every_full_attention_call_takes_k5_with_its_causal_flag(
        monkeypatch):
    """The encoder's self-attention (non-causal, F x F), the decoder's
    (causal, S x S) and the cross-attention (non-causal, S x F) all reach
    K5's wrapper in a prefill, its training entry in ``loss``, its plain
    version by name under ``plain=True``; a decode step's cross-attention
    (one query over the cached F frames) reaches the wrapper, its
    self-attention against the cache does not (``kv_len``: the plain
    blocked attention)."""
    calls = _record(monkeypatch, "flash_attention", "flash_attention_train",
                    "flash_attention_plain")
    _, _, model, params = _pair(remat=True)
    toks, frames = _inputs(model.cfg)
    batch = {"tokens": torch.as_tensor(toks),
             "frames": torch.as_tensor(frames)}
    per_layer = ([(False, F, F)] * 2 + [(True, S, S), (False, S, F)] * 2)
    model.prefill(params, batch)
    # the wrapper's CPU path is the plain version: it calls it by name
    assert [c for c in calls if c[0] == "flash_attention"] == \
        [("flash_attention", *c) for c in per_layer]
    assert len(calls) == 12
    calls.clear()
    model.prefill(params, batch, plain=True)
    assert calls == [("flash_attention_plain", *c) for c in per_layer]
    calls.clear()
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    loss = model.loss(tree_unflatten(params, leaves),
                      {**batch, "labels": batch["tokens"]})
    train_calls = [("flash_attention_train", *c) for c in per_layer]
    assert [c for c in calls if c[0] == "flash_attention_train"] == \
        train_calls
    calls.clear()
    torch.autograd.grad(loss, leaves)   # remat runs each layer again
    assert sorted(c for c in calls if c[0] == "flash_attention_train") == \
        sorted(train_calls)
    calls.clear()
    cache = model.fill_cross_cache(params, model.init_cache(2, 16),
                                   batch["frames"])
    calls.clear()
    model.decode_step(params, cache, {"tokens": batch["tokens"][:, :1]}, 0)
    assert [c for c in calls if c[0] == "flash_attention"] == \
        [("flash_attention", False, 1, F)] * 2


# ------------------------------------------------------------ train lm

def test_train_lm_cuts_both_stacks(capsys):
    """``train lm --n-layers 1`` on the reduced seamless: one encoder and
    one decoder layer, finite losses, the JSON line."""
    assert train.main(["lm", "--arch", NAME, "--reduced", "--n-layers", "1",
                       "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "32", "--log-every", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "train_lm"]
    assert out["arch"] == NAME and out["layers"] == 1
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    cfg = train.lm_config(train.argparse.Namespace(
        arch=NAME, reduced=True, preset=None, n_layers=1))
    assert (cfg.n_layers, cfg.n_dec_layers) == (1, 1)
