"""PyTorch port of the MLA block (``models/mla.py``, minicpm3-4b) against
the JAX package, where the v head is narrower than the q/k head as in the
published config (a 96-wide q/k head over a 64-wide v head).  The reduced
config has nope 8 + rope 8 = v 16, so these tests replace it in both
packages by nope 16 + rope 8 = 24 over v 16 (the same 3 : 2).

* prefill, 16 decode steps, ``loss`` and its gradients of that config
  against the reference (the bars of ``test_torch_lm.py`` and
  ``test_torch_lm_train.py``: 1e-5 of max |logit| in float32, loss 1e-5
  relative, gradient leaves 1e-4 of max(1, max |want|)), and decode
  against the port's own prefill (2e-3, the reference's bound);
* ``_absorbed_decode`` of one layer against the reference's at a cache
  filled with random latents (so the mask at t > pos matters) and pos > 0:
  1e-5 in float32, 3e-2 in bf16 (bf16 is rounded at other places in the
  two frameworks);
* the flash-attention wrapper (K5) with dv < dh on CPU tensors against the
  reference's ``layers.chunked_attention``, forward and VJP (1e-5), and the
  identity the float32 card path relies on: attention on v zero-padded to
  dh, sliced back to dv, equals attention on v (1e-6: the same
  arithmetic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.models import layers as JL
from repro.models import mla as JMLA
from repro_torch.configs import ARCHS
from repro_torch.core.nets import tree_leaves, tree_unflatten
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import build_model, mla, params_from_numpy

NAME = "minicpm3-4b"
NARROW_V = dict(nope_dim=16, rope_dim=8, v_head_dim=16)   # qk 24 > v 16
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_TOL = 1e-4
SAME = 1e-6


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


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


# -------------------------------------------------------------- the model

def test_narrow_v_prefill_and_decode_match_reference():
    jm, jp, model, params = _pair(**NARROW_V)
    cfg = model.cfg
    assert cfg.nope_dim + cfg.rope_dim > cfg.v_head_dim
    toks = _tokens(cfg, 2, 37)
    want = _np(jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)}))
    got = model.prefill(params, {"tokens": torch.as_tensor(toks)})
    scale = float(np.abs(want).max())
    assert float(np.abs(_np(got) - want).max()) / scale <= TOL["float32"]
    jcache, cache = jm.init_cache(2, 16), model.init_cache(2, 16)
    assert cache["ckv"].shape == (cfg.n_layers, 2, 16, cfg.kv_lora)
    assert cache["kr"].shape == (cfg.n_layers, 2, 16, cfg.rope_dim)
    jdec = jax.jit(jm.decode_step)
    derr, own = 0.0, []
    for t in range(16):
        cur = toks[:, t:t + 1]
        jl, jcache = jdec(jp, jcache, {"tokens": jnp.asarray(cur, jnp.int32)},
                          t)
        pl, cache = model.decode_step(params, cache,
                                      {"tokens": torch.as_tensor(cur)}, t)
        derr = max(derr, float(np.abs(_np(pl) - _np(jl)).max()) / scale)
        own.append(pl[:, 0])
    assert derr <= TOL["float32"], derr
    rel = float((torch.stack(own, 1) - got[:, :16]).abs().max()) / \
        float(got.abs().max())
    assert rel < 2e-3, rel


def test_narrow_v_loss_and_grads_match_reference():
    jm, jp, model, params = _pair(**NARROW_V)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, model.cfg.vocab, (2, 32))
             for k in ("tokens", "labels")}
    want, jgrads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    FA.reset_launch_counts()
    loss = model.loss(tree_unflatten(params, leaves),
                      {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(want),
                                                 rel=TOL["float32"])
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(grads)
    for g, w in zip(grads, jl):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        err = float(np.abs(_np(g) - w).max()) / max(1.0,
                                                     float(np.abs(w).max()))
        assert err <= GRAD_TOL, err
    # one training-entry VJP per layer, on the CPU's plain version
    assert FA.recomputes["flash_attention_vjp"] == model.cfg.n_layers
    assert FA.launches["flash_attention"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_decode_matches_reference(dtype):
    """One layer's absorbed decode at pos 7 of a 12-slot cache whose every
    slot holds random latents: the new cache and the output."""
    jm, jp, model, params = _pair(dtype, **NARROW_V)
    jcfg, cfg = jm.cfg, model.cfg
    B, T, pos = 2, 12, 7
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, T, cfg.kv_lora)).astype(np.float32)
    kr = rng.normal(size=(B, T, cfg.rope_dim)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tattn = {k: v[0] for k, v in params["layers"]["attn"].items()}
    want, wcache = JMLA._absorbed_decode(
        jattn, jnp.asarray(x, jdt), jcfg, jdt,
        jnp.full((B, 1), pos, jnp.int32),
        {"ckv": jnp.asarray(ckv, jdt), "kr": jnp.asarray(kr, jdt)}, pos)
    got, gcache = mla._absorbed_decode(
        tattn, torch.as_tensor(x).to(tdt), cfg, tdt,
        torch.full((B, 1), pos, dtype=torch.int64),
        {"ckv": torch.as_tensor(ckv).to(tdt),
         "kr": torch.as_tensor(kr).to(tdt)}, pos)
    assert got.dtype == tdt and got.shape == (B, 1, cfg.d_model)
    want = _np(want)
    err = float(np.abs(_np(got) - want).max()) / float(np.abs(want).max())
    assert err <= TOL[dtype], err
    for k in ("ckv", "kr"):
        w = _np(wcache[k])
        np.testing.assert_array_equal(_np(gcache[k])[:, :pos],
                                      w[:, :pos])
        np.testing.assert_array_equal(_np(gcache[k])[:, pos + 1:],
                                      w[:, pos + 1:])
        cerr = float(np.abs(_np(gcache[k])[:, pos] - w[:, pos]).max())
        assert cerr <= TOL[dtype] * max(1.0, float(np.abs(w[:, pos]).max()))


# ------------------------------------------------------- K5 with dv < dh

def _qkv_narrow(B=2, S=37, H=4, Hk=2, dh=24, dv=16, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, dh)).astype(np.float32),
            rng.normal(size=(B, S, Hk, dh)).astype(np.float32),
            rng.normal(size=(B, S, Hk, dv)).astype(np.float32))


@pytest.mark.parametrize("H,Hk", [(4, 4), (4, 2)])
def test_flash_attention_narrow_v_matches_reference(H, Hk):
    """The wrapper on CPU tensors (the plain version) and its training
    entry's VJP against the reference's attention, dh 24 over dv 16."""
    q, k, v = _qkv_narrow(H=H, Hk=Hk)
    do = np.random.default_rng(8).normal(size=v.shape[:2] + (H, 16)) \
        .astype(np.float32)

    def j_fn(q, k, v):
        return JL.chunked_attention(q, k, v, causal=True, block_q=16)

    want, vjp = jax.vjp(j_fn, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    FA.reset_launch_counts()
    got = FA.flash_attention_train(*ts, causal=True, block_q=16)
    grads = torch.autograd.grad(got, ts, torch.as_tensor(do))
    assert got.shape == (2, 37, H, 16)
    assert FA.recomputes["flash_attention_vjp"] == 1
    assert sum(FA.launches.values()) == 0
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL["float32"],
                               atol=TOL["float32"])
    for g, w in zip(grads, jgrads):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=TOL["float32"],
                                   atol=TOL["float32"])
    with torch.no_grad():
        fwd = FA.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                 causal=True, block_q=16)
    torch.testing.assert_close(fwd, got.detach(), rtol=SAME, atol=SAME)


@pytest.mark.parametrize("causal", [True, False])
def test_zero_padded_v_sliced_back_is_attention_on_v(causal):
    """What K5's wrapper does for float32 on a card with dv < dh: pad v
    with zeros to dh, attend, keep the first dv columns (the bf16 kernel
    reads v at its own width, and its zero fill past dv rests on the same
    identity).  The padded columns come out
    zero and the kept ones equal attention on v."""
    q, k, v = (torch.as_tensor(a) for a in _qkv_narrow(S=70, seed=9))
    dh, dv = q.shape[-1], v.shape[-1]
    padded = torch.nn.functional.pad(v, (0, dh - dv))
    out = FA.flash_attention_plain(q, k, padded, causal=causal, block_q=32)
    want = FA.flash_attention_plain(q, k, v, causal=causal, block_q=32)
    assert out.shape == q.shape and want.shape == v.shape[:2] + q.shape[2:3] \
        + (dv,)
    assert not out[..., dv:].any()
    torch.testing.assert_close(out[..., :dv], want, rtol=SAME, atol=SAME)
