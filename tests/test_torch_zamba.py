"""PyTorch port of the Zamba2 hybrid (``models/zamba.py``: Mamba2 groups and
one shared attention block; zamba2-1.2b) and of Mamba2's SSD scan
(``models/ssm.py``) against the JAX package, on the same numpy inputs and
the reference's weights carried across (``params_from_numpy``).

The reduced config (4 layers, ``attn_every`` 2) has no tail stage while the
published one (38 layers, every 6) has two tail layers, so the model tests
run ``n_layers = 5`` in both packages: two stages and a tail of one.

Tolerances (the bars of ``test_torch_lm.py`` / ``test_torch_lm_train.py``):
* prefill and 16 decode steps: 1e-5 of max |logit| in float32, 3e-2 in
  bf16; the caches after the 16 steps (Mamba2 states and conv windows per
  layer, K/V per stage) within 1e-5 of max |value| in float32, so a decode
  that mixed stages or layers cannot hide behind its logits;
* loss 1e-5 relative, every gradient leaf 1e-4 of max(1, max |want|);
* the SSD scan: see ``test_ssd_chunk256_*``.  The reference's
  ``_ssd_chunked`` takes ``exp`` of the positive differences above the
  diagonal and masks afterwards; at a chunk of 256 and the init's decay
  they overflow float32, so its gradient is not finite there (ROADMAP
  Queue 3).  Chunking is exact algebra, so the reference at a chunk of 16
  (where nothing overflows) is the oracle for the port's chunk of 256.
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
from repro.models import ssm as JSSM
from repro_torch.configs import ARCHS
from repro_torch.core.nets import tree_leaves, tree_unflatten
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import ssm as TSSM
from repro_torch.models.zamba import Zamba2Model

NAME = "zamba2-1.2b"
TAIL = dict(n_layers=5)            # attn_every 2: two stages, a tail of one
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_TOL = 1e-4
SSD_FWD_TOL = 1e-6
SSD_TOL = 1e-5


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


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


# ------------------------------------------------------------ the SSD scan

def _ssd_inputs(B=1, T=256, H=4, P=8, N=8, seed=0):
    """Inputs at the init's decay: A = -1, dt = softplus(~0) ~ 0.69, so a
    chunk of 256 steps accumulates a log-decay of ~177."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(B, T, H, P)).astype(f)
    dt = np.log1p(np.exp(0.1 * rng.normal(size=(B, T, H)))).astype(f)
    A = -np.ones((H,), f)
    Bm = rng.normal(size=(B, T, N)).astype(f)
    Cm = rng.normal(size=(B, T, N)).astype(f)
    s0 = (0.1 * rng.normal(size=(B, H, P, N))).astype(f)
    gy = rng.normal(size=(B, T, H, P)).astype(f)
    gs = rng.normal(size=(B, H, P, N)).astype(f)
    return (x, dt, A, Bm, Cm, s0), (gy, gs)


def _j_ssd(args, cts, chunk):
    """The reference's outputs and its gradients in x, dt, A, Bm, Cm, s0
    (of <y, gy> + <state_T, gs>)."""
    gy, gs = (jnp.asarray(c) for c in cts)

    def f(*a):
        y, sT = JSSM._ssd_chunked(*a, chunk=chunk)
        return jnp.sum(y * gy) + jnp.sum(sT * gs), (y, sT)

    (_, (y, sT)), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(6)), has_aux=True))(
            *(jnp.asarray(a) for a in args))
    return (np.asarray(y), np.asarray(sT)), [np.asarray(g) for g in grads]


def _t_ssd(args, cts, chunk):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, sT = TSSM._ssd_chunked(*ts, chunk=chunk)
    gy, gs = (torch.as_tensor(c) for c in cts)
    grads = torch.autograd.grad(torch.sum(y * gy) + torch.sum(sT * gs), ts)
    return (y.detach(), sT.detach()), list(grads)


def test_ssd_chunk256_reference_gradient_is_not_finite():
    """The reference's own chunk-256 gradient in dt overflows (inf * 0)."""
    args, cts = _ssd_inputs()
    (y, sT), grads = _j_ssd(args, cts, 256)
    assert np.isfinite(y).all() and np.isfinite(sT).all()
    assert not np.isfinite(grads[1]).all()


@pytest.mark.parametrize("seed", range(5))
def test_ssd_chunk256_port_matches_reference_and_its_chunk16_gradient(seed):
    """The port at a chunk of 256: finite, its values within 1e-6 of max of
    the reference's at a chunk of 16 and every gradient (x, dt, A, B, C,
    the initial state) within 1e-5 of max(1, max |want|) of the
    reference's there; its values within 1e-5 of max of the reference's at
    256.

    The reference's chunk-256 values are themselves 2.6e-6 to 5.5e-6 of
    max off the float64 scan (seeds 0-4): its decays are differences of
    float32 sums near 177, rounded by ~1.5e-5.  The port forms those
    differences in float64, which puts its values within 3.6e-7 of the
    reference's at 16 (itself within 3.3e-7 of float64) and its gradients
    within 1.6e-6, A's included, so it is held to the reference at 256 at
    the suite's float32 bar and not at 1e-6."""
    args, cts = _ssd_inputs(seed=seed)
    (jy, js), _ = _j_ssd(args, cts, 256)
    (jy16, js16), jgrads16 = _j_ssd(args, cts, 16)
    (y, sT), grads = _t_ssd(args, cts, 256)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(sT).all())
    assert _rel(y, jy16) <= SSD_FWD_TOL and _rel(sT, js16) <= SSD_FWD_TOL
    assert _rel(y, jy) <= SSD_TOL and _rel(sT, js) <= SSD_TOL
    for i, (g, w) in enumerate(zip(grads, jgrads16)):
        assert bool(torch.isfinite(g).all())
        err = float(np.abs(_np(g) - w).max()) / max(1.0, float(np.abs(w).max()))
        assert err <= SSD_TOL, (i, err)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_matches_reference_at_the_same_chunk(chunk):
    """Values and gradients at one chunk in both packages (B 2, T 128)."""
    args, cts = _ssd_inputs(B=2, T=128, seed=chunk)
    (jy, js), jgrads = _j_ssd(args, cts, chunk)
    (y, sT), grads = _t_ssd(args, cts, chunk)
    assert _rel(y, jy) <= SSD_TOL and _rel(sT, js) <= SSD_TOL
    for g, w in zip(grads, jgrads):
        err = float(np.abs(_np(g) - w).max()) / max(1.0, float(np.abs(w).max()))
        assert err <= SSD_TOL, err


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(5)
    f = np.float32
    B, H, P, N = 2, 4, 8, 8
    x, state = rng.normal(size=(B, H, P)).astype(f), \
        rng.normal(size=(B, H, P, N)).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=(B, H)))).astype(f)
    A = -np.exp(0.3 * rng.normal(size=(H,))).astype(f)
    Bm, Cm = (rng.normal(size=(B, N)).astype(f) for _ in range(2))
    want = jax.jit(JSSM._ssd_step)(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm,
                                                     state)))
    got = TSSM._ssd_step(*(torch.as_tensor(a) for a in (x, dt, A, Bm, Cm,
                                                        state)))
    for g, w in zip(got, want):
        assert _rel(g, w) <= SSD_TOL


def test_ragged_T_beyond_the_chunk_fails_like_reference():
    """T > ssm_chunk and T % ssm_chunk != 0: the reference's scan asserts,
    the port's raises (ROADMAP Queue 3)."""
    jm, jp, model, params = _pair()
    toks = _tokens(model.cfg, 1, model.cfg.ssm_chunk + 4)
    with pytest.raises(AssertionError):
        jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with pytest.raises(ValueError, match="chunk"):
        model.prefill(params, {"tokens": torch.as_tensor(toks)})


# ------------------------------------------------------------- the model

def test_tail_config_tree_and_caches():
    """n_layers 5: 2 stages and a tail of 1; ``mamba`` stacked over 5
    layers, ``shared_attn`` unstacked, the caches stacked over 5 layers /
    2 stages; the init tree is the reference's."""
    jm, jp, model, params = _pair(**TAIL)
    assert isinstance(model, Zamba2Model)
    assert (model.n_stages, model.tail) == (2, 1) == (jm.n_stages, jm.tail)
    flat = lambda t: {jax.tree_util.keystr(p): tuple(np.shape(l)) for p, l in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(params) == flat(jp)
    assert all(t.dtype == torch.float32 for t in tree_leaves(params))
    jc, c = jm.init_cache(2, 16), model.init_cache(2, 16)
    assert flat(c) == flat(jc)
    for path, w in jax.tree_util.tree_flatten_with_path(jc)[0]:
        assert str(c[path[0].key][path[1].key].dtype) == f"torch.{w.dtype}"
    assert c["mamba"]["ssm"].dtype == torch.float32   # float32 in any dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tail_prefill_decode_and_caches_match_reference(dtype):
    jm, jp, model, params = _pair(dtype, **TAIL)
    toks = _tokens(model.cfg, 2, 32)
    want = _np(jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)}))
    FA.reset_launch_counts()
    got = model.prefill(params, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, 32, model.cfg.padded_vocab)
    scale = float(np.abs(want).max())
    assert float(np.abs(_np(got) - want).max()) / scale <= TOL[dtype]
    assert sum(FA.launches.values()) == 0       # CPU: the plain versions
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
    if dtype == "float32":
        for path, w in jax.tree_util.tree_flatten_with_path(jcache)[0]:
            g = cache
            for k in path:
                g = g[k.key]
            assert _rel(g, w) <= TOL[dtype], jax.tree_util.keystr(path)


def test_tail_decode_matches_own_prefill():
    """The port's 16 decode steps reproduce its own float32 prefill within
    the reference's bound (2e-3 of max |logit|)."""
    _, _, model, params = _pair(**TAIL)
    toks = torch.as_tensor(_tokens(model.cfg, 2, 16, seed=2))
    full = model.prefill(params, {"tokens": toks})
    cache = model.init_cache(2, 16)
    outs = []
    for t in range(16):
        logits, cache = model.decode_step(params, cache,
                                          {"tokens": toks[:, t:t + 1]}, t)
        outs.append(logits[:, 0])
    assert _rel(torch.stack(outs, 1), full) < 2e-3


def test_tail_loss_and_grads_match_reference():
    """Loss and gradients of the tail config against
    ``jax.value_and_grad``, the Mamba2 groups under remat; the shared
    block's training entry runs once a stage (not under remat, as in the
    reference)."""
    jm, jp, model, params = _pair(remat=True, **TAIL)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, model.cfg.vocab, (2, 32))
             for k in ("tokens", "labels")}
    want, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    FA.reset_launch_counts()
    loss = model.loss(tree_unflatten(params, leaves),
                      {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert FA.recomputes["flash_attention_vjp"] == model.n_stages == 2
    assert float(loss.detach()) == pytest.approx(float(want),
                                                 rel=TOL["float32"])
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(grads)
    for g, w in zip(grads, jl):
        w = np.asarray(w)
        err = float(np.abs(_np(g) - w).max()) / max(1.0, float(np.abs(w).max()))
        assert err <= GRAD_TOL, err


def test_train_lm_on_cpu_with_the_tail(capsys):
    """``train lm`` on the reduced zamba2 cut to 5 layers: finite losses,
    the JSON line."""
    assert train.main(["lm", "--arch", NAME, "--reduced", "--n-layers", "5",
                       "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "32", "--log-every", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "train_lm"]
    assert out["arch"] == NAME and out["layers"] == 5
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
