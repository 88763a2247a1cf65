"""PyTorch port of the VLM family (llava-next-mistral-7b: the dense block
behind a stub frontend of precomputed patch embeddings) and of
``models.make_batch``'s family branches against the JAX package, on the
same numpy inputs and the reference's weights carried across
(``params_from_numpy``).

Tolerances (the bars of ``test_torch_lm.py`` / ``test_torch_lm_train.py``):
* prefill with patches and 16 decode steps: 1e-5 of max |logit| in
  float32, 3e-2 in bf16 (bf16 is rounded at other places in the two
  frameworks);
* loss 1e-5 relative and every gradient leaf (``vis_proj`` included)
  1e-4 of max(1, max |want|) in float32; 3e-2 / 3e-2 in bf16;
* ``make_batch``: bitwise, key by key, in the reference's key order.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import build_model as j_build
from repro.models import make_batch as j_make_batch
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.nets import tree_leaves, tree_unflatten
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train
from repro_torch.models import build_model, make_batch, params_from_numpy

NAME = "llava-next-mistral-7b"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module's tests run: the test workers
    are the parallelism."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype="float32"):
    jcfg = dataclasses.replace(J_ARCHS[NAME].reduced(), dtype=dtype)
    cfg = dataclasses.replace(ARCHS[NAME].reduced(), dtype=dtype)
    jm, model = j_build(jcfg), build_model(cfg, "cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, model, params


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _to_torch(v):
    a = np.array(v)
    if a.dtype == np.int32:
        return torch.as_tensor(a, dtype=torch.int64)
    return torch.as_tensor(a.astype(np.float32)).to(getattr(torch,
                                                           str(a.dtype)))


def _batches(jm, kind, S=40, B=2, seed=5):
    """One batch (8 patches + S - 8 tokens) as the reference's arrays and
    the same values as the port's tensors."""
    jb = j_make_batch(jm.cfg, JShapeConfig("t", S, B, kind), seed=seed)
    return jb, {k: _to_torch(v) for k, v in jb.items()}


# ------------------------------------------------------------- the batches

BATCH_CASES = [
    (NAME, "train", "float32"), (NAME, "train", "bfloat16"),
    (NAME, "prefill", "float32"), (NAME, "prefill", "bfloat16"),
    ("seamless-m4t-large-v2", "train", "bfloat16"),
    ("seamless-m4t-large-v2", "prefill", "float32"),
    ("llama3.2-1b", "train", "bfloat16"),
]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name,kind,dtype", BATCH_CASES)
def test_make_batch_matches_reference(name, kind, dtype, seed):
    """The port's batch is the reference's for the same seed: the same
    keys in the same order (the draws come from one stream in key order),
    every value bitwise, the float inputs in the config's dtype."""
    jcfg = dataclasses.replace(J_ARCHS[name].reduced(), dtype=dtype)
    cfg = dataclasses.replace(ARCHS[name].reduced(), dtype=dtype)
    want = j_make_batch(jcfg, JShapeConfig("t", 24, 3, kind), seed=seed)
    got = make_batch(cfg, ShapeConfig("t", 24, 3, kind), seed=seed)
    assert list(got) == list(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        if w.dtype == np.int32:
            assert g.dtype == torch.int64
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert g.dtype == getattr(torch, dtype), k
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32))


def test_seq_must_leave_text_tokens():
    """``seq_len`` counts the patches and the tokens: a length that leaves
    no token raises, in ``make_batch`` and in ``train lm``."""
    cfg = ARCHS[NAME].reduced()
    with pytest.raises(ValueError, match="no text tokens"):
        make_batch(cfg, ShapeConfig("t", cfg.n_patches, 2, "train"))
    with pytest.raises(ValueError, match="no text tokens"):
        train.main(["lm", "--arch", NAME, "--reduced", "--device", "cpu",
                    "--steps", "1", "--seq", str(cfg.n_patches)])
    assert make_batch(cfg, ShapeConfig("t", cfg.n_patches + 1, 2,
                                       "decode"))["tokens"].shape == (2, 1)


# ------------------------------------------------------------- the model

def test_vis_proj_is_drawn_after_the_dense_tree():
    """The VLM's init is the dense config's from the same seed, with
    ``vis_proj`` (w drawn last, b zero) beside it."""
    cfg = ARCHS[NAME].reduced()
    vlm = build_model(cfg, "cpu").init(7)
    dense = build_model(dataclasses.replace(cfg, family="dense"),
                        "cpu").init(7)
    assert sorted(vlm) == sorted([*dense, "vis_proj"])
    for a, b in zip(tree_leaves({k: vlm[k] for k in dense}),
                    tree_leaves(dense)):
        assert torch.equal(a, b)
    assert vlm["vis_proj"]["w"].shape == (cfg.patch_dim, cfg.d_model)
    assert not vlm["vis_proj"]["b"].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_patches_and_decode_match_reference(dtype):
    """A prefill of 8 patches + 32 tokens (one causal sequence of 40) and
    16 tokens-only decode steps from an empty cache, against the
    reference."""
    jm, jp, model, params = _pair(dtype)
    jb, batch = _batches(jm, "prefill")
    want = _np(jax.jit(jm.prefill)(jp, jb))
    FA.reset_launch_counts()
    got = model.prefill(params, batch)
    assert got.shape == (2, 40, model.cfg.padded_vocab)
    scale = float(np.abs(want).max())
    err = float(np.abs(_np(got) - want).max()) / scale
    assert err <= TOL[dtype], err
    assert sum(FA.launches.values()) == 0       # CPU: the plain versions
    toks = np.asarray(jb["tokens"])
    jcache, cache = jm.init_cache(2, 16), model.init_cache(2, 16)
    jdec = jax.jit(jm.decode_step)
    derr = 0.0
    for t in range(16):
        cur = toks[:, t:t + 1]
        jl, jcache = jdec(jp, jcache, {"tokens": jnp.asarray(cur)}, t)
        pl, cache = model.decode_step(params, cache,
                                      {"tokens": torch.as_tensor(cur)}, t)
        derr = max(derr, float(np.abs(_np(pl) - _np(jl)).max()) / scale)
    assert derr <= TOL[dtype], derr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_with_patches_match_reference(dtype):
    """``loss`` on 8 patches + 24 tokens (the patch positions dropped
    before the head) and its gradient in every leaf, ``vis_proj``
    included, against ``jax.value_and_grad``; one K5 training entry (its
    VJP recompute) per layer."""
    jm, jp, model, params = _pair(dtype)
    jb, batch = _batches(jm, "train", S=32)
    assert batch["tokens"].shape == (2, 24)
    want, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    FA.reset_launch_counts()
    loss = model.loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    assert FA.recomputes["flash_attention_vjp"] == model.cfg.n_layers
    assert float(loss.detach()) == pytest.approx(float(want),
                                                 rel=TOL[dtype])
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(grads)
    for g, w in zip(grads, jl):
        w = np.asarray(w, np.float32)
        err = float(np.abs(_np(g) - w).max()) / max(1.0, float(np.abs(w).max()))
        assert err <= GRAD_TOL[dtype], err
    assert float(grads[-1].abs().max()) > 0      # vis_proj.w learns


def test_patch_positions_carry_no_targets():
    """The loss is the mean NLL of the token positions of the forward's
    logits: the patch positions are dropped, the labels align with the
    tokens."""
    _, _, model, params = _pair()
    batch = make_batch(model.cfg, ShapeConfig("t", 32, 2, "train"), seed=1)
    logits, _ = model.forward(params, {k: batch[k] for k in
                                       ("tokens", "patch_embeds")})
    P = model.cfg.n_patches
    nll = torch.nn.functional.cross_entropy(
        logits[:, P:].reshape(-1, logits.shape[-1]).float(),
        batch["labels"].reshape(-1))
    assert float(model.loss(params, batch)) == pytest.approx(float(nll),
                                                             rel=1e-5)


def test_train_lm_on_cpu(capsys):
    """``train lm`` on the reduced llava: ``--seq`` counts patches and
    tokens; finite losses, the JSON line."""
    assert train.main(["lm", "--arch", NAME, "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "32",
                       "--log-every", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "train_lm"]
    assert out["arch"] == NAME and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"])) and out["tokens_per_s"] > 0
