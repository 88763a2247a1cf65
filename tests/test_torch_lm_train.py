"""PyTorch port of the LM training path against the JAX package:
``layers.cross_entropy`` / ``fused_head_cross_entropy``, ``CausalLM.loss``
and its gradients (llama3.2-1b, minicpm3-4b, rwkv6-3b, deepseek-moe-16b
with its dense prelude, phi3.5-moe, llava-next-mistral-7b with its
patches, zamba2-1.2b and seamless-m4t-large-v2 with its frames, reduced;
the MoE loss with its load-balance term),
per-layer remat, the kernels' training entries (``flash_attention_train``,
``wkv6_train``) and ``launch.train lm`` with its checkpoints, the
reference's params and checkpoints carried across.

Tolerances:
* loss and gradients against the reference in float32: the loss within
  1e-5 relative, every gradient leaf within 1e-4 of max(1, max |want|)
  (the frameworks sum in another order; measured up to 1e-7);
* in bf16: 3e-2 (``test_torch_lm.py``'s bound; bf16 is rounded at other
  places in the two frameworks; measured up to 1.5e-3);
* remat off, "full" and "dots" against each other, and the training
  entries against autograd through the plain versions: 1e-6 (the same
  arithmetic; measured equal);
* the reference's checkpoint resumed by the port: 3e-2 relative on the
  losses of the resumed steps (the reduced configs compute in bf16);
* a resumed run of the port against an uninterrupted one: bitwise.
"""
import argparse
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch import train as j_train
from repro.models import build_model as j_build
from repro.models import layers as JL
from repro_torch.configs import ARCHS
from repro_torch.checkpoint import ckpt
from repro_torch.core.nets import tree_leaves, tree_unflatten
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import wkv6 as WK
from repro_torch.launch import train
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as L

ARCH_NAMES = ("llama3.2-1b", "minicpm3-4b", "rwkv6-3b", "deepseek-moe-16b",
              "phi3.5-moe-42b-a6.6b", "llava-next-mistral-7b", "zamba2-1.2b",
              "seamless-m4t-large-v2")
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SAME = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module's tests run: the test workers
    are the parallelism."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _leaf_errs(got_tree_leaves, want_tree) -> list:
    return [_scaled_err(g, w) for g, w in
            zip(got_tree_leaves, jax.tree.leaves(want_tree))]


# ------------------------------------------------------------- cross-entropy

CE_CASES = {
    # name: (transpose_w, mask, n_valid, chunk, S)
    "untied": (False, False, None, 8, 32),
    "tied-masked": (True, True, None, 16, 32),
    "n_valid": (False, True, 200, 8, 32),
    "ragged-chunk": (True, True, 250, 12, 30),
    "one-chunk": (False, False, None, 512, 30),
}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_fused_head_cross_entropy_matches_reference(case):
    transpose_w, masked, n_valid, chunk, S = CE_CASES[case]
    rng = np.random.default_rng(len(case))
    B, D, V = 2, 16, 256
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    w = (0.3 * rng.normal(size=(V, D) if transpose_w else (D, V))
         ).astype(np.float32)
    labels = rng.integers(0, n_valid or V, (B, S))
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None

    def j_fn(x, w):
        return JL.fused_head_cross_entropy(
            x, w, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), chunk=chunk,
            transpose_w=transpose_w, n_valid=n_valid)

    want, (wdx, wdw) = jax.value_and_grad(j_fn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    got = L.fused_head_cross_entropy(
        xt, wt, torch.as_tensor(labels),
        None if mask is None else torch.as_tensor(mask), chunk=chunk,
        transpose_w=transpose_w, n_valid=n_valid)
    dx, dw = torch.autograd.grad(got, (xt, wt))
    got = got.detach()
    assert float(got) == pytest.approx(float(want), rel=TOL["float32"])
    assert _scaled_err(dx, wdx) <= GRAD_TOL["float32"]
    assert _scaled_err(dw, wdw) <= GRAD_TOL["float32"]

    # the unchunked cross-entropy on the full logits, against both
    logits = (x @ (w.T if transpose_w else w))
    if n_valid is not None:
        logits[..., n_valid:] = -1e30
    j_ce = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    t_ce = L.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                           None if mask is None else torch.as_tensor(mask))
    assert float(t_ce) == pytest.approx(float(j_ce), rel=TOL["float32"])
    assert float(t_ce) == pytest.approx(float(got), rel=TOL["float32"])


def test_fused_head_cross_entropy_saves_no_logits():
    """The float32 (B, S, V) logits are never saved for the backward: the
    chunks keep their inputs only."""
    B, S, D, V = 2, 64, 8, 512
    x = torch.randn((B, S, D), requires_grad=True)
    w = torch.randn((D, V), requires_grad=True)
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = L.fused_head_cross_entropy(x, w, torch.zeros((B, S),
                                                            dtype=torch.long),
                                          chunk=16)
    assert sizes and max(sizes) == D * V       # the head, not B x 16 x V
    loss.backward()
    assert x.grad.shape == x.shape and bool(torch.isfinite(w.grad).all())


# ------------------------------------------------------------- CausalLM.loss

def _pair(name, dtype="float32", **over):
    jcfg = dataclasses.replace(J_ARCHS[name].reduced(), dtype=dtype, **over)
    cfg = dataclasses.replace(ARCHS[name].reduced(), dtype=dtype, **over)
    jm, model = j_build(jcfg), build_model(cfg, "cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, model, params


def _train_batch(cfg, B=2, S=32, seed=3):
    """S tokens and labels; the VLM's patches in front of them (every
    leaf of its params then takes part in the loss), the
    encoder-decoder's S // enc_ratio frames beside them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
           "labels": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=(B, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            size=(B, S // cfg.enc_ratio, cfg.d_model)).astype(np.float32)
    return out


def _loss_and_grads(model, params, batch, **kw):
    leaves = [t.detach().clone().requires_grad_() for t in
              tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    loss = model.loss(p, {k: torch.as_tensor(v) for k, v in batch.items()},
                      **kw)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_and_grads_match_reference(name, dtype):
    jm, jp, model, params = _pair(name, dtype)
    batch = _train_batch(model.cfg)
    want, jgrads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    FA.reset_launch_counts()
    WK.reset_launch_counts()
    got, grads = _loss_and_grads(model, params, batch)
    assert float(got) == pytest.approx(float(want), rel=TOL[dtype])
    errs = _leaf_errs(grads, jgrads)
    assert len(errs) == len(jax.tree.leaves(jgrads))
    assert max(errs) <= GRAD_TOL[dtype], max(errs)
    # the training entries ran, one VJP recompute per layer (zamba2: per
    # stage; seamless: per encoder layer and two per decoder layer), on
    # the CPU's plain versions (no kernel launch)
    n = model.attn_calls
    rec = WK.recomputes["wkv6_vjp"] if name.startswith("rwkv") \
        else FA.recomputes["flash_attention_vjp"]
    assert rec == n
    assert FA.launches["flash_attention"] == 0 and WK.launches["wkv6"] == 0


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_remat_variants_agree(name):
    """remat off, "full" (each layer under a checkpoint) and "dots" (the
    products' outputs kept) give one loss and one gradient."""
    runs = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        _, _, model, params = _pair(name, remat=remat, remat_policy=policy)
        FA.reset_launch_counts()
        WK.reset_launch_counts()
        runs[(remat, policy)] = _loss_and_grads(model, params,
                                                _train_batch(model.cfg))
        rec = {**FA.recomputes, **WK.recomputes}
        assert sum(rec.values()) == model.attn_calls, rec
    loss0, g0 = runs[(False, "full")]
    for key, (loss, g) in runs.items():
        assert abs(float(loss) - float(loss0)) <= SAME * abs(float(loss0))
        for a, b in zip(g, g0):
            assert _scaled_err(a, b.numpy()) <= SAME, key
    with pytest.raises(ValueError, match="remat policy"):
        _, _, model, params = _pair(name, remat=True, remat_policy="some")
        _loss_and_grads(model, params, _train_batch(model.cfg))


def test_plain_flag_takes_the_plain_versions():
    """``loss(..., plain=True)`` differentiates the plain versions by
    autograd: no training entry, no recompute, the same loss."""
    for name in ARCH_NAMES:
        _, _, model, params = _pair(name)
        batch = _train_batch(model.cfg)
        FA.reset_launch_counts()
        WK.reset_launch_counts()
        loss_p, g_p = _loss_and_grads(model, params, batch, plain=True)
        assert not any({**FA.recomputes, **WK.recomputes}.values())
        loss, g = _loss_and_grads(model, params, batch)
        assert float(loss) == pytest.approx(float(loss_p), rel=SAME)
        assert max(_scaled_err(a, b.numpy()) for a, b in zip(g, g_p)) <= SAME


# ----------------------------------------------------- the training entries

def test_flash_attention_train_backward_equals_plain_autograd():
    g = torch.Generator().manual_seed(0)
    B, S, H, Hk, dh = 2, 40, 4, 2, 16
    q = torch.randn((B, S, H, dh), generator=g)
    k, v = (torch.randn((B, S, Hk, dh), generator=g) for _ in range(2))
    do = torch.randn((B, S, H, dh), generator=g)

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ts, causal=True, block_q=16)
        return out.detach(), torch.autograd.grad(out, ts, do)

    FA.reset_launch_counts()
    out, got = grads(FA.flash_attention_train)
    assert FA.recomputes["flash_attention_vjp"] == 1
    want_out, want = grads(FA.flash_attention_plain)
    assert sum(FA.launches.values()) == 0
    torch.testing.assert_close(out, want_out, rtol=SAME, atol=SAME)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=SAME, atol=SAME)


def test_wkv6_train_backward_equals_plain_autograd():
    g = torch.Generator().manual_seed(1)
    B, T, H, P = 2, 32, 2, 8
    r, k, v = (torch.randn((B, T, H, P), generator=g) for _ in range(3))
    w = 0.2 + 0.78 * torch.rand((B, T, H, P), generator=g)
    u = torch.randn((H, P), generator=g)
    dy = torch.randn((B, T, H, P), generator=g)

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
        out = fn(*ts, chunk=8)
        return out.detach(), torch.autograd.grad(out, ts, dy)

    WK.reset_launch_counts()
    out, got = grads(WK.wkv6_train)
    assert WK.recomputes["wkv6_vjp"] == 1
    want_out, want = grads(WK.wkv6_plain)
    assert sum(WK.launches.values()) == 0
    torch.testing.assert_close(out, want_out, rtol=SAME, atol=SAME)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=SAME, atol=SAME)


# ------------------------------------------------------------- train lm

def _port_lm(capsys, *argv) -> dict:
    assert train.main(["lm", "--reduced", "--device", "cpu", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "train_lm"]


def _ref_args(**kw):
    base = dict(arch="llama3.2-1b", reduced=True, preset=None, steps=3,
                batch=4, seq=256, lr=3e-4, seed=0, ckpt_dir=None,
                ckpt_every=25, log_every=10, resume=False)
    return argparse.Namespace(**{**base, **kw})


def test_reference_checkpoint_resumes_in_the_port(capsys, tmp_path):
    d, e = str(tmp_path / "D"), str(tmp_path / "E")
    j_train.run_lm(_ref_args(steps=3, ckpt_dir=d, ckpt_every=3))
    shutil.copytree(d, e)
    want = j_train.run_lm(_ref_args(steps=6, ckpt_dir=e, ckpt_every=3,
                                    resume=True))["losses"]
    got = _port_lm(capsys, "--steps", "6", "--ckpt-dir", d, "--ckpt-every",
                   "3", "--resume")
    assert got["start"] == 3 and len(got["losses"]) == len(want) == 3
    np.testing.assert_allclose(got["losses"], want, rtol=TOL["bfloat16"])


def test_resumed_run_repeats_the_uninterrupted_one_bitwise(capsys, tmp_path):
    argv = ["--steps", "6", "--batch", "2", "--seq", "32"]
    ck_whole, ck = str(tmp_path / "whole"), str(tmp_path / "ck")
    whole = _port_lm(capsys, *argv, "--ckpt-dir", ck_whole, "--ckpt-every",
                     "6")
    first = _port_lm(capsys, "--steps", "3", "--batch", "2", "--seq", "32",
                     "--ckpt-dir", ck, "--ckpt-every", "3")
    assert first["losses"] == whole["losses"][:3]
    rest = _port_lm(capsys, *argv, "--ckpt-dir", ck, "--ckpt-every", "3",
                    "--resume")
    assert rest["start"] == 3 and rest["losses"] == whole["losses"][3:]
    assert whole["final_loss"] == rest["final_loss"]
    assert whole["device"] == "cpu" and whole["steps"] == 6
    assert whole["tokens_per_s"] > 0 and len(whole["step_s"]) == 6
    want, _ = ckpt.raw_leaves(ck_whole, 6)
    got, meta = ckpt.raw_leaves(ck, 6)
    assert meta["metadata"] == {"step": 6, "arch": "llama3.2-1b"}
    assert got.keys() == want.keys()
    for path, a in want.items():     # params and Adam moments
        np.testing.assert_array_equal(got[path], a, err_msg=path)


def test_moe_run_with_prelude_resumes_bitwise(capsys, tmp_path):
    """``train lm`` on deepseek-moe-16b (reduced): ``--n-layers 3`` is the
    dense prelude and 2 MoE layers; its checkpoint holds ``prelude``
    beside ``layers``, and a resumed run repeats the uninterrupted one
    bitwise."""
    argv = ["--arch", "deepseek-moe-16b", "--n-layers", "3", "--steps", "4",
            "--batch", "2", "--seq", "32"]
    ck_whole, ck = str(tmp_path / "whole"), str(tmp_path / "ck")
    whole = _port_lm(capsys, *argv, "--ckpt-dir", ck_whole, "--ckpt-every",
                     "4")
    _port_lm(capsys, *argv[:-6], "--steps", "2", "--batch", "2", "--seq",
             "32", "--ckpt-dir", ck, "--ckpt-every", "2")
    rest = _port_lm(capsys, *argv, "--ckpt-dir", ck, "--ckpt-every", "2",
                    "--resume")
    assert whole["layers"] == 3 and rest["start"] == 2
    assert rest["losses"] == whole["losses"][2:]
    want, _ = ckpt.raw_leaves(ck_whole, 4)
    got, _ = ckpt.raw_leaves(ck, 4)
    assert got.keys() == want.keys()
    assert want["['params']/['prelude']/['mlp']/['wi']"].shape == \
        (1, 64, 10944)
    assert want["['params']/['layers']/['experts']/['wi']"].shape[0] == 2
    for path, a in want.items():     # params and Adam moments
        np.testing.assert_array_equal(got[path], a, err_msg=path)
