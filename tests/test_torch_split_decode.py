"""The split softmax over a cache split along T
(``models/partition.py::split_kv_attention``): each block of the cache
gives its partial (o, m, l) at its global offset
(``kernels/flash_attention.py::attention_partial``), a MAX of m and a SUM
of o e^(m - M) and l e^(m - M) combine them.

* The combine against the reference's ``layers.decode_attention`` under
  JAX on the CPU and the port's unsplit path, on the same numpy inputs:
  n = 1 .. 4 blocks of an uneven T (DTensor's ceil split), ``kv_len``
  inside the first block only, spanning blocks and equal to T; float32
  within 1e-6 of max(1, max |out|), a bf16 cache within 2e-3 of max
  |out|.  A block past every row's ``kv_len`` (and an empty one) adds 0;
  no NaN anywhere.  The blocks run in threads, each its own rank of an
  in-process group (:class:`_Group`).
* The encoder-decoder's cross decode (no ``kv_len``) and the MLA absorbed
  decode (its partial context kv_lora wide) the same way, through the
  helper on ranks' slices (``partition.use_seq``).
* No collective of a partitioned decode grows with the cache: every
  family on (2, 4) at two cache lengths, and zamba2 under the
  long-context rules.
* Two ``gloo`` ranks on the CPU decode a reduced llama with the cache
  split along T: the one-process decode's logits within 1e-5, and each
  rank's collectives those of the partitioned dry run of the same cell.

The reference band of the decode cells' collective bytes is in
``tests/test_torch_dryrun.py``.  JAX is imported inside the tests: the
ranks import this module by name.
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import mla
from repro_torch.models import partition as PT
from repro_torch.models.sharding import SINGLE_POD_RULES

F32_TOL = 1e-6     # of max(1, max |out|)
BF16_TOL = 2e-3    # of max |out|, a bf16 cache (the decode bar)
RANK_TOL = 1e-5    # gloo ranks' logits against one process, of max |logit|
B, H, HK, DH = 2, 4, 2, 16
FAMILIES = {"dense": "llama3.2-1b", "vlm": "llava-next-mistral-7b",
            "mla": "minicpm3-4b", "moe": "deepseek-moe-16b",
            "rwkv": "rwkv6-3b", "hybrid": "zamba2-1.2b",
            "encdec": "seamless-m4t-large-v2"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Group:
    """``n`` threads as the ranks of one group: ``all_reduce`` blocks
    until every rank has given its tensor, then gives each the reduction
    of all of them in rank order (the same on every rank)."""

    def __init__(self, n):
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n)

    def all_reduce(self, index, t, op):
        self.slots[index] = t
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        out = parts[0].clone()
        for p in parts[1:]:
            out = torch.maximum(out, p) if op == "max" else out + p
        return out

    def comm(self, index):
        """Rank ``index``'s ``core.halo.Comm``-like ``all_reduce``."""
        import torch.distributed as dist

        owner = self

        class _Comm:
            def all_reduce(self, t, op=dist.ReduceOp.SUM, group=None):
                name = "max" if op == dist.ReduceOp.MAX else "sum"
                return owner.all_reduce(index, t, name)
        return _Comm()

    def run(self, fn):
        """``fn(index)`` on every rank, in threads; their results."""
        out, errs = [None] * self.n, []

        def body(i):
            try:
                out[i] = fn(i)
            except BaseException as e:   # raised below
                errs.append(e)
                self.barrier.abort()
        threads = [threading.Thread(target=body, args=(i,))
                   for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


def _blocks(T, n):
    """DTensor's ceil split of T over n: [(start, stop)]."""
    c = -(-T // n)
    return [(min(i * c, T), min((i + 1) * c, T)) for i in range(n)]


def _split_combine(q, k, v, kv_len, n, T):
    """The split softmax of q over k, v cut in n ceil blocks, each block's
    partial and ``partition._combine`` on its own thread-rank."""
    g = _Group(n)

    def rank(i):
        a, b = _blocks(T, n)[i]
        o, m, l = FA.attention_partial(q, k[:, a:b], v[:, a:b], t0=a,
                                       kv_len=kv_len)
        return PT._combine(o, m, l, functools.partial(g.all_reduce, i))
    outs = g.run(rank)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    return outs[0]


def _inputs(T, dtype, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, DH)).astype(np.float32)
    k = rng.normal(size=(B, T, HK, DH)).astype(np.float32)
    v = rng.normal(size=(B, T, HK, DH)).astype(np.float32)
    return q, k, v


def _tol(want, dtype):
    top = float(np.abs(want).max())
    return F32_TOL * max(1.0, top) if dtype == "float32" else BF16_TOL * top


def _np(t):
    return t.detach().float().numpy()


# kv_len per row, T = 37: inside the first block for every n (ceil(37 / 4)
# = 10), spanning blocks, equal to T
KV_CASES = {"first": (5, 3), "spanning": (23, 30), "full": (37, 37)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(KV_CASES))
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_combine_matches_reference_decode_attention(n, case, dtype):
    import jax.numpy as jnp

    from repro.models import layers as JL

    T = 37
    q, k, v = _inputs(T, dtype)
    kv_len = np.array(KV_CASES[case])
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    got = _split_combine(tq, tk, tv, torch.as_tensor(kv_len), n, T)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    got = got.to(tdt)
    want = np.asarray(JL.decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(kv_len - 1)), np.float32)
    err = float(np.abs(_np(got) - want).max())
    assert err <= _tol(want, dtype), err
    # the port's unsplit path (the blocked attention)
    same = L.decode_attention(tq, tk, tv, torch.as_tensor(kv_len - 1))
    assert same.dtype == tdt
    err = float((got.float() - same.float()).abs().max())
    assert err <= _tol(want, dtype), err


def test_blocks_past_kv_len_and_empty_blocks_add_nothing():
    """T = 9 over 4 gives blocks of 3, 3, 3 and 0; with kv_len 2 every
    block but the first is masked whole: its m is NEG_INF (finite), its
    weight exactly 0, and the result is the first block's alone."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(9, "float32"))
    kv_len = torch.tensor([2, 2])
    for a, b in _blocks(9, 4)[1:]:
        o, m, l = FA.attention_partial(q, k[:, a:b], v[:, a:b], t0=a,
                                       kv_len=kv_len)
        assert bool((m == FA.NEG_INF).all())
        assert all(bool(torch.isfinite(t).all()) for t in (o, m, l))
    got = _split_combine(q, k, v, kv_len, 4, 9)
    alone = _split_combine(q, k[:, :2], v[:, :2], None, 1, 2)
    torch.testing.assert_close(got, alone, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_cross_decode_split_matches_reference(n, dtype):
    """The encoder-decoder's cross decode: one query over the cached
    frames, no ``kv_len``, through the helper on each rank's slice
    against the reference's call (``chunked_attention``, non-causal)."""
    import jax.numpy as jnp

    from repro.models import layers as JL

    T = 24
    q, k, v = _inputs(T, dtype, seed=4)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    g = _Group(n)

    def rank(i):
        seq = PT.SeqRank(n=n, index=i, group=None, comm=g.comm(i))
        with PT.use_seq(seq):
            kl, vl = seq.shard_cache(tk, 1), seq.shard_cache(tv, 1)
            return PT.split_kv_attention(
                tq, (kl, vl), None, plain=None,
                partial=FA.attention_partial, dtype=tdt)
    outs = g.run(rank)
    want = np.asarray(JL.chunked_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal=False, block_q=1), np.float32)
    same = L.chunked_attention(tq, tk, tv, causal=False, block_q=1)
    for got in outs:
        assert got.dtype == tdt
        err = float(np.abs(_np(got) - want).max())
        assert err <= _tol(want, dtype), err
        err = float((got.float() - same.float()).abs().max())
        assert err <= _tol(want, dtype), err


MLA_TOL = {"float32": 1e-5, "bfloat16": 3e-2}   # tests/test_torch_mla.py's


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [4, 17])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_mla_absorbed_decode_split(n, pos, dtype):
    """One layer's absorbed decode with its latent cache (T = 24) split
    over n thread-ranks: each writes the position where its slice holds
    it and attends over its slice; the output against the port's unsplit
    decode (1e-6 / 2e-3) and the reference's (the layer's own bars,
    1e-5 / 3e-2 of max), the slices' new caches against the unsplit
    one's, bitwise."""
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as J_ARCHS
    from repro.models import build_model as j_build
    from repro.models import mla as JMLA
    from repro_torch.models import params_from_numpy

    name = "minicpm3-4b"
    jcfg = dataclasses.replace(J_ARCHS[name].reduced(), dtype=dtype)
    cfg = dataclasses.replace(ARCHS[name].reduced(), dtype=dtype)
    jp = j_build(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    T = 24
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, T, cfg.kv_lora)).astype(np.float32)
    kr = rng.normal(size=(B, T, cfg.rope_dim)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tattn = {k: v[0] for k, v in params["layers"]["attn"].items()}
    want, _ = JMLA._absorbed_decode(
        jattn, jnp.asarray(x, jdt), jcfg, jdt,
        jnp.full((B, 1), pos, jnp.int32),
        {"ckv": jnp.asarray(ckv, jdt), "kr": jnp.asarray(kr, jdt)}, pos)
    want = np.asarray(want, np.float32)
    tx = torch.as_tensor(x).to(tdt)
    positions = torch.full((B, 1), pos, dtype=torch.int64)
    cache = {"ckv": torch.as_tensor(ckv).to(tdt),
             "kr": torch.as_tensor(kr).to(tdt)}
    same, same_cache = mla._absorbed_decode(tattn, tx, cfg, tdt, positions,
                                            cache, pos)
    g = _Group(n)

    def rank(i):
        seq = PT.SeqRank(n=n, index=i, group=None, comm=g.comm(i))
        with PT.use_seq(seq):
            return mla._absorbed_decode(tattn, tx, cfg, tdt, positions,
                                        seq.shard_cache(cache, 1), pos)
    outs = g.run(rank)
    top = float(np.abs(want).max())
    bar = F32_TOL * max(1.0, top) if dtype == "float32" else BF16_TOL * top
    for got, _ in outs:
        assert got.dtype == tdt and bool(torch.isfinite(got).all())
        err = float((got.float() - same.float()).abs().max())
        assert err <= bar, err
        err = float(np.abs(_np(got) - want).max()) / top
        assert err <= MLA_TOL[dtype], err
    for key in ("ckv", "kr"):
        whole = torch.cat([c[key] for _, c in outs], dim=1)
        assert torch.equal(whole, same_cache[key]), key


# ---------------------------------------------- no collective grows with T

def _decode_groups(arch, T, Bd=4, name="t"):
    _, rec = dryrun.lower_cell(
        arch, None, cfg_override=ARCHS[arch].reduced(),
        mesh=make_production_mesh(shape=(2, 4)),
        shape_override=ShapeConfig(name, T, Bd, "decode"), partitioned=True)
    return rec["collectives_by_group"]


@pytest.mark.parametrize("family", list(FAMILIES) + ["hybrid-long"])
def test_decode_collectives_do_not_grow_with_the_cache(family):
    """A partitioned decode's collectives by group, kind, count and bytes
    at cache lengths 64 and 512 on (2, 4) are equal: the split softmax
    moves (B, H) maxima and (B, H, dv + 1) sums, whatever T.  zamba2 under
    the long-context rules (B 1, the cache over both axes) too."""
    if family == "hybrid-long":
        arch, kw = FAMILIES["hybrid"], {"Bd": 1, "name": "long_500k"}
    else:
        arch, kw = FAMILIES[family], {}
    short, long_ = _decode_groups(arch, 64, **kw), \
        _decode_groups(arch, 512, **kw)
    assert short == long_
    assert short   # the step has collectives at all


# ------------------------------------------------- gloo ranks on the CPU

SEQ_T, SEQ_PROMPT, SEQ_STEPS = 64, 30, 4   # steps cross into rank 1's half


def _seq_cfg():
    return dataclasses.replace(ARCHS["llama3.2-1b"].reduced(),
                               dtype="float32")


def seq_rank_body(grid, cache, tokens):
    """A rank's decode over its half of the cache, teacher-forced with the
    one-process run's tokens: (logits, recorded collectives by group)."""
    from repro_torch.utils import collectives as COL

    torch.manual_seed(0)
    model = build_model(_seq_cfg(), "cpu")
    params = model.init(0)
    seq = grid.sequence_parallel()
    cache = seq.shard_cache(cache, 2)
    logits = []
    with PT.use_seq(seq), COL.CollectiveRecorder() as rec:
        for s in range(SEQ_STEPS):
            lg, cache = model.decode_step(
                params, cache, {"tokens": tokens[:, s:s + 1]},
                SEQ_PROMPT + s)
            logits.append(lg)
    return {"logits": torch.cat(logits, 1), "index": seq.index,
            "groups": {g: {k: [v["count"], v["bytes"]]
                           for k, v in kinds.items()}
                       for g, kinds in COL.by_group(rec.record).items()}}


def test_gloo_ranks_decode_over_a_sequence_split_cache(tmp_path):
    cfg = _seq_cfg()
    model = build_model(cfg, "cpu")
    params = model.init(0)
    rng = np.random.default_rng(2)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (B, SEQ_PROMPT + 1)))
    cache = model.init_cache(B, SEQ_T)
    for t in range(SEQ_PROMPT):
        _, cache = model.decode_step(params, cache,
                                     {"tokens": prompt[:, t:t + 1]}, t)
    full, tokens, c = [], [prompt[:, SEQ_PROMPT:]], cache
    for s in range(SEQ_STEPS):
        lg, c = model.decode_step(params, c, {"tokens": tokens[-1]},
                                  SEQ_PROMPT + s)
        full.append(lg)
        tokens.append(lg[..., :cfg.vocab].argmax(-1))
    full = torch.cat(full, 1)
    tokens = torch.cat(tokens[:-1], 1)
    ranks = mesh_lib.run_ranks(
        mesh_lib.make_grid_mesh(1, 2, str(tmp_path), "cpu"),
        seq_rank_body, cache, tokens, deadline_s=240)
    # the partitioned dry run of the cell: every param replicated, the
    # cache split along T over model
    rules = {k: None for k in SINGLE_POD_RULES if k != "batch"}
    rules["kv_seq"] = "model"
    _, rec = dryrun.lower_cell(
        "llama3.2-1b", None, cfg_override=cfg,
        mesh=make_production_mesh(shape=(1, 2)),
        shape_override=ShapeConfig("seq", SEQ_T, B, "decode"),
        partitioned=True, extra_rules=rules)
    dry = {g: {k: [v["count"] * SEQ_STEPS, v["bytes"] * SEQ_STEPS]
               for k, v in kinds.items()}
           for g, kinds in rec["collectives_by_group"].items()}
    # per layer a MAX of (B, 1, H) and one SUM of (B, 1, H, dh + 1), f32
    per_layer = [2, 4 * B * cfg.n_heads * (1 + cfg.hd + 1)]
    assert dry == {"model": {"all-reduce": [
        SEQ_STEPS * cfg.n_layers * per_layer[0],
        SEQ_STEPS * cfg.n_layers * per_layer[1]]}}
    top = float(full.abs().max())
    for r in ranks:
        err = float((r["logits"] - full).abs().max()) / top
        assert err <= RANK_TOL, (r["index"], err)
        assert r["groups"] == dry, (r["index"], r["groups"])
    assert sorted(r["index"] for r in ranks) == [0, 1]


def test_split_that_is_not_along_t_raises():
    """A cache split along its heads is no split the helper takes: it
    raises instead of gathering it."""
    plan = make_production_mesh(shape=(1, 4))
    with plan.fake_group() as grid:
        m = grid.device_mesh

        def dt(shape, spec):
            return PT.meta_dtensors(torch.empty(shape, device="meta"), spec,
                                    m, plan)
        from repro_torch.models.sharding import P
        q = dt((2, 1, 4, 16), P(None, None, "model", None))
        k = dt((2, 8, 4, 16), P(None, None, "model", None))
        with pytest.raises(ValueError, match="along T"):
            PT.split_kv_attention(q, (k, k), None, plain=None,
                                  partial=FA.attention_partial)
