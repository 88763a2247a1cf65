"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, and the meta branches of the K5 / K6 wrappers it traces
through.

* The slice as a whole: the reference's own ``lower_cell`` (8 fake CPU
  devices, a (2, 4) mesh, no unrolled FLOP fit) on a reduced config of
  each of the seven families, train / prefill / decode at the production
  shapes, against the port's record on the same mesh plan: argument and
  output bytes per device, param counts and model FLOPs exactly equal.
* The meta trace's outputs (loss, params, Adam state, logits, new cache)
  have the shapes and dtypes of ``jax.eval_shape`` of the reference's step
  for a reduced config of each of the seven families, and its K5 / K6
  calls are ``chip_smoke.py``'s ``_kernel_calls`` / ``_decode_calls``.
* The FLOPs of a reduced dense config equal a count written here from the
  config, within 1e-9 relative, term by term.
* A full-size cell allocates nothing real; the CLI writes its record.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as J_ARCHS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import batch_struct as j_batch_struct
from repro.models import build_model as j_build
from repro.optim import adam as j_adam
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import wkv6 as WK
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

FAMILIES = {"dense": "llama3.2-1b", "vlm": "llava-next-mistral-7b",
            "mla": "minicpm3-4b", "moe": "deepseek-moe-16b",
            "rwkv": "rwkv6-3b", "hybrid": "zamba2-1.2b",
            "encdec": "seamless-m4t-large-v2"}
SLICE_ARCHS = tuple(FAMILIES.values())
SLICE_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MESH = make_production_mesh(shape=(2, 4))
SMALL = {"train": (2, 64), "prefill": (2, 64), "decode": (2, 64)}  # B, S
KEYS = {"arch", "shape", "kind", "mesh", "n_devices", "memory", "peak_bytes",
        "flops", "bytes", "flops_per_device", "bytes_per_device",
        "kernel_calls", "model_flops", "model_flops_ratio", "param_count",
        "active_param_count", "roofline", "notes", "ok"}

REF_CODE = """
import json
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch import dryrun
dryrun._UNROLL_MEASURE = False
dryrun.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
keep = ("memory", "param_count", "active_param_count", "model_flops",
        "mesh", "n_devices", "collectives")
for arch in {archs!r}:
    for shape in {shapes!r}:
        _, _, rec = dryrun.lower_cell(arch, shape,
                                      cfg_override=get_config(arch).reduced())
        print("REC " + json.dumps({{"arch": arch, "shape": shape,
                                   **{{k: rec[k] for k in keep}}}}),
              flush=True)
# the options, on the first subprocess's dense prefill
for arch in {archs!r}[:1]:
    for tag, kw in OPTIONS.items():
        _, _, rec = dryrun.lower_cell(arch, "prefill_32k",
                                      cfg_override=get_config(arch).reduced(),
                                      **kw)
        print("REC " + json.dumps({{"arch": arch, "shape": tag,
                                   **{{k: rec[k] for k in keep}}}}),
              flush=True)
"""
# lower_cell options held against the reference's on a dense prefill
OPTIONS = {"bf16_params": {"bf16_params": True},
           "extra_rules": {"extra_rules": {"embed": None, "vocab": None}}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def ref_records():
    """The reference's records, computed in three subprocesses with 8
    fake devices each, started with the module's first test: they run while
    the tests before the slice's trace the port."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"OPTIONS = {OPTIONS!r}\n"
         + REF_CODE.format(archs=archs, shapes=SLICE_SHAPES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for archs in (SLICE_ARCHS[:2], SLICE_ARCHS[2:5], SLICE_ARCHS[5:])]
    cache = {}

    def get(arch, shape):
        if not cache:
            for proc in procs:
                out, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-3000:]
                for line in out.splitlines():
                    if line.startswith("REC "):
                        r = json.loads(line[4:])
                        cache[(r["arch"], r["shape"])] = r
        return cache[(arch, shape)]

    yield get
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()



# ------------------------------------------------------------------- shapes

def _flat(tree, path=()):
    """{path: (shape, dtype)} of a nested tuple / dict tree of tensors or
    JAX structs."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], path + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: (tuple(tree.shape),
                   str(tree.dtype).removeprefix("torch."))}


def _ref_outputs(arch, kind, B, S):
    """``jax.eval_shape`` of the reference's step on a reduced config."""
    jcfg = J_ARCHS[arch].reduced()
    jm = j_build(jcfg)
    p = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    b = j_batch_struct(jcfg, JShapeConfig("t", S, B, kind), kind)
    i32 = jax.ShapeDtypeStruct((), jnp.int32)
    if kind == "train":
        def step(params, opt, batch):
            loss, g = jax.value_and_grad(jm.loss)(params, batch)
            p2, o2 = j_adam.adam_update(g, opt, params, 1e-4)
            return p2, o2, loss

        return jax.eval_shape(step, p, {"m": p, "v": p, "count": i32}, b)
    if kind == "prefill":
        return jax.eval_shape(jm.prefill, p, b)
    return jax.eval_shape(jm.decode_step, p, jm.cache_struct(B, S), b, i32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_meta_outputs_and_kernel_calls_match(family):
    """Every kind's traced outputs against ``jax.eval_shape``; K5 / K6
    calls against ``chip_smoke._kernel_calls`` (the config's remat on)."""
    arch = FAMILIES[family]
    cfg = ARCHS[arch].reduced()
    kname = chip_smoke.FAMILY_KERNEL[family]
    for kind, (B, S) in SMALL.items():
        out, rec = dryrun.lower_cell(arch, None, cfg_override=cfg, mesh=MESH,
                                     shape_override=ShapeConfig("t", S, B,
                                                                kind))
        assert _flat(out) == _flat(_ref_outputs(arch, kind, B, S)), kind
        assert all(t.device.type == "meta"
                   for t in torch.utils._pytree.tree_leaves(out))
    remat = dataclasses.replace(cfg, remat=True)
    model = build_model(remat, "cpu")
    prefill, train, _ = chip_smoke._kernel_calls(model)
    want = {"prefill": prefill, "train": train,
            "decode": chip_smoke._decode_calls(remat)}
    for kind, (B, S) in SMALL.items():
        _, rec = dryrun.lower_cell(arch, None, cfg_override=remat, mesh=MESH,
                                   shape_override=ShapeConfig("t", S, B,
                                                              kind))
        other = "wkv6" if kname == "flash_attention" else "flash_attention"
        assert rec["kernel_calls"] == {kname: want[kind], other: 0}, kind


# -------------------------------------------------------------------- FLOPs

def _dense_flops(cfg, kind, B, S) -> dict:
    """The products of a dense config's step, by term (FLOPs = 2 per
    multiply-add), S the sequence (decode: the cache length)."""
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ff, V, L = cfg.d_ff, cfg.padded_vocab, cfg.n_layers

    def proj(n_tok):   # q, k, v, o and the SwiGLU's three, one layer
        return 2 * n_tok * (d * (H + 2 * Hk) * hd + H * hd * d + 3 * d * ff)

    if kind == "decode":
        return {"products": L * proj(B),
                "attention over the cache (scores and P V)":
                    L * 2 * 2 * B * H * S * hd,
                "head": 2 * B * d * V}
    n = B * S
    k5 = 2 * (hd + hd) * B * H * S * (S + 1) // 2   # visible pairs, causal
    terms = {"products": L * proj(n), "K5's visible pairs": L * k5,
             "head": 2 * n * d * V}
    if kind == "train":
        terms.update({
            # the chunked head recomputes its logits, then two products
            "head backward": 3 * 2 * n * d * V,
            "products backward (input and weight grads)": 2 * L * proj(n),
            # the checkpoint stops once its last saved tensor is back: the
            # MLP's down projection is not run again
            "remat recompute": L * (proj(n) - 2 * n * ff * d + k5),
            # attention_blocks over S x T (scores, P V) and its VJP's four
            # products
            "plain VJP recompute": L * (2 + 4) * 2 * B * H * S * S * hd,
        })
    return terms


@pytest.mark.parametrize("kind", list(SMALL))
def test_dense_flops_equal_the_analytic_count(kind):
    cfg = dataclasses.replace(ARCHS["llama3.2-1b"].reduced(), remat=True)
    B, S = SMALL[kind]
    _, rec = dryrun.lower_cell("llama3.2-1b", None, cfg_override=cfg,
                               mesh=make_production_mesh(shape=(1, 1)),
                               shape_override=ShapeConfig("t", S, B, kind))
    want = sum(_dense_flops(cfg, kind, B, S).values())
    assert abs(rec["flops"] - want) <= 1e-9 * want, (rec["flops"], want)
    assert rec["flops_per_device"] == rec["flops"]
    assert rec["model_flops_ratio"] == rec["model_flops"] / rec["flops"]


# ---------------------------------------------------------- the meta branches

def test_kernel_meta_branches_count_and_launch_nothing():
    FA.reset_launch_counts()
    WK.reset_launch_counts()
    m = torch.device("meta")
    q = torch.empty(2, 40, 8, 96, dtype=torch.bfloat16, device=m)
    k = torch.empty(2, 40, 8, 96, dtype=torch.bfloat16, device=m)
    v = torch.empty(2, 40, 8, 64, dtype=torch.bfloat16, device=m)
    o = FA.flash_attention(q, k, v, causal=True)
    assert o.shape == (2, 40, 8, 64) and o.dtype == torch.bfloat16 \
        and o.device == m
    r = torch.empty(1, 33, 4, 16, device=m)
    y = WK.wkv6(r, r, r, r, torch.empty(4, 16, device=m))
    assert y.shape == r.shape and y.device == m
    assert FA.meta_calls == {"flash_attention": 1} and \
        WK.meta_calls == {"wkv6": 1}
    assert FA.meta_work == dict(zip(("bytes", "flops"),
                                    FA.work(2, 40, 8, 8, 96, dv=64)))
    assert WK.meta_work == dict(zip(("bytes", "flops"), WK.work(1, 33, 4, 16)))
    assert not any(FA.launches.values()) and not any(WK.launches.values())
    # the training entries: forward counted, backward the plain VJP
    leaves = [t.requires_grad_() for t in (q, k, v)]
    g = torch.autograd.grad(FA.flash_attention_train(*leaves).sum(), leaves)
    assert [t.shape for t in g] == [q.shape, k.shape, v.shape]
    assert FA.meta_calls["flash_attention"] == 2 and \
        FA.recomputes["flash_attention_vjp"] == 1
    FA.reset_launch_counts()
    WK.reset_launch_counts()
    assert not FA.meta_reads and not any(FA.meta_work.values())


def test_trace_counts_live_storages_once():
    """Views share their storage; a freed storage leaves the live set."""
    m = torch.device("meta")
    root = torch.empty(250, device=m)           # 1000 bytes
    with dryrun._Trace([root]) as tr:
        a = torch.empty(1000, device=m) * 2     # the empty and the product
        assert (tr.peak, tr.cur) == (1000 + 4000 + 4000, 1000 + 4000)
        b = a[10:].view(-1, 10)                 # a view: nothing new
        del a
        c = b + 1
        assert tr.cur == 1000 + 4000 + 3960
        del b                                   # a's storage with its view
        assert tr.cur == 1000 + 3960
        del c
        d = torch.empty(100, device=m)
    assert tr.peak == 9000 and tr.cur == 1000 + 400
    del d
    assert tr.cur == 1000


def test_trace_reads_no_input_of_a_bare_allocation():
    """A tensor that only feeds ``empty_like`` / ``new_empty`` is not
    read (XLA drops such an argument); one that an op computes with is."""
    m = torch.device("meta")
    x, y, z = (torch.empty(8, device=m) for _ in range(3))
    with dryrun._Trace([x, y, z]) as tr:
        torch.empty_like(x)
        y.new_empty(4)
        z + 1
    assert tr.read == {dryrun._key(z)}
    assert tr.traffic == 2 * 8 * 4


def test_chip_smoke_bounds_unchanged():
    """The card check's bounds, now from the kernels' ``work`` and
    ``launch.mesh``'s peaks, to the last digit of their former values."""
    assert chip_smoke.fa_bound(1, 4096, 32, 8, 64) == \
        (0.06950076233771486, "operations", 41943040, 68736253952)
    assert chip_smoke.fa_bound(1, 4096, 40, 40, 96, dv=64) == \
        (0.10859494115267947, "operations", 104857600, 107400396800)
    assert chip_smoke.fa_bound(1, 4096, 16, 16, 64, T=1024,
                               causal=False) == \
        (0.017370949629929223, "operations", 20971520, 17179869184)
    assert chip_smoke.fa_bound(4, 1, 16, 16, 64, T=8, causal=False,
                               nbytes_el=4) == \
        (8.80334328358209e-05, "bytes", 294912, 131072)
    assert chip_smoke.wkv_bound(1, 4096, 40, 64) == \
        (0.06260460895522388, "bytes", 209725440, 2684354560)
    assert chip_smoke.bound(4, 512, 2, 24, 4, 1, None) == \
        (0.0005384711641791044, "operations")
    assert chip_smoke.train_bound(4, 1120, 2, 24, 4, 1, 2,
                                  "pinn_mlp_bwd2") == \
        (0.0026339438805970147, "bytes", 8823712, 157839360)


# ------------------------------------------------------------------ full size

class _NoLargeCpuTensor(TorchDispatchMode):
    def __init__(self, limit):
        super().__init__()
        self.limit, self.largest = limit, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                self.largest = max(self.largest, t.numel() * t.element_size())
        return out


def test_full_size_cell_allocates_nothing_real():
    t0 = time.perf_counter()
    with _NoLargeCpuTensor(2 ** 20) as guard:
        _, rec = dryrun.lower_cell("llama3.2-1b", "prefill_32k")
    seconds = time.perf_counter() - t0
    assert guard.largest <= 2 ** 20, guard.largest
    assert seconds < 10, seconds
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["kernel_calls"] == {"flash_attention": 16, "wkv6": 0}
    # 32 x 32768 x 128256 bf16 logits alone: 269 GB on the meta device
    assert rec["peak_bytes"] > 2.6e11


def test_cli_writes_the_record(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "prefill_32k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[dryrun] llama3.2-1b__prefill_32k__16x16: OK" in res.stdout
    with open(tmp_path / "llama3.2-1b__prefill_32k__16x16.json") as f:
        rec = json.load(f)
    assert set(rec) == KEYS and rec["ok"]
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "dominant"}


# ------------------------------------------------ the slice as a whole

@pytest.mark.parametrize("shape", SLICE_SHAPES)
@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_records_equal_the_reference_lower_cell(ref_records, arch, shape):
    _, rec = dryrun.lower_cell(arch, shape,
                               cfg_override=ARCHS[arch].reduced(), mesh=MESH)
    want = ref_records(arch, shape)
    for k in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert rec["memory"][k] == want["memory"][k], k
    for k in ("param_count", "active_param_count", "model_flops"):
        assert rec[k] == want[k], k
    assert rec["mesh"] == want["mesh"] == "2x4"
    assert rec["n_devices"] == want["n_devices"] == 8
    assert set(rec) == KEYS and rec["ok"]
    assert rec["flops"] > 0 and rec["bytes"] > 0 and rec["peak_bytes"] > 0
    assert rec["flops_per_device"] == rec["flops"] / 8


@pytest.mark.parametrize("arch", ["llama3.2-1b", "seamless-m4t-large-v2"])
def test_train_step_leaves_no_tensor_in_reference_cycles(arch):
    """A step frees its tensors by reference counting: none waits for the
    cyclic collector (``core.nets.tree_unflatten``'s recursive closure
    once held the step's gradients in a cycle, one float32 copy of the
    params above the dry run's peak on the card)."""
    import gc

    from repro_torch.launch import train
    from repro_torch.models import make_batch
    from repro_torch.optim.adam import init_adam

    cfg = dataclasses.replace(ARCHS[arch].reduced(), remat=True)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    opt = init_adam(params)
    batch = make_batch(cfg, ShapeConfig("t", 64, 2, "train"), "train")
    # the first step pays one-time costs (torch's own caches); the next
    # is a steady one
    params, opt, _, _ = train.lm_train_step(model, params, opt, batch, 0,
                                            1e-4, 10)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        params, opt, _, _ = train.lm_train_step(model, params, opt, batch, 1,
                                                1e-4, 10)
        gc.collect()
        held = [x for x in gc.garbage if isinstance(x, torch.Tensor)]
    finally:
        gc.garbage.clear()
        gc.set_debug(0)
        gc.enable()
    assert not held, [tuple(t.shape) for t in held]


# ------------------------------------------------ the partitioned dry run

BAND_CELLS = [(a, s) for a in ("llama3.2-1b", "deepseek-moe-16b")
              for s in ("train_4k", "prefill_32k")] + \
    [(a, "decode_32k") for a in SLICE_ARCHS]


@pytest.mark.parametrize("arch,shape", BAND_CELLS,
                         ids=[f"{a}-{s}" for a, s in BAND_CELLS])
def test_partitioned_collective_bytes_near_the_reference(ref_records, arch,
                                                         shape):
    """Rank 0's collective operand bytes against the reference's
    partitioned HLO on the same (2, 4) mesh, within [0.5x, 2x]: DTensor
    issues one collective a redistribution in bf16 where XLA on the CPU
    combines them and all-reduces the bf16 products' sums in float32.
    The counts are not compared.  A decode attends over its
    sequence-split cache by a split softmax: no collective of it is as
    large as one layer's float32 scores on a device (a gathered score
    tensor, or the cross cache moved to the heads' split).  All 21 cells
    stand in ``PERF.md`` §7."""
    cfg = ARCHS[arch].reduced()
    _, rec = dryrun.lower_cell(arch, shape, cfg_override=cfg, mesh=MESH,
                               partitioned=True)
    got = rec["collectives"]["total_bytes"]
    want = ref_records(arch, shape)["collectives"]["total_bytes"]
    assert 0.5 * want <= got <= 2 * want, (got, want)
    if shape == "decode_32k":
        sh = SHAPES[shape]
        scores = sh.global_batch // 2 * cfg.n_heads * sh.seq_len // 4 * 4
        assert max(c["bytes"] for c in rec["top_collectives"]) < scores
        assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                               "collective_s")
    assert set(rec) >= KEYS | {"collectives", "collectives_by_group",
                               "top_collectives", "peak_bytes_per_device",
                               "hlo_ops"}
    assert "collective_s" in rec["roofline"]


@pytest.mark.parametrize("option", list(OPTIONS))
def test_options_give_the_reference_s_argument_bytes(ref_records, option):
    """``bf16_params`` and ``extra_rules`` on the dense prefill: the
    argument and output bytes per device are the reference's, and the
    option moves them."""
    arch = SLICE_ARCHS[0]
    kw = OPTIONS[option]
    _, base = dryrun.lower_cell(arch, "prefill_32k",
                                cfg_override=ARCHS[arch].reduced(), mesh=MESH)
    _, rec = dryrun.lower_cell(arch, "prefill_32k",
                               cfg_override=ARCHS[arch].reduced(), mesh=MESH,
                               **kw)
    want = ref_records(arch, option)["memory"]
    for k in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert rec["memory"][k] == want[k], k
    assert rec["memory"]["argument_size_in_bytes"] != \
        base["memory"]["argument_size_in_bytes"]
