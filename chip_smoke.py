#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]
    python3 chip_smoke.py --ab DIR   # K3/K4 against DIR's sources, in turns
    python3 chip_smoke.py --only distributed   # build + phase 7 only
    python3 chip_smoke.py --only scenarios     # build + phase 8 only

Run from the root of a checkout.  With ``--ab DIR`` only the build and an
A/B runs: this checkout's K3 and K4 and the ones built from
``DIR/pinn_mlp_fwd.cu`` / ``DIR/pinn_mlp_bwd.cu`` (another revision, e.g.
``git show HEAD~1:src/repro_torch/csrc/pinn_mlp_fwd.cu``), each held
against the plain versions, timed in turns (other, this, this, other) at
the training shapes of phase 3.  Otherwise, phases in order; a failure in
any of them ends the run with a non-zero exit code and no result line:

1. **build** — compile every CUDA source under ``src/repro_torch/csrc/``
   (one ``nvcc`` per source, all started together) and print the seconds,
   the registers and spill bytes of every K1-K4 instantiation (none may
   spill), and per kernel the count of
   ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in the built
   library's SASS (``cuobjdump -sass``): the bf16 K5 kernel must hold
   ``HGMMA``, and ``UTMALDG`` in its TMA instantiations;
2. **kernels** — hold each forward kernel (K1/K2) against its plain PyTorch
   version on the card (float32, rtol = atol = 1e-5) over activations
   tanh/sin/cos, d_in 1-3, widths 20/24/40/80/128 at depths 2-5, d2
   directions all / a strict subset / none, n_sub 1 and 4, ragged point
   counts; then the training kernels: K3 (outputs and every spill, same
   tolerance) and K4 (per-leaf error scaled by max(1, max |want|) <= 1e-5,
   the reference's rule) over widths 20/24/80/128 at depths 1/4/3/5, then
   the edges of K4's partition (m = 1, a tile less one, a tile, a tile and
   one, 1120; widths 24/36/100; n_sub 1, 4 and 9, some with blocks owning
   unequal numbers of tiles), then the scenarios' shapes (the cavity's
   d_in = 2, n_out = 3 at 40 x 5 and 80 x 5 with d2 all or none; the
   us_map's ten subdomains at the rows of its example and paper
   megabatches), with K4 launched twice and held bitwise
   equal, and ``torch.autograd.grad`` through ``ops.pinn_mlp_forward2`` on
   the card against the CPU;
3. **timing** — each kernel (CUDA graph of back-to-back launches), its
   wrapper call and its plain version with CUDA events beside the shape's
   bound: K1/K2 at the serving shapes (n_sub=4, m = 64/512/4096 points per
   subdomain) and a dense grid (m = 262,144); K3/K4 at the quickstart's
   training megabatch (n_sub=4, m = 1120) at width 24 x 4 and 80 x 5;
4. **serve** — export the 2x2 space-time Burgers XPINN bundle
   (``MLPConfig(2, 1, 24, 4)``, weights from a seed) and serve it with
   ``repro_torch.launch.serve_field.main`` at ``--order 2`` and
   ``--order 1``, the kernels' launch counts set to 0 just before each run
   and read just after; then evaluate one fixed cloud (inside, interface and
   outside points) through the engine and hold it against the plain
   recurrence on the card;
5. **train** — ``repro_torch.launch.quickstart.main`` trains the same
   XPINN on the card for 1500 steps (chunks of 250), counts set to 0 just
   before and read just after: it must reach rel-L2 < 0.5 against
   Cole-Hopf with one K3 and one K4 launch per loss evaluation and no plain
   version run on a CUDA tensor; then 10 steps from one init on the card
   and on the CPU are held together, the ms per training step is taken over
   three chunks of 100 steps and split into forward kernel, backward kernel
   and everything else, and torch.profiler traces 20 steady steps: device
   busy ms, idle share, K3's and K4's device ms;
6. **runtime** — the fault-tolerant runtime (``repro_torch.runtime``) on
   the card, each run with the counts set to 0 just before and read just
   after: (a) ``quickstart.main(... --supervised --inject
   crash@1,nan_params@2:0,straggler@3*0.1)``, 1500 steps in chunks of 250,
   must report 1 crash, 1 guard trip, 2 restarts and 1 straggler, reach
   rel-L2 < 0.5, and launch K3 and K4 once per step of every chunk attempt
   (committed chunks plus rollbacks, each a whole chunk: the guarded chunk
   keeps computing frozen steps after a trip) with no plain version on a
   CUDA tensor; (b) a supervised 3 x 100-step run with a crash after chunk
   1 equals three uninterrupted chunks exactly (params and Adam moments,
   difference 0.0); (c) (a)'s checkpoint resumed at nx = 3 (4 -> 6
   subdomains) is a better start than a cold init, and 500 more supervised
   steps reach rel-L2 < 0.5; (d) ``serve_field.main --demo cart
   --max-requests 40 --faults engine-raise@3,nan-output@5,
   slow-engine@7*0.05`` at order 2 (K2) and order 1 (K1) answers every
   admitted ticket.  One ``{"runtime": ...}`` line;
7. **distributed** — Algorithm 1 with one rank per subdomain: 4 ``gloo``
   ranks (``repro_torch.launch.mesh``) share the card, each launch count
   set to 0 just before and read just after each step on every rank, the
   ranks' counts sent back to this process: (a) the quickstart problem
   for 10 steps from one init, gathered, within 1e-5 (params) and 1e-4
   relative (summed loss) of ``ReferenceTrainer`` on the card; (b) 1500
   steps in chunks of 250 to rel-L2 < 0.5 (``evaluate_l2`` on rank 0,
   K1) with exactly 1500 K3 and 1500 K4 launches per rank and no plain
   version on a CUDA tensor, then chunks of 100 steps with the exchange
   on and off in turns (on, off, off, on: ms per step, compute and
   communication), the bytes staged through the host per step, the
   ``dd-comp-forward`` / ``dd-comm-halo`` / ``dd-comp-update`` scopes of
   20 steps under torch.profiler on rank 0, and the single-process
   trainer's ms per step after the group; (c) ``DataParallelTrainer`` on
   4 workers, no compression, int8 and top-k 5 %, 30 steps each: the loss
   falls, params stay bitwise replicated, the error-feedback slices differ
   across workers, one K3 and one K4 per step; (d) a supervised 3 x 100
   step run with a crash after chunk 1 equals three uninterrupted chunks
   exactly (params and moments, 0.0), ``nan_params`` on subdomain 0
   trips the guard on every rank by consensus (``ok_sub[0]`` False,
   ``ok_sub[3]`` True, 1 good step), and the run's checkpoint resumes in
   ``ReferenceTrainer`` bitwise; (e) ``python -m repro_torch.launch.train
   pinn --distributed --nx 2 --nt 2 --steps 20`` exits 0.  One
   ``{"distributed": ...}`` line;
8. **scenarios** — the paper's remaining PINN scenarios, each run with
   the launch counts set to 0 just before and read just after: (a)
   ``launch.inverse_heat_map.main --export DIR --serve-demo`` at the
   example's defaults (Table-3 activations, jvp path, 2000 steps) must
   reach rel-L2(T,K) <= 0.0147 and a served K field rel-L2 <= 0.0114 with
   no K1-K4 launch; (b) the same problem at the paper's size (3 x 80 per
   net, Table 3's unscaled counts), 500 steps, timed; (c) the us_map with
   one shared tanh on the fused path at 3 x 80: 10 steps on the card
   against 10 on the CPU from one init (params 1e-5, summed loss 1e-4
   relative), then 2000 steps with exactly 2 K3 + 2 K4 a step and its
   rel-L2 through K1; (d) ``launch.navier_stokes_cavity.main`` at its
   defaults (jvp, 40 x 5, 4000 steps) must reach a Ghia centerline RMS
   <= 0.117; (e) the cavity at 80 x 5 on the fused path: 10 steps against
   the jvp path on the card (same bounds), the jvp step eager and both
   paths in turns (fused, jvp, jvp, fused; chunks of 100), then 4000 steps
   with exactly one K3 + one K4 a step; (f) vanilla Burgers
   (``MLPConfig(2, 1, 20, 3)``, 512 + 64 points): 300 Adam steps, then 60
   L-BFGS iterations, monotone and below 0.9 x the Adam loss, gradients
   through K3/K4 (two a step) and the 14 probes a step through K2.  No
   plain version may run on a CUDA tensor.  One ``{"scenarios": ...}``
   line;
9. **lm kernels** — hold K5 (flash attention) against its plain version on
   the card: float32 (rtol = atol = 2e-5, the CUDA-core kernel) and bf16
   (both outputs bf16, rtol = atol = 1e-2, the tensor-core kernel: by TMA
   at head dims 64 and 128, by element loads at 100), heads H/Hk 32/8,
   8/8, 4/1, head dims 64, 128, 100, S = T in {1, 37, 64, 130, 200, 333,
   2048}, and S != T causal (top-left) and not causal, each in the model's
   (B, S, H, dh) layout and as (B, H, S, dh) storage, every case counted on
   the device kernel of its dtype; and K6 (WKV6: a chunk, a scan and an
   output kernel) against its plain version (rtol = atol = 2e-4, the
   reference's bound): P 16, 64, 128, T in {1, 5, 17, 31, 33, 256, 1000}
   (B = 2) and T = 99 at B = 3, w from U(0.2, 0.98), a strong decay
   w = 0.05 and a near-1 decay w ~ exp(-e^-6) (the init's decay_bias);
10. **lm timing** — K5 at llama3.2-1b's per-layer prefill shape (B = 1,
   H = 32, Hk = 8, dh = 64, bf16, causal) at S = T = 4096 and 32768, beside
   its plain version and PyTorch's ``scaled_dot_product_attention`` on the
   same tensors (timed only; the port never calls it); K6 at rwkv6-3b's
   per-layer shape (B = 1, T = 4096, H = 40, P = 64, float32) beside its
   plain version;
11. **llm** — llama3.2-1b and rwkv6-3b at their published width and depth,
   weights drawn from a seed on the card: prefill (B = 2, S = 1024 /
   B = 1, T = 1024) through the kernels with the launch counts set to 0 just
   before and read just after (exactly n_layers K5 or K6 wrapper calls,
   each on its device kernels: the bf16 K5 kernel, or K6's chunk, scan
   and output kernels; no plain version on a CUDA tensor), a profiler
   trace of it (the device kernels' share found by their names), the same
   prefill through the plain versions in bf16 (difference printed) and in
   a float32 copy of the config (held at LLM_F32_TOL of max |logit|; for
   llama through the float32 K5 kernel, one launch per layer), and 16 decode
   steps held against the float32 prefill (2e-3 of max |logit|, the
   reference's bound);
12. **llm serve** — ``repro_torch.launch.serve.main`` serves each of them at
   full size (``--no-reduced --batch 4 --prompt-len 16 --gen 16``), twice
   (the first run pays the card's first-use costs): a (4, 32) token array,
   its tokens/s printed;
13. **report** — one ``{"kernels": [...]}`` line (K1-K6), the card's name
   and power limit from ``nvidia-smi``, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Each phase prints its seconds.

The bound of a shape is the larger of its bytes (inputs read once, outputs
written once; for K3 the spills are outputs, for K4 inputs) over 3.35 TB/s
and its operations over the card's rate for their type: K1-K4 their
matrix-product FLOPs (two per multiply-add, pruned second-order streams not
counted; K4 does two products per stream and layer), K6 the recurrence's
4 P^2 FLOP per step and head, over 67 TFLOP/s, the H100 SXM's float32 rate
outside the tensor cores; K5 its 4 dh FLOP per visible (query, key) pair
and head over 989 TFLOP/s, the bf16 tensor-core rate, since it takes and
returns bf16 at the timed shape.

The script imports nothing of the JAX package.  Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

SEED = 0
TOL = 1e-5               # rtol and atol, float32 kernel vs float32 plain
FP32_FLOPS = 67e12       # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12      # H100 SXM, bf16 tensor cores, dense
HBM_BYTES = 3.35e12      # H100 SXM, bytes/s
SOURCES = {"pinn_mlp_fwd1": "src/repro_torch/csrc/pinn_mlp_fwd.cu",
           "pinn_mlp_fwd2": "src/repro_torch/csrc/pinn_mlp_fwd.cu",
           "pinn_mlp_fwd2_res": "src/repro_torch/csrc/pinn_mlp_fwd.cu",
           "pinn_mlp_bwd2": "src/repro_torch/csrc/pinn_mlp_bwd.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention_sm90.cu",
           "wkv6": "src/repro_torch/csrc/wkv6.cu"}
# device kernels behind the K5 / K6 wrappers (launch counters, and the
# names by which the profiler split finds them)
DEVICE_KERNELS = {"flash_attention_sm90": "flash_fwd_sm90_kernel",
                  "flash_attention_f32": "flash_fwd_kernel",
                  "wkv6_chunk": "wkv6_chunk_kernel",
                  "wkv6_scan": "wkv6_scan_kernel",
                  "wkv6_out": "wkv6_out_kernel"}
# device kernels of a training step (the profiler split of the train phase)
TRAIN_KERNELS = {"k3": "pinn_mlp_fwd_kernel", "k4": "pinn_mlp_bwd_kernel",
                 "k4_reduce": "pinn_mlp_bwd_reduce"}
# the trainers' record_function scopes (the reference's named scopes)
SCOPES = ("dd-comp-forward", "dd-comm-halo", "dd-comp-update")
REPLACES = {"pinn_mlp_fwd1": "src/repro/kernels/pinn_mlp.py:82",
            "pinn_mlp_fwd2": "src/repro/kernels/pinn_mlp.py:148",
            "pinn_mlp_fwd2_res": "src/repro/kernels/pinn_mlp.py:166",
            "pinn_mlp_bwd2": "src/repro/kernels/pinn_mlp.py:184",
            "flash_attention": "src/repro/kernels/flash_attention.py:31",
            "wkv6": "src/repro/kernels/wkv6.py:27"}
# K5 against its plain version: float32 at 2e-5 (the sums run in another
# order); bf16 with both outputs rounded to bf16 at 1e-2 (values that agree
# to float32 precision may round to neighbouring bf16 numbers, 2^-8
# relative).  K6 at 2e-4, the reference's own bound for its WKV6 kernel
# (tests/test_kernels_wkv6.py): exponentials and cumulative sums of log w
# run in another order.
FA_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
WKV_TOL = 2e-4
# full-size prefill, kernels against plain versions on the card in a
# float32 copy of the config, relative to max |logit|: 16 or 32 layers of
# float32 sums in another order (the reduced models agree with the JAX
# package to 4e-7 on the CPU)
LLM_F32_TOL = 1e-4
DECODE_TOL = 2e-3        # decode vs prefill, the reference's bound
LLM = {"llama3.2-1b": (2, 1024), "rwkv6-3b": (1, 1024)}   # prefill (B, S)
# the serving path's shape (width, depth, points per subdomain): the served
# Burgers net at a serving batch; timing() runs it with n_sub=4, d_in=2
MAIN = (24, 4, 512)
# 10-step trajectory, card (kernels) against the CPU (plain versions): the
# loss terms within TRAJ_RTOL (relative), the params within TRAJ_ATOL.
# Adam's first step moves every parameter by lr * sign(gradient) whatever
# the gradient's size, so a component whose gradient sat at rounding level
# could differ by 2 * lr = 4e-3 after one step; 1e-5 says no component took
# a different direction, and the rest differs by float32 rounding only.
TRAJ_RTOL = 1e-4
TRAJ_ATOL = 1e-5


RECORD: list = []   # every result line of this run, for --out


def emit(obj: dict) -> None:
    """Print one result line and keep it for ``--out``."""
    RECORD.append(obj)
    print(json.dumps(obj))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# --------------------------------------------------------------------- build

def build_phase() -> None:
    from repro_torch.kernels import native

    t0 = time.perf_counter()
    info = native.build()
    secs = time.perf_counter() - t0
    check(set(info) == {p.stem for p in native.sources()},
          f"built {sorted(info)}")
    logs = "".join(v["log"] for v in info.values())
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", logs)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", logs)]
    emit({"build_s": round(secs, 2),
                      "sources": {k: round(v["seconds"], 2)
                                  for k, v in info.items()},
                      "instantiations": len(regs),
                      "registers_max": max(regs, default=None),
                      "spill_bytes_max": max(spills, default=None)})
    train = {stem: _ptxas_report(info[stem]["log"])
             for stem in ("pinn_mlp_fwd", "pinn_mlp_bwd")}
    check(all(train.values()), "no ptxas report for the K1-K4 libraries")
    for stem, rows in train.items():
        for kern, nreg, spill in rows:
            print(f"ptxas {stem}: {kern} registers {nreg} spill bytes "
                  f"{spill}")
    emit({"ptxas_k1_k4": {stem: {
        "instantiations": len(rows),
        "registers": [min(r[1] for r in rows), max(r[1] for r in rows)],
        "spill_bytes_max": max(r[2] for r in rows)}
        for stem, rows in train.items()}})
    check(all(r[2] == 0 for rows in train.values() for r in rows),
          "a K1-K4 instantiation spills registers")
    sass = _sass_counts(info)
    emit({"sass": sass})
    sm90 = {k: v for k, v in sass.items() if "flash_fwd_sm90_kernel" in k}
    check(len(sm90) == 4 and all(v["HGMMA"] > 0 for v in sm90.values()),
          f"bf16 K5 kernel without wgmma: {sm90}")
    # the TMA instantiations (template flag true) load by TMA, the others not
    tma = lambda k: re.search(r"(true|\(bool\)1)>$", k) is not None
    check(sum(map(tma, sm90)) == 2 and
          all((v["UTMALDG"] > 0) == tma(k) for k, v in sm90.items()),
          f"bf16 K5 TMA instantiations without TMA loads: {sm90}")


def _ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes) of every entry function in a
    ``-Xptxas -v`` log, the kernel's name demangled without its argument
    list."""
    rows = []
    for ent in re.split(r"Compiling entry function '", log)[1:]:
        regs = re.search(r"Used (\d+) registers", ent)
        spill = re.search(r"(\d+) bytes spill stores", ent)
        rows.append([ent.split("'", 1)[0], int(regs.group(1)),
                     int(spill.group(1))])
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    names = subprocess.run([os.path.join(cuda, "bin", "cu++filt")],
                           input="\n".join(r[0] for r in rows),
                           capture_output=True, text=True, check=True,
                           timeout=60).stdout.splitlines()
    check(len(names) == len(rows), f"cu++filt gave {len(names)} names")
    return [(_without_args(n), r[1], r[2]) for n, r in zip(names, rows)
            if "pinn_mlp" in n]


def _sass_counts(info) -> dict:
    """Each kernel of the built libraries: its count of HGMMA (wgmma) and
    UTMALDG (TMA load) instructions in the SASS."""
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    procs = {}   # all at once, each into a file of its own
    for stem, lib in sorted(info.items()):
        out = tempfile.TemporaryFile("w+")
        procs[stem] = (out, subprocess.Popen(
            [os.path.join(cuda, "bin", "cuobjdump"), "-sass", lib["path"]],
            stdout=out, text=True))
    counts = {}
    for stem, (out, proc) in procs.items():
        check(proc.wait(timeout=300) == 0, f"cuobjdump -sass failed on {stem}")
        out.seek(0)
        sass = out.read()
        out.close()
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                counts[fn] = {"library": stem, "HGMMA": 0, "UTMALDG": 0}
            elif fn is not None:
                for op in ("HGMMA", "UTMALDG"):
                    counts[fn][op] += op in line
    names = subprocess.run([os.path.join(cuda, "bin", "cu++filt")],
                           input="\n".join(counts), capture_output=True,
                           text=True, check=True, timeout=60).stdout
    names = [_without_args(n) for n in names.splitlines()]
    check(len(names) == len(counts) == len(set(names)),
          f"cu++filt output {names}")
    return dict(zip(names, counts.values()))


def _without_args(name: str) -> str:
    """A demangled kernel name without ``void``, the anonymous namespace
    and its argument list, keeping its template arguments (which cu++filt
    may print as ``(int)64, (bool)1``)."""
    name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::", "",
                  name.strip())
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if name.endswith(")") else name
    return name


# ------------------------------------------------------------------- kernels

def _net(gen, n_sub, n, d_in, width, depth, n_out, dev):
    """Seeded random inputs and packed weight stacks on the card."""
    import torch
    from repro_torch.kernels import ops

    dims = [d_in] + [width] * depth + [n_out]
    Ws = [torch.randn((n_sub, a, b), generator=gen) * (2.0 / (a + b)) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn((n_sub, b), generator=gen) for b in dims[1:]]
    a = 0.9 + 0.2 * torch.rand((n_sub, depth), generator=gen)
    x = 2.0 * torch.rand((n_sub, n, d_in), generator=gen) - 1.0
    w, b, av = ops.pack_mlp(Ws, bs, a)
    return [t.to(dev).contiguous() for t in (x, w, b, av)]


def _run(kernel: bool, args, n_out, act, d2):
    from repro_torch.kernels import pinn_mlp as K

    if d2 == ():
        fn = K.pinn_mlp_fwd1 if kernel else K.pinn_mlp_fwd1_plain
        return fn(*args, n_out=n_out, act=act)
    fn = K.pinn_mlp_fwd2 if kernel else K.pinn_mlp_fwd2_plain
    return fn(*args, n_out=n_out, act=act, d2_dirs=d2)


def _compare(got, want, d_in, d2) -> tuple[float, float]:
    import torch

    abs_err = rel_err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != "
                                  f"{tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), "non-finite kernel output")
        diff = (g - w).abs()
        check(bool((diff <= TOL + TOL * w.abs()).all()),
              f"kernel disagrees: max abs {float(diff.max()):.3e}")
        abs_err = max(abs_err, float(diff.max()))
        rel_err = max(rel_err, float((diff / (w.abs() + TOL)).max()))
    if d2 not in (None, ()):   # pruned second-derivative rows: exact zeros
        for j in range(d_in):
            if j not in d2:
                check(not bool(got[2][:, j].any()), f"d2u row {j} not zero")
    return abs_err, rel_err


def sweep(dev) -> dict:
    import torch

    gen = torch.Generator().manual_seed(SEED)
    worst = {"pinn_mlp_fwd1": 0.0, "pinn_mlp_fwd2": 0.0}
    subsets = {1: (None, ()), 2: (None, (1,), ()), 3: (None, (0, 2), ())}
    n_cases = 0
    for act in ("tanh", "sin", "cos"):
        for d_in in (1, 2, 3):
            n_out = 1 if d_in == 2 else 3
            for width, depth in ((20, 2), (24, 4), (40, 3), (80, 5),
                                 (128, 5)):
                sizes = [(1, 1013), (4, 517)]
                if width == 24:
                    sizes += [(4, 5), (4, 64)]
                for d2 in subsets[d_in]:
                    for n_sub, n in sizes:
                        args = _net(gen, n_sub, n, d_in, width, depth,
                                    n_out, dev)
                        got = _run(True, args, n_out, act, d2)
                        want = _run(False, args, n_out, act, d2)
                        torch.cuda.synchronize()
                        ae, re_ = _compare(got, want, d_in, d2)
                        name = "pinn_mlp_fwd1" if d2 == () else \
                            "pinn_mlp_fwd2"
                        worst[name] = max(worst[name], ae)
                        n_cases += 1
                        print(f"{name[-4:]} {act:4s} d{d_in} w{width}x"
                              f"{depth} d2={'all' if d2 is None else d2} "
                              f"{n_sub}x{n} abs {ae:.1e} rel {re_:.1e}")
    emit({"sweep_cases": n_cases, "tol": TOL,
                      "max_abs_err": dict(worst)})
    return worst


def bound(n_sub, m, d_in, width, depth, n_out, d2) -> tuple[float, str]:
    """Least time (ms) for the work of one call, and what bounds it."""
    dims = [d_in] + [width] * depth + [n_out]
    order2 = d2 != ()
    streams = 1 + d_in + (0 if not order2 else
                          d_in if d2 is None else len(d2))
    flops = 2 * d_in * width          # input layer: h (tangents are rows)
    for a, b in zip(dims[1:-1], dims[2:]):
        flops += streams * 2 * a * b
    flops *= n_sub * m
    n_params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:])) + depth
    rows_out = 1 + d_in + (d_in if order2 else 0)
    nbytes = 4 * n_sub * (m * d_in + n_params + m * n_out * rows_out)
    t_bytes, t_ops = nbytes / HBM_BYTES, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def _events_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device time per launch: ``reps`` launches captured in one CUDA graph
    and replayed, so host launch cost is out of the measurement."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    g.replay()
    e.record()
    e.synchronize()
    del g
    return s.elapsed_time(e) / reps


def timing(dev) -> dict:
    import torch

    gen = torch.Generator().manual_seed(SEED + 1)
    out = {}
    shapes = [(24, 4, m) for m in (64, 512, 4096, 262144)]
    shapes += [(w, 5, m) for w in (80, 128) for m in (4096, 262144)]
    for width, depth, m in shapes:
        d_in, n_out, act, n_sub = 2, 1, "tanh", 4
        args = _net(gen, n_sub, m, d_in, width, depth, n_out, dev)
        dense = m > 100_000
        for name, d2 in (("pinn_mlp_fwd1", ()), ("pinn_mlp_fwd2", (0,))):
            kern = lambda: _run(True, args, n_out, act, d2)
            plain = lambda: _run(False, args, n_out, act, d2)
            bms, by = bound(n_sub, m, d_in, width, depth, n_out, d2)
            row = {"kernel": name, "shape": f"n_sub={n_sub} m={m} "
                   f"w{width}x{depth} d_in={d_in} d2={list(d2)}",
                   "ms": _graph_ms(kern, 20 if dense else 200),
                   "call_ms": _events_ms(kern, 20 if dense else 200),
                   "plain_ms": _events_ms(plain, 3 if dense else 50),
                   "bound_ms": bms, "bound_by": by}
            out[(name, width, depth, m)] = row
            emit({"timing": row})
            torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- serve

def _plain_field(bundle, pts, order, dev) -> dict:
    """The stitched field from the plain recurrence, one subdomain at a time
    (independent of the engine's batching and stitching)."""
    import torch
    from repro_torch.core.nets import act_name, map_tree, params_from_numpy
    from repro_torch.kernels import ref
    from repro_torch.serve import routing

    pde, cfg = bundle.pde, bundle.model_cfg
    ((name, c),) = cfg.nets.items()
    params = params_from_numpy(bundle.params, dev)[name]
    mem = routing.membership_matrix(bundle.decomp, pts, tol=1e-9)
    d2 = pde.d2_dirs if order == 2 else ()
    sums = {}
    for q in range(bundle.n_sub):
        idx = np.nonzero(mem[q])[0]
        if len(idx) == 0:
            continue
        p = map_tree(lambda t: t[q], params)
        a = (c.slope_scale * p["a"] if c.adaptive
             else torch.full_like(p["a"], c.slope_scale))
        x = torch.tensor(pts[idx], dtype=torch.float32, device=dev)
        u, du, d2u = ref.pinn_mlp_ref2(x, p["W"], p["b"], a,
                                       act=act_name(bundle.act_codes[q]),
                                       d2_dirs=d2)
        vals = {"u": u, "grad_u": du.movedim(0, 1),
                "flux": pde.flux_from_derivs(x, u, du)}
        if order == 2:
            vals["residual"] = pde.residual_from_derivs(x, u, du, d2u)
        for k, v in vals.items():
            acc = sums.setdefault(k, np.zeros((len(pts),) + v.shape[1:]))
            acc[idx] += v.double().cpu().numpy()
    n = mem.sum(axis=0)
    return {k: np.where((n > 0).reshape((-1,) + (1,) * (v.ndim - 1)),
                        v / np.maximum(n, 1).reshape((-1,) + (1,) *
                                                     (v.ndim - 1)), np.nan)
            for k, v in sums.items()}


def serve_phase(dev) -> dict:
    from repro_torch.core import CartesianDecomposition
    from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig,
                                       stacked_init)
    from repro_torch.core.pdes import Burgers1D
    from repro_torch.kernels import pinn_mlp as K
    from repro_torch.launch import serve_field
    from repro_torch.serve import FieldEngine, export_bundle, load_bundle

    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    params, codes = stacked_init(cfg, dec.n_sub, SEED)
    launches = {k: 0 for k in K.launches}
    with tempfile.TemporaryDirectory() as tmp:
        bdir = os.path.join(tmp, "burgers_2x2")
        export_bundle(bdir, params, cfg, dec, act_codes=codes,
                      pde=Burgers1D())
        for order, kernel in ((2, "pinn_mlp_fwd2"), (1, "pinn_mlp_fwd1")):
            argv = ["--bundle", bdir, "--device", "cuda", "--max-requests",
                    "200", "--rate", "2000", "--order", str(order)]
            buf = io.StringIO()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = serve_field.main(argv)
            secs = time.perf_counter() - t0
            counts = dict(K.launches)
            report = json.loads(buf.getvalue())
            check(rc == 0, f"serve_field --order {order} exited {rc}")
            check(report["drained"]["unanswered"] == 0,
                  f"order {order}: unanswered tickets")
            check(report["goodput"] == 1.0,
                  f"order {order}: goodput {report['goodput']}")
            check(counts[kernel] > 0,
                  f"order {order}: {kernel} was never launched")
            for k in launches:
                launches[k] += counts[k]
            emit({"serve": {
                "order": order, "seconds": round(secs, 3),
                "requests": report["requests"],
                "by_status": report["by_status"],
                "goodput": report["goodput"],
                "degraded_frac": report["degraded_frac"],
                "p50_s": report["p50_s"], "p99_s": report["p99_s"],
                "dispatch_p50_s": report["latency"]["dispatch_s"]["p50"],
                "dispatches": report["latency"]["dispatch_s"]["count"],
                "launches": counts}})
        bundle = load_bundle(bdir)

    # one fixed cloud through the engine on the card
    eng = FieldEngine(bundle)
    check(eng.device.type == "cuda", f"engine on {eng.device}")
    rng = np.random.default_rng(SEED)
    inside = np.concatenate([dec.sample_interior(q, 300, rng)
                             for q in range(dec.n_sub)])
    iface = np.concatenate([
        np.stack([np.zeros(25), np.linspace(0.02, 0.98, 25)], axis=1),
        np.stack([np.linspace(-0.98, 0.98, 25), np.full(25, 0.5)], axis=1),
        [[0.0, 0.5]]])
    outside = np.array([[1.5, 0.5], [0.0, -0.2], [-3.0, 4.0]])
    pts = np.concatenate([inside, iface, outside])
    for order in (2, 1):
        got = eng.evaluate(pts, order=order)
        want = _plain_field(bundle, pts, order, eng.device)
        claims = eng.last_claims
        check(int((claims >= 2).sum()) == len(iface),
              f"interface claims {int((claims >= 2).sum())}")
        check(sorted(got) == sorted(want), f"keys {sorted(got)}")
        err = 0.0
        for k, v in got.items():
            inn, out = v[claims > 0], v[claims == 0]
            check(bool(np.isfinite(inn).all()), f"{k}: non-finite inside")
            check(bool(np.isnan(out).all()), f"{k}: outside not NaN")
            diff = np.abs(inn - want[k][claims > 0])
            check(bool((diff <= TOL + TOL * np.abs(want[k][claims > 0]))
                       .all()), f"order {order} {k}: max abs "
                                f"{float(diff.max()):.3e}")
            err = max(err, float(diff.max()))
        emit({"engine_vs_plain": {
            "order": order, "points": len(pts), "max_abs_err": err,
            "tol": TOL, "outside_nan": int((claims == 0).sum())}})
    return launches


# ------------------------------------------------------------------ training

def _leaf_err(got, want) -> float:
    """|got - want| / max(1, max |want|): the reference's per-leaf scaled
    error for the reverse sweep (tests/test_kernels_pinn_mlp.py:330-335)."""
    if want.numel() == 0:
        return 0.0
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def _run_train(kernel: bool, args, n_out, act, d2, cts):
    """K3 then K4 (or their plain versions) on the same inputs."""
    from repro_torch.kernels import pinn_mlp as K

    x, w, b, av = args
    fwd = K.pinn_mlp_fwd2_res if kernel else K.pinn_mlp_fwd2_res_plain
    bwd = K.pinn_mlp_bwd2 if kernel else K.pinn_mlp_bwd2_plain
    outs = fwd(x, w, b, av, n_out=n_out, act=act, d2_dirs=d2)
    return outs, bwd(x, w, av, outs[3], *cts, n_out=n_out, act=act,
                     d2_dirs=d2)


def _cotangents(gen, n_sub, n, d_in, n_out, dev):
    import torch

    return [torch.randn(s, generator=gen).to(dev) for s in
            ((n_sub, n, n_out), (n_sub, d_in, n, n_out),
             (n_sub, d_in, n, n_out))]


def train_sweep(dev) -> dict:
    """K3 against its plain version (outputs and every spill, rtol = atol =
    TOL) and K4 against its plain version on the same spills and random
    cotangents (per-leaf scaled error <= TOL), K4 launched twice and held
    bitwise; then the autograd boundary on the card against the CPU."""
    import torch
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(SEED + 2)
    worst = {"pinn_mlp_fwd2_res": 0.0, "pinn_mlp_bwd2": 0.0}
    scaled = 0.0
    subsets = {1: (None, ()), 2: (None, (0,), ()), 3: (None, (0, 2), ())}
    n_cases = 0

    def case(act, d_in, n_out, width, depth, d2, n_sub, n):
        nonlocal scaled, n_cases
        args = _net(gen, n_sub, n, d_in, width, depth, n_out, dev)
        cts = _cotangents(gen, n_sub, n, d_in, n_out, dev)
        got, gbar = _run_train(True, args, n_out, act, d2, cts)
        want, wbar = _run_train(False, args, n_out, act, d2, cts)
        again = _run_train(True, args, n_out, act, d2, cts)[1]
        torch.cuda.synchronize()
        ae, _ = _compare(got, want, d_in, d2)
        be = max(_leaf_err(g, w) for g, w in zip(gbar, wbar))
        babs = max(float((g - w).abs().max())
                   for g, w in zip(gbar, wbar) if w.numel())
        check(be <= TOL, f"K4 disagrees: {be:.3e}")
        check(all(torch.equal(g, a) for g, a in zip(gbar, again)),
              "K4 is not bitwise deterministic")
        worst["pinn_mlp_fwd2_res"] = max(worst["pinn_mlp_fwd2_res"], ae)
        worst["pinn_mlp_bwd2"] = max(worst["pinn_mlp_bwd2"], babs)
        scaled = max(scaled, be)
        n_cases += 1
        print(f"res+bwd {act:4s} d{d_in} w{width}x{depth} "
              f"d2={'all' if d2 is None else d2} "
              f"{n_sub}x{n} K3 abs {ae:.1e} K4 {be:.1e}")

    for act in ("tanh", "sin", "cos"):
        for d_in in (1, 2, 3):
            n_out = 1 if d_in == 2 else 3
            for width, depth in ((20, 1), (24, 4), (80, 3), (128, 5)):
                for d2 in subsets[d_in]:
                    for n_sub, n in ((1, 1013), (4, 517)):
                        case(act, d_in, n_out, width, depth, d2, n_sub, n)
    # the edges of K4's partition: one row, a tile less one, a tile, a tile
    # and one, the quickstart's rows (blocks owning unequal numbers of
    # tiles where a subdomain has more tiles than resident blocks); widths
    # 36 and 100, odd numbers (9, 25) of the micro-tiles' 4-column groups;
    # 1, 4 and 9 subdomains
    n_main = n_cases
    unequal = 0
    for d_in, d2, act in ((2, (0,), "tanh"), (3, None, "sin"),
                          (1, (), "cos")):
        n_out = 1 if d_in == 2 else 3
        for width, depth in ((24, 4), (36, 3), (100, 3)):
            tile = _k4_plan(1, 1, d_in, width, depth, n_out, d2)[0]
            for n_sub in (1, 4, 9):
                for n in sorted({1, tile - 1, tile, tile + 1, 1120}):
                    blocks = _k4_plan(n_sub, n, d_in, width, depth, n_out,
                                      d2)[1]
                    n_tiles = -(-n // tile)
                    unequal += n_tiles % blocks != 0
                    case(act, d_in, n_out, width, depth, d2, n_sub, n)
    check(unequal > 0, "no edge case had blocks owning unequal tiles")
    # the scenario shapes: the cavity's d_in = 2, n_out = 3 (u, v, p) at
    # depth 5 with both second-order directions or none (Euler1D's), and
    # the us_map's ten subdomains at the rows of their ragged megabatch
    # (the example's counts and the paper's)
    n_scen = n_cases
    rows = _scenario_rows()
    for width in (40, 80):
        for d2 in (None, ()):
            case("tanh", 2, 3, width, 5, d2, 4, rows["cavity"])
    for n in (rows["us_map"], rows["us_map_paper"]):
        case("tanh", 2, 1, 80, 3, None, 10, n)
    # autograd through the packed call: card (K3 + K4) against the CPU
    args = [t.cpu() for t in _net(gen, 4, 1120, 2, 24, 4, 1, dev)]
    x, w, b, av = args
    dims = [2, 24, 24, 24, 24, 1]
    Ws = [w[:, l, :i, :o] for l, (i, o) in enumerate(zip(dims[:-1],
                                                           dims[1:]))]
    bs = [b[:, l, :o] for l, o in enumerate(dims[1:])]
    a = av[:, :4]
    cts = _cotangents(gen, 4, 1120, 2, 1, "cpu")
    grads = {}
    for d in ("cpu", dev):
        ins = [t.to(d).clone().requires_grad_() for t in [x, *Ws, *bs, a]]
        outs = ops.pinn_mlp_forward2(ins[0], ins[1:6], ins[6:11], ins[11],
                                     act="tanh", d2_dirs=(0,), bwd="fused")
        grads[str(d)] = torch.autograd.grad(outs, ins,
                                            [c.to(d) for c in cts])
    ag = max(_leaf_err(g.cpu(), c) for g, c in zip(grads[str(dev)],
                                                   grads["cpu"]))
    check(ag <= TOL, f"autograd boundary card vs CPU: {ag:.3e}")
    emit({"train_sweep_cases": n_cases, "edge_cases": n_scen - n_main,
          "scenario_cases": n_cases - n_scen, "scenario_rows": rows,
          "edge_cases_unequal_tiles": unequal, "tol": TOL,
          "max_abs_err": worst, "k4_max_scaled_err": scaled,
          "autograd_card_vs_cpu": ag})
    return worst


def _scenario_rows() -> dict:
    """Megabatch rows per subdomain of the scenarios' problems (built on
    the CPU: points only)."""
    from repro_torch.launch import inverse_heat_map as ihm
    from repro_torch.launch import navier_stokes_cavity as nsc

    return {"cavity": _rows(nsc.build_problem(device="cpu").batch),
            "us_map": _rows(ihm.build_problem(device="cpu").batch),
            "us_map_paper": _rows(ihm.build_problem(
                width=80, counts=PAPER_COUNTS, device="cpu").batch)}


def _k4_plan(n_sub, n, d_in, width, depth, n_out, d2) -> tuple[int, int]:
    """K4's (tile rows, blocks per subdomain) for a shape on this card."""
    import ctypes

    from repro_torch.kernels import pinn_mlp as K

    sel = tuple(range(d_in)) if d2 is None else tuple(d2)
    tile, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = K._library_bwd().pinn_mlp_bwd_plan(
        n_sub, n, d_in, -(-width // 4) * 4, depth, n_out, 0, len(sel),
        ctypes.byref(tile), ctypes.byref(blocks))
    check(rc == 0, f"pinn_mlp_bwd_plan failed ({rc})")
    return tile.value, blocks.value


def train_bound(n_sub, m, d_in, width, depth, n_out, ns, kernel):
    """Least time (ms) of one K3 or K4 call, what bounds it, and the counts.

    K3: K2's bytes and FLOPs plus the spills, depth * (1 + d_in + ns) * m
    rows of the padded width.  K4: reads x, the weights, the spills and the
    cotangents of u, du and the kept d2u rows, writes x-bar and the W-bar,
    b-bar, a-bar stacks; per hidden layer two matrix products on every
    stream (W-bar and the W^T product), plus x-bar and W-bar_0."""
    wp = -(-width // 4) * 4
    dims = [d_in] + [width] * depth + [n_out]
    streams = 1 + d_in + ns
    spill = depth * streams * m * wp
    n_params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:])) + depth
    if kernel == "pinn_mlp_fwd2_res":
        flops = 2 * d_in * width
        for a, b in zip(dims[1:-1], dims[2:]):
            flops += streams * 2 * a * b
        words = m * d_in + n_params + m * n_out * (1 + 2 * d_in) + spill
    else:
        flops = 2 * 2 * d_in * width       # x-bar and W-bar_0
        for a, b in zip(dims[1:-1], dims[2:]):
            flops += 2 * streams * 2 * a * b
        words = (m * d_in + n_params + spill + m * n_out * streams
                 + m * d_in + n_params)
    flops *= n_sub * m
    nbytes = 4 * n_sub * words
    t_bytes, t_ops = nbytes / HBM_BYTES, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", nbytes, flops)


def train_timing(dev, m_main: int) -> dict:
    """K3 and K4 at the quickstart megabatch (n_sub=4, width 24 x 4,
    d2_dirs=(0,)) and at width 80 x 5, same rows: device ms (CUDA graph of
    launches), wrapper-call ms, plain-version ms, bound."""
    import torch

    from repro_torch.kernels import pinn_mlp as K

    gen = torch.Generator().manual_seed(SEED + 3)
    out = {}
    for width, depth in ((24, 4), (80, 5)):
        d_in, n_out, act, n_sub, d2 = 2, 1, "tanh", 4, (0,)
        args = _net(gen, n_sub, m_main, d_in, width, depth, n_out, dev)
        cts = _cotangents(gen, n_sub, m_main, d_in, n_out, dev)
        res = K.pinn_mlp_fwd2_res(*args, n_out=n_out, act=act, d2_dirs=d2)[3]
        x, w, b, av = args
        calls = {
            "pinn_mlp_fwd2_res": (
                lambda: K.pinn_mlp_fwd2_res(*args, n_out=n_out, act=act,
                                            d2_dirs=d2),
                lambda: K.pinn_mlp_fwd2_res_plain(*args, n_out=n_out,
                                                  act=act, d2_dirs=d2)),
            "pinn_mlp_bwd2": (
                lambda: K.pinn_mlp_bwd2(x, w, av, res, *cts, n_out=n_out,
                                        act=act, d2_dirs=d2),
                lambda: K.pinn_mlp_bwd2_plain(x, w, av, res, *cts,
                                              n_out=n_out, act=act,
                                              d2_dirs=d2))}
        for name, (kern, plain) in calls.items():
            bms, by, nbytes, flops = train_bound(n_sub, m_main, d_in, width,
                                                 depth, n_out, len(d2), name)
            row = {"kernel": name, "shape": f"n_sub={n_sub} m={m_main} "
                   f"w{width}x{depth} d_in={d_in} d2={list(d2)}",
                   "ms": _graph_ms(kern, 200),
                   "call_ms": _events_ms(kern, 200),
                   "plain_ms": _events_ms(plain, 20), "bound_ms": bms,
                   "bound_by": by, "bytes": nbytes, "flops": flops}
            out[(name, width, depth, m_main)] = row
            emit({"timing": row})
    return out


def ab_phase(dev, other: str, m_main: int) -> None:
    """K3 and K4 of this checkout against those built from the sources in
    the directory ``other`` (``pinn_mlp_fwd.cu`` and ``pinn_mlp_bwd.cu`` of
    another revision, with the same C interface), in one process on one
    card: each library held against the plain versions, then both timed in
    turns (other, this, this, other) at train_timing's two shapes."""
    import ctypes

    import torch
    from repro_torch.kernels import native
    from repro_torch.kernels import pinn_mlp as K

    libs = {"this": (K._library, K._library_bwd)}
    other_libs = []
    for stem, bind in (("pinn_mlp_fwd", K.bind_fwd),
                       ("pinn_mlp_bwd", K.bind_bwd)):
        built = native.build([os.path.join(other, stem + ".cu")])[stem]
        rows = _ptxas_report(built["log"])
        emit({"ab_build": {"source": os.path.join(other, stem + ".cu"),
                           "registers": [min(r[1] for r in rows),
                                         max(r[1] for r in rows)],
                           "spill_bytes_max": max(r[2] for r in rows)}})
        lib = bind(ctypes.CDLL(built["path"]))
        other_libs.append(lambda lib=lib: lib)
    libs["other"] = tuple(other_libs)
    gen = torch.Generator().manual_seed(SEED + 3)
    try:
        for width, depth in ((24, 4), (80, 5)):
            d_in, n_out, act, n_sub, d2 = 2, 1, "tanh", 4, (0,)
            args = _net(gen, n_sub, m_main, d_in, width, depth, n_out, dev)
            cts = _cotangents(gen, n_sub, m_main, d_in, n_out, dev)
            want, wbar = _run_train(False, args, n_out, act, d2, cts)
            x, w, b, av = args
            res = want[3]
            calls = {
                "pinn_mlp_fwd2_res": lambda: K.pinn_mlp_fwd2_res(
                    *args, n_out=n_out, act=act, d2_dirs=d2),
                "pinn_mlp_bwd2": lambda: K.pinn_mlp_bwd2(
                    x, w, av, res, *cts, n_out=n_out, act=act, d2_dirs=d2)}
            times = {}
            for side in ("other", "this", "this", "other"):
                K._library, K._library_bwd = libs[side]
                got, gbar = _run_train(True, args, n_out, act, d2, cts)
                torch.cuda.synchronize()
                _compare(got, want, d_in, d2)
                be = max(_leaf_err(g, v) for g, v in zip(gbar, wbar))
                check(be <= TOL, f"{side} K4 disagrees: {be:.3e}")
                for name, fn in calls.items():
                    times.setdefault((name, side), []).append(
                        _graph_ms(fn, 200))
            for name in calls:
                bms = train_bound(n_sub, m_main, d_in, width, depth, n_out,
                                  len(d2), name)[0]
                emit({"ab": {"kernel": name,
                             "shape": f"n_sub={n_sub} m={m_main} "
                                      f"w{width}x{depth} d_in={d_in} "
                                      f"d2={list(d2)}",
                             "other_ms": times[(name, "other")],
                             "this_ms": times[(name, "this")],
                             "bound_ms": bms}})
    finally:
        K._library, K._library_bwd = libs["this"]


def _train_setup(device, seed=SEED):
    """The quickstart's model, batch and trainer on ``device``."""
    from repro_torch.core import (Burgers1D, CartesianDecomposition, DDConfig,
                                  ReferenceTrainer, XPINN, build_topology)
    from repro_torch.core.nets import MLPConfig, SubdomainModelConfig
    from repro_torch.data import make_batch

    pde = Burgers1D()
    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    topo = build_topology(dec, n_iface=20)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    batch = make_batch(dec, topo, pde, n_res=1000, n_bnd=80,
                       rng=np.random.default_rng(seed))
    trainer = ReferenceTrainer(pde, cfg, topo,
                               DDConfig(method=XPINN, residual_path="fused"),
                               lrs=2e-3, device=device)
    return trainer, batch.device_arrays(trainer.device)


def _rows(b) -> int:
    """Megabatch rows per subdomain: residual, interface and data points."""
    return int(b.res_pts.shape[1] + b.iface_pts.shape[1] * b.iface_pts.shape[2]
               + b.data_pts.shape[1])


def train_phase(dev) -> dict:
    """The quickstart on the card through the port's entry point, its
    launch counts, a 10-step card-vs-CPU trajectory and the step time."""
    import torch
    from repro_torch.core import TrainState
    from repro_torch.core.nets import map_tree, tree_leaves
    from repro_torch.kernels import pinn_mlp as K
    from repro_torch.launch import quickstart
    from repro_torch.optim.adam import init_adam

    steps = 1500
    buf = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = quickstart.main(["--device", "cuda", "--steps", str(steps),
                              "--chunk", "250"])
    secs = time.perf_counter() - t0
    counts, plain = dict(K.launches), dict(K.plain_calls)
    report = json.loads(buf.getvalue().strip().splitlines()[-1])["quickstart"]
    check(rc == 0, f"quickstart exited {rc}")
    check(report["rel_l2"] < 0.5, f"rel-L2 {report['rel_l2']:.4f} >= 0.5")
    for k in ("pinn_mlp_fwd2_res", "pinn_mlp_bwd2"):
        check(counts[k] == steps, f"{k}: {counts[k]} launches for {steps} "
                                  "loss evaluations")
    check(counts["pinn_mlp_fwd1"] > 0, "rel-L2 evaluation never ran K1")
    check(not any(plain.values()), f"plain versions on CUDA tensors: {plain}")
    emit({"train": {
        "seconds": round(secs, 3), "rel_l2": report["rel_l2"],
        "chunks": [{"step": r["step"], "steps_per_s": r["steps_per_s"],
                    "rel_l2": r["rel_l2"]} for r in report["chunks"]],
        "launches": counts, "plain_calls_on_cuda": plain}})

    # 10 steps from one init on the card (kernels) and on the CPU (plain)
    tr_gpu, b_gpu = _train_setup(dev)
    tr_cpu, b_cpu = _train_setup("cpu")
    s_cpu = tr_cpu.init(SEED)
    p_gpu = map_tree(lambda t: t.to(dev), s_cpu.params)
    s_gpu = TrainState(params=p_gpu, opt=init_adam(p_gpu),
                       step=s_cpu.step.to(dev))
    s_gpu, t_gpu = tr_gpu.run_chunk(s_gpu, b_gpu, 10)
    s_cpu, t_cpu = tr_cpu.run_chunk(s_cpu, b_cpu, 10)
    term_err = max(float(((t_gpu[k].cpu() - t_cpu[k]).abs()
                          / t_cpu[k].abs().clamp(min=1e-6)).max())
                   for k in t_cpu)
    par_err = max(float((g.cpu() - c).abs().max()) for g, c in
                  zip(tree_leaves(s_gpu.params), tree_leaves(s_cpu.params)))
    check(term_err <= TRAJ_RTOL, f"10-step terms card vs CPU: {term_err:.3e}")
    check(par_err <= TRAJ_ATOL, f"10-step params card vs CPU: {par_err:.3e}")

    # ms per training step at the quickstart shape, over chunks of 100
    # steps (three repeats), then a profiler split of 20 steady steps
    trainer, b = _train_setup(dev)
    state = trainer.init(SEED)
    state, _ = trainer.run_chunk(state, b, 20)       # warm-up
    torch.cuda.synchronize()
    n, reps = 100, []
    for _ in range(3):
        t0 = time.perf_counter()
        state, terms = trainer.run_chunk(state, b, n)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3 / n)
    step_ms = sorted(reps)[1]
    holder = {}

    def twenty():
        holder["s"] = trainer.run_chunk(state, b, 20)[0]

    t0 = time.perf_counter()
    twenty()
    torch.cuda.synchronize()
    wall20 = (time.perf_counter() - t0) * 1e3
    split = _device_split(twenty, TRAIN_KERNELS)
    k = split["kernel_ms"]
    trace = {"steps": 20, "wall_ms": wall20,
             "profiled_wall_ms": split["profiled_wall_ms"],
             "device_busy_ms": split["device_busy_ms"],
             "idle_share": 1.0 - split["device_busy_ms"] / wall20,
             "k3_ms": k["k3"], "k4_ms": k["k4"] + k["k4_reduce"],
             "k4_sweep_ms": k["k4"], "k4_reduce_ms": k["k4_reduce"],
             "device_events": split["device_events"], "top": split["top"]}
    check(k["k3"] > 0 and k["k4"] > 0,
          f"the training trace shows no K3 / K4 time: {k}")
    emit({"train_check": {
        "traj_term_rel_err": term_err, "traj_param_abs_err": par_err,
        "traj_rtol": TRAJ_RTOL, "traj_atol": TRAJ_ATOL,
        "step_ms": step_ms, "step_ms_repeats": reps,
        "m_per_sub": _rows(b), "trace": trace}})
    return {"launches": counts, "step_ms": step_ms}


# ------------------------------------------------------------------- runtime

def _counted(fn, *args):
    """Run ``fn`` with the PINN kernels' counts set to 0 just before and
    read just after: (result, seconds, launches, plain calls on CUDA)."""
    from repro_torch.kernels import pinn_mlp as K

    buf = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    secs = time.perf_counter() - t0
    return res, buf.getvalue(), secs, dict(K.launches), dict(K.plain_calls)


def _quickstart_trainer(dev, nx):
    """The quickstart's trainer at nx x 2 subdomains on ``dev``."""
    from repro_torch.core import (Burgers1D, CartesianDecomposition, DDConfig,
                                  ReferenceTrainer, XPINN, build_topology)
    from repro_torch.core.nets import MLPConfig, SubdomainModelConfig

    dec = CartesianDecomposition(((-1, 1), (0, 1)), nx, 2)
    topo = build_topology(dec, n_iface=20)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    tr = ReferenceTrainer(Burgers1D(), cfg, topo,
                          DDConfig(method=XPINN, residual_path="fused"),
                          lrs=2e-3, device=dev)
    return tr, dec


def runtime_phase(dev) -> dict:
    """The fault-tolerant runtime on the card: (a) the supervised quickstart
    under the fault matrix, (b) bitwise crash recovery, (c) elastic resume
    4 -> 6 subdomains, (d) field serving under the serve fault matrix."""
    import torch
    from repro_torch.core import evaluate_l2
    from repro_torch.core.nets import tree_leaves
    from repro_torch.launch import quickstart, serve_field
    from repro_torch.runtime import (Fault, FaultInjector, Supervisor,
                                     SupervisorConfig, elastic_resume)

    t_phase = time.perf_counter()
    out = {"card": _smi()}
    k3, k4 = "pinn_mlp_fwd2_res", "pinn_mlp_bwd2"
    with tempfile.TemporaryDirectory() as tmp:
        # (a) supervised quickstart under crash, NaN and straggler faults
        ck = os.path.join(tmp, "ck")
        steps, chunk = 1500, 250
        spec = "crash@1,nan_params@2:0,straggler@3*0.1"
        rc, text, secs, counts, plain = _counted(quickstart.main, [
            "--device", "cuda", "--steps", str(steps), "--chunk", str(chunk),
            "--supervised", "--ckpt", ck, "--inject", spec])
        rep = json.loads(text.strip().splitlines()[-1])["quickstart"]
        sup = rep["supervisor"]
        check(rc == 0, f"supervised quickstart exited {rc}")
        check((sup["crashes"], sup["guard_trips"], sup["restarts"],
               sup["stragglers"]) == (1, 1, 2, 1), f"supervisor {sup}")
        check(rep["rel_l2"] < 0.5, f"supervised rel-L2 {rep['rel_l2']:.4f}")
        # every attempt ran a whole chunk (250 divides 1500): the committed
        # ones and the two rolled back, whose guarded chunk went on through
        # frozen steps after the trip
        attempts = sup["chunks"] + sup["restarts"]
        check(attempts == 8, f"{attempts} chunk attempts, expected 8")
        for k in (k3, k4):
            check(counts[k] == attempts * chunk,
                  f"{k}: {counts[k]} launches for {attempts} attempts x "
                  f"{chunk} steps")
        check(counts["pinn_mlp_fwd1"] > 0, "rel-L2 evaluation never ran K1")
        check(not any(plain.values()), f"plain versions on CUDA: {plain}")
        out["supervised"] = {
            "argv_inject": spec, "steps": steps, "chunk": chunk,
            "seconds": secs, "rel_l2": rep["rel_l2"], "attempts": attempts,
            "committed_steps_per_s": [chunk / w for w in sup["walltimes"]],
            "supervisor": sup, "launches": counts,
            "plain_calls_on_cuda": plain}

        # (b) crash recovery is bitwise on the card
        def crash_and_replay():
            tr, b = _train_setup(dev)
            s = Supervisor(tr, os.path.join(tmp, "ck_b"),
                           SupervisorConfig(chunk_steps=100),
                           FaultInjector([Fault(chunk=1, kind="crash")]))
            s_f, report = s.run(tr.init(SEED), b, 300)
            s_b = tr.init(SEED)
            for _ in range(3):
                s_b, _ = tr.run_chunk(s_b, b, 100)
            diff = max(float((x - y).abs().max()) for x, y in zip(
                tree_leaves((s_f.params, s_f.opt["m"], s_f.opt["v"])),
                tree_leaves((s_b.params, s_b.opt["m"], s_b.opt["v"]))))
            same = (int(s_f.step) == int(s_b.step) == 300
                    and int(s_f.opt["count"]) == int(s_b.opt["count"]))
            return report, diff, same, s_f.params["u"]["W"][0].is_cuda

        (report, diff, same, on_card), _, secs, counts, plain = _counted(
            crash_and_replay)
        check(report.crashes == 1 and report.chunks == 3,
              f"crash run: {report.as_dict()}")
        check(on_card and same, "crash run: state off the card or steps "
                                "differ")
        check(diff == 0.0, f"crash recovery differs by {diff:.3e} on the "
                           "card (must be bitwise)")
        # 4 supervised attempts + 3 uninterrupted chunks of 100 steps
        check(counts[k3] == counts[k4] == 700, f"crash run launches {counts}")
        check(not any(plain.values()), f"plain versions on CUDA: {plain}")
        out["bitwise_recovery"] = {
            "steps": 300, "chunk": 100, "max_abs_diff": diff,
            "recovery_s": report.recovery_s, "seconds": secs,
            "launches": counts}

        # what the guard costs: ms per step of guarded and plain chunks of
        # 100 steps from one state, in turns (guarded, plain, plain,
        # guarded), then 20 steps of each under the profiler
        tr, b = _train_setup(dev)
        st, _ = tr.run_chunk(tr.init(SEED), b, 20)          # warm-up
        chunks = {"guarded": lambda n: tr.run_chunk_guarded(st, b, n),
                  "plain": lambda n: tr.run_chunk(st, b, n)}
        turns = {"guarded": [], "plain": []}
        for kind in ("guarded", "plain", "plain", "guarded"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunks[kind](100)
            torch.cuda.synchronize()
            turns[kind].append((time.perf_counter() - t0) * 1e3 / 100)
        cost = {"ms_per_step": turns}
        for kind, run in chunks.items():
            split = _device_split(lambda: run(20), TRAIN_KERNELS)
            cost[kind] = {
                "device_events_per_step": split["device_events"] / 20,
                "device_busy_ms_per_step": split["device_busy_ms"] / 20,
                "profiled_wall_ms_per_step": split["profiled_wall_ms"] / 20,
                "top": split["top"]}
        out["guard_cost"] = cost

        # (c) elastic resume of (a)'s checkpoint at 3 x 2 subdomains
        def warm_cold():
            tr6, dec6 = _quickstart_trainer(dev, 3)
            resumed, meta = elastic_resume(ck, tr6, dec6)
            l2 = lambda p: evaluate_l2(dec6, tr6.model_cfg, p, tr6.act_codes,
                                       tr6.pde, device=dev)
            return (l2(resumed.params), l2(tr6.init(SEED).params),
                    meta["supervisor"]["decomp"]["n_sub"], int(resumed.step))

        (warm, cold, n_old, at), _, _, _, _ = _counted(warm_cold)
        check(n_old == 4 and at == steps, f"resumed n_sub {n_old} step {at}")
        check(warm < cold, f"warm start {warm:.4f} not better than cold "
                           f"{cold:.4f}")
        more = 500
        rc, text, secs, counts, plain = _counted(quickstart.main, [
            "--device", "cuda", "--nx", "3", "--steps", str(steps + more),
            "--chunk", str(chunk), "--supervised", "--resume", ck,
            "--ckpt", os.path.join(tmp, "ck6")])
        rep = json.loads(text.strip().splitlines()[-1])["quickstart"]
        check(rc == 0, f"elastic quickstart exited {rc}")
        check(rep["resumed"]["n_sub_from"] == 4 and
              rep["resumed"]["n_sub"] == 6, f"resume {rep['resumed']}")
        check(rep["rel_l2"] < 0.5, f"elastic rel-L2 {rep['rel_l2']:.4f}")
        for k in (k3, k4):
            check(counts[k] == more, f"elastic {k}: {counts[k]} launches")
        check(not any(plain.values()), f"plain versions on CUDA: {plain}")
        out["elastic"] = {"n_sub": [4, 6], "rel_l2_warm": warm,
                          "rel_l2_cold": cold, "steps_more": more,
                          "rel_l2": rep["rel_l2"], "seconds": secs,
                          "launches": counts}

    # (d) field serving under the serve fault matrix, order 2 (K2), 1 (K1)
    faults = "engine-raise@3,nan-output@5,slow-engine@7*0.05"
    out["serve"] = []
    for order, kernel in ((2, "pinn_mlp_fwd2"), (1, "pinn_mlp_fwd1")):
        argv = ["--demo", "cart", "--device", "cuda", "--max-requests", "40",
                "--order", str(order), "--faults", faults]
        with contextlib.redirect_stderr(io.StringIO()):
            rc, text, secs, counts, plain = _counted(serve_field.main, argv)
        report = json.loads(text[text.index("{"):])
        check(rc == 0, f"serve_field --faults --order {order} exited {rc}")
        check(report["drained"]["unanswered"] == 0,
              f"order {order}: unanswered tickets under faults")
        check(sum(report["by_status"].values()) == report["requests"],
              f"order {order}: statuses {report['by_status']}")
        check(counts[kernel] > 0, f"order {order}: {kernel} never launched")
        check(not any(plain.values()), f"plain versions on CUDA: {plain}")
        st = report["stats"]
        out["serve"].append({
            "order": order, "faults": faults, "seconds": secs,
            "requests": report["requests"], "by_status": report["by_status"],
            "goodput": report["goodput"], "p50_s": report["p50_s"],
            "p99_s": report["p99_s"], "guard_trips": st["guard_trips"],
            "flush_failures": st["flush_failures"], "retries": st["retries"],
            "launches": counts})
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t_phase
    emit({"runtime": out})
    return out


# ---------------------------------------------------------------- distributed

DIST_RANKS = 4
DIST_STEPS, DIST_CHUNK = 1500, 250
DIST_TURN_STEPS = 100
# the distributed trainer against ReferenceTrainer after 10 steps: the
# reference's bounds (tests/test_parallel_equivalence.py)
DIST_PARAM_TOL = 1e-5
DIST_LOSS_RTOL = 1e-4


def _dist_setup(dev, rank_trainer=True, **dd):
    """The quickstart's problem (2 x 2 Burgers XPINN, 24 x 4 nets, n_iface
    20, n_res 1000, n_bnd 80, lrs 2e-3, fused path) with a
    DistributedDDTrainer (inside a process group) or a ReferenceTrainer;
    the global batch on ``dev``."""
    from repro_torch.core import (Burgers1D, CartesianDecomposition,
                                  DDConfig, DistributedDDTrainer,
                                  ReferenceTrainer, XPINN, build_topology)
    from repro_torch.core.nets import MLPConfig, SubdomainModelConfig
    from repro_torch.data import make_batch

    pde = Burgers1D()
    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    topo = build_topology(dec, n_iface=20)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    batch = make_batch(dec, topo, pde, n_res=1000, n_bnd=80,
                       rng=np.random.default_rng(SEED))
    cls = DistributedDDTrainer if rank_trainer else ReferenceTrainer
    tr = cls(pde, cfg, topo, DDConfig(method=XPINN, residual_path="fused",
                                      **dd), lrs=2e-3, device=dev)
    return tr, batch.device_arrays(dev), dec


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _leaves_np(tree) -> list:
    from repro_torch.core.nets import tree_leaves
    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


def _dist_rank(mesh, ck_dir: str) -> dict:
    """One rank of the distributed phase, (a)-(d); every step with the
    PINN kernels' counts set to 0 just before and read just after."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import DataParallelTrainer, evaluate_l2
    from repro_torch.core.domain import build_topology
    from repro_torch.core.nets import tree_leaves
    from repro_torch.data import make_batch
    from repro_torch.kernels import pinn_mlp as K
    from repro_torch.optim import CompressionConfig
    from repro_torch.runtime import (Fault, FaultInjector, Supervisor,
                                     SupervisorConfig, inject_nan)
    from repro_torch.core import TrainState

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    dev = mesh.rank_device(rank)
    out = {"rank": rank, "device": str(dev)}

    def counted(fn):
        K.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        return (res, time.perf_counter() - t0, dict(K.launches),
                dict(K.plain_calls))

    tr, b_glob, dec = _dist_setup(dev)
    b = tr.shard_batch(b_glob)

    # (a) 10 steps from one init, gathered for the parent's comparison
    (s, terms), secs, cnt, plain = counted(
        lambda: tr.run_chunk(tr.init(SEED), b, 10))
    g = tr.gather_state(s)
    out["a"] = {"params": _leaves_np(g.params) if rank == 0 else None,
                "loss": float(terms["loss"][-1].sum()), "seconds": secs,
                "launches": cnt, "plain": plain}

    # (b) 1500 steps in chunks of 250, then rel-L2 through K1 on rank 0
    def train():
        st = tr.init(SEED)
        for _ in range(DIST_STEPS // DIST_CHUNK):
            st, _ = tr.run_chunk(st, b, DIST_CHUNK)
        return st

    s_b, secs, cnt, plain = counted(train)
    params = tr.gather_state(s_b).params
    l2, _, l2_cnt, l2_plain = counted(
        lambda: evaluate_l2(dec, tr.model_cfg, params, tr.act_codes, tr.pde,
                            device=dev) if rank == 0 else None)
    out["b"] = {"seconds": secs, "launches": cnt, "plain": plain,
                "rel_l2": l2, "l2_launches": l2_cnt, "l2_plain": l2_plain}

    # exchange on / off in turns (on, off, off, on) from s_b: the
    # compute / communication split per step
    tr_off, _, _ = _dist_setup(dev, disable_exchange=True)
    run = {"on": tr, "off": tr_off}
    turns = {"on": [], "off": []}
    staged = []
    for kind in ("on", "off", "off", "on"):
        dist.barrier()
        _sync(dev)
        b0 = tr.comm.staged_bytes
        t0 = time.perf_counter()
        run[kind].run_chunk(s_b, b, DIST_TURN_STEPS)
        _sync(dev)
        turns[kind].append((time.perf_counter() - t0) * 1e3
                           / DIST_TURN_STEPS)
        if kind == "on":
            staged.append((tr.comm.staged_bytes - b0) / DIST_TURN_STEPS)
    out["turns_ms"] = turns
    out["staged_bytes_per_step"] = staged
    # named scopes of 20 steps under the profiler (rank 0; the others run
    # the same chunk unprofiled, in lockstep)
    dist.barrier()
    if rank == 0:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.run_chunk(s_b, b, 20)
            _sync(dev)
        # a scope is a host range and, with CUDA activity on, a device
        # annotation of the same name: keep both
        host, card = dict.fromkeys(SCOPES, 0.0), dict.fromkeys(SCOPES, 0.0)
        for e in prof.key_averages():
            if e.key not in SCOPES:
                continue
            if e.device_type == DeviceType.CPU:
                host[e.key] += e.cpu_time_total / 1e3 / 20
            else:
                card[e.key] += e.device_time_total / 1e3 / 20
        out["scopes_ms_per_step"] = {"host": host, "device_span": card}
    else:
        tr.run_chunk(s_b, b, 20)

    # (c) data parallel, 4 workers, none / int8 / top-k, 30 steps each
    from repro_torch.core import Burgers1D, CartesianDecomposition
    from repro_torch.core.nets import MLPConfig, SubdomainModelConfig

    pde = Burgers1D()
    dec4 = CartesianDecomposition(((-1, 1), (0, 1)), 4, 1)
    bdp = make_batch(dec4, build_topology(dec4, 4), pde, n_res=64, n_bnd=16,
                     rng=np.random.default_rng(0)).device_arrays(dev)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 20, 3)})
    out["c"] = []
    for comp in (None, CompressionConfig("int8"),
                 CompressionConfig("topk", topk_frac=0.05)):
        dp = DataParallelTrainer(pde, cfg, n_workers=mesh.n_sub,
                                 compression=comp, lr=5e-4,
                                 residual_path="fused", device=dev)

        def thirty():
            st, losses = dp.init(SEED), []
            for _ in range(30):
                st, t = dp.step(st, bdp)
                losses.append(float(t["loss"]))
            return st, losses

        (st, losses), secs, cnt, plain = counted(thirty)
        full = dp.gather_state(st)
        row = {"scheme": None if comp is None else comp.scheme,
               "loss_first": losses[0], "loss_last": losses[-1],
               "seconds": secs, "launches": cnt, "plain": plain}
        # params stay replicated bitwise: every worker applies one gradient
        p = torch.cat([t.reshape(-1) for t in tree_leaves(st["params"])])
        allp = dp.comm.all_gather(p)
        row["param_spread"] = float((allp - allp[0]).abs().max())
        if comp is not None:
            e0 = tree_leaves(full["err"])[0]
            row["err_spread"] = float(max((e0[i] - e0[0]).abs().max()
                                          for i in range(1, mesh.n_sub)))
        out["c"].append(row)

    # (d) supervised crash replay (3 x 100 steps, crash after chunk 1)
    # against three uninterrupted chunks; the consensus guard
    def crash_replay():
        sup = Supervisor(tr, ck_dir, SupervisorConfig(chunk_steps=100),
                         FaultInjector([Fault(chunk=1, kind="crash")]),
                         decomp=dec)
        s_f, report = sup.run(tr.init(SEED), b, 300)
        s_u = tr.init(SEED)
        for _ in range(3):
            s_u, _ = tr.run_chunk(s_u, b, 100)
        diff = max(float(np.abs(x - y).max()) for x, y in zip(
            _leaves_np((s_f.params, s_f.opt["m"], s_f.opt["v"])),
            _leaves_np((s_u.params, s_u.opt["m"], s_u.opt["v"]))))
        same = (int(s_f.step) == int(s_u.step) == 300 and
                s_f.opt["count"].tolist() == s_u.opt["count"].tolist())
        st = tr.init(SEED)
        if tr.fault_target(0):
            tree = inject_nan({"params": st.params, "opt": st.opt,
                               "step": st.step}, "nan_params", 0)
            st = TrainState(params=tree["params"], opt=tree["opt"],
                            step=tree["step"])
        _, _, health = tr.run_chunk_guarded(st, b, 4)
        return (report, diff, same, tr.gather_state(s_f),
                health["ok_sub"].tolist(), int(health["good_steps"]))

    (report, diff, same, g_f, ok_sub, good), secs, cnt, plain = counted(
        crash_replay)
    out["d"] = {"report": {k: v for k, v in report.as_dict().items()
                           if isinstance(v, int)},
                "recovery_s": report.recovery_s, "max_abs_diff": diff,
                "same_step_and_count": same, "ok_sub": ok_sub,
                "good_steps": good, "seconds": secs, "launches": cnt,
                "plain": plain,
                "params": _leaves_np(g_f.params) if rank == 0 else None}

    # does gloo's all-reduce take a tensor on the card as it is?
    try:
        t = torch.ones(1, device=dev)
        dist.all_reduce(t)
        out["gloo_all_reduce_cuda"] = float(t) == mesh.n_sub
    except (RuntimeError, ValueError) as e:
        out["gloo_all_reduce_cuda"] = f"{type(e).__name__}: {e}"[:200]
    return out


def distributed_phase(dev) -> dict:
    """Algorithm 1 with one rank per subdomain on the card: 4 ``gloo`` ranks
    (``repro_torch.launch.mesh``) sharing it, (a) parity with
    ReferenceTrainer after 10 steps, (b) 1500 steps to rel-L2 < 0.5 with
    the compute / communication split, (c) the data-parallel baseline
    with and without compression, (d) supervised crash replay, the
    consensus guard and the checkpoint resumed in ReferenceTrainer, (e)
    ``launch.train pinn --distributed``."""
    from repro_torch.core.nets import tree_leaves
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import elastic_resume

    t_phase = time.perf_counter()
    k3, k4, k1 = "pinn_mlp_fwd2_res", "pinn_mlp_bwd2", "pinn_mlp_fwd1"
    res = {"card": _smi(), "ranks": DIST_RANKS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        mesh = mesh_lib.make_pinn_mesh(DIST_RANKS, tmp, dev.type,
                                       timeout_s=300)
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        ranks = mesh_lib.run_ranks(mesh, _dist_rank, ck, deadline_s=600)
        res["group_seconds"] = time.perf_counter() - t0
        res["backend"] = mesh.backend
        res["devices"] = [r["device"] for r in ranks]
        res["gloo_all_reduce_cuda"] = ranks[0]["gloo_all_reduce_cuda"]
        launches = {}

        def add(cnt):
            for k, v in cnt.items():
                launches[k] = launches.get(k, 0) + v

        # (a) parity with ReferenceTrainer on the card
        ref, b, dec = _dist_setup(dev, rank_trainer=False)
        s_ref, t_ref = ref.run_chunk(ref.init(SEED), b, 10)
        par = max(float(np.abs(x - y.detach().cpu().numpy()).max())
                  for x, y in zip(ranks[0]["a"]["params"],
                                  tree_leaves(s_ref.params)))
        l_ref = float(t_ref["loss"][-1].sum())
        l_d = ranks[0]["a"]["loss"]
        check(par <= DIST_PARAM_TOL, f"(a) params differ by {par:.3e}")
        check(abs(l_d - l_ref) <= DIST_LOSS_RTOL * max(1.0, abs(l_ref)),
              f"(a) loss {l_d} against {l_ref}")
        for r in ranks:
            check(r["a"]["launches"][k3] == r["a"]["launches"][k4] == 10,
                  f"(a) rank {r['rank']} launches {r['a']['launches']}")
            check(not any(r["a"]["plain"].values()),
                  f"(a) plain calls on CUDA {r['a']['plain']}")
            add(r["a"]["launches"])
        res["a"] = {"param_max_abs_diff": par, "loss": l_d,
                    "loss_reference": l_ref, "tol": DIST_PARAM_TOL}

        # (b) training: exactly one K3 and one K4 per step on every rank
        for r in ranks:
            cnt = r["b"]["launches"]
            check(cnt[k3] == cnt[k4] == DIST_STEPS,
                  f"(b) rank {r['rank']}: {cnt[k3]} K3 / {cnt[k4]} K4 for "
                  f"{DIST_STEPS} steps")
            check(not any(r["b"]["plain"].values())
                  and not any(r["b"]["l2_plain"].values()),
                  f"(b) plain calls on CUDA on rank {r['rank']}")
            add(cnt)
            add(r["b"]["l2_launches"])
        r0 = ranks[0]
        check(r0["b"]["rel_l2"] < 0.5, f"(b) rel-L2 {r0['b']['rel_l2']:.4f}")
        check(r0["b"]["l2_launches"][k1] > 0, "(b) rel-L2 never ran K1")
        on = sorted(max(r["turns_ms"]["on"][i] for r in ranks)
                    for i in range(2))
        off = sorted(max(r["turns_ms"]["off"][i] for r in ranks)
                     for i in range(2))
        on_ms, off_ms = sum(on) / 2, sum(off) / 2
        # the single-process trainer, same problem, same card, same run
        st, _ = ref.run_chunk(ref.init(SEED), b, 20)
        ref_ms = []
        for _ in range(2):
            _sync(dev)
            t0 = time.perf_counter()
            ref.run_chunk(st, b, DIST_TURN_STEPS)
            _sync(dev)
            ref_ms.append((time.perf_counter() - t0) * 1e3 / DIST_TURN_STEPS)
        res["b"] = {
            "steps": DIST_STEPS, "chunk": DIST_CHUNK,
            "rel_l2": r0["b"]["rel_l2"],
            "seconds": [r["b"]["seconds"] for r in ranks],
            "ms_per_step_1500": [r["b"]["seconds"] * 1e3 / DIST_STEPS
                                 for r in ranks],
            "turns_ms_per_step": {"on": [r["turns_ms"]["on"] for r in ranks],
                                  "off": [r["turns_ms"]["off"]
                                          for r in ranks]},
            "ms_per_step": on_ms, "compute_ms_per_step": off_ms,
            "comm_ms_per_step": on_ms - off_ms,
            "comm_share": (on_ms - off_ms) / on_ms,
            "staged_bytes_per_step": [r["staged_bytes_per_step"]
                                      for r in ranks],
            "scopes_ms_per_step_rank0": r0["scopes_ms_per_step"],
            "reference_trainer_ms_per_step": ref_ms}

        # (c) data parallel
        for i, row in enumerate(r0["c"]):
            for r in ranks:
                cnt = r["c"][i]["launches"]
                check(cnt[k3] == cnt[k4] == 30,
                      f"(c) {row['scheme']}: rank {r['rank']} launches {cnt}")
                check(not any(r["c"][i]["plain"].values()),
                      f"(c) plain calls on CUDA {r['c'][i]['plain']}")
                add(cnt)
            check(row["loss_last"] < row["loss_first"],
                  f"(c) {row['scheme']}: loss {row['loss_first']} -> "
                  f"{row['loss_last']}")
            check(row["param_spread"] == 0.0,
                  f"(c) {row['scheme']}: params differ across workers")
            if row["scheme"] is not None:
                check(row["err_spread"] > 0.0, f"(c) {row['scheme']}: the "
                      "error feedback is the same on every worker")
        res["c"] = [{k: v for k, v in row.items()
                     if k not in ("launches", "plain")} for row in r0["c"]]

        # (d) supervisor: crash replay exact, the guard by consensus, the
        # distributed checkpoint resumed in ReferenceTrainer
        for r in ranks:
            d = r["d"]
            check(d["max_abs_diff"] == 0.0 and d["same_step_and_count"],
                  f"(d) rank {r['rank']}: replay differs by "
                  f"{d['max_abs_diff']:.3e}")
            check(d["report"]["crashes"] == 1 and d["report"]["chunks"] == 3,
                  f"(d) rank {r['rank']}: {d['report']}")
            check(d["ok_sub"][0] is False and d["ok_sub"][3] is True
                  and d["good_steps"] == 1,
                  f"(d) guard: ok_sub {d['ok_sub']} good {d['good_steps']}")
            # 4 supervised attempts + 3 uninterrupted chunks of 100, and 4
            # guarded steps
            check(d["launches"][k3] == d["launches"][k4] == 704,
                  f"(d) rank {r['rank']} launches {d['launches']}")
            check(not any(d["plain"].values()), "(d) plain calls on CUDA")
            add(d["launches"])
        resumed, meta = elastic_resume(ck, ref, dec)
        rdiff = max(float(np.abs(x - y.detach().cpu().numpy()).max())
                    for x, y in zip(r0["d"]["params"],
                                    tree_leaves(resumed.params)))
        check(rdiff == 0.0 and int(resumed.step) == 300
              and int(resumed.opt["count"]) == 300,
              f"(d) ReferenceTrainer resume differs by {rdiff:.3e}")
        res["d"] = {k: r0["d"][k] for k in ("report", "recovery_s",
                                            "max_abs_diff", "ok_sub",
                                            "good_steps", "seconds")}
        res["d"]["reference_resume_max_abs_diff"] = rdiff

        # (e) the CLI, as a user runs it
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=SRC)
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "pinn",
             "--distributed", "--nx", "2", "--nt", "2", "--steps", "20",
             "--device", dev.type],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        check(p.returncode == 0, f"(e) train pinn --distributed exited "
              f"{p.returncode}: {p.stderr[-2000:]}")
        last = json.loads(p.stdout.strip().splitlines()[-1])["train"]
        res["e"] = {"seconds": time.perf_counter() - t0, "result": last,
                    "head": p.stdout.strip().splitlines()[:6]}
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    emit({"distributed": res})
    return launches


# ------------------------------------------------------------------ scenarios

# The bars hold the entry points at the reference examples' own settings,
# each a ratio of the reference's result (the examples at their defaults on
# a CPU, jax 0.9.0): trajectories part with the order of float32 sums, so a
# bar is a ratio, not a match.  Inverse problem: rel-L2 of (T, K) after
# 2000 steps at most 1.5 x the reference's 0.0098, and the served K field's
# rel-L2 at most 2 x its 0.0057 (K is the inferred unknown, and one number
# is a thin sample of its spread, hence the wider ratio).  Cavity: the Ghia
# centerline RMS after 4000 steps at most 1.5 x the reference's 0.0782 (a
# field of u = 0 scores 0.272).
INVERSE_BAR = 1.5 * 0.0098
INVERSE_SERVE_BAR = 2 * 0.0057
CAVITY_BAR = 1.5 * 0.0782
# paper Table 3's residual points per region, unscaled (the example divides
# them by 10)
PAPER_COUNTS = [3000, 4000, 5000, 4000, 3000, 4000, 800, 3000, 5000, 4000]
PAPER_STEPS = 500            # (b): the paper's size, timed; no bar
FUSED_INVERSE_STEPS = 2000   # (c)
CAVITY_TURN_STEPS = 100      # (e): chunks timed in turns
LBFGS_ADAM_STEPS, LBFGS_ITERS = 300, 60
LBFGS_PROBES = 14            # LBFGSConfig.n_probes
# 10 steps of one problem on two routes from one init: the distributed
# phase's bounds (params, summed loss relative)
SCEN_PARAM_TOL, SCEN_LOSS_RTOL = 1e-5, 1e-4
K1, K2, K3, K4 = ("pinn_mlp_fwd1", "pinn_mlp_fwd2", "pinn_mlp_fwd2_res",
                  "pinn_mlp_bwd2")


def _last_json(text: str, key: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])[key]


def _train_timed(tr, b, steps, chunk, state=None):
    """``steps`` outer steps in chunks from ``state`` (a fresh init by
    default): (state, ms per step over the chunks, last summed loss)."""
    import torch

    state = tr.init(SEED) if state is None else state
    done, secs, loss = 0, 0.0, float("nan")
    while done < steps:
        n = min(chunk, steps - done)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, terms = tr.run_chunk(state, b, n)
        loss = float(terms["loss"][-1].sum())    # waits for the chunk
        secs += time.perf_counter() - t0
        done += n
    return state, secs * 1e3 / steps, loss


def _parity(tr_a, b_a, tr_b, b_b, steps=10) -> dict:
    """``steps`` steps of two trainers of one problem from one init (drawn
    on ``tr_a``'s side, moved to ``tr_b``'s device): the largest parameter
    difference and the largest relative difference of the summed loss."""
    from repro_torch.core import TrainState
    from repro_torch.core.nets import map_tree, tree_leaves
    from repro_torch.optim.adam import init_adam

    s_a = tr_a.init(SEED)
    p_b = map_tree(lambda t: t.to(tr_b.device), s_a.params)
    s_b = TrainState(params=p_b, opt=init_adam(p_b),
                     step=s_a.step.to(tr_b.device))
    s_a, t_a = tr_a.run_chunk(s_a, b_a, steps)
    s_b, t_b = tr_b.run_chunk(s_b, b_b, steps)
    la, lb = t_a["loss"].sum(1).cpu(), t_b["loss"].sum(1).cpu()
    par = max(float((x.cpu() - y.cpu()).abs().max()) for x, y in
              zip(tree_leaves(s_a.params), tree_leaves(s_b.params)))
    loss = float(((la - lb).abs() / la.abs()).max())
    check(par <= SCEN_PARAM_TOL, f"{steps}-step params differ by {par:.3e}")
    check(loss <= SCEN_LOSS_RTOL, f"{steps}-step loss differs by {loss:.3e}")
    return {"param_max_abs": par, "loss_max_rel": loss,
            "loss_last": float(lb[-1]), "states": (s_a, s_b)}


def _no_kernels(counts, plain, what):
    check(not any(counts.values()), f"{what}: kernels launched {counts}")
    check(not any(plain.values()), f"{what}: plain versions on CUDA {plain}")


def scenarios_phase(dev) -> dict:
    """The paper's PINN scenarios on the card, each run with the launch
    counts set to 0 just before and read just after: (a) the inverse heat
    map at the example's defaults (jvp path, Table-3 activations) through
    ``launch.inverse_heat_map.main --export --serve-demo``, held to its
    bars, no kernel; (b) the same problem at the paper's size (3 x 80 per
    net, Table 3's unscaled counts), timed; (c) the us_map with one shared
    tanh on the fused path at 3 x 80: 10 steps card against CPU, then 2000
    steps with two K3 and two K4 a step; (d) the cavity at its defaults
    through ``launch.navier_stokes_cavity.main``, held to its bar; (e) the
    cavity at 80 x 5 fused: 10 steps against the jvp path, 4000 steps with
    one K3 and one K4 a step, both paths timed in turns; (f) Adam then
    L-BFGS on vanilla Burgers, gradients through K3/K4 and probes through
    K2."""
    import torch
    from repro_torch.kernels import pinn_mlp as K
    from repro_torch.launch import inverse_heat_map as ihm
    from repro_torch.launch import navier_stokes_cavity as nsc

    t_phase = time.perf_counter()
    out = {"card": _smi()}
    total = dict.fromkeys((K1, K2, K3, K4), 0)

    def add(counts):
        for k in total:
            total[k] += counts[k]

    # (a) the inverse problem at the example's defaults, train -> serve
    with tempfile.TemporaryDirectory(prefix="chip_smoke_inv_") as tmp:
        rc, text, secs, counts, plain = _counted(ihm.main, [
            "--device", str(dev), "--export", os.path.join(tmp, "field"),
            "--serve-demo"])
    rep = _last_json(text, "inverse")
    srv = rep["serve"]
    check(rc == 0, f"inverse_heat_map exited {rc}")
    _no_kernels(counts, plain, "(a) inverse, Table-3 activations")
    check(rep["rel_l2"] <= INVERSE_BAR,
          f"(a) rel-L2(T,K) {rep['rel_l2']:.4f} > {INVERSE_BAR:.4f}")
    check(srv["k_rel_l2"] <= INVERSE_SERVE_BAR,
          f"(a) served K rel-L2 {srv['k_rel_l2']:.4f} > "
          f"{INVERSE_SERVE_BAR:.4f}")
    check(srv["dispatches"] == 1 and srv["frontend"]["cache_hits"] == 1,
          f"(a) serve demo: {srv['dispatches']} dispatches")
    out["a_inverse"] = {
        "steps": rep["steps"], "seconds": secs, "rel_l2": rep["rel_l2"],
        "bar": INVERSE_BAR, "k_rel_l2_served": srv["k_rel_l2"],
        "serve_bar": INVERSE_SERVE_BAR,
        "residual_median": srv["residual_median"],
        "residual_p99": srv["residual_p99"],
        "cold_pts_per_s": srv["cold_pts_per_s"],
        "cached_pts_per_s": srv["cached_pts_per_s"],
        "steps_per_s": [r["steps_per_s"] for r in rep["chunks"]],
        "rel_l2_rows": [[r["step"], r["rel_l2"]] for r in rep["chunks"]],
        "launches": counts}
    emit({"scenario": "a", **out["a_inverse"]})

    # (b) the paper's size: 3 x 80 per net, Table 3's unscaled counts
    def paper():
        prob = ihm.build_problem(width=80, counts=PAPER_COUNTS, device=dev)
        b = prob.batch.device_arrays(dev)
        st, ms, loss = _train_timed(prob.trainer, b, PAPER_STEPS, 250)
        return ms, loss, prob.rel_l2(st.params), _rows(prob.batch)

    (ms, loss, err, rows), _, secs, counts, plain = _counted(paper)
    _no_kernels(counts, plain, "(b) inverse at the paper's size")
    out["b_inverse_paper"] = {"steps": PAPER_STEPS, "ms_per_step": ms,
                              "loss": loss, "rel_l2": err, "rows": rows,
                              "seconds": secs}
    emit({"scenario": "b", **out["b_inverse_paper"]})

    # (c) one shared tanh on the fused path at 3 x 80: parity, then 2000
    def fused_inverse(device):
        prob = ihm.build_problem(width=80, act_codes=["tanh"] * 10,
                                 residual_path="fused", device=device)
        return prob, prob.batch.device_arrays(prob.trainer.device)

    (p_cpu, b_cpu), (p_gpu, b_gpu) = fused_inverse("cpu"), \
        fused_inverse(dev)
    par, _, _, counts, plain = _counted(_parity, p_cpu.trainer, b_cpu,
                                        p_gpu.trainer, b_gpu)
    check(counts[K3] == counts[K4] == 20, f"(c) parity launches {counts}")
    add(counts)

    def fused_run():
        st, ms, loss = _train_timed(p_gpu.trainer, b_gpu,
                                    FUSED_INVERSE_STEPS, 250)
        return ms, loss, st

    (ms, loss, st), _, secs, counts, plain = _counted(fused_run)
    check(counts[K3] == counts[K4] == 2 * FUSED_INVERSE_STEPS,
          f"(c) {counts} launches for {FUSED_INVERSE_STEPS} steps x 2 nets")
    check(not any(plain.values()), f"(c) plain versions on CUDA {plain}")
    add(counts)
    err, _, _, c_l2, plain = _counted(p_gpu.rel_l2, st.params)
    check(c_l2[K1] == 2 and not any(plain.values()),
          f"(c) rel-L2 through K1: {c_l2}, plain {plain}")
    add(c_l2)
    out["c_inverse_fused"] = {
        "steps": FUSED_INVERSE_STEPS, "ms_per_step": ms, "loss": loss,
        "rel_l2": err, "parity_10": {k: par[k] for k in
                                     ("param_max_abs", "loss_max_rel")},
        "launches": counts, "rel_l2_launches": c_l2, "seconds": secs}
    emit({"scenario": "c", **out["c_inverse_fused"]})

    # (d) the cavity at its defaults (jvp, 40 x 5, 4000 steps)
    rc, text, secs, counts, plain = _counted(nsc.main,
                                             ["--device", str(dev)])
    rep = _last_json(text, "cavity")
    check(rc == 0, f"navier_stokes_cavity exited {rc}")
    _no_kernels(counts, plain, "(d) cavity, jvp path")
    check(rep["ghia_rms"] <= CAVITY_BAR,
          f"(d) Ghia RMS {rep['ghia_rms']:.4f} > {CAVITY_BAR:.4f}")
    out["d_cavity"] = {
        "steps": rep["steps"], "seconds": secs, "ghia_rms": rep["ghia_rms"],
        "bar": CAVITY_BAR, "centerline": rep["centerline"],
        "losses": [[r["step"], r["loss"]] for r in rep["chunks"]],
        "steps_per_s": [r["steps_per_s"] for r in rep["chunks"]]}
    emit({"scenario": "d", **out["d_cavity"]})

    # (e) the cavity at the paper's width on the fused path
    probs = {path: nsc.build_problem(width=80, residual_path=path,
                                     device=dev) for path in ("fused", "jvp")}
    bs = {k: p.batch.device_arrays(dev) for k, p in probs.items()}
    par, _, _, counts, plain = _counted(
        _parity, probs["jvp"].trainer, bs["jvp"], probs["fused"].trainer,
        bs["fused"])
    check(counts[K3] == counts[K4] == 10, f"(e) parity launches {counts}")
    add(counts)
    s_j, s_f = par["states"]
    # the jvp step without its graph (the eager step loop), for scale
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs["jvp"].trainer._loop(s_j, lambda i: bs["jvp"], 5)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / 5
    states = {"fused": s_f, "jvp": s_j}
    turns = {"fused": [], "jvp": []}
    for path in ("fused", "jvp", "jvp", "fused"):
        states[path], ms, _ = _train_timed(
            probs[path].trainer, bs[path], CAVITY_TURN_STEPS,
            CAVITY_TURN_STEPS, states[path])
        turns[path].append(ms)
    steps = int(nsc.REPORT_EVERY * 8)

    def cavity_fused():
        st, ms, loss = _train_timed(probs["fused"].trainer, bs["fused"],
                                    steps, nsc.REPORT_EVERY)
        line = nsc.centerline(probs["fused"], st.params)
        return ms, loss, line

    (ms, loss, line), _, secs, counts, plain = _counted(cavity_fused)
    check(counts[K3] == counts[K4] == steps,
          f"(e) {counts} launches for {steps} steps")
    check(not any(plain.values()), f"(e) plain versions on CUDA {plain}")
    add(counts)
    out["e_cavity_fused"] = {
        "steps": steps, "ms_per_step": ms, "loss": loss,
        "ghia_rms": nsc.ghia_rms(line), "centerline": line.tolist(),
        "parity_10_vs_jvp": {k: par[k] for k in
                             ("param_max_abs", "loss_max_rel")},
        "turns_ms_per_step": turns, "jvp_eager_ms_per_step": eager_ms,
        "launches": counts, "seconds": secs}
    emit({"scenario": "e", **out["e_cavity_fused"]})
    del probs, bs, states, par

    # (f) Adam then L-BFGS on vanilla Burgers, on the fused path
    def recipe():
        from repro_torch.core import (Burgers1D, CartesianDecomposition,
                                      losses)
        from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig,
                                           init_model, map_tree, tree_leaves,
                                           tree_unflatten)
        from repro_torch.data import make_vanilla_batch
        from repro_torch.optim import adam, lbfgs_refine

        pde = Burgers1D()
        dec = CartesianDecomposition(((-1, 1), (0, 1)), 1, 1)
        cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 20, 3)})
        batch = make_vanilla_batch(dec, pde, 512, 64,
                                   np.random.default_rng(SEED), device=dev)
        path = losses.ResidualPath(act="tanh")
        loss_fn = lambda p: losses.vanilla_pinn_loss(
            pde, cfg, losses.LossWeights(), p, 0, None, batch, path)[0]
        params = map_tree(lambda t: t.to(dev),
                          init_model(cfg, torch.Generator().manual_seed(SEED)))
        opt = adam.init_adam(params)
        for _ in range(LBFGS_ADAM_STEPS):
            leaves = [t.detach().requires_grad_()
                      for t in tree_leaves(params)]
            p = tree_unflatten(params, leaves)
            loss = loss_fn(p)
            grads = tree_unflatten(p, torch.autograd.grad(loss, leaves))
            params, opt = adam.adam_update(grads, opt, params, 2e-3)
        adam_loss = float(loss.detach())
        adam_counts = dict(K.launches)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = lbfgs_refine(loss_fn, params, LBFGS_ITERS)
        ms = (time.perf_counter() - t0) * 1e3 / LBFGS_ITERS
        return adam_loss, hist, ms, adam_counts

    (adam_loss, hist, ms, adam_counts), _, secs, counts, plain = _counted(
        recipe)
    check(adam_counts[K3] == adam_counts[K4] == LBFGS_ADAM_STEPS,
          f"(f) Adam launches {adam_counts}")
    check(counts[K3] == counts[K4] == 2 * LBFGS_ITERS,
          f"(f) L-BFGS gradients: {counts}")
    check(counts[K2] == LBFGS_PROBES * LBFGS_ITERS,
          f"(f) L-BFGS probes on K2: {counts}")
    check(not any(plain.values()), f"(f) plain versions on CUDA {plain}")
    check(all(b <= a + 1e-6 for a, b in zip(hist, hist[1:])),
          "(f) L-BFGS losses increased")
    check(hist[-1] < 0.9 * adam_loss,
          f"(f) L-BFGS {hist[-1]:.4e} not below 0.9 x Adam {adam_loss:.4e}")
    add(adam_counts)
    add(counts)
    out["f_lbfgs"] = {"adam_steps": LBFGS_ADAM_STEPS, "adam_loss": adam_loss,
                      "iterations": LBFGS_ITERS, "losses": hist,
                      "ms_per_iteration": ms, "adam_launches": adam_counts,
                      "launches": counts, "seconds": secs}
    emit({"scenario": "f", **{k: v for k, v in out["f_lbfgs"].items()
                              if k != "losses"}})
    torch.cuda.synchronize()
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_phase
    emit({"scenarios": out})
    return total


# ---------------------------------------------------------------- LLM kernels

def _allclose(got, want, tol) -> float:
    """Raise unless |got - want| <= tol + tol |want| everywhere and got is
    finite; returns the max abs difference."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{tuple(got.shape)} {got.dtype} != {tuple(want.shape)} "
          f"{want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), "non-finite kernel output")
    diff = (g - w).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    check(bool((diff <= tol + tol * w.abs()).all()),
          f"kernel disagrees: max abs {err:.3e} (tol {tol})")
    return err


def _qkv(gen, B, S, T, H, Hk, dh, dtype, heads_first, dev):
    """q (B, S, H, dh), k/v (B, T, Hk, dh) on the card; with
    ``heads_first`` stored as (B, H, S, dh) and passed as transposed views
    (the layout of the reference's ops signature)."""
    import torch

    if heads_first:
        q = torch.randn((B, H, S, dh), generator=gen, device=dev)
        k, v = (torch.randn((B, Hk, T, dh), generator=gen, device=dev)
                for _ in range(2))
        return [t.to(dtype).transpose(1, 2) for t in (q, k, v)]
    q = torch.randn((B, S, H, dh), generator=gen, device=dev)
    k, v = (torch.randn((B, T, Hk, dh), generator=gen, device=dev)
            for _ in range(2))
    return [t.to(dtype) for t in (q, k, v)]


def _rkvwu(gen, B, T, H, P, w_mode, dev):
    import torch

    r, k, v = (torch.randn((B, T, H, P), generator=gen, device=dev)
               for _ in range(3))
    if w_mode == "uniform":
        w = 0.2 + 0.78 * torch.rand((B, T, H, P), generator=gen, device=dev)
    elif w_mode == "strong":
        w = torch.full((B, T, H, P), 0.05, device=dev)
    else:   # near 1: the init's decay_bias = -6, w = exp(-e^(-6 + dw))
        w = torch.exp(-torch.exp(-6.0 + 0.01 * torch.randn(
            (B, T, H, P), generator=gen, device=dev)))
    u = torch.randn((H, P), generator=gen, device=dev)
    return r, k, v, w, u


def lm_sweep(dev) -> dict:
    """K5 and K6 against their plain versions on the card, each case
    counted on the device kernels it must launch."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import wkv6 as WK

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = []
    for H, Hk in ((32, 8), (8, 8), (4, 1)):
        for dh in (64, 128, 100):
            cases += [(H, Hk, dh, n, n, True)
                      for n in (1, 37, 64, 130, 200, 333, 2048)]
    cases += [(32, 8, dh, S, T, c) for dh in (64, 128, 100)
              for S, T in ((50, 130), (130, 50), (1, 64), (200, 333),
                           (333, 200)) for c in (True, False)]
    n_fa = 0
    for H, Hk, dh, S, T, causal in cases:
        for dname in ("float32", "bfloat16"):
            for heads_first in (False, True):
                B = 1 if max(S, T) > 1000 else 2
                q, k, v = _qkv(gen, B, S, T, H, Hk, dh, getattr(torch, dname),
                               heads_first, dev)
                before = {**FA.launches, **FA.producers}
                got = FA.flash_attention(q, k, v, causal=causal)
                want = FA.flash_attention_plain(q, k, v, causal=causal)
                torch.cuda.synchronize()
                after = {**FA.launches, **FA.producers}
                kern = ("flash_attention_sm90" if dname == "bfloat16"
                        else "flash_attention_f32")
                ran = {n for n in after if after[n] != before[n]}
                want_ran = {"flash_attention", kern}
                if dname == "bfloat16":   # TMA where dh is a multiple of 8
                    want_ran.add("tma" if dh % 8 == 0 else "loads")
                check(ran == want_ran, f"K5 {dname} dh{dh} launched {ran}")
                check(got.stride() == q.stride(), "output layout")
                err = _allclose(got, want, FA_TOL[dname])
                worst[dname] = max(worst[dname], err)
                n_fa += 1
        print(f"K5 H{H}/{Hk} dh{dh} S{S} T{T} causal={causal} ok")
    emit({"k5_sweep_cases": n_fa, "tol": FA_TOL, "max_abs_err": dict(worst)})

    wworst, n_wkv = 0.0, 0
    wcases = [(2, T, chunk) for T, chunk in ((1, 1), (5, 5), (17, 17),
                                             (31, 31), (33, 11), (256, 64),
                                             (1000, 50))]
    wcases.append((3, 99, 33))
    for P in (16, 64, 128):
        for B, T, chunk in wcases:
            for w_mode in ("uniform", "strong", "near1"):
                args = _rkvwu(gen, B, T, 4, P, w_mode, dev)
                before = dict(WK.launches)
                got = WK.wkv6(*args)
                want = WK.wkv6_plain(*args, chunk=chunk)
                torch.cuda.synchronize()
                check(all(WK.launches[n] == before[n] + 1 for n in before),
                      f"K6 launches {before} -> {WK.launches}")
                err = _allclose(got, want, WKV_TOL)
                wworst = max(wworst, err)
                n_wkv += 1
                print(f"K6 P{P} B{B} T{T} w={w_mode} abs {err:.1e}")
    emit({"k6_sweep_cases": n_wkv, "tol": WKV_TOL, "max_abs_err": wworst})
    return {"flash_attention": max(worst.values()), "wkv6": wworst}


def fa_bound(B, S, H, Hk, dh, nbytes_el=2) -> tuple[float, str, int, int]:
    """K5 at S == T, causal (top-left): q, k, v read once and o written once;
    4 dh FLOP per visible (query, key) pair and head, S (S + 1) / 2 pairs."""
    nbytes = nbytes_el * B * S * dh * (2 * H + 2 * Hk)
    flops = 4 * dh * B * H * S * (S + 1) // 2
    t_bytes, t_ops = nbytes / HBM_BYTES, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", nbytes, flops)


def wkv_bound(B, T, H, P) -> tuple[float, str, int, int]:
    """K6: r, k, v, w read once, y written once, u read once (float32); the
    recurrence's 4 P^2 FLOP per step and head (the state read through r and
    its rank-1 update)."""
    nbytes = 4 * (5 * B * T * H * P + H * P)
    flops = 4 * P * P * B * T * H
    t_bytes, t_ops = nbytes / HBM_BYTES, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", nbytes, flops)


def _sdpa(q, k, v):
    """PyTorch's fused attention on the same (B, S, H, dh) tensors, causal
    (its mask is aligned top-left too) with GQA; the math backend is
    excluded, so it is a fused kernel or an error."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)


def lm_timing(dev) -> dict:
    """K5 at llama3.2-1b's per-layer prefill shape (4096 and 32768 tokens)
    and K6 at rwkv6-3b's (4096 steps): device ms of the kernel (CUDA graph of
    launches), its plain version, and for K5 PyTorch's SDPA."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import wkv6 as WK

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = {}
    B, H, Hk, dh = 1, 32, 8, 64
    for S, reps, preps in ((4096, 20, 3), (32768, 2, 1)):
        q, k, v = _qkv(gen, B, S, S, H, Hk, dh, torch.bfloat16, False, dev)
        kern = lambda: FA.flash_attention(q, k, v, causal=True)
        plain = lambda: FA.flash_attention_plain(q, k, v, causal=True)
        lib = lambda: _sdpa(q, k, v)
        sdpa_err = float((lib().float() - kern().float()).abs().max())
        bms, by, nbytes, flops = fa_bound(B, S, H, Hk, dh)
        row = {"kernel": "flash_attention",
               "shape": f"B={B} S=T={S} H={H} Hk={Hk} dh={dh} bf16 causal",
               "ms": _graph_ms(kern, reps), "plain_ms": _events_ms(plain,
                                                                   preps),
               "library_ms": _graph_ms(lib, reps), "bound_ms": bms,
               "bound_by": by, "bytes": nbytes, "flops": flops,
               "sdpa_max_abs_diff": sdpa_err}
        row["tflops"] = flops / row["ms"] * 1e-9
        out[("flash_attention", S)] = row
        emit({"timing": row})
        del q, k, v
        torch.cuda.empty_cache()
    B, T, H, P = 1, 4096, 40, 64
    args = _rkvwu(gen, B, T, H, P, "near1", dev)
    bms, by, nbytes, flops = wkv_bound(B, T, H, P)
    # the plain version at its default chunk of 64 steps: its (c, c, P)
    # decay tensors take 2.7 GB here (at the model's ssm_chunk of 256 they
    # would take 10.7 GB each)
    row = {"kernel": "wkv6", "shape": f"B={B} T={T} H={H} P={P} float32",
           "ms": _graph_ms(lambda: WK.wkv6(*args), 20),
           "plain_ms": _events_ms(lambda: WK.wkv6_plain(*args, chunk=64), 3),
           "plain_chunk": 64, "library_ms": None, "bound_ms": bms,
           "bound_by": by, "bytes": nbytes, "flops": flops,
           "device_kernel_ms": {
               n: t for n, t in _device_split(
                   lambda: WK.wkv6(*args))["kernel_ms"].items() if t}}
    out[("wkv6", T)] = row
    emit({"timing": row})
    del args
    torch.cuda.empty_cache()
    return out


def _device_split(fn, kernels=None) -> dict:
    """One call of ``fn`` under torch.profiler: the device time of every
    kernel and copy it ran (events on the CUDA device only, each counted
    once), the part of it in each device kernel of ``kernels`` (name ->
    symbol; DEVICE_KERNELS, the K5/K6 kernels, by default), the largest
    items, and the host-clock ms of the profiled call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernels = DEVICE_KERNELS if kernels is None else kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    kern = dict.fromkeys(kernels, 0.0)
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        # a record_function scope is also a device-side annotation whose
        # span covers the kernels inside it: it is not work of its own
        if getattr(ev, "is_user_annotation", False) or ev.key in SCOPES:
            continue
        ms = ev.self_device_time_total / 1e3
        busy += ms
        for name, sym in kernels.items():
            if re.search(rf"\b{sym}\b", ev.key):
                kern[name] += ms
        top.append((ms, ev.count, ev.key[:70]))
    top.sort(reverse=True)
    return {"device_busy_ms": busy, "k5_k6_ms": sum(kern.values()),
            "kernel_ms": kern, "device_events": sum(n for _, n, _ in top),
            "top": [[round(t, 3), n, k] for t, n, k in top[:8]],
            "profiled_wall_ms": wall}


def llm_phase(dev) -> dict:
    """The published llama3.2-1b and rwkv6-3b on the card: prefill through
    the kernels (counted), its trace, the plain versions in bf16 and float32,
    and decode against prefill."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import wkv6 as WK
    from repro_torch.models import build_model

    launches = {}
    for name, (B, S) in LLM.items():
        cfg = get_config(name)
        model = build_model(cfg, dev)
        params = model.init(SEED)
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device=dev)
        batch = {"tokens": tokens}
        kname, mod = (("flash_attention", FA) if cfg.family == "dense"
                      else ("wkv6", WK))
        model.prefill(params, batch)          # warm-up (cuBLAS, the build)
        torch.cuda.synchronize()
        for m in (FA, WK):
            m.reset_launch_counts()
        t0 = time.perf_counter()
        logits = model.prefill(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {**FA.launches, **WK.launches}
        plain = {**FA.plain_calls, **WK.plain_calls}
        # one wrapper call per layer, each on the bf16 K5 kernel or on
        # K6's chunk, scan and output kernels, and nothing else
        device = (("flash_attention_sm90",) if kname == "flash_attention"
                  else ("wkv6_chunk", "wkv6_scan", "wkv6_out"))
        expect = {n: cfg.n_layers if n in (kname, *device) else 0
                  for n in counts}
        check(counts == expect, f"{name}: launches {counts}, want {expect}")
        check(not any(plain.values()), f"plain versions on CUDA: {plain}")
        check(tuple(logits.shape) == (B, S, cfg.padded_vocab),
              f"{name}: logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
              f"{name}: non-finite logits")
        launches.update({n: counts[n] for n in (kname, *device)})
        split = _device_split(lambda: model.prefill(params, batch))
        split["idle_share"] = 1.0 - split["device_busy_ms"] / (secs * 1e3)
        check(all(split["kernel_ms"][n] > 0 for n in device),
              f"{name}: the trace shows no time in {device}: {split}")
        plain_bf16 = model.prefill(params, batch, plain=True)
        scale = float(plain_bf16[..., :cfg.vocab].float().abs().max())
        bf16_rel = float((logits.float() - plain_bf16.float())[
            ..., :cfg.vocab].abs().max()) / scale
        del logits, plain_bf16

        m32 = build_model(dataclasses.replace(cfg, dtype="float32"), dev)
        FA.reset_launch_counts()
        got = m32.prefill(params, batch)
        check(kname != "flash_attention" or
              FA.launches["flash_attention_f32"] == cfg.n_layers,
              f"{name}: float32 prefill launches {FA.launches}")
        want = m32.prefill(params, batch, plain=True)
        scale = float(want[..., :cfg.vocab].abs().max())
        f32_rel = float((got - want)[..., :cfg.vocab].abs().max()) / scale
        check(f32_rel <= LLM_F32_TOL,
              f"{name}: float32 prefill kernels vs plain {f32_rel:.3e}")
        del want
        cache = m32.init_cache(B, 16)
        dec = []
        for t in range(16):
            lg, cache = m32.decode_step(params, cache,
                                        {"tokens": tokens[:, t:t + 1]}, t)
            dec.append(lg[:, 0])
        dec_rel = float((torch.stack(dec, 1) - got[:, :16])[
            ..., :cfg.vocab].abs().max()) / scale
        check(dec_rel <= DECODE_TOL, f"{name}: decode vs prefill "
                                     f"{dec_rel:.3e}")
        emit({"llm": {
            "arch": name, "batch": B, "seq": S, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "prefill_s": secs,
            "prefill_tokens_per_s": B * S / secs, "launches": counts,
            "plain_calls_on_cuda": plain, "bf16_kernel_vs_plain_rel": bf16_rel,
            "f32_kernel_vs_plain_rel": f32_rel, "f32_tol": LLM_F32_TOL,
            "decode_vs_prefill_rel": dec_rel, "decode_tol": DECODE_TOL,
            "profile": split}})
        del params, got, dec, cache, model, m32
        torch.cuda.empty_cache()
    return launches


def llm_serve_phase(dev) -> None:
    """``launch.serve.main`` on the card at full width and depth."""
    import torch
    from repro_torch.launch import serve

    smi = _smi()
    argv = ["--no-reduced", "--batch", "4", "--prompt-len", "16", "--gen",
            "16"]
    for name in LLM:
        runs = []
        for _ in range(2):   # the first one pays the card's first-use costs
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = serve.main(["--arch", name] + argv)
            secs = time.perf_counter() - t0
            report = json.loads(
                buf.getvalue().strip().splitlines()[-1])["serve"]
            check(rc == 0, f"serve {name} exited {rc}")
            check(report["shape"] == [4, 32] and not report["reduced"],
                  f"serve {name}: {report}")
            check(report["device"].startswith("cuda"), f"serve on {report}")
            runs.append((secs, report))
            torch.cuda.empty_cache()
        emit({"llm_serve": {
            "arch": name, "argv": argv, "seconds": [r[0] for r in runs],
            "tokens_per_s": [r[1]["tokens_per_s"] for r in runs],
            "new_tokens": runs[-1][1]["new_tokens"], "card": smi}})


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


# -------------------------------------------------------------------- report

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every phase's numbers to this JSON")
    ap.add_argument("--only", default=None,
                    choices=("distributed", "scenarios"),
                    help="only the build and this phase (no result line)")
    ap.add_argument("--ab", default=None, metavar="DIR",
                    help="only time this checkout's K3/K4 against the "
                         "pinn_mlp_fwd.cu / pinn_mlp_bwd.cu in DIR (another "
                         "revision's), in turns; no other phase runs")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on a "
                         "card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {ROOT}; "
                         "run it from a checkout of the repository")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in
    torch.backends.cudnn.allow_tf32 = False         # full float32
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        emit({"phase": name, "seconds": round(time.perf_counter() - t0, 2)})
        return res

    if args.ab:
        _, b_main = _train_setup("cpu")
        phase("build", build_phase)
        phase("ab", ab_phase, dev, args.ab, _rows(b_main))
        print(_smi())
        return 0
    if args.only:
        phase("build", build_phase)
        phase(args.only, {"distributed": distributed_phase,
                          "scenarios": scenarios_phase}[args.only], dev)
        print(_smi())
        return 0
    phase("build", build_phase)
    worst = phase("kernels", sweep, dev)
    worst.update(phase("train kernels", train_sweep, dev))
    _, b_main = _train_setup("cpu")
    m_train = _rows(b_main)
    times = phase("timing", timing, dev)
    times.update(phase("train timing", train_timing, dev, m_train))
    launches = phase("serve", serve_phase, dev)
    train = phase("train", train_phase, dev)
    for k, v in train["launches"].items():
        launches[k] = launches.get(k, 0) + v
    t3 = times[("pinn_mlp_fwd2_res", 24, 4, m_train)]
    t4 = times[("pinn_mlp_bwd2", 24, 4, m_train)]
    emit({"train_step": {
        "step_ms": train["step_ms"], "forward_kernel_ms": t3["ms"],
        "backward_kernel_ms": t4["ms"],
        "other_ms": train["step_ms"] - t3["ms"] - t4["ms"]}})
    phase("runtime", runtime_phase, dev)
    for k, v in phase("distributed", distributed_phase, dev).items():
        launches[k] = launches.get(k, 0) + v
    for k, v in phase("scenarios", scenarios_phase, dev).items():
        launches[k] = launches.get(k, 0) + v
    worst.update(phase("lm kernels", lm_sweep, dev))
    times.update(phase("lm timing", lm_timing, dev))
    launches.update(phase("llm", llm_phase, dev))
    phase("llm serve", llm_serve_phase, dev)

    kernels = []
    shapes = {"pinn_mlp_fwd1": MAIN, "pinn_mlp_fwd2": MAIN,
              "pinn_mlp_fwd2_res": (24, 4, m_train),
              "pinn_mlp_bwd2": (24, 4, m_train),
              "flash_attention": (4096,), "wkv6": (4096,)}
    for name, shape in shapes.items():
        t = times[(name, *shape)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "device_kernels": {n: launches[n] for n in DEVICE_KERNELS
                               if n.startswith(name) and n in launches},
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            "shape": t["shape"]})
    smi = _smi()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"kernels": kernels, "nvidia_smi": smi,
                       "results": RECORD,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    emit({"kernels": kernels})
    print(smi)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
