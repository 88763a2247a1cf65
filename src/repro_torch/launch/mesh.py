"""Process groups for the distributed trainers, and the production meshes.

Counterpart of the reference package's ``launch/mesh.py``.
:func:`make_production_mesh` is a plan with no devices behind it: the
shape and axis names of the reference's production meshes, ``(16, 16)``
``("data", "model")`` and ``(2, 16, 16)`` ``("pod", "data", "model")``,
or any other shape asked for; the dry run (``launch/dryrun.py``) lays the
sharding specs over it to get per-device bytes.  Beside it, the roofline
peaks of one NVIDIA H100 SXM from NVIDIA's datasheet (dense rates, at the
700 W power limit): figures the dry run and the card check divide by, not
measurements.

:func:`make_pinn_mesh` is the reference's ``make_pinn_mesh``
(a 1-D ``("sub",)`` device mesh, Algorithm 1's communicator).  Here the
communicator is a ``torch.distributed`` process group of ``n`` ranks, each
its own process, started on this host by :func:`run_ranks`:

* the ranks start with ``torch.multiprocessing``'s ``spawn`` method (no
  forked copy of a parent's CUDA state);
* the group is ``gloo``, initialised through a ``FileStore`` in a directory
  the caller gives (no fixed TCP port, so groups started side by side never
  collide), with an explicit ``timeout``: a dead or stuck rank fails its
  peers' collectives instead of hanging them;
* every rank runs on ``cuda:0`` (the one-card machine: the ranks share it)
  or on the CPU when asked, with one intra-op thread;
* a rank that raises fails the run: :func:`run_ranks` stops the others and
  raises the rank's error.  Nothing is caught and continued.

``gloo`` moves host tensors only; payloads on the card are staged through
pinned host buffers by :class:`repro_torch.core.halo.Comm`.  NCCL, with one
card per rank, is not used here: it refuses two ranks on one card.

:func:`make_grid_mesh` is a ``data x model`` grid of such ranks (expert
parallelism, ``models/expert_parallel.py``), laid out as the reference's
``("data", "model")`` mesh: model innermost, so rank = d * M + m.  Every
rank of a grid gets its data group (the D ranks of its model index) and
its model group (the M ranks of its data index) from ``dist.new_group``,
described ``"data"`` and ``"model"``; :func:`run_ranks` hands the rank's
body its :class:`GridRank` in the mesh's place.
"""
from __future__ import annotations

import datetime
import os
import time
import traceback
import uuid
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device

BACKEND = "gloo"
TIMEOUT_S = 300.0

# H100 SXM datasheet peaks (dense, no sparsity), per card
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12      # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
# one direction of NVLink 4's 900 GB/s (18 links), the roofline's rate
# for a device's collective operand bytes
LINK_BW = 450e9              # bytes/s


@dataclass(frozen=True)
class MeshPlan:
    """A device mesh's shape and axis names, with no devices behind it."""

    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.shape)

    def size(self, entry) -> int:
        """Devices a spec entry (an axis name, a tuple of them or None)
        splits a dim over."""
        names = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        n = 1
        for a in names:
            if a not in self.axes:
                raise ValueError(f"mesh {self.name} {self.axes} has no axis "
                                 f"{a!r}")
            n *= self.shape[self.axes.index(a)]
        return n

    def shard_shape(self, shape, spec) -> tuple[int, ...]:
        """One device's shard of an array of ``shape`` under ``spec``: a dim
        split over n devices takes ceil(dim / n) (XLA pads the last
        shard)."""
        if len(spec) > len(shape):
            raise ValueError(f"spec {spec} has more entries than {shape}")
        out = list(shape)
        for i, entry in enumerate(spec):
            n = self.size(entry)
            out[i] = -(-out[i] // n)
        return tuple(out)

    @contextmanager
    def fake_group(self):
        """Rank 0 of a ``fake`` process group of ``n_devices`` ranks (no
        peer, no payload moved: every collective returns at once) and the
        plan's ``DeviceMesh`` over it: ``with plan.fake_group() as grid:``
        gives a :class:`FakeRank`.  The mesh's group along each axis is a
        ``new_group`` described by the axis' name (``"data"``,
        ``"model"``), as :func:`make_grid_mesh`'s ranks describe theirs.
        The group is torn down on exit, also after an error; another
        process group may not be live."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        # registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if dist.is_initialized():
            raise RuntimeError("a process group is live already")
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=self.n_devices)
        try:
            groups = {}
            for i, axis in enumerate(self.axes):
                stride = 1
                for s in self.shape[i + 1:]:
                    stride *= s
                groups[axis] = dist.new_group(
                    [k * stride for k in range(self.shape[i])],
                    group_desc=axis)
            ranks = torch.arange(self.n_devices).reshape(self.shape)
            mesh = DeviceMesh.from_group([groups[a] for a in self.axes],
                                         "cuda", mesh=ranks,
                                         mesh_dim_names=self.axes)
            yield FakeRank(self, mesh, groups)
        finally:
            dist.destroy_process_group()


@dataclass(frozen=True)
class FakeRank:
    """Rank 0 of a :meth:`MeshPlan.fake_group`: the plan, its
    ``DeviceMesh`` and the group along each axis."""

    plan: MeshPlan
    device_mesh: object
    groups: dict

    def expert_parallel(self):
        """Rank (0, 0)'s ``models.expert_parallel.EPRank`` on the plan's
        ``data`` and ``model`` axes, its ``Comm`` on the meta device (no
        host staging; each collective still issued)."""
        from repro_torch.core.halo import Comm
        from repro_torch.models.expert_parallel import EPRank

        return EPRank(data=self.plan.size("data"),
                      model=self.plan.size("model"), d=0, m=0,
                      data_group=self.groups["data"],
                      model_group=self.groups["model"],
                      comm=Comm(torch.device("meta")))


def make_production_mesh(*, multi_pod: bool = False,
                         shape: tuple[int, ...] | None = None) -> MeshPlan:
    """``(16, 16)`` ``("data", "model")``, or with ``multi_pod`` ``(2, 16,
    16)`` ``("pod", "data", "model")``; ``shape`` asks for another of
    two or three axes, named alike."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None:
        raise ValueError(f"a production mesh has 2 or 3 axes, got {shape}")
    return MeshPlan(tuple(int(s) for s in shape), axes)


@dataclass(frozen=True)
class PinnMesh:
    """``n_sub`` ranks on one host: their store directory, device type and
    collective timeout."""

    n_sub: int
    store_dir: str
    device: str = "cuda"
    timeout_s: float = TIMEOUT_S

    @property
    def backend(self) -> str:
        return BACKEND

    def rank_device(self, rank: int) -> torch.device:
        """Every rank's device: ``cuda:0`` (shared) or the CPU."""
        return torch.device("cuda", 0) if self.device == "cuda" \
            else torch.device("cpu")


def make_pinn_mesh(n_sub: int, store_dir: str, device=None,
                   timeout_s: float = TIMEOUT_S) -> PinnMesh:
    """The process group's plan for ``n_sub`` ranks; ``device`` None means
    the card (raises when there is none: no quiet CPU run)."""
    dev = resolve_device(device)
    if n_sub < 1:
        raise ValueError(f"n_sub must be >= 1, got {n_sub}")
    os.makedirs(store_dir, exist_ok=True)
    return PinnMesh(n_sub=n_sub, store_dir=os.path.abspath(store_dir),
                    device=dev.type, timeout_s=float(timeout_s))


@dataclass(frozen=True)
class GridMesh:
    """``data x model`` ranks on one host (model innermost), with the store
    directory, device type and collective timeout of :class:`PinnMesh`."""

    data: int
    model: int
    store_dir: str
    device: str = "cuda"
    timeout_s: float = TIMEOUT_S

    @property
    def n_sub(self) -> int:
        return self.data * self.model

    @property
    def backend(self) -> str:
        return BACKEND

    def rank_device(self, rank: int) -> torch.device:
        return PinnMesh.rank_device(self, rank)

    def coords(self, rank: int) -> tuple[int, int]:
        """(d, m) of a rank."""
        return divmod(rank, self.model)


@dataclass(frozen=True)
class GridRank:
    """One rank's place in a :class:`GridMesh` and its two groups: what a
    rank's body gets from :func:`run_ranks` in the mesh's place."""

    mesh: GridMesh
    rank: int
    data_group: object
    model_group: object

    @property
    def device(self) -> torch.device:
        return self.mesh.rank_device(self.rank)

    def expert_parallel(self):
        """This rank's ``models.expert_parallel.EPRank``: its coordinates,
        its two groups and a ``core.halo.Comm`` on its device."""
        from repro_torch.core.halo import Comm
        from repro_torch.models.expert_parallel import EPRank

        d, m = self.mesh.coords(self.rank)
        return EPRank(data=self.mesh.data, model=self.mesh.model, d=d, m=m,
                      data_group=self.data_group,
                      model_group=self.model_group, comm=Comm(self.device))


def make_grid_mesh(data: int, model: int, store_dir: str, device=None,
                   timeout_s: float = TIMEOUT_S) -> GridMesh:
    """The plan of a ``data x model`` grid of ranks; ``device`` as in
    :func:`make_pinn_mesh`."""
    dev = resolve_device(device)
    if data < 1 or model < 1:
        raise ValueError(f"a grid needs data, model >= 1, got {data} x "
                         f"{model}")
    os.makedirs(store_dir, exist_ok=True)
    return GridMesh(data=int(data), model=int(model),
                    store_dir=os.path.abspath(store_dir), device=dev.type,
                    timeout_s=float(timeout_s))


def _init_grid(mesh: GridMesh, rank: int) -> GridRank:
    """Every data and model group of the grid (each rank makes all of
    them, in one order, as ``new_group`` asks), and this rank's two."""
    import torch.distributed as dist

    D, M = mesh.data, mesh.model
    d, m = mesh.coords(rank)
    data_groups = [dist.new_group([dd * M + mm for dd in range(D)],
                                  group_desc="data") for mm in range(M)]
    model_groups = [dist.new_group([dd * M + mm for mm in range(M)],
                                   group_desc="model") for dd in range(D)]
    return GridRank(mesh=mesh, rank=rank, data_group=data_groups[m],
                    model_group=model_groups[d])


def _rank_main(rank: int, mesh: PinnMesh, store: str, out_dir: str, fn,
               args) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    # every rank lives on this host: gloo's pairs go over the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        BACKEND, store=dist.FileStore(store, mesh.n_sub), rank=rank,
        world_size=mesh.n_sub,
        timeout=datetime.timedelta(seconds=mesh.timeout_s))
    try:
        if mesh.device == "cuda":
            torch.cuda.set_device(mesh.rank_device(rank))
        first = _init_grid(mesh, rank) if isinstance(mesh, GridMesh) else mesh
        result = fn(first, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    except BaseException:
        # kept for the parent: the first rank to fail is the cause, the
        # others usually fail in a collective after it
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(mesh: PinnMesh | GridMesh, fn, *args, deadline_s: float | None = None
              ) -> list:
    """Run ``fn(mesh, *args)`` on every rank of ``mesh``, each in its own
    process inside the initialised group; returns the ranks' return values
    in rank order (they cross by ``torch.save``: keep them on the CPU).
    On a :class:`GridMesh`, ``fn`` gets the rank's :class:`GridRank` in
    the mesh's place.

    ``fn`` must be importable by name (a module-level function).  When a
    rank fails, the others are stopped and ``RuntimeError`` carries every
    failed rank's traceback; with ``deadline_s`` a run that outlasts it
    raises ``TimeoutError`` after stopping every rank.
    On a card, build the kernels in the caller first
    (``repro_torch.kernels.native.build()``): ranks that find no library
    would each run ``nvcc``."""
    import torch.multiprocessing as mp

    tag = uuid.uuid4().hex[:12]
    store = os.path.join(mesh.store_dir, f"store-{tag}")
    out_dir = os.path.join(mesh.store_dir, f"ranks-{tag}")
    os.makedirs(out_dir)
    ctx = mp.start_processes(_rank_main,
                             args=(mesh, store, out_dir, fn, args),
                             nprocs=mesh.n_sub, join=False,
                             start_method="spawn")
    t_end = None if deadline_s is None else time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=0.5):
            if t_end is not None and time.monotonic() > t_end:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{mesh.n_sub} ranks outlasted "
                                   f"{deadline_s} s; stopped")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        errs = [open(os.path.join(out_dir, f)).read()
                for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
        raise RuntimeError(f"{len(errs)} of {mesh.n_sub} ranks failed:\n"
                           + "\n".join(errs)) from e
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(mesh.n_sub)]
