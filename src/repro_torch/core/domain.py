"""Domain decomposition for cPINN/XPINN (paper §5.1, Fig 3).

The computational domain Omega is split into ``n_sub`` non-overlapping subdomains,
one per worker (paper: one MPI rank; here: one mesh device along the ``"sub"`` axis).

Two decomposition families are provided:

* :class:`CartesianDecomposition` — the paper's Fig 3 layout: an ``nx x ny`` grid of
  rectangular subdomains over a rectangle (used for Burgers space / space-time DD and
  the Navier-Stokes cavity).  The paper's rank map (eq. 7) ``(r_x, r_y) = (r//N, r%N)``
  is implemented as ``q = ix * ny + iy``.
* :class:`PolygonDecomposition` — arbitrary polygonal regions with exact shared edges
  (used for the §7.6 inverse heat-conduction problem on a 10-region irregular "map").

A :class:`Topology` is derived from the decomposition: interface edges are greedily
*edge-colored* so that every subdomain has at most one edge per color ("slot").  Each
slot then lowers to ONE ``jax.lax.ppermute`` in the distributed trainer — the TPU
analogue of the paper's non-blocking ``MPI.Isend/Irecv`` per direction, with ppermute's
zero-fill for untargeted devices reproducing ``MPI.PROC_NULL``.  For a Cartesian grid
the coloring yields <= 4 slots (the paper's S/E/N/W); for irregular maps it yields
<= max_degree + 1 slots (Vizing bound).

Interface points are sampled ONCE per undirected edge and shared verbatim by both
sides (paper: both ranks receive the same physical points), so exchanged buffers align
pointwise.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np


# --------------------------------------------------------------------------- edges

@dataclass(frozen=True)
class Edge:
    """An undirected interface between subdomains ``a`` and ``b`` (a < b).

    ``points``   (n_pts, dim) — shared physical interface points.
    ``normal_a`` (n_pts, dim) — unit normal pointing OUT of subdomain ``a``
                                (subdomain ``b``'s outward normal is ``-normal_a``).
    """

    a: int
    b: int
    points: np.ndarray
    normal_a: np.ndarray

    def __post_init__(self):
        assert self.a < self.b, "edges are stored with a < b"
        assert self.points.shape == self.normal_a.shape


# ----------------------------------------------------------------- decompositions

class Decomposition:
    """Base class: geometry queries used to build training point sets."""

    dim: int
    n_sub: int

    # -- geometry -------------------------------------------------------------
    def subdomain_contains(self, q: int, pts: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def sample_interior(self, q: int, n: int, rng: np.random.Generator) -> np.ndarray:
        """n i.i.d. points in the interior of subdomain q."""
        raise NotImplementedError

    def boundary_segments(self, q: int) -> list[tuple[np.ndarray, np.ndarray]]:
        """Segments (p0, p1) of the GLOBAL boundary owned by subdomain q."""
        raise NotImplementedError

    def interface_edges(self, n_iface: int) -> list[Edge]:
        """All undirected interfaces, each with ``n_iface`` shared points."""
        raise NotImplementedError

    def centroid(self, q: int) -> np.ndarray:
        raise NotImplementedError

    # -- helpers ----------------------------------------------------------------
    def sample_boundary(self, q: int, n: int, rng: np.random.Generator) -> np.ndarray:
        """~n points distributed over subdomain q's share of the global boundary.

        Returns (m, dim) with m in [0, n] (m = 0 for interior subdomains).
        """
        segs = self.boundary_segments(q)
        if not segs or n == 0:
            return np.zeros((0, self.dim))
        lens = np.array([np.linalg.norm(p1 - p0) for p0, p1 in segs])
        total = lens.sum()
        out = []
        for (p0, p1), ln in zip(segs, lens):
            k = max(1, int(round(n * ln / total)))
            t = (np.arange(k) + rng.uniform(0.2, 0.8, size=k)) / k
            out.append(p0[None, :] + t[:, None] * (p1 - p0)[None, :])
        pts = np.concatenate(out, axis=0)
        return pts[:n]


def _segment_points(p0: np.ndarray, p1: np.ndarray, n: int) -> np.ndarray:
    """n points uniformly spread over segment (p0,p1), excluding endpoints."""
    t = (np.arange(n) + 0.5) / n
    return p0[None, :] + t[:, None] * (p1 - p0)[None, :]


def _segment_normal(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """Unit normal of a 2-D segment, rotated -90 deg from its direction."""
    d = p1 - p0
    n = np.array([d[1], -d[0]])
    return n / (np.linalg.norm(n) + 1e-30)


class CartesianDecomposition(Decomposition):
    """nx x ny grid of rectangles over ``bounds = ((x0,x1),(y0,y1))``.

    Subdomain index: ``q = ix * ny + iy`` (paper eq. (7) with row-major rank map).
    For 1-D-in-space problems (Burgers) the second axis is time: a space-only cPINN
    decomposition uses ``ny = 1``; XPINN space-time uses ``ny > 1``.
    """

    def __init__(self, bounds: Sequence[Sequence[float]], nx: int, ny: int):
        (x0, x1), (y0, y1) = bounds
        self.bounds = ((float(x0), float(x1)), (float(y0), float(y1)))
        self.nx, self.ny = int(nx), int(ny)
        self.dim = 2
        self.n_sub = self.nx * self.ny
        self._xs = np.linspace(x0, x1, self.nx + 1)
        self._ys = np.linspace(y0, y1, self.ny + 1)

    # -- index maps (paper eq. 7) -------------------------------------------------
    def grid_index(self, q: int) -> tuple[int, int]:
        return q // self.ny, q % self.ny

    def rank(self, ix: int, iy: int) -> int:
        return ix * self.ny + iy

    def cell_bounds(self, q: int):
        ix, iy = self.grid_index(q)
        return (self._xs[ix], self._xs[ix + 1]), (self._ys[iy], self._ys[iy + 1])

    # -- Decomposition API ----------------------------------------------------------
    def subdomain_contains(self, q: int, pts: np.ndarray) -> np.ndarray:
        (xa, xb), (ya, yb) = self.cell_bounds(q)
        return (
            (pts[:, 0] >= xa) & (pts[:, 0] <= xb) & (pts[:, 1] >= ya) & (pts[:, 1] <= yb)
        )

    def sample_interior(self, q: int, n: int, rng: np.random.Generator) -> np.ndarray:
        (xa, xb), (ya, yb) = self.cell_bounds(q)
        u = rng.uniform(size=(n, 2))
        return np.stack([xa + u[:, 0] * (xb - xa), ya + u[:, 1] * (yb - ya)], axis=1)

    def centroid(self, q: int) -> np.ndarray:
        (xa, xb), (ya, yb) = self.cell_bounds(q)
        return np.array([(xa + xb) / 2, (ya + yb) / 2])

    def boundary_segments(self, q: int):
        ix, iy = self.grid_index(q)
        (xa, xb), (ya, yb) = self.cell_bounds(q)
        segs = []
        if ix == 0:
            segs.append((np.array([xa, ya]), np.array([xa, yb])))  # west wall
        if ix == self.nx - 1:
            segs.append((np.array([xb, ya]), np.array([xb, yb])))  # east wall
        if iy == 0:
            segs.append((np.array([xa, ya]), np.array([xb, ya])))  # south wall
        if iy == self.ny - 1:
            segs.append((np.array([xa, yb]), np.array([xb, yb])))  # north wall
        return segs

    def interface_edges(self, n_iface: int) -> list[Edge]:
        edges = []
        # vertical interfaces between (ix, iy) and (ix+1, iy): outward normal +x
        for ix in range(self.nx - 1):
            for iy in range(self.ny):
                x = self._xs[ix + 1]
                p0 = np.array([x, self._ys[iy]])
                p1 = np.array([x, self._ys[iy + 1]])
                pts = _segment_points(p0, p1, n_iface)
                nrm = np.tile(np.array([1.0, 0.0]), (n_iface, 1))
                edges.append(Edge(self.rank(ix, iy), self.rank(ix + 1, iy), pts, nrm))
        # horizontal interfaces between (ix, iy) and (ix, iy+1): outward normal +y
        for ix in range(self.nx):
            for iy in range(self.ny - 1):
                y = self._ys[iy + 1]
                p0 = np.array([self._xs[ix], y])
                p1 = np.array([self._xs[ix + 1], y])
                pts = _segment_points(p0, p1, n_iface)
                nrm = np.tile(np.array([0.0, 1.0]), (n_iface, 1))
                edges.append(Edge(self.rank(ix, iy), self.rank(ix, iy + 1), pts, nrm))
        return edges


class PolygonDecomposition(Decomposition):
    """Arbitrary polygonal regions with EXACT shared edges.

    ``polygons``: list of (n_vertices, 2) arrays, CCW order.  Two regions are
    neighbors iff they share one or more polygon edges (matched vertex pairs within
    tolerance); the interface polyline is the union of shared segments.  Polygon edges
    not shared by any pair form the global boundary.  Used for the paper's §7.6
    10-region irregular-map inverse problem.
    """

    def __init__(self, polygons: Sequence[np.ndarray], tol: float = 1e-9):
        self.polygons = [np.asarray(p, dtype=np.float64) for p in polygons]
        self.dim = 2
        self.n_sub = len(self.polygons)
        self.tol = tol
        self._classify_edges()

    @staticmethod
    def _poly_edges(poly: np.ndarray):
        n = len(poly)
        return [(poly[i], poly[(i + 1) % n]) for i in range(n)]

    def _edge_key(self, p0, p1):
        a = tuple(np.round(p0 / self.tol).astype(np.int64))
        b = tuple(np.round(p1 / self.tol).astype(np.int64))
        return (a, b) if a <= b else (b, a)

    def _classify_edges(self):
        owner: dict = {}
        self._shared: dict[tuple[int, int], list[tuple[np.ndarray, np.ndarray]]] = {}
        self._bnd: dict[int, list[tuple[np.ndarray, np.ndarray]]] = {q: [] for q in range(self.n_sub)}
        for q, poly in enumerate(self.polygons):
            for p0, p1 in self._poly_edges(poly):
                key = self._edge_key(p0, p1)
                if key in owner:
                    q0, e0 = owner.pop(key)
                    pair = (min(q0, q), max(q0, q))
                    # store segment oriented CCW w.r.t. the LOWER-indexed region
                    seg = e0 if q0 == pair[0] else (p0, p1)
                    self._shared.setdefault(pair, []).append(seg)
                else:
                    owner[key] = (q, (p0, p1))
        for key, (q, seg) in owner.items():
            self._bnd[q].append(seg)

    def subdomain_contains(self, q: int, pts: np.ndarray) -> np.ndarray:
        return _points_in_polygon(pts, self.polygons[q])

    def sample_interior(self, q: int, n: int, rng: np.random.Generator) -> np.ndarray:
        poly = self.polygons[q]
        lo, hi = poly.min(axis=0), poly.max(axis=0)
        out = np.zeros((0, 2))
        while len(out) < n:
            cand = rng.uniform(lo, hi, size=(max(4 * n, 64), 2))
            cand = cand[_points_in_polygon(cand, poly)]
            out = np.concatenate([out, cand], axis=0)
        return out[:n]

    def centroid(self, q: int) -> np.ndarray:
        return self.polygons[q].mean(axis=0)

    def boundary_segments(self, q: int):
        return [(np.asarray(p0), np.asarray(p1)) for p0, p1 in self._bnd[q]]

    def interface_edges(self, n_iface: int) -> list[Edge]:
        edges = []
        for (qa, qb), segs in sorted(self._shared.items()):
            lens = np.array([np.linalg.norm(p1 - p0) for p0, p1 in segs])
            total = lens.sum()
            pts_l, nrm_l = [], []
            # distribute n_iface points over the polyline proportionally to length
            alloc = np.maximum(1, np.round(n_iface * lens / total).astype(int))
            while alloc.sum() > n_iface:
                alloc[int(np.argmax(alloc))] -= 1
            while alloc.sum() < n_iface:
                alloc[int(np.argmax(lens / alloc))] += 1
            for (p0, p1), k in zip(segs, alloc):
                p0, p1 = np.asarray(p0), np.asarray(p1)
                pts_l.append(_segment_points(p0, p1, int(k)))
                nrm = _segment_normal(p0, p1)
                # orient outward from qa: segments are stored CCW w.r.t. qa, and the
                # -90 deg rotation of a CCW edge direction points out of the polygon.
                nrm_l.append(np.tile(nrm, (int(k), 1)))
            edges.append(Edge(qa, qb, np.concatenate(pts_l), np.concatenate(nrm_l)))
        return edges


def _points_in_polygon(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorized even-odd point-in-polygon test."""
    x, y = pts[:, 0], pts[:, 1]
    inside = np.zeros(len(pts), dtype=bool)
    n = len(poly)
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        cross = (yi > y) != (yj > y)
        slope = (xj - xi) * (y - yi) / (yj - yi + 1e-300) + xi
        inside ^= cross & (x < slope)
        j = i
    return inside


def us_map_decomposition(
    n_cols: int = 5, n_rows: int = 2, jitter: float = 0.22, seed: int = 0
) -> PolygonDecomposition:
    """A 10-region irregular polygonal 'map' (paper §7.6 uses the US map with 10
    regions; the exact shapefile is immaterial to the algorithm — what matters is
    irregular, partly non-convex subdomains with exactly-matching shared edges).

    Construction: an (n_cols x n_rows) lattice of jittered corner points, with each
    internal lattice edge subdivided by a jittered midpoint -> regions are irregular
    (often non-convex) octagons that tile ``[0, n_cols] x [0, n_rows]``.
    """
    rng = np.random.default_rng(seed)
    # lattice corners, jittered except on the outer boundary (keep a clean rectangle)
    corner = np.zeros((n_cols + 1, n_rows + 1, 2))
    for i in range(n_cols + 1):
        for j in range(n_rows + 1):
            p = np.array([float(i), float(j)])
            if 0 < i < n_cols:
                p[0] += rng.uniform(-jitter, jitter)
            if 0 < j < n_rows:
                p[1] += rng.uniform(-jitter, jitter)
            corner[i, j] = p

    def _mid(pa, pb, internal):
        m = (pa + pb) / 2
        if internal:  # jitter perpendicular to the edge -> non-convexity
            d = pb - pa
            nrm = np.array([d[1], -d[0]])
            nrm /= np.linalg.norm(nrm) + 1e-30
            m = m + nrm * rng.uniform(-jitter, jitter)
        return m

    # midpoints of horizontal and vertical lattice edges (shared between regions)
    hmid = {}  # edge ((i,j)-(i+1,j))
    for i in range(n_cols):
        for j in range(n_rows + 1):
            hmid[(i, j)] = _mid(corner[i, j], corner[i + 1, j], 0 < j < n_rows)
    vmid = {}  # edge ((i,j)-(i,j+1))
    for i in range(n_cols + 1):
        for j in range(n_rows):
            vmid[(i, j)] = _mid(corner[i, j], corner[i, j + 1], 0 < i < n_cols)

    polys = []
    for i in range(n_cols):
        for j in range(n_rows):
            polys.append(
                np.stack(
                    [
                        corner[i, j], hmid[(i, j)], corner[i + 1, j], vmid[(i + 1, j)],
                        corner[i + 1, j + 1], hmid[(i, j + 1)], corner[i, j + 1], vmid[(i, j)],
                    ]
                )
            )
    return PolygonDecomposition(polys)


# ------------------------------------------------------------------------ topology

@dataclass
class Topology:
    """Edge-colored communication topology (stacked, SPMD-ready numpy arrays).

    Slot semantics: in slot k every subdomain with an edge of color k exchanges its
    interface quantities with the neighbor across that edge — one ppermute per slot.
    Because colors are assigned to UNDIRECTED edges, both endpoints use the SAME slot
    for the same edge, so the received buffer aligns with the local slot-k points.
    """

    n_sub: int
    n_slots: int
    n_iface: int
    dim: int
    neighbor: np.ndarray      # (n_sub, K) int32, -1 where no edge
    edge_mask: np.ndarray     # (n_sub, K) float32
    iface_points: np.ndarray  # (n_sub, K, n_iface, dim) float
    iface_normal: np.ndarray  # (n_sub, K, n_iface, dim) outward from q
    perms: list[list[tuple[int, int]]]  # per slot: directed (src, dst) pairs

    @property
    def max_degree(self) -> int:
        return int((self.neighbor >= 0).sum(axis=1).max())


def build_topology(decomp: Decomposition, n_iface: int) -> Topology:
    """Greedy edge coloring -> slots; one ppermute per slot in the trainer."""
    edges = decomp.interface_edges(n_iface)
    used: list[set[int]] = [set() for _ in range(decomp.n_sub)]
    color_of: list[int] = []
    n_slots = 0
    for e in edges:
        c = 0
        while c in used[e.a] or c in used[e.b]:
            c += 1
        color_of.append(c)
        used[e.a].add(c)
        used[e.b].add(c)
        n_slots = max(n_slots, c + 1)
    n_slots = max(n_slots, 1)

    K, n, d = n_slots, decomp.n_sub, decomp.dim
    neighbor = np.full((n, K), -1, dtype=np.int32)
    edge_mask = np.zeros((n, K), dtype=np.float32)
    # default points: subdomain centroid (harmless filler for empty slots)
    pts = np.zeros((n, K, n_iface, d))
    for q in range(n):
        pts[q] = decomp.centroid(q)[None, None, :]
    nrm = np.zeros((n, K, n_iface, d))
    nrm[..., 0] = 1.0
    perms: list[list[tuple[int, int]]] = [[] for _ in range(K)]
    for e, c in zip(edges, color_of):
        neighbor[e.a, c], neighbor[e.b, c] = e.b, e.a
        edge_mask[e.a, c] = edge_mask[e.b, c] = 1.0
        pts[e.a, c] = pts[e.b, c] = e.points
        nrm[e.a, c] = e.normal_a
        nrm[e.b, c] = -e.normal_a
        perms[c].append((e.a, e.b))
        perms[c].append((e.b, e.a))
    return Topology(
        n_sub=n, n_slots=K, n_iface=n_iface, dim=d,
        neighbor=neighbor, edge_mask=edge_mask,
        iface_points=pts, iface_normal=nrm, perms=perms,
    )
