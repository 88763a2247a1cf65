"""Vectorized point -> subdomain routing for arbitrary query clouds.

Training pre-assigns points to subdomains at sampling time; serving gets an
arbitrary cloud and must answer "which network(s) own each point" fast:

* :class:`~repro_torch.core.domain.CartesianDecomposition` — O(log n_cells)
  ``searchsorted`` index math per axis (the grid is a sorted edge array), no
  per-cell loop.
* :class:`~repro_torch.core.domain.PolygonDecomposition` — ONE vectorized
  crossing-number (even-odd) test over ALL polygons at once (the training-side
  ``_points_in_polygon`` runs per region, host-side), exactly the same
  edge arithmetic so routed ownership agrees bitwise with
  ``subdomain_contains``, plus a point-to-edge distance pass so points within
  ``tol`` of a shared edge are claimed by BOTH regions.

Interface semantics: a point claimed by >= 2 subdomains gets the XPINN-style
*averaged* (stitched) prediction in the engine, so the served field is
single-valued across interfaces (paper eq. 4).  Points claimed by nobody
(outside the domain) come back NaN with a diagnostic count.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.domain import (
    CartesianDecomposition, Decomposition, PolygonDecomposition,
)

# chunk size for the polygon edge-distance pass (bounds the (n_poly, Vmax, N)
# broadcast temporaries to a few MB regardless of query size)
_CHUNK = 16384


def _as_cloud(pts, dim: int) -> np.ndarray:
    """Validate a query cloud to (N, dim) float64 — a wrongly-shaped array
    must fail loudly, not be silently reinterpreted by a blind reshape."""
    pts = np.asarray(pts, np.float64)
    if pts.ndim == 1 and pts.shape[0] == dim:
        return pts[None, :]
    if pts.ndim != 2 or pts.shape[1] != dim:
        raise ValueError(f"query cloud must be (N, {dim}); got {pts.shape}")
    return pts


def _axis_cells(edges: np.ndarray, v: np.ndarray, tol: float):
    """Inclusive cell-index range [lo, hi] claiming each coordinate.

    Cell i spans [edges[i], edges[i+1]]; it claims v iff
    ``edges[i] - tol <= v <= edges[i+1] + tol`` — with tol=0 this is exactly
    the closed-interval test of ``CartesianDecomposition.subdomain_contains``
    (a coordinate ON an internal grid line claims both adjacent cells).
    Returns (lo, hi) int arrays; empty ranges (lo > hi) mean "outside".
    """
    n_cells = len(edges) - 1
    hi = np.searchsorted(edges, v + tol, side="right") - 1
    lo = np.searchsorted(edges, v - tol, side="left") - 1
    return np.maximum(lo, 0), np.minimum(hi, n_cells - 1)


def _cartesian_membership(dec: CartesianDecomposition, pts: np.ndarray,
                          tol: float) -> np.ndarray:
    x_lo, x_hi = _axis_cells(dec._xs, pts[:, 0], tol)
    y_lo, y_hi = _axis_cells(dec._ys, pts[:, 1], tol)
    ix = np.arange(dec.nx)[:, None]
    iy = np.arange(dec.ny)[:, None]
    in_x = (ix >= x_lo[None, :]) & (ix <= x_hi[None, :])     # (nx, N)
    in_y = (iy >= y_lo[None, :]) & (iy <= y_hi[None, :])     # (ny, N)
    # q = ix * ny + iy (paper eq. 7 rank map)
    return (in_x[:, None, :] & in_y[None, :, :]).reshape(dec.n_sub, len(pts))


def _padded_vertices(dec: PolygonDecomposition) -> np.ndarray:
    """(n_poly, Vmax, 2) vertex stack, short polygons padded by repeating the
    last vertex (degenerate zero-length edges contribute nothing to either the
    crossing-number or the edge-distance test)."""
    vmax = max(len(p) for p in dec.polygons)
    return np.stack([
        np.concatenate([p, np.repeat(p[-1:], vmax - len(p), axis=0)])
        for p in dec.polygons
    ])


def _polygon_membership(dec: PolygonDecomposition, pts: np.ndarray,
                        tol: float) -> np.ndarray:
    P = _padded_vertices(dec)                  # vertices i
    Q = np.roll(P, 1, axis=1)                  # vertices j (previous, cyclic)
    out = np.zeros((dec.n_sub, len(pts)), dtype=bool)
    xi, yi = P[..., 0][..., None], P[..., 1][..., None]   # (n_poly, Vmax, 1)
    xj, yj = Q[..., 0][..., None], Q[..., 1][..., None]
    ab = Q - P                                             # edge j -> i ... (n_poly, Vmax, 2)
    denom = (ab ** 2).sum(-1)                              # (n_poly, Vmax)
    for s in range(0, len(pts), _CHUNK):
        x, y = pts[s:s + _CHUNK, 0], pts[s:s + _CHUNK, 1]
        # identical per-edge arithmetic to domain._points_in_polygon (XOR is
        # order-independent, so the all-polygons reduce matches the sequential
        # per-region loop bitwise)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            cross = (yi > y) != (yj > y)
            slope = (xj - xi) * (y - yi) / (yj - yi + 1e-300) + xi
            contrib = cross & (x < slope)
        inside = np.logical_xor.reduce(contrib, axis=1)    # (n_poly, chunk)
        if tol > 0.0:
            # point-to-segment distance: claim the region when within tol of
            # any of its edges (shared edges -> both regions claim the point)
            ap = pts[s:s + _CHUNK][None, None, :, :] - P[:, :, None, :]
            t = (ap * ab[:, :, None, :]).sum(-1) / (denom + 1e-300)[..., None]
            t = np.clip(t, 0.0, 1.0)
            d = ap - t[..., None] * ab[:, :, None, :]
            near = ((d ** 2).sum(-1) <= tol * tol).any(axis=1)
            inside |= near
        out[:, s:s + _CHUNK] = inside
    return out


def membership_matrix(decomp: Decomposition, pts: np.ndarray,
                      tol: float = 0.0) -> np.ndarray:
    """(n_sub, N) bool claim matrix for a query cloud.

    With ``tol=0`` row q equals ``decomp.subdomain_contains(q, pts)`` (bitwise
    for both decomposition families); ``tol > 0`` widens every subdomain by
    ``tol`` so interface points are claimed by all adjacent regions.  Custom
    decomposition subclasses only support ``tol=0`` (per-region containment —
    there is no generic way to widen them), so interface averaging needs one
    of the two shipped families; pass ``tol=0`` explicitly to route/engine to
    opt into one-sided containment instead.
    """
    pts = _as_cloud(pts, decomp.dim)
    if isinstance(decomp, CartesianDecomposition):
        return _cartesian_membership(decomp, pts, tol)
    if isinstance(decomp, PolygonDecomposition):
        return _polygon_membership(decomp, pts, tol)
    if tol > 0.0:
        raise NotImplementedError(
            f"{type(decomp).__name__}: tol-widened membership (interface "
            "stitching) is only implemented for Cartesian/Polygon "
            "decompositions; pass tol=0 for plain containment routing")
    return np.stack([np.asarray(decomp.subdomain_contains(q, pts), bool)
                     for q in range(decomp.n_sub)])


@dataclass
class RoutedQuery:
    """A query cloud bucketed into per-subdomain segments (engine input).

    ``X`` is the padded (n_sub, m, dim) point tensor the fused entry consumes;
    ``rows``/``pt_idx`` map every claim back to its query point in the
    flattened (n_sub * m) row space; ``primary`` marks each point's FIRST
    claim (interface points carry one primary + extra claims to average).
    """

    pts: np.ndarray        # (N, dim) float64 — the original query cloud
    membership: np.ndarray  # (n_sub, N) bool
    claims: np.ndarray     # (N,) int — number of claiming subdomains
    owner: np.ndarray      # (N,) int32 — first claiming subdomain, -1 outside
    m: int                 # bucket size (max per-subdomain count, padded)
    X: np.ndarray          # (n_sub, m, dim) float32 — bucketed points
    rows: np.ndarray       # (R,) int64 — flattened (n_sub*m) row per claim
    pt_idx: np.ndarray     # (R,) int64 — query index per claim
    primary: np.ndarray    # (R,) bool — first claim of its point

    @property
    def n_unclaimed(self) -> int:
        return int((self.claims == 0).sum())


def route(decomp: Decomposition, pts: np.ndarray, tol: float = 1e-9,
          bucket: int = 64) -> RoutedQuery:
    """Assign a query cloud to subdomains and bucket it for the fused entry.

    ``bucket`` quantizes the per-subdomain segment length so repeated queries
    of similar size reuse one compiled engine program instead of recompiling
    per distinct point count.
    """
    pts = _as_cloud(pts, decomp.dim)
    mem = membership_matrix(decomp, pts, tol)
    claims = mem.sum(axis=0).astype(np.int64)
    owner = np.where(claims > 0, mem.argmax(axis=0), -1).astype(np.int32)

    counts = mem.sum(axis=1)
    m = max(bucket, int(-(-int(counts.max() or 1) // bucket) * bucket))
    n_sub = decomp.n_sub
    X = np.zeros((n_sub, m, decomp.dim), np.float32)
    rows_l, idx_l, prim_l = [], [], []
    for q in range(n_sub):
        idx_q = np.nonzero(mem[q])[0]
        k = len(idx_q)
        if k == 0:
            continue
        X[q, :k] = pts[idx_q]
        rows_l.append(q * m + np.arange(k, dtype=np.int64))
        idx_l.append(idx_q.astype(np.int64))
        prim_l.append(owner[idx_q] == q)
    cat = lambda ls, dt: (np.concatenate(ls) if ls else np.zeros((0,), dt))
    return RoutedQuery(
        pts=pts, membership=mem, claims=claims, owner=owner, m=m, X=X,
        rows=cat(rows_l, np.int64), pt_idx=cat(idx_l, np.int64),
        primary=cat(prim_l, bool),
    )
