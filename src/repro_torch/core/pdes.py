"""PDE definitions for the paper's computational experiments (§7).

PyTorch counterpart of the reference package's ``core/pdes.py``: the same
dataclasses (same fields, so a bundle's PDE spec crosses between the two
packages) with

* the per-point ``residual`` / ``flux`` oracles, built from forward-mode AD
  (:func:`dir_deriv` / :func:`dir_deriv2` through ``torch.func.jvp``) on a
  single-point closure ``u_fn: (dim,) -> (n_fields,)``; the loss layer maps
  them over points and subdomains with ``torch.func.vmap`` (the
  ``residual_path="jvp"`` oracle of the trainers);
* the batched derivative-bundle interface the fused path and the serving
  engine assemble flux / residual from;
* the training data: ``boundary_data`` (and ``interior_data`` for the
  inverse problem) on numpy points, as in the reference.

Shapes of the bundle interface, with any leading batch axes (``...``, e.g.
the stacked subdomain axis): x (..., n, dim); u (..., n, n_fields);
du, d2u (..., dim, n, n_fields) with d2u the DIAGONAL second derivatives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

Fn = Callable[[torch.Tensor], torch.Tensor]


def dir_deriv(u_fn: Fn, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """First directional derivative d/de u(x + e v)."""
    return torch.func.jvp(u_fn, (x,), (v.to(x.dtype),))[1]


def dir_deriv2(u_fn: Fn, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Second directional derivative (forward-over-forward)."""
    v = v.to(x.dtype)
    g = lambda y: torch.func.jvp(u_fn, (y,), (v,))[1]
    return torch.func.jvp(g, (x,), (v,))[1]


def _basis(x: torch.Tensor, i: int) -> torch.Tensor:
    """Unit vector e_i shaped, typed and placed like the point x (built on
    the device alone, so a CUDA graph can capture it)."""
    return (torch.arange(x.shape[-1], device=x.device) == i).to(x.dtype)


class PDE:
    name: str = "pde"
    input_dim: int
    n_fields: int
    n_eq: int

    # Directions whose SECOND derivative the residual actually consumes
    # (None = all).  The bundle evaluators prune the second-order tangent
    # stream to these directions; pruned rows of d2u are exact zeros.
    d2_dirs: tuple[int, ...] | None = None

    def residual(self, u_fn: Fn, x) -> torch.Tensor:  # (n_eq,)
        raise NotImplementedError

    def flux(self, u_fn: Fn, x) -> torch.Tensor:  # (n_eq, dim)
        raise NotImplementedError

    def boundary_data(self, pts: np.ndarray):
        """(values (n, n_fields), comp_mask (n, n_fields), keep (n,)) on
        candidate global-boundary points; comp_mask selects which components
        carry data."""
        raise NotImplementedError

    def residual_from_derivs(self, x, u, du, d2u):  # (..., n, n_eq)
        raise NotImplementedError

    def flux_from_derivs(self, x, u, du):  # (..., n, n_eq, dim)
        raise NotImplementedError

    @classmethod
    def supports_derivs(cls) -> bool:
        """True when the batched bundle methods are overridden."""
        return (cls.residual_from_derivs is not PDE.residual_from_derivs
                and cls.flux_from_derivs is not PDE.flux_from_derivs)

    def exact(self, pts: np.ndarray) -> np.ndarray | None:
        return None


def _d(t, j):
    """Row j of a (..., dim, n, F) derivative bundle -> (..., n, F)."""
    return t[..., j, :, :]


# ------------------------------------------------------------------ Burgers (1D+t)

@dataclass(frozen=True)
class Burgers1D(PDE):
    """u_t + u u_x = nu u_xx on x in [-1,1], t in [0,T];  coords = (x, t).

    u(x,0) = -sin(pi x); u(+-1,t) = 0 (paper eq. (10)/(12), nu = 0.01/pi).
    """

    nu: float = 0.01 / np.pi
    t_final: float = 1.0
    name: str = "burgers1d"
    input_dim: int = 2
    n_fields: int = 1
    n_eq: int = 1
    d2_dirs = (0,)  # u_xx only — no second time derivative in the residual

    def residual(self, u_fn, x):
        ex, et = _basis(x, 0), _basis(x, 1)
        u = u_fn(x)
        u_x = dir_deriv(u_fn, x, ex)
        u_t = dir_deriv(u_fn, x, et)
        u_xx = dir_deriv2(u_fn, x, ex)
        return u_t + u * u_x - self.nu * u_xx

    def flux(self, u_fn, x):
        # conservation form: d/dt u + d/dx (u^2/2 - nu u_x) = 0
        u = u_fn(x)
        u_x = dir_deriv(u_fn, x, _basis(x, 0))
        return torch.stack([0.5 * u * u - self.nu * u_x, u], dim=-1)  # (1, 2)

    def boundary_data(self, pts: np.ndarray):
        x, t = pts[:, 0], pts[:, 1]
        on_ic = np.isclose(t, 0.0, atol=1e-9)
        on_wall = np.isclose(np.abs(x), 1.0, atol=1e-9)
        vals = np.where(on_ic, -np.sin(np.pi * x), 0.0)[:, None]
        keep = (on_ic | on_wall).astype(np.float32)
        comp = np.ones((len(pts), 1), np.float32)
        return vals.astype(np.float32), comp, keep

    def residual_from_derivs(self, x, u, du, d2u):
        # u (..., n, 1); du/d2u (..., 2, n, 1): row 0 = d/dx, row 1 = d/dt
        return _d(du, 1) + u * _d(du, 0) - self.nu * _d(d2u, 0)

    def flux_from_derivs(self, x, u, du):
        fx = 0.5 * u * u - self.nu * _d(du, 0)
        return torch.stack([fx, u], dim=-1)  # (..., n, 1, 2)

    def exact(self, pts: np.ndarray) -> np.ndarray:
        """Cole-Hopf solution via Gauss-Hermite quadrature (validation oracle)."""
        he_x, he_w = np.polynomial.hermite.hermgauss(96)
        x, t = pts[:, 0], np.maximum(pts[:, 1], 1e-12)
        nu = self.nu
        eta = (2.0 * np.sqrt(nu * t))[:, None] * he_x[None, :]  # (n, q)
        y = x[:, None] - eta
        f = np.exp(-np.cos(np.pi * y) / (2 * np.pi * nu))
        num = (np.sin(np.pi * y) * f * he_w[None, :]).sum(axis=1)
        den = (f * he_w[None, :]).sum(axis=1)
        u = -num / den
        u = np.where(pts[:, 1] <= 1e-12, -np.sin(np.pi * x), u)
        return u[:, None].astype(np.float32)


# ------------------------------------------------------- steady Navier-Stokes (2D)

@dataclass(frozen=True)
class NavierStokes2D(PDE):
    """Steady incompressible NS, lid-driven cavity (paper §7.4, Re=100).

    fields = (u, v, p); equations = (x-mom, y-mom, mass); fluxes per Table 1.
    """

    re: float = 100.0
    lid_velocity: float = 1.0
    name: str = "ns2d"
    input_dim: int = 2
    n_fields: int = 3
    n_eq: int = 3

    def residual(self, u_fn, x):
        ex, ey = _basis(x, 0), _basis(x, 1)
        w = u_fn(x)                     # (3,) = u, v, p
        wx = dir_deriv(u_fn, x, ex)
        wy = dir_deriv(u_fn, x, ey)
        wxx = dir_deriv2(u_fn, x, ex)
        wyy = dir_deriv2(u_fn, x, ey)
        u, v = w[0], w[1]
        inv_re = 1.0 / self.re
        r_u = u * wx[0] + v * wy[0] + wx[2] - inv_re * (wxx[0] + wyy[0])
        r_v = u * wx[1] + v * wy[1] + wy[2] - inv_re * (wxx[1] + wyy[1])
        r_m = wx[0] + wy[1]
        return torch.stack([r_u, r_v, r_m])

    def flux(self, u_fn, x):
        w = u_fn(x)
        wx = dir_deriv(u_fn, x, _basis(x, 0))
        wy = dir_deriv(u_fn, x, _basis(x, 1))
        u, v, p = w[0], w[1], w[2]
        inv_re = 1.0 / self.re
        fx = torch.stack([u * u + p - inv_re * wx[0], u * v - inv_re * wx[1],
                          u])
        fy = torch.stack([u * v - inv_re * wy[0], v * v + p - inv_re * wy[1],
                          v])
        return torch.stack([fx, fy], dim=-1)  # (3, 2)

    def boundary_data(self, pts: np.ndarray):
        y = pts[:, 1]
        on_lid = np.isclose(y, 1.0, atol=1e-9)
        vals = np.zeros((len(pts), 3), np.float32)
        vals[:, 0] = np.where(on_lid, self.lid_velocity, 0.0)
        comp = np.zeros((len(pts), 3), np.float32)
        comp[:, 0] = comp[:, 1] = 1.0  # velocity Dirichlet; p unconstrained
        keep = np.ones((len(pts),), np.float32)
        return vals, comp, keep

    def residual_from_derivs(self, x, u, du, d2u):
        wx, wy, wxx, wyy = _d(du, 0), _d(du, 1), _d(d2u, 0), _d(d2u, 1)
        uu, vv = u[..., 0], u[..., 1]
        inv_re = 1.0 / self.re
        r_u = (uu * wx[..., 0] + vv * wy[..., 0] + wx[..., 2]
               - inv_re * (wxx[..., 0] + wyy[..., 0]))
        r_v = (uu * wx[..., 1] + vv * wy[..., 1] + wy[..., 2]
               - inv_re * (wxx[..., 1] + wyy[..., 1]))
        r_m = wx[..., 0] + wy[..., 1]
        return torch.stack([r_u, r_v, r_m], dim=-1)  # (..., n, 3)

    def flux_from_derivs(self, x, u, du):
        wx, wy = _d(du, 0), _d(du, 1)
        uu, vv, p = u[..., 0], u[..., 1], u[..., 2]
        inv_re = 1.0 / self.re
        fx = torch.stack([uu * uu + p - inv_re * wx[..., 0],
                          uu * vv - inv_re * wx[..., 1],
                          uu], dim=-1)
        fy = torch.stack([uu * vv - inv_re * wy[..., 0],
                          vv * vv + p - inv_re * wy[..., 1],
                          vv], dim=-1)
        return torch.stack([fx, fy], dim=-1)  # (..., n, 3, 2)


# ------------------------------------------- inverse heat conduction (variable K)

@dataclass(frozen=True)
class HeatConduction2D(PDE):
    """d/dx(K T_x) + d/dy(K T_y) = f,   f = 4 exp(-0.1 y)  (paper §7.6).

    fields = (T, K): TWO separate networks per subdomain.
    """

    name: str = "heat2d_inverse"
    input_dim: int = 2
    n_fields: int = 2
    n_eq: int = 1

    def residual(self, u_fn, x):
        ex, ey = _basis(x, 0), _basis(x, 1)
        w = u_fn(x)                     # (2,) = T, K
        wx = dir_deriv(u_fn, x, ex)
        wy = dir_deriv(u_fn, x, ey)
        wxx = dir_deriv2(u_fn, x, ex)
        wyy = dir_deriv2(u_fn, x, ey)
        K = w[1]
        r = (wx[1] * wx[0] + K * wxx[0] + wy[1] * wy[0] + K * wyy[0]
             - 4.0 * torch.exp(-0.1 * x[1]))
        return r[None]

    def flux(self, u_fn, x):
        w = u_fn(x)
        wx = dir_deriv(u_fn, x, _basis(x, 0))
        wy = dir_deriv(u_fn, x, _basis(x, 1))
        K = w[1]
        return torch.stack([K * wx[0], K * wy[0]], dim=-1)[None, :]  # (1, 2)

    def boundary_data(self, pts: np.ndarray):
        ex = self.exact(pts)
        comp = np.zeros((len(pts), 2), np.float32)
        comp[:, 0] = 1.0  # Dirichlet T on the boundary
        comp[:, 1] = 1.0  # K data available along the boundary (paper §7.6)
        keep = np.ones((len(pts),), np.float32)
        return ex, comp, keep

    def interior_data(self, pts: np.ndarray):
        """Inverse-problem observations: T known inside the domain, K
        unknown."""
        ex = self.exact(pts)
        comp = np.zeros((len(pts), 2), np.float32)
        comp[:, 0] = 1.0
        return ex, comp

    def residual_from_derivs(self, x, u, du, d2u):
        wx, wy, wxx, wyy = _d(du, 0), _d(du, 1), _d(d2u, 0), _d(d2u, 1)
        K = u[..., 1]
        r = (wx[..., 1] * wx[..., 0] + K * wxx[..., 0]
             + wy[..., 1] * wy[..., 0] + K * wyy[..., 0]
             - 4.0 * torch.exp(-0.1 * x[..., 1]))
        return r[..., None]  # (..., n, 1)

    def flux_from_derivs(self, x, u, du):
        K = u[..., 1]
        return torch.stack([K * _d(du, 0)[..., 0], K * _d(du, 1)[..., 0]],
                           dim=-1)[..., None, :]  # (..., n, 1, 2)

    def exact(self, pts: np.ndarray) -> np.ndarray:
        T = 20.0 * np.exp(-0.1 * pts[:, 1])
        K = 20.0 + np.exp(0.1 * pts[:, 1]) * np.sin(0.5 * pts[:, 0])
        return np.stack([T, K], axis=-1).astype(np.float32)


# --------------------------------------------------- 1-D compressible Euler (Sod)

@dataclass(frozen=True)
class Euler1D(PDE):
    """1-D compressible Euler equations in conservation form.

    coords = (x, t); fields U = (rho, rho*u, E); space-time flux rows
    (F(U), U):  F = (rho u,  rho u^2 + p,  u (E + p)),
    p = (gamma-1)(E - rho u^2 / 2).  IC: Sod shock tube.
    """

    gamma: float = 1.4
    t_final: float = 0.2
    name: str = "euler1d"
    input_dim: int = 2
    n_fields: int = 3
    n_eq: int = 3
    d2_dirs = ()  # first-order system: the bundle's d2u is never consumed

    def _flux_x(self, U):
        # constants as tensors of U's dtype: inside torch.func.jvp a Python
        # float combined with a 0-dim slice (one point's U) gives a float64
        # tangent; the forward values are the same either way
        c = U.new_tensor
        rho = U[..., 0]
        u = U[..., 1] / (rho + c(1e-8))
        p = c(self.gamma - 1.0) * (U[..., 2] - c(0.5) * rho * u * u)
        return torch.stack([U[..., 1], U[..., 1] * u + p, u * (U[..., 2] + p)],
                           dim=-1)

    def residual(self, u_fn, x):
        U_t = dir_deriv(u_fn, x, _basis(x, 1))
        F_x = dir_deriv(lambda y: self._flux_x(u_fn(y)), x, _basis(x, 0))
        return U_t + F_x

    def flux(self, u_fn, x):
        U = u_fn(x)
        return torch.stack([self._flux_x(U), U], dim=-1)  # (3, 2)

    def _sod_ic(self, x: np.ndarray) -> np.ndarray:
        left = x < 0.5
        rho = np.where(left, 1.0, 0.125)
        u = np.zeros_like(x)
        p = np.where(left, 1.0, 0.1)
        E = p / (self.gamma - 1.0) + 0.5 * rho * u * u
        return np.stack([rho, rho * u, E], axis=-1).astype(np.float32)

    def boundary_data(self, pts: np.ndarray):
        x, t = pts[:, 0], pts[:, 1]
        on_ic = np.isclose(t, 0.0, atol=1e-9)
        on_wall = np.isclose(x, 0.0, atol=1e-9) | np.isclose(x, 1.0, atol=1e-9)
        vals = self._sod_ic(x)  # walls keep the undisturbed IC for t <= 0.2
        keep = (on_ic | on_wall).astype(np.float32)
        comp = np.ones((len(pts), 3), np.float32)
        return vals, comp, keep

    def residual_from_derivs(self, x, u, du, d2u):
        # chain rule F_x = (dF/dU) U_x: the flux map is pointwise, so one
        # forward-mode product over the whole batch gives every point's F_x
        F_x = torch.func.jvp(self._flux_x, (u,), (_d(du, 0),))[1]
        return _d(du, 1) + F_x  # (..., n, 3)

    def flux_from_derivs(self, x, u, du):
        return torch.stack([self._flux_x(u), u], dim=-1)  # (..., n, 3, 2)


REGISTRY = {
    "burgers1d": Burgers1D,
    "ns2d": NavierStokes2D,
    "heat2d_inverse": HeatConduction2D,
    "euler1d": Euler1D,
}
