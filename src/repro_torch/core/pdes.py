"""PDE definitions for the paper's computational experiments (§7).

PyTorch counterpart of the reference package's ``core/pdes.py``: the same
dataclasses (same fields, so a bundle's PDE spec crosses between the two
packages), with the batched derivative-bundle interface the serving engine
assembles flux / residual from.  The per-point forward-mode ``residual`` /
``flux`` oracles and the training data (``boundary_data`` /
``interior_data``) belong to the training path and are not part of this
package yet.

Shapes of the bundle interface, with any leading batch axes (``...``, e.g.
the stacked subdomain axis): x (..., n, dim); u (..., n, n_fields);
du, d2u (..., dim, n, n_fields) with d2u the DIAGONAL second derivatives.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


class PDE:
    name: str = "pde"
    input_dim: int
    n_fields: int
    n_eq: int

    # Directions whose SECOND derivative the residual actually consumes
    # (None = all).  The bundle evaluators prune the second-order tangent
    # stream to these directions; pruned rows of d2u are exact zeros.
    d2_dirs: tuple[int, ...] | None = None

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
        rho = U[..., 0]
        u = U[..., 1] / (rho + 1e-8)
        p = (self.gamma - 1.0) * (U[..., 2] - 0.5 * rho * u * u)
        return torch.stack([U[..., 1], U[..., 1] * u + p, u * (U[..., 2] + p)],
                           dim=-1)

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
