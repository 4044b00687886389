"""Gaussian-process surrogate for RIBBON's Bayesian optimisation (PyTorch).

Paper §4 design choices implemented here:

* **Matern 5/2 covariance kernel**, so that similar configurations get
  similar objective values.
* **Integer rounding inside the kernel** (Eq. 3): ``k'(x_i, x_j) =
  k(R(x_i), R(x_j))``, so the GP is piecewise-constant within an integer
  cell and the acquisition never proposes a point inside a sampled cell.
  The rounding works on raw instance counts; inputs are normalised to
  [0, 1] only after rounding.
* The lengthscale is picked from a small grid by the (masked) log marginal
  likelihood.  The grid is a batch dimension: the five Gram matrices are
  factored by one batched Cholesky.

Observation buffers are padded to ``max_obs`` rows with a mask, as in the
reference, so every fit has the same shapes.  Counterpart of
``repro/core/gp.py``; float32 throughout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device

SQRT5 = 2.2360679774997896

# Lengthscale candidates (in normalized [0,1] coordinates).
LS_GRID = (0.1, 0.2, 0.35, 0.5, 1.0)


def round_counts(x: torch.Tensor) -> torch.Tensor:
    """R(x): round raw instance counts to the nearest integer (Eq. 3)."""
    return torch.round(x)


def _scaled_sqdist(x1: torch.Tensor, x2: torch.Tensor,
                   lengthscale) -> torch.Tensor:
    """Pairwise squared distance after lengthscale division.  A lengthscale
    of shape (L, 1, 1) gives a leading batch dimension: (L, n, m)."""
    a = x1 / lengthscale
    b = x2 / lengthscale
    d = a[..., :, None, :] - b[..., None, :, :]
    return torch.sum(d * d, dim=-1)


def matern52(x1: torch.Tensor, x2: torch.Tensor, lengthscale,
             variance) -> torch.Tensor:
    """Matern 5/2 kernel matrix, shape (n, m), or (L, n, m) for a batch of
    lengthscales of shape (L, 1, 1)."""
    r2 = _scaled_sqdist(x1, x2, lengthscale)
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    return variance * (1.0 + SQRT5 * r + (5.0 / 3.0) * r2) * torch.exp(-SQRT5 * r)


def rounded_matern52(x1, x2, lengthscale, variance, denom) -> torch.Tensor:
    """k'(x1, x2) = matern52(R(x1)/denom, R(x2)/denom)  (paper Eq. 3)."""
    return matern52(round_counts(x1) / denom, round_counts(x2) / denom,
                    lengthscale, variance)


def _fit_predict(x_obs, y_obs, mask, x_query, lengthscale, variance, noise,
                 denom):
    """Masked GP posterior at ``x_query`` plus log marginal likelihood, for
    each of L lengthscales at once.

    x_obs:   (max_obs, d) raw counts (padded rows arbitrary)
    y_obs:   (max_obs,)   objective values (padded rows arbitrary)
    mask:    (max_obs,)   1.0 = real observation, 0.0 = padding
    x_query: (q, d)       raw counts to predict at
    lengthscale: (L,)     candidates, batched

    Returns mean (L, q), var (L, q) and lml (L,).  Padded rows get unit
    diagonal, zero off-diagonal and zero target in the Gram matrix, so they
    contribute nothing to the posterior or the likelihood.
    """
    n = x_obs.shape[0]
    ls = lengthscale.reshape(-1, 1, 1)
    m = mask.to(x_obs.dtype)
    outer = m[:, None] * m[None, :]
    eye = torch.eye(n, dtype=x_obs.dtype, device=x_obs.device)

    k_obs = rounded_matern52(x_obs, x_obs, ls, variance, denom)
    k_obs = k_obs * outer + eye * (1.0 - m) + eye * noise * m
    ybar = torch.sum(y_obs * m) / torch.clamp(torch.sum(m), min=1.0)
    y_c = (y_obs - ybar) * m

    chol = torch.linalg.cholesky(k_obs)                         # (L, n, n)
    rhs = y_c[:, None].expand(ls.shape[0], n, 1)
    alpha = torch.cholesky_solve(rhs, chol)                     # (L, n, 1)

    k_cross = rounded_matern52(x_obs, x_query, ls, variance, denom)
    k_cross = k_cross * m[:, None]                              # (L, n, q)
    mean = ybar + (k_cross.transpose(-1, -2) @ alpha)[..., 0]

    v = torch.linalg.solve_triangular(chol, k_cross, upper=False)
    var = torch.clamp(variance - torch.sum(v * v, dim=-2), min=1e-10)

    quad = -0.5 * torch.sum(y_c * alpha[..., 0], dim=-1)
    logdet = -torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                        dim=-1)
    n_eff = torch.sum(m)
    lml = quad + logdet - 0.5 * n_eff * math.log(2.0 * math.pi)
    return mean, var, lml


def gp_posterior(x_obs, y_obs, mask, x_query, denom):
    """Fit-and-predict with the grid-selected lengthscale.

    Returns (mean, std) at ``x_query`` (raw-count coordinates).
    """
    n_eff = torch.clamp(torch.sum(mask), min=1.0)
    ybar = torch.sum(y_obs * mask) / n_eff
    yvar = torch.sum(mask * (y_obs - ybar) ** 2) / n_eff
    variance = torch.clamp(yvar, min=1e-4)
    noise = 1e-4 * variance + 1e-6
    grid = torch.tensor(LS_GRID, dtype=x_obs.dtype, device=x_obs.device)
    means, variances, lmls = _fit_predict(x_obs, y_obs, mask, x_query, grid,
                                          variance, noise, denom)
    best = torch.argmax(lmls)
    return means[best], torch.sqrt(variances[best])


class GaussianProcess:
    """Stateful wrapper holding padded observation buffers.

    Observations are staged in host numpy buffers (``add`` is a plain array
    write) and uploaded to ``device`` at most once per fit, only when
    changed.
    """

    def __init__(self, n_dims: int, bounds, max_obs: int = 192, device=None):
        self.device = resolve_device(device)
        self.n_dims = n_dims
        self.max_obs = max_obs
        self.denom = torch.clamp(
            torch.as_tensor(bounds, dtype=torch.float32, device=self.device),
            min=1.0)
        self._x_host = np.zeros((max_obs, n_dims), dtype=np.float32)
        self._y_host = np.zeros((max_obs,), dtype=np.float32)
        self._mask_host = np.zeros((max_obs,), dtype=np.float32)
        self._dev: tuple | None = None   # (x, y, mask) device mirror
        self.n_obs = 0

    def add(self, x, y: float) -> None:
        if self.n_obs >= self.max_obs:
            raise RuntimeError(f"GP observation buffer full ({self.max_obs})")
        i = self.n_obs
        self._x_host[i] = np.asarray(x, dtype=np.float32)
        self._y_host[i] = float(y)
        self._mask_host[i] = 1.0
        self._dev = None
        self.n_obs += 1

    def buffers(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Device-resident (x, y, mask), uploading staged rows if needed."""
        if self._dev is None:
            self._dev = tuple(torch.tensor(a, device=self.device)
                              for a in (self._x_host, self._y_host,
                                        self._mask_host))
        return self._dev

    @property
    def x(self) -> torch.Tensor:
        return self.buffers()[0]

    @property
    def y(self) -> torch.Tensor:
        return self.buffers()[1]

    @property
    def mask(self) -> torch.Tensor:
        return self.buffers()[2]

    def predict(self, x_query) -> tuple[torch.Tensor, torch.Tensor]:
        xq = torch.as_tensor(np.asarray(x_query, dtype=np.float32),
                             device=self.device)
        x, y, mask = self.buffers()
        return gp_posterior(x, y, mask, xq, self.denom)

    def state_dict(self) -> dict:
        return {
            "x": self._x_host.copy(),
            "y": self._y_host.copy(),
            "mask": self._mask_host.copy(),
            "n_obs": self.n_obs,
        }

    def load_state_dict(self, state: dict) -> None:
        self._x_host = np.asarray(state["x"], dtype=np.float32).copy()
        self._y_host = np.asarray(state["y"], dtype=np.float32).copy()
        self._mask_host = np.asarray(state["mask"], dtype=np.float32).copy()
        self._dev = None
        self.n_obs = int(state["n_obs"])
