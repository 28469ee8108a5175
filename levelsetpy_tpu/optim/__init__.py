"""Proximal / primal-dual optimization: ADMM lasso and Chambolle-Pock TV.

Replacement for the reference's ``Optimization/`` tower
(``admm.py``: lasso ADMM with over-relaxation and soft-thresholding;
``champock.py``: Chambolle-Pock primal-dual total-variation solver).  The
reference iterates host-side with numpy; here the iteration is a
``lax.scan`` inside jit — fixed trip count, fully fused updates, history
captured on-device.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["admm_lasso", "chambolle_pock_tv", "soft_threshold"]


def soft_threshold(x: jnp.ndarray, kappa) -> jnp.ndarray:
    """Shrinkage operator (ref ``Optimization/admm.py:107``)."""
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - kappa, 0.0)


class AdmmResult(NamedTuple):
    x: jnp.ndarray
    z: jnp.ndarray
    objective: jnp.ndarray     # per-iteration lasso objective
    r_norm: jnp.ndarray        # primal residual history
    s_norm: jnp.ndarray        # dual residual history


def admm_lasso(
    a: jnp.ndarray,
    b: jnp.ndarray,
    lam: float,
    rho: float = 1.0,
    alpha: float = 1.0,
    n_iters: int = 200,
) -> AdmmResult:
    """Lasso ``min 1/2||Ax-b||^2 + lam ||x||_1`` by ADMM with over-relaxation
    ``alpha`` (ref ``Optimization/admm.py:15,32,96``).

    The (A^T A + rho I) factorisation is computed once (Cholesky) and reused
    every iteration — one triangular solve pair per step, all on device.
    """
    m, n = a.shape
    atb = a.T @ b
    lhs = a.T @ a + rho * jnp.eye(n, dtype=a.dtype)
    chol = jax.scipy.linalg.cho_factor(lhs)

    def step(carry, _):
        x, z, u = carry
        x = jax.scipy.linalg.cho_solve(chol, atb + rho * (z - u))
        x_hat = alpha * x + (1 - alpha) * z
        z = soft_threshold(x_hat + u, lam / rho)
        u = u + x_hat - z
        obj = 0.5 * jnp.sum((a @ x - b) ** 2) + lam * jnp.sum(jnp.abs(z))
        r = jnp.linalg.norm(x - z)
        s = rho * jnp.linalg.norm(z)  # relative dual scale per reference
        return (x, z, u), (obj, r, s)

    z0 = jnp.zeros((n,), a.dtype)
    (x, z, _), (obj, r, s) = jax.lax.scan(
        step, (z0, z0, z0), None, length=n_iters)
    return AdmmResult(x=x, z=z, objective=obj, r_norm=r, s_norm=s)


class CpkResult(NamedTuple):
    image: jnp.ndarray
    gap: jnp.ndarray           # primal-dual objective history


def _grad2d(u):
    gx = jnp.diff(u, axis=0, append=u[-1:, :])
    gy = jnp.diff(u, axis=1, append=u[:, -1:])
    return gx, gy


def _div2d(px, py):
    dx = jnp.concatenate([px[:1], px[1:-1] - px[:-2], -px[-2:-1]], axis=0)
    dy = jnp.concatenate([py[:, :1], py[:, 1:-1] - py[:, :-2],
                          -py[:, -2:-1]], axis=1)
    return dx + dy


def chambolle_pock_tv(
    f: jnp.ndarray,
    lam: float = 0.1,
    n_iters: int = 100,
    tau: float = 0.25,
    sigma: float = 0.25,
    theta: float = 1.0,
) -> CpkResult:
    """ROF total-variation denoising ``min_u lam TV(u) + 1/2||u - f||^2`` by
    the Chambolle-Pock primal-dual algorithm
    (ref ``Optimization/champock.py:6,42`` with its ``cpk_*`` helpers fused
    into one scan step): dual ascent on p via the gradient operator,
    proximal descent on u, over-relaxation ``theta``."""
    def step(carry, _):
        u, u_bar, px, py = carry
        gx, gy = _grad2d(u_bar)
        px = px + sigma * gx
        py = py + sigma * gy
        mag = jnp.maximum(1.0, jnp.sqrt(px ** 2 + py ** 2) / lam)
        px, py = px / mag, py / mag
        u_old = u
        u = (u + tau * _div2d(px, py) + tau * f) / (1.0 + tau)
        u_bar = u + theta * (u - u_old)
        gx, gy = _grad2d(u)
        primal = (lam * jnp.sum(jnp.sqrt(gx ** 2 + gy ** 2))
                  + 0.5 * jnp.sum((u - f) ** 2))
        return (u, u_bar, px, py), primal

    z = jnp.zeros_like(f)
    (u, _, _, _), gap = jax.lax.scan(
        step, (f, f, z, z), None, length=n_iters)
    return CpkResult(image=u, gap=gap)
