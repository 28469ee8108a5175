"""Tensor algebra: n-mode products, matricization, Kruskal/Tucker formats,
HOSVD and Tucker-ALS (HOOI) decompositions.

Replacement for the reference's ``Tensors/`` tower
(``class_tensor.py``, ``tensor_mat_mult.py``, ``matricize.py``,
``leading_vecs.py``, ``tucker_decomp.py``, ``class_tucker_als.py``,
``kronecker.py``).  The reference wraps arrays in a ``Tensor`` class and
hand-rolls unfoldings with permute/reshape loops (its ``tucker_decomp.py``
doesn't parse — ``np..rand`` syntax error — and ``kruskal_tensor_mat_mul.py``
is an empty ``__all__`` stub; survey §2.8).  Here everything is a pure
function on ``jnp`` arrays: n-mode products lower to ``jnp.einsum`` /
``dot_general`` — large batched matmuls that map straight onto the
matrix units — and decompositions run as fixed-iteration ``lax``-friendly
loops, jittable and differentiable.
"""
from __future__ import annotations

import string
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

__all__ = [
    "mode_n_product",
    "multi_mode_product",
    "matricize",
    "dematricize",
    "kron",
    "khatri_rao",
    "nvecs",
    "KruskalTensor",
    "TuckerTensor",
    "hosvd",
    "tucker_als",
    "cp_als",
]

_LETTERS = string.ascii_lowercase


def mode_n_product(x: jnp.ndarray, m: jnp.ndarray, mode: int,
                   transpose: bool = False) -> jnp.ndarray:
    """Mode-``mode`` tensor-matrix product ``X ×_n M``
    (ref ``tensor_mat_mult.py:16``): contracts tensor dim ``mode`` with the
    second (or first, if ``transpose``) axis of ``M``.

    Lowering: a single ``einsum`` → one matmul with the remaining axes
    batched; no explicit unfolding copies.
    """
    nd = x.ndim
    if not 0 <= mode < nd:
        raise ValueError(f"mode {mode} out of range for {nd}-d tensor")
    x_ax = _LETTERS[:nd]
    m_ax = ("z" + x_ax[mode]) if not transpose else (x_ax[mode] + "z")
    out_ax = x_ax.replace(x_ax[mode], "z")
    return jnp.einsum(f"{x_ax},{m_ax}->{out_ax}", x, m)


def multi_mode_product(x: jnp.ndarray, mats: Sequence[jnp.ndarray],
                       skip: int | None = None,
                       transpose: bool = False) -> jnp.ndarray:
    """Apply a matrix per mode (optionally skipping one) — the composite
    used by HOSVD/Tucker."""
    for mode, m in enumerate(mats):
        if mode == skip or m is None:
            continue
        x = mode_n_product(x, m, mode, transpose=transpose)
    return x


def matricize(x: jnp.ndarray, mode: int) -> jnp.ndarray:
    """Mode-``mode`` unfolding: shape ``(shape[mode], prod(other dims))``
    (ref ``matricize.py:15``, ``TenMat/class_tenmat.py``)."""
    return jnp.moveaxis(x, mode, 0).reshape(x.shape[mode], -1)


def dematricize(m: jnp.ndarray, shape: Sequence[int],
                mode: int) -> jnp.ndarray:
    """Inverse of :func:`matricize`."""
    shape = tuple(shape)
    rest = shape[:mode] + shape[mode + 1:]
    return jnp.moveaxis(m.reshape((shape[mode],) + rest), 0, mode)


def kron(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Kronecker product (ref ``kronecker.py``)."""
    return jnp.kron(a, b)


def khatri_rao(mats: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Column-wise Khatri-Rao product of matrices with equal column count."""
    r = mats[0].shape[1]
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, r)
    return out


def nvecs(x: jnp.ndarray, mode: int, r: int) -> jnp.ndarray:
    """Leading ``r`` eigenvectors of the mode-``mode`` unfolding's Gram
    matrix (ref ``leading_vecs.py:18``) — the HOSVD factor."""
    xn = matricize(x, mode)
    gram = xn @ xn.T
    w, v = jnp.linalg.eigh(gram)
    return v[:, ::-1][:, :r]


class KruskalTensor(NamedTuple):
    """CP format: ``sum_r weights[r] * outer(factors[0][:,r], ...)``
    (ref ``class_tensor.py:55``)."""

    weights: jnp.ndarray              # (R,)
    factors: tuple                    # each (shape[i], R)

    def to_dense(self) -> jnp.ndarray:
        nd = len(self.factors)
        x_ax = _LETTERS[:nd]
        terms = ",".join(f"{a}r" for a in x_ax)
        return jnp.einsum(f"r,{terms}->{x_ax}", self.weights, *self.factors)


class TuckerTensor(NamedTuple):
    """Tucker format: core contracted with per-mode factors
    (ref ``class_tucker_als.py:6``)."""

    core: jnp.ndarray
    factors: tuple                    # each (shape[i], rank[i])

    def to_dense(self) -> jnp.ndarray:
        # factors are (shape[i], rank[i]): expanding contracts the core's
        # rank dims with the factors' SECOND axes (transpose=False)
        return multi_mode_product(self.core, self.factors)


def hosvd(x: jnp.ndarray, ranks: Sequence[int]) -> TuckerTensor:
    """Truncated higher-order SVD (ref ``tucker_decomp.py`` intent /
    ``POD/_basis.py:20``): per-mode leading singular vectors, core by
    projection (``X x_n U_n^T`` -> transpose=True)."""
    factors = tuple(nvecs(x, n, r) for n, r in enumerate(ranks))
    core = multi_mode_product(x, factors, transpose=True)
    return TuckerTensor(core=core, factors=factors)


def tucker_als(x: jnp.ndarray, ranks: Sequence[int],
               n_iters: int = 25) -> TuckerTensor:
    """Tucker decomposition via HOOI / alternating least squares
    (ref ``tucker_decomp.py:7`` intent — the shipped file has syntax
    errors).  Fixed iteration count (jit-friendly); initialised by HOSVD."""
    nd = x.ndim
    tt = hosvd(x, ranks)
    factors = list(tt.factors)
    for _ in range(n_iters):
        for n in range(nd):
            y = multi_mode_product(x, factors, skip=n, transpose=True)
            factors[n] = nvecs(y, n, ranks[n])
    core = multi_mode_product(x, factors, transpose=True)
    return TuckerTensor(core=core, factors=tuple(factors))


def cp_als(x: jnp.ndarray, rank: int, n_iters: int = 50,
           seed: int = 0) -> KruskalTensor:
    """CP decomposition by alternating least squares (capability the
    reference stubs at ``kruskal_tensor_mat_mul.py`` — an empty ``__all__``
    file).  Fixed iterations, jittable."""
    nd = x.ndim
    keys = jax.random.split(jax.random.PRNGKey(seed), nd)
    factors = [jax.random.normal(k, (s, rank), dtype=x.dtype)
               for k, s in zip(keys, x.shape)]
    weights = jnp.ones((rank,), dtype=x.dtype)
    for _ in range(n_iters):
        for n in range(nd):
            # row-major unfolding: first remaining axis is slowest, matching
            # khatri_rao's ordering of the factor list as-is
            others = [f for i, f in enumerate(factors) if i != n]
            kr = khatri_rao(others)
            gram = jnp.ones((rank, rank), dtype=x.dtype)
            for i, f in enumerate(factors):
                if i != n:
                    gram = gram * (f.T @ f)
            xn = matricize(x, n)
            sol = jnp.linalg.solve(
                gram + 1e-10 * jnp.eye(rank, dtype=x.dtype),
                (xn @ kr).T).T
            norms = jnp.linalg.norm(sol, axis=0)
            norms = jnp.where(norms > 0, norms, 1.0)
            factors[n] = sol / norms
            weights = norms
    return KruskalTensor(weights=weights, factors=tuple(factors))
