"""Tensor-decomposition compression of a reachability value function.

Equivalent of the reference's tensor tutorials
(``Notes/tensors*.ipynb``; machinery from the reference's ``Tensors/`` —
``class_tensor.py:13``, ``tucker_decomp.py:7``, ``tensor_mat_mult.py:16``):
take the (time, x, y, theta) value-function stack of an air3D BRT solve,
compress it with HOSVD / Tucker-ALS / CP-ALS, and report compression ratio
vs reconstruction error — model-order reduction across BOTH space and time.

Run:  python examples/tensor_compression.py
(``JAX_PLATFORMS=cpu`` keeps it on the CPU when a GPU is present)
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid, cylinder,
                            solve)
from levelsetpy_tpu.tensors import (cp_als, hosvd,
                                    multi_mode_product, tucker_als)


def rel_err(x, y):
    return float(jnp.linalg.norm(x - y) / jnp.linalg.norm(x))


def main():
    grid = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi], 25,
                       periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], radius=5.0)
    system = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
    tau = jnp.linspace(0.0, 1.0, 21)
    res = solve(grid, system, target, tau,
                cfg=SchemeConfig(accuracy="veryHigh", rk_order=2),
                comp_method="minVOverTime")
    x = res.values                      # (21, 25, 25, 25) 4-way tensor
    full = x.size

    ranks = (5, 10, 10, 8)
    tk = hosvd(x, ranks)
    x_h = multi_mode_product(tk.core, tk.factors)
    stored = tk.core.size + sum(f.size for f in tk.factors)
    print(f"HOSVD      ranks={ranks}: {full / stored:6.1f}x compression, "
          f"rel err {rel_err(x, x_h):.3e}")

    tk2 = tucker_als(x, ranks, n_iters=10)
    x_t = multi_mode_product(tk2.core, tk2.factors)
    print(f"Tucker-ALS ranks={ranks}: {full / stored:6.1f}x compression, "
          f"rel err {rel_err(x, x_t):.3e}")

    r_cp = 24
    kt = cp_als(x, r_cp, n_iters=30)
    x_c = kt.to_dense()
    stored_cp = sum(f.size for f in kt.factors) + r_cp
    print(f"CP-ALS     rank={r_cp}:          {full / stored_cp:6.1f}x "
          f"compression, rel err {rel_err(x, x_c):.3e}")

    # sanity: zero level set of the compressed field still matches
    iou_num = float(((x <= 0) & (x_h <= 0)).sum())
    iou_den = float(((x <= 0) | (x_h <= 0)).sum())
    print(f"HOSVD zero-sublevel IoU vs truth: {iou_num / iou_den:.4f}")


if __name__ == "__main__":
    main()
