"""POD reduced-order model of a reachability value-function trajectory.

Equivalent of the reference's ``Notes/pod_rom.ipynb`` demo
(operator-inference workflow adapted from rom-operator-inference — see
the reference's ``POD/_basis.py:20``, ``_tikhonov.py:144``,
``_finite_difference.py:49``): take value-function snapshots from a real HJ
solve, build a POD basis, estimate reduced time derivatives, fit a linear
reduced operator by Tikhonov-regularised least squares, and compare the
ROM's re-integrated trajectory against the truth.

Run:  python examples/pod_rom.py
(``JAX_PLATFORMS=cpu`` keeps it on the CPU when a GPU is present)
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid, cylinder,
                            solve)
from levelsetpy_tpu.pod import (SolverTikhonov, cumulative_energy, pod_basis,
                                projection_error, xdot_uniform)


def main():
    # ---- 1. snapshots: a coarse air3D BRT solve saved at 41 checkpoints
    grid = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi], 25,
                       periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], radius=5.0)
    system = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
    n_snap, t_end = 41, 1.0
    tau = jnp.linspace(0.0, t_end, n_snap)
    res = solve(grid, system, target, tau,
                cfg=SchemeConfig(accuracy="veryHigh", rk_order=2),
                comp_method="minVOverTime")
    # snapshot matrix: one column per time (state dim x time)
    x = res.values.reshape(n_snap, -1).T

    # ---- 2. POD basis sized by cumulative energy
    vr, svals = pod_basis(x)
    r = int(cumulative_energy(svals, 0.9999))
    vr = vr[:, :r]
    err = float(projection_error(x, vr))
    print(f"POD basis: r={r} modes capture 99.99% energy; "
          f"projection error {err:.2e}")

    # ---- 3. reduced trajectories + finite-difference time derivatives
    xr = vr.T @ x                                   # (r, n_snap)
    dt = float(tau[1] - tau[0])
    xrdot = xdot_uniform(xr, dt, order=4)           # snapshots are columns

    # ---- 4. operator inference: fit xrdot ≈ A xr (linear ROM) by
    # Tikhonov-regularised least squares (fit once, solve at a given
    # regulariser — rom-operator-inference workflow)
    slv = SolverTikhonov().fit(xr.T, xrdot.T)
    a_op = slv.predict(1e-6).T                      # (r, r)

    # ---- 5. integrate the ROM (RK4) and compare against truth
    def rom_rhs(z):
        return a_op @ z

    z = xr[:, 0]
    zs = [z]
    for _ in range(n_snap - 1):
        k1 = rom_rhs(z)
        k2 = rom_rhs(z + 0.5 * dt * k1)
        k3 = rom_rhs(z + 0.5 * dt * k2)
        k4 = rom_rhs(z + dt * k3)
        z = z + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        zs.append(z)
    z_traj = jnp.stack(zs, axis=1)                  # (r, n_snap)
    x_rom = vr @ z_traj                             # lifted back

    rel = float(jnp.linalg.norm(x_rom - x) / jnp.linalg.norm(x))
    print(f"linear ROM (r={r}) relative trajectory error: {rel:.3%}")
    # the BRT converges toward a fixed set, so a linear ROM tracks it well
    final_rel = float(jnp.linalg.norm(x_rom[:, -1] - x[:, -1])
                      / jnp.linalg.norm(x[:, -1]))
    print(f"final-snapshot relative error: {final_rel:.3%}")


if __name__ == "__main__":
    main()
