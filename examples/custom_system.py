"""Defining a CUSTOM dynamical system with no analytic dissipation bound.

Most users of the reference never write an analytic dissipation bound: they
implement ``dynamics`` + ``get_opt_u``/``get_opt_v`` and let
``genericPartial`` (``Hamiltonians/generic_partial.py:42-51``) bound
|dH/dp_i| by evaluating the dynamics at the four corners of the costate
box.  This example shows the same workflow here:

  1. subclass :class:`System` with ``dynamics``/``opt_control``/
     ``opt_disturbance`` ONLY (no ``alpha``, no ``hamiltonian``) — the
     generic optimal-control Hamiltonian and the 4-corner costate-box
     alpha come from the base class;
  2. pick a node-local dissipation (``dissipation="local"`` = LLF, the
     reference's production default, or ``"locallocal"``): the 4-corner
     alpha is then evaluated every RK substep from the node-local
     derivative boxes.

For direction-valued controls, return the unit vector
``(p_i/|p|, p_j/|p|)`` instead of an angle: no trig in the hot loop.

Run:  python examples/custom_system.py [--n 41] [--t-end 0.4]
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import SchemeConfig, create_grid, solve, sphere
from levelsetpy_tpu.systems.base import System, register_system


@register_system
class BoatInCurrent(System):
    """A boat with bounded speed fighting a shear current, plus a bounded
    adversarial drift — nothing about this system ships with the library.

    States (x, y, heading-proxy z in [-1, 1] is unused by the current but
    shows a 3-D solve):
        x' = u_x * v_max + c * tanh(y)      (shear current along x)
        y' = u_y * v_max + d
        z' = 0.2 * (x - z)
    Control (u_x, u_y) is a unit vector (|u| <= 1); disturbance |d| <= d_max.
    """

    v_max: float = 1.0
    c: float = 0.6
    d_max: float = 0.3

    n_states = 3
    u_mode = "min"      # control shrinks V (reach the target)
    d_mode = "max"      # disturbance grows V

    def dynamics(self, t, x, u, d):
        return (u[0] * self.v_max + self.c * jnp.tanh(x[1]),
                u[1] * self.v_max + d[0],
                0.2 * (x[0] - x[2]))

    def opt_control(self, t, x, p, mode):
        # argmin/argmax_u p . f over the unit disc: -/+ p/|p|
        r = jnp.sqrt(p[0] * p[0] + p[1] * p[1]) + 1e-30
        s = -1.0 if mode == "min" else 1.0
        return (s * p[0] / r, s * p[1] / r)

    def opt_disturbance(self, t, x, p, mode):
        s = jnp.sign(p[1])
        return ((s if mode == "max" else -s) * self.d_max,)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=41)
    ap.add_argument("--t-end", type=float, default=0.4)
    args = ap.parse_args()

    grid = create_grid([-2.0, -2.0, -1.0], [2.0, 2.0, 1.0], args.n)
    target = sphere(grid, center=[1.0, 1.0, 0.0], radius=0.3)
    system = BoatInCurrent()

    # LLF: node-local costate box for the active dim, grid-global box for
    # the others — the reference's production dissipation for generic
    # systems; the 4-corner bound is recomputed every substep.
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2,
                       dissipation="local")
    t0 = time.time()
    res = solve(grid, system, target, jnp.linspace(0.0, args.t_end, 5),
                cfg=cfg)
    v = np.asarray(res.values)
    print(f"solved {args.n}^3 BRT to T={args.t_end} in "
          f"{time.time() - t0:.2f}s ({int(res.steps)} RK steps)")
    frac = [(v[i] <= 0).mean() for i in range(v.shape[0])]
    print("tube volume fraction per checkpoint:",
          [f"{f:.4f}" for f in frac])
    assert np.isfinite(v).all()
    assert frac[-1] > frac[0], "backward reachable tube should grow"
    print("custom system OK")


if __name__ == "__main__":
    main()
