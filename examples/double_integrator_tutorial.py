"""Tutorial: backward reachable tube for the double integrator, end to end.

The equivalent of the reference's canonical driver
(``Backups/main.py`` — Sylvia Herbert's BRS/BRT tutorial, which no longer
runs upstream): grid -> target -> system -> solve -> value query ->
optimal trajectory -> plots.

Run:  python examples/double_integrator_tutorial.py [--no-plots]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import (DoubleIntegrator, SchemeConfig, create_grid,
                            eval_u, optimal_trajectory, solve, sphere)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--n", type=int, default=101)
    args = ap.parse_args()

    # 1. grid
    grid = create_grid([-1.0, -1.0], [1.0, 1.0], args.n)
    # 2. target set: ball of radius 0.15 at the origin
    target = sphere(grid, center=[0.0, 0.0], radius=0.15,
                    dtype=jnp.float32)
    # 3. dynamics: x'' = u, |u| <= 1 (parking problem)
    system = DoubleIntegrator(u_max=1.0)
    # 4. solve the BRT over 0.8 s
    tau = jnp.linspace(0.0, 0.8, 9)
    res = solve(grid, system, target, tau,
                cfg=SchemeConfig(accuracy="veryHigh", rk_order=3),
                comp_method="minVOverTime", progress=True)
    print(f"solved in {int(res.steps)} RK steps")

    # 5. query: can we reach the target from (0.3, -0.2) within 0.8 s?
    x0 = jnp.array([0.3, -0.2])
    val = float(eval_u(grid, res.values[-1], x0))
    print(f"V(x0) = {val:+.4f}  ->  {'reachable' if val <= 0 else 'NOT reachable'}")

    # 6. extract the optimal trajectory
    traj = optimal_trajectory(grid, system, res.values, tau, x0)
    d = np.linalg.norm(np.asarray(traj.states), axis=-1)
    print(f"trajectory |x|: {d[0]:.3f} -> {d[-1]:.3f}")

    # 7. compare the tube against the analytic minimum time to reach
    xs = grid.mesh(jnp.float32)
    mttr = np.asarray(system.mttr(xs[0], xs[1]))
    inside = np.asarray(res.values[-1]) <= 0
    print(f"tube volume: {inside.mean():.3f} of the domain; "
          f"analytic mttr<=0.8 region: "
          f"{((mttr <= 0.8)).mean():.3f} (target radius adds margin)")

    if not args.no_plots:
        from levelsetpy_tpu.viz import plot_value_dashboard

        fig = plot_value_dashboard(grid, res.values[-1])
        out = pathlib.Path(__file__).parent / "double_integrator_brt.png"
        fig.savefig(out, dpi=110, bbox_inches="tight")
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
