"""Batch-LAST sweeps (``solve_batch``) checked against a loop of
per-scenario ``solve`` calls: per-scenario CFL steps, early finishers,
comp methods, obstacles, targets, per-scenario Jaime discounts, Kene
discounting, the WENO epsilon methods, RK1/3, non-periodic axes and batch
sizes of any value.

The batch and the single-grid solve are different XLA programs, so the
comparison allows float64 roundoff (1e-9) rather than bitwise equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid, cylinder,
                            solve, solve_batch)
from levelsetpy_tpu.terms import (batched_ops, hj_rhs, local_ops,
                                  precompute_alpha)

LO, HI = [-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi]
ATOL = 1e-9


def sweep_system(n, w_spread=True):
    return DubinsRel(
        v_e=jnp.linspace(3.0, 7.0, n),
        v_p=5.0,
        w_bound=jnp.linspace(0.5, 2.0, n) if w_spread else 1.0)


def scenario(system, i):
    return jax.tree.map(
        lambda leaf: leaf[i] if getattr(leaf, "ndim", 0) else leaf, system)


def grid_target(shape=(14, 12, 16), periodic=True):
    grid = create_grid(LO, HI, shape, periodic_dims=[2] if periodic else [])
    return grid, cylinder(grid, ignore_axes=[2], radius=5.0,
                          dtype=jnp.float64)


def assert_batch_matches_loop(grid, system, v0, tau, cfg, n, per=None,
                              **kw):
    """``per(i)`` returns per-scenario solve kwargs (gamma, operands)."""
    rb = solve_batch(grid, system, v0, tau, cfg=cfg, **kw)
    vb = np.asarray(rb.values)
    assert vb.shape[-1] == n
    assert np.isfinite(vb).all()
    steps = []
    for i in range(n):
        kw_i = dict(kw)
        if per is not None:
            kw_i.update(per(i))
        v0_i = v0[..., i] if v0.ndim == grid.ndim + 1 else v0
        r = solve(grid, scenario(system, i), v0_i, tau, cfg=cfg, **kw_i)
        steps.append(int(r.steps))
        np.testing.assert_allclose(vb[..., i], np.asarray(r.values),
                                   rtol=0, atol=ATOL)
        if kw.get("record_ttr"):
            t_b, t_s = np.asarray(rb.ttr[..., i]), np.asarray(r.ttr)
            assert (np.isfinite(t_b) == np.isfinite(t_s)).all()
            m = np.isfinite(t_s)
            np.testing.assert_allclose(t_b[m], t_s[m], rtol=0, atol=ATOL)
    assert int(rb.steps) == max(steps), (int(rb.steps), steps)
    return rb, steps


# ------------------------------------------------------------- RHS level
def _batch_rhs_case(shape, eps_method):
    n = 6
    grid = create_grid(LO, HI, shape, periodic_dims=[2])
    xs3 = grid.mesh_broadcastable(jnp.float64)
    v = (cylinder(grid, ignore_axes=[2], radius=5.0, dtype=jnp.float64)
         + 0.5 * jnp.sin(xs3[2]) * jnp.cos(0.3 * xs3[0])
         * jnp.cos(0.2 * xs3[1]))
    # slightly different field per scenario along the trailing axis
    vb = v[..., None] + 0.01 * jnp.sin(jnp.arange(n, dtype=jnp.float64))
    system = sweep_system(n)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2,
                       epsilon_method=eps_method)
    xs = tuple(a[..., None] for a in xs3)
    ops = batched_ops(grid)
    ab = precompute_alpha(grid, system, xs, reduce_max=ops.reduce_max)
    d, sb = hj_rhs(grid, cfg, system, 0.0, vb, xs, ab, ops)
    assert d.shape == vb.shape and sb.shape == (n,)
    for i in range(n):
        s_i = scenario(system, i)
        ab_i = precompute_alpha(grid, s_i, xs3)
        d_i, sb_i = hj_rhs(grid, cfg, s_i, 0.0, vb[..., i], xs3, ab_i,
                           local_ops(grid))
        np.testing.assert_allclose(d[..., i], d_i, rtol=0, atol=ATOL)
        np.testing.assert_allclose(sb[i], sb_i, rtol=1e-12)


@pytest.mark.parametrize("shape", [(16, 16, 16), (15, 13, 11)])
def test_batch_rhs_matches_per_scenario(shape):
    _batch_rhs_case(shape, "maxOverGrid")


def test_batch_rhs_constant_epsilon():
    _batch_rhs_case((12, 12, 12), "constant")


# ----------------------------------------------------------- solve level
CFG = SchemeConfig(accuracy="veryHigh", rk_order=2)
CFG_C = SchemeConfig(accuracy="veryHigh", rk_order=2,
                     epsilon_method="constant")


def test_batch_solve_matches_loop():
    grid, target = grid_target()
    assert_batch_matches_loop(grid, sweep_system(6), target,
                              jnp.array([0.0, 0.15]), CFG, 6,
                              save_all=False)


def test_batch_solve_matches_loop_constant_eps():
    grid, target = grid_target()
    assert_batch_matches_loop(grid, sweep_system(6), target,
                              jnp.array([0.0, 0.15]), CFG_C, 6,
                              save_all=False)


def test_batch_arbitrary_size():
    """Any batch size: per-scenario outputs come back with the true B."""
    grid, target = grid_target()
    rb, _ = assert_batch_matches_loop(grid, sweep_system(5), target,
                                      jnp.array([0.0, 0.15]), CFG_C, 5,
                                      save_all=False)
    assert rb.changes.shape[-1] == 5 and rb.stop_index.shape == (5,)


@pytest.mark.parametrize("rk_order", [1, 3])
def test_batch_heterogeneous_dt(rk_order):
    """Strongly different speeds give different per-scenario step counts;
    early finishers freeze while the rest integrate."""
    grid, target = grid_target((12, 12, 16))
    system = DubinsRel(v_e=jnp.array([2.0, 2.0, 8.0, 8.0]), v_p=5.0,
                       w_bound=jnp.linspace(0.5, 2.0, 4))
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=rk_order)
    _, steps = assert_batch_matches_loop(
        grid, system, target, jnp.array([0.0, 0.12]), cfg, 4,
        save_all=False, record_ttr=True)
    assert min(steps) < max(steps)


def test_batch_nonperiodic_z():
    grid, _ = grid_target((12, 12, 14), periodic=False)
    xs3 = grid.mesh_broadcastable(jnp.float64)
    v0 = (cylinder(grid, ignore_axes=[2], radius=5.0, dtype=jnp.float64)
          + 0.4 * jnp.sin(xs3[2]) * jnp.cos(0.3 * xs3[0]))
    assert_batch_matches_loop(grid, sweep_system(4, w_spread=False), v0,
                              jnp.array([0.0, 0.1]), CFG, 4,
                              save_all=False)


def test_batch_per_scenario_initial_data():
    """A trailing-batched v0 (one field per scenario) and an odd B."""
    grid, target = grid_target((12, 12, 12))
    n = 7
    v0 = target[..., None] + 0.05 * jnp.arange(n, dtype=jnp.float64)
    assert_batch_matches_loop(grid, sweep_system(n, w_spread=False), v0,
                              jnp.array([0.0, 0.1]), CFG, n,
                              save_all=False)


def _epilogue_setup(n=5):
    grid, target = grid_target()
    obs = cylinder(grid, center=[8.0, 4.0, 0.0], ignore_axes=[2],
                   radius=3.0, dtype=jnp.float64)
    tgt = cylinder(grid, ignore_axes=[2], radius=4.0, dtype=jnp.float64)
    return grid, target, obs, tgt, sweep_system(n)


TAU3 = jnp.array([0.0, 0.08, 0.16])


def test_batch_obstacle():
    grid, target, obs, _, system = _epilogue_setup()
    assert_batch_matches_loop(grid, system, target, TAU3, CFG_C, 5,
                              obstacles=obs, save_all=False)


def test_batch_discount_target_per_scenario_gamma():
    """minVWithL + per-scenario Jaime discount + obstacle: frozen early
    finishers must skip the (non-idempotent) discount."""
    grid, target, obs, tgt, system = _epilogue_setup()
    gam = jnp.linspace(0.85, 0.99, 5)
    assert_batch_matches_loop(
        grid, system, target, TAU3, CFG_C, 5,
        per=lambda i: {"discount_factor": float(gam[i])},
        comp_method="minVWithL", targets=tgt, obstacles=obs,
        discount_factor=gam, save_all=False)


def test_batch_kene():
    grid, target, _, tgt, system = _epilogue_setup()
    assert_batch_matches_loop(grid, system, target, TAU3, CFG_C, 5,
                              comp_method="minVWithL", targets=tgt,
                              discount_factor=0.9, discount_mode="Kene",
                              save_all=False)


def test_batch_max_over_neighbors():
    grid, target = grid_target()
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2,
                       epsilon_method="maxOverNeighbors")
    assert_batch_matches_loop(grid, sweep_system(4), target,
                              jnp.array([0.0, 0.15]), cfg, 4,
                              save_all=False)


def test_batch_per_scenario_operands_odd_size():
    """Per-scenario (trailing-batched) obstacles and targets with a
    per-scenario discount and an odd batch size."""
    n = 3
    grid, target, obs, tgt, _ = _epilogue_setup(n)
    system = sweep_system(n)
    shift = 0.3 * jnp.arange(n, dtype=jnp.float64)
    obs_b = obs[..., None] + shift
    tgt_b = tgt[..., None] - shift
    gam = jnp.linspace(0.85, 0.99, n)
    assert_batch_matches_loop(
        grid, system, target, jnp.array([0.0, 0.1]), CFG_C, n,
        per=lambda i: {"discount_factor": float(gam[i]),
                       "obstacles": obs_b[..., i],
                       "targets": tgt_b[..., i]},
        comp_method="minVWithL", targets=tgt_b, obstacles=obs_b,
        discount_factor=gam, save_all=False)
