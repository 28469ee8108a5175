"""Single-grid solver features checked against the independent numpy
reference (``benchmarks/numpy_ref.py``: same O&F algorithm, separate code
path, no import from the package).

Every case runs in float64 (tests/conftest.py) and must agree with the
reference to 1e-8 — the roundoff level ``tests/test_numpy_oracle.py`` sets
for the plain air3D solve — with the same RK step count.  The features:
comp methods, static and time-varying obstacles, targets, Jaime and Kene
discounting, the three WENO epsilon methods, RK1/2/3, global/local/
locallocal dissipation for analytic and for generic (costate-box) systems,
diagonal Gaussian noise, periodic and non-periodic axes, 2-D and 3-D grids,
and time-to-reach recording.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "benchmarks"))

from numpy_ref import (Air3DNumpy, DoubleIntegratorNumpy,  # noqa: E402
                       PursuitNumpy)

from levelsetpy_tpu import (DoubleIntegrator, DubinsRel,  # noqa: E402
                            SchemeConfig, create_grid, solve)
from levelsetpy_tpu.systems.base import System, register_system  # noqa: E402
from levelsetpy_tpu.terms import hj_rhs, local_ops, precompute_alpha  # noqa

LO, HI = [-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi]
TOL = 1e-8


@register_system
class GenericPursuit(System):
    """Dubins-relative dynamics WITHOUT any analytic alpha/Hamiltonian:
    exercises the generic 4-corner costate-box machinery (``System.alpha``
    default, ref generic_partial.py:42-51) end to end."""

    v_e: float = 5.0
    v_p: float = 5.0
    w_bound: float = 1.0

    n_states = 3

    def dynamics(self, t, x, u, d):
        we, wp = u[0], d[0]
        return (
            -self.v_e + self.v_p * jnp.cos(x[2]) + we * x[1],
            -self.v_p * jnp.sin(x[2]) - we * x[0],
            -wp - we,
        )

    def opt_control(self, t, x, p, mode):
        det = p[0] * x[1] - p[1] * x[0] - p[2]
        s = jnp.sign(det)
        return ((-s if mode == "min" else s) * self.w_bound,)

    def opt_disturbance(self, t, x, p, mode):
        s = jnp.sign(-p[2])
        return ((-s if mode == "min" else s) * self.w_bound,)


def air3d(shape, periodic_z=True, perturb=True, generic=False):
    """(numpy reference, grid, system, v0) for air3D on ``shape``; the
    perturbation makes every axis (theta included) carry data."""
    ref = (PursuitNumpy if generic else Air3DNumpy)(
        LO, HI, shape, periodic=(False, False, periodic_z))
    v0 = ref.target_cylinder(5.0)
    if perturb:
        x = ref.x
        v0 = v0 + 0.5 * np.sin(x[2]) * np.cos(0.3 * x[0]) * np.cos(0.2 * x[1])
    grid = create_grid(LO, HI, shape,
                       periodic_dims=[2] if periodic_z else [])
    system = GenericPursuit() if generic else DubinsRel(v_e=5.0, v_p=5.0,
                                                        w_bound=1.0)
    return ref, grid, system, v0


def run_both(ref, grid, system, v0, tau, cfg, comp="minVOverTime",
             obstacles=None, targets=None, discount=None,
             discount_mode="Jaime", noise=None, record_ttr=False,
             jax_noise=None):
    tau = np.asarray(tau, np.float64)
    kw = {}
    if obstacles is not None:
        kw["obstacles"] = jnp.asarray(obstacles)
    if targets is not None:
        kw["targets"] = jnp.asarray(targets)
    if discount is not None:
        kw.update(discount_factor=discount, discount_mode=discount_mode)
    if noise is not None:
        kw["noise_stddev"] = jnp.asarray(
            noise if jax_noise is None else jax_noise)
    r = solve(grid, system, jnp.asarray(v0), jnp.asarray(tau), cfg=cfg,
              comp_method=comp, record_ttr=record_ttr, **kw)
    n = ref.solve_tau(v0, tau, rk_order=cfg.rk_order, cfl=cfg.factor_cfl,
                      comp=comp, eps_method=cfg.epsilon_method,
                      dissipation=cfg.dissipation, obstacles=obstacles,
                      targets=targets, discount=discount,
                      discount_mode=discount_mode, noise=noise,
                      record_ttr=record_ttr, max_step=cfg.max_step)
    return r, n


def assert_match(r, n, atol=TOL):
    assert int(r.steps) == n["steps"], (int(r.steps), n["steps"])
    vals = np.asarray(r.values)
    assert np.isfinite(vals).all()
    np.testing.assert_allclose(vals, n["values"], rtol=0, atol=atol)


def cfg(**kw):
    base = dict(accuracy="veryHigh", rk_order=2)
    base.update(kw)
    return SchemeConfig(**base)


# ------------------------------------------------------------- RHS level
def _rhs_pair(ref, grid, system, v0, c):
    xs = grid.mesh_broadcastable(jnp.float64)
    ab = precompute_alpha(grid, system, xs)
    d, sb = hj_rhs(grid, c, system, 0.0, jnp.asarray(v0), xs, ab,
                   local_ops(grid))
    dn, sbn = ref.rhs_bound(v0, eps_method=c.epsilon_method)
    return np.asarray(d), float(sb), dn, sbn


@pytest.mark.parametrize("shape", [(24, 20, 16), (17, 13, 11)])
def test_rhs_matches_numpy(shape):
    ref, grid, system, v0 = air3d(shape)
    d, sb, dn, sbn = _rhs_pair(ref, grid, system, v0, cfg())
    np.testing.assert_allclose(d, dn, rtol=0, atol=TOL)
    np.testing.assert_allclose(sb, sbn, rtol=1e-12)


@pytest.mark.parametrize("eps", ["constant", "maxOverNeighbors"])
def test_rhs_epsilon_methods(eps):
    ref, grid, system, v0 = air3d((16, 16, 16))
    d, _, dn, _ = _rhs_pair(ref, grid, system, v0,
                            cfg(epsilon_method=eps))
    np.testing.assert_allclose(d, dn, rtol=0, atol=TOL)


def test_rhs_traced_system_params():
    """System parameters arriving as jit tracers and as vmap batch tracers
    give the reference's RHS for each parameter value."""
    ref4, grid, _, v0 = air3d((16, 16, 16))
    xs = grid.mesh_broadcastable(jnp.float64)

    def rhs_for(ve):
        system = DubinsRel(v_e=ve, v_p=5.0, w_bound=1.0)
        ab = precompute_alpha(grid, system, xs)
        return hj_rhs(grid, cfg(), system, 0.0, jnp.asarray(v0), xs, ab,
                      local_ops(grid))[0]

    ves = [4.0, 6.0]
    refs = [Air3DNumpy(LO, HI, (16, 16, 16), ve=ve).rhs(v0) for ve in ves]
    np.testing.assert_allclose(jax.jit(rhs_for)(4.0), refs[0], rtol=0,
                               atol=TOL)
    out_b = jax.vmap(rhs_for)(jnp.asarray(ves))
    for k in range(2):
        np.testing.assert_allclose(out_b[k], refs[k], rtol=0, atol=TOL)


def di2d(shape):
    ref = DoubleIntegratorNumpy([-1.0, -1.0], [1.0, 1.0], shape)
    x = ref.x
    v0 = (np.sqrt(x[0] ** 2 + x[1] ** 2) - 0.3
          + 0.2 * np.sin(3 * x[0]) * np.cos(2 * x[1]))
    grid = create_grid([-1.0, -1.0], [1.0, 1.0], shape)
    return ref, grid, DoubleIntegrator(u_max=1.0), v0


@pytest.mark.parametrize("shape", [(32, 32), (101, 101), (17, 13)])
def test_rhs_2d_matches_numpy(shape):
    ref, grid, system, v0 = di2d(shape)
    d, sb, dn, sbn = _rhs_pair(ref, grid, system, v0, cfg(rk_order=1))
    np.testing.assert_allclose(d, dn, rtol=0, atol=TOL)
    np.testing.assert_allclose(sb, sbn, rtol=1e-12)


# ----------------------------------------------------------- solve level
@pytest.mark.parametrize("rk_order", [1, 2, 3])
def test_solve_matches_numpy(rk_order):
    ref, grid, system, v0 = air3d((24, 20, 16))
    r, n = run_both(ref, grid, system, v0, np.linspace(0.0, 0.2, 3),
                    cfg(rk_order=rk_order))
    assert_match(r, n)


def test_constant_axis_initial_data():
    """A pure cylinder is constant along theta: that axis's maxOverGrid
    epsilon sits at its floor while the solve starts to vary along it.
    The solve must stay finite, grow the tube and match the reference."""
    ref, grid, system, v0 = air3d((20, 20, 16), perturb=False)
    r, n = run_both(ref, grid, system, v0, [0.0, 0.3], cfg())
    assert_match(r, n)
    assert (np.asarray(r.values[-1]) <= 0).mean() > (v0 <= 0).mean()


def test_ttr_nonperiodic_z():
    """Extrapolated (non-periodic) theta axis plus time-to-reach."""
    ref, grid, system, v0 = air3d((16, 16, 16), periodic_z=False)
    r, n = run_both(ref, grid, system, v0, [0.0, 0.2], cfg(),
                    record_ttr=True)
    assert_match(r, n)
    ttr, ttr_n = np.asarray(r.ttr), n["ttr"]
    assert (np.isfinite(ttr) == np.isfinite(ttr_n)).all()
    m = np.isfinite(ttr_n)
    np.testing.assert_allclose(ttr[m], ttr_n[m], rtol=0, atol=1e-7)


def test_2d_solve_matches_numpy():
    ref, grid, system, v0 = di2d((41, 41))
    r, n = run_both(ref, grid, system, v0, np.linspace(0.0, 0.2, 3), cfg())
    assert_match(r, n)


def test_solve_max_over_neighbors():
    ref, grid, system, v0 = air3d((20, 16, 16))
    r, n = run_both(ref, grid, system, v0, np.linspace(0.0, 0.2, 3),
                    cfg(epsilon_method="maxOverNeighbors"))
    assert_match(r, n)


@pytest.mark.parametrize("kind", ["local", "locallocal"])
def test_local_dissipation_analytic_system(kind):
    """DubinsRel's alpha ignores the costate box, so every dissipation
    kind is the reference's global LF."""
    ref, grid, system, v0 = air3d((20, 16, 16))
    r, n = run_both(ref, grid, system, v0, [0.0, 0.15],
                    cfg(dissipation=kind, epsilon_method="constant"))
    assert_match(r, n)


# ------------------------------------ generic (costate-box) systems
def assert_close_except_knife_edges(a, b, atol, outlier_atol, max_outliers):
    """Elementwise closeness that tolerates a few bang-bang knife-edge
    nodes: the generic alpha takes ``sign(det)`` of a derivative
    expression, and where det is within roundoff of zero the two
    implementations' association can flip the optimal control — an
    O(alpha) local dissipation difference on a measure-zero set."""
    diff = np.abs(np.asarray(a) - np.asarray(b))
    n_bad = int((diff > atol).sum())
    assert n_bad <= max_outliers, (n_bad, float(diff.max()))
    assert float(diff.max()) <= outlier_atol, float(diff.max())


def _costate_case(tau, atol=TOL, **kw):
    ref, grid, system, v0 = air3d((20, 16, 16), generic=True)
    assert not system.alpha_time_invariant
    noise = kw.pop("noise", None)
    r, n = run_both(ref, grid, system, v0, tau, cfg(**kw), noise=noise)
    assert int(r.steps) == n["steps"]
    scale = float(np.abs(n["values"]).max())
    assert_close_except_knife_edges(r.values, n["values"], atol,
                                    1e-3 * scale, max_outliers=5)
    return r


def test_costate_locallocal():
    _costate_case([0.0, 0.12], dissipation="locallocal",
                  epsilon_method="constant")


def test_costate_local_rk1():
    _costate_case(np.linspace(0.0, 0.06, 7), rk_order=1,
                  dissipation="local", epsilon_method="constant")


def test_costate_local_full_solve():
    _costate_case(np.linspace(0.0, 0.3, 4), dissipation="local")


def test_costate_global():
    _costate_case([0.0, 0.1], dissipation="global")


def test_costate_one_long_interval():
    """One long interval from a theta-constant cylinder: the costate-box
    alphas (and the CFL bound) evolve from zero along theta, and the
    per-substep bound must track them."""
    ref, grid, system, v0 = air3d((16, 14, 12), perturb=False, generic=True)
    r, n = run_both(ref, grid, system, v0, [0.0, 1.5],
                    cfg(dissipation="locallocal", epsilon_method="constant"))
    assert int(r.steps) == n["steps"]
    scale = float(np.abs(n["values"]).max())
    assert_close_except_knife_edges(r.values, n["values"], TOL,
                                    1e-3 * scale, max_outliers=5)


def test_costate_with_epilogue():
    """Costate-box alphas with obstacle + running target + Jaime
    discount in the per-step epilogue."""
    ref, grid, system, v0 = air3d((20, 16, 16), generic=True)
    obstacle = ref.target_cylinder(3.0, center=(8.0, 4.0))
    target = ref.target_cylinder(4.0)
    r, n = run_both(ref, grid, system, v0, [0.0, 0.12],
                    cfg(dissipation="locallocal", epsilon_method="constant"),
                    comp="minVWithL", obstacles=obstacle, targets=target,
                    discount=0.95)
    assert int(r.steps) == n["steps"]
    scale = float(np.abs(n["values"]).max())
    assert_close_except_knife_edges(r.values, n["values"], TOL,
                                    1e-3 * scale, max_outliers=5)


def test_costate_with_noise():
    """Costate-box alphas plus diffusion: the step bound combines both
    parts every substep."""
    _costate_case([0.0, 0.5], dissipation="locallocal",
                  epsilon_method="constant", noise=[0.35, 0.3, 0.2])


# ------------------------------------------------------------------ noise
def test_noise_diagonal():
    ref, grid, system, v0 = air3d((20, 16, 16))
    sg = [0.3, 0.2, 0.1]
    r, n = run_both(ref, grid, system, v0, [0.0, 0.15],
                    cfg(epsilon_method="constant"), noise=sg)
    assert_match(r, n)
    r0, _ = run_both(ref, grid, system, v0, [0.0, 0.15],
                     cfg(epsilon_method="constant"))
    assert float(np.abs(np.asarray(r.values[-1] - r0.values[-1])).max()) \
        > 1e-3


def test_noise_matrix_form():
    """A full (nd, m) diffusion matrix that is diagonal is the vector
    form."""
    ref, grid, system, v0 = air3d((16, 14, 12))
    sg = [0.3, 0.2, 0.1]
    r, n = run_both(ref, grid, system, v0, [0.0, 0.1],
                    cfg(epsilon_method="constant"), noise=sg,
                    jax_noise=np.diag(sg))
    assert_match(r, n)


# ---------------------------------------------------- per-step epilogue
TAU3 = [0.0, 0.08, 0.16]


def _epi(shape=(16, 14, 16)):
    ref, grid, system, v0 = air3d(shape)
    # an off-center obstacle the growing tube actually hits
    obstacle = ref.target_cylinder(3.0, center=(8.0, 4.0))
    target = ref.target_cylinder(4.0)
    return ref, grid, system, v0, obstacle, target


def test_obstacle_static():
    ref, grid, system, v0, obs, _ = _epi()
    r, n = run_both(ref, grid, system, v0, TAU3,
                    cfg(epsilon_method="constant"), obstacles=obs)
    assert_match(r, n)
    # the obstacle must actually bite: some node inside it stays positive
    assert (np.asarray(r.values[-1])[obs < 0] > 0).any()


def test_obstacle_time_varying():
    ref, grid, system, v0, obs, _ = _epi()
    obs_tv = np.stack([obs + 0.5 * k for k in range(len(TAU3))])
    r, n = run_both(ref, grid, system, v0, TAU3,
                    cfg(epsilon_method="constant"), obstacles=obs_tv)
    assert_match(r, n)


@pytest.mark.parametrize("comp", ["minVWithV0", "maxVWithV0"])
def test_comp_with_v0(comp):
    ref, grid, system, v0, _, _ = _epi()
    r, n = run_both(ref, grid, system, v0, TAU3,
                    cfg(epsilon_method="constant"), comp=comp)
    assert_match(r, n)


@pytest.mark.parametrize("comp", ["minVWithL", "maxVWithL"])
def test_comp_with_target(comp):
    ref, grid, system, v0, _, tgt = _epi()
    r, n = run_both(ref, grid, system, v0, TAU3,
                    cfg(epsilon_method="constant"), comp=comp, targets=tgt)
    assert_match(r, n)


def test_jaime_discount_target_obstacle():
    ref, grid, system, v0, obs, tgt = _epi()
    r, n = run_both(ref, grid, system, v0, TAU3,
                    cfg(epsilon_method="constant"), comp="minVWithL",
                    targets=tgt, obstacles=obs, discount=0.95)
    assert_match(r, n)


def test_jaime_discount_v0_base():
    ref, grid, system, v0, _, _ = _epi()
    r, n = run_both(ref, grid, system, v0, TAU3,
                    cfg(epsilon_method="constant"), discount=0.9)
    assert_match(r, n)


def test_kene_discount():
    ref, grid, system, v0, _, tgt = _epi()
    r, n = run_both(ref, grid, system, v0, TAU3,
                    cfg(epsilon_method="constant"), comp="minVWithL",
                    targets=tgt, discount=0.9, discount_mode="Kene")
    assert_match(r, n)


def test_obstacle_max_over_grid_epsilon():
    ref, grid, system, v0, obs, _ = _epi()
    r, n = run_both(ref, grid, system, v0, TAU3, cfg(), obstacles=obs)
    assert_match(r, n)


# ------------------------------------------------------- feature matrix
MATRIX = [
    # (comp, eps_method, rk, obstacles?, targets?, discount)
    ("minVOverTime", "constant", 1, False, False, None),
    ("maxVOverTime", "constant", 3, True, False, None),
    ("none", "maxOverNeighbors", 2, True, False, None),
    ("minVWithV0", "constant", 2, True, False, 0.9),
    ("maxVWithL", "constant", 2, False, True, None),
    ("minVWithL", "maxOverNeighbors", 2, True, True, 0.95),
    ("set", "constant", 2, True, False, None),
    ("zero", "constant", 2, False, False, None),
]


@pytest.mark.parametrize("comp,eps,rk,use_obs,use_tgt,gamma", MATRIX)
def test_feature_matrix(comp, eps, rk, use_obs, use_tgt, gamma):
    ref, grid, system, v0, obs, tgt = _epi((14, 12, 16))
    r, n = run_both(ref, grid, system, v0, [0.0, 0.06, 0.12],
                    cfg(rk_order=rk, epsilon_method=eps), comp=comp,
                    obstacles=obs if use_obs else None,
                    targets=tgt if use_tgt else None, discount=gamma)
    assert_match(r, n)


# ---------------------------------------------------------- vector solve
def _reach_avoid(t, fields, fields_prev):
    return jnp.maximum(fields[0], -fields[1]), fields[1]


def test_coupled_reach_avoid_matches_numpy():
    """Two fields under one shared dt, each with its own comp method, the
    reach-avoid coupling after every step, and per-field time-to-reach."""
    from levelsetpy_tpu import solve_vector

    ref, grid, system, reach = air3d((16, 16, 16))
    avoid = ref.target_cylinder(3.0, center=(8.0, 4.0))
    tau = np.linspace(0.0, 0.2, 3)
    r = solve_vector(grid, system, (jnp.asarray(reach), jnp.asarray(avoid)),
                     jnp.asarray(tau), cfg=cfg(epsilon_method="constant"),
                     comp_methods=("minVOverTime", "none"),
                     coupling=_reach_avoid, record_ttr=True)
    kw = dict(eps_method="constant")
    fields = [reach, avoid]
    ttr = [np.where(f <= 0, 0.0, np.inf) for f in fields]
    stack, steps = [list(fields)], 0
    for i in range(len(tau) - 1):
        t, t1 = tau[i], tau[i + 1]
        small = 100 * np.finfo(np.float64).eps * abs(t1)
        while t < t1 - small:
            prev = list(fields)
            new = []
            for f in fields:
                f_new, t_new = ref.rk_step(f, t, t1, 2, 0.8, **kw)
                new.append(f_new)
            new[0] = np.minimum(new[0], prev[0])
            new[0] = np.maximum(new[0], -new[1])
            for k in range(2):
                crossed = (prev[k] > 0) & (new[k] <= 0) & np.isinf(ttr[k])
                denom = np.where(prev[k] != new[k], prev[k] - new[k], 1.0)
                ttr[k] = np.where(crossed,
                                  t + (t_new - t) * prev[k] / denom, ttr[k])
            fields, t = new, t_new
            steps += 1
        stack.append(list(fields))
    assert int(r.steps) == steps
    for k in range(2):
        np.testing.assert_allclose(np.asarray(r.values[k]),
                                   np.stack([s[k] for s in stack]), rtol=0,
                                   atol=TOL)
        m = np.isfinite(ttr[k])
        assert (np.isfinite(np.asarray(r.ttr[k])) == m).all()
        np.testing.assert_allclose(np.asarray(r.ttr[k])[m], ttr[k][m],
                                   rtol=0, atol=1e-7)
