"""End-to-end solver tests: analytic golden oracles + solver features.

The key correctness gate (reference never automated it): the double
integrator's backward reachable tube boundary at horizon T equals the analytic
minimum-time-to-reach contour ``mttr(x) = T`` (``DynamicalSystems/
double_integrator.py:91-119``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from levelsetpy_tpu import (DoubleIntegrator, DubinsRel, SchemeConfig,
                            create_grid, cylinder, solve, sphere)
from levelsetpy_tpu.integration import integrate
from levelsetpy_tpu.terms import hj_rhs, precompute_alpha


def di_setup(n=101, dtype=jnp.float64):
    g = create_grid([-1.0, -1.0], [1.0, 1.0], n)
    sys = DoubleIntegrator(u_max=1.0)
    phi0 = sphere(g, center=[0.0, 0.0], radius=0.1, dtype=dtype)
    return g, sys, phi0


class TestDoubleIntegratorBRT:
    @pytest.mark.parametrize("accuracy,rk,tol", [
        ("first", 1, 0.12),
        ("eno2", 2, 0.05),
        ("veryHigh", 3, 0.04),
    ])
    def test_brt_matches_analytic_mttr(self, accuracy, rk, tol):
        """Sharp golden test against the analytic solution: by dynamic
        programming, the BRT of the target {mttr <= a} at horizon T is
        EXACTLY {mttr <= a + T}.  Check sign agreement of the computed value
        function against the analytic contour outside a resolution band."""
        g = create_grid([-1.0, -1.0], [1.0, 1.0], 101)
        sys = DoubleIntegrator(u_max=1.0)
        xs = g.mesh(jnp.float64)
        mttr = sys.mttr(xs[0], xs[1])
        a, T = 0.3, 0.4
        phi0 = mttr - a  # implicit target {mttr <= a}
        cfg = SchemeConfig(accuracy=accuracy, rk_order=rk)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, T, 5), cfg=cfg,
                    comp_method="minVOverTime")
        v = np.asarray(res.values[-1])
        m = np.asarray(mttr)
        x1, x2 = np.asarray(xs[0]), np.asarray(xs[1])
        inside = v <= 0
        must_in = m <= a + T - tol
        must_out = m >= a + T + tol
        # evaluate away from (a) the domain rim, where extrapolating BCs
        # pollute, and (b) the switching curve, where the analytic solution
        # has a gradient kink that LF dissipation smears (max-norm
        # convergence there is sublinear — standard HJ behavior)
        interior = np.zeros_like(v, dtype=bool)
        interior[5:-5, 5:-5] = True
        off_kink = np.abs(x1 + 0.5 * x2 * np.abs(x2)) > 0.2
        ok = interior & off_kink
        n_wrong_out = (inside & must_out & ok).sum()
        n_wrong_in = ((~inside) & must_in & ok).sum()
        assert n_wrong_in == 0, \
            f"{n_wrong_in} states reachable within T missing from the BRT"
        assert n_wrong_out == 0, \
            f"{n_wrong_out} unreachable states wrongly inside the BRT"
        if accuracy == "veryHigh":
            # direct value-error check away from the kink: V = mttr - (a+T)
            band = np.abs(m - (a + T)) < 0.2
            err = np.abs(v - (m - (a + T)))[band & ok].max()
            assert err < 0.06, f"value error {err:.3f} off the kink"

    def test_brt_grows_monotonically(self):
        g, sys, phi0 = di_setup(81)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 0.4, 5),
                    cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        vols = [(np.asarray(v) <= 0).mean() for v in res.values]
        assert all(b >= a - 1e-12 for a, b in zip(vols, vols[1:]))
        assert vols[-1] > vols[0]

    def test_min_over_time_never_increases(self):
        g, sys, phi0 = di_setup(51)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 0.3, 4),
                    cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        v = np.asarray(res.values)
        assert (v[1:] <= v[:-1] + 1e-10).all()

    def test_no_nans(self):
        g, sys, phi0 = di_setup(51)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 0.5, 3))
        assert np.isfinite(np.asarray(res.values)).all()


class TestSolverFeatures:
    def test_obstacle_masking(self):
        g, sys, phi0 = di_setup(61)
        obstacle = sphere(g, center=[0.5, 0.5], radius=0.2,
                          dtype=jnp.float64)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 0.5, 4),
                    obstacles=obstacle,
                    cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        v = np.asarray(res.values[-1])
        inside_obs = np.asarray(obstacle) < -0.05
        assert (v[inside_obs] > 0).all(), "BRT leaked into the obstacle"

    def test_zero_comp_method_freezes_outside(self):
        g, sys, phi0 = di_setup(61)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 0.3, 4),
                    comp_method="zero",
                    cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        v = np.asarray(res.values)
        assert (v[1:] <= v[:-1] + 1e-10).all()

    def test_min_with_v0(self):
        g, sys, phi0 = di_setup(41)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 0.2, 3),
                    comp_method="minVWithV0",
                    cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        assert (np.asarray(res.values[-1]) <= np.asarray(phi0) + 1e-10).all()

    def test_converge_stop(self):
        """Small target + long horizon: BRT fills reachable region then
        converges; solver should flag an early stop index."""
        g, sys, phi0 = di_setup(41)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 6.0, 25),
                    converge_threshold=1e-3,
                    cfg=SchemeConfig(accuracy="first", rk_order=1))
        assert int(res.stop_index) < 24
        # after stopping, the stack repeats the final slice
        v = np.asarray(res.values)
        np.testing.assert_allclose(v[-1], v[int(res.stop_index)])

    def test_stop_init(self):
        g, sys, phi0 = di_setup(61)
        x_query = jnp.array([0.3, 0.0])
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 3.0, 13),
                    stop_init=x_query,
                    cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        # the query state IS eventually reachable -> early stop triggers
        assert int(res.stop_index) < 12

    def test_save_all_false(self):
        g, sys, phi0 = di_setup(41)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 0.2, 5),
                    save_all=False,
                    cfg=SchemeConfig(accuracy="first", rk_order=1))
        assert res.values.shape == (1,) + g.shape

    def test_jaime_discounting_contracts(self):
        g, sys, phi0 = di_setup(41)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 0.2, 3),
                    discount_factor=0.999,
                    cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        assert np.isfinite(np.asarray(res.values)).all()


class TestAir3D:
    def test_air3d_brt_sanity(self):
        """71^3-lite air3D BRT: collision set grows backward in time and the
        value function stays finite (full parity vs the reference oracle is
        covered by the numpy-oracle tests)."""
        g = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi],
                        [31, 31, 31], periodic_dims=[2])
        target = cylinder(g, ignore_axes=[2], center=[0, 0, 0], radius=5.0,
                          dtype=jnp.float64)
        sys = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
        res = solve(g, sys, target, tau=jnp.linspace(0.0, 0.5, 3),
                    cfg=SchemeConfig(accuracy="veryHigh", rk_order=2),
                    comp_method="minVOverTime")
        v = np.asarray(res.values)
        assert np.isfinite(v).all()
        vol0 = (v[0] <= 0).mean()
        vol1 = (v[-1] <= 0).mean()
        assert vol1 > vol0  # tube grows

    def test_vmap_disturbance_sweep(self):
        """Batched solves over vehicle speeds — the BASELINE config #3
        pattern — must vmap cleanly."""
        g = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi],
                        [15, 15, 15], periodic_dims=[2])
        target = cylinder(g, ignore_axes=[2], center=[0, 0, 0], radius=5.0,
                          dtype=jnp.float64)

        def solve_one(ve):
            sys = DubinsRel(v_e=ve, v_p=5.0, w_bound=1.0)
            return solve(g, sys, target, tau=jnp.linspace(0.0, 0.2, 2),
                         cfg=SchemeConfig(accuracy="eno2", rk_order=2),
                         save_all=False).values

        out = jax.vmap(solve_one)(jnp.array([4.0, 5.0, 6.0]))
        assert out.shape == (3, 1) + g.shape
        assert np.isfinite(np.asarray(out)).all()


class TestIntegrator:
    def test_rk_orders_agree_on_smooth_problem(self):
        g, sys, phi0 = di_setup(61)
        xs = g.mesh_broadcastable(jnp.float64)
        outs = {}
        for rk in (1, 2, 3):
            cfg = SchemeConfig(accuracy="veryHigh", rk_order=rk,
                               factor_cfl=0.5)
            ab = precompute_alpha(g, sys, xs)
            rhs = lambda t, v: hj_rhs(g, cfg, sys, t, v, xs, ab)
            outs[rk] = integrate(rhs, 0.0, phi0, 0.1, factor_cfl=0.5,
                                 rk_order=rk).v
        d12 = float(jnp.max(jnp.abs(outs[1] - outs[2])))
        d23 = float(jnp.max(jnp.abs(outs[2] - outs[3])))
        assert d23 < d12  # higher order pairs agree better
        assert d12 < 0.05

    def test_integrate_reaches_target_time(self):
        g, sys, phi0 = di_setup(41)
        xs = g.mesh_broadcastable(jnp.float64)
        cfg = SchemeConfig(accuracy="first", rk_order=1)
        ab = precompute_alpha(g, sys, xs)
        rhs = lambda t, v: hj_rhs(g, cfg, sys, t, v, xs, ab)
        out = integrate(rhs, 0.0, phi0, 0.25, rk_order=1)
        assert abs(float(out.t) - 0.25) < 1e-6
        assert int(out.steps) > 1


class TestStopSetAndNoise:
    """stopSet early exits (ref hji_solver.py:250-266,687-703) and the
    Gaussian-noise trace-Hessian scheme (ref hji_solver.py:450-471)."""

    def test_stop_set_intersect_triggers(self):
        g, sys, phi0 = di_setup(61)
        # a small ball the growing BRT will touch well before the horizon
        stop = sphere(g, center=[0.35, 0.0], radius=0.05)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 3.0, 13),
                    stop_set_intersect=stop,
                    cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        assert int(res.stop_index) < 12
        # include (containment) needs the whole ball covered -> stops at the
        # same time or later than first touch
        res_inc = solve(g, sys, phi0, tau=jnp.linspace(0.0, 3.0, 13),
                        stop_set_include=stop,
                        cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        assert int(res_inc.stop_index) >= int(res.stop_index)

    def test_stop_set_never_touched(self):
        g, sys, phi0 = di_setup(41)
        # stop set outside the reachable region within a tiny horizon
        stop = sphere(g, center=[0.9, 0.9], radius=0.02)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 0.1, 3),
                    stop_set_intersect=stop,
                    cfg=SchemeConfig(accuracy="first", rk_order=1))
        assert int(res.stop_index) == 2

    def test_stop_set_validation(self):
        g, sys, phi0 = di_setup(21)
        with pytest.raises(ValueError):
            solve(g, sys, phi0, tau=jnp.linspace(0.0, 0.1, 3),
                  stop_set_include=phi0, stop_set_intersect=phi0)
        with pytest.raises(ValueError):
            solve(g, sys, phi0, tau=jnp.linspace(0.0, 0.1, 3),
                  stop_set_include=jnp.zeros((3, 3)))

    def test_gaussian_noise_diffuses(self):
        g, sys, phi0 = di_setup(41)
        tau = jnp.linspace(0.0, 0.3, 4)
        cfg = SchemeConfig(accuracy="eno2", rk_order=2)
        det = solve(g, sys, phi0, tau=tau, cfg=cfg, comp_method="none")
        noisy = solve(g, sys, phi0, tau=tau, cfg=cfg, comp_method="none",
                      noise_stddev=jnp.array([0.2, 0.2]))
        vd = np.asarray(det.values[-1])
        vn = np.asarray(noisy.values[-1])
        assert np.all(np.isfinite(vn))
        assert not np.allclose(vd, vn)
        # the diffusion term must tighten the CFL bound -> more RK steps
        assert int(noisy.steps) > int(det.steps)

    def test_noise_matrix_form_matches_diag(self):
        g, sys, phi0 = di_setup(31)
        tau = jnp.linspace(0.0, 0.2, 3)
        cfg = SchemeConfig(accuracy="first", rk_order=1)
        a = solve(g, sys, phi0, tau=tau, cfg=cfg,
                  noise_stddev=jnp.array([0.1, 0.3]))
        b = solve(g, sys, phi0, tau=tau, cfg=cfg,
                  noise_stddev=jnp.diag(jnp.array([0.1, 0.3])))
        np.testing.assert_allclose(np.asarray(a.values), np.asarray(b.values))


class TestVectorLevelSets:
    """Joint integration of multiple value functions under one shared CFL dt
    (the reference's vector level sets, ode_cfl_3.py:104-136) — here v is an
    arbitrary pytree."""

    def test_pytree_matches_single(self):
        g, sys, phi0 = di_setup(31)
        xs = g.mesh_broadcastable(phi0.dtype)
        from levelsetpy_tpu.terms import local_ops

        def rhs_one(t, v):
            return hj_rhs(g, SchemeConfig(accuracy="eno2"), sys, t, v, xs,
                          None, local_ops(g))

        def rhs_pair(t, vs):
            d0, sb0 = rhs_one(t, vs[0])
            d1, sb1 = rhs_one(t, vs[1])
            return (d0, d1), jnp.minimum(sb0, sb1)

        single = jax.jit(lambda v: integrate(rhs_one, 0.0, v, 0.2,
                                             rk_order=3))(phi0)
        pair = jax.jit(lambda v: integrate(rhs_pair, 0.0, (v, v + 1.0), 0.2,
                                           rk_order=3))((phi0))
        # same dynamics + same CFL bound: component 0 identical to the
        # standalone integration; component 1 = shifted input, same updates
        np.testing.assert_allclose(np.asarray(pair.v[0]),
                                   np.asarray(single.v), rtol=1e-10)
        assert int(pair.steps) == int(single.steps)
        assert np.all(np.isfinite(np.asarray(pair.v[1])))

    def test_shared_dt_respects_fastest_field(self):
        """A pair where one field needs a much smaller dt: the joint solve
        must take at least as many steps as the stiffer field alone."""
        g, sys, phi0 = di_setup(31)
        xs = g.mesh_broadcastable(phi0.dtype)
        from levelsetpy_tpu.terms import local_ops

        def rhs_slow(t, v):
            d, sb = hj_rhs(g, SchemeConfig(accuracy="first"), sys, t, v, xs,
                           None, local_ops(g))
            return d, sb

        def rhs_fast(t, v):
            d, sb = rhs_slow(t, v)
            return 5.0 * d, sb / 5.0

        def rhs_pair(t, vs):
            d0, sb0 = rhs_slow(t, vs[0])
            d1, sb1 = rhs_fast(t, vs[1])
            return (d0, d1), jnp.minimum(sb0, sb1)

        alone = jax.jit(lambda v: integrate(rhs_fast, 0.0, v, 0.1,
                                            rk_order=2))(phi0)
        joint = jax.jit(lambda v: integrate(rhs_pair, 0.0, (v, v), 0.1,
                                            rk_order=2))(phi0)
        assert int(joint.steps) >= int(alone.steps)


class TestRobustness:
    def test_nan_guard_freezes_and_flags(self):
        """A CFL-violating factor blows the scheme up (f32 overflows to inf
        within a few checkpoints); the guard must freeze the state at the
        last finite slice and report the interval."""
        g, sys, _ = di_setup(41)
        phi0 = sphere(g, center=[0.0, 0.0], radius=0.1, dtype=jnp.float32)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 50.0, 6),
                    comp_method="none",
                    cfg=SchemeConfig(accuracy="first", rk_order=1,
                                     factor_cfl=50.0))
        ni = int(res.nan_index)
        assert ni >= 0, "instability not detected"
        v = np.asarray(res.values)
        # every stored slice is finite (the guard froze before the blowup
        # slice was committed) and later slices repeat the frozen state
        assert np.isfinite(v).all()
        np.testing.assert_allclose(v[-1], v[ni])

    def test_nan_guard_clean_solve_reports_none(self):
        g, sys, phi0 = di_setup(31)
        res = solve(g, sys, phi0, tau=jnp.linspace(0.0, 0.2, 3),
                    cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        assert int(res.nan_index) == -1

    def test_kene_rejects_unsupported_comp(self):
        g, sys, phi0 = di_setup(21)
        with pytest.raises(ValueError, match="Kene"):
            solve(g, sys, phi0, tau=jnp.array([0.0, 0.1]),
                  discount_factor=0.9, discount_mode="Kene",
                  comp_method="minVOverTime", targets=phi0)


class TestIntegratorHooks:
    def test_terminal_event_sign_change_stops(self):
        """Integration must halt when the event value changes sign (ref
        odeCFL terminalEvent, ode_cfl_3.py:255-261)."""
        g, sys, phi0 = di_setup(41)
        xs = g.mesh_broadcastable(jnp.float64)
        from levelsetpy_tpu.terms import local_ops, precompute_alpha

        cfg = SchemeConfig(accuracy="eno2", rk_order=2)
        ab = precompute_alpha(g, sys, xs)
        rhs = lambda t, v: hj_rhs(g, cfg, sys, t, v, xs, ab, local_ops(g))
        # event: value at a nearby state crosses zero as the BRT grows
        probe = jnp.array([0.15, 0.0])
        from levelsetpy_tpu import eval_u

        event = lambda t, v: eval_u(g, v, probe)
        full = integrate(rhs, 0.0, phi0, 1.0, rk_order=2)
        stopped = integrate(rhs, 0.0, phi0, 1.0, rk_order=2,
                            terminal_event=event)
        assert int(stopped.steps) < int(full.steps)
        assert float(stopped.t) < 1.0
        # the event actually fired: probe value is (just) inside
        assert float(eval_u(g, stopped.v, probe)) <= 0.0

    def test_eval_u_extrapolate(self):
        g, sys, phi0 = di_setup(21)
        from levelsetpy_tpu import eval_u

        # linear field: extrapolation must be exact, clamping must stick
        xs = g.mesh(jnp.float64)
        v = 2.0 * xs[0] + 0.5 * xs[1]
        q = jnp.array([1.5, 0.0])  # outside [-1, 1]
        clamped = float(eval_u(g, v, q))
        extr = float(eval_u(g, v, q, extrapolate=True))
        assert abs(clamped - 2.0) < 1e-9
        assert abs(extr - 3.0) < 1e-9


class TestCheckCFL:
    """Opt-in CFL-violation diagnostic (ref ode_cfl_3.py:159-175)."""

    def test_warns_on_violation(self):
        import warnings as W

        # step bound collapses after the first substep: the dt chosen at
        # t=0 (from the large bound) grossly violates the second substep's
        # bound -> the reference-style warning must fire
        def rhs(t, v):
            bound = jnp.where(t > 0.0, 1e-4, 1.0)
            return -0.1 * v, bound

        phi0 = jnp.ones((8,))
        with W.catch_warnings(record=True) as rec:
            W.simplefilter("always")
            out = integrate(rhs, 0.0, phi0, 0.05, rk_order=2,
                            check_cfl=True)
            jax.block_until_ready(out.v)
            jax.effects_barrier()
        assert any("CFL violation" in str(w.message) for w in rec), \
            [str(w.message) for w in rec]

    def test_silent_when_satisfied(self):
        import warnings as W

        def rhs(t, v):
            return -0.1 * v, jnp.asarray(1.0)

        phi0 = jnp.ones((8,))
        with W.catch_warnings(record=True) as rec:
            W.simplefilter("always")
            out = integrate(rhs, 0.0, phi0, 0.05, rk_order=3,
                            check_cfl=True)
            jax.block_until_ready(out.v)
            jax.effects_barrier()
        assert not any("CFL violation" in str(w.message) for w in rec)

    def test_scheme_config_carries_flag(self):
        cfg = SchemeConfig(check_cfl=True)
        assert cfg.check_cfl and hash(cfg) != hash(SchemeConfig())


class TestOnCheckpoint:
    """Opt-in in-solve snapshot hook (ref hji_solver.py:731-836 per-step
    redraw, at tau-checkpoint frequency here)."""

    def test_callback_fires_per_interval(self):
        grid = create_grid([-1.0, -1.0], [1.0, 1.0], 21)
        sys_ = DoubleIntegrator(u_max=1.0)
        phi0 = sphere(grid, center=[0.0, 0.0], radius=0.3)
        snaps = []

        def hook(t, v):
            snaps.append((float(t), np.asarray(v).copy()))

        tau = jnp.linspace(0.0, 0.3, 4)
        res = solve(grid, sys_, phi0, tau,
                    cfg=SchemeConfig(accuracy="medium", rk_order=2),
                    on_checkpoint=hook)
        jax.block_until_ready(res.values)
        jax.effects_barrier()
        assert len(snaps) == 3
        ts = [t for t, _ in snaps]
        assert ts == sorted(ts)
        for (t, v), expect in zip(snaps, np.asarray(res.values[1:])):
            np.testing.assert_array_equal(v, expect)


class TestDefaultConfig:
    """A plain solve with the default ``SchemeConfig`` runs end to end."""

    def test_default_solve_runs(self):
        grid = create_grid([-1.0, -1.0], [1.0, 1.0], 21)
        phi0 = sphere(grid, center=[0.0, 0.0], radius=0.3)
        r = solve(grid, DoubleIntegrator(u_max=1.0), phi0,
                  jnp.array([0.0, 0.1]),
                  cfg=SchemeConfig(accuracy="medium", rk_order=2))
        assert np.isfinite(np.asarray(r.values)).all()
