"""Vector level sets through the front door (`solve_vector`): joint
integration under one shared CFL dt must reproduce decoupled solves when
fields don't interact, and support coupled reach-avoid — single-device and
sharded (ref ode_cfl_3.py:104-136 list-valued integrator semantics)."""
import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import (DoubleIntegrator, DubinsRel, SchemeConfig,
                            create_grid, cylinder, solve, solve_vector,
                            sphere)
from levelsetpy_tpu.parallel import make_mesh, solve_vector_sharded


def _ra_coupling(t, fields, fields_prev):
    # reach-avoid: the reach set may never enter the avoid set
    return (jnp.maximum(fields[0], -fields[1]), fields[1])


class TestDecoupled:
    def test_matches_per_field_solve(self):
        """Same system per field -> same CFL bound -> the joint solve must
        equal each decoupled solve exactly."""
        g = create_grid([-6, -10, 0], [20, 10, 2 * np.pi], 15,
                        periodic_dims=[2])
        sys_ = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
        v0a = cylinder(g, ignore_axes=[2], radius=5.0, dtype=jnp.float64)
        v0b = cylinder(g, ignore_axes=[2], radius=3.0, dtype=jnp.float64)
        tau = jnp.linspace(0.0, 0.4, 3)
        cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)
        res = solve_vector(g, sys_, (v0a, v0b), tau, cfg=cfg,
                           comp_methods=("minVOverTime", "none"))
        ra = solve(g, sys_, v0a, tau, cfg=cfg, comp_method="minVOverTime")
        rb = solve(g, sys_, v0b, tau, cfg=cfg, comp_method="none")
        np.testing.assert_allclose(res.values[0], ra.values, atol=1e-12)
        np.testing.assert_allclose(res.values[1], rb.values, atol=1e-12)
        assert int(res.steps) == int(ra.steps) == int(rb.steps)
        np.testing.assert_allclose(res.changes[:, 0], ra.changes, atol=1e-12)

    def test_per_field_systems_share_min_dt(self):
        """Different systems: the shared dt is the min of the per-field
        bounds, so the joint solve takes at least as many steps as the
        slowest field alone."""
        g = create_grid([-2, -2], [2, 2], 21)
        fast = DoubleIntegrator(u_max=2.0)   # tighter CFL bound
        slow = DoubleIntegrator(u_max=0.5)
        v0 = sphere(g, radius=0.5, dtype=jnp.float64)
        tau = jnp.linspace(0.0, 0.5, 2)
        cfg = SchemeConfig(accuracy="eno2", rk_order=2)
        res = solve_vector(g, (fast, slow), (v0, v0), tau, cfg=cfg)
        r_fast = solve(g, fast, v0, tau, cfg=cfg)
        # field 0 evolves under its own (binding) dt -> exact match
        np.testing.assert_allclose(res.values[0], r_fast.values, atol=1e-12)
        assert int(res.steps) == int(r_fast.steps)

    def test_targets_and_obstacles_per_field(self):
        g = create_grid([-2, -2], [2, 2], 21)
        sys_ = DoubleIntegrator(u_max=1.0)
        v0 = sphere(g, radius=0.5, dtype=jnp.float64)
        obs = sphere(g, center=[1.0, 1.0], radius=0.3, dtype=jnp.float64)
        tau = jnp.linspace(0.0, 0.4, 3)
        cfg = SchemeConfig(accuracy="eno2", rk_order=2)
        res = solve_vector(g, sys_, (v0, v0), tau, cfg=cfg,
                           comp_methods=("minVWithL", "minVOverTime"),
                           targets=(v0, None), obstacles=(None, obs))
        single = solve(g, sys_, v0, tau, cfg=cfg, comp_method="minVWithL",
                       targets=v0)
        np.testing.assert_allclose(res.values[0], single.values, atol=1e-12)
        s2 = solve(g, sys_, v0, tau, cfg=cfg, comp_method="minVOverTime",
                   obstacles=obs)
        np.testing.assert_allclose(res.values[1], s2.values, atol=1e-12)


class TestCoupled:
    def test_reach_avoid_masking(self):
        """The coupling hook must hold the reach tube out of the avoid set
        after every step."""
        g = create_grid([-2, -2], [2, 2], 31)
        sys_ = DoubleIntegrator(u_max=1.0)
        reach0 = sphere(g, radius=0.4, dtype=jnp.float64)
        avoid0 = sphere(g, center=[0.9, 0.0], radius=0.35,
                        dtype=jnp.float64)
        tau = jnp.linspace(0.0, 0.8, 3)
        cfg = SchemeConfig(accuracy="eno2", rk_order=2)
        res = solve_vector(g, sys_, (reach0, avoid0), tau, cfg=cfg,
                           comp_methods=("minVOverTime", "minVOverTime"),
                           coupling=_ra_coupling)
        # invariant: reach >= -avoid everywhere, every checkpoint
        for i in range(3):
            assert float(jnp.min(res.values[0][i] + res.values[1][i])) \
                >= -1e-12
        # and the masking binds: the unmasked solve enters the avoid set
        free = solve(g, sys_, reach0, tau, cfg=cfg,
                     comp_method="minVOverTime")
        viol = float(jnp.min(free.values[-1] + res.values[1][-1]))
        assert viol < 0, "test not discriminating; enlarge avoid set"

    def test_coupled_sharded_matches_single(self):
        """The coupled case through shard_map on a 2x2 CPU mesh must match
        the single-device joint solve to reduction-order tolerance."""
        g = create_grid([-2, -2], [2, 2], 32)
        sys_ = DoubleIntegrator(u_max=1.0)
        reach0 = sphere(g, radius=0.4, dtype=jnp.float64)
        avoid0 = sphere(g, center=[0.9, 0.0], radius=0.35,
                        dtype=jnp.float64)
        tau = jnp.linspace(0.0, 0.6, 3)
        cfg = SchemeConfig(accuracy="eno2", rk_order=2)
        single = solve_vector(g, sys_, (reach0, avoid0), tau, cfg=cfg,
                              coupling=_ra_coupling)
        mesh = make_mesh({"px": 2, "py": 2})
        shard = solve_vector_sharded(
            g, sys_, (reach0, avoid0), tau, shard_axes={0: "px", 1: "py"},
            mesh=mesh, cfg=cfg, coupling=_ra_coupling)
        for k in range(2):
            np.testing.assert_allclose(np.asarray(shard.values[k]),
                                       np.asarray(single.values[k]),
                                       atol=1e-10)
        assert int(shard.steps) == int(single.steps)


class TestFrontDoorParity:
    """The single-field extras (discounting, tv stacks,
    TTR, stopInit/stopSet) through the vector front door, each validated
    against the single-field `solve` on decoupled fields."""

    def setup_method(self):
        self.g = create_grid([-2, -2], [2, 2], 21)
        self.sys = DoubleIntegrator(u_max=1.0)
        self.v0 = sphere(self.g, radius=0.5, dtype=jnp.float64)
        self.target = sphere(self.g, radius=0.4, dtype=jnp.float64)
        self.tau = jnp.linspace(0.0, 0.4, 3)
        self.cfg = SchemeConfig(accuracy="eno2", rk_order=2)

    def test_jaime_discounting_per_field(self):
        res = solve_vector(
            self.g, self.sys, (self.v0, self.v0), self.tau, cfg=self.cfg,
            comp_methods=("minVWithL", "minVOverTime"),
            targets=(self.target, None),
            discount_factors=(0.9, None))
        ra = solve(self.g, self.sys, self.v0, self.tau, cfg=self.cfg,
                   comp_method="minVWithL", targets=self.target,
                   discount_factor=0.9)
        rb = solve(self.g, self.sys, self.v0, self.tau, cfg=self.cfg)
        np.testing.assert_allclose(res.values[0], ra.values, atol=1e-12)
        np.testing.assert_allclose(res.values[1], rb.values, atol=1e-12)

    def test_kene_discounting(self):
        res = solve_vector(
            self.g, self.sys, (self.v0,), self.tau, cfg=self.cfg,
            comp_methods="minVWithL", targets=(self.target,),
            discount_factors=0.9, discount_modes="Kene")
        ref = solve(self.g, self.sys, self.v0, self.tau, cfg=self.cfg,
                    comp_method="minVWithL", targets=self.target,
                    discount_factor=0.9, discount_mode="Kene")
        np.testing.assert_allclose(res.values[0], ref.values, atol=1e-12)

    def test_time_varying_obstacles(self):
        obs = jnp.stack([
            sphere(self.g, center=[1.0 - 0.3 * i, 1.0], radius=0.3,
                   dtype=jnp.float64) for i in range(3)])
        res = solve_vector(self.g, self.sys, (self.v0,), self.tau,
                           cfg=self.cfg, obstacles=(obs,))
        ref = solve(self.g, self.sys, self.v0, self.tau, cfg=self.cfg,
                    obstacles=obs)
        np.testing.assert_allclose(res.values[0], ref.values, atol=1e-12)

    def test_record_ttr(self):
        res = solve_vector(self.g, self.sys, (self.v0, self.v0),
                           jnp.linspace(0.0, 1.0, 5), cfg=self.cfg,
                           record_ttr=True)
        ref = solve(self.g, self.sys, self.v0, jnp.linspace(0.0, 1.0, 5),
                    cfg=self.cfg, record_ttr=True)
        assert len(res.ttr) == 2
        np.testing.assert_allclose(res.ttr[0], ref.ttr, atol=1e-12)

    def test_stop_init(self):
        state = jnp.array([1.2, 0.0])
        tau = jnp.linspace(0.0, 2.0, 9)
        res = solve_vector(self.g, self.sys, (self.v0, self.v0), tau,
                           cfg=self.cfg, stop_init=state, stop_field=1)
        ref = solve(self.g, self.sys, self.v0, tau, cfg=self.cfg,
                    stop_init=state)
        assert int(res.stop_index) == int(ref.stop_index)
        np.testing.assert_allclose(res.values[1], ref.values, atol=1e-12)

    def test_stop_set_intersect(self):
        stop_set = sphere(self.g, center=[1.2, 0.0], radius=0.2,
                          dtype=jnp.float64)
        tau = jnp.linspace(0.0, 2.0, 9)
        res = solve_vector(self.g, self.sys, (self.v0,), tau,
                           cfg=self.cfg, stop_set_intersect=stop_set)
        ref = solve(self.g, self.sys, self.v0, tau, cfg=self.cfg,
                    stop_set_intersect=stop_set)
        assert int(res.stop_index) == int(ref.stop_index)
        np.testing.assert_allclose(res.values[0], ref.values, atol=1e-12)

    def test_sharded_features_match_single(self):
        g = create_grid([-2, -2], [2, 2], 24)
        v0 = sphere(g, radius=0.5, dtype=jnp.float64)
        target = sphere(g, radius=0.4, dtype=jnp.float64)
        mesh = make_mesh({"x": 2, "y": 4})
        kw = dict(comp_methods=("minVWithL", "minVOverTime"),
                  targets=(target, None), discount_factors=(0.9, None),
                  record_ttr=True)
        res = solve_vector(g, self.sys, (v0, v0), self.tau, cfg=self.cfg,
                           **kw)
        shr = solve_vector_sharded(g, self.sys, (v0, v0), self.tau,
                                   shard_axes={0: "x", 1: "y"}, mesh=mesh,
                                   cfg=self.cfg, **kw)
        for k in range(2):
            np.testing.assert_allclose(shr.values[k], res.values[k],
                                       atol=1e-10)
            np.testing.assert_allclose(shr.ttr[k], res.ttr[k], atol=1e-10)
        assert int(shr.stop_index) == int(res.stop_index)

    def test_validation(self):
        import pytest

        with pytest.raises(ValueError, match="Kene"):
            solve_vector(self.g, self.sys, (self.v0,), self.tau,
                         cfg=self.cfg, discount_factors=0.9,
                         discount_modes="Kene")
        with pytest.raises(ValueError, match="stop_field"):
            solve_vector(self.g, self.sys, (self.v0,), self.tau,
                         cfg=self.cfg, stop_field=3)
        with pytest.raises(ValueError, match="mutually exclusive"):
            solve_vector(self.g, self.sys, (self.v0,), self.tau,
                         cfg=self.cfg, stop_set_include=self.v0,
                         stop_set_intersect=self.v0)
