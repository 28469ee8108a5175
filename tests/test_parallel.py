"""Sharded-solver tests on the 8-device virtual CPU mesh.

The multi-chip path (shard_map + ppermute halo exchange + allreduced CFL
scalars) must reproduce the single-device solve bit-for-bit up to reduction
reordering."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid, cylinder,
                            solve)
from levelsetpy_tpu.parallel import (halo_exchange_axis, make_mesh,
                                     pad_axis_sharded, solve_sharded)
from jax.sharding import PartitionSpec as P

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def air3d_setup(shape=(16, 16, 16)):
    grid = create_grid([-6, -10, 0], [20, 10, 2 * np.pi], shape,
                       periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], radius=5.0, dtype=jnp.float64)
    system = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
    return grid, system, target


class TestHalo:
    def test_halo_matches_unsharded_pad_periodic(self):
        """Sharded ghost-fill over a ring == global periodic pad."""
        from levelsetpy_tpu.boundary import pad_periodic

        mesh = make_mesh({"x": 8})
        data = jnp.arange(32.0).reshape(32, 1) * jnp.ones((1, 4))
        expect = pad_periodic(data, 0, 2)

        def body(local):
            return pad_axis_sharded(local, 0, 2, "x", periodic=True)

        out = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
            check_vma=False))(data)
        # sharded output: each shard padded; reconstruct the shard-0 block
        # and compare its ghosts with the global pad's relevant cells
        assert out.shape == (32 + 4 * 8, 4)  # 8 shards each grow by 2*width
        # shard 0 low ghosts must equal wrap-around from the global end
        np.testing.assert_allclose(out[:2], expect[:2])

    def test_halo_exchange_values(self):
        mesh = make_mesh({"x": 4})
        data = jnp.arange(16.0)

        def body(local):
            left, right = halo_exchange_axis(local, 0, 1, "x")
            return jnp.stack([left[0], right[0]])

        out = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
            check_vma=False))(data)
        # shard i holds [4i..4i+3]; left ghost = 4i-1 mod 16, right = 4i+4
        out = np.asarray(out).reshape(4, 2)
        np.testing.assert_allclose(out[:, 0], [15, 3, 7, 11])
        np.testing.assert_allclose(out[:, 1], [4, 8, 12, 0])


class TestShardedSolve:
    def test_matches_single_device_2d_mesh(self):
        grid, system, target = air3d_setup()
        cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)
        tau = jnp.linspace(0.0, 0.2, 3)
        r1 = solve(grid, system, target, tau, cfg=cfg)
        mesh = make_mesh({"x": 2, "y": 4})
        r2 = solve_sharded(grid, system, target, tau,
                           shard_axes={0: "x", 1: "y"}, mesh=mesh, cfg=cfg)
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)
        assert int(r1.steps) == int(r2.steps)

    def test_matches_single_device_periodic_axis_sharded(self):
        grid, system, target = air3d_setup()
        cfg = SchemeConfig(accuracy="eno3", rk_order=3)
        tau = jnp.linspace(0.0, 0.2, 3)
        r1 = solve(grid, system, target, tau, cfg=cfg)
        mesh = make_mesh({"a": 2, "th": 4})
        r2 = solve_sharded(grid, system, target, tau,
                           shard_axes={1: "a", 2: "th"}, mesh=mesh, cfg=cfg)
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)

    def test_obstacles_sharded(self):
        grid, system, target = air3d_setup()
        from levelsetpy_tpu import sphere

        obstacle = sphere(grid, center=[10.0, 0.0, np.pi], radius=3.0,
                          dtype=jnp.float64)
        cfg = SchemeConfig(accuracy="eno2", rk_order=2)
        tau = jnp.linspace(0.0, 0.2, 3)
        r1 = solve(grid, system, target, tau, cfg=cfg, obstacles=obstacle)
        mesh = make_mesh({"x": 8})
        r2 = solve_sharded(grid, system, target, tau, shard_axes={0: "x"},
                           mesh=mesh, cfg=cfg, obstacles=obstacle)
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)

    def test_three_axes_sharded(self):
        grid, system, target = air3d_setup()
        cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)
        tau = jnp.linspace(0.0, 0.2, 3)
        r1 = solve(grid, system, target, tau, cfg=cfg)
        mesh = make_mesh({"x": 2, "y": 2, "z": 2})
        r2 = solve_sharded(grid, system, target, tau,
                           shard_axes={0: "x", 1: "y", 2: "z"}, mesh=mesh,
                           cfg=cfg)
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)

    def test_rejects_non_divisible(self):
        grid, system, target = air3d_setup((15, 16, 16))
        mesh = make_mesh({"x": 2})
        with pytest.raises(ValueError, match="divide"):
            solve_sharded(grid, system, target, [0.0, 0.1],
                          shard_axes={0: "x"}, mesh=mesh)

    def test_rejects_halo_wider_than_shard(self):
        """WENO5 needs 3 ghost cells; 2 local nodes per shard must fail
        with a clear message, not a shape error mid-trace."""
        grid, system, target = air3d_setup((16, 16, 16))
        mesh = make_mesh({"th": 8})
        with pytest.raises(ValueError, match="stencil halo"):
            solve_sharded(grid, system, target, [0.0, 0.1],
                          shard_axes={2: "th"}, mesh=mesh)


class TestShardedFeatureParity:
    """Every solver feature must produce identical values through the
    sharded path (the single-device suites in test_solver.py are the
    semantic oracle; here sharded == single-device to reduction
    reordering)."""

    def setup_method(self):
        self.grid, self.system, self.target = air3d_setup()
        self.cfg = SchemeConfig(accuracy="eno2", rk_order=2)
        self.tau = jnp.linspace(0.0, 0.3, 4)
        self.mesh = make_mesh({"x": 2, "y": 4})
        self.axes = {0: "x", 1: "y"}

    def both(self, **kw):
        r1 = solve(self.grid, self.system, self.target, self.tau,
                   cfg=self.cfg, **kw)
        r2 = solve_sharded(self.grid, self.system, self.target, self.tau,
                           shard_axes=self.axes, mesh=self.mesh,
                           cfg=self.cfg, **kw)
        return r1, r2

    def test_discounting(self):
        r1, r2 = self.both(discount_factor=0.99)
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)

    def test_kene_discounting(self):
        tgt = cylinder(self.grid, ignore_axes=[2], radius=4.0,
                       dtype=jnp.float64)
        r1, r2 = self.both(discount_factor=0.95, discount_mode="Kene",
                           comp_method="minVWithL", targets=tgt)
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)

    def test_record_ttr(self):
        r1, r2 = self.both(record_ttr=True)
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)
        m = np.isfinite(np.asarray(r1.ttr))
        assert (np.isfinite(np.asarray(r2.ttr)) == m).all()
        np.testing.assert_allclose(np.asarray(r2.ttr)[m],
                                   np.asarray(r1.ttr)[m], atol=1e-10)

    def test_stop_set_intersect(self):
        from levelsetpy_tpu import sphere

        stop = sphere(self.grid, center=[12.0, 0.0, np.pi], radius=1.5,
                      dtype=jnp.float64)
        tau = jnp.linspace(0.0, 2.0, 9)
        r1 = solve(self.grid, self.system, self.target, tau, cfg=self.cfg,
                   stop_set_intersect=stop)
        r2 = solve_sharded(self.grid, self.system, self.target, tau,
                           shard_axes=self.axes, mesh=self.mesh,
                           cfg=self.cfg, stop_set_intersect=stop)
        assert int(r1.stop_index) == int(r2.stop_index)
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)

    def test_stop_init(self):
        x_query = jnp.array([8.0, 0.0, np.pi])
        tau = jnp.linspace(0.0, 2.0, 9)
        r1 = solve(self.grid, self.system, self.target, tau, cfg=self.cfg,
                   stop_init=x_query)
        r2 = solve_sharded(self.grid, self.system, self.target, tau,
                           shard_axes=self.axes, mesh=self.mesh,
                           cfg=self.cfg, stop_init=x_query)
        assert int(r1.stop_index) == int(r2.stop_index)
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)

    def test_ignore_boundary_convergence(self):
        tau = jnp.linspace(0.0, 4.0, 17)
        kw = dict(converge_threshold=1e-3, ignore_boundary=True)
        r1 = solve(self.grid, self.system, self.target, tau, cfg=self.cfg,
                   **kw)
        r2 = solve_sharded(self.grid, self.system, self.target, tau,
                           shard_axes=self.axes, mesh=self.mesh,
                           cfg=self.cfg, **kw)
        assert int(r1.stop_index) == int(r2.stop_index)
        np.testing.assert_allclose(r1.changes, r2.changes, atol=1e-10)

    def test_gaussian_noise(self):
        r1, r2 = self.both(noise_stddev=jnp.array([0.1, 0.1, 0.05]),
                           comp_method="none")
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)
        assert int(r1.steps) == int(r2.steps)

    def test_time_varying_obstacles(self):
        from levelsetpy_tpu import sphere

        centers = jnp.linspace(8.0, 12.0, self.tau.shape[0])
        obs = jnp.stack([
            sphere(self.grid, center=[float(c), 0.0, np.pi], radius=2.0,
                   dtype=jnp.float64) for c in centers])
        r1, r2 = self.both(obstacles=obs)
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)

    def test_save_all_false(self):
        r1, r2 = self.both(save_all=False)
        assert r2.values.shape == (1,) + self.grid.shape
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)


class TestHaloAllShards:
    """Every shard's padded block must equal the corresponding window of a
    globally padded array (not just shard 0's low ghosts)."""

    @pytest.mark.parametrize("periodic", [True, False])
    def test_padded_blocks_match_global(self, periodic):
        from levelsetpy_tpu.boundary import pad_axis

        n, width, shards = 32, 3, 8
        grid = create_grid([0.0], [1.0], [n],
                           periodic_dims=[0] if periodic else [])
        rng = np.random.default_rng(3)
        data = jnp.asarray(rng.normal(size=(n,)))
        expect = np.asarray(pad_axis(grid, data, 0, width))
        mesh = make_mesh({"x": shards})

        def body(local):
            return pad_axis_sharded(local, 0, width, "x",
                                    periodic=periodic)

        out = np.asarray(jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
            check_vma=False))(data))
        per = n // shards
        blocks = out.reshape(shards, per + 2 * width)
        full = np.concatenate([np.asarray(data)] * 1)
        for s in range(shards):
            lo, hi = s * per, (s + 1) * per
            if s == 0:
                np.testing.assert_allclose(blocks[s, :width],
                                           expect[:width])
            else:
                np.testing.assert_allclose(blocks[s, :width],
                                           full[lo - width:lo])
            np.testing.assert_allclose(blocks[s, width:width + per],
                                       full[lo:hi])
            if s == shards - 1:
                np.testing.assert_allclose(blocks[s, width + per:],
                                           expect[-width:])
            else:
                np.testing.assert_allclose(blocks[s, width + per:],
                                           full[hi:hi + width])
