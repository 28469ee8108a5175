"""Multi-agent flock system tests."""
import jax
import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import SchemeConfig, create_grid, cylinder, solve
from levelsetpy_tpu.systems.flock import (Flock, consensus_matrix,
                                          topological_adjacency)


class TestGraph:
    def test_adjacency_topological(self):
        a = np.asarray(topological_adjacency(5, 2))
        # neighbors are labels at distance 1 only
        assert a[0, 1] == 1 and a[1, 0] == 1
        assert a[0, 2] == 0 and a[0, 0] == 0
        assert (a == a.T).all()

    def test_consensus_matrix_row_stochastic(self):
        adj = topological_adjacency(6, 3)
        f = np.asarray(consensus_matrix(adj))
        np.testing.assert_allclose(f.sum(axis=1), 1.0, atol=1e-6)
        assert (f >= 0).all()

    def test_consensus_converges_to_agreement(self):
        """Repeated Jadbabaie updates on a connected graph reach heading
        consensus."""
        flock = Flock(headings=jnp.array([0.1, 0.9, 0.4, 0.7]),
                      n_agents=4, neigh_rad=2)
        for _ in range(200):
            flock = flock.consensus_step()
        h = np.asarray(flock.headings)
        assert h.std() < 1e-5
        # consensus preserves the achievable range
        assert 0.1 - 1e-6 <= h.mean() <= 0.9 + 1e-6


class TestFlockSystem:
    def grid(self, n=15):
        return create_grid([-6, -10, 0], [20, 10, 2 * np.pi], n,
                           periodic_dims=[2])

    def test_flock_ham_is_union_of_members(self):
        g = self.grid()
        flock = Flock(headings=jnp.array([0.5, 1.0, 1.5]), n_agents=3,
                      v_e=5.0, v_p=5.0, w_bound=1.0)
        xs = g.mesh_broadcastable(jnp.float64)
        p = tuple(jnp.ones(g.shape) for _ in range(3))
        ham = flock.hamiltonian(0.0, xs, p)
        solo = flock._attacked_system().hamiltonian(0.0, xs, p)
        assert ham.shape == g.shape
        # union: flock ham <= attacked agent's ham pointwise
        assert (np.asarray(ham) <= np.asarray(solo) + 1e-12).all()

    def test_flock_alpha_dominates_member(self):
        g = self.grid()
        flock = Flock(headings=jnp.array([0.5, 1.0]), n_agents=2,
                      v_e=5.0, v_p=5.0, w_bound=1.0)
        xs = g.mesh_broadcastable(jnp.float64)
        for axis in range(3):
            a_f = flock.alpha(0.0, xs, None, None, axis)
            a_m = flock._attacked_system().alpha(0.0, xs, None, None, axis)
            assert (np.asarray(a_f) >= np.asarray(a_m) - 1e-12).all()

    def test_flock_brt_solves(self):
        g = self.grid()
        target = cylinder(g, ignore_axes=[2], radius=5.0,
                          dtype=jnp.float64)
        flock = Flock(headings=jnp.array([0.5, 1.0, 1.5]), n_agents=3,
                      v_e=5.0, v_p=5.0, w_bound=1.0)
        res = solve(g, flock, target, tau=jnp.linspace(0.0, 0.2, 3),
                    cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        v = np.asarray(res.values)
        assert np.isfinite(v).all()
        assert (v[-1] <= v[0] + 1e-12).all()

    def test_vmap_over_flock_headings(self):
        g = self.grid(9)
        target = cylinder(g, ignore_axes=[2], radius=5.0,
                          dtype=jnp.float64)

        def solve_one(headings):
            flock = Flock(headings=headings, n_agents=3, v_e=5.0, v_p=5.0,
                          w_bound=1.0)
            return solve(g, flock, target, tau=jnp.array([0.0, 0.1]),
                         cfg=SchemeConfig(accuracy="first", rk_order=1),
                         save_all=False).values

        batch = jnp.array([[0.5, 1.0, 1.5], [0.2, 0.4, 0.6]])
        out = jax.vmap(solve_one)(batch)
        assert out.shape == (2, 1) + g.shape
        assert np.isfinite(np.asarray(out)).all()


class TestFlockFidelity:
    """Per-agent payload parity: positions, labels, arbitrary graphs,
    per-agent grids (ref bird.py:96-276, flock.py:18-258,
    Grids/flock_grid.py)."""

    def grid(self, n=15):
        return create_grid([-6, -10, 0], [20, 10, 2 * np.pi], n,
                           periodic_dims=[2])

    def test_positions_default_matches_headings(self):
        f = Flock(headings=jnp.array([0.3, 0.6, 0.9]), n_agents=3)
        np.testing.assert_allclose(np.asarray(f.positions[:, 2]),
                                   [0.3, 0.6, 0.9])

    def test_explicit_adjacency_overrides_topology(self):
        """A disconnected explicit graph must keep headings frozen while the
        default topological graph mixes them."""
        h = jnp.array([0.0, 1.0, 2.0])
        disconnected = jnp.zeros((3, 3))
        f_iso = Flock(headings=h, adjacency=disconnected, n_agents=3)
        f_top = Flock(headings=h, n_agents=3, neigh_rad=2)
        np.testing.assert_allclose(
            np.asarray(f_iso.consensus_step().headings), np.asarray(h))
        assert not np.allclose(
            np.asarray(f_top.consensus_step().headings), np.asarray(h))

    def test_step_positions_moves_agents(self):
        f = Flock(headings=jnp.array([0.0, 0.5]), n_agents=2, v_e=5.0)
        f2 = f.step_positions(dt=0.1)
        d = np.asarray(f2.positions - f.positions)
        assert (np.abs(d[:, 0]) > 0.1).all()    # moved in x
        np.testing.assert_allclose(d[:, 2], 0.1 * np.asarray(f.headings),
                                   atol=1e-6)   # theta' = w_e

    def test_brt_responds_to_consensus_evolution(self):
        """The attacked agent's BRT must change as neighbour headings and
        positions evolve under consensus + motion (the reference evolves
        them per step inside flock.hamiltonian's _housekeeping)."""
        g = self.grid()
        target = cylinder(g, ignore_axes=[2], radius=5.0,
                          dtype=jnp.float64)
        flock = Flock(headings=jnp.array([0.1, 1.4, 2.8]), n_agents=3,
                      v_e=5.0, v_p=5.0, w_bound=1.0)
        tau = jnp.linspace(0.0, 0.15, 2)
        cfg = SchemeConfig(accuracy="eno2", rk_order=2)
        r1 = solve(g, flock, target, tau, cfg=cfg, save_all=False)
        flock2 = flock.consensus_step().step_positions(dt=0.3)
        r2 = solve(g, flock2, target, tau, cfg=cfg, save_all=False)
        assert not np.allclose(np.asarray(r1.values), np.asarray(r2.values))
        assert np.isfinite(np.asarray(r2.values)).all()

    def test_member_grids_offsets(self):
        g = self.grid()
        f = Flock(n_agents=3)
        grids = f.member_grids(g)
        assert len(grids) == 3
        pos = np.asarray(f.positions)
        for gi, p in zip(grids, pos):
            c = [0.5 * (l + h) for l, h in zip(gi.lo, gi.hi)]
            np.testing.assert_allclose(c, p, atol=1e-6)
            assert gi.shape == g.shape

    def test_union_payoff(self):
        g = create_grid([-10, -10, 0], [10, 10, 2 * np.pi], 21,
                        periodic_dims=[2])
        pos = jnp.array([[-5.0, 0.0, 0.0], [5.0, 0.0, 0.0]])
        f = Flock(positions=pos, n_agents=2)
        pay = np.asarray(f.payoff(g, radius=1.5))
        assert pay.shape == g.shape
        # negative near both agent centers
        x = np.linspace(-10, 10, 21)
        i1, i2 = np.argmin(np.abs(x + 5)), np.argmin(np.abs(x - 5))
        j = np.argmin(np.abs(x))
        assert pay[i1, j, 0] < 0 and pay[i2, j, 0] < 0
        assert pay[j, j, 0] > 0  # positive between them
