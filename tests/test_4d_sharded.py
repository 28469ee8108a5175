"""4-D reachability on a sharded mesh (BASELINE config #4 scale pattern)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from levelsetpy_tpu import (PlanarDoubleIntegrator, SchemeConfig,
                            create_grid, sphere, solve)
from levelsetpy_tpu.parallel import make_mesh, solve_sharded

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def setup_4d(n=12):
    g = create_grid([-1, -1, -1, -1], [1, 1, 1, 1], n)
    sys_ = PlanarDoubleIntegrator(u_max=1.0, d_max=0.2)
    phi0 = sphere(g, center=[0, 0, 0, 0], radius=0.3, dtype=jnp.float64)
    return g, sys_, phi0


class TestPlanar4D:
    def test_brt_grows_and_is_finite(self):
        g, sys_, phi0 = setup_4d(16)
        res = solve(g, sys_, phi0, tau=jnp.linspace(0.0, 0.3, 4),
                    cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        v = np.asarray(res.values)
        assert np.isfinite(v).all()
        assert (v[-1] <= 0).sum() > (v[0] <= 0).sum()

    def test_disturbance_shrinks_tube(self):
        g, _, phi0 = setup_4d(12)
        tau = jnp.linspace(0.0, 0.3, 3)
        cfg = SchemeConfig(accuracy="eno2", rk_order=2)
        v_nod = solve(g, PlanarDoubleIntegrator(u_max=1.0, d_max=0.0),
                      phi0, tau, cfg=cfg).values[-1]
        v_dist = solve(g, PlanarDoubleIntegrator(u_max=1.0, d_max=0.5),
                       phi0, tau, cfg=cfg).values[-1]
        # adversarial disturbance can only make reaching harder
        assert (np.asarray(v_dist) <= 0).sum() \
            <= (np.asarray(v_nod) <= 0).sum()

    def test_sharded_4d_matches_single_device(self):
        """Domain decomposition over 2 grid axes of a 4-D grid (the config
        #4 pattern: multi-agent-scale state spaces sharded over the mesh)."""
        g, sys_, phi0 = setup_4d(16)
        tau = jnp.linspace(0.0, 0.2, 3)
        cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)
        r1 = solve(g, sys_, phi0, tau, cfg=cfg)
        mesh = make_mesh({"px": 2, "py": 4})
        r2 = solve_sharded(g, sys_, phi0, tau,
                           shard_axes={0: "px", 1: "py"}, mesh=mesh,
                           cfg=cfg)
        np.testing.assert_allclose(r1.values, r2.values, atol=1e-10)
