"""Per-interval lagged alpha refresh: systems whose alpha
varies with TIME but ignores the costate box (``alpha_costate_free``) get
dissipation bounds + CFL dt recomputed once per tau interval (frozen at the
interval's start), hoisting the per-substep alpha work out of the RK loop.
Parity vs the exact per-substep path holds up to the documented O(dt) lag.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from levelsetpy_tpu import SchemeConfig, create_grid, solve, sphere
from levelsetpy_tpu.systems import System, register_system


class _Pulsing(System):
    """3-D front propagation with a time-varying speed
    ``s(t) = base * (1 + amp * sin(w t))`` — alpha depends on t only."""

    n_states = 3

    def speed(self, t):
        return self.base * (1.0 + self.amp * jnp.sin(self.w * t))

    def hamiltonian(self, t, x, p):
        return self.speed(t) * jnp.sqrt(sum(pi * pi for pi in p) + 1e-12)

    def alpha(self, t, x, p_min, p_max, axis):
        return jnp.abs(self.speed(t)) * jnp.ones_like(x[0])


@register_system
class PulsingLagged(_Pulsing):
    base: float = 1.0
    amp: float = 0.3
    w: float = 4.0
    alpha_costate_free = True     # opt IN to the lagged refresh


@register_system
class PulsingExact(_Pulsing):
    base: float = 1.0
    amp: float = 0.3
    w: float = 4.0                # default: exact per-substep alpha


def _setup():
    grid = create_grid([-1.0] * 3, [1.0] * 3, (16, 16, 16))
    xs = grid.mesh_broadcastable(jnp.float32)
    v = (sphere(grid, radius=0.5)
         + 0.05 * jnp.sin(4 * xs[0]) * jnp.cos(3 * xs[1])
         * jnp.cos(2 * xs[2])).astype(jnp.float32)
    return grid, v


@pytest.mark.parametrize("rk_order", [2, 3])
def test_lagged_alpha_parity_small_intervals(rk_order):
    """With tau intervals short relative to the speed's variation, the
    lagged execution must track the exact per-substep path to the
    documented O(dt) budget, at every RK order."""
    grid, v = _setup()
    # 8 short intervals over 0.2s: speed varies ~2% within an interval
    tau = jnp.linspace(0.0, 0.2, 9).astype(jnp.float32)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=rk_order,
                       epsilon_method="constant")
    r1 = solve(grid, PulsingExact(), v, tau, cfg=cfg)
    r2 = solve(grid, PulsingLagged(), v, tau, cfg=cfg)
    v1, v2 = np.asarray(r1.values), np.asarray(r2.values)
    assert np.isfinite(v2).all()
    scale = np.abs(v1).max()
    # lag budget: dt * max relative speed change per interval ~ 1e-3
    np.testing.assert_allclose(v2, v1, atol=2e-3 * scale)
