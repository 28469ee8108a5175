"""Multi-agent flock reachability: vectorized birds + topological consensus.

Redesign of the reference's ``DynamicalSystems/bird.py`` /
``flock.py`` / ``Graph``: starling-inspired flocks where each agent interacts
with its topological (label-distance) neighbours — Ballerini et al. PNAS 2008
— and headings follow the Jadbabaie nearest-neighbour consensus rule.

The reference stores agents as Python objects, loops over them per
Hamiltonian evaluation, and round-trips every per-agent result through host
memory (``flock.py:225-234`` ``.get()`` per agent — survey Q3).  Here the
flock is ONE pytree carrying the full per-agent payload of the reference's
``Bird`` objects, vectorized:

  * ``positions`` — each agent's absolute state ``(x, y, theta)``
    (``bird.cur_state``, ``bird.py:96-233``), evolved by the same RK4
    absolute Dubins dynamics (``bird.dynamics_abs/runge_kutta4``,
    ``bird.py:175-233``) — but as one ``(N, 3)`` array under ``vmap``.
  * ``labels`` — the agent labels whose distance defines topological
    neighbourhood (``flock._compare_neighbor``, ``flock.py:166-169``).
  * ``adjacency`` — an OPTIONAL explicit ``(N, N)`` neighbour graph
    (the reference ``Graph``'s mutable ``edges_set``, ``flock.py:18-96``);
    when absent the label-distance rule applies.
  * ``headings`` — the consensus variables ``w_e`` per agent; one
    ``consensus_step`` is the Jadbabaie row-stochastic update
    ``(I + D)^-1 (I + A)`` as a single matmul (``flock.py:171-236``).

Semantics (ref ``flock.py:191-258``):
  * one "attacked" agent plays the relative-coordinates pursuit-evasion game
    (the DubinsRel Merz Hamiltonian);
  * every other agent contributes its absolute-coordinates Hamiltonian
    ``-p1 cos(theta_j) - p2 sin(theta_j) - p3 w_j`` evaluated at its own
    STATE heading ``theta_j = positions[j, 2]`` with consensus rate ``w_j``
    (``bird.hamiltonian_abs``, ``bird.py:235-276``);
  * flock Hamiltonian = union (pointwise min) of member Hamiltonians;
  * flock dissipation = elementwise max of member alphas.

Per-agent grids (``Grids/flock_grid.py``) are exposed through
:meth:`Flock.member_grids` (offset copies of a base grid centred at each
agent, via ``decompose.flock_grids``) and the union payoff through
:meth:`Flock.payoff` (each bird's cylinder on its own block,
``bird.payoff``/``flock`` target construction).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .base import System, register_system, static_field
from .dubins import DubinsRel

__all__ = ["Flock", "topological_adjacency", "consensus_matrix"]


def topological_adjacency(n: int, neigh_rad: int,
                          labels=None) -> jnp.ndarray:
    """(N, N) 0/1 adjacency by topological label distance
    (``flock._compare_neighbor``, ``flock.py:166-169``): agents i and j are
    neighbours iff ``0 < |l_i - l_j| < neigh_rad``.  ``labels`` defaults to
    ``0..n-1``."""
    lab = jnp.arange(n, dtype=jnp.float32) if labels is None \
        else jnp.asarray(labels, jnp.float32)
    d = jnp.abs(lab[:, None] - lab[None, :])
    return ((d > 0) & (d < neigh_rad)).astype(jnp.float32)


def consensus_matrix(adj: jnp.ndarray) -> jnp.ndarray:
    """Row-stochastic Jadbabaie transition ``(I + D)^-1 (I + A)``."""
    valence = adj.sum(axis=1)
    return (jnp.eye(adj.shape[0]) + adj) / (1.0 + valence)[:, None]


@register_system
class Flock(System):
    """N Dubins agents with consensus headings on a shared 3-D relative
    grid.  Pytree: headings / positions / labels / adjacency (and speeds)
    are leaves — sweeps over flock configurations vmap;
    ``n_agents``/``neigh_rad``/``attacked`` are static.
    """

    headings: jnp.ndarray = None          # (N,) consensus w_e per agent
    positions: jnp.ndarray = None         # (N, 3) absolute (x, y, theta)
    labels: jnp.ndarray = None            # (N,) topological labels
    adjacency: jnp.ndarray = None         # optional explicit (N, N) graph
    v_e: float = 5.0
    v_p: float = 5.0
    w_bound: float = 5.0
    n_agents: int = static_field(default=3)
    neigh_rad: int = static_field(default=2)
    attacked: int = static_field(default=0)

    n_states = 3
    alpha_time_invariant = True

    def __post_init__(self):
        n = self.n_agents
        if self.headings is None:
            object.__setattr__(self, "headings",
                               jnp.linspace(0.0, 1.0, n))
        if self.labels is None:
            object.__setattr__(self, "labels",
                               jnp.arange(n, dtype=jnp.float32))
        if self.positions is None:
            # deterministic line formation, state heading = consensus
            # heading (the reference randomizes via init_random,
            # bird.py:96-130; pass positions explicitly for that)
            xs = 2.0 * jnp.arange(n, dtype=self.headings.dtype)
            pos = jnp.stack([xs, jnp.zeros_like(xs), self.headings],
                            axis=1)
            object.__setattr__(self, "positions", pos)

    # ------------------------------------------------------------- consensus
    def adjacency_matrix(self) -> jnp.ndarray:
        """Explicit graph when provided, else label-distance topology."""
        if self.adjacency is not None:
            return self.adjacency
        return topological_adjacency(self.n_agents, self.neigh_rad,
                                     self.labels)

    def consensus_step(self) -> "Flock":
        """One Jadbabaie heading-consensus update over the neighbour graph
        (``flock._update_headings``, ``flock.py:171-189``)."""
        f = consensus_matrix(self.adjacency_matrix()).astype(
            self.headings.dtype)
        # HIGHEST: an f32 product may otherwise run in TF32 on a GPU
        return dataclasses.replace(
            self, headings=jnp.matmul(f, self.headings,
                                      precision=jax.lax.Precision.HIGHEST))

    def step_positions(self, dt: float = 0.2, n_steps: int = 1) -> "Flock":
        """Advance every agent's absolute state by RK4 under the Dubins
        dynamics ``x' = v cos(th), y' = v sin(th), th' = w_e``
        (``bird.dynamics_abs`` + ``runge_kutta4``, ``bird.py:175-233``) —
        one vectorized step over the whole flock."""

        def xdot(pos):
            th = pos[:, 2]
            return jnp.stack([self.v_e * jnp.cos(th),
                              self.v_e * jnp.sin(th),
                              self.headings], axis=1)

        pos = self.positions
        for _ in range(n_steps):
            k1 = xdot(pos)
            k2 = xdot(pos + 0.5 * dt * k1)
            k3 = xdot(pos + 0.5 * dt * k2)
            k4 = xdot(pos + dt * k3)
            pos = pos + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return dataclasses.replace(self, positions=pos)

    # ---------------------------------------------------------- member parts
    def _attacked_system(self) -> DubinsRel:
        return DubinsRel(v_e=self.v_e, v_p=self.v_p, w_bound=self.w_bound)

    def _others(self, arr):
        # static unit-index gather (the members other than the attacked
        # agent; their count is static)
        keep = [i for i in range(self.n_agents) if i != self.attacked]
        return jnp.stack([arr[i] for i in keep], axis=0)

    def _abs_hamiltonian(self, theta, w, p):
        """Absolute-coordinates member Hamiltonian at the agent's state
        heading ``theta`` and consensus rate ``w``
        (``bird.hamiltonian_abs``, ``bird.py:235-276``:
        ``-p1 cos(th) - p2 sin(th) - p3 w_e``)."""
        return (-p[0] * jnp.cos(theta) - p[1] * jnp.sin(theta)
                - p[2] * w)

    def hamiltonian(self, t, x, p):
        """Union (pointwise min) of member Hamiltonians
        (``flock.hamiltonian``, ``flock.py:191-236``)."""
        rel_ham = self._attacked_system().hamiltonian(t, x, p)
        if self.n_agents == 1:
            return rel_ham
        thetas = self._others(self.positions)[:, 2]
        ws = self._others(self.headings)
        # running min over the (static) member count instead of a vmapped
        # stack: no (N-1, *grid) intermediate — one live grid-sized array
        ham = rel_ham
        for i in range(self.n_agents - 1):
            ham = jnp.minimum(
                ham, self._abs_hamiltonian(thetas[i], ws[i], p))
        return ham

    def alpha(self, t, x, p_min, p_max, axis):
        """Elementwise max of member dissipation bounds
        (``flock.dissipation``, ``flock.py:238-258``; members contribute
        |dH/dp| of the absolute Hamiltonian — ``bird.dissipation_abs``)."""
        a = self._attacked_system().alpha(t, x, p_min, p_max, axis)
        if self.n_agents == 1:
            return a
        thetas = self._others(self.positions)[:, 2]
        if axis == 0:
            member = jnp.max(jnp.abs(jnp.cos(thetas)))
        elif axis == 1:
            member = jnp.max(jnp.abs(jnp.sin(thetas)))
        else:
            member = jnp.max(jnp.abs(self._others(self.headings)))
        return jnp.maximum(a, member * jnp.ones_like(a))

    # ----------------------------------------------------- grids and payoffs
    def member_grids(self, base):
        """Per-agent offset copies of ``base`` centred at each agent
        (``Grids/flock_grid.py:6`` via ``decompose.flock_grids``).  Host
        helper (static grids) — call outside jit."""
        import numpy as np

        from ..decompose import flock_grids

        centers = np.asarray(self.positions)
        return flock_grids(base, [list(c) for c in centers])

    def payoff(self, grid, radius: float = 1.0, dtype=jnp.float32):
        """Union of per-agent payoff cylinders at the agents' positions
        (each ``bird.payoff`` cylinder, unioned as in the reference's
        flock target construction)."""
        xs = grid.mesh_broadcastable(dtype)

        def one(pos):
            return jnp.sqrt((xs[0] - pos[0]) ** 2
                            + (xs[1] - pos[1]) ** 2) - radius

        return jnp.min(jax.vmap(one)(self.positions.astype(dtype)),
                       axis=0) + 0.0 * xs[2]

    # ------------------------------------------------------------- dynamics
    def dynamics(self, t, x, u, d):
        return self._attacked_system().dynamics(t, x, u, d)

    def opt_control(self, t, x, p, mode):
        return self._attacked_system().opt_control(t, x, p, mode)

    def opt_disturbance(self, t, x, p, mode):
        return self._attacked_system().opt_disturbance(t, x, p, mode)
