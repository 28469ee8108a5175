"""Second-order variational HJI approximation — minimax DDP over trajectories.

Realization of the reference's ``DDPReach/`` machinery
(``var_hji_approx.py:15`` ``VarHJIApprox``, ``ddp_reach.py:64`` ``DDPReach``,
``rocket_system.py:142-305`` hand-coded Hamiltonian/value derivative buffers
and Cholesky gains — the spur is broken upstream: undefined ``backward_pass``
/ ``forward_pass`` / ``system`` symbols and a syntax error in ``gains()``,
survey §2.8).  The intent is the LCSS-paper scheme: approximate the HJI value
function along *scheduled trajectories* by solving, per initial state, a
two-player differential game with an iterative dynamic-game (DDP) sweep, and
accumulate the per-trajectory values over the state space
(``ddp_reach.py:78-85``).

A redesign, not a translation:

  * Every derivative the reference hand-codes into ``(T, n, n)`` buffers
    (``rocket_system.py:163-246``: ``fx/fu/fv``, ``H*``, ``Vx/Vxx``) comes
    from ``jax`` autodiff of the *discrete* step — ``jax.jacfwd`` for the
    Jacobian, ``jax.hessian`` of the costate-contracted step for the exact
    second-order (tensor) term, so this is full DDP, not iLQR.
  * The backward pass (gains via a regularized saddle solve — the
    reference's aborted Cholesky ``gains()``, ``rocket_system.py:283-305``)
    and the forward rollout are ``lax.scan``s; the improvement loop is one
    more scan.  One XLA program per game — no per-step host round trips.
  * Games are independent per initial state: :func:`varhji_reach` vmaps the
    whole solve over a batch of initial states *and* a horizon schedule, so
    the (n×n) solves/matmuls batch into ``(B, n, n)`` einsums that XLA
    tiles onto the matrix units — the reference's per-trajectory Python
    ``for x_i in X`` loop (``ddp_reach.py:83``) becomes one compiled fan-out.

Convention: the **u player minimizes**, the **v player maximizes** (H-inf
style; pass ``nv=0`` for plain optimal control).  :func:`varhji_reach` maps a
:class:`~levelsetpy_tpu.systems.base.System`'s ``u_mode``/``d_mode`` onto the
slots automatically.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["DDPConfig", "DDPResult", "ddp_minimax", "varhji_reach"]


@dataclasses.dataclass(frozen=True)
class DDPConfig:
    """Iteration hyper-parameters (ref ``var_hji_approx.py:16`` ``eta``/
    ``rho`` stopping & regularization params; here iterations are a fixed
    scan length for one-trace compilation, and convergence is *reported*
    per-iteration rather than branched on)."""

    iters: int = 30
    #: Levenberg-Marquardt regularization added to +Quu / -Qvv before the
    #: saddle solve (ref ``rho``; the reference tried raw Cholesky and
    #: raised on failure, ``rocket_system.py:283-305``).
    reg: float = 1e-3
    #: step size on the open-loop gain in the forward pass.
    step: float = 1.0


class DDPResult(NamedTuple):
    value: jnp.ndarray        # game value phi(x_T) + integral running cost
    xs: jnp.ndarray           # (T+1, n) converged state trajectory
    us: jnp.ndarray           # (T, nu) minimizing player's schedule
    vs: jnp.ndarray           # (T, nv) maximizing player's schedule
    gain_norms: jnp.ndarray   # (iters,) max |open-loop gain| per iteration
    improvements: jnp.ndarray  # (iters,) value change per iteration


def _quad_q(step_fn, run_cost, t, dt, x, u, v, vx, vxx):
    """Second-order expansion of Q(x,u,v) = dt*L + V'(F(x,u,v)) around the
    nominal point — the autodiff replacement for the reference's hand-coded
    ``hamiltonian``/``f_derivs`` buffers (``rocket_system.py:163-246``)."""
    nx, nu, nv = x.shape[0], u.shape[0], v.shape[0]

    def F(z):
        return step_fn(t, z[:nx], z[nx:nx + nu], z[nx + nu:], dt)

    def L(z):
        return dt * run_cost(t, z[:nx], z[nx:nx + nu], z[nx + nu:])

    z0 = jnp.concatenate([x, u, v])
    J = jax.jacfwd(F)(z0)                        # (nx, nz)
    g = J.T @ vx + jax.grad(L)(z0)
    # exact DDP tensor term: hessian of the costate-contracted step
    H = (J.T @ vxx @ J
         + jax.hessian(lambda z: vx @ F(z))(z0)
         + jax.hessian(L)(z0))
    H = 0.5 * (H + H.T)
    return g, H


def _backward(step_fn, run_cost, term_cost, ts, dt, xs, us, vs, reg):
    """Backward sweep: per step, expand Q, solve the regularized saddle for
    the joint (du, dv) gains, recurse (Vx, Vxx).  Returns per-step open-loop
    gains k and feedback K."""
    nx = xs.shape[-1]
    nu, nv = us.shape[-1], vs.shape[-1]
    m = nu + nv
    # +reg for the minimizer block, -reg for the maximizer block: pushes the
    # saddle Hessian towards (PD, ND) splitting.
    reg_sign = jnp.concatenate([jnp.ones(nu), -jnp.ones(nv)])

    vx_T = jax.grad(term_cost)(xs[-1])
    vxx_T = jax.hessian(term_cost)(xs[-1])

    def step(carry, inp):
        vx, vxx = carry
        t, x, u, v = inp
        g, H = _quad_q(step_fn, run_cost, t, dt, x, u, v, vx, vxx)
        gm = g[nx:]                       # (m,) control-block gradient
        M = H[nx:, nx:]                   # (m, m) control-block hessian
        N = H[nx:, :nx]                   # (m, nx) control-state coupling
        M_reg = M + reg * jnp.diag(reg_sign)
        k = -jnp.linalg.solve(M_reg, gm)
        K = -jnp.linalg.solve(M_reg, N)
        # value recursion with the TRUE (unregularized) blocks
        vx_new = (g[:nx] + K.T @ M @ k + K.T @ gm + N.T @ k)
        vxx_new = H[:nx, :nx] + K.T @ M @ K + K.T @ N + N.T @ K
        vxx_new = 0.5 * (vxx_new + vxx_new.T)
        return (vx_new, vxx_new), (k, K)

    (_, _), (ks, Ks) = jax.lax.scan(
        step, (vx_T, vxx_T), (ts, xs[:-1], us, vs), reverse=True)
    return ks, Ks


def _rollout(step_fn, ts, dt, x0, us, vs, xs_bar=None, ks=None, Ks=None,
             step=1.0, nu=None):
    """Forward pass: open-loop when no gains, else the gain-corrected policy
    ``w_t = w̄_t + step*k_t + K_t (x_t - x̄_t)`` for both players jointly."""
    nu = us.shape[-1] if nu is None else nu

    def f(x, inp):
        if ks is None:
            t, u, v = inp
        else:
            t, u, v, xb, k, K = inp
            dw = step * k + K @ (x - xb)
            u = u + dw[:nu]
            v = v + dw[nu:]
        x_new = step_fn(t, x, u, v, dt)
        return x_new, (x_new, u, v)

    inps = (ts, us, vs) if ks is None else (ts, us, vs, xs_bar, ks, Ks)
    _, (xs_tail, us_new, vs_new) = jax.lax.scan(f, x0, inps)
    xs = jnp.concatenate([x0[None], xs_tail], axis=0)
    return xs, us_new, vs_new


def _traj_value(run_cost, term_cost, ts, dt, xs, us, vs):
    run = jax.vmap(run_cost)(ts, xs[:-1], us, vs)
    return term_cost(xs[-1]) + dt * jnp.sum(run)


def ddp_minimax(
    step_fn: Callable,
    term_cost: Callable,
    x0: jnp.ndarray,
    horizon: float,
    n_steps: int,
    nu: int,
    nv: int = 0,
    run_cost: Callable | None = None,
    u_init: jnp.ndarray | None = None,
    v_init: jnp.ndarray | None = None,
    cfg: DDPConfig = DDPConfig(),
) -> DDPResult:
    """Solve the two-player trajectory game from one initial state.

    min over u, max over v of ``term_cost(x_T) + ∫ run_cost dt`` subject to
    ``x_{t+1} = step_fn(t, x, u, v, dt)`` with ``dt = horizon/n_steps``.
    Jit/vmap-friendly throughout: fixed ``cfg.iters`` scan, static shapes.

    The reference analog is ``VarHJIApprox`` + the ``DDPReach`` driver's
    backward/forward passes (``ddp_reach.py:78-85``, unimplemented
    upstream).
    """
    x0 = jnp.asarray(x0)
    # The (n x n) value recursion is numerically delicate (products of
    # ~|phi| magnitudes); reduced-precision matmul inputs (bf16, or TF32
    # on a GPU) NaN the Vxx recursion for physically-scaled problems —
    # force full-precision matmuls; the matrices are tiny.
    with jax.default_matmul_precision("highest"):
        return _ddp_minimax_impl(step_fn, term_cost, x0, horizon, n_steps,
                                 nu, nv, run_cost, u_init, v_init, cfg)


def _ddp_minimax_impl(step_fn, term_cost, x0, horizon, n_steps, nu, nv,
                      run_cost, u_init, v_init, cfg):
    dt = horizon / n_steps
    ts = dt * jnp.arange(n_steps, dtype=x0.dtype)
    rc = run_cost if run_cost is not None \
        else (lambda t, x, u, v: jnp.zeros((), x.dtype))
    us0 = jnp.zeros((n_steps, nu), x0.dtype) if u_init is None \
        else jnp.broadcast_to(u_init, (n_steps, nu)).astype(x0.dtype)
    vs0 = jnp.zeros((n_steps, nv), x0.dtype) if v_init is None \
        else jnp.broadcast_to(v_init, (n_steps, nv)).astype(x0.dtype)

    xs0, _, _ = _rollout(step_fn, ts, dt, x0, us0, vs0)
    val0 = _traj_value(rc, term_cost, ts, dt, xs0, us0, vs0)

    def iteration(carry, _):
        xs, us, vs, val = carry
        ks, Ks = _backward(step_fn, rc, term_cost, ts, dt, xs, us, vs,
                           cfg.reg)
        xs_new, us_new, vs_new = _rollout(
            step_fn, ts, dt, x0, us, vs, xs_bar=xs[:-1], ks=ks, Ks=Ks,
            step=cfg.step, nu=nu)
        val_new = _traj_value(rc, term_cost, ts, dt, xs_new, us_new, vs_new)
        diag = (jnp.max(jnp.abs(ks)), val_new - val)
        return (xs_new, us_new, vs_new, val_new), diag

    (xs, us, vs, val), (gain_norms, improvements) = jax.lax.scan(
        iteration, (xs0, us0, vs0, val0), None, length=cfg.iters)
    return DDPResult(value=val, xs=xs, us=us, vs=vs,
                     gain_norms=gain_norms, improvements=improvements)


def _system_step_fn(system, nu: int, nv: int, squash: float | None):
    """Adapt a :class:`System` to the flat-vector ``step_fn`` signature,
    honoring its u/d optimisation senses.  Returns ``(step_fn, u_is_min)``
    where ``u_is_min`` says whether the system's *control* landed in the
    minimizing slot (else the disturbance did)."""
    u_is_min = system.u_mode == "min"

    def step_fn(t, x, w_min, w_max, dt):
        u, d = (w_min, w_max) if u_is_min else (w_max, w_min)
        if squash is not None:
            u = squash * jnp.tanh(u / squash)
            d = squash * jnp.tanh(d / squash)
        state = system.step_state(
            t, x, tuple(u[i] for i in range(u.shape[0])),
            tuple(d[i] for i in range(d.shape[0])), dt)
        return state

    return step_fn, u_is_min


def varhji_reach(
    system,
    x0s: jnp.ndarray,
    tau,
    target_fn: Callable,
    n_steps: int = 32,
    nu: int = 1,
    nv: int = 1,
    squash: float | None = None,
    cfg: DDPConfig = DDPConfig(),
):
    """Approximate the BRT value at sampled states via scheduled trajectory
    games — the ``VarHJIApprox`` capability (``var_hji_approx.py:15``,
    ``ddp_reach.py:64-85``) as one vmapped XLA program.

    For every initial state ``x0s[b]`` and every horizon ``tau[k] > 0``, a
    terminal-cost game ``min_u max_v target_fn(x(tau_k))`` is solved by
    :func:`ddp_minimax` (with the system's ``u_mode``/``d_mode`` deciding
    which physical player occupies which slot); the BRT value is the min
    over the horizon schedule, matching ``min_t V(x, t)`` BRT semantics
    (and the reference's ``value_buff`` max-accumulation up to its
    sign/direction conventions, ``ddp_reach.py:85``).

    ``target_fn`` maps a state vector ``(n,)`` to the implicit target value
    (e.g. a smooth SDF — keep it differentiable; squared distances behave
    best).  ``squash``: optional tanh saturation bound applied to both
    players' inputs (bounded-control games, e.g. |u| <= 1).

    Returns ``(values, per_tau)`` with shapes ``(B,)`` and ``(B, K)``.
    """
    x0s = jnp.atleast_2d(jnp.asarray(x0s))
    taus = jnp.atleast_1d(jnp.asarray(tau, x0s.dtype))
    taus = jnp.where(taus <= 0, jnp.finfo(x0s.dtype).eps, taus)
    step_fn, _ = _system_step_fn(system, nu, nv, squash)

    def one(x0, horizon):
        res = ddp_minimax(step_fn, target_fn, x0, horizon, n_steps,
                          nu=nu, nv=nv, cfg=cfg)
        return res.value

    per_tau = jax.vmap(jax.vmap(one, in_axes=(None, 0)),
                       in_axes=(0, None))(x0s, taus)
    # t=0 membership: the target value itself
    v0 = jax.vmap(target_fn)(x0s)
    values = jnp.minimum(v0, jnp.min(per_tau, axis=1))
    return values, per_tau
