"""Preconditioned conjugate gradients under `lax.while_loop`.

Replacement for the reference's KSP solve (`src/solver/
kle_solver.py:49-64`, GMRES+LU ~= direct). The penalized KLE operator K is
symmetric positive definite on the free subspace, so CG is the natural Krylov
method. The inner product is pluggable: the single-device path uses a plain
vdot, the slab-sharded path an ownership-masked `psum` dot (SURVEY §2.3).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class CGResult(NamedTuple):
    x: jax.Array
    iters: jax.Array
    residual: jax.Array


def _vdot(a, b):
    return jnp.vdot(a.ravel(), b.ravel(),
                    precision=jax.lax.Precision.HIGHEST)


def pcg(A: Callable, b: jax.Array, x0: jax.Array,
        M_inv: Callable | None = None, rtol: float = 1e-12,
        atol: float = 0.0, maxiter: int = 1000,
        dot: Callable | None = None, A0: Callable | None = None) -> CGResult:
    """Solve A x = b with preconditioned CG.

    A and M_inv are linear callables on arrays of b's shape. Stopping:
    ||r||_2 <= max(rtol * ||b||_2, atol), capped at maxiter iterations.

    A0, when given, is used ONLY for the initial residual r0 = b - A0(x0):
    the caller guarantees A(v) == A0(v) for every vector the LOOP produces
    (here: the Dirichlet-condensed KLE operator, whose loop iterates are
    exactly zero on constrained dofs, so the in-loop input mask and the
    `con*v` passthrough are dropped — two full HBM passes per iteration,
    bitwise-identical trajectory; see local_engine._masked_solve).
    """
    if M_inv is None:
        M_inv = lambda r: r
    if dot is None:
        dot = _vdot

    r0 = b - (A0 if A0 is not None else A)(x0)
    z0 = M_inv(r0)
    gamma0 = dot(r0, z0)
    rr0 = dot(r0, r0)
    bnorm2 = dot(b, b)
    tol2 = jnp.maximum(rtol * jnp.sqrt(bnorm2), atol) ** 2

    def cond(state):
        x, r, z, p, gamma, rr, k = state
        # gamma == 0: exact convergence (or M-degenerate breakdown) — the
        # next beta would be 0/0. bnorm2 == 0: A SPD => x = 0, no iterations
        # (PETSc KSPConvergedDefault's zero-rhs semantics); without this the
        # atol=0 default makes tol2 == 0 unreachable in floating point and
        # gamma underflow turns the solve into NaNs. ||r||^2 is carried in
        # the state (computed in body where it fuses with the z/gamma pass)
        # so cond reads scalars only — no extra full pass over r per
        # iteration.
        run = jnp.logical_and(rr > tol2, k < maxiter)
        return jnp.logical_and(run, jnp.logical_and(gamma > 0, bnorm2 > 0))

    def body(state):
        x, r, z, p, gamma, rr, k = state
        Ap = A(p)
        pAp = dot(p, Ap)
        alpha = jnp.where(pAp > 0, gamma / jnp.where(pAp > 0, pAp, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        gamma_new = dot(r, z)
        rr_new = dot(r, r)
        beta = gamma_new / gamma
        p = z + beta * p
        return (x, r, z, p, gamma_new, rr_new, k + 1)

    state = (x0, r0, z0, z0, gamma0, rr0, jnp.array(0, dtype=jnp.int32))
    x, r, _, _, _, rr, k = jax.lax.while_loop(cond, body, state)
    x = jnp.where(bnorm2 > 0, x, jnp.zeros_like(x))
    return CGResult(x=x, iters=k, residual=jnp.sqrt(rr))
