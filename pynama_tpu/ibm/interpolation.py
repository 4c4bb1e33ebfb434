"""Lagrangian<->Eulerian interpolation (the IBM H/S matrices).

Redesign of the reference's PETSc AIJ machinery
(`src/cases/immersed_boundary.py:170-246`): on the structured GLL grid, each
Lagrangian node's Eulerian support is a FIXED (K^dim) window of grid nodes
found by per-axis binary search, so H is a static-shape (L, K^dim) index +
weight table instead of a dynamically preallocated sparse matrix. Because H
acts identically on each velocity component, the normal matrix A = H S is
kron(C, I_dim) with a tiny dense (L, L) core C — assembled and
Cholesky-factored on device, so the dynamic case's rebuild-per-step
(`immersed_boundary.py:366-385`) is a fixed-shape jittable recompute, not a
matrix-structure change.

Beyond the reference (which restricts IBM to ngl<4 and 2D,
`immersed_boundary.py:36`): the regularized deltas are evaluated in INDEX
space — per axis, a Lagrangian point maps to its fractional node index
eta(X) (piecewise-linear inverse of the axis coordinates) and the kernel
argument is |i - eta|. The node-index grid is uniform BY CONSTRUCTION for
any node spacing, so the kernels' discrete identities (zeroth moment
exactly 1 — what makes the correction enforce rigid-body velocity exactly)
hold on clustered GLL spacings just as on the reference's uniform ngl<=3
grids, where the two formulations coincide node-for-node. The same tables
work unchanged in 3D (K^3 windows).

Scalings: H rows are dimensionless kernel products (row sum 1); the spread
carries the reference's dl*h column scale and C = H S = (W Wᵀ)·dl·h
(`immersed_boundary.py:199-205`), keeping virtual fluxes (hence cd/cl
histories) on the reference's scale. The velocity correction itself is
invariant to the spread scaling (v += S (H S)^-1 r is unchanged under
S -> alpha S).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pynama_tpu.ibm.bodies import KERNELS, KERNEL_SUPPORT


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IBMOps:
    """Static grid-side tables for the interpolation."""
    axes: tuple              # dim (np_d,) per-axis grid coordinates
    h: jax.Array             # node separation (flux/force scale, 0-d)
    dl: jax.Array            # body measure per Lagrangian point (0-d)
    kernel: str = dataclasses.field(metadata=dict(static=True))
    #: per-axis window width: the kernel support in INDEX units is fixed
    #: (2*ceil(support)+1 nodes) regardless of physical spacing
    kside: int = dataclasses.field(default=5, metadata=dict(static=True))

    @property
    def dim(self):
        return len(self.axes)

    @property
    def n_nodes(self):
        return int(np.prod([a.shape[0] for a in self.axes]))


def make_ibm_ops(mesh, dl, kernel="fourGrid", dtype=jnp.float32) -> IBMOps:
    assert getattr(mesh, "is_box", False), \
        "IBM requires a structured box mesh (as the reference)"
    axes_np = [np.asarray(a) for a in mesh.axis_coords]
    kside = 2 * int(np.ceil(KERNEL_SUPPORT[kernel])) + 1
    kside = min(kside, min(a.shape[0] for a in axes_np))
    return IBMOps(axes=tuple(jnp.asarray(a, dtype=dtype) for a in axes_np),
                  h=jnp.asarray(mesh.node_separation(), dtype=dtype),
                  dl=jnp.asarray(dl, dtype=dtype), kernel=kernel,
                  kside=kside)


def support_tables(ops: IBMOps, body_xy: jax.Array):
    """(L, K^dim) Euler node ids and index-space dirac weights for the
    Lagrangian points (each row sums to 1 exactly).

    Pure jnp (jittable) — the dynamic case recomputes this every step with
    the same shapes (reference rebuildMatrix, immersed_boundary.py:379-385).
    """
    phi = KERNELS[ops.kernel]
    K = ops.kside
    half = K // 2

    def axis_window(axis_coords, x):
        n = axis_coords.shape[0]
        j = jnp.clip(jnp.searchsorted(axis_coords, x) - 1, 0, n - 2)
        frac = (x - axis_coords[j]) / (axis_coords[j + 1] - axis_coords[j])
        eta = j.astype(x.dtype) + frac              # fractional node index
        i0 = jnp.clip(j - half, 0, n - K)
        idx = i0[:, None] + jnp.arange(K)[None, :]  # (L, K)
        w = phi(jnp.abs(idx.astype(x.dtype) - eta[:, None]))
        return idx, w

    wins = [axis_window(a, body_xy[:, d]) for d, a in enumerate(ops.axes)]
    L = body_xy.shape[0]
    dim = ops.dim
    if dim == 2:
        (ix, wx), (iy, wy) = wins
        npy = ops.axes[1].shape[0]
        nodes = ix[:, :, None] * npy + iy[:, None, :]
        w = wx[:, :, None] * wy[:, None, :]
    else:
        (ix, wx), (iy, wy), (iz, wz) = wins
        npy, npz = ops.axes[1].shape[0], ops.axes[2].shape[0]
        nodes = (ix[:, :, None, None] * npy
                 + iy[:, None, :, None]) * npz + iz[:, None, None, :]
        w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    return nodes.reshape(L, K**dim), w.reshape(L, K**dim)


def interp_H(ops: IBMOps, nodes, w, vel_nodal: jax.Array) -> jax.Array:
    """H . vel: (n_nodes, dim) -> (L, dim); rows sum to 1 exactly, so
    constant fields (rigid-body velocities) are reproduced exactly."""
    ve = vel_nodal[nodes]                 # (L, K^dim, dim)
    return jnp.einsum("lk,lkc->lc", w, ve,
                      precision=jax.lax.Precision.HIGHEST)


def spread_S(ops: IBMOps, nodes, w, flux: jax.Array,
             n_nodes: int) -> jax.Array:
    """S . flux: (L, dim) -> (n_nodes, dim), dl*h column scaling
    (reference immersed_boundary.py:199-205)."""
    dim = ops.dim
    vals = w[:, :, None] * flux[:, None, :] * (ops.dl * ops.h)
    out = jnp.zeros((n_nodes, dim), dtype=flux.dtype)
    return out.at[nodes.reshape(-1)].add(
        vals.reshape(-1, dim), mode="drop")


def normal_core(ops: IBMOps, nodes, w) -> jax.Array:
    """C (L, L): the per-component core of A = H S = kron(C, I_dim).

    C[l,m] = dl*h * sum over shared Euler nodes of w_l w_m."""
    eq = (nodes[:, None, :, None] == nodes[None, :, None, :])
    overlap = jnp.einsum("lk,mj,lmkj->lm", w, w, eq.astype(w.dtype),
                         precision=jax.lax.Precision.HIGHEST)
    return overlap * ops.h * ops.dl


def normal_core_spgemm(ops: IBMOps, nodes, w) -> np.ndarray:
    """Host assembly of C for large supports (3D: the jittable eq-tensor is
    (L,L,K^3,K^3) — too big) via sparse W Wᵀ.

    W is the (L, n_nodes) interpolation-weight matrix in CSR (each row is
    one Lagrangian point's K^dim window — distinct columns by construction),
    and C = W Wᵀ is exactly the SpGEMM the reference computes as
    PETSc H.matMult(S) (`immersed_boundary.py:199-206`) — here through the
    framework's own `sparse/spgemm.py`, fully vectorized."""
    from pynama_tpu.sparse.formats import COO
    from pynama_tpu.sparse.spgemm import spgemm

    nodes = np.asarray(nodes)
    wv = np.asarray(w, dtype=np.float64)
    L, Kd = nodes.shape
    rows = np.repeat(np.arange(L, dtype=np.int64), Kd)
    cols = nodes.ravel().astype(np.int64)
    vals = wv.ravel()
    W = COO(row=rows, col=cols, data=vals, shape=(L, ops.n_nodes))
    Wt = COO(row=cols, col=rows, data=vals, shape=(ops.n_nodes, L))
    Ccsr = spgemm(W, Wt)
    C = np.zeros((L, L))
    indptr = np.asarray(Ccsr.indptr)
    r = np.repeat(np.arange(L), np.diff(indptr))
    C[r, np.asarray(Ccsr.indices)] = np.asarray(Ccsr.data)
    return C * float(ops.h) * float(ops.dl)


def correction_cg(ops: IBMOps, nodes, w, vel_nodal, body_vel, flux0,
                  n_nodes, rtol=1e-10, maxiter=200):
    """Velocity correction with a MATRIX-FREE solve of C z = -(H v - v_body).

    C = H S is never formed: each CG iteration applies z -> H(S z) through
    the same gather/scatter tables the correction itself uses, so the whole
    per-step work of a MOVING body (tables + solve + spread) is one jittable
    device program — no host assembly (the reference rebuilds PETSc matrices
    per step, `immersed_boundary.py:366-385`; the previous fallback here ran
    a host O(sum fanin^2) loop per step for large 3D supports). C is the
    Gram matrix W Wᵀ (SPD), so CG converges fast, and `flux0` warm-starts
    from the previous step's flux. Returns (vel_correction, flux,
    (iters, relative_residual)) — the stats let callers detect a stalled
    solve (CG hitting maxiter leaves the rigid-body constraint silently
    under-enforced otherwise)."""
    from pynama_tpu.solver.cg import pcg

    def A(z):
        return interp_H(ops, nodes, w, spread_S(ops, nodes, w, z, n_nodes))

    # Jacobi: diag(C) = dl*h * sum_k w_k^2 per row, same for each component
    d = (jnp.sum(w * w, axis=1) * ops.h * ops.dl)[:, None]
    rhs = body_vel - interp_H(ops, nodes, w, vel_nodal)
    res = pcg(A, rhs, flux0, M_inv=lambda r: r / d, rtol=rtol,
              maxiter=maxiter)
    corr = spread_S(ops, nodes, w, res.x, n_nodes)
    relres = res.residual / (jnp.sqrt(jnp.sum(rhs * rhs)) + 1e-300)
    return corr, res.x, (res.iters, relres)


def correction(ops: IBMOps, nodes, w, chol, vel_nodal, body_vel, n_nodes):
    """One velocity correction (reference computeVelocityCorrection,
    immersed_boundary.py:162-168): solve C z = -(H v - v_body) per
    component, return (vel_correction, virtual_flux)."""
    rhs = interp_H(ops, nodes, w, vel_nodal) - body_vel
    flux = jax.scipy.linalg.cho_solve((chol, True), -rhs)
    corr = spread_S(ops, nodes, w, flux, n_nodes)
    return corr, flux
