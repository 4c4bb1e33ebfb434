"""Slab-sharded IBM velocity correction (domain-decomposed H/S).

The reference runs IBM cases under ``mpiexec -n N`` like every case
(`src/cases/immersed_boundary.py` is rank-aware through PETSc's distributed
H/S AIJ matrices). Here the correction is

    H-gather   : (L, dim) = sum over Euler support nodes   (tiny output)
    (L,L) solve: replicated dense Cholesky                  (tiny)
    S-scatter  : add w * z * dl * h onto the support nodes

so under the slab decomposition of `parallel/sharded_engine.py` the H/S
tables are expressed in LOCAL SLOT ids of each shard's element-local state
(exactly how `FuncSide` boundary scatters shard, sharded_engine.py:104-119):
each shard gathers its partial contribution of H·v with ownership-corrected
weights (w / slot-multiplicity), one `psum` replicates the full (L, dim)
interpolation, the dense solve is computed redundantly on every device, and
each shard scatters the correction onto the slots it owns — keeping the
local state consistent (all slots of a node receive the same add).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def build_node_slot_map(mesh, ndev: int):
    """Position-INDEPENDENT node -> global-slot map (mesh connectivity
    only, built once): (slots_of (n_nodes, maxm) with pad = E*nn, counts
    (n_nodes,)). The per-step shard-local conversion for a MOVING body is
    then a pure gather + range test (`dynamic_tables_local`), so the
    whole dynamic rebuild stays in-jit."""
    cn = np.asarray(mesh.cell_nodes)
    E, nn = cn.shape
    if E % ndev != 0:
        raise ValueError(f"n_cells={E} not divisible by {ndev} devices")
    n_nodes = mesh.n_nodes
    counts = np.bincount(cn.ravel(), minlength=n_nodes)
    maxm = int(counts.max())
    order = np.argsort(cn.ravel(), kind="stable")
    flat = cn.ravel()[order]
    starts = np.r_[0, np.cumsum(counts[:-1])]
    within = np.arange(flat.size) - starts[flat]
    slots_of = np.full((n_nodes, maxm), E * nn, dtype=np.int64)
    slots_of[flat, within] = order
    return slots_of, counts


def dynamic_tables_local(slots_of, counts, nodes, w, nloc: int, shard_idx):
    """In-jit conversion of GLOBAL support tables (L, Kd) to THIS shard's
    local-slot tables (L, S) — the moving-body analog of
    `build_ibm_shard_tables`, with identical semantics: `nloc = E_loc*nn`
    is the local pad id, gather weights are ownership-corrected w/mult,
    scatter weights are plain w (all dropped outside the shard)."""
    gsl = slots_of[nodes]                                # (L, Kd, maxm)
    lo = shard_idx * nloc
    m = (gsl >= lo) & (gsl < lo + nloc)
    loc = jnp.where(m, gsl - lo, nloc).astype(jnp.int32)
    gw = jnp.where(m, (w / counts[nodes])[..., None], 0.0)
    sw = jnp.where(m, w[..., None], 0.0)
    L = nodes.shape[0]
    return (loc.reshape(L, -1), gw.reshape(L, -1).astype(w.dtype),
            sw.reshape(L, -1).astype(w.dtype))


def build_ibm_shard_tables(mesh, nodes_tab, w_tab, ndev: int):
    """Per-shard local-slot tables for the H/S application.

    Returns (slots, gw, sw): each (ndev, L, S) with S = K^dim * max-slot-
    multiplicity. `slots` holds LOCAL slot ids into the shard's flattened
    (E_loc*nn) node axis (pad/out-of-shard = E_loc*nn, dropped by OOB
    gather/scatter modes); `gw` are H-gather weights w/mult (summing a
    node's slots over ALL shards reproduces the nodal value once); `sw` are
    S-scatter weights w (every slot of a node receives the full add)."""
    cn = np.asarray(mesh.cell_nodes)
    E, nn = cn.shape
    E_loc = E // ndev
    n_nodes = mesh.n_nodes
    slots_of, counts = build_node_slot_map(mesh, ndev)

    nodes = np.asarray(nodes_tab)                       # (L, Kd)
    w = np.asarray(w_tab, dtype=np.float64)             # (L, Kd)
    L, Kd = nodes.shape
    maxm = slots_of.shape[1]
    gslots = slots_of[nodes]                            # (L, Kd, maxm)
    valid = gslots < E * nn
    gw_g = np.where(valid, (w / counts[nodes])[..., None], 0.0)
    sw_g = np.where(valid, w[..., None], 0.0)

    S = Kd * maxm
    pad_loc = E_loc * nn
    slots = np.full((ndev, L, S), pad_loc, dtype=np.int32)
    gw = np.zeros((ndev, L, S))
    sw = np.zeros((ndev, L, S))
    fslots = gslots.reshape(L, S)
    for d in range(ndev):
        lo, hi = d * pad_loc, (d + 1) * pad_loc
        m = (fslots >= lo) & (fslots < hi)
        slots[d][m] = (fslots[m] - lo).astype(np.int32)
        gw[d][m] = gw_g.reshape(L, S)[m]
        sw[d][m] = sw_g.reshape(L, S)[m]
    return slots, gw, sw


def correction_local(slots, gw, sw, chol, scale, vel_l, body_vel,
                     axis_name: str):
    """Shard-local velocity correction on the element-local state.

    vel_l: (E_loc, nn*dim) canonical local layout. Returns (corrected
    vel_l, flux) with flux the replicated (L, dim) virtual flux — identical
    on every shard after the psum."""
    L = slots.shape[0]
    dim = body_vel.shape[1]
    vf = vel_l.reshape(-1, dim)
    vfp = jnp.concatenate([vf, jnp.zeros((1, dim), dtype=vf.dtype)])
    hv = jnp.einsum("ls,lsc->lc", gw, vfp[slots],
                    precision=jax.lax.Precision.HIGHEST)
    hv = jax.lax.psum(hv, axis_name)
    flux = jax.scipy.linalg.cho_solve((chol, True), body_vel - hv)
    vals = sw[:, :, None] * flux[:, None, :] * scale
    corr = jnp.zeros_like(vf).at[slots.reshape(-1)].add(
        vals.reshape(-1, dim), mode="drop")
    return (vf + corr).reshape(vel_l.shape), flux


def correction_cg_local(slots, gw, sw, scale, vel_l, body_vel, flux0,
                        axis_name: str, rtol=1e-10, maxiter=200):
    """MATRIX-FREE shard-local velocity correction (moving bodies): solve
    C z = v_body - H v by CG where each application of C = H S is one
    local scatter + local gather + one `psum` across the slab shards —
    the dense Cholesky core is never formed, so the per-step table
    rebuild of a dynamic body needs no host assembly (the sharded analog
    of `interpolation.correction_cg`; reference rebuilds PETSc matrices
    per step rank-parallel, `immersed_boundary.py:366-385`).

    The flux iterates are REPLICATED (L, dim) arrays: the psum inside H
    makes every shard's Krylov scalars identical, so the CG dots are
    shard-local. Returns (corrected vel_l, flux, (iters, relres))."""
    from pynama_tpu.solver.cg import pcg

    dim = body_vel.shape[1]
    vf = vel_l.reshape(-1, dim)
    pad = jnp.zeros((1, dim), dtype=vf.dtype)

    def H(vflat):
        vfp = jnp.concatenate([vflat, pad])
        hv = jnp.einsum("ls,lsc->lc", gw, vfp[slots],
                        precision=jax.lax.Precision.HIGHEST)
        return jax.lax.psum(hv, axis_name)

    def S(z):
        vals = sw[:, :, None] * z[:, None, :] * scale
        return jnp.zeros_like(vf).at[slots.reshape(-1)].add(
            vals.reshape(-1, dim), mode="drop")

    # Jacobi diag(C)[l] = scale * sum_k w_lk^2: each of a node's `mult`
    # slots contributes (w/mult)*w, summed over shards by the psum
    d = jax.lax.psum(jnp.sum(gw * sw, axis=1), axis_name)[:, None] * scale
    rhs = body_vel - H(vf)
    res = pcg(lambda z: H(S(z)), rhs, flux0, M_inv=lambda r: r / d,
              rtol=rtol, maxiter=maxiter)
    relres = res.residual / (jnp.sqrt(jnp.sum(rhs * rhs)) + 1e-300)
    return (vf + S(res.x)).reshape(vel_l.shape), res.x, \
        (res.iters, relres)
