"""Fast-diagonalization (FDM) preconditioner for the penalized KLE operator.

The penalty-aware decomposition called for in docs/DESIGN.md §4. The element
KLE operator is K = L⊗I_dim + α_d·(div penalty) + α_w·(curl penalty)
(`elements/kle.py:175-203`, reference `src/domain/elements/spectral.py:
96-160`): its unpenalized part is the componentwise scalar weak Laplacian S.
In the continuum every velocity mode splits into a longitudinal part (div
carries the full gradient energy) and a transverse part (curl does), so the
S-preconditioned spectrum of K collapses into CLUSTERS near {1, 1+α_w,
1+α_d} — the α=1e3 spread that defeats Jacobi/coarse-space methods becomes a
few tight clusters that CG annihilates in a handful of iterations each.

S is exactly invertible on a tensor-product box mesh by global fast
diagonalization (Lynch-Rice-Thomas; the classic SEM Poisson solver of
Deville-Fischer-Mund §4.5): with per-axis assembled 1D stiffness A_d and
mass B_d (same full-quadrature family as the element K),

    S = A_0⊗B_1⊗B_2 + B_0⊗A_1⊗B_2 + B_0⊗B_1⊗A_2,

and with the generalized eigenbasis A_d Q_d = B_d Q_d Λ_d (Q_dᵀB_dQ_d = I)

    S⁻¹ = (Q_0⊗Q_1⊗Q_2) · diag(λ_i+λ_j+λ_k)⁻¹ · (Q_0ᵀ⊗Q_1ᵀ⊗Q_2ᵀ).

One application = 2·dim small dense matmuls over the global grid — pure matmul
work, comparable in cost to a single element-local K application. Dirichlet
condensation stays exact whenever the per-component free mask is a tensor
product of per-axis 1D masks (true for every whole-wall BC configuration:
main solves constrain all boundary components; the no-slip FS stage
constrains component c exactly on its two normal walls). Non-tensor masks
fall back to the smallest covering tensor mask — the preconditioner stays
SPD on the free subspace (congruence restriction of an SPD inverse), only
its clustering degrades.
"""
from __future__ import annotations

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

from pynama_tpu.basis.lagrange import lagrange_basis
from pynama_tpu.basis.quadrature import gauss_points, lobatto_points

logger = logging.getLogger("pynama_tpu.fdm")

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FDMOps:
    """Everything one masked-system FDM application needs (pytree)."""
    #: per-axis stacked eigenbases, (ncomp, n1d_d, n1d_d); columns beyond
    #: the free-subspace dimension are zero (static shapes)
    Qs: tuple
    #: 1/(sum of per-axis eigenvalues) per node and component, (n_nodes, c)
    dinv: jax.Array
    #: per-mode (ncomp, ncomp) INVERSE blocks of the exact mode-block-
    #: diagonal of the transformed operator (captures the cross-component
    #: penalty coupling the scalar dinv misses — the FS-stage fix);
    #: (ncomp, ncomp) + npts, or None for the scalar-diagonal form
    binv: object
    #: representative element slot of each global node, (n_nodes,) into E*nn
    rep_rows: jax.Array
    #: (E, nn) global node id per element slot (local scatter-back gather)
    cell_nodes: jax.Array
    #: Jacobi coefficients (leftover_mask / K_diag) for the few free dofs
    #: outside the largest contained tensor mask (FS corner rule), (n,c)
    jleft: jax.Array
    npts: tuple = dataclasses.field(metadata=dict(static=True))
    ncomp: int = dataclasses.field(metadata=dict(static=True))


def _assemble_1d(ngl: int, ne: int, mat_e: np.ndarray) -> np.ndarray:
    n1d = ne * (ngl - 1) + 1
    M = np.zeros((n1d, n1d))
    for e in range(ne):
        s = e * (ngl - 1)
        M[s:s + ngl, s:s + ngl] += mat_e
    return M


def _axis_matrices_1d(ngl: int, length: float, ne: int):
    """Assembled global 1D matrices for one mesh axis: (A, B, Ar, Br) =
    full-quadrature stiffness/mass (same family as the element K: Gauss if
    ngl<=3 else GLL, `basis/tables.py make_tensor_basis`) and
    reduced-quadrature (Gauss(ngl-1)) stiffness/mass, the 1D factors of the
    div/curl penalty blocks."""
    nodes1d, _ = lobatto_points(ngl)
    if ngl <= 3:
        q1, w1 = gauss_points(ngl)
    else:
        q1, w1 = lobatto_points(ngl)
    he = length / ne

    def pair(q, w):
        h, dh = lagrange_basis(nodes1d, q)       # (nq, ngl)
        A_e = (2.0 / he) * (dh.T @ (w[:, None] * dh))
        B_e = (he / 2.0) * (h.T @ (w[:, None] * h))
        return _assemble_1d(ngl, ne, A_e), _assemble_1d(ngl, ne, B_e)

    A, B = pair(q1, w1)
    qr, wr = gauss_points(ngl - 1)
    Ar, Br = pair(qr, wr)
    # mixed reduced-quadrature factor D̃ᵀW H̃ (the 1D piece of the CROSS-
    # component penalty blocks): physical scales cancel, (2/he)(he/2) = 1
    h, dh = lagrange_basis(nodes1d, qr)
    C_e = dh.T @ (wr[:, None] * h)
    Cr = _assemble_1d(ngl, ne, C_e)
    return A, B, Ar, Br, Cr


def _gen_eigh(A: np.ndarray, B: np.ndarray):
    """Generalized symmetric eig A q = λ B q with qᵀBq = I (numpy-only)."""
    L = np.linalg.cholesky(B)
    Linv = np.linalg.inv(L)
    lam, Y = np.linalg.eigh(Linv @ A @ Linv.T)
    return lam, Linv.T @ Y


def _axis_free_masks(mask_c: np.ndarray, npts: tuple):
    """Largest per-axis-factorable (tensor-product) free mask CONTAINED in
    one component's node mask, plus the leftover free dofs it misses.

    Starting from the covering ("any free in plane") factors, refine each
    axis to "free everywhere the other factors expect free" until a
    fixpoint. Containment matters: a too-large tensor mask frees whole wall
    lines (the FS-stage corner rule frees corner dofs only), turning the 1D
    eigenproblem Neumann and poisoning the denominators with near-zero
    modes. The leftover dofs (isolated corners) get Jacobi instead."""
    m = mask_c.reshape(npts)
    dim = len(npts)
    factors = [np.moveaxis(m, d, 0).reshape(npts[d], -1).any(axis=1)
               for d in range(dim)]
    for _ in range(dim + 1):
        changed = False
        for d in range(dim):
            others = [factors[e] for e in range(dim) if e != d]
            sel = functools.reduce(np.multiply.outer, others) \
                if others else np.ones((), bool)
            md = np.moveaxis(m, d, 0).reshape(npts[d], -1)
            new = (md | ~sel.reshape(-1)[None, :]).all(axis=1) & factors[d]
            changed |= bool((new != factors[d]).any())
            factors[d] = new
        if not changed:
            break
    outer = functools.reduce(np.multiply.outer, factors)
    leftover = m & ~outer
    return factors, leftover.reshape(-1)


def build_fdm(mesh, free_mask_np: np.ndarray, dtype,
              diag_global: np.ndarray | None = None,
              alpha_w: float | None = None,
              alpha_d: float | None = None,
              block: bool = True) -> FDMOps | None:
    """FDM data for one masked system; None when the mesh has no tensor
    structure. free_mask_np: (n_nodes, dim) bool/float free-dof mask.

    The denominator is the EXACT diagonal of the eigenbasis-transformed
    operator QᵀKQ ("Jacobi in the FDM eigenbasis"): the stiffness part is
    Λ_0⊕Λ_1⊕Λ_2 by construction, and each penalty diagonal block is a
    Kronecker product of reduced-quadrature 1D matrices, so its transformed
    diagonal is the Kronecker product of per-axis diagonals
    diag(QᵀÃᵣQ)/diag(QᵀB̃ᵣQ). Without the penalty terms the FS-stage mask
    (tangential wall dofs free) leaves S with near-null wall-constant modes
    that K penalizes heavily — measured 1325 CG iterations vs Jacobi's 521;
    with them the same solve drops to a small fraction (see DESIGN.md §4)."""
    if not getattr(mesh, "is_box", False):
        return None
    from pynama_tpu.elements.kle import ALPHA_D, ALPHA_W
    aw = ALPHA_W if alpha_w is None else alpha_w
    ad = ALPHA_D if alpha_d is None else alpha_d
    dim, ngl = mesh.dim, mesh.ngl
    npts = tuple(mesh.npts)
    free = np.asarray(free_mask_np).astype(bool).reshape(mesh.n_nodes, dim)

    AB = [_axis_matrices_1d(ngl, mesh.upper[d] - mesh.lower[d],
                            mesh.nelem[d]) for d in range(dim)]

    Qs = [np.zeros((dim, npts[d], npts[d])) for d in range(dim)]
    lams = [np.ones((dim, npts[d])) for d in range(dim)]   # stiffness eigs
    gds = [np.zeros((dim, npts[d])) for d in range(dim)]   # diag QᵀÃᵣQ
    mrs = [np.zeros((dim, npts[d])) for d in range(dim)]   # diag QᵀB̃ᵣQ
    jleft = np.zeros((mesh.n_nodes, dim))
    for c in range(dim):
        factors, leftover = _axis_free_masks(free[:, c], npts)
        if leftover.any():
            logger.info("FDM: component %d free mask is not a tensor "
                        "product; %d leftover dofs get Jacobi",
                        c, int(leftover.sum()))
            if diag_global is None:
                return None
            jleft[:, c] = leftover / np.asarray(diag_global)[:, c]
        for d in range(dim):
            f = np.where(factors[d])[0]
            if f.size == 0:
                return None     # degenerate: nothing free along an axis
            A, B, Ar, Br, _Cr = AB[d]
            lam, Q = _gen_eigh(A[np.ix_(f, f)], B[np.ix_(f, f)])
            lam = np.maximum(lam, 0.0)
            Qs[d][c][np.ix_(f, np.arange(f.size))] = Q
            lams[d][c, :f.size] = lam
            lams[d][c, f.size:] = 1.0   # padded slots (zero Q columns)
            gds[d][c, :f.size] = np.einsum(
                "if,ij,jf->f", Q, Ar[np.ix_(f, f)], Q)
            mrs[d][c, :f.size] = np.einsum(
                "if,ij,jf->f", Q, Br[np.ix_(f, f)], Q)

    # denom[c, modes] = sum_d lam + ad*div-diag + aw*curl-diag
    grids = np.meshgrid(*[np.arange(n) for n in npts], indexing="ij")
    dsum = np.zeros((dim,) + npts)
    for c in range(dim):
        lam_sum = np.zeros(npts)
        for d in range(dim):
            lam_sum = lam_sum + lams[d][c][grids[d]]

        def pen_term(deriv_axis):
            # Ãᵣ along deriv_axis, B̃ᵣ along the others
            acc = np.ones(npts)
            for e in range(dim):
                v = gds[e][c] if e == deriv_axis else mrs[e][c]
                acc = acc * v[grids[e]]
            return acc

        pen = ad * pen_term(c)                     # div diag block (c,c)
        for d in range(dim):
            if d != c:
                pen = pen + aw * pen_term(d)       # curl diag block (c,c)
        dsum[c] = np.maximum(lam_sum + pen,
                             1e-12 * max(float(lam_sum.max()), 1.0))
    dinv = (1.0 / dsum).reshape(dim, -1).T            # (n_nodes, dim)

    binv = None
    if block:
        # exact per-mode (dim x dim) block diagonal of the transformed
        # operator: since diag(A (x) B) = diag(A) (x) diag(B), the mode-
        # diagonal of every cross-component penalty block ⊗_e Q_cᵀ X_e Q_c'
        # is the product of per-axis diagonals diag(Q_c,eᵀ X_e Q_c',e).
        # The scalar dinv drops these cross entries — exactly the mode-
        # off-diagonal coupling that made the FS stage need 3x the main
        # stage's iterations (docs/ROADMAP r2 item; DESIGN.md §4). The
        # block diagonal of an SPD congruence is SPD; eigenvalue clipping
        # below guards the padded/rounded modes.
        def cross_diag(c, c2, d, X):
            return np.einsum("im,ij,jm->m", Qs[d][c], X, Qs[d][c2])

        Bmat = np.zeros((dim, dim) + npts)
        for c in range(dim):
            Bmat[c, c] = dsum[c]
        for c in range(dim):
            for c2 in range(c + 1, dim):
                div_f = np.ones(npts)
                curl_f = np.ones(npts)
                for e in range(dim):
                    _, _, _, Br, Cr = AB[e]
                    Xd = Cr if e == c else (Cr.T if e == c2 else Br)
                    Xw = Cr if e == c2 else (Cr.T if e == c else Br)
                    div_f = div_f * cross_diag(c, c2, e, Xd)[grids[e]]
                    curl_f = curl_f * cross_diag(c, c2, e, Xw)[grids[e]]
                off = ad * div_f - aw * curl_f
                Bmat[c, c2] = off
                Bmat[c2, c] = off
        Bb = np.moveaxis(Bmat.reshape(dim, dim, -1), -1, 0)  # (n, c, c)
        Bb = 0.5 * (Bb + np.swapaxes(Bb, 1, 2))
        lam_b, V = np.linalg.eigh(Bb)
        floor = 1e-10 * np.maximum(lam_b.max(axis=1, keepdims=True), 1.0)
        lam_b = np.maximum(lam_b, floor)
        Binv = np.einsum("nck,nk,ndk->ncd", V, 1.0 / lam_b, V)
        binv = np.moveaxis(Binv, 0, -1).reshape((dim, dim) + npts)

    rep = np.asarray(mesh.incidence)[:, 0].astype(np.int32)
    return FDMOps(
        Qs=tuple(jnp.asarray(q, dtype=dtype) for q in Qs),
        dinv=jnp.asarray(dinv, dtype=dtype),
        binv=None if binv is None else jnp.asarray(binv, dtype=dtype),
        rep_rows=jnp.asarray(rep),
        cell_nodes=jnp.asarray(np.asarray(mesh.cell_nodes, dtype=np.int32)),
        jleft=jnp.asarray(jleft, dtype=dtype),
        npts=npts, ncomp=dim)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SlabFDM:
    """Slab-sharded FDM data: one shard's axis-0 row blocks plus the shared
    local-axis transforms, stacked (ndev, ...) for shard_map in_specs.

    The global transform chain factorizes per shard: the local axes (1..d-1)
    are untouched by the slab split, and the axis-0 analysis becomes an
    ownership-weighted partial projection `Q0_ownᵀ · z_slab` psum-reduced to
    the full mode grid, while the axis-0 synthesis needs NO communication
    (each shard computes its own slab rows `Q0_syn · ẑ` from the replicated
    mode tensor). One psum of the mode grid per application — the analog
    of the all-reduce inside a distributed direct solve. (Headroom: a
    reduce-scatter over the mode axis would cut the replicated-mode memory
    at very large grids; not needed at current sizes.)"""
    #: (ndev, c, k+1, n0) ownership rows of Q0 (duplicated interface plane
    #: zeroed on the non-owning shard)
    Q0_own: jax.Array
    #: (ndev, c, k+1, n0) slab rows of Q0 (both interface planes kept)
    Q0_syn: jax.Array
    #: local-axis eigenbases, each (ndev, c, n_d, n_d) broadcast-stacked
    Qs_rest: tuple
    #: replicated full mode-grid denominators, (ndev, c, n0[, n1, n2])
    dinv_grid: jax.Array
    #: replicated per-mode inverse blocks, (ndev, c, c, n0[, n1, n2]) or
    #: None (scalar-diagonal form)
    binv_grid: object
    #: slab slice of the Jacobi-leftover coefficients, (ndev, slab_nodes, c)
    jleft: jax.Array
    ncomp: int = dataclasses.field(metadata=dict(static=True))


def shard_fdm(f: FDMOps, ndev: int) -> SlabFDM:
    """Split FDMOps into the (ndev, ...)-stacked slab form (axis-0 slabs,
    matching `parallel/sharded_engine.build_sharded_ops`), as host
    arrays."""
    npts = f.npts
    c = f.ncomp
    n0 = npts[0]
    if (n0 - 1) % ndev != 0:
        raise ValueError(f"axis-0 planes {n0 - 1} not divisible by {ndev}")
    k = (n0 - 1) // ndev
    Q0 = np.asarray(f.Qs[0])                       # (c, n0, n0)
    own = np.zeros((ndev, c, k + 1, n0))
    syn = np.zeros((ndev, c, k + 1, n0))
    jleft = np.asarray(f.jleft).reshape(npts + (c,))
    jl = np.zeros((ndev, (k + 1) * int(np.prod(npts[1:])), c))
    for d in range(ndev):
        rows = slice(d * k, d * k + k + 1)
        syn[d] = Q0[:, rows, :]
        own[d] = Q0[:, rows, :]
        if d != ndev - 1:
            own[d, :, -1, :] = 0.0                 # upper nbr owns the plane
        jl[d] = jleft[rows].reshape(-1, c)
    dt = f.dinv.dtype
    bcast = lambda x: np.broadcast_to(np.asarray(x)[None],
                                      (ndev,) + x.shape)
    return SlabFDM(
        Q0_own=np.asarray(own, dtype=dt),
        Q0_syn=np.asarray(syn, dtype=dt),
        Qs_rest=tuple(bcast(q) for q in f.Qs[1:]),
        dinv_grid=bcast(np.moveaxis(np.asarray(f.dinv), -1, 0)
                        .reshape((c,) + npts)),
        binv_grid=None if f.binv is None else bcast(f.binv),
        jleft=np.asarray(jl, dtype=dt),
        ncomp=c)


# --------------------------------------------------------------------- apply
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _merge_axis(g: jax.Array, axis: int, ne: int, N: int) -> jax.Array:
    """Collapse an (..., ne, N, ...) overlapping-window pair into the global
    (..., ne*(N-1)+1, ...) axis by PICKING (consistent data: duplicated
    interface slots are equal). Static slices + one concat — no gather."""
    lead, trail = g.shape[:axis], g.shape[axis + 2:]
    sl = [slice(None)] * g.ndim
    sl[axis + 1] = slice(0, N - 1)
    body = g[tuple(sl)].reshape(lead + (ne * (N - 1),) + trail)
    sl[axis] = slice(ne - 1, ne)
    sl[axis + 1] = slice(N - 1, N)
    last = g[tuple(sl)].reshape(lead + (1,) + trail)
    return jnp.concatenate([body, last], axis=axis)


def _split_axis(g: jax.Array, axis: int, ne: int, N: int) -> jax.Array:
    """Inverse of _merge_axis: (..., np_ax, ...) -> (..., ne, N, ...)
    overlapping length-N windows with stride N-1 (strided slices)."""
    lead, trail = g.shape[:axis], g.shape[axis + 1:]
    sl = [slice(None)] * g.ndim
    sl[axis] = slice(0, ne * (N - 1))
    body = g[tuple(sl)].reshape(lead + (ne, N - 1) + trail)
    sl[axis] = slice(N - 1, None, N - 1)
    last = g[tuple(sl)].reshape(lead + (ne, 1) + trail)
    return jnp.concatenate([body, last], axis=axis + 1)


def _local_to_grid(r_loc: jax.Array, nelem: tuple, N: int,
                   c: int) -> jax.Array:
    """(E, nn*c) consistent canonical local vector -> global grid
    (np0[, np1, np2], c), all static slices/reshapes (the gather-free
    structured-mesh conversion)."""
    dim = len(nelem)
    g = r_loc.reshape(tuple(nelem) + (N,) * dim + (c,))
    perm = []
    for d in range(dim):
        perm += [d, dim + d]
    g = g.transpose(perm + [2 * dim])          # (e0, N, e1, N[, e2, N], c)
    for d in range(dim):
        # merging pair d shifts later (ne, N) pairs left; the d-th
        # remaining pair always sits at axis position d
        g = _merge_axis(g, d, nelem[d], N)
    return g


def _grid_to_local(z: jax.Array, nelem: tuple, N: int, c: int) -> jax.Array:
    """Global grid (np0[, np1, np2], c) -> (E, nn*c) canonical local."""
    dim = len(nelem)
    for d in range(dim - 1, -1, -1):
        z = _split_axis(z, d, nelem[d], N)
    perm = tuple(2 * d for d in range(dim)) \
        + tuple(2 * d + 1 for d in range(dim)) + (2 * dim,)
    z = z.transpose(perm)
    E = int(np.prod(nelem))
    return z.reshape(E, N**dim * c)


def _transform_chain(Qs, z, transpose_q: bool):
    """Apply the per-axis transforms to z (c, np0[, np1, np2]).

    Each step: batched matmul contracting the axis at position 1 (keeping
    a large trailing flat axis rather than a component axis of size 2-3),
    then roll
    that axis to the back. After `dim` rolls the layout returns to
    (c, np0[, np1, np2]) with every axis transformed."""
    dim = z.ndim - 1
    for d in range(dim):
        Q = Qs[d]                                   # (c, n1d, n1d)
        Qm = jnp.swapaxes(Q, 1, 2) if transpose_q else Q
        sh = z.shape
        z = _mm(Qm, z.reshape(sh[0], sh[1], -1)).reshape(sh)
        if dim > 1:
            z = jnp.moveaxis(z, 1, -1)              # roll: next axis to pos 1
    return z


def fdm_apply(f: FDMOps, r_loc: jax.Array, nelem: tuple | None = None,
              ngl: int | None = None) -> jax.Array:
    """z = S⁻¹ r on a CONSISTENT element-local vector (E, nn*ncomp); the
    result is consistent (global values duplicated into every slot).

    With (nelem, ngl) given the grid<->local conversions are gather-free
    strided slices; otherwise they fall back to index gathers."""
    E, nnc = r_loc.shape
    c = f.ncomp
    if nelem is not None:
        z = _local_to_grid(r_loc, nelem, ngl, c)
    else:
        g = r_loc.reshape(E * (nnc // c), c)[f.rep_rows]   # (n_nodes, c)
        z = g.reshape(f.npts + (c,))
    z = jnp.moveaxis(z, -1, 0)                      # (c, np0[, np1, np2])
    g0 = z
    csh = (c,) + f.npts
    z = _transform_chain(f.Qs, z, transpose_q=True)     # analysis (Qᵀ)
    if f.binv is not None:
        z = jnp.einsum("ab...,b...->a...", f.binv, z,
                       precision=jax.lax.Precision.HIGHEST)
    else:
        z = z * f.dinv.T.reshape(csh)
    z = _transform_chain(f.Qs, z, transpose_q=False)    # synthesis (Q)
    z = z + f.jleft.T.reshape(csh) * g0
    z = jnp.moveaxis(z, 0, -1)                      # back to (np..., c)
    if nelem is not None:
        return _grid_to_local(z, nelem, ngl, c)
    out = z.reshape(-1, c)[f.cell_nodes]               # (E, nn, c)
    return out.reshape(E, nnc)


def _contract_axis(Q: jax.Array, z: jax.Array, pos: int,
                   transpose_q: bool) -> jax.Array:
    """Contract z's axis `pos` with Q (c, n, n); z leads with the component
    axis. Moveaxis keeps a large trailing flat axis."""
    z = jnp.moveaxis(z, pos, 1)
    Qm = jnp.swapaxes(Q, 1, 2) if transpose_q else Q
    sh = z.shape
    z = _mm(Qm, z.reshape(sh[0], sh[1], -1)).reshape(sh)
    return jnp.moveaxis(z, 1, pos)


def fdm_apply_slab(f: SlabFDM, r_loc: jax.Array, nelem: tuple, ngl: int,
                   axis_name: str) -> jax.Array:
    """Sharded z = S⁻¹ r on one shard's consistent slab-local vector
    (E_loc, nn*ncomp); `nelem` is the LOCAL slab nelem. Called inside
    shard_map; exactly one psum (of the mode grid) per application.

    Cross-shard consistency of the result is bitwise: the duplicated
    interface plane is computed on both shards as the same `Q0 row · ẑ`
    contraction of the identical (psum-replicated) mode tensor."""
    c = f.ncomp
    z = _local_to_grid(r_loc, nelem, ngl, c)        # (k+1, n1[, n2], c)
    z = jnp.moveaxis(z, -1, 0)                      # (c, k+1, ...)
    g0 = z
    # analysis on the unsharded local axes first (slab-sized work)
    for i, Q in enumerate(f.Qs_rest):
        z = _contract_axis(Q, z, i + 2, transpose_q=True)
    # axis-0 ownership partial projection, reduced to the full mode grid
    sh = z.shape
    zh = _mm(jnp.swapaxes(f.Q0_own, 1, 2), z.reshape(c, sh[1], -1))
    zh = jax.lax.psum(zh, axis_name)                # (c, n0, rest)
    if f.binv_grid is not None:
        zh = jnp.einsum("ab...,b...->a...", f.binv_grid,
                        zh.reshape(f.dinv_grid.shape),
                        precision=jax.lax.Precision.HIGHEST)
    else:
        zh = zh.reshape(f.dinv_grid.shape) * f.dinv_grid
    # synthesis: slab rows from the replicated modes (no comm), local axes
    z = _mm(f.Q0_syn, zh.reshape(c, zh.shape[1], -1)).reshape(sh)
    for i, Q in enumerate(f.Qs_rest):
        z = _contract_axis(Q, z, i + 2, transpose_q=False)
    z = z + f.jleft.T.reshape(g0.shape) * g0
    z = jnp.moveaxis(z, 0, -1)
    return _grid_to_local(z, nelem, ngl, c)
