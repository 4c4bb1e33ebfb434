"""Execution engine: the whole KLE/RHS pipeline in element-local layout.

This is the production compute path. All state lives in the local vector
layout of `ops/local.py` — (E, nnode_el*ncomp) — and every hot operation is
either one dense element matmul or an elementwise op on a 2D array with a
large trailing axis, compiled by XLA from plain jnp/lax. The engine is a
*pure-function + pytree-of-arrays* design: EngineOps carries every array
the step functions need, and is passed as an ARGUMENT to the jitted
functions (never captured by closure — embedded large constants make XLA
compiles pathological and defeat buffer donation).

Pipeline per RHS evaluation (reference evalRHS, `src/cases/base_problem.py:
111-137`):

    BC write  : dense-mask merge with a scatter-built value buffer
    KLE solve : matrix-free PCG on DSS(x @ K^T) with Jacobi preconditioner
    operators : curl/SrT/DivSrT as (E, nnc) @ matT + DSS + winv scaling
    v (x) v   : component extraction/packing via permutation matmuls

Correctness relies on every field staying *consistent* (duplicated interface
slots equal); all engine ops preserve consistency (DSS assembles, masks and
pointwise scalings are per-node, CG combines consistent vectors linearly).

The boundary-condition semantics mirror `boundary_conditions.py:252-277`:
velocity/vorticity values are written on ALL components of every boundary
node before each solve; tangential values are re-imposed on no-slip walls
after the free-slip stage. Sides are merged in declaration order (constant
sides first in the precomputed buffer, analytic-function sides scattered on
top).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pynama_tpu.functions import get_function_lib
from pynama_tpu.ops import local as L
from pynama_tpu.solver.cg import pcg


# ---------------------------------------------------------------------------
# pytrees
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FuncSide:
    """Analytic-function boundary side (time-dependent values)."""
    coords: jax.Array          # (k, dim) slot coordinates (duplicates incl.)
    rows: jax.Array            # (k,) slot row ids into the (E*nn) node axis
    func_name: str = dataclasses.field(metadata=dict(static=True))
    kind: str = dataclasses.field(metadata=dict(static=True))
    normal_axis: int = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EngineOps:
    """Everything the jitted step functions need, as one pytree argument."""
    # element matrices, transposed (x_local @ matT)
    KT: jax.Array              # (nncv, nncv)
    RwT: jax.Array             # (nncw, nncv)
    curlT: jax.Array           # (nncv, nncw)
    srtT: jax.Array            # (nncv, nncs)
    divT: jax.Array            # (nncs, nncv)
    # layouts (DSS perms + slot weights) per component family
    lay_v: L.LocalLayout
    lay_w: L.LocalLayout
    lay_s: L.LocalLayout
    # reciprocal lumped weights expanded per family, (E, nnc)
    winv_v: jax.Array
    winv_w: jax.Array
    winv_s: jax.Array
    # masked-system data (E, nncv)
    free_main: jax.Array
    free_fs: jax.Array
    diag: jax.Array
    # BC dense masks and constant-value buffers
    mask_vel: jax.Array        # (E, nncv) 1.0 where velocity is imposed
    mask_vort: jax.Array       # (E, nncw)
    mask_tang: jax.Array       # (E, nncv) no-slip tangential components
    const_vel: jax.Array       # (E, nncv) constant boundary velocity values
    const_vort: jax.Array      # (E, nncw)
    #: tangential values merged per-COMPONENT in side order — at wall
    #: edges/corners two no-slip sides write different component subsets, so
    #: the whole-row const_vel buffer cannot reproduce the reference's
    #: sequential setTangentialValuesToVec (boundary_conditions.py:262-277)
    const_tang: jax.Array      # (E, nncv)
    func_sides: tuple          # of FuncSide
    # v (x) v component shuffles
    P_v2cm: jax.Array          # (dim*nn,) gather idx interleaved -> comp-major
    P_cm2s: jax.Array          # (nncs,) gather idx comp-major -> interleaved
    #: element-pseudoinverse for the overlapping-Schwarz preconditioner
    #: (transposed, (nncv, nncv)); None under pc="jacobi"
    KinvT: Optional[jax.Array]
    #: fast-diagonalization data per masked system (solver/fdm.py);
    #: None unless pc="fdm" on a box mesh
    fdm_main: Optional[object]
    fdm_fs: Optional[object]
    #: sum-factorized K (ops/sumfact.py SumFactK) replacing the dense
    #: per-element KT on unstructured meshes (~56x less HBM per apply at
    #: 3D ngl=4); None -> dense KT path
    sumfact: Optional[object]
    # scalars as 0-d arrays (data, not static — avoids recompiles)
    rho: jax.Array
    mu: jax.Array
    nu: jax.Array
    # statics
    ngl: int = dataclasses.field(metadata=dict(static=True))
    nelem: tuple = dataclasses.field(metadata=dict(static=True))
    dim: int = dataclasses.field(metadata=dict(static=True))
    dim_w: int = dataclasses.field(metadata=dict(static=True))
    dim_s: int = dataclasses.field(metadata=dict(static=True))
    is_ns: bool = dataclasses.field(metadata=dict(static=True))
    cg_rtol: float = dataclasses.field(metadata=dict(static=True))
    cg_atol: float = dataclasses.field(metadata=dict(static=True))
    cg_maxiter: int = dataclasses.field(metadata=dict(static=True))
    #: preconditioner: "jacobi" (assembled-diagonal; default — the
    #: alpha=1e3-penalized K defeats element-block Schwarz, measured 2.7x
    #: MORE iterations) or "schwarz" (weighted additive overlapping
    #: Schwarz by element + Jacobi mix, kept for experimentation).
    #: Also measured and rejected: per-node dim x dim block-Jacobi (0%
    #: fewer iterations — the penalty coupling is cross-node, the nodal
    #: blocks are nearly diagonal) and a Q1 corner-space two-level additive
    #: method (276 -> 179 iters on 12^3 ngl=4, but the coarse solve has no
    #: efficient on-device form at production sizes — net wash).
    pc: str = dataclasses.field(default="jacobi",
                                metadata=dict(static=True))
    #: Krylov method: "cg" (default; K is SPD on the free subspace) or
    #: "gmres" (restarted GMRES(30), the KSP-parity method)
    krylov: str = dataclasses.field(default="cg",
                                    metadata=dict(static=True))
    #: shard_map mesh-axis name when running slab-sharded, else None
    axis_name: Optional[str] = dataclasses.field(
        default=None, metadata=dict(static=True))
    #: overlap the cross-shard DSS exchange with the bulk passes
    #: (ops/local.py dss_overlapped); only meaningful when sharded
    overlap_dss: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    @property
    def n_cells(self):
        return int(np.prod(self.nelem))

    @property
    def nn(self):
        return self.ngl ** self.dim


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _comp_perm_idx(nn: int, ncomp: int) -> np.ndarray:
    """Gather index: interleaved -> component-major, t_cm = t[:, idx]."""
    dst = np.arange(ncomp * nn)
    comp = dst // nn
    node = dst % nn
    return (node * ncomp + comp).astype(np.int32)


def _comp_unperm_idx(nn: int, ncomp: int) -> np.ndarray:
    """Gather index: component-major -> interleaved, t = t_cm[:, idx]."""
    dst = np.arange(nn * ncomp)
    node = dst // ncomp
    comp = dst % ncomp
    return (comp * nn + node).astype(np.int32)


def _vtensv_pairs(dim: int):
    """Strain-slot component pairs (reference computeVtensV,
    base_problem.py:139-154)."""
    if dim == 2:
        return [(0, 0), (0, 1), (1, 1)]
    return [(0, 0), (0, 1), (1, 1), (1, 2), (2, 2), (2, 0)]


def build_engine(mesh, bc, em_K, em_Rw, op_curl, op_srt, op_div, op_weight,
                 rho, mu, dtype, cg_rtol=1e-12, cg_atol=0.0,
                 cg_maxiter=2000, pc="jacobi", krylov="cg",
                 sumfact=None, basis=None) -> EngineOps:
    """Assemble the EngineOps pytree from setup-time numpy data.

    em_*/op_* are the dense element matrices from `elements/kle.py`
    (reference getElemKLEMatrices / getElemKLEOperators,
    `src/domain/elements/spectral.py:92-228`); op_weight is the per-local-
    node quadrature weight used for lumping (`mat_fs.py:249-267`).
    """
    dim, dim_w, dim_s = mesh.dim, mesh.dim_w, mesh.dim_s
    nn = mesh.nnode_el
    E = mesh.n_cells
    npdt = np.dtype(dtype)

    lay_v = L.make_local_layout(mesh, dim, dtype=npdt)
    lay_w = L.make_local_layout(mesh, dim_w, dtype=npdt)
    lay_s = L.make_local_layout(mesh, dim_s, dtype=npdt)

    # lumped weights: assemble (DSS of tiled element weights), then 1/w per
    # node, expanded per family
    wtile = np.broadcast_to(np.asarray(op_weight, dtype=np.float64),
                            (E, nn)).copy()
    w_loc = L.dss_np(mesh, wtile, 1)
    winv = 1.0 / w_loc                                     # (E, nn)
    exp = lambda c: jnp.asarray(np.repeat(winv, c, axis=1), dtype=npdt)

    # masked-system data in local layout
    free_main = jnp.asarray(L.to_local(mesh, bc.free_main.astype(np.float64)),
                            dtype=npdt)
    free_fs = jnp.asarray(L.to_local(mesh, bc.free_fs.astype(np.float64)),
                          dtype=npdt)
    # keep the source dtype: upcasting f32-built batched matrices to f64
    # here only to downcast at jnp.asarray doubled the copy traffic
    K_np = np.asarray(em_K)
    tr = lambda a: np.swapaxes(np.asarray(a), -1, -2)
    de = np.diagonal(K_np, axis1=-2, axis2=-1) if K_np.ndim == 3 \
        else np.tile(np.diagonal(K_np)[None, :], (E, 1))
    diag = jnp.asarray(L.dss_np(mesh, de, dim), dtype=npdt)

    fdm_main = fdm_fs = None
    if pc == "fdm":
        from pynama_tpu.solver.fdm import build_fdm
        diag_g = L.to_global(mesh, np.asarray(diag), dim)
        fdm_main = build_fdm(mesh, bc.free_main, npdt, diag_global=diag_g)
        fdm_fs = build_fdm(mesh, bc.free_fs, npdt, diag_global=diag_g) \
            if bc.needs_fs_stage else None
        if fdm_main is None:
            pc = "jacobi"   # no tensor structure -> fall back

    KinvT = None
    if pc == "schwarz" and K_np.ndim == 2:
        # element pseudo-inverse: K_e is symmetric PSD with a small null
        # space (per-component constants survive stiffness + penalties);
        # invert the definite part, drop the null directions (the Jacobi
        # mix in the preconditioner covers them)
        Ke = np.asarray(em_K, dtype=np.float64)
        lam, Q = np.linalg.eigh(0.5 * (Ke + Ke.T))
        cut = 1e-10 * lam.max()
        inv_lam = np.where(lam > cut, 1.0 / np.maximum(lam, cut), 0.0)
        Kinv = (Q * inv_lam[None, :]) @ Q.T
        KinvT = jnp.asarray(Kinv.T, dtype=npdt)

    # BC masks + constant values (dense, merged in side order)
    n_nodes = mesh.n_nodes
    mvel = np.zeros((n_nodes, dim))
    mvort = np.zeros((n_nodes, dim_w))
    mtang = np.zeros((n_nodes, dim))
    cvel = np.zeros((n_nodes, dim))
    cvort = np.zeros((n_nodes, dim_w))
    ctang = np.zeros((n_nodes, dim))
    func_sides = []
    cell_nodes = np.asarray(mesh.cell_nodes)
    # slot row ids of each global node (for func-side scatters)
    for s in bc.sides:
        mvel[s.nodes, :] = 1.0
        mvort[s.nodes, :] = 1.0
        if s.kind == "no-slip":
            for d in range(dim):
                if d != s.normal_axis:
                    mtang[s.nodes, d] = 1.0
                    if s.func is None:
                        ctang[s.nodes, d] = s.velocity[d]
        if s.func is None:
            cvel[s.nodes, :] = s.velocity
            cvort[s.nodes, :] = s.vorticity
        else:
            onside = np.zeros(n_nodes, dtype=bool)
            onside[s.nodes] = True
            rows = np.where(onside[cell_nodes.ravel()])[0].astype(np.int32)
            gids = cell_nodes.ravel()[rows]
            func_sides.append(FuncSide(
                coords=jnp.asarray(mesh.coords[gids], dtype=npdt),
                rows=jnp.asarray(rows),
                func_name=s.func.__name__.rsplit(".", 1)[-1],
                kind=s.kind, normal_axis=int(s.normal_axis)))

    tl = lambda a: jnp.asarray(L.to_local(mesh, a), dtype=npdt)

    # sum-factorized K: default ON for unstructured meshes (the dense
    # per-element KT costs (nn*dim)^2 floats/element of HBM traffic per
    # CG iteration; SumFactK streams ~2.6 KB/element instead)
    sf = None
    use_sf = (not getattr(mesh, "is_box", False)) if sumfact is None \
        else bool(sumfact)
    if use_sf and basis is not None:
        from pynama_tpu.ops.sumfact import build_sumfact
        sf = build_sumfact(basis, np.asarray(mesh.cell_corners), npdt)

    # the dense element K never goes to the device when sumfact replaces
    # it (that's the whole point: it is the HBM hog)
    KT = jnp.zeros((0,), dtype=npdt) if sf is not None \
        else jnp.asarray(tr(K_np), dtype=npdt)

    zdt = lambda x: jnp.asarray(x, dtype=npdt)
    return EngineOps(
        KT=KT,
        RwT=jnp.asarray(tr(em_Rw), dtype=npdt),
        curlT=jnp.asarray(tr(op_curl), dtype=npdt),
        srtT=jnp.asarray(tr(op_srt), dtype=npdt),
        divT=jnp.asarray(tr(op_div), dtype=npdt),
        lay_v=lay_v, lay_w=lay_w, lay_s=lay_s,
        winv_v=exp(dim), winv_w=exp(dim_w), winv_s=exp(dim_s),
        free_main=free_main, free_fs=free_fs, diag=diag,
        mask_vel=tl(mvel), mask_vort=tl(mvort), mask_tang=tl(mtang),
        const_vel=tl(cvel), const_vort=tl(cvort), const_tang=tl(ctang),
        func_sides=tuple(func_sides),
        KinvT=KinvT, fdm_main=fdm_main, fdm_fs=fdm_fs, sumfact=sf,
        P_v2cm=jnp.asarray(_comp_perm_idx(nn, dim)),
        P_cm2s=jnp.asarray(_comp_unperm_idx(nn, dim_s)),
        rho=zdt(rho), mu=zdt(mu), nu=zdt(mu / rho),
        ngl=mesh.ngl,
        nelem=tuple(getattr(mesh, 'nelem', (mesh.n_cells,))),
        dim=dim, dim_w=dim_w,
        dim_s=dim_s, is_ns=bc.needs_fs_stage,
        cg_rtol=float(cg_rtol), cg_atol=float(cg_atol),
        cg_maxiter=int(cg_maxiter),
        pc=pc if (KinvT is not None or fdm_main is not None) else "jacobi",
        krylov=krylov)


# ---------------------------------------------------------------------------
# boundary conditions
# ---------------------------------------------------------------------------

def _value_buffer(ops: EngineOps, time, attr: str,
                  const: Optional[jax.Array] = None) -> jax.Array:
    """(E, nnc) buffer holding boundary values on boundary slots.

    Constant sides are baked in; analytic-function sides are evaluated on
    their (small) slot-coordinate arrays and scattered on top."""
    if const is None:
        const = ops.const_vel if attr == "velocity" else ops.const_vort
    ncomp = ops.dim if attr == "velocity" else ops.dim_w
    U = const.reshape(-1, ncomp)
    for fs in ops.func_sides:
        lib = get_function_lib(fs.func_name)
        a = lib.alpha(ops.nu, time)
        vals = getattr(lib, attr)(fs.coords, a).astype(U.dtype)
        U = U.at[fs.rows].set(vals, mode="drop")
    return U.reshape(const.shape)


def apply_velocity_bc(ops: EngineOps, vel, time):
    """setValuesToVec for velocity (boundary_conditions.py:252-260)."""
    U = _value_buffer(ops, time, "velocity")
    return vel * (1.0 - ops.mask_vel) + U * ops.mask_vel


def apply_vorticity_bc(ops: EngineOps, vort, time):
    U = _value_buffer(ops, time, "vorticity")
    return vort * (1.0 - ops.mask_vort) + U * ops.mask_vort


def apply_tangential_bc(ops: EngineOps, vel, time):
    """Re-impose tangential wall velocity after the FS stage
    (setTangentialValuesToVec, boundary_conditions.py:262-277)."""
    U = _value_buffer(ops, time, "velocity", const=ops.const_tang)
    return vel * (1.0 - ops.mask_tang) + U * ops.mask_tang


# ---------------------------------------------------------------------------
# operator applications
# ---------------------------------------------------------------------------

def _dot_v(ops: EngineOps):
    inv = ops.lay_v.inv_mult
    ax = ops.axis_name

    def dot(a, b):
        s = jnp.sum(a * b * inv)
        return jax.lax.psum(s, ax) if ax is not None else s

    return dot


def _dss(ops: EngineOps, lay, t):
    """DSS dispatch: overlapped variant when sharded with overlap_dss."""
    if ops.axis_name is not None and ops.overlap_dss \
            and lay.structured:
        return L.dss_overlapped(lay, L.make_plane_layout(lay), t,
                                ops.axis_name)
    return L.dss(lay, t, axis_name=ops.axis_name)


def _apply_mat(ops: EngineOps, lay, t, matT):
    """y = DSS(t @ matT), the one hot operator-application pattern."""
    return _dss(ops, lay, L.emm(t, matT))


def apply_K(ops: EngineOps, v):
    if ops.sumfact is not None:
        from pynama_tpu.ops.sumfact import apply_sumfact_k
        return _dss(ops, ops.lay_v, apply_sumfact_k(ops.sumfact, v))
    return _apply_mat(ops, ops.lay_v, v, ops.KT)


def curl(ops: EngineOps, v):
    """Nodal curl (row-scaled assembled Curl, mat_fs.py:253-267)."""
    return _apply_mat(ops, ops.lay_w, v, ops.curlT) * ops.winv_w


def srt(ops: EngineOps, v):
    return _apply_mat(ops, ops.lay_s, v, ops.srtT) * ops.winv_s


def div_srt(ops: EngineOps, s):
    return _apply_mat(ops, ops.lay_v, s, ops.divT) * ops.winv_v


def vtensv(ops: EngineOps, vel):
    """v (x) v packed into strain slots via component-major shuffles."""
    nn, dim = ops.nn, ops.dim
    cm = vel[:, ops.P_v2cm]                     # (E, dim*nn) component-major
    comps = [cm[:, k * nn:(k + 1) * nn] for k in range(dim)]
    prods = jnp.concatenate(
        [comps[i] * comps[j] for i, j in _vtensv_pairs(dim)], axis=1)
    return prods[:, ops.P_cm2s]                 # -> interleaved strain


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

def _masked_solve(ops: EngineOps, free, vort, vel, fdm=None):
    """Solve the Dirichlet-condensed KLE system on the free subspace
    (reference kle_solver.py:33-41 semantics)."""
    con = 1.0 - free
    vc = con * vel
    b = free * (_apply_mat(ops, ops.lay_v, vort, ops.RwT)
                - apply_K(ops, vc)) + vc

    def A0(v):
        """Full Dirichlet-condensed operator — initial residual only."""
        return free * apply_K(ops, free * v) + con * v

    def A(v):
        """In-loop operator: every CG loop vector is exactly zero on the
        constrained dofs (r0_con = b_con - A0(x0)_con = vc - vc = 0, and
        Ap/z/p inherit the zeros), so `free*v == v` bitwise and `con*v`
        vanishes — dropping them saves two full HBM passes per iteration
        with a bitwise-identical trajectory."""
        return free * apply_K(ops, v)

    dmask = free * ops.diag + con

    # CONTRACT for every M_inv below: z = M_inv(r) must preserve exact
    # zeros on the constrained dofs (z_con == 0 whenever r_con == 0).
    # The A0/A split above rests on it — the in-loop operator drops the
    # input mask and `con*v` passthrough because every loop vector stays
    # exactly zero on constrained dofs; a preconditioner that smooths
    # across the constraint boundary would silently change the solve.
    # All three forms comply: each masks with `free` and re-adds `con*r`
    # (or divides by a diagonal, which maps zeros to zeros).
    if ops.pc == "fdm" and fdm is not None:
        # penalty-aware: exact inverse of the unpenalized separable
        # stiffness clusters the spectrum near {1, 1+alpha_w, 1+alpha_d}
        from pynama_tpu.solver.fdm import SlabFDM, fdm_apply, fdm_apply_slab

        if isinstance(fdm, SlabFDM):
            def M_inv(r):
                z = fdm_apply_slab(fdm, free * r, ops.nelem, ops.ngl,
                                   ops.axis_name)
                return free * z + con * r
        else:
            def M_inv(r):
                z = fdm_apply(fdm, free * r, nelem=ops.nelem, ngl=ops.ngl)
                return free * z + con * r
    elif ops.pc == "schwarz":
        # weighted additive overlapping Schwarz by element
        # (M^-1 = sum_e R^T D K_e^+ D R, SPSD) mixed with Jacobi to cover
        # the element null space; both restricted to the free subspace
        inv_mult = ops.lay_v.inv_mult

        def M_inv(r):
            rf = free * r
            z = _dss(ops, ops.lay_v, L.mm(rf * inv_mult, ops.KinvT)) \
                * inv_mult
            return free * z + 0.5 * rf / dmask + con * r
    else:
        def M_inv(r):
            return r / dmask

    if ops.krylov == "gmres":
        from pynama_tpu.solver.gmres import gmres
        res = gmres(A0, b, free * vel + vc, M_inv=M_inv,
                    rtol=ops.cg_rtol, atol=ops.cg_atol,
                    maxiter=ops.cg_maxiter, dot=_dot_v(ops))
    else:
        res = pcg(A, b, free * vel + vc, M_inv=M_inv,
                  rtol=ops.cg_rtol, atol=ops.cg_atol,
                  maxiter=ops.cg_maxiter, dot=_dot_v(ops), A0=A0)
    return res.x


def solve_kle_local(ops: EngineOps, vort, vel, time):
    """BC application + (two-stage) KLE solve, local layout
    (evalRHS pre-solve chain, base_problem.py:115-125)."""
    vort = apply_vorticity_bc(ops, vort, time)
    vel = apply_velocity_bc(ops, vel, time)
    if ops.is_ns:
        vel_fs = _masked_solve(ops, ops.free_fs, vort, vel, fdm=ops.fdm_fs)
        vel_fs = apply_tangential_bc(ops, vel_fs, time)
        vort = curl(ops, vel_fs)
    vel = _masked_solve(ops, ops.free_main, vort, vel, fdm=ops.fdm_main)
    return vort, vel


def rhs_local(ops: EngineOps, time, vort, vel):
    """d(vort)/dt in local layout (evalRHS, base_problem.py:111-137)."""
    _, vel = solve_kle_local(ops, vort, vel, time)
    vtv = vtensv(ops, vel)
    aux1 = 2.0 * ops.mu * srt(ops, vel) - ops.rho * vtv
    rhs_v = div_srt(ops, aux1) / ops.rho
    f = curl(ops, rhs_v)
    return f, vel


def rk_error_norm(ops: EngineOps, e):
    """Ownership-weighted RMS over global vorticity dofs."""
    n_glob = ops.lay_w.inv_mult.sum()   # == n_nodes*dim_w (local share)
    ss = jnp.sum(e * e * ops.lay_w.inv_mult)
    if ops.axis_name is not None:
        ss = jax.lax.psum(ss, ops.axis_name)
        n_glob = jax.lax.psum(n_glob, ops.axis_name)
    return jnp.sqrt(ss / n_glob)
