"""Element-local execution engine: the hot path.

Canonical state layout for all solver-side fields is the *local vector*:
``(n_cells, nnode_el * ncomp)`` — every element owns a private copy of its
nodes. This is the classic accelerator SEM design (gather-free): a global
sparse operator application (the reference's assembled PETSc MatMult,
`src/matrices/mat_fs.py:131-201`, `base_problem.py:123-136`) becomes

    compute : z = x_local @ K_e^T            ONE dense element matmul
    DSS     : per-axis interface-plane adds  slices/pads on (lead,ne,trail,B)
    reorder : axis-major column permutations trailing-axis column gathers

Every array in the hot path is 2D/4D with a large trailing axis; the
naive (e0,N,e1,N,e2,N,c) grid view would put tiny (N=4, c=3) dimensions
last.

Direct stiffness summation (DSS) exchanges interface-plane partial sums so
every duplicated node slot holds the fully assembled value. It is done
dimension-by-dimension; correctness for edge/corner nodes shared by up to
2**dim elements follows from linearity of the per-axis exchanges. To keep
each axis's plane a *contiguous trailing block* of the column axis, columns
are permuted to that axis's "major" ordering first.

Global<->local conversion (setup/IO only, not in the hot path) mirrors
PETSc's VecScatter begin/end pairs.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

#: Without a precision argument an f32 matmul may run in reduced
#: precision: TF32 on NVIDIA tensor cores (~3 decimal digits). That is
#: fatal for the stiff penalized KLE operator (lambda_min/||K|| ~ 6e-4, so
#: the rounding makes K indefinite and CG diverges). HIGHEST gives full FP32
#: products; tests/test_precision.py checks every dot_general of the main
#: path carries it.
mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def emm(t: jax.Array, matT: jax.Array) -> jax.Array:
    """t @ matT with a shared (nnc_in, nnc_out) element matrix, or the
    batched per-element form when matT is (E, nnc_in, nnc_out)
    (unstructured meshes: every element has its own geometry)."""
    if matT.ndim == 2:
        return mm(t, matT)
    return jnp.einsum("ei,eio->eo", t, matT,
                      precision=jax.lax.Precision.HIGHEST)


# --------------------------------------------------------------- orderings
def _axis_major_order(dim: int, axis: int) -> tuple:
    """Local-axis permutation putting `axis` slowest (most significant)."""
    rest = [d for d in range(dim) if d != axis]
    return (axis, *rest)


def _local_col_index(ngl: int, dim: int, ncomp: int, order: tuple) -> np.ndarray:
    """Column index table: for each column j of the `order`-major layout,
    the column in the canonical (0,1[,2])-major layout holding that dof.

    Canonical column = (a0*N^{d-1} + a1*N^{d-2} + ...) * ncomp + comp with
    a_d the local index along mesh axis d (tensor order, axis 0 slowest —
    matching `BoxMesh.cell_nodes` and the element matrices).
    """
    N = ngl
    shape = (N,) * dim + (ncomp,)
    canon = np.arange(N**dim * ncomp).reshape(shape)
    permuted = np.transpose(canon, tuple(order) + (dim,))
    return permuted.reshape(-1)


def _perm_index(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Gather index g moving a row vector from layout `src` to layout
    `dst`: t_dst = t_src[:, g]. src/dst map their layout's columns to
    canonical columns.

    A gather rather than a permutation-matrix matmul: it is bit-exact by
    construction and moves the data once, where the matmul would do
    nnc FLOPs per entry at the HIGHEST precision the f32 data requires."""
    n = src.size
    inv_src = np.empty(n, dtype=np.int64)
    inv_src[src] = np.arange(n)
    return inv_src[dst].astype(np.int32)


# ------------------------------------------------------------------ layout
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LocalLayout:
    """Hot-path tables for one (nelem, ngl, ncomp) local representation.

    perms[d] maps axis-d-major -> axis-(d+1 mod dim)-major column order;
    applying them in sequence after per-axis DSS rotates the layout through
    all axis-major orders and back to canonical.
    """
    perms: tuple                     # dim (nnc,) int32 gather-index arrays
    inv_mult: jax.Array              # (E, nnc) 1/slot-multiplicity
    ngl: int = dataclasses.field(metadata=dict(static=True))
    nelem: tuple = dataclasses.field(metadata=dict(static=True))
    ncomp: int = dataclasses.field(metadata=dict(static=True))
    #: unstructured meshes: fan-in table (n_nodes, kmax) into E*nn (pad =
    #: E*nn) and (E, nn) node ids — the DSS becomes segment-sum + gather
    #: (PETSc's dynamic scatter-add as a static fixed-fanin reduction)
    incidence: object = None
    cell_nodes: object = None
    #: sharded unstructured meshes: global node ids on the PARTITION
    #: INTERFACE (nodes touched by cells of >=2 shards). The cross-shard
    #: DSS exchange reduces to psum of these rows only — a surface/volume
    #: payload cut vs all-reducing the full node vector (a
    #: graph-partitioned halo exchange in all-reduce form; exact because
    #: non-interface rows are complete on their owner shard and never
    #: gathered by any other shard's cells).
    #: None -> full-vector psum.
    iface: object = None
    structured: bool = dataclasses.field(default=True,
                                         metadata=dict(static=True))
    #: spatial dim when nelem is just (n_cells,) (unstructured)
    mesh_dim: int = dataclasses.field(default=0,
                                      metadata=dict(static=True))

    @property
    def dim(self):
        return self.mesh_dim or len(self.nelem)

    @property
    def n_cells(self):
        return int(np.prod(self.nelem))

    @property
    def nnode_el(self):
        return self.ngl ** self.dim

    @property
    def nnc(self):
        return self.nnode_el * self.ncomp

    @property
    def plane_cols(self):
        """Columns in one local axis-plane (trailing block in axis-major)."""
        return (self.nnode_el // self.ngl) * self.ncomp


def _make_perms(ngl: int, dim: int, ncomp: int) -> tuple:
    orders = [_axis_major_order(dim, d) for d in range(dim)]
    cols = [_local_col_index(ngl, dim, ncomp, o) for o in orders]
    return tuple(
        jnp.asarray(_perm_index(cols[d], cols[(d + 1) % dim]))
        for d in range(dim))


def make_local_layout(mesh, ncomp: int, dtype=jnp.float32) -> LocalLayout:
    dim = mesh.dim
    cell_nodes = np.asarray(mesh.cell_nodes)
    np_dtype = np.dtype(dtype)
    counts = np.bincount(cell_nodes.ravel(), minlength=mesh.n_nodes)
    mult = counts[cell_nodes]                      # (E, nnode)
    inv = (1.0 / mult).astype(np_dtype)
    inv_mult = jnp.asarray(np.repeat(inv, ncomp, axis=1))
    if getattr(mesh, "is_box", False):
        return LocalLayout(perms=_make_perms(mesh.ngl, dim, ncomp),
                           inv_mult=inv_mult, ngl=mesh.ngl,
                           nelem=tuple(mesh.nelem), ncomp=int(ncomp))
    return LocalLayout(
        perms=(), inv_mult=inv_mult, ngl=mesh.ngl,
        nelem=(int(mesh.n_cells),), ncomp=int(ncomp),
        incidence=jnp.asarray(np.asarray(mesh.incidence), dtype=jnp.int32),
        cell_nodes=jnp.asarray(cell_nodes, dtype=jnp.int32),
        structured=False, mesh_dim=dim)


def make_plane_layout(layout: LocalLayout) -> LocalLayout:
    """LocalLayout of the (dim-1)-dimensional axis-0 interface-plane
    sub-mesh (elements (ne1[, ne2]), same ngl/ncomp) — the working set of
    the overlapped DSS's plane-restricted passes. inv_mult is unused by
    dss and left as a placeholder."""
    sub_nelem = tuple(layout.nelem[1:])
    sub_dim = len(sub_nelem)
    perms = _make_perms(layout.ngl, sub_dim, layout.ncomp)
    return LocalLayout(perms=perms, inv_mult=jnp.zeros((1, 1)),
                       ngl=layout.ngl, nelem=sub_nelem,
                       ncomp=layout.ncomp)


# -------------------------------------------------------- global <-> local
def to_local(mesh, x_global) -> np.ndarray:
    """(n_nodes, ncomp) -> (E, nnode*ncomp) canonical-order local vector.

    Setup/IO only (host-side gather, the VecScatter analog)."""
    xg = np.asarray(x_global)
    E, nn = mesh.cell_nodes.shape
    return xg[np.asarray(mesh.cell_nodes)].reshape(E, nn * xg.shape[-1])


def to_global(mesh, t_local, ncomp: int) -> np.ndarray:
    """(E, nnode*ncomp) consistent local vector -> (n_nodes, ncomp)."""
    E, nn = mesh.cell_nodes.shape
    t = np.asarray(t_local).reshape(E * nn, ncomp)
    out = np.zeros((mesh.n_nodes, ncomp), dtype=t.dtype)
    out[np.asarray(mesh.cell_nodes).reshape(-1)] = t
    return out


# ---------------------------------------------------------------- DSS core
def _dss_axis_major(t: jax.Array, nelem: tuple, axis: int, nnc: int,
                    plane: int, axis_name=None) -> jax.Array:
    """Interface-plane exchange along mesh `axis`, with t's columns in
    axis-major order: local plane 0 = first `plane` columns, plane N-1 =
    last `plane` columns. t: (E, nnc).

    With `axis_name` set (shard_map slab decomposition along mesh axis 0),
    the axis-0 exchange additionally ppermutes the outermost interface
    planes with the neighboring shards — the analog of PETSc's
    VecScatter inside a distributed MatMult (SURVEY §2.3)."""
    ne = nelem[axis]
    lead = int(np.prod(nelem[:axis]))
    trail = int(np.prod(nelem[axis + 1:]))
    g = t.reshape(lead, ne, trail, nnc)
    if ne > 1:
        from_prev = g[:, :-1, :, nnc - plane:]    # left nbr's last plane
        from_next = g[:, 1:, :, :plane]           # right nbr's 0 plane
        g = g + jnp.pad(from_prev,
                        ((0, 0), (1, 0), (0, 0), (0, nnc - plane))) \
              + jnp.pad(from_next,
                        ((0, 0), (0, 1), (0, 0), (nnc - plane, 0)))
    if axis == 0 and axis_name is not None:
        nd = jax.lax.axis_size(axis_name)
        if nd > 1:
            fwd = [(i, i + 1) for i in range(nd - 1)]
            bwd = [(i + 1, i) for i in range(nd - 1)]
            send_r = g[:, -1, :, nnc - plane:]    # my last plane partials
            send_l = g[:, 0, :, :plane]           # my first plane partials
            from_left = jax.lax.ppermute(send_r, axis_name, fwd)
            from_right = jax.lax.ppermute(send_l, axis_name, bwd)
            g = g.at[:, 0, :, :plane].add(from_left)
            g = g.at[:, -1, :, nnc - plane:].add(from_right)
    return g.reshape(-1, nnc)


def _dss_gather(layout: LocalLayout, t: jax.Array, axis_name=None
                ) -> jax.Array:
    """General-mesh DSS: fixed-fanin segment sum into global node values,
    duplicated back into every slot. Sharded (element-split) meshes psum
    the per-shard partial node sums — one collective per application.

    The fan-in sum runs as kmax separate column gathers + adds, in a
    fixed summation order. A cumsum-segmented variant with fewer gathers
    carries an O(eps*sqrt(S)) ~ 1.5e-5 cancellation error that would floor
    cg_rtol=1e-6 solves, and is rejected (DESIGN §7)."""
    E, nn, c = layout.n_cells, layout.nnode_el, layout.ncomp
    zf = t.reshape(E * nn, c)
    zf = jnp.concatenate([zf, jnp.zeros((1, c), dtype=zf.dtype)])
    inc = layout.incidence
    g = zf[inc[:, 0]]
    for k in range(1, inc.shape[1]):
        g = g + zf[inc[:, k]]                         # (n_nodes, c)
    if axis_name is not None:
        if layout.iface is not None:
            # exchange only the partition-interface rows (see the
            # LocalLayout.iface docstring for why this is exact)
            gi = jax.lax.psum(g[layout.iface], axis_name)
            g = g.at[layout.iface].set(gi)
        else:
            g = jax.lax.psum(g, axis_name)
    return g[layout.cell_nodes].reshape(E, nn * c)


def dss(layout: LocalLayout, t: jax.Array, axis_name=None) -> jax.Array:
    """Full direct-stiffness summation: canonical-order in/out, every
    duplicated slot assembled (globally, when `axis_name` names a shard_map
    mesh axis for the slab decomposition)."""
    if not layout.structured:
        return _dss_gather(layout, t, axis_name=axis_name)
    nnc, plane = layout.nnc, layout.plane_cols
    for d in range(layout.dim):
        t = _dss_axis_major(t, layout.nelem, d, nnc, plane,
                            axis_name=axis_name)
        t = t[:, layout.perms[d]]      # rotate to next axis-major (gather)
    return t


def dss_overlapped(layout: LocalLayout, plane_layout: LocalLayout,
                   t: jax.Array, axis_name: str) -> jax.Array:
    """DSS with the cross-shard exchange overlapped against the bulk
    compute — the analog of PETSc's VecScatter-overlapped MatMult
    (SURVEY §2.3).

    The per-axis DSS passes commute (each is a linear sum over a disjoint
    index dimension), and the neighbor only needs this shard's boundary
    plane with the OTHER axes' passes applied. So: process the two small
    boundary planes through the axes-1..d-1 plane DSS first, issue the
    `ppermute`, run the full-volume axes-1..d-1 passes and the axis-0
    internal adds while the transfer flies (XLA's latency-hiding scheduler
    reorders the independent collective ahead of the bulk compute), and
    accumulate the received planes at the end. Results match `dss` up to
    f.p. summation order."""
    nnc, plane = layout.nnc, layout.plane_cols
    nelem, dim = layout.nelem, layout.dim
    ne0 = nelem[0]
    trail = int(np.prod(nelem[1:]))
    g = t.reshape(ne0, trail, nnc)

    def plane_dss(p):                    # (trail, plane) sub-mesh DSS
        sub = plane_layout
        for d in range(sub.dim):
            p = _dss_axis_major(p, sub.nelem, d, sub.nnc, sub.plane_cols)
            p = p[:, sub.perms[d]]
        return p

    send_l = plane_dss(g[0, :, :plane])          # raw boundary partials:
    send_r = plane_dss(g[-1, :, nnc - plane:])   # independent of the bulk
    nd = jax.lax.axis_size(axis_name)
    fwd = [(i, i + 1) for i in range(nd - 1)]
    bwd = [(i + 1, i) for i in range(nd - 1)]
    from_left = jax.lax.ppermute(send_r, axis_name, fwd)
    from_right = jax.lax.ppermute(send_l, axis_name, bwd)

    # bulk: axes 1..dim-1 over the full volume, then axis-0 internal adds
    u = t[:, layout.perms[0]]                    # rotate to axis-1-major
    for d in range(1, dim):
        u = _dss_axis_major(u, nelem, d, nnc, plane)
        u = u[:, layout.perms[d]]                # ...back to canonical
    u = _dss_axis_major(u, nelem, 0, nnc, plane)

    gu = u.reshape(ne0, trail, nnc)
    gu = gu.at[0, :, :plane].add(from_left)
    gu = gu.at[-1, :, nnc - plane:].add(from_right)
    return gu.reshape(-1, nnc)


def local_dot(layout: LocalLayout, a: jax.Array, b: jax.Array) -> jax.Array:
    """Global inner product of two consistent local vectors."""
    return jnp.sum(a * b * layout.inv_mult)


def dss_np(mesh, t: np.ndarray, ncomp: int) -> np.ndarray:
    """Host (numpy) DSS for SETUP-time data: assemble into global dofs and
    gather back. Semantically identical to `dss`; avoids eager device
    dispatches (each a compile plus a transfer) during engine
    construction."""
    cn = np.asarray(mesh.cell_nodes)
    gid = (np.repeat(cn.ravel(), ncomp) * ncomp
           + np.tile(np.arange(ncomp), cn.size))
    acc = np.zeros(mesh.n_nodes * ncomp, dtype=np.asarray(t).dtype)
    np.add.at(acc, gid, np.asarray(t).ravel())
    return acc[gid].reshape(np.asarray(t).shape)


# ------------------------------------------------------------------ LocalOp
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LocalOp:
    """Element operator executing in the local layout.

    matT is the element matrix transposed ((nnode*din, nnode*dout)), rows
    and columns in canonical tensor order (same convention as ElementOp)."""
    matT: jax.Array
    layout_out: LocalLayout


def make_local_op(mat, layout_out: LocalLayout, dtype=None) -> LocalOp:
    matT = jnp.asarray(np.asarray(mat).T, dtype=dtype)
    return LocalOp(matT=matT, layout_out=layout_out)


def apply_local_op(op: LocalOp, t: jax.Array) -> jax.Array:
    """y_local = DSS(x_local @ K^T): assembled operator application."""
    return dss(op.layout_out, mm(t, op.matT))


def local_diagonal(op: LocalOp) -> jax.Array:
    """Assembled diagonal in local layout, (E, nnc)."""
    lo = op.layout_out
    d = jnp.diagonal(op.matT)
    de = jnp.tile(d[None, :], (lo.n_cells, 1))
    return dss(lo, de)
