"""Matrix-free global application of element-local operators.

This is the replacement for the reference's assembled PETSc AIJ
matrices and their MatMult (`src/matrices/mat_fs.py:131-201`,
`base_problem.py:123-136`). A global sparse matvec becomes

    gather  : xe = x[cell_nodes]                  (E, nnode, din)
    compute : ze = xe @ K_e^T                     batched dense matmul
    reduce  : y[n] = sum_k ze_flat[incidence[n,k]]  fixed-fanin gather-sum

The reduce step exploits the structured mesh: a node belongs to at most
2**dim elements, so PETSc's dynamic scatter-add assembly becomes a static
gather over a padded index table — no atomics, no dynamic shapes, XLA-fusable.

On a uniform box mesh all elements share one element matrix, so the compute
step is a single (E*nnode, din) x (din, dout-ish) matmul.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ElementOp:
    """A global operator defined by element-local dense blocks.

    mat layout is interleaved: row = a*dout + c, col = b*din + e with a,b
    local tensor-ordered nodes.
    """
    #: (nd_out, nd_in) shared, or (E, nd_out, nd_in) per-element
    mat: jax.Array
    #: (E, nnode) global node ids
    cell_nodes: jax.Array
    #: (n_nodes, kmax) indices into E*nnode (pad = E*nnode)
    incidence: jax.Array
    #: components per node of input / output
    din: int = dataclasses.field(metadata=dict(static=True))
    dout: int = dataclasses.field(metadata=dict(static=True))
    n_nodes: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_cells(self) -> int:
        return self.cell_nodes.shape[0]

    @property
    def nnode_el(self) -> int:
        return self.cell_nodes.shape[1]


def make_element_op(mat, cell_nodes, incidence, din, dout, n_nodes,
                    dtype=None) -> ElementOp:
    mat = jnp.asarray(mat, dtype=dtype)
    return ElementOp(
        mat=mat,
        cell_nodes=jnp.asarray(cell_nodes, dtype=jnp.int32),
        incidence=jnp.asarray(incidence, dtype=jnp.int32),
        din=int(din), dout=int(dout), n_nodes=int(n_nodes))


def element_gather(op: ElementOp, x: jax.Array) -> jax.Array:
    """x (n_nodes, din) -> (E, nnode*din) element-local interleaved dofs."""
    xe = x[op.cell_nodes]  # (E, nnode, din)
    return xe.reshape(op.n_cells, op.nnode_el * op.din)


def fanin_sum(op: ElementOp, ze: jax.Array) -> jax.Array:
    """ze (E, nnode*dout) element contributions -> (n_nodes, dout) sums."""
    zf = ze.reshape(op.n_cells * op.nnode_el, op.dout)
    zf = jnp.concatenate([zf, jnp.zeros((1, op.dout), dtype=zf.dtype)])
    return zf[op.incidence].sum(axis=1)


def apply_op(op: ElementOp, x: jax.Array) -> jax.Array:
    """y = A x for the globally-assembled operator A, matrix-free."""
    xe = element_gather(op, x)
    hi = jax.lax.Precision.HIGHEST
    if op.mat.ndim == 2:
        ze = jnp.matmul(xe, op.mat.T, precision=hi)
    else:
        ze = jnp.einsum("eij,ej->ei", op.mat, xe, precision=hi)
    return fanin_sum(op, ze)


def fanin_sum_np(cell_nodes: np.ndarray, ze: np.ndarray, dout: int,
                 n_nodes: int) -> np.ndarray:
    """Host (numpy) twin of fanin_sum for SETUP-time data — avoids eager
    device dispatches (each a compile plus a transfer) during
    construction."""
    cn = np.asarray(cell_nodes)
    zf = np.asarray(ze).reshape(cn.size, dout)
    out = np.zeros((n_nodes, dout), dtype=zf.dtype)
    np.add.at(out, cn.ravel(), zf)
    return out


def assembled_diagonal_np(mat: np.ndarray, cell_nodes: np.ndarray,
                          n_nodes: int) -> np.ndarray:
    """Host twin of assembled_diagonal (square operator, din == dout)."""
    mats = np.asarray(mat)
    nnc = mats.shape[-1]
    cn = np.asarray(cell_nodes)
    dout = nnc // cn.shape[1]
    if mats.ndim == 2:
        de = np.tile(np.diagonal(mats)[None, :], (cn.shape[0], 1))
    else:
        de = np.diagonal(mats, axis1=-2, axis2=-1)
    return fanin_sum_np(cell_nodes, de, dout, n_nodes)


def assembled_diagonal(op: ElementOp) -> jax.Array:
    """Diagonal of the assembled square operator, (n_nodes, dout)."""
    assert op.din == op.dout
    if op.mat.ndim == 2:
        de = jnp.tile(jnp.diagonal(op.mat)[None, :], (op.n_cells, 1))
    else:
        de = jnp.diagonal(op.mat, axis1=-2, axis2=-1)
    return fanin_sum(op, de)


def assemble_dense(mat: np.ndarray, cell_nodes: np.ndarray, din: int,
                   dout: int, n_nodes: int) -> np.ndarray:
    """Host-side dense assembly of the global operator (numpy float64).

    Used by the direct (Cholesky) solve path and differential tests — the
    moral equivalent of the reference's assembled AIJ matrices.
    """
    E, nnode = cell_nodes.shape
    A = np.zeros((n_nodes * dout, n_nodes * din))
    mats = np.broadcast_to(mat, (E,) + mat.shape[-2:])
    rows_l = np.repeat(np.arange(nnode), dout)
    rows_c = np.tile(np.arange(dout), nnode)
    cols_l = np.repeat(np.arange(nnode), din)
    cols_c = np.tile(np.arange(din), nnode)
    for e in range(E):
        gr = cell_nodes[e][rows_l] * dout + rows_c
        gc = cell_nodes[e][cols_l] * din + cols_c
        np.add.at(A, (gr[:, None], gc[None, :]), mats[e])
    return A
