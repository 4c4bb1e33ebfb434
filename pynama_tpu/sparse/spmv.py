"""Sparse matrix-vector products (the PETSc MatMult replacement).

ELL is the execution format: y[r] = sum_k data[r,k] * x[cols[r,k]] is a
dense gather + fused multiply + small-axis reduction with fully static
shapes. CSR/COO paths use segment_sum (XLA scatter-add); BSR feeds dim-sized
blocks through dense dots.

There is no hand-written kernel here: the production hot path does not
use these formats (element-local engine: dense matmul + static plane adds,
`engine/local_engine.py`); these assembled-format SpMVs serve the sparse
library surface (IBM normal systems, external users, differential tests).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.ops import segment_sum

from pynama_tpu.sparse.formats import BSR, COO, CSR, ELL


def spmv_ell(A: ELL, x: jax.Array) -> jax.Array:
    """x: (ncols,) or (ncols, m). Returns (nrows,) or (nrows, m)."""
    squeeze = x.ndim == 1
    xm = x[:, None] if squeeze else x
    xp = jnp.concatenate([xm, jnp.zeros((1, xm.shape[1]), dtype=xm.dtype)])
    gathered = xp[A.cols]                      # (nrows, width, m)
    y = jnp.einsum("rw,rwm->rm", A.data, gathered)
    return y[:, 0] if squeeze else y


def spmv_csr(A: CSR, x: jax.Array) -> jax.Array:
    """x: (ncols,) or (ncols, m) — the multi-vector case is SpMM."""
    data = A.data if x.ndim == 1 else A.data[:, None]
    vals = data * x[A.indices]
    rows = jnp.repeat(jnp.arange(A.shape[0]), jnp.diff(A.indptr),
                      total_repeat_length=A.data.shape[0])
    return segment_sum(vals, rows, num_segments=A.shape[0])


def spmv_coo(A: COO, x: jax.Array) -> jax.Array:
    data = A.data if x.ndim == 1 else A.data[:, None]
    return segment_sum(data * x[A.col], A.row, num_segments=A.shape[0])


def spmv_bsr(A: BSR, x: jax.Array) -> jax.Array:
    bs = A.blocksize
    xb = x.reshape(-1, bs)
    gathered = xb[A.indices]                   # (nblocks, bs)
    prod = jnp.einsum("bij,bj->bi", A.data, gathered)
    nbr = A.shape[0] // bs
    rows = jnp.repeat(jnp.arange(nbr), jnp.diff(A.indptr),
                      total_repeat_length=A.data.shape[0])
    yb = segment_sum(prod, rows, num_segments=nbr)
    return yb.reshape(-1)


def spmv(A, x: jax.Array) -> jax.Array:
    if isinstance(A, ELL):
        return spmv_ell(A, x)
    if isinstance(A, CSR):
        return spmv_csr(A, x)
    if isinstance(A, COO):
        return spmv_coo(A, x)
    if isinstance(A, BSR):
        return spmv_bsr(A, x)
    raise TypeError(f"unsupported sparse type {type(A)}")
