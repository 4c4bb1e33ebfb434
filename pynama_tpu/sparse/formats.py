"""Sparse matrix containers as JAX pytrees.

The counterpart of PETSc's MatAIJ zoo (reference consumes
createAIJ/setValues/assemble/mult, SURVEY §2.2). Four formats:

  COO — assembly interchange (duplicate-friendly, segment-sum reducible)
  CSR — classic compressed rows (interchange + host-side ops)
  ELL — padded fixed-width rows: the execution format. Static shapes,
        no indptr-dependent control flow; SpMV is a dense gather + multiply
        + row reduction, which XLA vectorizes cleanly. Spectral-element
        stencils have near-uniform row widths, so padding waste is small.
  BSR — block CSR with dim x dim dense blocks (interleaved velocity dofs);
        blocks go through dense dots.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class COO:
    data: jax.Array      # (nnz,)
    row: jax.Array       # (nnz,) int32
    col: jax.Array       # (nnz,) int32
    shape: tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self):
        return self.data.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSR:
    data: jax.Array      # (nnz,)
    indices: jax.Array   # (nnz,) int32 column ids
    indptr: jax.Array    # (nrows+1,) int32
    shape: tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self):
        return self.data.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded rows: data/cols are (nrows, width); padding entries have
    col == padded column pointing at a zero slot (index ncols) and data 0."""
    data: jax.Array      # (nrows, width)
    cols: jax.Array      # (nrows, width) int32, pad = ncols
    shape: tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def width(self):
        return self.data.shape[1]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BSR:
    data: jax.Array      # (nblocks, bs, bs)
    indices: jax.Array   # (nblocks,) int32 block-column ids
    indptr: jax.Array    # (n_brows+1,) int32
    shape: tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    blocksize: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self):
        return self.data.shape[0] * self.blocksize * self.blocksize
