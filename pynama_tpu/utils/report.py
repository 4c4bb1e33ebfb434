"""Operator memory / size reporting (the printMatsInfo analog,
reference `src/matrices/mat_fs.py:122-129`).

The reference reports assembled-AIJ nnz and bytes; this build is
matrix-free, so the honest analog is the device bytes of each operator
pytree plus the *effective* assembled nnz its application replaces.
"""
from __future__ import annotations

import jax
import numpy as np


def pytree_nbytes(tree) -> int:
    """Total array bytes in a pytree (host or device)."""
    total = 0
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
        elif hasattr(leaf, "size") and hasattr(leaf, "dtype"):
            total += int(leaf.size) * np.dtype(leaf.dtype).itemsize
    return total


def ops_info(problem) -> dict:
    """Size report for a set-up Problem: per-operator device bytes and the
    assembled-equivalent nnz of K (what a PETSc AIJ build would store)."""
    mesh = problem.mesh
    nnc = mesh.nnode_el * mesh.dim
    em_bytes = pytree_nbytes(problem.kle) if problem.kle is not None else 0
    eng_bytes = pytree_nbytes(problem.engine_ops) \
        if getattr(problem, "engine_ops", None) is not None else 0
    # effective nnz: every element contributes a dense nnc x nnc block;
    # shared nodes merge, so the true assembled count is <= E * nnc^2
    nnz_upper = mesh.n_cells * nnc * nnc
    info = {
        "n_nodes": int(mesh.n_nodes),
        "n_cells": int(mesh.n_cells),
        "dofs": int(mesh.n_nodes * mesh.dim),
        "kle_solver_bytes": em_bytes,
        "engine_bytes": eng_bytes,
        "assembled_nnz_upper_bound": int(nnz_upper),
        "matrix_free_bytes_per_assembled_nnz":
            round((em_bytes + eng_bytes) / max(nnz_upper, 1), 4),
    }
    return info


def format_ops_info(info: dict) -> str:
    mb = 1.0 / (1024 * 1024)
    return (f"operators: {info['dofs']} dofs, "
            f"solver {info['kle_solver_bytes']*mb:.1f} MiB, "
            f"engine {info['engine_bytes']*mb:.1f} MiB, "
            f"assembled-equivalent nnz <= "
            f"{info['assembled_nnz_upper_bound']:,} "
            f"({info['matrix_free_bytes_per_assembled_nnz']} B/nnz "
            f"matrix-free)")
