"""Native (C++) runtime layer: mesh/graph kernel + async binary writer.

The reference delegates its mesh connectivity, dof-graph construction, and
field IO to the native PETSc C library (SURVEY §2.2). This package holds
this build's own native layer: `meshkernel.cpp` compiled once into
`_meshkernel.so` (g++, no external deps) and bound through ctypes.

Everything here has a pure-numpy fallback of identical semantics — the
native path is an accelerator for setup-time graph building on large
meshes and for non-blocking snapshot IO, not a hard dependency. Set
PYNAMA_NO_NATIVE=1 to force the fallbacks.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess

import numpy as np

logger = logging.getLogger("pynama_tpu.native")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "meshkernel.cpp")
_LIB = os.path.join(_HERE, "_meshkernel.so")

_lib = None


def _build() -> bool:
    # compile to a unique temp path and os.replace() atomically so two
    # concurrent processes (parallel pytest, multi-host shared fs) never
    # CDLL a partially written .so
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
           "-o", tmp, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception as e:  # noqa: BLE001 - any build failure -> fallback
        logger.warning("native build failed (%s); using numpy fallbacks", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("PYNAMA_NO_NATIVE"):
        return None
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError as e:
        logger.warning("native load failed (%s); using numpy fallbacks", e)
        return None
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_vp = ctypes.c_void_p
    lib.pn_unique_edges.restype = ctypes.c_int64
    lib.pn_unique_edges.argtypes = [c_i32p, ctypes.c_int64, c_i32p, c_i32p]
    lib.pn_cell_nodes.restype = None
    lib.pn_cell_nodes.argtypes = [c_i32p, c_i32p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int32, c_i32p]
    lib.pn_incidence_kmax.restype = ctypes.c_int64
    lib.pn_incidence_kmax.argtypes = [c_i32p, ctypes.c_int64,
                                      ctypes.c_int64]
    lib.pn_incidence_fill.restype = None
    lib.pn_incidence_fill.argtypes = [c_i32p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64,
                                      c_i32p]
    lib.pn_writer_create.restype = c_vp
    lib.pn_writer_create.argtypes = [ctypes.c_int64]
    lib.pn_writer_submit.restype = None
    lib.pn_writer_submit.argtypes = [c_vp, ctypes.c_char_p, c_vp,
                                     ctypes.c_int64]
    lib.pn_writer_flush.restype = None
    lib.pn_writer_flush.argtypes = [c_vp]
    lib.pn_writer_destroy.restype = None
    lib.pn_writer_destroy.argtypes = [c_vp]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# --------------------------------------------------------------- mesh graph
def unique_edges(cells_tensor: np.ndarray):
    """-> (edges (E,2) int32 sorted pairs in lex order, cell_edges (C,4)).

    Native or numpy; both number edges identically (lexicographic)."""
    cells = np.ascontiguousarray(cells_tensor, dtype=np.int32)
    C = len(cells)
    lib = _load()
    if lib is not None:
        edges = np.empty((4 * C, 2), dtype=np.int32)
        cell_edges = np.empty((C, 4), dtype=np.int32)
        ne = lib.pn_unique_edges(_ptr(cells), C, _ptr(edges),
                                 _ptr(cell_edges))
        return edges[:ne].copy(), cell_edges
    pairs = np.concatenate([cells[:, [0, 1]], cells[:, [2, 3]],
                            cells[:, [0, 2]], cells[:, [1, 3]]], axis=0)
    keys = np.sort(pairs, axis=1)
    edges, inverse = np.unique(keys, axis=0, return_inverse=True)
    # reorder from [slotA cells..., slotB cells...] to (C, 4) slot-major
    return (edges.astype(np.int32),
            inverse.reshape(4, C).T.astype(np.int32))


def cell_nodes(cells_tensor, cell_edges, n_vertices, n_edges, ngl):
    """(C, ngl^2) int32 high-order node table (see meshkernel.cpp)."""
    cells = np.ascontiguousarray(cells_tensor, dtype=np.int32)
    ce = np.ascontiguousarray(cell_edges, dtype=np.int32)
    C = len(cells)
    lib = _load()
    if lib is None:
        return None   # caller uses its own fallback loop
    out = np.empty((C, ngl * ngl), dtype=np.int32)
    lib.pn_cell_nodes(_ptr(cells), _ptr(ce), C, int(n_vertices),
                      int(n_edges), int(ngl), _ptr(out))
    return out


def build_incidence(cell_nodes_arr: np.ndarray, n_nodes: int) -> np.ndarray:
    """(n_nodes, kmax) padded fan-in table (pad = total slots)."""
    cn = np.ascontiguousarray(cell_nodes_arr, dtype=np.int32)
    total = cn.size
    lib = _load()
    if lib is not None:
        flat = cn.reshape(-1)
        kmax = lib.pn_incidence_kmax(_ptr(flat), total, int(n_nodes))
        out = np.empty((n_nodes, kmax), dtype=np.int32)
        lib.pn_incidence_fill(_ptr(flat), total, int(n_nodes), kmax,
                              _ptr(out))
        return out
    from pynama_tpu.mesh.box import build_incidence as np_build
    return np_build(cn, n_nodes)


# ------------------------------------------------------------ async writer
class AsyncBinaryWriter:
    """Background double-buffered raw writer (C++ worker thread).

    submit() copies the array and returns immediately; flush() blocks until
    everything submitted has hit disk. Falls back to synchronous writes
    when the native library is unavailable.
    """

    def __init__(self, max_queue: int = 4):
        self._lib = _load()
        self._h = self._lib.pn_writer_create(max_queue) \
            if self._lib is not None else None

    @property
    def is_async(self) -> bool:
        return self._h is not None

    def submit(self, path: str, array: np.ndarray):
        a = np.ascontiguousarray(array)
        if self._h is None:
            a.tofile(path)
            return
        self._lib.pn_writer_submit(
            self._h, path.encode(), a.ctypes.data_as(ctypes.c_void_p),
            a.nbytes)

    def flush(self):
        if self._h is not None:
            self._lib.pn_writer_flush(self._h)

    def close(self):
        if self._h is not None:
            self._lib.pn_writer_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
