"""HDF5/XDMF/VTK field output (the reference Paraviewer,
`src/viewer/paraviewer.py:9-82`, rebuilt on h5py).

File layout (ParaView-compatible, matching the reference's PETSc HDF5
viewer output):
    <save-dir>/mesh.h5              /fields/mesh  flat interleaved coords
    <save-dir>/vec-data-<step>.h5   /fields/<name> flat interleaved field
    <save-dir>/<name>.xmf           XDMF 2.0 time-series index
"""
from __future__ import annotations

import logging
import os

import numpy as np

from pynama_tpu.io.xdmf import XdmfWriter

logger = logging.getLogger("pynama_tpu.viewer")


class Paraviewer:
    def __init__(self):
        self.save_dir = "."
        self.h5name = "vec-data"
        self.xml = None

    def configure(self, dim: int, save_dir: str | None = None):
        self.save_dir = "." if not save_dir else str(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self.xml = XdmfWriter(dim, self.h5name)

    # ----------------------------------------------------------------- mesh
    def save_mesh(self, coords: np.ndarray, name: str = "mesh"):
        """coords (n_nodes, dim) -> mesh.h5:/fields/mesh (flat)."""
        import h5py
        coords = np.asarray(coords)
        self.xml.set_nodes(coords.shape[0])
        self.xml.build_template()
        with h5py.File(os.path.join(self.save_dir, f"{name}.h5"), "w") as f:
            f.create_dataset(f"/fields/{name}", data=coords.ravel())
        logger.debug("Mesh saved")

    # ---------------------------------------------------------------- fields
    def save_data(self, step: int, time: float, **fields):
        """Write one step: every field (n_nodes, ncomp) under its name
        (reference saveData + saveStepInXML, paraviewer.py:40-66)."""
        import h5py
        path = os.path.join(self.save_dir, f"{self.h5name}-{step:05d}.h5")
        with h5py.File(path, "w") as f:
            for name, arr in fields.items():
                f.create_dataset(f"/fields/{name}",
                                 data=np.asarray(arr).ravel())
        grid = self.xml.add_step_grid("mesh1")
        self.xml.set_time(time, grid)
        for name, arr in fields.items():
            arr = np.asarray(arr)
            ncomp = 1 if arr.ndim == 1 else arr.shape[1]
            if ncomp == 1:
                self.xml.add_scalar(name, step, grid)
            else:
                self.xml.add_vector(name, step, grid, ncomp=ncomp)
        logger.debug("Step saved")

    def write_xmf(self, name: str):
        self.xml.write(os.path.join(self.save_dir, name))

    # ------------------------------------------------------------------- vtk
    def write_vtk(self, name: str, coords: np.ndarray, step=None, **fields):
        """Legacy-VTK point cloud with point data (reference writeVTK,
        paraviewer.py:68-75 dumps the DMPlex; here: the GLL point set)."""
        coords = np.asarray(coords, dtype=np.float64)
        n, dim = coords.shape
        fname = f"{name}.vtk" if step is None else f"{name}-{step:05d}.vtk"
        with open(os.path.join(self.save_dir, fname), "w") as f:
            f.write("# vtk DataFile Version 3.0\npynama_tpu fields\n"
                    "ASCII\nDATASET POLYDATA\n")
            f.write(f"POINTS {n} double\n")
            xyz = np.zeros((n, 3))
            xyz[:, :dim] = coords
            np.savetxt(f, xyz, fmt="%.16g")
            if fields:
                f.write(f"POINT_DATA {n}\n")
            for fn, arr in fields.items():
                arr = np.asarray(arr, dtype=np.float64)
                ncomp = 1 if arr.ndim == 1 else arr.shape[1]
                if ncomp == 1:
                    f.write(f"SCALARS {fn} double 1\nLOOKUP_TABLE default\n")
                    np.savetxt(f, arr.ravel(), fmt="%.16g")
                else:
                    v = np.zeros((n, 3))
                    v[:, :ncomp] = arr
                    f.write(f"VECTORS {fn} double\n")
                    np.savetxt(f, v, fmt="%.16g")

    # ------------------------------------------------------------------ yaml
    def write_yaml(self, name: str, data: dict):
        data = dict(data)
        data["dir"] = self.save_dir
        import yaml
        with open(self.save_dir + ".yaml", "w") as f:
            yaml.dump(data, f, default_flow_style=False)
