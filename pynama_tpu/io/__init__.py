"""Field output: ParaView HDF5/XDMF, checkpoints, raw binary snapshots.

Submodules load on first use, so importing the package needs none of
h5py, PyYAML or matplotlib."""
import importlib

_EXPORTS = {"Paraviewer": "viewer", "XdmfWriter": "xdmf",
            "save_checkpoint": "checkpoint", "load_checkpoint": "checkpoint"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(mod, name)
