"""Global framework configuration.

The reference runs everything in PETSc double precision. The runtime dtype
follows JAX's x64 mode: verification suites run float64, production/bench
paths run float32 (with full-FP32 matmuls, see ops/local.py `mm`).
Setup-time element/basis math is always computed in numpy float64 and cast at
device-transfer time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class FrameworkConfig:
    #: runtime dtype for fields and operators on device
    dtype: jnp.dtype = None  # resolved lazily against jax_enable_x64
    #: linear solver: "cg" (matrix-free PCG), "direct" (dense Cholesky), or
    #: "auto" (direct below direct_max_dofs free dofs, cg above)
    solver: str = "auto"
    #: dense-direct threshold (number of velocity dofs)
    direct_max_dofs: int = 40_000
    #: CG relative tolerance and iteration cap
    cg_rtol: float = 1e-12
    cg_atol: float = 0.0
    cg_maxiter: int = 2000

    def resolved_dtype(self):
        if self.dtype is not None:
            return jnp.dtype(self.dtype)
        # follow jax's x64 mode
        import jax
        return np.dtype(np.float64) if jax.config.jax_enable_x64 \
            else np.dtype(np.float32)


_config = FrameworkConfig()


def get_config() -> FrameworkConfig:
    return _config


def set_config(**kwargs) -> FrameworkConfig:
    global _config
    _config = dataclasses.replace(_config, **kwargs)
    return _config


def fdtype() -> np.dtype:
    return np.dtype(get_config().resolved_dtype())
