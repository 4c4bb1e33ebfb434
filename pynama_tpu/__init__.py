"""pynama_tpu — a spectral-element incompressible Navier-Stokes framework in JAX.

Re-implements the capabilities of the reference Pynama solver (vorticity-velocity
KLE method on Gauss-Lobatto-Legendre spectral elements) as an idiomatic
JAX/XLA framework:

- matrix-free element-operator application (batched dense matmuls)
  instead of assembled PETSc AIJ sparse matrices,
- free/constrained dof masks instead of Dirichlet-condensed matrix variants
  (K/Krhs/Kfs/Krhsfs of reference src/matrices/mat_fs.py, mat_ns.py),
- preconditioned CG / dense Cholesky instead of KSP GMRES+LU,
- an embedded Bogacki-Shampine 5(4) adaptive RK under `jax.lax` control flow
  instead of PETSc TS 'rk'/'5bs',
- 1D device-mesh slab partitioning with `shard_map` + `ppermute` halo exchange
  instead of DMPlex/MPI domain decomposition.
"""

__version__ = "0.1.0"

from pynama_tpu.config import FrameworkConfig, get_config, set_config
