"""Case orchestration: mesh + operators + BC + KLE solver + time stepping.

Functional equivalent of reference `src/cases/base_problem.py` (BaseProblem /
BaseProblemTest): builds everything from a YAML-style config dict, exposes the
RHS evaluation (evalRHS, base_problem.py:111-137), the KLE verification sweeps
(getKLEError, base_problem.py:375-391), and the operator convergence tests
(OperatorsTests, base_problem.py:318-340).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pynama_tpu.basis import make_tensor_basis
from pynama_tpu.bc import BoundaryConditions
from pynama_tpu.config import get_config
from pynama_tpu.elements import compute_kle_matrices, compute_operators
from pynama_tpu.functions import get_function_lib
from pynama_tpu.mesh import BoxMesh
from pynama_tpu.ops.apply import ElementOp, apply_op, fanin_sum, \
    make_element_op
from pynama_tpu.solver.kle import KLESolver, build_system
from pynama_tpu.solver.timestep import adaptive_solve

logger = logging.getLogger("pynama_tpu.problem")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Operators:
    """Row-scaled nodal operators (reference Operators, mat_fs.py:211-271).

    The assembled SrT/DivSrT/Curl are row-scaled by the reciprocal lumped
    weight (diagonalScale, mat_fs.py:253-267) so applications return nodal
    field values.
    """
    curl_op: ElementOp     # velocity -> vorticity
    srt_op: ElementOp      # velocity -> strain components
    div_op: ElementOp      # strain -> velocity
    winv: jax.Array        # (n_nodes, 1) reciprocal lumped weights
    weight: jax.Array      # (n_nodes, 1) lumped weights (for error norms)

    def curl(self, v):
        return apply_op(self.curl_op, v) * self.winv

    def srt(self, v):
        return apply_op(self.srt_op, v) * self.winv

    def div_srt(self, s):
        return apply_op(self.div_op, s) * self.winv


def compute_vtensv(vel: jax.Array, dim: int) -> jax.Array:
    """v (x) v packed into the symmetric strain slots
    (reference computeVtensV, base_problem.py:139-154)."""
    if dim == 2:
        vx, vy = vel[:, 0], vel[:, 1]
        return jnp.stack([vx * vx, vx * vy, vy * vy], axis=1)
    vx, vy, vz = vel[:, 0], vel[:, 1], vel[:, 2]
    return jnp.stack([vx * vx, vx * vy, vy * vy,
                      vy * vz, vz * vz, vz * vx], axis=1)


def _host_device():
    """The CPU device, or None when the process runs without a CPU
    backend (then arrays go to the default device)."""
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return None


class Problem:
    """A configured flow case (reference BaseProblem)."""

    def __init__(self, config: dict, **kwargs):
        self.config = config
        self.case_name = config.get("name", "case")
        mat = config["material-properties"]
        self.rho = float(mat["rho"])
        self.mu = float(mat["mu"])
        self.nu = self.mu / self.rho
        self.opts = dict(kwargs)
        ts = config.get("time-solver", {})
        self.start_time = float(ts.get("start-time", 0.0))
        self.end_time = float(ts.get("end-time", 1.0))
        self.max_steps = int(ts.get("max-steps", 1000))
        self.viewer = None

    # ------------------------------------------------------------------ setup
    def setUp(self):
        """Build mesh, boundary conditions, operators, solvers and the
        initial state.

        A sharded run (ndev > 1) builds everything in host memory:
        `ShardedEngine` sends each device only its slab, so no device has
        to hold the global operator set."""
        host = int(self.opts.get("ndev", 1)) > 1
        with jax.default_device(_host_device() if host else None):
            self._set_up()

    def _set_up(self):
        import time as _time
        phases = {}
        t0 = _time.perf_counter()

        def _mark(name):
            nonlocal t0
            t1 = _time.perf_counter()
            phases[name] = t1 - t0
            t0 = t1

        cfg = get_config()
        dom = dict(self.config["domain"])
        ngl = int(self.opts.get("ngl", dom["ngl"]))
        if "gmsh-file" in dom and "box-mesh" not in dom:
            from pynama_tpu.mesh import mesh_from_gmsh
            self.mesh = mesh_from_gmsh(dom["gmsh-file"], ngl)
        else:
            box = dict(dom.get("box-mesh", dom))
            nelem = self.opts.get("nelem", box["nelem"])
            lower = self.opts.get("lower",
                                  box.get("lower", [0] * len(nelem)))
            upper = self.opts.get("upper",
                                  box.get("upper", [1] * len(nelem)))
            self.mesh = BoxMesh.create(ngl, nelem, lower, upper)
        self.dim = self.mesh.dim
        self.dim_w = self.mesh.dim_w
        self.dim_s = self.mesh.dim_s
        self.ngl = ngl
        self.basis = make_tensor_basis(ngl, self.dim)
        self.dtype = cfg.resolved_dtype()
        _mark("mesh")

        bc_data = dict(self.config["boundary-conditions"])
        for k in ("freeSlip", "noSlip"):
            if k in self.opts:
                key = "free-slip" if k == "freeSlip" else "no-slip"
                bc_data[key] = self.opts[k]
        self.bc = BoundaryConditions(self.mesh, bc_data)
        _mark("bc")

        self._build_operators()
        _mark("operators")
        self._build_kle_solver()
        _mark("kle_solver")
        self._build_engine()
        _mark("engine")
        self.vort, self.vel = self._initial_conditions()
        _mark("initial_conditions")
        self.setup_phases = phases
        logger.info("setup phases: %s",
                    {k: round(v, 2) for k, v in phases.items()})
        if logger.isEnabledFor(logging.DEBUG):
            from pynama_tpu.utils.report import format_ops_info, ops_info
            logger.debug(format_ops_info(ops_info(self)))

    def _build_operators(self):
        mesh, basis = self.mesh, self.basis
        corners = mesh.cell_corners[0] if mesh.is_uniform \
            else mesh.cell_corners
        # batched (per-element-geometry) builds run their quadratic-form
        # GEMMs at the ENGINE dtype: at f32 that is both what the device
        # consumes and ~100x faster than this OpenBLAS's small-batch dgemm
        # (elements/kle.py gemm_dtype docstring); the shared uniform-box
        # build stays exact f64
        gdt = None if mesh.is_uniform else np.dtype(self.dtype)
        self._em = compute_kle_matrices(basis, corners, gemm_dtype=gdt)
        eo = compute_operators(basis, corners, gemm_dtype=gdt)
        self._eo = eo
        mk = lambda m, din, dout: make_element_op(
            m, mesh.cell_nodes, mesh.incidence, din, dout, mesh.n_nodes,
            dtype=self.dtype)

        # lumped weights (mat_fs.py:249-251 weight lumping; host-side)
        from pynama_tpu.ops.apply import fanin_sum_np
        wtile = np.broadcast_to(np.asarray(eo.weight, dtype=np.float64),
                                (mesh.n_cells, mesh.nnode_el))
        w = jnp.asarray(
            fanin_sum_np(mesh.cell_nodes, wtile, 1, mesh.n_nodes),
            dtype=self.dtype)
        self.operator = Operators(
            curl_op=mk(eo.Curl, self.dim, self.dim_w),
            srt_op=mk(eo.SrT, self.dim, self.dim_s),
            div_op=mk(eo.DivSrT, self.dim_s, self.dim),
            winv=1.0 / w, weight=w)

    def _build_kle_solver(self):
        cfg = get_config()
        mesh = self.mesh
        method = self.opts.get("solver", cfg.solver)
        n_free = int(self.bc.free_main.sum())
        if method == "auto":
            method = "direct" if mesh.n_nodes * self.dim \
                <= cfg.direct_max_dofs else "cg"
        self.solver_method = method

        mk = lambda m, din, dout: make_element_op(
            m, mesh.cell_nodes, mesh.incidence, din, dout, mesh.n_nodes,
            dtype=self.dtype)
        K_op = mk(self._em.K, self.dim, self.dim)
        Rw_op = mk(self._em.Rw, self.dim_w, self.dim)

        K_np = np.asarray(self._em.K)
        sys_args = dict(K_mat_np=K_np, cell_nodes=np.asarray(mesh.cell_nodes),
                        K_op=K_op, method=method,
                        cg_rtol=self.opts.get("cg_rtol", cfg.cg_rtol),
                        cg_atol=self.opts.get("cg_atol", cfg.cg_atol),
                        cg_maxiter=self.opts.get("cg_maxiter",
                                                 cfg.cg_maxiter),
                        dtype=self.dtype)
        main = build_system(free_mask_np=self.bc.free_main, **sys_args)
        fs = build_system(free_mask_np=self.bc.free_fs, **sys_args) \
            if self.bc.needs_fs_stage else None
        self.kle = KLESolver(K_op=K_op, Rw_op=Rw_op, main=main, fs=fs)
        logger.info("KLE solver: %s (%d free dofs / %d nodes)", method,
                    n_free, mesh.n_nodes)

    def _build_engine(self):
        """Build the element-local execution engine (the production path).

        Used for every iterative (CG) solve on ANY mesh; box meshes get the
        plane-exchange DSS, unstructured meshes the fixed-fanin gather DSS
        with per-element matrices (batched einsum). The dense-direct
        method keeps the global-layout path (its Cholesky factor lives on
        the global dof vector). Disable explicitly with engine=False."""
        use = self.opts.get("engine",
                            self.solver_method in ("cg", "gmres"))
        self.engine_ops = None
        self._jit_solve_local = None
        self._jit_rhs_local = None
        if not use:
            return
        from pynama_tpu.engine import build_engine
        cfg = get_config()
        eo = self._eo
        self.engine_ops = build_engine(
            self.mesh, self.bc, em_K=self._em.K, em_Rw=self._em.Rw,
            op_curl=eo.Curl, op_srt=eo.SrT, op_div=eo.DivSrT,
            op_weight=eo.weight, rho=self.rho, mu=self.mu, dtype=self.dtype,
            cg_rtol=self.opts.get("cg_rtol", cfg.cg_rtol),
            cg_atol=self.opts.get("cg_atol", cfg.cg_atol),
            cg_maxiter=self.opts.get("cg_maxiter", cfg.cg_maxiter),
            # Jacobi by default: FDM takes ~5x fewer iterations on cold
            # solves (docs/DESIGN.md §4) but each iteration costs more, and
            # the production chain warm-starts every RK stage. Which one
            # wins in time is open (ROADMAP Speed item 4); request
            # pc="fdm" explicitly until then.
            pc=self.opts.get("pc", "jacobi"),
            krylov="gmres" if self.solver_method == "gmres" else "cg",
            sumfact=self.opts.get("sumfact"), basis=self.basis)

    # ------------------------------------------------- local layout shuttles
    def to_local(self, x):
        from pynama_tpu.ops import local as L
        if isinstance(x, jax.core.Tracer):      # inside jit: pure gather
            cn = self._jnp_cell_nodes()
            E, nn = cn.shape
            return x[cn].reshape(E, nn * x.shape[-1]).astype(self.dtype)
        return jnp.asarray(L.to_local(self.mesh, np.asarray(x)),
                           dtype=self.dtype)

    def to_global(self, t, ncomp):
        from pynama_tpu.ops import local as L
        if isinstance(t, jax.core.Tracer):      # inside jit: rep-slot gather
            rep = self._jnp_rep_rows()
            return t.reshape(-1, ncomp)[rep]
        return L.to_global(self.mesh, np.asarray(t), ncomp)

    def _jnp_cell_nodes(self):
        if not hasattr(self, "_cn_jnp"):
            self._cn_jnp = jnp.asarray(np.asarray(self.mesh.cell_nodes),
                                       dtype=jnp.int32)
        return self._cn_jnp

    def _jnp_rep_rows(self):
        if not hasattr(self, "_rep_jnp"):
            self._rep_jnp = jnp.asarray(
                np.asarray(self.mesh.incidence)[:, 0], dtype=jnp.int32)
        return self._rep_jnp

    def _initial_conditions(self):
        """reference setUpInitialConditions (base_problem.py:181-226)."""
        n = self.mesh.n_nodes
        vort = jnp.zeros((n, self.dim_w), dtype=self.dtype)
        vel = jnp.zeros((n, self.dim), dtype=self.dtype)
        ic = self.config.get("initial-conditions", {})
        if "custom-func" in ic:
            lib = get_function_lib(ic["custom-func"]["name"])
            a = lib.alpha(self.nu, self.start_time)
            coords = self.mesh.coords
            vel = jnp.asarray(lib.velocity(coords, a), dtype=self.dtype)
            vort = jnp.asarray(lib.vorticity(coords, a), dtype=self.dtype)
        elif "velocity" in ic and "vorticity" not in ic:
            vel = jnp.tile(jnp.asarray(ic["velocity"], dtype=self.dtype),
                           (n, 1))
        elif "vorticity" in ic:
            vort = jnp.tile(jnp.asarray(ic["vorticity"], dtype=self.dtype),
                            (n, 1))
        return vort, vel

    # ------------------------------------------------------------------- RHS
    def solve_kle(self, vort, vel, t=None):
        """Apply BCs and run the (possibly two-stage) KLE solve
        (evalRHS pre-solve chain, base_problem.py:115-125)."""
        t = self.start_time if t is None else t
        if self.engine_ops is not None:
            from pynama_tpu.engine import solve_kle_local
            if self._jit_solve_local is None:
                self._jit_solve_local = jax.jit(solve_kle_local)
            vort_l, vel_l = self._jit_solve_local(
                self.engine_ops, self.to_local(vort), self.to_local(vel), t)
            return (jnp.asarray(self.to_global(vort_l, self.dim_w)),
                    jnp.asarray(self.to_global(vel_l, self.dim)))
        vort = self.bc.apply_vorticity(vort, t, self.nu)
        vel = self.bc.apply_velocity(vel, t, self.nu)
        if self.kle.is_ns:
            vel_fs = self.kle.solve_fs(vort, vel)
            vel_fs = self.bc.apply_tangential(vel_fs, t, self.nu)
            vort = self.operator.curl(vel_fs)
        vel = self.kle.solve(vort, vel)
        return vort, vel

    def rhs(self, t, vort, vel_prev):
        """d(vort)/dt (reference evalRHS, base_problem.py:111-137).

        Note: the reference evaluates at `self.vort` (the step-start state)
        rather than the RK stage vector; here the stage vector is used, which
        is the mathematically intended explicit-RK semantics.
        """
        vort_bc, vel = self.solve_kle(vort, vel_prev, t)
        vtensv = compute_vtensv(vel, self.dim)
        aux1 = 2.0 * self.mu * apply_op(self.operator.srt_op, vel) \
            * self.operator.winv - self.rho * vtensv
        rhs_v = self.operator.div_srt(aux1) / self.rho
        f = self.operator.curl(rhs_v)
        return f, vel

    # ----------------------------------------------------------- time solving
    def start_solver(self, post_step=None, dt0=None, atol=1e-4, rtol=1e-4,
                     tableau="5bs"):
        """Integrate vorticity from start to end time (reference ts.solve).

        With opts `ndev=N` (N>1) the whole transient runs device-sharded
        over an N-device 1D mesh (the reference's `mpiexec -n N` analog,
        makefile:2-7)."""
        if dt0 is None:
            dt0 = (self.end_time - self.start_time) / (10 * self.max_steps)

        ndev = int(self.opts.get("ndev", 1))
        if ndev > 1:
            if self.engine_ops is None:
                raise ValueError("ndev>1 requires the element-local engine "
                                 "(box mesh + iterative solver)")
            return self._start_solver_sharded(post_step, dt0, atol, rtol,
                                              tableau, ndev)
        if self.engine_ops is not None:
            return self._start_solver_local(post_step, dt0, atol, rtol,
                                            tableau)

        def _post(step, t, dt, y, aux):
            logger.info("Converged: Step %4d | Time %.4e | dt %.2e",
                        step, t, dt)
            if post_step is not None:
                post_step(step, t, dt, y, aux)

        def _accept(t, w):
            return self.bc.apply_vorticity(w, t, self.nu)

        t, vort, vel, steps = adaptive_solve(
            self.rhs, self.start_time, self.end_time, self.vort, self.vel,
            dt0=dt0, max_steps=self.max_steps, atol=atol, rtol=rtol,
            tableau=tableau, post_step=_post, accept_fn=_accept)
        self.vort, self.vel = vort, vel
        return t, steps

    def _start_solver_sharded(self, post_step, dt0, atol, rtol, tableau,
                              ndev):
        """End-to-end multi-device transient over ShardedEngine: the state
        stays sharded for the whole run; gathers happen only on post_step
        (saves/logs) and at the end."""
        from pynama_tpu.parallel import ShardedEngine
        se = ShardedEngine(self, ndev,
                           overlap_dss=bool(self.opts.get("overlap_dss",
                                                          False)))
        vort_s, vel_s = se.shard_state(self.vort, self.vel)

        def _post(step, t, dt, y_s, aux_s):
            logger.info("Converged: Step %4d | Time %.4e | dt %.2e",
                        step, t, dt)
            if post_step is not None:
                post_step(step, t, dt, se.gather_state(y_s, self.dim_w),
                          se.gather_state(aux_s, self.dim))

        t, vort_s, vel_s, steps = se.start_solver(
            vort_s, vel_s, self.start_time, self.end_time, self.max_steps,
            dt0=dt0, atol=atol, rtol=rtol, tableau=tableau, post_step=_post)
        self.vort = jnp.asarray(se.gather_state(vort_s, self.dim_w))
        self.vel = jnp.asarray(se.gather_state(vel_s, self.dim))
        return t, steps

    def _start_solver_local(self, post_step, dt0, atol, rtol,
                            tableau="5bs"):
        """Adaptive integration entirely in the element-local layout; state
        is converted at the boundaries of the run (and per save when a
        post_step consumer is attached)."""
        from pynama_tpu.engine import (apply_vorticity_bc, rhs_local)
        from pynama_tpu.engine.local_engine import rk_error_norm

        def _rhs(t, y, aux, ops):
            return rhs_local(ops, t, y, aux)

        def _post(step, t, dt, y, aux):
            logger.info("Converged: Step %4d | Time %.4e | dt %.2e",
                        step, t, dt)
            if post_step is not None:
                post_step(step, t, dt, self.to_global(y, self.dim_w),
                          self.to_global(aux, self.dim))

        t, vort_l, vel_l, steps = adaptive_solve(
            _rhs, self.start_time, self.end_time,
            self.to_local(self.vort), self.to_local(self.vel),
            dt0=dt0, max_steps=self.max_steps, atol=atol, rtol=rtol,
            tableau=tableau, post_step=_post,
            accept_fn=lambda t, y, ops: apply_vorticity_bc(ops, y, t),
            params=self.engine_ops,
            err_norm=lambda e, ops: rk_error_norm(ops, e))
        self.vort = jnp.asarray(self.to_global(vort_l, self.dim_w))
        self.vel = jnp.asarray(self.to_global(vel_l, self.dim))
        return t, steps

    # ------------------------------------------------------------------ viewer
    def setup_viewer(self):
        """Configure HDF5/XDMF output (reference Paraviewer.configure +
        saveMesh, base_problem.py:65-71)."""
        from pynama_tpu.io import Paraviewer
        self.viewer = Paraviewer()
        self.viewer.configure(self.dim, self.config.get("save-dir"))
        self.viewer.save_mesh(np.asarray(self.mesh.coords))

    def run(self, atol=1e-4, rtol=1e-4, dt0=None, tableau="5bs",
            log_diagnostics=False, fast_io=False):
        """Production run: integrate + save fields every save-n-steps
        (reference convergedStepFunction, base_problem.py:93-103).

        With fast_io=True the per-step saves go through the native async
        binary writer (the solve loop never blocks on disk) and the
        HDF5/XDMF ParaView layout is produced once at the end by
        converting the binary snapshots."""
        save_every = int(self.config.get("save-n-steps", 1))
        bin_writer = None
        if fast_io:
            from pynama_tpu.io.binary import BinarySnapshotWriter
            fast_dir = str(self.config.get("save-dir", ".")) + "-fast"
            bin_writer = BinarySnapshotWriter(fast_dir)

        def post(step, t, dt, vort, vel):
            if step % save_every == 0:
                if bin_writer is not None:
                    bin_writer.save(step, t, vorticity=np.asarray(vort),
                                    velocity=np.asarray(vel))
                elif self.viewer is not None:
                    self.viewer.save_data(step, t,
                                          vorticity=np.asarray(vort),
                                          velocity=np.asarray(vel))
            if log_diagnostics and step % save_every == 0:
                d = self.diagnostics(vel=np.asarray(vel),
                                     vort=np.asarray(vort))
                logger.info("step %d t=%.6g KE=%.6g enstrophy=%.6g "
                            "div_l2=%.3g", step, t, d["kinetic_energy"],
                            d["enstrophy"], d["div_l2"])

        t, steps = self.start_solver(post_step=post, atol=atol, rtol=rtol,
                                     dt0=dt0, tableau=tableau)
        if bin_writer is not None:
            bin_writer.close()
            if self.viewer is not None:
                from pynama_tpu.io.binary import convert_to_paraview
                n = convert_to_paraview(bin_writer.save_dir, self.viewer)
                logger.info("fast-io: converted %d snapshots to HDF5", n)
        if self.viewer is not None:
            self.viewer.write_xmf(self.case_name)
        return t, steps

    # ------------------------------------------------------------ test suite
    def exact_fields(self, time, names=("velocity", "vorticity")):
        """Exact analytic fields at `time` (generateExactVecs,
        base_problem.py:235-264)."""
        lib = get_function_lib(self.config["tests"]["custom-func"]["name"])
        a = lib.alpha(self.nu, time)
        coords = self.mesh.coords
        out = []
        for name in names:
            fn = getattr(lib, name)
            if name == "diffusive":
                out.append(jnp.asarray(fn(coords, a, self.nu),
                                       dtype=self.dtype))
            else:
                out.append(jnp.asarray(fn(coords, a), dtype=self.dtype))
        return out

    def kle_errors(self, viscous_times):
        """Velocity L2 error of the KLE solve against exact fields
        (getKLEError, base_problem.py:375-391), t = tau^2/(4 nu)."""
        errors = []
        vel = self.vel
        for tau in viscous_times:
            time = tau**2 / (4 * self.nu)
            exact_vel, exact_vort = self.exact_fields(time)
            _, vel = self.solve_kle(exact_vort, vel, time)
            errors.append(float(jnp.linalg.norm(
                (exact_vel - vel).ravel())))
        return errors

    def operators_errors(self, viscous_time=1.0):
        """Weighted-L2 errors of convective/diffusive/curl operators
        (OperatorsTests, base_problem.py:318-340)."""
        time = viscous_time**2 / (4 * self.nu)
        exact_vel, exact_vort, exact_conv, exact_diff = self.exact_fields(
            time, ("velocity", "vorticity", "convective", "diffusive"))
        op = self.operator

        vtensv = compute_vtensv(exact_vel, self.dim)
        convective = op.curl(op.div_srt(vtensv))
        aux1 = 2.0 * self.mu * op.srt(exact_vel)
        diffusive = op.curl(op.div_srt(aux1) / self.rho)
        curl = op.curl(exact_vel)

        def werr(err):
            return float(jnp.sqrt(((err * err) * op.weight).sum()))

        return (werr(convective - exact_conv), werr(diffusive - exact_diff),
                werr(curl - exact_vort))

    def diagnostics(self, vel=None, vort=None) -> dict:
        """Physics monitors: kinetic energy, enstrophy, divergence norm
        (weighted quadrature integrals over the domain).

        The reference logs only step/time/dt (base_problem.py:103); these
        are the standard incompressible-flow observables — div_l2 in
        particular measures how well the KLE penalty enforces
        incompressibility and should stay small through a run.
        """
        vel = self.vel if vel is None else vel
        vort = self.vort if vort is None else vort
        op = self.operator
        w = op.weight
        ke = 0.5 * self.rho * float(((vel * vel).sum(axis=1,
                                                     keepdims=True) * w).sum())
        ens = 0.5 * float(((vort * vort).sum(axis=1, keepdims=True)
                           * w).sum())
        # div(v) = trace of the strain tensor; diagonal slots in the
        # reduced symmetric packing are [0, 2] (2D) / [0, 2, 4] (3D)
        # (elements/kle.py srt_tensor)
        strain = op.srt(vel)
        diag_slots = [0, 2] if self.dim == 2 else [0, 2, 4]
        div = strain[:, jnp.asarray(diag_slots)].sum(axis=1, keepdims=True)
        div_l2 = float(jnp.sqrt(((div * div) * w).sum()))
        return {"kinetic_energy": ke, "enstrophy": ens, "div_l2": div_l2}
