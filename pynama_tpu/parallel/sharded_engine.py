"""Slab-sharded execution of the element-local engine over a device mesh.

Replacement for the reference's DMPlex.distribute + PETSc
distributed MatMult/VecDot (`src/domain/dmplex.py:21`, SURVEY §2.3): the
element array is cut into contiguous slabs along mesh axis 0 (elements are
e0-major, so the split is a pure reshape of every per-element array), and the
SAME engine code runs on every shard under `shard_map` — `ops.axis_name`
makes the axis-0 DSS ppermute interface-plane partial sums with neighbor
shards and turns CG dots / RK error norms into psums.

The shard-local EngineOps is the global one with:
  * every per-element array reshaped (ndev, E_loc, ...) and sharded on the
    leading device axis,
  * shared arrays (element matrices, layout perms) broadcast-stacked on the
    same leading axis (uniform in_specs; a few hundred KB of duplication),
  * layout statics rewritten for the local slab nelem,
  * func-side scatter rows localized per shard and padded to equal length
    (out-of-slab rows -> sentinel, dropped by the scatter's OOB mode).

The stacked arrays are built in host memory and sent to the devices with
the mesh sharding, so each device receives only its own slab: no device
ever holds the global operator set or the broadcast copies.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pynama_tpu.engine import local_engine as E
from pynama_tpu.ops import local as L
from pynama_tpu.solver.timestep import adaptive_loop, get_tableau, make_step

AXIS = "dp"


def build_sharded_ops(ops: E.EngineOps, ndev: int,
                      overlap_dss: bool = False) -> E.EngineOps:
    """Stack/split the global EngineOps into the (ndev, ...) sharded form,
    as host arrays (`ShardedEngine` sends them with the mesh sharding).

    Box meshes split into contiguous axis-0 slabs (DSS = ppermute plane
    exchange); unstructured meshes split into contiguous element ranges —
    each shard keeps a full-length node axis and the gather-DSS becomes
    partial fan-in + one `psum` (parallel/unstructured_sharded.py's scheme,
    now inside the one production engine)."""
    structured = ops.lay_v.structured
    ne0 = ops.nelem[0]
    if ne0 % ndev != 0:
        what = "nelem[0]" if structured else "n_cells"
        raise ValueError(f"{what}={ne0} not divisible by {ndev} devices")
    local_nelem = (ne0 // ndev,) + tuple(ops.nelem[1:])
    E_loc = int(np.prod(local_nelem))

    def split(x):          # per-element data: (E, ...) -> (ndev, E_loc, ...)
        x = np.asarray(x)
        return x.reshape((ndev, -1) + x.shape[1:])

    def bcast(x):          # shared data -> (ndev, ...) stacked copies
        x = np.asarray(x)
        return np.broadcast_to(x[None], (ndev,) + x.shape)

    # partition-interface nodes (unstructured): touched by cells of >=2
    # shards; the cross-shard DSS psums ONLY these rows (surface/volume
    # payload cut — ops/local.py LocalLayout.iface). Layout-independent
    # (cell_nodes + shard split only), computed ONCE for all 3 layouts.
    iface_j = None
    if not structured:
        cn = np.asarray(ops.lay_v.cell_nodes)
        nn0 = ops.lay_v.nnode_el
        n_nodes = np.asarray(ops.lay_v.incidence).shape[0]
        shard_of_cell = np.repeat(np.arange(ndev), E_loc)
        smin = np.full(n_nodes, ndev, dtype=np.int64)
        smax = np.full(n_nodes, -1, dtype=np.int64)
        so = np.repeat(shard_of_cell, nn0)
        np.minimum.at(smin, cn.ravel(), so)
        np.maximum.at(smax, cn.ravel(), so)
        iface_j = np.where(smax > smin)[0].astype(np.int32)

    def relay(lay):
        if lay.structured:
            return dataclasses.replace(
                lay, inv_mult=split(lay.inv_mult),
                perms=tuple(bcast(p) for p in lay.perms),
                nelem=tuple(local_nelem))
        # unstructured: per-shard incidence in LOCAL slot ids (pad E_loc*nn)
        nn = lay.nnode_el
        inc = np.asarray(lay.incidence)
        incs = np.full((ndev,) + inc.shape, E_loc * nn, dtype=np.int32)
        for d in range(ndev):
            lo, hi = d * E_loc * nn, (d + 1) * E_loc * nn
            m = (inc >= lo) & (inc < hi)
            incs[d][m] = (inc[m] - lo).astype(np.int32)
        return dataclasses.replace(
            lay, inv_mult=split(lay.inv_mult),
            incidence=incs,
            cell_nodes=split(lay.cell_nodes),
            iface=bcast(iface_j),
            nelem=(E_loc,))

    def mat(x):            # element matrices: shared (2D) or batched (3D)
        return split(x) if x.ndim == 3 else bcast(x)

    # FDM preconditioner: slab form (solver/fdm.py shard_fdm) — the axis-0
    # transform becomes ownership-partial projections psum-reduced to the
    # mode grid, so sharded solves keep the FDM iteration win
    fdm_main_s = fdm_fs_s = None
    pc = ops.pc
    if ops.pc == "fdm" and structured and ops.fdm_main is not None:
        from pynama_tpu.solver.fdm import shard_fdm
        fdm_main_s = shard_fdm(ops.fdm_main, ndev)
        fdm_fs_s = None if ops.fdm_fs is None else shard_fdm(ops.fdm_fs, ndev)
    elif ops.pc == "fdm":
        pc = "jacobi"

    # sum-factorized K: per-element geometry splits, shared tables stack
    sf_s = None
    if ops.sumfact is not None:
        sf = ops.sumfact
        sf_s = dataclasses.replace(
            sf, Gt=split(sf.Gt), Jrt=split(sf.Jrt), wr=split(sf.wr),
            Df_flat=bcast(sf.Df_flat), Dr_flat=bcast(sf.Dr_flat),
            v2cm=bcast(sf.v2cm), cm2v=bcast(sf.cm2v))

    nn = ops.nn
    fs_out = []
    for fs in ops.func_sides:
        rows = np.asarray(fs.rows)
        coords = np.asarray(fs.coords)
        shard_of = rows // (E_loc * nn)
        local_rows = rows - shard_of * (E_loc * nn)
        kmax = max(int((shard_of == d).sum()) for d in range(ndev)) or 1
        rws = np.full((ndev, kmax), E_loc * nn, dtype=rows.dtype)
        cds = np.zeros((ndev, kmax, coords.shape[1]), dtype=coords.dtype)
        for d in range(ndev):
            m = shard_of == d
            k = int(m.sum())
            rws[d, :k] = local_rows[m]
            cds[d, :k] = coords[m]
        fs_out.append(dataclasses.replace(
            fs, rows=rws, coords=cds))

    return dataclasses.replace(
        ops,
        KT=mat(ops.KT), RwT=mat(ops.RwT), curlT=mat(ops.curlT),
        srtT=mat(ops.srtT), divT=mat(ops.divT),
        lay_v=relay(ops.lay_v), lay_w=relay(ops.lay_w),
        lay_s=relay(ops.lay_s),
        winv_v=split(ops.winv_v), winv_w=split(ops.winv_w),
        winv_s=split(ops.winv_s),
        free_main=split(ops.free_main), free_fs=split(ops.free_fs),
        diag=split(ops.diag),
        mask_vel=split(ops.mask_vel), mask_vort=split(ops.mask_vort),
        mask_tang=split(ops.mask_tang),
        const_vel=split(ops.const_vel), const_vort=split(ops.const_vort),
        const_tang=split(ops.const_tang),
        func_sides=tuple(fs_out),
        KinvT=None if ops.KinvT is None else bcast(ops.KinvT),
        fdm_main=fdm_main_s, fdm_fs=fdm_fs_s, pc=pc, sumfact=sf_s,
        P_v2cm=bcast(ops.P_v2cm), P_cm2s=bcast(ops.P_cm2s),
        rho=bcast(ops.rho), mu=bcast(ops.mu), nu=bcast(ops.nu),
        nelem=local_nelem, axis_name=AXIS, overlap_dss=overlap_dss)


class ShardedEngine:
    """shard_map runtime for a Problem's EngineOps over a 1D device mesh."""

    def __init__(self, problem, ndev: int, devices=None,
                 overlap_dss: bool = False):
        assert problem.engine_ops is not None, "Problem built without engine"
        self.p = problem
        self.ndev = ndev
        devices = devices if devices is not None else jax.devices()[:ndev]
        self.mesh = Mesh(np.array(devices), (AXIS,))
        sh = NamedSharding(self.mesh, P(AXIS))
        self.ops_s = jax.device_put(
            build_sharded_ops(problem.engine_ops, ndev,
                              overlap_dss=overlap_dss), sh)
        self._spec_ops = jax.tree.map(lambda _: P(AXIS), self.ops_s)
        self._spec_state = P(AXIS)

    # ------------------------------------------------------------ state utils
    def shard_state(self, vort_g, vel_g):
        """Global nodal fields -> sharded local-layout device arrays."""
        p = self.p
        dt = p.dtype
        vort_l = L.to_local(p.mesh, np.asarray(vort_g)).astype(dt).reshape(
            (self.ndev, -1) + (p.engine_ops.lay_w.nnc,))
        vel_l = L.to_local(p.mesh, np.asarray(vel_g)).astype(dt).reshape(
            (self.ndev, -1) + (p.engine_ops.lay_v.nnc,))
        sh = NamedSharding(self.mesh, P(AXIS))
        return jax.device_put(vort_l, sh), jax.device_put(vel_l, sh)

    def gather_state(self, t_s, ncomp):
        flat = np.asarray(t_s).reshape(-1, np.asarray(t_s).shape[-1])
        return self.p.to_global(flat, ncomp)

    # ---------------------------------------------------------------- kernels
    def make_rhs(self):
        """jit(shard_map(rhs_local)): (ops_s, t, vort_s, vel_s) sharded."""
        def body(ops_s, t, vort, vel):
            ops = jax.tree.map(lambda x: x[0], ops_s)
            f, v = E.rhs_local(ops, t, vort[0], vel[0])
            return f[None], v[None]

        fn = jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(self._spec_ops, P(), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P(AXIS)), check_vma=False)
        return jax.jit(fn)

    def make_attempt(self, tableau="5bs", atol=1e-4, rtol=1e-4):
        """One full adaptive-RK trial step (8 stages x two-stage KLE solve),
        sharded: the framework's 'training step'."""
        tab = get_tableau(tableau)

        def body(ops_s, t, dt, vort, vel):
            ops = jax.tree.map(lambda x: x[0], ops_s)

            def rhs(tt, y, aux):
                return E.rhs_local(ops, tt, y, aux)

            def err_norm(e):
                return E.rk_error_norm(ops, e)

            att = make_step(rhs, tab, atol, rtol, err_norm=err_norm)
            res = att(t, dt, vort[0], vel[0])
            return res.y[None], res.enorm, res.aux[None]

        fn = jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(self._spec_ops, P(), P(), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P(), P(AXIS)), check_vma=False)
        return jax.jit(fn)

    def make_accept_bc(self):
        """jit(shard_map(apply_vorticity_bc)): pin boundary vorticity on the
        accepted sharded state (the reference's in-place BC application to
        the TS solution vector, base_problem.py:115)."""
        def body(ops_s, t, vort):
            ops = jax.tree.map(lambda x: x[0], ops_s)
            return E.apply_vorticity_bc(ops, vort[0], t)[None]

        fn = jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(self._spec_ops, P(), P(AXIS)),
            out_specs=P(AXIS), check_vma=False)
        return jax.jit(fn)

    # ------------------------------------------------------- production loop
    def start_solver(self, vort_s, vel_s, t0, t_end, max_steps,
                     dt0=None, atol=1e-4, rtol=1e-4, tableau="5bs",
                     post_step=None):
        """End-to-end sharded transient: host accept/reject dt controller
        (PETSc TSAdapt analog) driving the shard_map trial step. State stays
        device-sharded across the whole run; only the scalar error norm
        crosses to host per attempt. post_step(step, t, dt, vort_s, vel_s)
        receives the SHARDED arrays — gather with `gather_state` only when
        actually saving. Returns (t, vort_s, vel_s, accepted_steps).

        This is the form of the reference's headline parallel
        capability `mpiexec -n N python src/run_case.py -case ...`
        (reference makefile:2-7)."""
        if dt0 is None:
            dt0 = (t_end - t0) / (10 * max_steps)
        att = self.make_attempt(tableau=tableau, atol=atol, rtol=rtol)
        acc = self.make_accept_bc()

        def attempt(t, dt, y, aux):
            y2, enorm, aux2 = att(self.ops_s, t, dt, y, aux)
            from pynama_tpu.solver.timestep import StepResult
            return StepResult(y=y2, enorm=enorm, aux=aux2)

        tab = get_tableau(tableau)
        t, vort_s, vel_s, steps = adaptive_loop(
            attempt, t0, t_end, vort_s, vel_s, dt0=dt0,
            max_steps=max_steps, order=tab.order,
            accept_fn=lambda t, y: acc(self.ops_s, t, y),
            post_step=post_step)
        return t, vort_s, vel_s, steps
