"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline: effective SpMV throughput (assembled-matrix GNNZ/s) of the
element-local matrix-free KLE operator application on one device: the
assembled operator's nnz over the time of one matrix-free application.
`vs_baseline` is null: no peak table for the device exists yet, so no
ratio to a speed-of-light is claimed. Every line names the device
(platform, kind, count) and, on a GPU, the card's name and power limit.

Methodology:
  * Competing variants (jacobi vs fdm solves, apply vs its matmul and
    rotation phases) are timed INTERLEAVED: every variant's short and
    long chains run round-robin, min over rounds, so all variants sample
    the same windows.
  * Per-iteration time is the slope between two chain lengths (cancels
    dispatch/fetch latency).
  * The phase split is derived from the SAME interleaved group as the
    headline apply — internally consistent by construction.
  * Sections are ordered so a budget-skip drops only fields some other
    artifact already records: apply group -> warm solves (jacobi+fdm
    interleaved) -> high-order -> IBM -> cold solves -> rhs.
  * All operator pytrees are jit ARGUMENTS (closure constants trigger
    pathological XLA compiles); every chain takes nit as a TRACED argument
    so both slope lengths share one compile.
"""
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


#: milestones recorded as the run progresses — the hard-timeout watchdog
#: (see __main__) emits these when the measurement thread stalls beyond
#: the wall budget (no in-thread guard can interrupt a blocked C++ fetch
#: call)
PARTIAL = {}


def assembled_nnz(mesh) -> int:
    """Exact nnz of the assembled KLE operator K (dim x dim dense blocks,
    stencil = union of element node ranges per axis)."""
    total_per_axis = []
    ngl = mesh.ngl
    for d in range(mesh.dim):
        npd = mesh.npts[d]
        ne = mesh.nelem[d]
        i = np.arange(npd, dtype=np.int64)
        e_hi = np.minimum(i // (ngl - 1), ne - 1)
        e_lo = np.maximum(-(-(i - ngl + 1) // (ngl - 1)), 0)
        total_per_axis.append((e_hi - e_lo) * (ngl - 1) + ngl)
    if mesh.dim == 2:
        grid = total_per_axis[0][:, None] * total_per_axis[1][None, :]
    else:
        grid = (total_per_axis[0][:, None, None]
                * total_per_axis[1][None, :, None]
                * total_per_axis[2][None, None, :])
    return int(grid.sum()) * mesh.dim * mesh.dim


# --------------------------------------------------------------- protocol
def _sync_first(out):
    """Host-fetch sync on the first element of an arbitrary pytree leaf."""
    import jax
    leaf = jax.tree_util.tree_leaves(out)[0]
    return float(np.asarray(leaf).ravel()[0])


def best_of(fn, *args, reps=5):
    fn_out = fn(*args)
    _sync_first(fn_out)                            # compile + sync
    best = np.inf
    for _ in range(reps):
        t1 = time.perf_counter()
        out = fn(*args)
        _sync_first(out)                           # host fetch = hard sync
        best = min(best, time.perf_counter() - t1)
    return best


def timed_slope(make_chain, *args, n1=None, n2=None, reps=5,
                target_s=None):
    """Per-iteration device time from the slope between two chain
    lengths (single-variant form; competing variants use
    interleaved_slopes). The long chain is sized from the MEASURED rough
    rate so one timed call never exceeds ~2.5 s even in a fast window."""
    if target_s is not None:
        rough = best_of(make_chain(n1), *args, reps=2)
        per = max(rough / n1, 1e-7)
        n2 = int(np.clip(target_s / per, 2 * n1, 200000))
        n2 = min(n2, max(int(2.5 / per), 2 * n1))
    t1 = best_of(make_chain(n1), *args, reps=reps)
    t2 = best_of(make_chain(n2), *args, reps=min(reps, 3))
    slope = (t2 - t1) / (n2 - n1)
    if slope <= 0:
        # jitter swamped the short chain; fall back to the long chain's
        # amortized rate — an upper bound, never 0
        slope = t2 / n2
    return max(slope, 1e-9), t1


def interleaved_slopes(specs, n1=400, target_s=1.0, rounds=5,
                       time_left=None, reserve=60.0):
    """Round-robin slope timing for COMPETING variants.

    specs: list of (name, make_chain, args_tuple). Each round times every
    variant's short then long chain in sequence; the reported
    per-iteration time is the slope between the min-over-rounds times.
    Because all variants sample the same window sequence, cross-variant
    ratios (jacobi-vs-fdm, apply-vs-matmul) are meaningful even when the
    absolute throughput swings between rounds.

    Returns dict name -> (per_iter_s, short_chain_floor_s)."""
    state = {}
    for name, make_chain, args in specs:
        try:
            fn1 = make_chain(n1)
            _sync_first(fn1(*args))                # compile + sync
        except Exception as e:  # noqa: BLE001 — drop the variant, keep
            # the group (one variant's compile failure must not void its
            # comparators' numbers)
            log(f"interleaved spec '{name}' failed to compile/run: "
                f"{type(e).__name__}: " + " ".join(str(e).split())[:200])
            continue
        t0 = time.perf_counter()
        _sync_first(fn1(*args))
        rough = time.perf_counter() - t0
        per = max(rough / n1, 1e-7)
        n2 = int(np.clip(target_s / per, 2 * n1, 200000))
        n2 = min(n2, max(int(2.5 / per), 2 * n1))
        state[name] = dict(fn1=fn1, fn2=make_chain(n2), n1=n1, n2=n2,
                           t1=np.inf, t2=np.inf, args=args)
    for _ in range(rounds):
        for st in state.values():
            for fk, tk in (("fn1", "t1"), ("fn2", "t2")):
                t0 = time.perf_counter()
                _sync_first(st[fk](*st["args"]))
                st[tk] = min(st[tk], time.perf_counter() - t0)
        if time_left is not None and time_left() < reserve:
            log("interleaved group: budget cut after a round")
            break
    out = {}
    for name, st in state.items():
        slope = (st["t2"] - st["t1"]) / (st["n2"] - st["n1"])
        if slope <= 0:
            slope = st["t2"] / st["n2"]
        out[name] = (max(slope, 1e-9), st["t1"])
    return out


# --------------------------------------------------------------- sections
def bench_scaling():
    """Weak-scaling efficiency over all visible devices (BASELINE.md:
    '>=75% nnz/s scaling efficiency'). Shards the full RHS over a 1D mesh
    with nelem[0] proportional to device count.

    Efficiency definition depends on what the devices ARE:
      * real devices: T(N) / (N * T(1)) — the classic weak-scaling
        ratio; the axis-0 DSS rides device-to-device ppermutes.
      * VIRTUAL devices (cpu host platform): all N "devices" share one
        physical CPU, so per-device throughput falls ~1/N by
        construction and T(N)/(N*T(1)) measures silicon sharing, not the
        framework. The honest signal there is T(N) / T(1) — total
        throughput of the N-way SHARDED run (with its ppermutes/psums
        and duplicated shared operands) against the unsharded run of
        the base problem on the same silicon: 1.0 = sharding adds zero
        overhead; this bounds the comm+duplication cost the real-chip
        run would amortize against N x the FLOPs.

    The reported value is the MINIMUM efficiency over all measured N
    (the r4 artifact reported N=8 while N=2 sat below the bar)."""
    import jax
    import jax.numpy as jnp
    from pynama_tpu.cases import Problem
    from pynama_tpu.parallel.sharded_engine import ShardedEngine
    from pynama_tpu.engine import local_engine as E

    ndev_all = len(jax.devices())
    base = (4, 12, 12)
    ngl = 4
    # PHASE 1: build every config (identical per-shard shape (4,12,12);
    # the two-stage solve is fixed-work — both CG stages cap at maxiter,
    # verified — so throughput differences are pure sharding+host effects)
    runs = {}
    for ndev in [d for d in (1, 2, 4, 8, 16) if d <= ndev_all]:
        nelem = (base[0] * ndev, base[1], base[2])
        cfg = {
            "name": "scale", "material-properties": {"rho": 0.5, "mu": 0.01},
            "domain": {"ngl": ngl, "box-mesh": {
                "nelem": list(nelem), "lower": [0] * 3, "upper": [1] * 3}},
            "boundary-conditions": {"no-slip": {
                s: [0, 0, 0] for s in
                ("up", "down", "left", "right", "back", "front")}},
            "initial-conditions": {"vorticity": [0, 0, 0]},
        }
        p = Problem(cfg, solver="cg", cg_rtol=1e-5, cg_maxiter=50)
        p.setUp()
        sk = ShardedEngine(p, ndev)
        rhs = sk.make_rhs()
        vort_s, vel_s = sk.shard_state(
            np.zeros((p.mesh.n_nodes, p.mesh.dim_w)),
            np.zeros((p.mesh.n_nodes, p.mesh.dim)))
        jax.block_until_ready(rhs(sk.ops_s, 0.0, vort_s, vel_s))  # compile
        runs[ndev] = (sk, rhs, vort_s, vel_s, assembled_nnz(p.mesh))
    # PHASE 2: INTERLEAVED rounds — every N is timed inside the same host
    # load windows, min over rounds (the r4 artifact's N=2 'dip' did not
    # reproduce: three repetitions of the sequential protocol gave N=2
    # efficiency 0.82 / 0.53 / 1.01 on the 2-core shared host; per-N
    # numbers from different windows are noise, not framework signal)
    best = {n: np.inf for n in runs}
    for _ in range(7):
        for ndev, (sk, rhs, vort_s, vel_s, nnz) in runs.items():
            t1 = time.perf_counter()
            jax.block_until_ready(rhs(sk.ops_s, 0.0, vort_s, vel_s))
            best[ndev] = min(best[ndev], time.perf_counter() - t1)
    results = {n: runs[n][4] / best[n] / 1e9 for n in runs}
    for ndev, g in results.items():
        log(f"scaling ndev={ndev}: {g:.2f} GNNZ/s ({g/ndev:.2f}/dev)")
    shared = jax.devices()[0].platform == "cpu"
    effs = {}
    for ndev, g in results.items():
        if ndev == 1:
            continue
        effs[ndev] = (g / results[1]) if shared \
            else (g / ndev) / results[1]
    if not effs:
        eff, n_min = 1.0, 1
    else:
        n_min = min(effs, key=effs.get)
        eff = effs[n_min]
    print(json.dumps({
        "metric": "weak_scaling_efficiency",
        "value": round(eff, 3), "unit": "ratio",
        "vs_baseline": round(eff / 0.75, 3),
        "detail": {"gnnz_per_s": {str(k): round(v, 2)
                                  for k, v in results.items()},
                   "efficiency_per_n": {str(k): round(v, 3)
                                        for k, v in effs.items()},
                   "devices": ("virtual-cpu (shared silicon: efficiency "
                               "= T(N)/T(1), the sharding+comm overhead "
                               "bound)" if shared else "real chips: "
                               "efficiency = T(N)/(N*T(1))"),
                   "value_is": f"minimum over N (at N={n_min})"}}))


def bench_hex():
    """Hex-mesh (unstructured) K apply: sum-factorized vs dense
    per-element matrices. The dense path streams (nn*dim)^2 floats per
    element per CG iteration (147 KB at ngl=4 f32); SumFactK streams
    ~2.6 KB/element — this records the HBM win on real hardware."""
    import time as _t

    import jax
    import jax.numpy as jnp
    from pynama_tpu.engine import local_engine as E
    from pynama_tpu.cases import Problem

    nx = ny = nz = 10
    ngl = 4
    path = _write_hex_msh(nx, ny, nz, distort=0.12)
    cfg = {"name": "bench-hex",
           "material-properties": {"rho": 1.0, "mu": 0.01},
           "domain": {"ngl": ngl, "gmsh-file": path},
           "boundary-conditions": {"uniform": {"velocity": [1, 0, 0],
                                               "vorticity": [0, 0, 0]}},
           "initial-conditions": {"velocity": [1, 0, 0]}}

    # wall-clock budget: this section must DEGRADE (emit whatever was
    # measured) when compiles run slow, not die with no JSON line
    budget_s = float(os.environ.get("PYNAMA_BENCH_BUDGET", 520))
    hex_t0 = _t.time()
    res = {}
    setup_secs = {}
    errors = []
    mesh = None
    for sf_on in (True, False):
        name = "sumfact" if sf_on else "dense"
        if _t.time() - hex_t0 > budget_s:
            errors.append(f"{name}: skipped (budget)")
            continue
        try:
            t0 = _t.time()
            q = Problem(cfg, solver="cg", cg_rtol=1e-6, cg_maxiter=500,
                        engine=True, sumfact=sf_on)
            q.setUp()
            setup_secs[name] = round(_t.time() - t0, 1)
            mesh = q.mesh
            ops = q.engine_ops
            assert (ops.sumfact is not None) == sf_on
            rngv = np.random.default_rng(1)
            v = jnp.asarray(q.to_local(rngv.standard_normal(
                (mesh.n_nodes, 3))), dtype=q.dtype)

            @jax.jit
            def chain(ops_, v, nit):
                def body(i, x):
                    y = E.apply_K(ops_, x)
                    return y / (1.0 + jnp.max(jnp.abs(y)))
                return jax.lax.fori_loop(0, nit, body, v)

            def mk(n):
                return lambda o_, v_: chain(o_, v_, n)

            per, _ = timed_slope(mk, ops, v, n1=100, reps=5, target_s=1.0)
            res[name] = per
            log(f"hex K apply ({name}): {per*1e6:.1f} us "
                f"(setup {setup_secs[name]}s)")
            if sf_on:
                # split out the gather-DSS (the documented unstructured
                # ceiling, DESIGN §7) from the sumfact math
                from pynama_tpu.ops import local as LL

                @jax.jit
                def dchain(ops_, v, nit):
                    def body(i, x):
                        y = LL.dss(ops_.lay_v, x)
                        return y / (1.0 + jnp.max(jnp.abs(y)))
                    return jax.lax.fori_loop(0, nit, body, v)

                r = timed_slope(lambda n: (lambda o_, v_: dchain(o_, v_, n)),
                                ops, v, n1=100, reps=5, target_s=1.0)
                res["dss_only"] = r[0]
                log(f"hex gather-DSS alone: {r[0]*1e6:.1f} us")
        except Exception as e:  # noqa: BLE001 — degrade, never die
            errors.append(f"{name}: {type(e).__name__}: "
                          + " ".join(str(e).split())[:200])
            log(f"hex section FAILED (degrading): {errors[-1]}")

    speedup = res["dense"] / res["sumfact"] \
        if "dense" in res and "sumfact" in res else None
    us = lambda k: None if k not in res else round(res[k] * 1e6, 1)
    print(json.dumps({
        "metric": "hex_sumfact_speedup",
        "value": 0.0 if speedup is None else round(speedup, 2),
        "unit": "x",
        "vs_baseline": 0.0 if speedup is None else round(speedup, 2),
        "detail": {"k_apply_sumfact_us": us("sumfact"),
                   "k_apply_dense_us": us("dense"),
                   "gather_dss_us": us("dss_only"),
                   "setup_s": setup_secs,
                   "cells": None if mesh is None else mesh.n_cells,
                   "ngl": ngl,
                   "dense_bytes_per_cell": (ngl**3 * 3) ** 2 * 4,
                   "errors": errors,
                   "config": f"distorted hex {nx}x{ny}x{nz} ngl={ngl}"}}))


def _write_hex_msh(nx, ny, nz, distort=0.0):
    """Distorted structured hex grid as a temp MSH 2.2 file (the bench
    analog of the tests' gmsh fixtures)."""
    import tempfile

    xs = [np.linspace(0, 1, n + 1) for n in (nx, ny, nz)]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1)
    rng = np.random.default_rng(0)
    interior = np.all((verts > 1e-12) & (verts < 1 - 1e-12), axis=1)
    verts[interior] += (rng.uniform(-1, 1, (int(interior.sum()), 3))
                        * distort / nx)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    hexes = [[vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k),
              vid(i, j + 1, k), vid(i, j, k + 1), vid(i + 1, j, k + 1),
              vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1)]
             for i in range(nx) for j in range(ny) for k in range(nz)]
    names = ["down", "right", "up", "left", "back", "front"]
    quads = {
        "down": [[vid(i, 0, k), vid(i + 1, 0, k), vid(i + 1, 0, k + 1),
                  vid(i, 0, k + 1)] for i in range(nx) for k in range(nz)],
        "up": [[vid(i, ny, k), vid(i + 1, ny, k), vid(i + 1, ny, k + 1),
                vid(i, ny, k + 1)] for i in range(nx) for k in range(nz)],
        "left": [[vid(0, j, k), vid(0, j + 1, k), vid(0, j + 1, k + 1),
                  vid(0, j, k + 1)] for j in range(ny) for k in range(nz)],
        "right": [[vid(nx, j, k), vid(nx, j + 1, k), vid(nx, j + 1, k + 1),
                   vid(nx, j, k + 1)] for j in range(ny) for k in range(nz)],
        "back": [[vid(i, j, 0), vid(i + 1, j, 0), vid(i + 1, j + 1, 0),
                  vid(i, j + 1, 0)] for i in range(nx) for j in range(ny)],
        "front": [[vid(i, j, nz), vid(i + 1, j, nz), vid(i + 1, j + 1, nz),
                   vid(i, j + 1, nz)] for i in range(nx) for j in range(ny)],
    }
    f = tempfile.NamedTemporaryFile("w", suffix=".msh", delete=False)
    f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$PhysicalNames\n"
            f"{len(names) + 1}\n")
    for t, n in enumerate(names):
        f.write(f'2 {t + 1} "{n}"\n')
    f.write(f'3 {len(names) + 1} "volume"\n$EndPhysicalNames\n$Nodes\n'
            f"{len(verts)}\n")
    for i, v in enumerate(verts):
        f.write(f"{i + 1} {v[0]} {v[1]} {v[2]}\n")
    f.write("$EndNodes\n$Elements\n")
    n_el = sum(len(v) for v in quads.values()) + len(hexes)
    f.write(f"{n_el}\n")
    eid = 1
    for t, n in enumerate(names):
        for q in quads[n]:
            f.write(f"{eid} 3 2 {t + 1} {t + 1} "
                    + " ".join(str(x + 1) for x in q) + "\n")
            eid += 1
    for h in hexes:
        f.write(f"{eid} 5 2 {len(names) + 1} {len(names) + 1} "
                + " ".join(str(x + 1) for x in h) + "\n")
        eid += 1
    f.write("$EndElements\n")
    f.close()
    return f.name


def _ibm_section(timed, dtype_str):
    """Per-step IBM costs on the chip (r4 missing #3 / weak #7): the
    static body's velocity-correction solve (Cholesky back-substitution
    path, reference computeVelocityCorrection immersed_boundary.py:162-168)
    and the dynamic body's full in-jit rebuild (support tables + matrix-
    free CG + spread, the analog of rebuildMatrix immersed_boundary.py:
    379-385) — both at the bundled production configs."""
    import jax
    import jax.numpy as jnp
    from pynama_tpu.cases.ibm import (ImmersedBoundaryDynamic,
                                      ImmersedBoundaryStatic)
    from pynama_tpu.ibm import interpolation as I

    out = {}

    def base_cfg(nelem, lo, hi, re):
        return {
            "name": "bench-ibm", "material-properties": {"rho": 0.5,
                                                         "mu": 0.01},
            "domain": {"ngl": 3, "box-mesh": {
                "nelem": nelem, "lower": lo, "upper": hi}},
            "time-solver": {"start-time": 0, "end-time": 1, "max-steps": 1},
            "boundary-conditions": {"uniform": {
                "re": re, "direction": 0, "Lref": "1", "rho": 0.5,
                "mu": 0.01}},
            "initial-conditions": {"vorticity": [0]},
            "bodies": [{"type": "circle", "vel": "static", "radius": 0.5,
                        "center": [0, 0]}],
        }

    # static cylinder, the reference ibm-static production config
    cfg = base_cfg([50, 50], [-3, -3], [3, 3], 10)
    ps = ImmersedBoundaryStatic(cfg, solver="cg", cg_rtol=1e-6,
                                cg_maxiter=500)
    ps.setUp()
    nn = ps.mesh.n_nodes
    rng = np.random.default_rng(3)
    vel = jnp.asarray(rng.standard_normal((nn, 2)), dtype=ps.dtype)
    bv = jnp.asarray(ps.body.velocities(), dtype=ps.dtype)

    @jax.jit
    def _stat_f(iops, nodes, w, chol, v, bv, nit):
        def body(i, v):
            corr, _ = I.correction(iops, nodes, w, chol, v, bv, n_nodes=nn)
            return v + 1e-9 * corr
        return jax.lax.fori_loop(0, nit, body, v)

    def mk_stat(n):
        return lambda *a: _stat_f(*a, n)

    per, _ = timed(mk_stat, ps.ibm_ops, ps.nodes_tab, ps.w_tab, ps.chol,
                   vel, bv, n1=50, reps=5, target_s=0.5)
    out["static_correction_us"] = round(per * 1e6, 1)
    out["static_config"] = "50x50 ngl=3, 2D cylinder r=0.5 (Re=10)"
    out["lag_points"] = int(ps.body.n_nodes)
    log(f"IBM static correction: {per*1e6:.1f} us/step "
        f"({ps.body.n_nodes} lag points, {nn} nodes)")

    # dynamic cylinder, the reference ibm-dynamic production config
    cfg = base_cfg([100, 100], [-4, -4], [4, 4], 140)
    cfg["bodies"][0]["vel"] = "dynamic"
    pd = ImmersedBoundaryDynamic(cfg, solver="cg", cg_rtol=1e-6,
                                 cg_maxiter=500)
    pd.setUp()
    nn_d = pd.mesh.n_nodes
    xy = jnp.asarray(pd.body.coordinates(), dtype=pd.dtype)
    vel = jnp.asarray(rng.standard_normal((nn_d, 2)), dtype=pd.dtype)
    bv = jnp.asarray(pd.body.velocities(), dtype=pd.dtype)
    flux0 = jnp.zeros((pd.body.n_nodes, 2), dtype=pd.dtype)
    rtol = pd._corr_rtol

    @jax.jit
    def _dyn_f(iops, xy, v, bv, f0, nit):
        def body(i, carry):
            v, f = carry
            # i-dependent shift defeats loop hoisting of the table build
            nodes, w = I.support_tables(iops, xy + 1e-14 * i)
            corr, flux, _ = I.correction_cg(iops, nodes, w, v, bv, f,
                                            n_nodes=nn_d, rtol=rtol)
            return (v + 1e-9 * corr, flux)
        return jax.lax.fori_loop(0, nit, body, (v, f0))[0]

    def mk_dyn(n):
        return lambda *a: _dyn_f(*a, n)

    per_d, _ = timed(mk_dyn, pd.ibm_ops, xy, vel, bv, flux0,
                     n1=20, reps=5, target_s=0.5)
    out["dynamic_rebuild_us"] = round(per_d * 1e6, 1)
    out["dynamic_config"] = "100x100 ngl=3, 2D cylinder r=0.5 (Re=140)"
    out["dynamic_lag_points"] = int(pd.body.n_nodes)
    log(f"IBM dynamic rebuild+correction: {per_d*1e6:.1f} us/step "
        f"({pd.body.n_nodes} lag points, {nn_d} nodes)")
    return out


def _mem_stats(dev):
    """Peak/current HBM from the device, where the backend exposes it."""
    try:
        ms = dev.memory_stats()
    except Exception:  # noqa: BLE001 — optional on experimental backends
        return None
    if not ms:
        return None
    gb = lambda k: None if k not in ms else round(ms[k] / 2**30, 3)
    return {"bytes_in_use_gb": gb("bytes_in_use"),
            "peak_bytes_in_use_gb": gb("peak_bytes_in_use"),
            "bytes_limit_gb": gb("bytes_limit")}


def main():
    import jax
    from pynama_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from pynama_tpu.cases import Problem
    from pynama_tpu.engine import local_engine as E

    if os.environ.get("PYNAMA_BENCH") == "scaling":
        return bench_scaling()
    if os.environ.get("PYNAMA_BENCH") == "hex":
        return bench_hex()

    size = os.environ.get("PYNAMA_BENCH", "default")
    if size == "small":
        nelem, ngl = (8, 8, 8), 4
    elif size == "large":
        nelem, ngl = (32, 32, 32), 4
    elif size == "highorder":
        # BASELINE.md "high-order N=6-8 single-host refinement" config
        nelem, ngl = (8, 8, 8), 7
    else:
        nelem, ngl = (24, 24, 24), 4

    dim = len(nelem)
    zero = [0] * dim
    cfg = {
        "name": "bench-cavity3d",
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": list(nelem), "lower": zero, "upper": [1] * dim}},
        "time-solver": {"start-time": 0, "end-time": 1.0, "max-steps": 10},
        "boundary-conditions": {"no-slip": {
            "up": [2, 0, 0], "down": zero, "left": zero, "right": zero,
            "back": zero, "front": zero}},
        "initial-conditions": {"vorticity": [0, 0, 0]},
    }
    dev = jax.devices()[0]
    from pynama_tpu.utils.profiling import card_info
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card_info()}
    log(f"device: {device}")
    # wall-clock budget: optional sections are skipped once the deadline
    # nears so the JSON line ALWAYS prints
    budget_s = float(os.environ.get("PYNAMA_BENCH_BUDGET", 540))
    bench_t0 = time.time()

    def time_left():
        return budget_s - (time.time() - bench_t0)

    def gate(cap):
        """Section gates scale with the budget so a small-budget CPU
        contract run still reaches every section."""
        return min(cap, 0.25 * budget_s)

    # every section is guarded: a failure records an error string and the
    # report DEGRADES (optional sections -> null) instead of dying
    errors = []

    def guard(name, fn, *args, **kw):
        try:
            return fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 — degrade, never die
            msg = f"{name}: {type(e).__name__}: " \
                  + " ".join(str(e).split())[:300]
            errors.append(msg)
            log(f"SECTION FAILED (degrading): {msg}")
            return None

    t0 = time.time()
    f64 = jax.config.jax_enable_x64
    p = Problem(cfg, solver="cg", cg_rtol=1e-12 if f64 else 1e-6,
                cg_maxiter=1000)
    p.setUp()
    ops = p.engine_ops
    assert ops is not None
    setup_s = time.time() - t0
    log(f"setup {setup_s:.1f}s: {p.mesh.n_nodes} nodes, "
        f"{p.mesh.n_cells} cells, ngl={ngl}, dtype={p.dtype}")
    log(f"setup phases: "
        f"{ {k: round(v, 2) for k, v in p.setup_phases.items()} }")

    nnz = assembled_nnz(p.mesh)
    log(f"assembled K nnz: {nnz/1e9:.3f} G")
    PARTIAL.update(
        setup_s=round(setup_s, 1),
        setup_phases_s={k: round(v, 2) for k, v in p.setup_phases.items()},
        nnz=nnz, device=device, last_milestone="setup")

    rng = np.random.default_rng(0)
    v = jnp.asarray(p.to_local(rng.standard_normal(
        (p.mesh.n_nodes, p.dim))), dtype=p.dtype)

    # ---- group A (interleaved): apply + phase probes ---------------------
    from pynama_tpu.ops import local as L

    @jax.jit
    def _k_f(ops_, v, nit):
        def body(i, x):
            y = E.apply_K(ops_, x)
            return y / (1.0 + jnp.max(jnp.abs(y)))
        return jax.lax.fori_loop(0, nit, body, v)

    def k_chain(nit):
        return lambda ops_, v: _k_f(ops_, v, nit)

    @jax.jit
    def _mm_f(ops_, v, nit):
        def body(i, x):
            y = L.mm(x, ops_.KT)
            return y / (1.0 + jnp.max(jnp.abs(y)))
        return jax.lax.fori_loop(0, nit, body, v)

    def mm_chain(nit):
        return lambda ops_, v: _mm_f(ops_, v, nit)

    @jax.jit
    def _rot_f(ops_, v, nit):
        def body(i, x):
            for d in range(len(ops_.nelem)):
                x = x[:, ops_.lay_v.perms[d]]
            return x / (1.0 + jnp.max(jnp.abs(x)))
        return jax.lax.fori_loop(0, nit, body, v)

    def rot_chain(nit):
        return lambda ops_, v: _rot_f(ops_, v, nit)

    specs = [("k_apply", k_chain, (ops, v)),
             ("matmul", mm_chain, (ops, v)),
             ("rot", rot_chain, (ops, v))]
    groupA = guard("apply_group", interleaved_slopes, specs, n1=400,
                   target_s=1.0, rounds=8, time_left=time_left,
                   reserve=min(120.0, 0.3 * budget_s))
    if groupA is None or "k_apply" not in groupA:
        # nothing timeable at all: emit what we recorded and stop — the
        # errors list (the root cause) must survive into the artifact
        print(json.dumps({
            "metric": "spmv_effective_gnnz_per_s", "value": 0.0,
            "unit": "GNNZ/s", "vs_baseline": None,
            "detail": {"setup_s": round(setup_s, 1),
                       "setup_phases_s": {k: round(v2, 2) for k, v2
                                          in p.setup_phases.items()},
                       "device": device, "errors": errors}}))
        return

    t_apply, t_call = groupA["k_apply"]
    t_mm = groupA.get("matmul", (None, None))[0]
    t_rot = groupA.get("rot", (None, None))[0]
    gnnz_s = nnz / t_apply / 1e9
    log(f"K apply: {t_apply*1e6:.1f} us -> {gnnz_s:.1f} GNNZ/s effective "
        f"(short-chain floor {t_call*1e3:.1f} ms)")
    PARTIAL.update(gnnz_s=round(gnnz_s, 2),
                   k_apply_ms=round(t_apply * 1e3, 4),
                   last_milestone="k_apply")

    # phase split from the SAME interleaved group
    flops = 2.0 * p.mesh.n_cells * (p.mesh.nnode_el * p.dim) ** 2
    phase = None
    if t_mm is not None:
        phase = {"matmul": round(t_mm * 1e6, 1),
                 "dss": round(max(t_apply - t_mm, 0.0) * 1e6, 1)}
        if t_rot is not None:
            phase["rotations"] = round(t_rot * 1e6, 1)
        log(f"phase split (same group): matmul {phase['matmul']} us "
            f"({flops/t_mm/1e12:.1f} TFLOP/s), dss {phase['dss']} us, "
            f"rotations {phase.get('rotations')} us")

    # ---- group B (interleaved): warm two-stage solves, jacobi vs fdm ----
    vort = E.curl(ops, v)
    vel0 = jnp.zeros_like(v)

    @jax.jit
    def _solve_f(ops_, w, u, nit):
        def body(i, u):
            _, u2 = E.solve_kle_local(ops_, w, u, 0.0)
            return u2 * (1.0 - 1e-6) + 1e-7 * i  # defeat loop hoisting
        return jax.lax.fori_loop(0, nit, body, u)

    def solve_chain(nit):
        return lambda ops_, w, u: _solve_f(ops_, w, u, nit)

    # a COLD chain: every iteration restarts from a ~zero initial guess
    # (the i-dependence defeats hoisting without warming the start vector)
    @jax.jit
    def _cold_f(ops_, w, u0, nit):
        def body(i, u):
            _, u2 = E.solve_kle_local(ops_, w, u * (1e-20 * i), 0.0)
            return u0 + 1e-30 * u2
        return jax.lax.fori_loop(0, nit, body, u0)

    def cold_chain(nit):
        return lambda ops_, w, u0: _cold_f(ops_, w, u0, nit)

    ops_fdm = None
    if size in ("default", "large") and time_left() > gate(240):
        def fdm_setup():
            t1 = time.time()
            p2 = Problem(cfg, solver="cg", cg_rtol=1e-12 if f64 else 1e-6,
                         cg_maxiter=1000, pc="fdm")
            p2.setUp()
            log(f"fdm setup {time.time()-t1:.1f}s")
            return p2.engine_ops if p2.engine_ops.pc == "fdm" else None
        ops_fdm = guard("fdm_setup", fdm_setup)

    t_solve = t_solve_fdm = None
    specs = [("solve_jacobi", solve_chain, (ops, vort, vel0))]
    if ops_fdm is not None:
        specs.append(("solve_fdm", solve_chain, (ops_fdm, vort, vel0)))
    groupB = guard("solve_group", interleaved_slopes, specs, n1=2,
                   target_s=0.8, rounds=4, time_left=time_left,
                   reserve=min(90.0, 0.25 * budget_s))
    if groupB is not None:
        t_solve = groupB.get("solve_jacobi", (None,))[0]
        t_solve_fdm = groupB.get("solve_fdm", (None,))[0]
        _f = lambda t: "n/a" if t is None else f"{t*1e3:.2f} ms"
        log(f"KLE warm two-stage solve (interleaved): pc={ops.pc} "
            f"{_f(t_solve)}; fdm {_f(t_solve_fdm)}")
    PARTIAL.update(last_milestone="warm_solve")

    # ---- high-order series (BASELINE.md N=6-8 refinement) ---------------
    ho = None
    # gate 110: the section costs ~60-70 s (setup + one chain compile);
    # the r5 validation run showed a 150 s gate losing to the budget in
    # exactly the window where the cheaper sections still fit
    if size == "default" and time_left() > gate(110):
        def ho_section():
            cfg_ho = dict(cfg)
            cfg_ho["domain"] = {"ngl": 7, "box-mesh": {
                "nelem": [8] * dim, "lower": zero, "upper": [1] * dim}}
            ph = Problem(cfg_ho, solver="cg", cg_rtol=1e-12 if f64 else 1e-6,
                         cg_maxiter=1000)
            ph.setUp()
            vh = jnp.asarray(ph.to_local(rng.standard_normal(
                (ph.mesh.n_nodes, ph.dim))), dtype=ph.dtype)
            t_ho, _ = timed_slope(k_chain, ph.engine_ops, vh, n1=100,
                                  reps=5, target_s=1.0)
            nnz_ho = assembled_nnz(ph.mesh)
            flops_ho = 2.0 * ph.mesh.n_cells \
                * (ph.mesh.nnode_el * ph.dim) ** 2
            out = {"gnnz_per_s": round(nnz_ho / t_ho / 1e9, 1),
                   "tflop_per_s": round(flops_ho / t_ho / 1e12, 2),
                   "k_apply_us": round(t_ho * 1e6, 1),
                   "config": f"{tuple(cfg_ho['domain']['box-mesh']['nelem'])}"
                             f" ngl=7"}
            log(f"highorder ngl=7: {out['gnnz_per_s']} GNNZ/s, "
                f"{out['tflop_per_s']} TFLOP/s")
            return out
        ho = guard("highorder", ho_section)
    PARTIAL.update(last_milestone="highorder")

    # ---- IBM per-step costs (r5: previously never measured on-chip) -----
    ibm = None
    if size == "default" and time_left() > gate(120):
        ibm = guard("ibm", _ibm_section, timed_slope, str(p.dtype))
    PARTIAL.update(last_milestone="ibm")

    # ---- memory (after the big programs have run) ------------------------
    mem = _mem_stats(dev)
    if mem:
        log(f"device memory: {mem}")

    # ---- cold solves + rhs (builder artifacts carry these too) ----------
    t_cold = t_cold_fdm = None
    if time_left() > gate(90):
        specs = [("cold_jacobi", cold_chain, (ops, vort, vel0))]
        if ops_fdm is not None and time_left() > gate(150):
            specs.append(("cold_fdm", cold_chain, (ops_fdm, vort, vel0)))
        groupC = guard("cold_group", interleaved_slopes, specs, n1=2,
                       target_s=0.8, rounds=3, time_left=time_left,
                       reserve=min(45.0, 0.1 * budget_s))
        if groupC is not None:
            t_cold = groupC.get("cold_jacobi", (None,))[0]
            t_cold_fdm = groupC.get("cold_fdm", (None,))[0]
            log(f"KLE cold solve: jacobi "
                f"{None if t_cold is None else round(t_cold*1e3, 2)} ms, "
                f"fdm {None if t_cold_fdm is None else round(t_cold_fdm*1e3, 2)} ms")

    @jax.jit
    def _rhs_f(ops_, w, u, nit):
        def body(i, w):
            f_, _ = E.rhs_local(ops_, 0.0, w, u)
            return w + 1e-9 * f_
        return jax.lax.fori_loop(0, nit, body, w)

    def rhs_chain(nit):
        return lambda ops_, w, u: _rhs_f(ops_, w, u, nit)

    t_rhs = None
    if time_left() > gate(60):
        r = guard("rhs_eval", timed_slope, rhs_chain, ops, vort, vel0,
                  n1=2, n2=10, reps=3)
        t_rhs = None if r is None else r[0]
        if t_rhs is not None:
            log(f"full RHS eval: {t_rhs*1e3:.2f} ms")

    ms = lambda t: None if t is None else round(t * 1e3, 3)
    print(json.dumps({
        "metric": "spmv_effective_gnnz_per_s",
        "value": round(gnnz_s, 2),
        "unit": "GNNZ/s",
        "vs_baseline": None,
        "detail": {
            "kle_solve_ms": ms(t_solve),
            "kle_solve_jacobi_ms": ms(t_solve),
            "kle_solve_fdm_ms": ms(t_solve_fdm),
            "kle_cold_jacobi_ms": ms(t_cold),
            "kle_cold_fdm_ms": ms(t_cold_fdm),
            "setup_s": round(setup_s, 1),
            "setup_phases_s": {k: round(v2, 2)
                               for k, v2 in p.setup_phases.items()},
            "rhs_eval_ms": ms(t_rhs),
            "k_apply_ms": round(t_apply * 1e3, 4),
            "phase_us": phase,
            "highorder": ho,
            "ibm": ibm,
            "memory": mem,
            "nnz": nnz,
            "nodes": p.mesh.n_nodes,
            "device": device,
            "protocol": "interleaved min-over-rounds slopes "
                        "(competing variants share windows)",
            "errors": errors,
            "config": f"3D cavity {nelem} ngl={ngl} {p.dtype}",
        },
    }))


#: serializes the worker's final JSON line against the watchdog's partial
#: line: whoever prints first wins, the other stays silent (the driver
#: parses the LAST stdout line, so two lines in either order are a hazard)
_EMIT_LOCK = None


def _run_for_watchdog(done):
    try:
        main()
    except Exception as e:  # noqa: BLE001 — the JSON line ALWAYS prints
        import traceback
        traceback.print_exc(file=sys.stderr)
        with _EMIT_LOCK:
            if not done.is_set():
                print(json.dumps({
                    "metric": "spmv_effective_gnnz_per_s", "value": 0.0,
                    "unit": "GNNZ/s", "vs_baseline": None,
                    "detail": {"errors": [f"fatal: {type(e).__name__}: "
                                          + " ".join(str(e).split())[:300]],
                               **PARTIAL}}))
    finally:
        sys.stdout.flush()
        done.set()


if __name__ == "__main__":
    # HARD wall-clock watchdog: the measurement runs in a worker thread;
    # if it stalls past the budget (a blocked C++ call that no try/except
    # or in-thread budget check can preempt), the main thread emits the
    # JSON line with the milestones recorded so far and hard-exits.
    import threading
    _EMIT_LOCK = threading.Lock()
    done = threading.Event()
    th = threading.Thread(target=_run_for_watchdog, args=(done,),
                          daemon=True)
    t0 = time.time()
    th.start()
    hard_s = float(os.environ.get("PYNAMA_BENCH_HARD_TIMEOUT", 560))
    if not done.wait(hard_s):
        # re-check done INSIDE the lock: if the worker unblocked and
        # printed its real JSON line in the same instant, the stale
        # partial line must NOT follow it (the driver parses the last
        # line)
        with _EMIT_LOCK:
            if done.is_set():
                os._exit(0)
            print(json.dumps({
                "metric": "spmv_effective_gnnz_per_s",
                "value": PARTIAL.get("gnnz_s", 0.0),
                "unit": "GNNZ/s", "vs_baseline": None,
                "detail": {"errors": [
                    f"hard-stall after {time.time()-t0:.0f}s at milestone "
                    f"'{PARTIAL.get('last_milestone', 'startup')}' (device "
                    "execution/fetch hung)"],
                    **PARTIAL}}), flush=True)
            os._exit(0)
