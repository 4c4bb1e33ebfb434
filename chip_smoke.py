"""Run the solver's main path on one GPU and check what comes out.

    python chip_smoke.py          # phases (a)-(d), one card
    python chip_smoke.py --four   # phase (e) only: slab-sharded, four cards

Every phase goes through the user entry points (`Problem(cfg, ...).setUp()`
and `start_solver`, or the engine functions those call) in float32, the
production precision, and checks its output:

  (a) flagship transient: 3D lid-driven cavity 24^3 ngl=4 (the bench
      configuration), Jacobi CG at rtol 1e-6, >= 3 accepted adaptive
      BS5(4) steps with a finite state; warm two-stage KLE solve, RHS
      evaluation, and the K apply with its matmul / DSS split. The K apply
      is checked against a float64 numpy reference on the host (element
      matmul + scatter-add over cell_nodes) at relative max-norm 1e-5: a
      product that fell to TF32 lands near 1e-3, full FP32 near 1e-6.
  (b) accuracy: 2D Taylor-Green, ngl=5, 6x6, t=0.15, cg_rtol 1e-5; the
      relative L2 error of vorticity against the analytic field <= 1e-2.
  (c) high order: 8^3 ngl=7, K apply and one two-stage solve, checked as
      in (a).
  (d) a size users run: 3D cavity 48^3 ngl=4 (~3.0M nodes), setup, one
      warm two-stage solve, one RHS evaluation.
  (e) with --four: the slab-sharded path (ShardedEngine, `-ndev 4`) on a
      48x24x24 ngl=4 cavity; its RHS against the one-card RHS of the same
      Problem at relative max-norm 1e-5, >= 3 accepted sharded steps, and
      every device's peak memory.

Each phase prints one line `phase <name> {json}` with its wall time, its
figures and the devices' `peak_bytes_in_use` (the process's high-water
mark so far). Any failed check raises and the script exits non-zero. The
last line, printed only when every phase passed, is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a GPU the script exits non-zero before any phase runs.
"""
import argparse
import json
import sys
import time

import numpy as np

#: K apply vs the float64 host reference, relative max-norm: full FP32
#: products land near 1e-6, TF32 ones near 1e-3
APPLY_TOL = 1e-5
#: main-stage residual of a solve, relative 2-norm: cg_rtol 1e-6 plus the
#: f32 rounding of the applied operator (a few 1e-6 in float32 on a CPU)
SOLVE_TOL = 1e-4
#: Taylor-Green vorticity, relative L2: the discretization floor of this
#: configuration is ~4e-3 in float64
TG_TOL = 1e-2
#: sharded vs one-card RHS, relative max-norm: the two sum in different
#: orders, and both CG solves stop at rtol 1e-6
SHARD_TOL = 1e-5


def log(name, **fields):
    print(f"phase {name} " + json.dumps(fields, default=float), flush=True)


def peak_bytes():
    """peak_bytes_in_use of every device (None where not reported)."""
    import jax
    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in jax.devices()]


def cavity_config(nelem, ngl, max_steps=4):
    """3D lid-driven cavity: the bench configuration."""
    zero = [0, 0, 0]
    return {
        "name": "smoke-cavity3d",
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": list(nelem), "lower": zero, "upper": [1, 1, 1]}},
        "time-solver": {"start-time": 0, "end-time": 1.0,
                        "max-steps": max_steps},
        "boundary-conditions": {"no-slip": {
            "up": [2, 0, 0], "down": zero, "left": zero, "right": zero,
            "back": zero, "front": zero}},
        "initial-conditions": {"vorticity": zero},
    }


def taylor_green_config(ngl, nelem, t_end):
    return {
        "name": "smoke-tg",
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": [nelem, nelem], "lower": [0, 0], "upper": [1, 1]}},
        "time-solver": {"start-time": 0, "end-time": t_end,
                        "max-steps": 500},
        "boundary-conditions": {"custom-func": {
            "name": "taylor_green",
            "attributes": ["velocity", "vorticity", "alpha"]}},
        "initial-conditions": {"custom-func": {"name": "taylor_green"}},
        "tests": {"custom-func": {"name": "taylor_green"}},
    }


# ------------------------------------------------------------ references
def host_apply(mesh, mat, t_local, ncomp_out):
    """float64 reference of an assembled operator application in local
    layout: y = DSS(t @ mat^T), the DSS as a scatter-add over
    mesh.cell_nodes gathered back to every slot."""
    t = np.asarray(t_local, dtype=np.float64)
    z = t @ np.asarray(mat, dtype=np.float64).T
    cn = np.asarray(mesh.cell_nodes)
    gid = (cn[:, :, None] * ncomp_out
           + np.arange(ncomp_out)[None, None, :]).reshape(z.shape)
    acc = np.bincount(gid.ravel(), weights=z.ravel(),
                      minlength=mesh.n_nodes * ncomp_out)
    return acc[gid]


def check_apply(p, seed=0):
    """K apply on the device against the float64 host reference.
    Returns (relative max-norm error, the random input)."""
    import jax
    from pynama_tpu.engine import local_engine as E
    rng = np.random.default_rng(seed)
    v = p.to_local(rng.standard_normal((p.mesh.n_nodes, p.dim)))
    y = np.asarray(jax.jit(E.apply_K)(p.engine_ops, v), dtype=np.float64)
    ref = host_apply(p.mesh, p._em.K, np.asarray(v), p.dim)
    err = float(np.abs(y - ref).max() / np.abs(ref).max())
    if not err <= APPLY_TOL:
        raise AssertionError(f"K apply error {err:.3e} > {APPLY_TOL}")
    return err, v


def check_solve(p, vort_out, vel_out):
    """Main-stage residual of a two-stage solve's output, in float64 on
    the host, relative to the condensed system's right side
    b = free * (Rw vort - K vc) + vc, vc the imposed boundary velocity
    (which the output carries on its constrained dofs); the residual is
    free * (K vel - Rw vort), the quantity CG drives below rtol * |b|."""
    free = np.asarray(p.engine_ops.free_main, dtype=np.float64)
    vel = np.asarray(vel_out, dtype=np.float64)
    vc = (1.0 - free) * vel
    kv = host_apply(p.mesh, p._em.K, vel, p.dim)
    rw = host_apply(p.mesh, p._em.Rw, np.asarray(vort_out), p.dim)
    if not (np.isfinite(kv).all() and np.isfinite(rw).all()):
        raise AssertionError("solve output not finite")
    b = free * (rw - host_apply(p.mesh, p._em.K, vc, p.dim)) + vc
    res = float(np.linalg.norm(free * (kv - rw)) / np.linalg.norm(b))
    if not res <= SOLVE_TOL:
        raise AssertionError(f"solve residual {res:.3e} > {SOLVE_TOL}")
    return res


# ---------------------------------------------------------------- timing
def best_time(fn, *args, reps=3):
    """Min wall time of fn(*args) over reps calls after one warm-up call
    (which compiles). Returns (seconds, last output)."""
    import jax
    out = jax.block_until_ready(fn(*args))
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def apply_split(ops, v, rounds=5):
    """Per-application time of the K apply, of its matmul alone and of its
    axis rotations alone, as slopes between two chain lengths, the three
    chains timed in turn in every round (min over rounds)."""
    import jax
    import jax.numpy as jnp
    from pynama_tpu.engine import local_engine as E
    from pynama_tpu.ops import local as L

    def rotations(o, x):
        for d in range(len(o.nelem)):
            x = x[:, o.lay_v.perms[d]]
        return x

    bodies = {"apply": E.apply_K, "matmul": lambda o, x: L.mm(x, o.KT),
              "rotations": rotations}

    def chain(body):
        @jax.jit
        def run(o, x, nit):
            def step(i, x):
                y = body(o, x)
                return y / (1.0 + jnp.max(jnp.abs(y)))
            return jax.lax.fori_loop(0, nit, step, x)
        return run

    runs = {k: chain(b) for k, b in bodies.items()}
    n1 = 20
    t_short = {k: best_time(r, ops, v, n1, reps=1)[0]
               for k, r in runs.items()}
    n2 = {k: int(np.clip(0.5 / max(t / n1, 1e-7), 5 * n1, 20000))
          for k, t in t_short.items()}
    for k, r in runs.items():
        jax.block_until_ready(r(ops, v, n2[k]))
    best = {k: [np.inf, np.inf] for k in runs}
    for _ in range(rounds):
        for k, r in runs.items():
            for j, n in enumerate((n1, n2[k])):
                t0 = time.perf_counter()
                jax.block_until_ready(r(ops, v, n))
                best[k][j] = min(best[k][j], time.perf_counter() - t0)
    us = {k: 1e6 * (b[1] - b[0]) / (n2[k] - n1) for k, b in best.items()}
    return {"apply_us": us["apply"], "matmul_us": us["matmul"],
            "dss_us": us["apply"] - us["matmul"],
            "rotations_us": us["rotations"]}


def solve_and_rhs(p, vort, vel_prev, t):
    """One warm two-stage KLE solve and one RHS evaluation, timed, with
    the solve checked on the host."""
    import jax
    from pynama_tpu.engine import local_engine as E
    ops = p.engine_ops
    t_solve, (w_out, v_out) = best_time(jax.jit(E.solve_kle_local), ops,
                                        vort, vel_prev, t)
    res = check_solve(p, w_out, v_out)
    t_rhs, (f, _) = best_time(jax.jit(E.rhs_local), ops, t, vort, vel_prev)
    if not np.isfinite(np.asarray(f)).all():
        raise AssertionError("RHS not finite")
    return {"solve_ms": 1e3 * t_solve, "solve_residual": res,
            "rhs_ms": 1e3 * t_rhs}


# ---------------------------------------------------------------- phases
def phase_transient(nelem=(24, 24, 24), ngl=4, max_steps=4, cg_rtol=1e-6,
                    split=True):
    """(a) adaptive transient of the lid cavity, then a warm solve, an
    RHS evaluation and the K apply, each checked."""
    from pynama_tpu.cases import Problem
    t0 = time.perf_counter()
    p = Problem(cavity_config(nelem, ngl, max_steps), solver="cg",
                cg_rtol=cg_rtol, cg_maxiter=1000)
    p.setUp()
    setup_s = time.perf_counter() - t0
    stamps, prev = [], {}

    def post(step, t, dt, vort, vel):
        stamps.append(time.perf_counter())
        prev["vel"] = prev.get("cur")
        prev["cur"] = vel

    t_end, steps = p.start_solver(post_step=post, dt0=2e-3)
    vort, vel = np.asarray(p.vort), np.asarray(p.vel)
    if steps < 3:
        raise AssertionError(f"only {steps} accepted steps")
    if not (np.isfinite(vort).all() and np.isfinite(vel).all()):
        raise AssertionError("transient state not finite")
    out = {"nelem": list(nelem), "ngl": ngl, "nodes": p.mesh.n_nodes,
           "setup_s": setup_s, "setup_phases_s": p.setup_phases,
           "accepted_steps": steps, "t": t_end,
           "step_s": (stamps[-1] - stamps[0]) / (len(stamps) - 1)}
    # production's warm start: this step's vorticity, last step's velocity
    out.update(solve_and_rhs(p, p.to_local(vort), p.to_local(prev["vel"]),
                             t_end))
    out["apply_error"], v = check_apply(p)
    if split:
        out.update(apply_split(p.engine_ops, v))
    return out


def phase_taylor_green(ngl=5, nelem=6, t_end=0.15, cg_rtol=1e-5):
    """(b) 2D Taylor-Green vortex against its analytic vorticity."""
    from pynama_tpu.cases import Problem
    from pynama_tpu.functions import taylor_green as tg
    p = Problem(taylor_green_config(ngl, nelem, t_end), solver="cg",
                cg_rtol=cg_rtol, cg_maxiter=2000)
    p.setUp()
    t, steps = p.start_solver(atol=1e-4, rtol=1e-4, dt0=1e-3)
    w = np.asarray(p.vort, dtype=np.float64)
    w_exact = np.asarray(tg.vorticity(p.mesh.coords, tg.alpha(p.nu, t)))
    err = float(np.linalg.norm(w - w_exact) / np.linalg.norm(w_exact))
    if not (abs(t - t_end) < 1e-9 and err <= TG_TOL):
        raise AssertionError(f"Taylor-Green error {err:.3e} at t={t}")
    return {"ngl": ngl, "nelem": [nelem, nelem], "t": t,
            "accepted_steps": steps, "vorticity_rel_l2": err}


def phase_apply_solve(nelem=(8, 8, 8), ngl=7, cg_rtol=1e-6, split=True):
    """(c) K apply and one two-stage solve (cold start from zero
    velocity), checked against the host reference."""
    import jax
    import jax.numpy as jnp
    from pynama_tpu.cases import Problem
    from pynama_tpu.engine import local_engine as E
    t0 = time.perf_counter()
    p = Problem(cavity_config(nelem, ngl), solver="cg", cg_rtol=cg_rtol,
                cg_maxiter=1000)
    p.setUp()
    out = {"nelem": list(nelem), "ngl": ngl, "nodes": p.mesh.n_nodes,
           "setup_s": time.perf_counter() - t0}
    out["apply_error"], v = check_apply(p)
    vort = jax.jit(E.curl)(p.engine_ops, v)
    t_solve, (w_out, v_out) = best_time(
        jax.jit(E.solve_kle_local), p.engine_ops, vort, jnp.zeros_like(v),
        0.0)
    out["cold_solve_ms"] = 1e3 * t_solve
    out["solve_residual"] = check_solve(p, w_out, v_out)
    if split:
        out.update(apply_split(p.engine_ops, v))
    return out


def phase_large(nelem=(48, 48, 48), ngl=4, cg_rtol=1e-6):
    """(d) setup, a warm two-stage solve and an RHS evaluation at a size
    users run."""
    import jax
    import jax.numpy as jnp
    from pynama_tpu.cases import Problem
    from pynama_tpu.engine import local_engine as E
    t0 = time.perf_counter()
    p = Problem(cavity_config(nelem, ngl), solver="cg", cg_rtol=cg_rtol,
                cg_maxiter=1000)
    p.setUp()
    out = {"nelem": list(nelem), "ngl": ngl, "nodes": p.mesh.n_nodes,
           "velocity_dofs": p.mesh.n_nodes * p.dim,
           "setup_s": time.perf_counter() - t0,
           "setup_phases_s": p.setup_phases}
    rng = np.random.default_rng(1)
    v = p.to_local(rng.standard_normal((p.mesh.n_nodes, p.dim)))
    vort = jax.jit(E.curl)(p.engine_ops, v)
    _, vel1 = jax.jit(E.solve_kle_local)(p.engine_ops, vort,
                                         jnp.zeros_like(v), 0.0)
    # warm: a slightly changed vorticity from the previous velocity
    out.update(solve_and_rhs(p, vort * 1.001, vel1, 0.0))
    return out


def phase_four(nelem=(48, 24, 24), ngl=4, ndev=4, cg_rtol=1e-6):
    """(e) the slab-sharded path over ndev devices: RHS against the
    one-card RHS of the same Problem, and an adaptive transient."""
    import jax
    from pynama_tpu.cases import Problem
    from pynama_tpu.engine import local_engine as E
    from pynama_tpu.parallel import ShardedEngine
    if len(jax.devices()) < ndev:
        raise RuntimeError(f"needs {ndev} devices, found "
                           f"{len(jax.devices())}")
    t0 = time.perf_counter()
    p = Problem(cavity_config(nelem, ngl), solver="cg", cg_rtol=cg_rtol,
                cg_maxiter=1000, ndev=ndev)
    p.setUp()
    out = {"nelem": list(nelem), "ngl": ngl, "ndev": ndev,
           "nodes": p.mesh.n_nodes, "setup_s": time.perf_counter() - t0,
           "peak_bytes_after_setup": peak_bytes()}
    t_end, steps = p.start_solver(dt0=2e-3)
    if steps < 3 or not np.isfinite(np.asarray(p.vort)).all():
        raise AssertionError(f"sharded transient: {steps} steps")
    out.update(accepted_steps=steps, t=t_end)

    rng = np.random.default_rng(2)
    vort_g = rng.standard_normal((p.mesh.n_nodes, p.dim_w))
    vel_g = np.zeros((p.mesh.n_nodes, p.dim))
    se = ShardedEngine(p, ndev)
    vort_s, vel_s = se.shard_state(vort_g, vel_g)
    t_rhs, (f_s, _) = best_time(se.make_rhs(), se.ops_s, 0.0, vort_s, vel_s)
    f_sharded = np.asarray(f_s).reshape(-1, f_s.shape[-1])
    out["sharded_rhs_ms"] = 1e3 * t_rhs
    out["peak_bytes_sharded"] = peak_bytes()
    del se, f_s, vort_s, vel_s

    # one card: the same Problem's global engine, sent to device 0
    ops1 = jax.device_put(p.engine_ops, jax.devices()[0])
    t_one, (f1, _) = best_time(jax.jit(E.rhs_local), ops1, 0.0,
                               p.to_local(vort_g), p.to_local(vel_g))
    f1 = np.asarray(f1, dtype=np.float64)
    err = float(np.abs(f_sharded - f1).max() / np.abs(f1).max())
    if not err <= SHARD_TOL:
        raise AssertionError(f"sharded RHS differs by {err:.3e}")
    out.update(one_card_rhs_ms=1e3 * t_one, rhs_rel_diff=err)
    return out


# ------------------------------------------------------------------ main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the slab-sharded phase on four devices")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices}",
              file=sys.stderr)
        return 1

    from pynama_tpu import native
    from pynama_tpu.utils.compile_cache import enable_compile_cache
    from pynama_tpu.utils.profiling import card_info
    enable_compile_cache()

    def importable(mod):
        try:
            __import__(mod)
        except ImportError:
            return False
        return True

    print(f"jax {jax.__version__}; devices {devices}", flush=True)
    print(f"card: {card_info()}", flush=True)
    print(f"native mesh kernel loaded: {native.available()}; "
          f"yaml: {importable('yaml')}; h5py: {importable('h5py')}",
          flush=True)

    if args.four:
        phases = [("four", phase_four)]
    else:
        phases = [("transient", phase_transient),
                  ("taylor_green", phase_taylor_green),
                  ("high_order", phase_apply_solve),
                  ("large", phase_large)]
    for name, fn in phases:
        t0 = time.perf_counter()
        out = fn()
        log(name, wall_s=time.perf_counter() - t0,
            peak_bytes_in_use=peak_bytes(), **out)

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
