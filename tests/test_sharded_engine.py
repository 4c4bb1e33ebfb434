"""Sharded local-engine vs single-device engine equivalence (8 virtual CPU
devices, the cheap analog of a multi-card host — conftest forces the
device count)."""
import jax
import numpy as np
import pytest

from pynama_tpu.cases import Problem
from pynama_tpu.engine import local_engine as E
from pynama_tpu.parallel.sharded_engine import ShardedEngine


def cavity_config(nelem0=8, ngl=3, dim=2):
    zero = [0] * dim
    ns = {"up": [1.0] + [0] * (dim - 1), "down": zero, "left": zero,
          "right": zero}
    if dim == 3:
        ns["back"] = zero
        ns["front"] = zero
    nelem = [nelem0] + [2] * (dim - 1)
    return {
        "name": "cavity",
        "material-properties": {"rho": 1.0, "mu": 0.02},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": nelem, "lower": zero, "upper": [1] * dim}},
        "time-solver": {"start-time": 0, "end-time": 0.01, "max-steps": 20},
        "boundary-conditions": {"no-slip": ns},
        "initial-conditions": {"vorticity": [0] * (1 if dim == 2 else 3)},
    }


def tg_config(nelem0=8, ngl=3):
    return {
        "name": "tg",
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": [nelem0, 2], "lower": [0, 0], "upper": [1, 1]}},
        "time-solver": {"start-time": 0, "end-time": 0.1, "max-steps": 50},
        "boundary-conditions": {"custom-func": {
            "name": "taylor_green",
            "attributes": ["velocity", "vorticity", "alpha"]}},
        "initial-conditions": {"custom-func": {"name": "taylor_green"}},
        "tests": {"custom-func": {"name": "taylor_green"}},
    }


@pytest.mark.parametrize("ndev", [1, 4, 8])
@pytest.mark.parametrize("cfg_fn", [cavity_config, tg_config])
def test_sharded_rhs_matches(ndev, cfg_fn):
    p = Problem(cfg_fn(), solver="cg", cg_rtol=1e-13, cg_maxiter=4000)
    p.setUp()
    rng = np.random.default_rng(0)
    vort = rng.standard_normal((p.mesh.n_nodes, p.dim_w))
    vel = np.zeros((p.mesh.n_nodes, p.dim))

    f_ref, vel_ref = E.rhs_local(p.engine_ops, 0.1, p.to_local(vort),
                                 p.to_local(vel))
    f_ref = p.to_global(f_ref, p.dim_w)

    sk = ShardedEngine(p, ndev)
    rhs = sk.make_rhs()
    vort_s, vel_s = sk.shard_state(vort, vel)
    f_s, vel_s_out = rhs(sk.ops_s, 0.1, vort_s, vel_s)
    f_got = sk.gather_state(f_s, p.dim_w)
    np.testing.assert_allclose(f_got, f_ref, rtol=1e-8, atol=1e-9)


def test_sharded_attempt_matches():
    """Full RK trial step: sharded result and error norm match 1-device."""
    p = Problem(cavity_config(8, 3, 2), solver="cg", cg_rtol=1e-13,
                cg_maxiter=4000)
    p.setUp()
    rng = np.random.default_rng(2)
    vort = 0.1 * rng.standard_normal((p.mesh.n_nodes, p.dim_w))
    vel = np.zeros((p.mesh.n_nodes, p.dim))

    results = {}
    for ndev in (1, 8):
        sk = ShardedEngine(p, ndev)
        att = sk.make_attempt(atol=1e-6, rtol=1e-6)
        vort_s, vel_s = sk.shard_state(vort, vel)
        y, enorm, aux = att(sk.ops_s, 0.0, 1e-4, vort_s, vel_s)
        results[ndev] = (sk.gather_state(y, p.dim_w), float(enorm))

    y1, e1 = results[1]
    y8, e8 = results[8]
    np.testing.assert_allclose(y8, y1, rtol=1e-8, atol=1e-10)
    assert abs(e1 - e8) < 1e-8 * max(1.0, abs(e1))


def test_sharded_3d():
    p = Problem(cavity_config(4, 3, 3), solver="cg", cg_rtol=1e-12,
                cg_maxiter=3000)
    p.setUp()
    rng = np.random.default_rng(3)
    vort = rng.standard_normal((p.mesh.n_nodes, 3))
    vel = np.zeros((p.mesh.n_nodes, 3))
    f_ref, _ = E.rhs_local(p.engine_ops, 0.0, p.to_local(vort),
                           p.to_local(vel))
    f_ref = p.to_global(f_ref, 3)
    sk = ShardedEngine(p, 4)
    rhs = sk.make_rhs()
    vort_s, vel_s = sk.shard_state(vort, vel)
    f_s, _ = rhs(sk.ops_s, 0.0, vort_s, vel_s)
    np.testing.assert_allclose(sk.gather_state(f_s, 3), f_ref,
                               rtol=1e-7, atol=1e-8)


def test_graft_entry():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out[0])).all()
    ge.dryrun_multichip(8)


def test_sharded_transient_matches_single_device():
    """VERDICT r1 #1: the full -ndev production transient (host dt
    controller + sharded attempt + accepted-state BC pin) integrates to
    end-time and matches the 1-device run."""
    cfg = cavity_config(8, 3, 2)
    cfg["time-solver"] = {"start-time": 0, "end-time": 1.0, "max-steps": 5}

    ref = Problem(cfg, solver="cg", cg_rtol=1e-13, cg_maxiter=4000)
    ref.setUp()
    t1, s1 = ref.start_solver(dt0=1e-3, atol=1e-6, rtol=1e-6)

    p = Problem(cfg, solver="cg", cg_rtol=1e-13, cg_maxiter=4000, ndev=8)
    p.setUp()
    t8, s8 = p.start_solver(dt0=1e-3, atol=1e-6, rtol=1e-6)

    assert s1 == s8 >= 3
    # psum dot ordering perturbs enorm at ~1e-12; the dt controller
    # compounds that into the accumulated time at ~1e-8
    assert abs(t1 - t8) <= 1e-6 * max(1.0, abs(t1))
    np.testing.assert_allclose(np.asarray(p.vort), np.asarray(ref.vort),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(p.vel), np.asarray(ref.vel),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("dim", [2, 3])
def test_overlapped_dss_matches(dim):
    """Comm/compute-overlapped DSS (ops/local.py dss_overlapped, the
    VecScatter-overlap analog of SURVEY §2.3) equals the plain sharded
    DSS up to f.p. summation order."""
    cfg = cavity_config(8, 3, dim)
    p = Problem(cfg, solver="cg", cg_rtol=1e-12, cg_maxiter=3000)
    p.setUp()
    rng = np.random.default_rng(7)
    vort = rng.standard_normal((p.mesh.n_nodes, p.dim_w))
    vel = np.zeros((p.mesh.n_nodes, p.dim))
    outs = {}
    for ov in (False, True):
        sk = ShardedEngine(p, 4, overlap_dss=ov)
        rhs = sk.make_rhs()
        vort_s, vel_s = sk.shard_state(vort, vel)
        f_s, v_s = rhs(sk.ops_s, 0.1, vort_s, vel_s)
        outs[ov] = (sk.gather_state(f_s, p.dim_w),
                    sk.gather_state(v_s, p.dim))
    np.testing.assert_allclose(outs[True][0], outs[False][0],
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(outs[True][1], outs[False][1],
                               rtol=1e-9, atol=1e-11)


def test_overlapped_dss_transient():
    """Full -ndev transient with overlap_dss on matches the plain run."""
    cfg = cavity_config(8, 3, 2)
    cfg["time-solver"] = {"start-time": 0, "end-time": 0.01, "max-steps": 3}
    res = {}
    for ov in (False, True):
        p = Problem(cfg, solver="cg", cg_rtol=1e-12, cg_maxiter=3000,
                    ndev=8, overlap_dss=ov)
        p.setUp()
        t, steps = p.start_solver(dt0=1e-3, atol=1e-4, rtol=1e-4)
        res[ov] = (steps, np.asarray(p.vort))
    assert res[True][0] == res[False][0]
    np.testing.assert_allclose(res[True][1], res[False][1],
                               rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("dim", [2, 3])
def test_sharded_fdm_rhs_matches(dim):
    """Slab-sharded FDM preconditioner (solver/fdm.py shard_fdm): sharded
    RHS under pc="fdm" equals the single-device FDM run. Exercises the
    ownership-weighted axis-0 projection + psum, the FS-stage SlabFDM, and
    the jleft corner-rule slab slices (no-slip cavity has both stages)."""
    p = Problem(cavity_config(8, 3, dim), solver="cg", pc="fdm",
                cg_rtol=1e-12, cg_maxiter=3000)
    p.setUp()
    assert p.engine_ops.pc == "fdm"
    rng = np.random.default_rng(11)
    vort = rng.standard_normal((p.mesh.n_nodes, p.dim_w))
    vel = np.zeros((p.mesh.n_nodes, p.dim))
    f_ref, _ = E.rhs_local(p.engine_ops, 0.1, p.to_local(vort),
                           p.to_local(vel))
    f_ref = p.to_global(f_ref, p.dim_w)
    for ndev in (2, 8):
        sk = ShardedEngine(p, ndev)
        assert sk.ops_s.pc == "fdm"          # no Jacobi fallback anymore
        vort_s, vel_s = sk.shard_state(vort, vel)
        f_s, _ = sk.make_rhs()(sk.ops_s, 0.1, vort_s, vel_s)
        np.testing.assert_allclose(sk.gather_state(f_s, p.dim_w), f_ref,
                                   rtol=1e-8, atol=1e-10)


def test_sharded_fdm_transient():
    """Full -ndev production transient with pc="fdm" matches 1-device."""
    cfg = cavity_config(8, 3, 2)
    cfg["time-solver"] = {"start-time": 0, "end-time": 1.0, "max-steps": 4}
    ref = Problem(cfg, solver="cg", pc="fdm", cg_rtol=1e-13,
                  cg_maxiter=4000)
    ref.setUp()
    t1, s1 = ref.start_solver(dt0=1e-3, atol=1e-6, rtol=1e-6)
    p = Problem(cfg, solver="cg", pc="fdm", cg_rtol=1e-13, cg_maxiter=4000,
                ndev=8)
    p.setUp()
    t8, s8 = p.start_solver(dt0=1e-3, atol=1e-6, rtol=1e-6)
    assert s1 == s8 >= 3
    # the FDM psum reorders mode-grid summation; the dt controller
    # compounds the ~1e-12 per-step drift into ~1e-6 relative by end-time
    np.testing.assert_allclose(np.asarray(p.vort), np.asarray(ref.vort),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(p.vel), np.asarray(ref.vel),
                               rtol=1e-5, atol=1e-8)
