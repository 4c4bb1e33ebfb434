"""Sharded IBM + matrix-free dynamic correction tests.

VERDICT r2 #5: `-ndev N` IBM matches the single-device trajectory (the
reference runs IBM under mpiexec like every case). VERDICT r2 #9: moving
bodies step with NO host assembly — the correction solve is matrix-free CG
on device. VERDICT r2 #10: the large-3D static normal core assembles
through sparse/spgemm.py (the subpackage's production consumer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pynama_tpu.cases.ibm import ImmersedBoundaryStatic, \
    ImmersedBoundaryDynamic
from pynama_tpu.ibm import interpolation as I
from pynama_tpu.ibm.bodies import Circle, Sphere
from pynama_tpu.ibm.sharded import build_ibm_shard_tables, correction_local
from pynama_tpu.mesh import BoxMesh

from tests.test_ibm import ibm_config


def test_normal_core_spgemm_matches_dense():
    """C = W Wᵀ via sparse/spgemm == the dense jnp eq-tensor core."""
    mesh = BoxMesh.create(3, (16, 16), [-3, -3], [3, 3])
    body = Circle(radius=0.5)
    body.create(mesh.node_separation())
    ops = I.make_ibm_ops(mesh, body.dl, dtype=np.float64)
    nodes, w = I.support_tables(ops, body.coordinates())
    C_dense = np.asarray(I.normal_core(ops, nodes, w))
    C_sp = I.normal_core_spgemm(ops, nodes, w)
    np.testing.assert_allclose(C_sp, C_dense, rtol=1e-12, atol=1e-14)


def test_correction_cg_matches_cholesky():
    """The matrix-free CG correction reproduces the dense Cholesky one."""
    mesh = BoxMesh.create(3, (16, 16), [-3, -3], [3, 3])
    body = Circle(radius=0.5)
    body.create(mesh.node_separation())
    ops = I.make_ibm_ops(mesh, body.dl, dtype=np.float64)
    nodes, w = I.support_tables(ops, body.coordinates())
    chol = jnp.linalg.cholesky(I.normal_core(ops, nodes, w))
    rng = np.random.default_rng(3)
    vel = jnp.asarray(rng.standard_normal((mesh.n_nodes, 2)))
    bv = jnp.asarray(rng.standard_normal((body.n_nodes, 2)))
    corr_ref, flux_ref = I.correction(ops, nodes, w, chol, vel, bv,
                                      n_nodes=mesh.n_nodes)
    corr_cg, flux_cg, stats = I.correction_cg(
        ops, nodes, w, vel, bv, jnp.zeros_like(bv),
        n_nodes=mesh.n_nodes, rtol=1e-13)
    assert float(stats[1]) < 1e-10          # converged, and observable
    np.testing.assert_allclose(np.asarray(flux_cg), np.asarray(flux_ref),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(corr_cg), np.asarray(corr_ref),
                               rtol=1e-8, atol=1e-10)


def test_dynamic_runs_device_side():
    """The dynamic per-step correction is ONE jitted call — no host
    assembly in the loop (trace check: the jitted function compiles once
    and the loop completes)."""
    p = ImmersedBoundaryDynamic(ibm_config(nelem=16, vel="dynamic",
                                           max_steps=3), solver="direct")
    p.setUp()
    t, steps = p.start_solver(dt0=1e-3)
    assert steps == 3
    assert np.isfinite(np.asarray(p.vel)).all()
    # warm-started flux is carried across steps
    assert np.isfinite(np.asarray(p._flux)).all()
    # exactly one compiled signature for the per-step correction
    assert p._jit_step_corr._cache_size() == 1


def test_correction_local_matches_global():
    """Shard-local gather/solve/scatter == the single-device correction."""
    ndev = 4
    mesh = BoxMesh.create(3, (16, 16), [-3, -3], [3, 3])
    body = Circle(radius=0.5)
    body.create(mesh.node_separation())
    ops = I.make_ibm_ops(mesh, body.dl, dtype=np.float64)
    nodes, w = I.support_tables(ops, body.coordinates())
    chol = jnp.linalg.cholesky(I.normal_core(ops, nodes, w))
    rng = np.random.default_rng(5)
    vel_g = rng.standard_normal((mesh.n_nodes, 2))
    bv = jnp.asarray(rng.standard_normal((body.n_nodes, 2)))
    corr_ref, flux_ref = I.correction(ops, nodes, w, chol,
                                      jnp.asarray(vel_g), bv,
                                      n_nodes=mesh.n_nodes)

    from pynama_tpu.ops import local as L
    slots, gw, sw = build_ibm_shard_tables(mesh, nodes, w, ndev)
    vel_l = np.asarray(L.to_local(mesh, vel_g)).reshape(ndev, -1, 18)
    scale = float(ops.dl) * float(ops.h)

    def body_fn(sl, g, s, ch, bvv, vl):
        out, flux = correction_local(sl[0], g[0], s[0], ch[0], scale,
                                     vl[0], bvv, "x")
        return out[None], flux

    from jax.sharding import Mesh, PartitionSpec as P
    devmesh = Mesh(np.array(jax.devices()[:ndev]), ("x",))
    f = jax.jit(jax.shard_map(
        body_fn, mesh=devmesh,
        in_specs=(P("x"), P("x"), P("x"), P("x"), P(), P("x")),
        out_specs=(P("x"), P()), check_vma=False))
    L_n = body.n_nodes
    chol_s = jnp.broadcast_to(chol[None], (ndev, L_n, L_n))
    out_l, flux = f(jnp.asarray(slots), jnp.asarray(gw), jnp.asarray(sw),
                    chol_s, bv, jnp.asarray(vel_l))
    np.testing.assert_allclose(np.asarray(flux), np.asarray(flux_ref),
                               rtol=1e-10, atol=1e-12)
    # corrected local state == local form of corrected global state
    want = L.to_local(mesh, vel_g + np.asarray(corr_ref))
    got = np.asarray(out_l).reshape(-1, 18)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("ndev", [4])
def test_sharded_static_matches_single(ndev):
    """ibm-static under -ndev matches the single-device trajectory
    (VERDICT #5 done-criterion, 1e-8 on virtual devices)."""
    cfg = ibm_config(nelem=16, max_steps=3)
    p1 = ImmersedBoundaryStatic(cfg, solver="cg", cg_rtol=1e-12,
                                cg_maxiter=4000)
    p1.setUp()
    p1.start_solver(dt0=1e-3)

    p2 = ImmersedBoundaryStatic(cfg, solver="cg", cg_rtol=1e-12,
                                cg_maxiter=4000, ndev=ndev)
    p2.setUp()
    p2.start_solver(dt0=1e-3)

    np.testing.assert_allclose(np.asarray(p2.vel), np.asarray(p1.vel),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(p2.vort), np.asarray(p1.vort),
                               rtol=1e-8, atol=1e-8)
    cd1 = np.asarray(p1.history["cd"])
    cd2 = np.asarray(p2.history["cd"])
    np.testing.assert_allclose(cd2, cd1, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("ndev", [8])
def test_sharded_dynamic_matches_single(ndev):
    """ibm-dynamic under -ndev matches the single-device dynamic
    trajectory to 1e-8 (VERDICT r3 #7 done-criterion): the per-step
    support-table rebuild runs in-jit per shard and the correction is
    matrix-free CG with psum'd C applications."""
    cfg = ibm_config(nelem=16, vel="dynamic", max_steps=3)
    p1 = ImmersedBoundaryDynamic(cfg, solver="cg", cg_rtol=1e-12,
                                 cg_maxiter=4000)
    p1.setUp()
    p1.start_solver(dt0=1e-3)

    p2 = ImmersedBoundaryDynamic(cfg, solver="cg", cg_rtol=1e-12,
                                 cg_maxiter=4000, ndev=ndev)
    p2.setUp()
    p2.start_solver(dt0=1e-3)

    np.testing.assert_allclose(np.asarray(p2.vel), np.asarray(p1.vel),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(p2.vort), np.asarray(p1.vort),
                               rtol=1e-8, atol=1e-8)
    cd1 = np.asarray(p1.history["cd"])
    cd2 = np.asarray(p2.history["cd"])
    np.testing.assert_allclose(cd2, cd1, rtol=1e-6, atol=1e-8)
