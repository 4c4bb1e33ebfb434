"""Every matrix product on the main path asks for full precision.

Without a precision argument XLA may compute an f32 product in reduced
precision (TF32 on NVIDIA tensor cores), which makes the penalized KLE
operator indefinite (ops/local.py `mm`). A CPU run cannot show that, so
this walks the traced programs of the hot-path functions and asserts that
every dot_general carries Precision.HIGHEST on both operands.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pynama_tpu.cases import Problem
from pynama_tpu.engine import local_engine as E

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _sub_jaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def dot_precisions(fn, *args):
    """Precision params of every dot_general in fn's traced program,
    nested loops/conds/calls included."""
    found = []
    todo = [jax.make_jaxpr(fn)(*args).jaxpr]
    while todo:
        jaxpr = todo.pop()
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                todo.extend(_sub_jaxprs(v))
    return found


def _cavity(nelem=(3, 2, 2), ngl=3, **kw):
    zero = [0, 0, 0]
    cfg = {
        "name": "precision",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": list(nelem), "lower": zero, "upper": [1, 1, 1]}},
        "boundary-conditions": {"no-slip": {
            s: ([1, 0, 0] if s == "up" else zero) for s in
            ("up", "down", "left", "right", "back", "front")}},
        "initial-conditions": {"vorticity": zero},
    }
    p = Problem(cfg, solver="cg", cg_rtol=1e-8, cg_maxiter=50, **kw)
    p.setUp()
    return p


def _state(p):
    rng = np.random.default_rng(0)
    v = p.to_local(rng.standard_normal((p.mesh.n_nodes, p.dim)))
    return v, E.curl(p.engine_ops, v)


def case_apply_k():
    p = _cavity()
    v, _ = _state(p)
    return E.apply_K, (p.engine_ops, v)


def case_solve():
    p = _cavity()
    v, w = _state(p)
    return E.solve_kle_local, (p.engine_ops, w, v, 0.0)


def case_rhs():
    p = _cavity()
    v, w = _state(p)
    return E.rhs_local, (p.engine_ops, 0.0, w, v)


def case_fdm():
    from pynama_tpu.solver.fdm import fdm_apply
    p = _cavity(pc="fdm")
    ops = p.engine_ops
    assert ops.pc == "fdm"
    v, _ = _state(p)
    return (lambda o, r: fdm_apply(o.fdm_main, r, nelem=o.nelem,
                                   ngl=o.ngl)), (ops, v)


def case_sumfact():
    from pynama_tpu.basis import make_tensor_basis
    from pynama_tpu.ops.sumfact import apply_sumfact_k, build_sumfact
    rng = np.random.default_rng(1)
    base = np.array(np.meshgrid(*[[0.0, 1.0]] * 3,
                                indexing="ij")).reshape(3, -1).T
    corners = np.stack([base + 0.1 * rng.standard_normal(base.shape)
                        for _ in range(3)])
    sf = build_sumfact(make_tensor_basis(3, 3), corners, jnp.float64)
    t = jnp.asarray(rng.standard_normal((3, 27 * 3)))
    return apply_sumfact_k, (sf, t)


def _ibm(vel):
    from pynama_tpu.cases.ibm import (ImmersedBoundaryDynamic,
                                      ImmersedBoundaryStatic)
    cfg = {
        "name": "precision-ibm",
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": 3, "box-mesh": {
            "nelem": [8, 8], "lower": [-3, -3], "upper": [3, 3]}},
        "boundary-conditions": {"uniform": {"velocity": [1.0, 0.0]}},
        "initial-conditions": {"vorticity": [0]},
        "bodies": [{"type": "circle", "vel": vel, "radius": 0.5,
                    "center": [0, 0]}],
    }
    cls = ImmersedBoundaryDynamic if vel == "dynamic" \
        else ImmersedBoundaryStatic
    p = cls(cfg, solver="cg", cg_rtol=1e-8, cg_maxiter=200)
    p.setUp()
    rng = np.random.default_rng(2)
    v = jnp.asarray(rng.standard_normal((p.mesh.n_nodes, 2)))
    bv = jnp.asarray(p.body.velocities())
    return p, v, bv


def case_ibm_static():
    from pynama_tpu.ibm import interpolation as I
    p, v, bv = _ibm("static")
    n = p.mesh.n_nodes
    return (lambda *a: I.correction(*a, n_nodes=n)), (
        p.ibm_ops, p.nodes_tab, p.w_tab, p.chol, v, bv)


def case_ibm_dynamic():
    from pynama_tpu.ibm import interpolation as I
    p, v, bv = _ibm("dynamic")
    n = p.mesh.n_nodes
    xy = jnp.asarray(p.body.coordinates())
    f0 = jnp.zeros((p.body.n_nodes, 2))

    def fn(iops, xy, v, bv, f0):
        nodes, w = I.support_tables(iops, xy)
        return I.correction_cg(iops, nodes, w, v, bv, f0, n_nodes=n,
                               rtol=1e-8)
    return fn, (p.ibm_ops, xy, v, bv, f0)


@pytest.mark.parametrize("case", [
    case_apply_k, case_solve, case_rhs, case_fdm, case_sumfact,
    case_ibm_static, case_ibm_dynamic], ids=lambda c: c.__name__[5:])
def test_every_dot_is_highest(case):
    fn, args = case()
    precisions = dot_precisions(fn, *args)
    assert precisions, "no matrix product traced"
    bad = [p for p in precisions if p != HIGHEST]
    assert not bad, f"{len(bad)} of {len(precisions)} products: {bad[:3]}"
