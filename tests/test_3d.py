"""3D end-to-end coverage: KLE convergence, operator errors, transient FS
run, and the two-stage no-slip solve on a 3D cavity.

The reference exercises 3D through its custom-func cases
(`src/functions/taylor_green3d.py`, `src/cases/taylor-green3d.yaml`) and the
Spectral 3D element path (`src/domain/elements/spectral.py:67-90,312-355`);
these tests assert the same behaviors on this build.
"""
import numpy as np
import pytest

from pynama_tpu.cases import Problem


def tg3_config(ngl, nelem=3):
    return {
        "name": "tg3d",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": [nelem] * 3, "lower": [0, 0, 0], "upper": [1, 1, 1]}},
        "time-solver": {"start-time": 0, "end-time": 0.01, "max-steps": 5},
        "boundary-conditions": {"custom-func": {
            "name": "taylor_green3d",
            "attributes": ["velocity", "vorticity", "alpha"]}},
        "initial-conditions": {"custom-func": {"name": "taylor_green3d"}},
        "tests": {"custom-func": {"name": "taylor_green3d"}},
    }


def cavity3_config(ngl=3, nelem=3):
    zero = [0, 0, 0]
    return {
        "name": "cavity3d",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": [nelem] * 3, "lower": zero, "upper": [1, 1, 1]}},
        "time-solver": {"start-time": 0, "end-time": 0.01, "max-steps": 3},
        "boundary-conditions": {"no-slip": {
            "up": [1, 0, 0], "down": zero, "left": zero, "right": zero,
            "back": zero, "front": zero}},
        "initial-conditions": {"vorticity": zero},
    }


def test_kle_p_convergence_3d():
    """Velocity error decreases monotonically with ngl (3D analog of the
    reference chart sweep, run_case.py:48-77)."""
    errs = []
    for ngl in (3, 4, 5):
        p = Problem(tg3_config(ngl), solver="direct")
        p.setUp()
        errs.append(p.kle_errors([0.1])[0])
    assert errs[0] > errs[1] > errs[2]
    assert errs[2] < 1e-2


def test_cg_matches_direct_3d():
    pd = Problem(tg3_config(4), solver="direct")
    pd.setUp()
    pc = Problem(tg3_config(4), solver="cg")
    pc.setUp()
    ev, ew = pd.exact_fields(0.1)
    _, v1 = pd.solve_kle(ew, pd.vel, 0.1)
    _, v2 = pc.solve_kle(ew, pc.vel, 0.1)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-8)


def test_operator_errors_3d():
    """Weighted-L2 operator errors on TG3D (reference OperatorsTests,
    base_problem.py:318-340) stay small at ngl=5."""
    p = Problem(tg3_config(5), solver="direct")
    p.setUp()
    conv, diff, curl = p.operators_errors(0.5)
    assert conv < 1e-4
    assert diff < 1e-2
    assert curl < 1e-3


def test_transient_3d():
    """Short adaptive-RK free-slip-style 3D run stays finite."""
    p = Problem(tg3_config(4), solver="cg")
    p.setUp()
    p.start_solver(dt0=1e-4)
    assert np.isfinite(np.asarray(p.vort)).all()
    assert np.isfinite(np.asarray(p.vel)).all()


def test_cavity_3d_no_slip():
    """3D lid-driven cavity: two-stage NS solve runs and produces finite,
    nonzero flow under the moving lid."""
    p = Problem(cavity3_config(), solver="cg")
    p.setUp()
    p.start_solver(dt0=1e-4)
    vel = np.asarray(p.vel)
    assert np.isfinite(vel).all()
    assert np.abs(vel).max() > 1e-6
