"""chip_smoke.py: its phases at tiny sizes here (float64, CPU), its refusal
to run without a GPU, and its phases at full width on a GPU (`-m gpu`)."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _env(**extra):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_refuses_without_gpu():
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=_env(JAX_PLATFORMS="cpu"), capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_transient_tiny():
    out = cs.phase_transient((3, 3, 3), 3, max_steps=3, cg_rtol=1e-10,
                             split=False)
    assert out["accepted_steps"] == 3 and out["step_s"] > 0
    assert out["apply_error"] < 1e-12
    assert out["solve_residual"] < 1e-8
    assert set(out["setup_phases_s"]) >= {"mesh", "engine"}


def test_phase_taylor_green_tiny():
    out = cs.phase_taylor_green(ngl=4, nelem=4, t_end=0.05, cg_rtol=1e-10)
    assert out["vorticity_rel_l2"] < cs.TG_TOL


def test_phase_apply_solve_tiny():
    """The K apply against the float64 host reference, and the solve's
    host residual, at ngl=5; the reference itself is checked by feeding
    it a wrong operator."""
    import dataclasses
    from pynama_tpu.cases import Problem
    out = cs.phase_apply_solve((2, 2, 2), 5, cg_rtol=1e-10, split=False)
    assert out["apply_error"] < 1e-12
    assert out["solve_residual"] < 1e-8

    p = Problem(cs.cavity_config((2, 1, 1), 3), solver="cg")
    p.setUp()
    p._em = dataclasses.replace(p._em, K=p._em.K * (1 + 1e-4))
    with pytest.raises(AssertionError, match="K apply error"):
        cs.check_apply(p)


def test_imports_without_optional_packages():
    """chip_smoke and a Problem build need none of PyYAML, h5py and
    matplotlib, which the GPU machine need not have."""
    code = (
        "import sys\n"
        "for m in ('yaml', 'h5py', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import chip_smoke as cs\n"
        "from pynama_tpu.cases import Problem\n"
        "import pynama_tpu.engine, pynama_tpu.io, pynama_tpu.parallel\n"
        "p = Problem(cs.cavity_config((2, 2, 2), 3), solver='cg')\n"
        "p.setUp()\n"
        "assert p.engine_ops is not None\n"
        "print('built')\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "built" in r.stdout


# ------------------------------------------------------- card-only tests
@pytest.fixture
def gpu():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with `python -m pytest -m gpu`)")


@pytest.mark.gpu
def test_flagship_transient_gpu(gpu):
    out = cs.phase_transient()
    assert out["accepted_steps"] >= 3


@pytest.mark.gpu
def test_taylor_green_gpu(gpu):
    assert cs.phase_taylor_green()["vorticity_rel_l2"] <= cs.TG_TOL


@pytest.mark.gpu
def test_high_order_gpu(gpu):
    assert cs.phase_apply_solve()["apply_error"] <= cs.APPLY_TOL
