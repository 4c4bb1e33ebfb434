"""CLI driver smoke tests (the reference's run_case entry,
src/run_case.py:164-187): case loading, run modes, checkpoint round trip."""
import os

import numpy as np
import pytest

from pynama_tpu import run_case


def tg_args(tmp_path, extra):
    return ["-case", "taylor-green", "-log", "WARNING",
            "-nelem", "4", "4", "-ngl", "4"] + extra


def test_kle_mode(tmp_path, capsys):
    run_case.main(["-case", "taylor-green", "-test", "kle",
                   "-log", "WARNING", "-nelem", "4", "4", "-ngl", "4",
                   "-solver", "direct"])


def test_production_run_and_checkpoint(tmp_path):
    ck = str(tmp_path / "state.h5")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        run_case.main(["-case", "taylor-green", "-log", "WARNING",
                       "-nelem", "3", "3", "-ngl", "3",
                       "-solver", "direct", "-checkpoint", ck])
        assert os.path.exists(ck)
        # resume restarts from the written state
        run_case.main(["-case", "taylor-green", "-log", "WARNING",
                       "-nelem", "3", "3", "-ngl", "3",
                       "-solver", "direct", "-resume", ck])
    finally:
        os.chdir(cwd)


def test_unknown_case_raises():
    with pytest.raises(FileNotFoundError):
        run_case.load_case("no-such-case-xyz")


def test_case_library_loads():
    for name in ("taylor-green", "cavity-2d", "uniform", "ibm-static",
                 "senoidal", "flat-plate", "taylor-green3d"):
        cfg = run_case.load_case(name)
        assert "boundary-conditions" in cfg or "bodies" in cfg


def test_ndev_production_run(tmp_path):
    """-ndev N runs the sharded transient end-to-end (mpiexec -n analog)."""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        run_case.main(["-case", "cavity-2d", "-log", "WARNING",
                       "-nelem", "8", "4", "-ngl", "3", "-solver", "cg",
                       "-ndev", "4", "-rtol", "1e-3", "-atol", "1e-3",
                       "-dt0", "1e-3"])
    finally:
        os.chdir(cwd)


def test_solver_tuning_flags(tmp_path):
    """-cg-rtol/-maxiter/-tableau change solver behavior from the CLI
    (the reference's -ksp_*/-ts_* setFromOptions analog)."""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        run_case.main(["-case", "taylor-green", "-log", "WARNING",
                       "-nelem", "3", "3", "-ngl", "3", "-solver", "cg",
                       "-cg-rtol", "1e-8", "-maxiter", "500",
                       "-tableau", "5dp", "-pc", "jacobi"])
        with pytest.raises(SystemExit):
            run_case.main(["-case", "taylor-green", "-tableau", "bogus"])
    finally:
        os.chdir(cwd)


def test_fast_io_production_run(tmp_path):
    """-fast-io: per-step saves go through the native async binary writer
    and ParaView HDF5/XDMF output is produced by post-hoc conversion."""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        run_case.main(["-case", "taylor-green", "-log", "WARNING",
                       "-nelem", "3", "3", "-ngl", "3",
                       "-solver", "cg", "-fast-io"])
        # binary snapshots + manifest
        fast = next(tmp_path.glob("*-fast"))
        assert (fast / "manifest.json").exists()
        assert any(f.suffix == ".bin" for f in fast.iterdir())
        # converted ParaView layout still opens
        import h5py
        out = next(d for d in tmp_path.iterdir()
                   if d.is_dir() and not d.name.endswith("-fast"))
        snaps = sorted(out.glob("vec-data-*.h5"))
        assert snaps
        with h5py.File(snaps[0]) as f:
            assert "fields" in f
        assert any(f.suffix == ".xmf" for f in out.iterdir())
    finally:
        os.chdir(cwd)


def test_engine_flags(tmp_path):
    """-sumfact and the solver knobs reach the engine through the CLI's
    override mapping."""
    from pynama_tpu import run_case as rc
    cfg = rc.load_case("cavity-2d")

    # go through _overrides directly (a production run is exercised by
    # test_ndev_production_run; here we assert the kwarg wiring)
    import argparse
    ns = argparse.Namespace(sumfact="off", ngl=3, nelem=[4, 4],
                            solver="cg", cg_rtol=1e-9, cg_atol=None,
                            maxiter=321, pc="jacobi", ndev=None)
    kw = rc._overrides(ns)
    assert kw["sumfact"] is False
    assert kw["cg_rtol"] == 1e-9 and kw["cg_maxiter"] == 321

    p = rc.make_problem(cfg, **kw)
    p.setUp()
    ops = p.engine_ops
    assert ops is not None and ops.sumfact is None
    assert ops.cg_rtol == 1e-9 and ops.cg_maxiter == 321
    assert ops.pc == "jacobi"

    ns.sumfact = "on"
    assert rc._overrides(ns)["sumfact"] is True
