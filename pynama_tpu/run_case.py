"""CLI driver (reference `src/run_case.py:164-189`).

Run modes (the reference's `-test` option, run_case.py:177-184):
    (none)     production run: time-integrate and dump HDF5/XDMF per step
    kle        single KLE solve against exact fields, dump for ParaView
    chart      KLE p-convergence sweep (error vs ngl, loglog chart)
    operators  operator-accuracy sweep (convective/diffusive/curl errors)
    chartkle   KLE error chart for one ngl over viscous times

Usage:
    python -m pynama_tpu.run_case -case taylor-green [-test chart] [-log INFO]
    python -m pynama_tpu.run_case -case path/to/case.yaml

Accepts the reference's single-dash flags; case names resolve against
`pynama_tpu/cases/yaml/` or a filesystem path.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

logger = logging.getLogger("pynama_tpu.run_case")

CASE_DIR = os.path.join(os.path.dirname(__file__), "cases", "yaml")


def load_case(name: str) -> dict:
    import yaml
    for cand in (name, f"{name}.yaml",
                 os.path.join(CASE_DIR, f"{name}.yaml"),
                 os.path.join(CASE_DIR, name)):
        if os.path.isfile(cand):
            with open(cand) as f:
                return yaml.safe_load(f)
    raise FileNotFoundError(
        f"case '{name}' not found (searched {CASE_DIR} and cwd)")


def make_problem(cfg: dict, **kw):
    from pynama_tpu.cases import Problem
    from pynama_tpu.cases.ibm import (ImmersedBoundaryStatic,
                                      ImmersedBoundaryDynamic)
    if "bodies" in cfg:
        dyn = any(b.get("vel") == "dynamic" for b in cfg["bodies"])
        cls = ImmersedBoundaryDynamic if dyn else ImmersedBoundaryStatic
    else:
        cls = Problem
    return cls(cfg, **kw)


def time_solving(cfg: dict, args):
    """Production run (reference timeSolving, run_case.py:152-162)."""
    from pynama_tpu.utils import Timer
    timer = Timer()
    timer.tic()
    p = make_problem(cfg, **_overrides(args))
    p.setUp()
    p.setup_viewer()
    if args.resume:
        from pynama_tpu.io import load_checkpoint
        ck = load_checkpoint(args.resume)
        p.vort = np.asarray(ck["vorticity"])
        p.vel = np.asarray(ck["velocity"])
        p.start_time = ck["t"]
        logger.info("resumed from %s at t=%g step=%d", args.resume,
                    ck["t"], ck["step"])
    ts_kw = {}
    if args.rtol is not None:
        ts_kw["rtol"] = args.rtol
    if args.atol is not None:
        ts_kw["atol"] = args.atol
    if args.dt0 is not None:
        ts_kw["dt0"] = args.dt0
    if args.tableau is not None:
        ts_kw["tableau"] = args.tableau
    t, steps = p.run(log_diagnostics=args.diag, fast_io=args.fast_io,
                     **ts_kw)
    logger.info("Total time: %.3fs (%d steps to t=%g)", timer.toc(), steps, t)
    if args.checkpoint:
        from pynama_tpu.io import save_checkpoint
        save_checkpoint(args.checkpoint, np.asarray(p.vort),
                        np.asarray(p.vel), t, 0.0, steps, cfg)
        logger.info("checkpoint written to %s", args.checkpoint)


def generate_chart(cfg: dict, args):
    """KLE p-convergence sweep (reference generateChart,
    run_case.py:31-77): error vs N* for each viscous time."""
    from pynama_tpu.io.plotter import ErrorPlotter
    viscous_times = [0.001, 0.01, 0.1, 1]
    ngls = list(range(3, args.max_ngl + 1))
    errors = {tau: [] for tau in viscous_times}
    for ngl in ngls:
        p = make_problem(cfg, ngl=ngl, **_overrides(args, skip_ngl=True))
        p.setUp()
        errs = p.kle_errors(viscous_times)
        for tau, e in zip(viscous_times, errs):
            errors[tau].append(e)
        logger.info("ngl=%d errors=%s", ngl, errs)
    name = cfg.get("name", "case")
    ErrorPlotter().plot_convergence(ngls, errors, f"test-kle-{name}.png")
    _dump_yaml(f"out-kle-chart-{name}.yaml",
               {"ngls": ngls,
                "errors": {str(k): [float(x) for x in v]
                           for k, v in errors.items()}})


def generate_chart_operators(cfg: dict, args):
    """Operator convergence sweep (reference generateChartOperators,
    run_case.py:80-131)."""
    from pynama_tpu.io.plotter import Plotter
    ngls = list(range(3, args.max_ngl + 1))
    conv, diff, curl = [], [], []
    for ngl in ngls:
        p = make_problem(cfg, ngl=ngl, **_overrides(args, skip_ngl=True))
        p.setUp()
        ec, ed, ecu = p.operators_errors()
        conv.append(ec)
        diff.append(ed)
        curl.append(ecu)
        logger.info("ngl=%d conv=%.3e diff=%.3e curl=%.3e", ngl, ec, ed, ecu)
    name = cfg.get("name", "case")
    x = 2 * (np.asarray(ngls) - 1)
    Plotter().plot({"convective": (x, conv), "diffusive": (x, diff),
                    "curl": (x, curl)},
                   f"test-operators-{name}.png", xlabel="N* = 2(ngl-1)",
                   ylabel="weighted L2 error", loglog=True)
    _dump_yaml(f"out-operators-test-{name}.yaml",
               {"ngl": ngls, "convective": [float(x) for x in conv],
                "diffusive": [float(x) for x in diff],
                "curl": [float(x) for x in curl]})


def solve_kle_test(cfg: dict, args):
    """Single KLE solve vs exact fields + ParaView dump (reference
    solveKLETests, base_problem.py:266-287)."""
    p = make_problem(cfg, **_overrides(args))
    p.setUp()
    p.setup_viewer()
    time = p.start_time
    exact_vel, exact_vort = p.exact_fields(time)
    vort, vel = p.solve_kle(exact_vort, p.vel, time)
    err = np.asarray(exact_vel) - np.asarray(vel)
    logger.info("KLE |error| = %.3e", np.linalg.norm(err))
    p.viewer.save_data(0, time, velocity=np.asarray(vel),
                       vorticity=np.asarray(vort), error=err,
                       exact_velocity=np.asarray(exact_vel))
    p.viewer.write_xmf(p.case_name)


def generate_chart_kle(cfg: dict, args):
    """KLE error over viscous times at the case ngl (reference
    generateChartKLE, run_case.py:139-149)."""
    p = make_problem(cfg, **_overrides(args))
    p.setUp()
    taus = [0.001, 0.01, 0.1, 0.5, 1]
    errs = p.kle_errors(taus)
    for tau, e in zip(taus, errs):
        logger.info("tau=%g -> |err| %.3e", tau, e)
    _dump_yaml(f"out-kle-{cfg.get('name', 'case')}.yaml",
               {"tau": taus, "error": [float(e) for e in errs]})


def _dump_yaml(path, data):
    import yaml
    with open(path, "w") as f:
        yaml.dump(data, f)
    logger.info("wrote %s", path)


def _overrides(args, skip_ngl=False):
    """Problem kwargs from CLI args; robust to partially-populated
    Namespace objects (programmatic callers)."""
    get = lambda name: getattr(args, name, None)
    kw = {}
    if get("ngl") and not skip_ngl:
        kw["ngl"] = args.ngl
    if get("nelem"):
        kw["nelem"] = args.nelem
    if get("solver"):
        kw["solver"] = args.solver
    # solver tuning (the reference forwards any -ksp_* flag into
    # KSP.setFromOptions, kle_solver.py:62; these are its analogs)
    if get("cg_rtol") is not None:
        kw["cg_rtol"] = args.cg_rtol
    if get("cg_atol") is not None:
        kw["cg_atol"] = args.cg_atol
    if get("maxiter") is not None:
        kw["cg_maxiter"] = args.maxiter
    if get("pc") is not None:
        kw["pc"] = args.pc
    if get("ndev"):
        kw["ndev"] = args.ndev
    # engine toggles (Options-DB parity: every solver knob CLI-reachable)
    if get("sumfact") is not None:
        kw["sumfact"] = {"on": True, "off": False}[args.sumfact]
    return kw


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pynama_tpu.run_case", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    # single-dash long flags, PETSc-Options style (reference run_case.py:9-13)
    ap.add_argument("-case", required=True, help="case name or yaml path")
    ap.add_argument("-test", default=None,
                    choices=["kle", "chart", "operators", "chartkle"])
    ap.add_argument("-log", default="INFO", help="logging level")
    ap.add_argument("-ngl", type=int, default=None)
    ap.add_argument("-nelem", type=int, nargs="+", default=None)
    ap.add_argument("-solver", default=None,
                    choices=["cg", "gmres", "direct", "auto"])
    ap.add_argument("-ndev", type=int, default=None,
                    help="run the transient sharded over N devices "
                         "(the reference's mpiexec -n N analog)")
    # KLE (KSP) solver tuning — the reference's -ksp_* passthrough analog
    ap.add_argument("-cg-rtol", dest="cg_rtol", type=float, default=None,
                    help="KLE Krylov relative tolerance")
    ap.add_argument("-cg-atol", dest="cg_atol", type=float, default=None,
                    help="KLE Krylov absolute tolerance")
    ap.add_argument("-maxiter", type=int, default=None,
                    help="KLE Krylov max iterations")
    ap.add_argument("-pc", default=None, choices=["jacobi", "schwarz", "fdm"],
                    help="KLE preconditioner")
    ap.add_argument("-sumfact", default=None, choices=["on", "off"],
                    help="sum-factorized K on unstructured meshes "
                         "(default: on)")
    # TS tuning — the reference's -ts_* passthrough analog
    ap.add_argument("-rtol", type=float, default=None,
                    help="adaptive-RK relative tolerance")
    ap.add_argument("-atol", type=float, default=None,
                    help="adaptive-RK absolute tolerance")
    ap.add_argument("-dt0", type=float, default=None,
                    help="initial timestep")
    ap.add_argument("-tableau", default=None, choices=["5bs", "5dp"],
                    help="embedded RK pair")
    ap.add_argument("-trace", default=None, metavar="DIR",
                    help="capture a jax device trace into DIR")
    ap.add_argument("-diag", action="store_true",
                    help="log KE/enstrophy/divergence each saved step")
    ap.add_argument("-fast-io", dest="fast_io", action="store_true",
                    help="save steps via the async binary writer; convert "
                         "to HDF5/XDMF after the run")
    ap.add_argument("-max-ngl", dest="max_ngl", type=int, default=10)
    ap.add_argument("-checkpoint", default=None,
                    help="write final state to this HDF5 file")
    ap.add_argument("-resume", default=None,
                    help="resume from a checkpoint HDF5 file")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=getattr(logging, args.log.upper(), logging.INFO),
        format="%(levelname)s %(name)s: %(message)s")
    from pynama_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    cfg = load_case(args.case)

    mode = {
        None: time_solving,
        "kle": solve_kle_test,
        "chart": generate_chart,
        "operators": generate_chart_operators,
        "chartkle": generate_chart_kle,
    }[args.test]
    if args.trace:
        from pynama_tpu.utils.profiling import device_trace
        with device_trace(args.trace):
            mode(cfg, args)
    else:
        mode(cfg, args)


if __name__ == "__main__":
    main()
