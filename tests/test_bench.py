"""bench.py must ALWAYS produce the JSON line.

One failing section must not lose the numbers already measured. This
runs the real bench end-to-end (small config, CPU) and asserts the
contract: rc 0, one parseable JSON line on stdout, required fields
populated, the device named, no ratio to an assumed peak, no section
errors.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_small_emits_json_line():
    env = dict(os.environ)
    env.update(PYNAMA_BENCH="small", PYNAMA_BENCH_BUDGET="300",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       env=env, capture_output=True, text=True,
                       timeout=540, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.strip().splitlines() if ln.strip()]
    assert lines, r.stderr[-2000:]
    doc = json.loads(lines[-1])
    assert doc["metric"] == "spmv_effective_gnnz_per_s"
    assert doc["value"] > 0
    assert doc["vs_baseline"] is None
    d = doc["detail"]
    assert d["device"]["platform"] == "cpu" and d["device"]["count"] >= 1
    for gone in ("mfu", "fused", "k_apply_fused_ms", "fused_speedup",
                 "fused_blocks", "csr_speed_of_light_gnnz_per_s"):
        assert gone not in d, gone
    assert d["errors"] == [], d["errors"]
    for key in ("kle_solve_ms", "kle_cold_jacobi_ms", "rhs_eval_ms",
                "k_apply_ms", "setup_s"):
        assert d[key] is not None and d[key] > 0, key
    assert d["setup_phases_s"]
