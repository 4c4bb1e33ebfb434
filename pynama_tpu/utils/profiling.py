"""Profiling helpers: jax device traces + per-phase wall timers.

The reference's observability is a datetime Timer plus commented-out
line_profiler hooks (SURVEY §5); the equivalents here are XLA device
traces (viewable in TensorBoard / Perfetto) and phase timers that survive
jit (timing only dispatch boundaries).
"""
from __future__ import annotations

import contextlib
import logging
import subprocess
import time

logger = logging.getLogger("pynama_tpu.profiling")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax profiler trace into `log_dir` (TensorBoard format)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("device trace written to %s", log_dir)


def card_info() -> str | None:
    """The GPU's name and power limit as `nvidia-smi` reports them (one
    line per card), or None where there is no nvidia-smi. A card set below
    its maximum power runs slower under load, so every time measured on it
    is reported beside this line."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip()


class PhaseTimer:
    """Accumulating named phase timers (blocking: call around complete
    dispatch+sync regions, e.g. with jax.block_until_ready)."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{name:30s} {self.totals[name]*1e3:10.2f} ms "
                         f"x{self.counts[name]}")
        return "\n".join(lines)
