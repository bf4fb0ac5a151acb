"""Phase timing + profiler integration.

Makes real what the reference left commented out: the per-phase
performance report (``src/advect.H:186-203`` — BVH/Adv/Dfs/Qry/Rft/Mov/IO
table with fractions) and the cudaEvent timers (``cuda/cudaHelpers.cuh:44-87``).
The compute phases are fused into one program by design, so the
table reports the pipeline stages that remain observable (mesh build,
locator build, seeding, compute loop, I/O) plus optional deep op-level
traces via ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import time


class PhaseTimer:
    """Accumulating wall-clock phase timer with a reference-style report."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def add(self, name: str, seconds: float):
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, log=print, exclude_io: bool = True):
        """Print the fraction table (cf. the reference's intended report at
        ``advect.H:193-202``: 'IO is not included to compute time fraction')."""
        compute = {
            k: v for k, v in self.totals.items() if not (exclude_io and k == "IO")
        }
        total = sum(compute.values())
        log("\tItem\ttime(s)\tfraction(%)")
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            if exclude_io and name == "IO":
                continue
            frac = 100.0 * t / total if total > 0 else 0.0
            log(f"\t{name}\t{t:.2f}\t{frac:.2f}")
        if "IO" in self.totals:
            log(f"\tIO\t{self.totals['IO']:.2f}")
        log(f"\tTotal Time = {total*1e3:.2f} ms")
        return total


@contextlib.contextmanager
def device_trace(out_dir: str | None):
    """Optional jax.profiler trace around a region (op-level device times —
    the deep version of the reference's cudaTimer)."""
    if not out_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
