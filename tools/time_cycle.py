"""End-to-end cycle timing on the headline bench workload (no profiler).

Usage: python tools/time_cycle.py [n_side] [n_particles] [n_cycles]

Prints ms/cycle (best of 3 windows, each ending in block_until_ready) for
the current engine source — the edit-compile-measure loop for fused.py
experiments.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from profile_cycle import build

    from cudaparticlesfoam_tpu import StepConfig, run_cycles
    from cudaparticlesfoam_tpu.stepper import suggest_tuning

    n_side = int(sys.argv[1]) if len(sys.argv) > 1 else 55
    n_particles = int(float(sys.argv[2])) if len(sys.argv) > 2 else 1_000_000
    n_cycles = int(sys.argv[3]) if len(sys.argv) > 3 else 200

    mesh, st = build(n_side, n_particles)
    cfg = suggest_tuning(
        mesh, StepConfig(dt=0.05, diffusion_coeff=1e-3, brownian_rng="rbg"),
        0.05, n_particles=n_particles,
    )
    print(
        f"tuned: inline_hops={cfg.inline_hops} "
        f"walk_capacity_frac={cfg.walk_capacity_frac} "
        f"cycle_chunks={cfg.cycle_chunks}", file=sys.stderr,
    )
    t0 = time.perf_counter()
    out = run_cycles(mesh, st, cfg, n_cycles)
    jax.block_until_ready(out.pos)
    print(f"compile+first: {time.perf_counter()-t0:.1f}s", file=sys.stderr)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = run_cycles(mesh, st, cfg, n_cycles)
        jax.block_until_ready(out.pos)
        best = min(best, time.perf_counter() - t0)
    ms = best / n_cycles * 1e3
    act = int(np.asarray(out.active).sum())
    ood = int((np.asarray(out.tet_id) < 0).sum())
    print(
        f"{ms:.2f} ms/cycle  {n_particles*n_cycles/best/1e6:.1f}M steps/s  "
        f"active={act} out={ood}"
    )


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
