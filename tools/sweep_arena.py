"""Sweep rare-arena capacity knobs at the headline bench config.

Usage: python tools/sweep_arena.py [n_side n_particles n_cycles]

The profiler shows ~4 rare-arena rounds/cycle at the tuned
walk_capacity_frac=0.0625 (x79 while-body ops over 20 cycles) — both the
block cap (capb) and the lane cap (cap_l) bind when pending lanes run
3-6% of the batch.  This sweeps (walk_capacity_frac, arena_lane_frac)
pairs with the bench's rbg noise to find the round-count / round-cost
optimum.
"""

import dataclasses
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
    base = suggest_tuning(
        mesh,
        StepConfig(dt=0.05, diffusion_coeff=1e-3, brownian_rng="rbg"),
        0.05, n_particles=n_particles,
    )
    print(
        f"tuned base: hops={base.inline_hops} frac={base.walk_capacity_frac} "
        f"alf={base.arena_lane_frac} chunks={base.cycle_chunks}",
        flush=True,
    )

    combos = [
        (base.walk_capacity_frac, base.arena_lane_frac),
        (0.125, 0.25),
        (0.25, 0.25),
        (0.25, 0.125),
        (0.375, 0.125),
        (0.125, 0.5),
    ]
    for frac, alf in combos:
        cfg = dataclasses.replace(
            base, walk_capacity_frac=frac, arena_lane_frac=alf
        )
        t0 = time.perf_counter()
        out = run_cycles(mesh, st, cfg, n_cycles)
        jax.block_until_ready(out.pos)
        comp = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = run_cycles(mesh, st, cfg, n_cycles)
            jax.block_until_ready(out.pos)
            best = min(best, time.perf_counter() - t0)
        ms = best / n_cycles * 1e3
        print(
            f"frac={frac:<6} alf={alf:<6} {ms:6.2f} ms/cycle "
            f"{n_particles * n_cycles / best / 1e6:6.1f}M steps/s "
            f"(compile+first {comp:.0f}s)",
            flush=True,
        )


if __name__ == "__main__":
    main()
