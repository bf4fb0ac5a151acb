"""A/B sweep of the PARTITIONED cycle on one GPU.

Usage: python tools/sweep_partition_chip.py [n_side] [n_particles] \
        [n_cycles] "slack=1.25" "slack=2.0,cap_out_frac=0.125" ...

Builds the headline-bench vortex workload ONCE (the host build and
upload dominate wall time), then times each named config through
``make_partitioned_runner`` (one dispatch per timed batch).  Entries may
set ``slack`` / ``cap_out_frac`` plus any StepConfig field.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_cycle import build  # noqa: E402


def main():
    import dataclasses

    import jax
    import numpy as np

    from cudaparticlesfoam_tpu import StepConfig
    from cudaparticlesfoam_tpu.parallel import partition, sharding

    n_side = int(sys.argv[1]) if len(sys.argv) > 1 else 55
    n_particles = int(float(sys.argv[2])) if len(sys.argv) > 2 else 1_000_000
    n_cycles = int(sys.argv[3]) if len(sys.argv) > 3 else 20
    specs = sys.argv[4:] or ["slack=2.0"]

    t0 = time.perf_counter()
    mesh, st = build(n_side, n_particles)
    print(f"build {time.perf_counter()-t0:.1f}s; {mesh.n_tets} tets",
          flush=True)
    pm0 = partition.partition_mesh(mesh, 1)
    dmesh = sharding.make_device_mesh(1, axis="s")

    for spec in specs:
        cfg = StepConfig(dt=0.05, diffusion_coeff=1e-3)
        slack, cof = 2.0, 0.25
        for kv in spec.split(","):
            if "=" not in kv:
                continue
            k, v = kv.split("=", 1)
            if k == "slack":
                slack = float(v)
                continue
            if k == "cap_out_frac":
                cof = float(v)
                continue
            cur = getattr(cfg, k)
            if isinstance(cur, bool):
                v = v.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                v = int(v)
            elif isinstance(cur, float):
                v = float(v)
            cfg = dataclasses.replace(cfg, **{k: v})
        sp = partition.distribute_particles(
            pm0, st.pos, st.vel, st.tet_id, st.active, slack=slack
        )
        pm, sp = partition.shard_arrays(pm0, sp, dmesh)
        run = partition.make_partitioned_runner(
            pm, cfg, dmesh, n_cycles, cap_out_frac=cof
        )
        t0 = time.perf_counter()
        sp, _ = run(pm, sp, cfg.dt)
        jax.block_until_ready(sp.pos)
        tc = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            sp, _ = run(pm, sp, cfg.dt)
            jax.block_until_ready(sp.pos)
            best = min(best, time.perf_counter() - t0)
        print(
            f"[{spec}] capacity={sp.pos.shape[1]} compile {tc:.1f}s; "
            f"best {best*1e3:.0f} ms / {n_cycles} cycles = "
            f"{best/n_cycles*1e3:.1f} ms/cycle "
            f"({n_particles*n_cycles/best/1e6:.1f}M steps/s)",
            flush=True,
        )


if __name__ == "__main__":
    main()
