"""Device-side op profile of the PARTITIONED cycle on one GPU.

Usage: python tools/profile_partition_chip.py [n_side] [n_particles] \
        [n_cycles] [slack] [extra cfg k=v ...]

Builds the headline-bench vortex workload, partitions it over a 1-device
mesh (S=1: every lane is local, migration is a no-op semantically but its
ops still run), and prints the top device ops of a warmed-up run — the
apples-to-apples overhead picture vs tools/profile_cycle.py.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_cycle import build, parse_trace  # noqa: E402


def main():
    import dataclasses

    import jax
    import numpy as np

    from cudaparticlesfoam_tpu import StepConfig
    from cudaparticlesfoam_tpu.parallel import partition, sharding

    n_side = int(sys.argv[1]) if len(sys.argv) > 1 else 55
    n_particles = int(float(sys.argv[2])) if len(sys.argv) > 2 else 1_000_000
    n_cycles = int(sys.argv[3]) if len(sys.argv) > 3 else 20
    slack = float(sys.argv[4]) if len(sys.argv) > 4 else 2.0

    t0 = time.perf_counter()
    mesh, st = build(n_side, n_particles)
    print(f"build {time.perf_counter()-t0:.1f}s; {mesh.n_tets} tets",
          file=sys.stderr)
    cfg = StepConfig(dt=0.05, diffusion_coeff=1e-3)
    for kv in sys.argv[5:]:
        if "=" not in kv:
            continue
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        cfg = dataclasses.replace(cfg, **{k: v})

    S = 1
    pm = partition.partition_mesh(mesh, S)
    dmesh = sharding.make_device_mesh(S, axis="s")
    sp = partition.distribute_particles(
        pm, st.pos, st.vel, st.tet_id, st.active, slack=slack
    )
    pm, sp = partition.shard_arrays(pm, sp, dmesh)
    step = partition.make_partitioned_step(pm, cfg, dmesh)
    print(f"capacity/shard = {sp.pos.shape[1]}", file=sys.stderr)

    run = partition.make_partitioned_runner(pm, cfg, dmesh, n_cycles)
    t0 = time.perf_counter()
    sp, _ = step(pm, sp, cfg.dt)
    jax.block_until_ready(sp.pos)
    print(f"compile+first {time.perf_counter()-t0:.1f}s", file=sys.stderr)
    t0 = time.perf_counter()
    sp, _ = run(pm, sp, cfg.dt)
    jax.block_until_ready(sp.pos)
    print(f"runner compile+first {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)

    tdir = tempfile.mkdtemp(prefix="jxtrace_part_")
    jax.profiler.start_trace(tdir)
    t0 = time.perf_counter()
    sp, _ = run(pm, sp, cfg.dt)
    jax.block_until_ready(sp.pos)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    print(f"timed: {wall*1e3:.0f} ms wall / {n_cycles} cycles "
          f"({n_particles*n_cycles/wall/1e6:.1f}M steps/s; "
          f"{wall/n_cycles*1e3:.1f} ms/cycle)", file=sys.stderr)
    parse_trace(tdir)


if __name__ == "__main__":
    main()
