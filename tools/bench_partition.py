"""Cross-shard migration benchmark on the 8-virtual-device CPU mesh.

Usage: python tools/bench_partition.py [n_side] [n_particles] [n_cycles]

Measures the spatially-partitioned engine (parallel/partition.py): a
circulating field drives particles through every slab boundary, so every
cycle migrates a steady fraction of the population over the all_to_all.
Reports particle-steps/s and migrations/s.  Virtual CPU devices share
ONE host core here, so absolute rates are a lower bound -- the collective
pattern, loss-freeness, and migration accounting are what this validates
(real interconnect rates need real devices; sizes above ~50k particles
can trip the cross-device rendezvous timeout on a 1-core host).

Measured (1-core host, 8 virtual devices, circulating field):
  10k particles x 150 cycles: ~250k steps/s, ~10k migrations/s,
  ~4% of the population migrating per cycle, 0 deferred, loss-free.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax



def main(n_side=12, n_particles=10000, n_cycles=150):
    from cudaparticlesfoam_tpu import (
        StepConfig, box_mesh, build_grid_locator, locate_seeds,
        replace_velocity, seed_in_box,
    )
    from cudaparticlesfoam_tpu.state import replace as rs
    from cudaparticlesfoam_tpu.parallel import partition, sharding

    S = 8
    mesh = box_mesh(n_side, n_side, n_side)
    pts = np.asarray(mesh.points, dtype=np.float64)
    cen = pts[np.asarray(mesh.tets)].mean(axis=1)
    r = cen[:, :2] - n_side / 2.0
    u = np.zeros_like(cen)
    u[:, 0] = -r[:, 1] * 0.35
    u[:, 1] = r[:, 0] * 0.35
    mesh = replace_velocity(mesh, tet_vel=u)
    loc = build_grid_locator(mesh)
    st = seed_in_box(
        n_particles, (0.5,) * 3, (n_side - 0.5,) * 3, method="threefry"
    )
    st = rs(st, tet_id=locate_seeds(mesh, loc, st.pos))

    cfg = StepConfig(dt=0.05, use_brownian=False, engine="simple")
    pm = partition.partition_mesh(mesh, S)
    dmesh = sharding.make_device_mesh(S, axis="s")
    sp = partition.distribute_particles(
        pm, st.pos, st.vel, st.tet_id, st.active, slack=4.0
    )
    pm, sp = partition.shard_arrays(pm, sp, dmesh)
    step = partition.make_partitioned_step(pm, cfg, dmesh)

    # warm up / compile
    sp, _ = step(pm, sp, 0.05)
    jax.block_until_ready(sp.pos)

    t0 = time.perf_counter()
    mig_dev = None
    for i in range(n_cycles):
        sp, mstats = step(pm, sp, 0.05)
        if mig_dev is None:
            mig_dev = (mstats["migrated"], mstats["deferred"])
        else:
            mig_dev = (
                mig_dev[0] + mstats["migrated"],
                mig_dev[1] + mstats["deferred"],
            )
        if i % 16 == 15:
            jax.block_until_ready(sp.pos)
    jax.block_until_ready(sp.pos)
    wall = time.perf_counter() - t0
    migrated, deferred = int(mig_dev[0]), int(mig_dev[1])
    resident = int(np.asarray(sp.resident).sum())
    assert resident == n_particles, f"lost particles: {resident}/{n_particles}"
    print(
        f"shards={S} particles={n_particles} cycles={n_cycles} "
        f"wall={wall:.2f}s"
    )
    print(
        f"steps/s={n_particles * n_cycles / wall:,.0f}  "
        f"migrations/s={migrated / wall:,.0f}  "
        f"migrated/cycle={migrated / n_cycles:.0f} "
        f"({migrated / n_cycles / n_particles * 100:.2f}% of pop)  "
        f"deferred={deferred}"
    )


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:4]]
    main(*args)
