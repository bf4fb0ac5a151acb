"""Headline benchmark: particle-steps/sec on one GPU.

Two workloads (both full physics per sub-step: advect + Brownian +
tet-walk relocation + specular wall reflection + move; float32; no I/O
in the timed region):

1. north-star config (BASELINE.md): ~1M-tet mesh (55^3 hexes x 6 tets,
   the reference's own box fixture geometry, ``HostTetMesh.h:62-144``),
   1M particles, dt at a few % of a cell per sub-step.
2. tutorial-scale config: ~147k tets / 1e5 particles / ~1 cell crossed
   per sub-step — the regime of the reference's own pitzDaily case
   (``pitzDaily/system/cudaParticlesDict:23-29``), which is the
   worst case for a compaction engine (small batch, high crossing).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} where
value is config 1's throughput and vs_baseline is its ratio to
BASELINE.json's reference rate of 1e8 particle-steps/s (the reference
repo publishes no numbers of its own); the other cells ride along under
their own keys.  Exits non-zero when JAX finds no GPU: a CPU run is not
a measurement of this program.
"""

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_workload(n_side, n_particles, diffusion=1e-3):
    from cudaparticlesfoam_tpu import (
        box_mesh,
        build_grid_locator,
        locate_seeds,
        replace_velocity,
        seed_in_box,
    )
    from cudaparticlesfoam_tpu.state import replace as replace_state

    t0 = time.perf_counter()
    mesh = box_mesh(n_side, n_side, n_side)
    # recirculating CONFINED vortex: tangential speed ~ r(1-(r/R)^2),
    # zero at the walls — particles cross cells continuously but are not
    # advected into the boundary (round-1's plain solid rotation swept
    # every particle beyond the inscribed radius into the flat walls,
    # growing a wall-grinding population that benchmarked the reflection
    # path instead of advection; Brownian wall contact remains)
    from cudaparticlesfoam_tpu.mesh import host_np

    cen = host_np(mesh, "points", np.float64)[host_np(mesh, "tets")].mean(axis=1)
    r = cen[:, :2] - n_side / 2.0
    r2 = (r * r).sum(axis=1) / (n_side / 2.0) ** 2
    omega = (5.2 / n_side) * np.maximum(1.0 - r2, 0.0)
    u = np.zeros_like(cen)
    u[:, 0] = -r[:, 1] * omega
    u[:, 1] = r[:, 0] * omega
    mesh = replace_velocity(mesh, tet_vel=u)
    log(f"mesh: {mesh.n_tets} tets ({time.perf_counter()-t0:.1f}s build)")
    loc = build_grid_locator(mesh)
    lo, hi = 0.05 * n_side, 0.95 * n_side
    st = seed_in_box(n_particles, (lo,) * 3, (hi,) * 3, method="threefry")
    tet = locate_seeds(mesh, loc, st.pos)
    st = replace_state(st, tet_id=tet)
    import jax.numpy as jnp

    log(f"seeded {n_particles} particles, "
        f"{int(jnp.sum(tet < 0))} out of domain")
    return mesh, st


def build_unstructured_workload(n_side, n_particles, diffusion=1e-3,
                                jitter=0.18, seed=11):
    """BASELINE config-4 representative: IRREGULAR tetrahedra (interior
    vertices jittered by ``jitter`` of the spacing — non-uniform shapes,
    volumes, and face orientations; topology intact) with an absorbing
    outflow patch at +x (escape faces ON, exercising the outflow path)
    and the confined vortex so the bulk recirculates while Brownian
    contact feeds a realistic trickle of escapes.

    Built HOST-SIDE in one pass (no device refresh of the jittered
    geometry), with the outflow patch tagged before the single upload so
    the mesh keeps its host mirror."""
    import jax.numpy as jnp

    from cudaparticlesfoam_tpu import (
        build_grid_locator, locate_seeds, seed_in_box,
    )
    from cudaparticlesfoam_tpu.mesh import (
        box_points_tets, from_arrays_host, host_to_device,
        set_boundary_escape,
    )
    from cudaparticlesfoam_tpu.state import replace as replace_state

    t0 = time.perf_counter()
    pts, tets, _ = box_points_tets(n_side, n_side, n_side)
    # the confined vortex of build_workload, from PRE-jitter centroids
    cen = pts[tets].mean(axis=1)
    r = cen[:, :2] - n_side / 2.0
    r2 = (r * r).sum(axis=1) / (n_side / 2.0) ** 2
    omega = (5.2 / n_side) * np.maximum(1.0 - r2, 0.0)
    u = np.zeros_like(cen)
    u[:, 0] = -r[:, 1] * omega
    u[:, 1] = r[:, 0] * omega
    rng = np.random.default_rng(seed)
    inner = np.all((pts > 1e-9) & (pts < n_side - 1e-9), axis=1)
    jit = np.where(
        inner[:, None], rng.uniform(-jitter, jitter, pts.shape), 0.0
    )
    host = from_arrays_host(pts + jit, tets, tet_vel=u)
    # +x boundary faces become an absorbing outflow patch (classified on
    # the PRE-jitter points — boundary vertices are pinned)
    ctr = pts[host["bd_tris"]].mean(axis=1)
    host["bd_patch"] = (ctr[:, 0] > n_side - 1e-6).astype(np.int32)
    mesh = host_to_device(host)
    log(f"mesh: {mesh.n_tets} jittered tets "
        f"({time.perf_counter()-t0:.1f}s host build)")
    mesh = set_boundary_escape(mesh, [1])
    loc = build_grid_locator(mesh)
    lo, hi = 0.05 * n_side, 0.95 * n_side
    st = seed_in_box(n_particles, (lo,) * 3, (hi,) * 3, method="threefry")
    st = replace_state(st, tet_id=locate_seeds(mesh, loc, st.pos))
    log(f"seeded {n_particles} particles, "
        f"{int(jnp.sum(st.tet_id < 0))} out of domain")
    return mesh, st


def run_config_injected(name, mesh, st, n_particles, dt, n_cycles,
                        burst_every, burst_count, box_lo, box_hi,
                        diffusion=1e-3):
    """BASELINE config-4 timed loop: fused cycles with PERIODIC in-loop
    particle injection (state.inject_device — fully device-side, zero
    readbacks) refilling slots freed by the absorbing outflow patch.
    Wall time covers cycles + injections."""
    import jax

    from cudaparticlesfoam_tpu import StepConfig, run_cycles
    from cudaparticlesfoam_tpu import build_grid_locator
    from cudaparticlesfoam_tpu.state import inject_device
    from cudaparticlesfoam_tpu.stepper import suggest_tuning

    loc = build_grid_locator(mesh)
    cfg = suggest_tuning(
        mesh, StepConfig(dt=dt, diffusion_coeff=diffusion,
                         brownian_rng="rbg", escape_faces=True),
        dt, n_particles=n_particles,
    )
    log(f"[{name}] tuned: inline_hops={cfg.inline_hops} "
        f"chunks={cfg.cycle_chunks}")

    def one_pass(sst, salt):
        for j in range(n_cycles // burst_every):
            sst = run_cycles(mesh, sst, cfg, burst_every)
            sst = inject_device(
                sst, mesh, loc, box_lo, box_hi, burst_count,
                rng_seed=salt * 997 + j,
            )
        return sst

    t0 = time.perf_counter()
    sst = one_pass(st, 0)
    jax.block_until_ready(sst.pos)
    log(f"[{name}] compile+first batch: {time.perf_counter()-t0:.1f}s")
    dt_wall = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        sst = one_pass(sst, 1 + rep)
        jax.block_until_ready(sst.pos)
        dt_wall = min(dt_wall, time.perf_counter() - t0)
    steps_per_sec = n_particles * n_cycles / dt_wall
    import jax.numpy as jnp

    act = int(jnp.sum(sst.active.astype(jnp.int32)))
    log(f"[{name}] {n_cycles} cycles + {n_cycles//burst_every} injections "
        f"in {dt_wall:.2f}s -> {steps_per_sec/1e6:.1f}M steps/s; "
        f"active={act}")
    return steps_per_sec


def run_config(name, n_side, n_particles, dt, n_cycles, diffusion=1e-3,
               locate_mode="bary", workload=None, escape=False,
               integrator="euler", brownian=True):
    import jax

    from cudaparticlesfoam_tpu import StepConfig, run_cycles
    from cudaparticlesfoam_tpu.parallel import sharding
    from cudaparticlesfoam_tpu.stepper import suggest_tuning

    mesh, st = workload or build_workload(n_side, n_particles, diffusion)
    if st.n_particles != n_particles:
        # same mesh, different particle count: reseed
        from cudaparticlesfoam_tpu import (
            build_grid_locator, locate_seeds, seed_in_box,
        )
        from cudaparticlesfoam_tpu.state import replace as replace_state

        loc = build_grid_locator(mesh)
        lo, hi = 0.05 * n_side, 0.95 * n_side
        st = seed_in_box(n_particles, (lo,) * 3, (hi,) * 3, method="threefry")
        st = replace_state(st, tet_id=locate_seeds(mesh, loc, st.pos))
    if locate_mode == "convex" and mesh.tet_row_cx is None:
        from cudaparticlesfoam_tpu.mesh import with_convex_rows

        t0 = time.perf_counter()
        mesh = with_convex_rows(mesh)
        log(f"convex rows built ({time.perf_counter()-t0:.1f}s)")
    # "rbg" Brownian noise (lax.rng_bit_generator + Box-Muller):
    # statistically equivalent normals, as the reference's curand is
    # equally non-bit-matching (particles.cu:551-599)
    cfg = suggest_tuning(
        mesh, StepConfig(dt=dt, diffusion_coeff=diffusion,
                         brownian_rng="rbg", locate_mode=locate_mode,
                         escape_faces=escape, integrator=integrator,
                         use_brownian=brownian),
        dt, n_particles=n_particles,
    )
    log(f"[{name}] tuned: inline_hops={cfg.inline_hops} "
        f"walk_capacity_frac={cfg.walk_capacity_frac:.4f}")

    if len(jax.devices()) > 1:
        dmesh, rmesh, sst = sharding.distribute(mesh, st)
        run = sharding.run_cycles_sharded
    else:
        # single device: plain jit, no sharding machinery
        rmesh, sst = mesh, st
        run = run_cycles

    # warm up THE SAME program shape that is timed (each n_cycles value is
    # its own XLA program; first execution includes its compile)
    t0 = time.perf_counter()
    sst = run(rmesh, sst, cfg, n_cycles)
    jax.block_until_ready(sst.pos)
    log(f"[{name}] compile+first batch: {time.perf_counter()-t0:.1f}s")

    # best of 3 timed windows, each ending in block_until_ready
    dt_wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sst = run(rmesh, sst, cfg, n_cycles)
        jax.block_until_ready(sst.pos)
        dt_wall = min(dt_wall, time.perf_counter() - t0)

    steps_per_sec = n_particles * n_cycles / dt_wall
    d = sharding.global_diagnostics(sst)
    log(f"[{name}] {n_cycles} cycles in {dt_wall:.2f}s -> "
        f"{steps_per_sec/1e6:.1f}M steps/s; active={int(d['active'])} "
        f"out={int(d['out_of_domain'])}")
    return steps_per_sec, (mesh, st)


def run_config_partitioned(name, workload, n_particles, dt, n_cycles,
                           slack=1.25, cap_out_frac=0.125):
    """The multi-device regime's shard-local cycle + full migration glue
    on one device (S=1): headline workload in ``slack``x particle slots,
    timed through the one-dispatch scan runner."""
    import jax

    from cudaparticlesfoam_tpu import StepConfig
    from cudaparticlesfoam_tpu.parallel import partition, sharding
    from cudaparticlesfoam_tpu.stepper import suggest_tuning

    mesh, st = workload
    cfg = suggest_tuning(
        mesh, StepConfig(dt=dt, diffusion_coeff=1e-3), dt,
        n_particles=n_particles,
    )
    pm = partition.partition_mesh(mesh, 1)
    dmesh = sharding.make_device_mesh(1, axis="s")
    sp = partition.distribute_particles(
        pm, st.pos, st.vel, st.tet_id, st.active, slack=slack
    )
    pm, sp = partition.shard_arrays(pm, sp, dmesh)
    run = partition.make_partitioned_runner(
        pm, cfg, dmesh, n_cycles, cap_out_frac=cap_out_frac
    )
    t0 = time.perf_counter()
    sp, _ = run(pm, sp, dt)
    jax.block_until_ready(sp.pos)
    log(f"[{name}] compile+first batch: {time.perf_counter()-t0:.1f}s")
    dt_wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sp, _ = run(pm, sp, dt)
        jax.block_until_ready(sp.pos)
        dt_wall = min(dt_wall, time.perf_counter() - t0)
    sps = n_particles * n_cycles / dt_wall
    log(f"[{name}] {n_cycles} cycles in {dt_wall:.2f}s -> "
        f"{sps/1e6:.1f}M steps/s (capacity {sp.pos.shape[1]})")
    return sps


def main():
    import jax

    from cudaparticlesfoam_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's default device is "
                 f"{dev.platform} ({dev.device_kind})")
    enable_compile_cache()
    log(f"device: {dev.device_kind} x{len(jax.devices())}")
    n_side = int(sys.argv[1]) if len(sys.argv) > 1 else 55
    n_particles = int(float(sys.argv[2])) if len(sys.argv) > 2 else 1_000_000
    n_cycles = int(sys.argv[3]) if len(sys.argv) > 3 else 200

    headline, wl = run_config("north-star", n_side, n_particles, 0.05, n_cycles)
    # the reference's DEFAULT build mode (-DConvexPoly,
    # applications/*/Make/options:1-5): same workload, convex locate
    convex, _ = run_config(
        "convex-default", n_side, n_particles, 0.05, n_cycles,
        locate_mode="convex", workload=wl,
    )
    # BASELINE config 2's integrator: "1M tracers, RK4 + wall rebound" —
    # pure advection (no Brownian), integrator="rk4" on the cached engine
    # (stage velocities via fused._stage_velocity)
    rk4, _ = run_config(
        "rk4-tracers", n_side, n_particles, 0.05, max(n_cycles // 2, 20),
        workload=wl, integrator="rk4", brownian=False,
    )
    tutorial, _ = run_config("tutorial-scale", 29, 100_000, 1.0, max(n_cycles, 200))
    # scale config (BASELINE config 4's particle count): 10M particles on
    # the same 1M-tet mesh — catches large-batch gather regressions that
    # the 1M number cannot see.  Reuses the headline mesh; 10x lanes,
    # fewer cycles.
    scale_10m, _ = run_config(
        "scale-10m", n_side, 10_000_000, 0.05, max(n_cycles // 5, 20),
        workload=wl,
    )
    # partitioned strategy on one device (BASELINE config 5's shard-local
    # cycle + full migration glue at S=1)
    partitioned = run_config_partitioned(
        "partitioned-1shard", wl, n_particles, 0.05, max(n_cycles // 5, 20)
    )
    # unstructured + outflow config (BASELINE config 4's character):
    # jittered irregular tets, absorbing +x patch, escape faces on the
    # fast path, coupled-tutorial particle count
    wl_u = build_unstructured_workload(n_side, 4_000_000)
    unstructured, _ = run_config(
        "unstructured-outflow", n_side, 4_000_000, 0.05,
        max(n_cycles // 2, 20), workload=wl_u, escape=True,
    )
    del wl_u
    # FULL BASELINE config 4: "~5M-tet mesh, 10M-100M particles,
    # injection/deletion + outflow boundaries" — 95^3 hexes x 6 = 5.14M
    # jittered tets (411 MB walk table, larger than the 50 MB L2: the
    # large-table regime), 10M particles, absorbing +x patch, and
    # PERIODIC in-loop injection refilling escaped slots inside the
    # timed region (state.inject_device)
    n5 = 95
    mesh5, st5 = build_unstructured_workload(n5, 10_000_000)
    lo5, hi5 = 0.05 * n5, 0.95 * n5
    unstructured_5m = run_config_injected(
        "unstructured-5m-inject", mesh5, st5, 10_000_000, 0.05,
        max(n_cycles // 10, 20), burst_every=10, burst_count=65536,
        box_lo=(lo5,) * 3, box_hi=(hi5,) * 3,
    )
    del mesh5, st5

    reference_rate = 100e6  # BASELINE.json's rate scale, particle-steps/s
    print(
        json.dumps(
            {
                "metric": "particle_steps_per_sec_per_chip",
                "value": round(headline, 1),
                "unit": "particle-steps/s",
                "vs_baseline": round(headline / reference_rate, 4),
                "rk4_steps_per_sec": round(rk4, 1),
                "tutorial_scale_steps_per_sec": round(tutorial, 1),
                "convex_mode_steps_per_sec": round(convex, 1),
                "steps_per_sec_10m": round(scale_10m, 1),
                "unstructured_steps_per_sec": round(unstructured, 1),
                "unstructured_5m_steps_per_sec": round(unstructured_5m, 1),
                "partitioned_steps_per_sec": round(partitioned, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
