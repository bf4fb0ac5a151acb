"""Uncoupled (frozen-field) particle tracking driver.

The XLA equivalent of ``cudaParticlesUncoupledFoam``
(``applications/cudaParticlesUncoupledFoam/cudaParticlesUncoupledFoam.C:60-89``):
read the latest converged ``U``, build the tet mesh + particle state, then
run ``nCycles = ceil(deltaT/dt)`` Lagrangian sub-steps of the frozen field
in one shot (``advect.H`` included once, no time loop).

Differences by design: the whole sub-cycling loop runs as chunked fused XLA
programs between VTU writes instead of per-kernel launches, and output can
be disabled for benchmarking.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import numpy as np

from ..io import vtu
from ..ops import advect as advect_ops
from ..stepper import n_cycles_for, run_cycles_donated, suggest_tuning
from ..utils.profiling import PhaseTimer, device_trace
from . import case as caselib


def write_schedule(n_cycles: int, save_interval: int):
    """Cycle indices after which a VTU frame is written, and the frame id.

    Matches ``advect.H:166-169``: after cycle i (0-based), write frame i+1
    iff i % saveInterval == 0.
    """
    return [(i, i + 1) for i in range(0, n_cycles, save_interval)]


def run(
    case_dir: str,
    out_dir: str | None = None,
    write_output: bool = True,
    dtype=None,
    log=print,
    trajectories: bool | None = None,
    profile_dir: str | None = None,
    devices: int | None = None,
    strategy: str = "auto",
):
    """Run the uncoupled case end-to-end.  Returns (case, final_state, stats).

    ``devices``/``strategy`` control multi-chip execution (see
    :mod:`..parallel.auto`): with more than one device the driver picks
    particle-DP (mesh replicated) or spatial partitioning with migration
    (mesh > HBM) automatically — the inversion of the reference's
    gather-to-master distribution (``initCuda.H:209-322``).
    """
    timer = PhaseTimer()
    with timer.phase("Init"):
        case = caselib.load_case(case_dir, dtype=dtype, log=log)
    pcfg = case.particles
    ctrl = case.control
    out_dir = out_dir or case_dir

    t = case.time_value
    with timer.phase("Seed"):
        state = caselib.init_particles(case, log=log)
    cfg = suggest_tuning(case.tet_mesh, pcfg.step_config(),
                         n_particles=state.n_particles)
    if cfg.locate_mode == "convex":
        from ..mesh import with_convex_rows

        case.tet_mesh = with_convex_rows(case.tet_mesh)

    # warm-up advect: initCuda.H:184-199 computes vel/disp once (no move)
    # so frame 0 carries velocities; reproduce via the advect op alone.
    disp0, vel0, act0 = advect_ops.advect(
        case.tet_mesh, state.pos, state.vel, state.tet_id, state.active,
        pcfg.dt, cfg.velocity_interp,
    )
    state = dataclasses.replace(state, vel=vel0, disp=disp0, active=act0)

    track = vtu.Trajectories(state.n_particles) if (
        trajectories if trajectories is not None else pcfg.save_streamlines
    ) else None

    # ConvexPoly builds write an extra ConvexTetID column (utils.cpp:216-228)
    convex_ids = (lambda st: np.asarray(st.tet_id)) if (
        cfg.locate_mode == "convex"
    ) else (lambda st: None)

    stats = {"frames": [], "cycles": 0, "wall_s": 0.0}
    writer = vtu.AsyncVTUWriter()   # formatting/IO overlaps device compute
    if write_output:
        with timer.phase("IO"):
            path = writer.write(
                0, state, convex_tet_id=convex_ids(state), out_dir=out_dir,
                verbose=True,
            )
        stats["frames"].append(path)

    if not (pcfg.start_time <= t <= pcfg.end_time):
        log(
            f"#adv: time {t} outside particle window "
            f"[{pcfg.start_time}, {pcfg.end_time}]; nothing to do (advect.H:33)"
        )
        writer.close()
        return case, state, stats

    n_cycles, cycle_dt = n_cycles_for(ctrl.delta_t, pcfg.dt)
    log(f"dtE:{ctrl.delta_t} dtL: {pcfg.dt}")
    log(f"nCycles: {n_cycles} cycleDt: {cycle_dt}")

    # clear the warm-up displacement before the real loop (the reference's
    # first cudaAdvect overwrite does this implicitly, particles.cu:362)
    state = dataclasses.replace(state, disp=np.zeros_like(state.disp))

    n_dev = devices if devices is not None else len(jax.devices())
    if strategy == "auto" and n_dev <= 1 and devices is None:
        engine = None       # plain single-chip fast path (no wrapper)
    else:
        from ..parallel.auto import ParticleEngine

        engine = ParticleEngine(
            case.tet_mesh, state, cfg, devices=n_dev, strategy=strategy,
            log=log,
        )

    wall0 = time.perf_counter()
    with device_trace(profile_dir):
        inj_active = pcfg.injection_interval > 0 and (
            engine is None or engine.supports_injection
        )
        i = 0
        while i < n_cycles:
            # run up to the next write boundary in one fused program
            if i % pcfg.save_interval == 0:
                chunk = 1
            else:
                next_write = ((i // pcfg.save_interval) + 1) * pcfg.save_interval
                chunk = min(next_write, n_cycles) - i
            if inj_active:
                # break chunks at injection boundaries too, so every
                # multiple of injectionInterval is a chunk start (an
                # interval that does not divide saveInterval used to
                # inject only at step 0)
                inj = pcfg.injection_interval
                chunk = min(chunk, ((i // inj) + 1) * inj - i)
            with timer.phase("Advect"):
                if engine is None:
                    # donated: the previous state's buffers are reused
                    state = run_cycles_donated(
                        case.tet_mesh, state, cfg, chunk, cycle_dt
                    )
                else:
                    engine.advance(chunk, cycle_dt)
            prev = i
            i += chunk
            if inj_active and prev % pcfg.injection_interval == 0:
                from ..state import inject

                if engine is not None:
                    # host-ordered unpadded view: padding slots must not
                    # masquerade as dead, injectable particles
                    state = engine.snapshot()
                state, n_inj = inject(
                    state, case.tet_mesh, case.locator,
                    pcfg.seeding_box_lo, pcfg.seeding_box_hi,
                    pcfg.injection_count, rng_seed=pcfg.rng_seed,
                )
                if engine is not None:
                    engine.set_state(state)
                if n_inj:
                    log(f"#adv: injected {n_inj} particles at step {prev}")
            if prev % pcfg.save_interval == 0:
                if engine is not None:
                    state = engine.snapshot()
                if track is not None:
                    track.append(state)
                if write_output:
                    with timer.phase("IO"):
                        path = writer.write(
                            prev + 1, state, convex_tet_id=convex_ids(state),
                            out_dir=out_dir, verbose=True,
                        )
                    stats["frames"].append(path)
        if engine is not None:
            engine.block()
            state = engine.snapshot()
        jax.block_until_ready(state.pos)
        with timer.phase("IO"):
            writer.close()
    stats["wall_s"] = time.perf_counter() - wall0
    stats["cycles"] = n_cycles
    rate = state.n_particles * n_cycles / max(stats["wall_s"], 1e-12)
    log(
        f"#adv: Simulation RunTime={stats['wall_s']*1e3:.1f} ms "
        f"({rate/1e6:.2f}M particle-steps/s)"
    )
    timer.report(log=log)
    stats["phases"] = dict(timer.totals)
    if track is not None:
        track.save_vtk(f"{out_dir}/Streamline.vtk")
    return case, state, stats
