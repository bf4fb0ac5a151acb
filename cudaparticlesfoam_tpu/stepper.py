"""The fused particle stepper.

The reference's per-cycle hot loop (``src/advect.H:86-184``) is six
synchronized kernel launches: advect -> brownian -> locate -> reflect ->
move (each with a full ``cudaDeviceSynchronize``).  Here the whole
sub-cycling loop is ONE compiled XLA program: a ``lax.fori_loop`` over
``n_cycles`` of the fused cycle, with zero host round-trips and zero
device syncs inside.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .mesh import TetMesh
from .state import ParticleState
from .ops import advect as advect_ops
from .ops import locate as locate_ops


BROWNIAN_RNGS = ("threefry", "rbg")

# options of earlier versions whose only code paths were TPU kernels; a
# config that still names one fails loudly instead of being ignored
REMOVED_OPTIONS = ("hop_compact", "hop_compact_frac", "macro_cycles",
                   "engine_impl")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static per-run knobs (hashable; changing them recompiles).

    Mirrors the reference's config surface: the ``cudaParticlesDict`` keys
    (``src/initCuda.H:50-57``) plus the hardcoded toggles that should have
    been config (``src/initCuda.H:64-72``), promoted to real options.
    """

    dt: float = 1e-4
    diffusion_coeff: float = 5.7e-6
    use_advection: bool = True            # usingAdvection
    use_brownian: bool = True             # usingBrownianMotion
    reflect_wall: bool = True             # reflectWall
    velocity_interp: str = advect_ops.TET_VELOCITY  # VelocityInterpMethod
    max_hops: int = locate_ops.MAX_HOPS   # RTQuery.cu:42
    max_bounces: int = 10                 # RTQuery.cu:131
    # engine selection: "cached" = row-cache fast path (TetVelocity only),
    # "simple" = straightforward vectorized ops, "auto" picks cached when
    # the interpolation mode allows it.
    engine: str = "auto"
    # rare-stage round buffer: fraction of the n/8 lane-blocks gathered per
    # round (pending lanes after the inline hop — multi-hop walkers + wall
    # hits).  Undersizing costs extra rounds, never correctness.
    walk_capacity_frac: float = 0.125
    # rare-stage exact-lane capacity, as a fraction of the round arena
    # (``walk_capacity_frac * n`` lanes).  Arena op cost scales with this;
    # undersizing costs extra rounds, never correctness.  1/4 retires a
    # fully-pending arena in 4 rounds; the headline regime pends ~1% of
    # lanes so smaller fractions shrink every per-round [cap_l,*] op.
    arena_lane_frac: float = 0.25
    # cell-location algorithm: "bary" = barycentric sign walk (RTX build,
    # query/RTQuery.cu), "convex" = exact segment/face tracing (ConvexPoly
    # build, query/ConvexQuery.cu)
    locate_mode: str = "bary"
    # time integrator: "euler" (reference, particles.cu:297-302) or "rk4"
    # (north-star mode; cached engine on the bary path — stage velocities
    # via fused._stage_velocity — simple engine elsewhere)
    integrator: str = "euler"
    # Brownian noise source (cached engine): "threefry" = counter-based
    # jax.random, bit-identical to the simple engine; "rbg" =
    # lax.rng_bit_generator (Philox on the GPU) + Box-Muller, statistically
    # equivalent and cheaper to generate
    brownian_rng: str = "threefry"
    # full-batch inline walk hops per sub-step before the compacted rare
    # stage takes over: 1 for low-CFL regimes (<~15% of particles cross a
    # tet face per sub-step), 3-4 when particles cross ~a cell per
    # sub-step (e.g. the pitzDaily tutorial's frozen-field replay).
    # See suggest_tuning() for the data-driven choice.
    inline_hops: int = 1
    # resolve the dominant single-bounce wall reflection inline (full
    # batch, column math) before the rare stage; semantics identical to
    # bounce 1 of RTreflection (RTQuery.cu:92-186)
    inline_bounce: bool = True
    # sub-batches per cycle on the bary cached engine (very large runs;
    # bit-identical results)
    cycle_chunks: int = 1
    # set by the case drivers when absorbing (escape) patches exist so the
    # inline bounce checks bd_escape; the rare-stage reflector always does
    escape_faces: bool = False
    # safety net for convex mode: the reference's tracer cannot re-detect a
    # face once a particle sits a hair outside it (tol asymmetry,
    # ConvexQuery.cu:95), so corner-reflection dust can leak out of the
    # domain (their testNStracing replays such cases).  This runs a
    # barycentric re-check + reflect after the convex step; disable for
    # strict reference behavior.
    convex_bary_fix: bool = True

    def __post_init__(self):
        if self.brownian_rng not in BROWNIAN_RNGS:
            raise ValueError(
                f"brownian_rng must be one of {BROWNIAN_RNGS}, got "
                f"{self.brownian_rng!r}"
            )

    def resolved_engine(self) -> str:
        if self.engine == "auto":
            if self.locate_mode == "convex":
                # ConvexPoly cached engine (TetVelocity + Euler, like the
                # reference's default build); needs with_convex_rows(mesh)
                return (
                    "cached"
                    if self.velocity_interp == advect_ops.TET_VELOCITY
                    and self.integrator == "euler"
                    else "simple"
                )
            # euler AND rk4 ride the cached engine on the bary path (rk4
            # stage velocities come from _stage_velocity's cached-row
            # classify + compacted exact walk, fused.py)
            return (
                "cached"
                if self.velocity_interp
                in (advect_ops.TET_VELOCITY, advect_ops.VERTEX_VELOCITY)
                and self.locate_mode == "bary"
                and self.integrator in ("euler", "rk4")
                else "simple"
            )
        return self.engine


_dataclass_init = StepConfig.__init__


def _init_rejecting_removed(self, *args, **kwargs):
    for name in REMOVED_OPTIONS:
        if name in kwargs:
            raise ValueError(
                f"StepConfig option {name!r} was removed: it selected TPU "
                f"kernels that no longer exist; the XLA engine needs no "
                f"such setting"
            )
    _dataclass_init(self, *args, **kwargs)


StepConfig.__init__ = _init_rejecting_removed


def cycle(mesh: TetMesh, state: ParticleState, cfg: StepConfig, dt) -> ParticleState:
    """One Lagrangian sub-step (one iteration of ``advect.H:86-184``)."""
    pos, vel, disp = state.pos, state.vel, state.disp
    tet_id, active = state.tet_id, state.active

    # advect: disp = dt * u(x); kills lanes with negative tet ids
    if cfg.use_advection:
        disp, vel, active = advect_ops.advect(
            mesh, pos, vel, tet_id, active, dt, cfg.velocity_interp,
            integrator=cfg.integrator,
        )

    # brownian: disp += sqrt(2 D dt) N(0,1)
    if cfg.use_brownian:
        key = jax.random.fold_in(state.rng_key, state.step)
        disp = advect_ops.brownian(disp, active, key, dt, cfg.diffusion_coeff)

    if cfg.locate_mode == "convex":
        # ConvexPoly mode: exact segment tracing + its reflector
        from .ops import convex as convex_ops

        tet_id, stop_tet, p_cross, hit_face = convex_ops.trace_segment(
            mesh, pos, disp, tet_id, active=active, max_tets=cfg.max_hops
        )
        if cfg.reflect_wall:
            pos, disp, vel, tet_id = convex_ops.convex_reflect(
                mesh, pos, disp, vel, tet_id, stop_tet, p_cross, hit_face
            )
            if cfg.convex_bary_fix:
                # barycentric consistency pass on the landed position
                p_land = pos + jnp.where(active[:, None], disp, 0.0)
                tet_chk, _ = locate_ops.walk(mesh, p_land, tet_id)
                zero = jnp.zeros_like(disp)
                d_fix, vel, tet_id = locate_ops.reflect_walls(
                    mesh, p_land, zero, vel, tet_chk,
                    max_bounces=cfg.max_bounces,
                )
                disp = jnp.where(active[:, None], disp + d_fix, disp)
    else:
        # locate: walk from previous tet to pos + disp
        tet_id, _ = locate_ops.walk(
            mesh, pos + disp, tet_id, max_hops=cfg.max_hops
        )

        # reflect wall hits (specular, all boundaries — reference TODO
        # semantics)
        if cfg.reflect_wall:
            disp, vel, tet_id = locate_ops.reflect_walls(
                mesh, pos, disp, vel, tet_id, max_bounces=cfg.max_bounces
            )

    # move: pos += disp; disp = 0
    pos, disp = advect_ops.move(pos, disp, active)

    return dataclasses.replace(
        state,
        pos=pos,
        vel=vel,
        disp=disp,
        tet_id=tet_id,
        active=active,
        step=state.step + 1,
    )


def _run_cycles_impl(
    mesh: TetMesh, state: ParticleState, cfg: StepConfig, n_cycles: int, dt,
) -> ParticleState:
    dt = jnp.asarray(cfg.dt if dt is None else dt, dtype=state.dtype)

    engine = cfg.resolved_engine()
    if engine == "cached" and cfg.locate_mode == "convex":
        if mesh.tet_row_cx is None:
            # without with_convex_rows(mesh): simple engine
            engine = "simple"
        else:
            from .ops import fused, fused_convex

            tab = fused_convex.cx_table(mesh)
            m0 = fused_convex.pack_state(
                mesh, tab, state.pos, state.vel, state.tet_id, state.active
            )

            def body(i, carry):
                m, step = carry
                m = fused_convex.mega_cycle(
                    mesh, tab, m, state.rng_key, step, cfg, dt
                )
                return m, step + 1

            m, step = lax.fori_loop(0, n_cycles, body, (m0, state.step))
            pos, vel, tet, act = fused.unpack_state(m)
            return dataclasses.replace(
                state, pos=pos, vel=vel, disp=jnp.zeros_like(state.disp),
                tet_id=tet, active=act, step=step,
            )
    if engine == "cached":
        from .ops import fused

        ly = fused.layout_for(cfg)
        if fused.row_table(mesh, ly) is None:
            # VertexVelocity without with_pk_rows(mesh): simple engine
            engine = "simple"

    if engine == "cached":
        m0 = fused.pack_state(
            mesh, state.pos, state.vel, state.tet_id, state.active, ly
        )

        def body(i, carry):
            m, step = carry
            m = fused.mega_cycle(mesh, m, state.rng_key, step, cfg, dt)
            return m, step + 1

        m, step = lax.fori_loop(0, n_cycles, body, (m0, state.step))
        pos, vel, tet, act = fused.unpack_state(m)
        return dataclasses.replace(
            state,
            pos=pos,
            vel=vel,
            disp=jnp.zeros_like(state.disp),
            tet_id=tet,
            active=act,
            step=step,
        )

    def body(_, st):
        return cycle(mesh, st, cfg, dt)

    return lax.fori_loop(0, n_cycles, body, state)


@partial(jax.jit, static_argnames=("cfg", "n_cycles"))
def run_cycles(
    mesh: TetMesh, state: ParticleState, cfg: StepConfig, n_cycles: int,
    dt=None,
) -> ParticleState:
    """``n_cycles`` sub-steps as one compiled program.

    ``dt`` defaults to cfg.dt; pass the Eulerian ``cycleDt`` for coupled runs
    (``advect.H:36-37``: nCycles = ceil(deltaT/dt), cycleDt = deltaT/nCycles).

    Engine "cached" (default for TetVelocity) carries the per-particle row
    cache through the loop — one gather builds it, only face-crossers touch
    it after (see :mod:`.ops.fused`).
    """
    return _run_cycles_impl(mesh, state, cfg, n_cycles, dt)


@partial(jax.jit, static_argnames=("cfg", "n_cycles"), donate_argnums=(1,))
def run_cycles_donated(
    mesh: TetMesh, state: ParticleState, cfg: StepConfig, n_cycles: int,
    dt=None,
) -> ParticleState:
    """:func:`run_cycles` with the input state DONATED: its buffers are
    reused for the outputs, halving the particle-state HBM footprint.  Use
    on hot paths that never touch the old state again (the case drivers,
    bench); tests that re-run from one seed state need :func:`run_cycles`.
    """
    return _run_cycles_impl(mesh, state, cfg, n_cycles, dt)


@partial(jax.jit, static_argnames=("cfg",))
def step_once(mesh: TetMesh, state: ParticleState, cfg: StepConfig, dt) -> ParticleState:
    """Single sub-step (jitted), for tests and interactive use."""
    return cycle(mesh, state, cfg, jnp.asarray(dt, dtype=state.dtype))


def suggest_tuning(mesh: TetMesh, cfg: StepConfig, dt=None,
                   n_particles: int | None = None) -> StepConfig:
    """Profile-guided static tuning of the cached engine's knobs.

    Estimates the expected tet-face crossings per particle per sub-step
    from the mesh's per-tet velocity magnitude, tet size, and the Brownian
    RMS kick, then picks ``inline_hops`` (full-batch walk hops) and
    ``walk_capacity_frac`` (rare-stage round buffer) to match the regime.
    Cheap (one host-side pass over the tet arrays at setup); exactness is
    never at stake — these knobs trade kernel launches vs buffer sizes.
    The choice depends only on the mesh, the flow and the batch size,
    never on the device.
    """
    import numpy as np

    from . import mesh as meshlib

    dt = float(cfg.dt if dt is None else dt)
    pts = meshlib.host_np(mesh, "points", np.float64)
    tets = meshlib.host_np(mesh, "tets")
    u = meshlib.host_np(mesh, "tet_vel", np.float64)
    if cfg.velocity_interp == advect_ops.VERTEX_VELOCITY or not np.any(u):
        # Pk workloads carry per-vertex velocities; estimate per-tet speed
        # from the vertex average when tet_vel is absent/zero
        vv = meshlib.host_np(mesh, "vert_vel", np.float64)
        if np.any(vv):
            u = vv[tets].mean(axis=1)
    a = pts[tets[:, 0]]
    vol = np.abs(
        np.einsum(
            "ij,ij->i",
            pts[tets[:, 1]] - a,
            np.cross(pts[tets[:, 2]] - a, pts[tets[:, 3]] - a),
        )
        / 6.0
    )
    h = np.cbrt(np.maximum(vol * 6.0, 1e-300))   # tet characteristic length
    speed = np.sqrt((u * u).sum(axis=1))
    if cfg.use_brownian:
        # per-axis RMS Brownian displacement rate over one sub-step
        speed = speed + np.sqrt(2.0 * cfg.diffusion_coeff / max(dt, 1e-300)) * 1.7
    # mean tets crossed per sub-step (the 1.5 accounts for the Kuhn split's
    # internal diagonal faces being crossed more often than cell faces)
    crossings = float(np.mean(np.minimum(speed * dt / np.maximum(h, 1e-300), 50.0)) * 1.5)
    # The thresholds and fractions below were fitted on the engine's
    # earlier accelerator and are not yet re-tuned on the H100.  The
    # shape of the rule holds on any device: every rare-stage round is
    # several kernel launches plus a loop-condition readback, so a
    # high-crossing regime wants more full-batch inline hops, and at low
    # crossing rates a single hop resolves nearly every crosser.
    if crossings < 0.4:
        hops, frac = 1, 1 / 16
    elif crossings < 0.8:
        hops, frac = 2, 1 / 8
    elif crossings < 1.5:
        hops, frac = 4, 1 / 4
    else:
        hops, frac = min(4 + int(crossings + 1.0), 8), 1 / 4
    # inline single-bounce reflection streams several full-batch passes
    # per cycle; it pays off only when wall contact is frequent (e.g. 2-D
    # cases where every cell touches an empty patch and Brownian motion
    # grinds the z-walls).  Estimate the per-cycle wall-hit rate as
    # (boundary-adjacent tet fraction) x (crossing rate) and route rare
    # wall hits through the compacted rare stage instead.
    bd_frac = float(np.mean(np.any(meshlib.host_np(mesh, "tet_nbr") < 0, axis=1)))
    wall_rate = bd_frac * min(crossings, 1.0) * 0.5
    inline_bounce = cfg.reflect_wall and wall_rate > 0.01
    # very large batches run the cycle as sub-batches of ~5M lanes
    # (bit-identical; bounds the per-cycle temporaries)
    n_p = int(n_particles or 0)
    chunks = 1 if n_p <= 2_000_000 else max(1, round(n_p / 5_000_000))
    # rare-arena exact-stage capacity: the convex stream and the
    # multi-hop bary regimes pend under ~1% of lanes after the inline
    # hops, so a leaner per-round arena shrinks every [cap_l,*] op inside
    # the round loop; undersizing costs rounds, never correctness
    if getattr(cfg, "locate_mode", "bary") == "convex" or hops >= 2:
        arena_lf = 0.125
    else:
        arena_lf = cfg.arena_lane_frac
    return dataclasses.replace(
        cfg, inline_hops=hops, walk_capacity_frac=frac,
        inline_bounce=inline_bounce, cycle_chunks=chunks,
        arena_lane_frac=arena_lf,
    )


def n_cycles_for(delta_t_euler: float, dt_lagrange: float) -> tuple[int, float]:
    """Sub-cycling split (``advect.H:36-37``)."""
    import math

    n = max(int(math.ceil(delta_t_euler / dt_lagrange)), 1)
    return n, delta_t_euler / n


def diagnostics(state: ParticleState) -> dict:
    """Out-of-domain count + system KE (the reference prints these at
    ``particles.cu:770`` and ``utils.cpp:258``)."""
    return {
        "out_of_domain": advect_ops.count_out_of_domain(state.tet_id),
        "kinetic_energy": advect_ops.kinetic_energy(state.vel),
        "active": jnp.sum(state.active.astype(jnp.int32)),
    }
