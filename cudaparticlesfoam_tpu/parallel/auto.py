"""Automatic multi-chip strategy selection for the particle engine.

The reference shrinks to one GPU (gather-to-master, ``initCuda.H:209-322``).
Here the case drivers scale *out* instead, picking between the two
multi-chip regimes (SURVEY.md §2.3) without user flags:

* ``single``  — one device, the plain fused stepper.
* ``dp``      — particle data-parallel: mesh replicated per chip, particles
  sharded over the device mesh (zero per-step communication).  Chosen when
  the mesh's device tables fit comfortably in per-chip HBM.
* ``partitioned`` — spatial slab decomposition with ``all_to_all`` particle
  migration (:mod:`.partition`).  Chosen when replicating the mesh would
  not fit (>HBM meshes) — no device ever holds the whole problem.

:class:`ParticleEngine` gives the drivers one interface over all three.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax

from ..mesh import TetMesh
from ..state import ParticleState
from ..stepper import StepConfig, run_cycles


def device_hbm_bytes(default: float = 16e9) -> float:
    """Per-device memory budget as the backend reports it.  Only the CPU
    backend (host memory, virtual devices) reports none and gets
    ``default``; an accelerator that reports no limit is an error, not a
    guess."""
    dev = jax.devices()[0]
    stats = dev.memory_stats()
    if stats and "bytes_limit" in stats:
        return float(stats["bytes_limit"])
    if dev.platform == "cpu":
        return default
    raise RuntimeError(
        f"{dev.platform} device {dev.device_kind!r} reports no memory limit"
    )


def mesh_table_bytes(tet_mesh: TetMesh) -> int:
    """Bytes of the mesh pytree a replicating (DP) device must hold."""
    return int(
        sum(
            np.prod(x.shape) * x.dtype.itemsize
            for x in jax.tree_util.tree_leaves(tet_mesh)
            if hasattr(x, "shape")
        )
    )


def particle_working_bytes(n: int, itemsize: int = 4) -> int:
    """Per-particle engine working set: mega rows (32-40 cols) double-
    buffered through the cycle + the unpacked state arrays."""
    return n * itemsize * (40 * 2 + 14)


def choose_strategy(
    tet_mesh: TetMesh,
    n_particles: int,
    n_devices: int,
    hbm_bytes: float | None = None,
    headroom: float = 0.6,
) -> str:
    """Pick single / dp / partitioned from the memory model.

    DP replicates the mesh per chip: viable iff
    ``mesh_bytes + particle_share <= headroom * HBM``.  Otherwise the mesh
    must be spatially partitioned so no device holds the whole problem.
    One device always runs ``single`` (partitioning cannot reduce a lone
    device's footprint).
    """
    if n_devices <= 1:
        return "single"
    hbm = hbm_bytes if hbm_bytes is not None else device_hbm_bytes()
    mesh_b = mesh_table_bytes(tet_mesh)
    share = particle_working_bytes(-(-n_particles // n_devices))
    if mesh_b + share <= headroom * hbm:
        return "dp"
    return "partitioned"


class ParticleEngine:
    """Uniform stepping interface over the three execution strategies.

    ``advance(n_cycles, dt)`` runs fused sub-steps; ``snapshot()`` returns
    a host-ordered :class:`ParticleState` for I/O (for the partitioned
    strategy this settles pending migration handoffs first, so snapshots
    match the single-device trajectory exactly).
    """

    def __init__(self, tet_mesh: TetMesh, state: ParticleState, cfg: StepConfig,
                 devices: int | None = None, strategy: str = "auto",
                 hbm_bytes: float | None = None, log=print):
        self.cfg = cfg
        self._orig_n = state.n_particles
        n_dev = devices if devices is not None else 1
        if strategy == "auto":
            strategy = choose_strategy(
                tet_mesh, state.n_particles, n_dev, hbm_bytes
            )
        if strategy == "dp" and n_dev <= 1:
            strategy = "single"
        # NOTE: the partitioned cycle draws Brownian noise keyed by
        # (run key, step, GLOBAL particle id) — migration- and
        # shard-count-stable — regardless of cfg.brownian_rng; the knob
        # selects the lane-indexed stream of the single/DP paths
        # (partition._local_cycle_cached documents the stream).
        self.strategy = strategy
        log(
            f"#adv: engine strategy={strategy} devices={n_dev} "
            f"(mesh tables {mesh_table_bytes(tet_mesh)/2**20:.0f}MB)"
        )
        if strategy == "single":
            self.mesh = tet_mesh
            self.state = state
        elif strategy == "dp":
            from . import sharding

            self.dmesh, self.mesh, self.state = sharding.distribute(
                tet_mesh, state, n_dev
            )
        elif strategy == "partitioned":
            from . import partition, sharding

            if getattr(cfg, "locate_mode", "bary") == "convex":
                if tet_mesh.tet_row_cx is None:
                    raise ValueError(
                        "partitioned convex mode needs with_convex_rows(mesh)"
                    )
                layout = "cx"
            elif getattr(cfg, "velocity_interp", "") == "VertexVelocity":
                layout = "pk"
            else:
                layout = "tet"

            S = max(n_dev, 1)
            self._pm = partition.partition_mesh(tet_mesh, S, layout=layout)
            self.dmesh = sharding.make_device_mesh(S, axis="s")
            sp = partition.distribute_particles(
                self._pm, state.pos, state.vel, state.tet_id, state.active,
                rng_key=state.rng_key,
            )
            self._pm, self._sp = partition.shard_arrays(self._pm, sp, self.dmesh)
            self._step = partition.make_partitioned_step(self._pm, cfg, self.dmesh)
            self._settle = partition.make_settle_step(self._pm, cfg, self.dmesh)
            self._runners = {}
            self._deferred = 0
            self._migrated = 0
        else:
            raise ValueError(f"unknown strategy {strategy!r}")

    @property
    def supports_injection(self) -> bool:
        return True

    def set_state(self, state: ParticleState) -> None:
        """Replace the particle state (injection path): single assigns,
        DP re-pads and re-shards, partitioned re-distributes the host
        state into the existing per-shard slots (same capacity — the
        compiled step functions survive; Brownian streams are keyed by
        (step, global pid), so surviving particles keep their noise)."""
        if self.strategy == "single":
            self.state = state
        elif self.strategy == "dp":
            from . import sharding

            self.state = sharding.shard_state(state, self.dmesh)
        else:
            from . import partition

            sp = partition.distribute_particles(
                self._pm, state.pos, state.vel, state.tet_id, state.active,
                rng_key=state.rng_key, capacity=self._sp.capacity,
                step=state.step,
            )
            _, self._sp = partition.shard_arrays(self._pm, sp, self.dmesh)

    def update_from_case(self, case, geometry: bool = False) -> None:
        """Refresh the engine's mesh copy after ``case.update_velocity``
        (or, with ``geometry=True``, a dynamic-mesh geometry refresh) —
        the multi-chip analog of the per-Eulerian-step
        ``cudaUpdateVelocity`` upload (``advect.H:44-83``)."""
        from ..mesh import replace_velocity

        tm = case.tet_mesh
        if self.strategy == "single":
            self.mesh = tm
        elif self.strategy == "dp":
            if geometry:
                from . import sharding

                self.mesh = sharding.replicate_mesh(tm, self.dmesh)
            else:
                # velocity-only refresh of the replicated tables (row
                # caches embed u)
                self.mesh = replace_velocity(
                    self.mesh, tet_vel=tm.tet_vel,
                    vert_vel=tm.vert_vel if self.mesh.tet_row_pk is not None
                    else None,
                )
        else:   # partitioned
            import jax.sharding as jsh

            from . import partition

            if geometry:
                # moving mesh (no topology changes): rebuild the per-shard
                # geometry tables in place — the slab assignment, shapes,
                # compiled step functions, and particle tet ids all
                # survive (partition.refresh_geometry)
                layout = {29: "pk", 24: "cx"}.get(
                    int(self._pm.tet_row.shape[-1]), "tet"
                )
                pm = partition.refresh_geometry(self._pm, tm, layout=layout)
            else:
                pm = partition.update_velocity(
                    self._pm, tm.tet_vel, vert_vel=tm.vert_vel, tets=tm.tets
                )
            self._pm = dataclasses.replace(
                pm,
                tet_row=jax.device_put(
                    pm.tet_row, jsh.NamedSharding(self.dmesh, jsh.PartitionSpec("s"))
                ),
            )

    @property
    def migration_stats(self) -> dict:
        if self.strategy != "partitioned":
            return {}
        return {
            "migrated": int(self._migrated), "deferred": int(self._deferred)
        }

    def advance(self, n_cycles: int, dt) -> None:
        if self.strategy == "partitioned":
            if n_cycles == 1:
                self._sp, stats = self._step(self._pm, self._sp, dt)
            else:
                # one dispatch for the whole batch (lax.scan); compiled
                # runners are cached per batch length
                from . import partition

                runner = self._runners.get(n_cycles)
                if runner is None:
                    runner = partition.make_partitioned_runner(
                        self._pm, self.cfg, self.dmesh, n_cycles
                    )
                    self._runners[n_cycles] = runner
                self._sp, stats = runner(self._pm, self._sp, dt)
            # device-side accumulation keeps dispatch asynchronous
            self._deferred = self._deferred + stats["deferred"]
            self._migrated = self._migrated + stats["migrated"]
            return
        if self.strategy == "dp":
            from . import sharding

            self.state = sharding.run_cycles_sharded(
                self.mesh, self.state, self.cfg, n_cycles, dt
            )
            return
        self.state = run_cycles(self.mesh, self.state, self.cfg, n_cycles, dt)

    def snapshot(self) -> ParticleState:
        """Host-ordered state (original particle ordering and count)."""
        if self.strategy == "partitioned":
            from . import partition

            sp, _ = self._settle(self._pm, self._sp, 0.0)
            pos, vel, tet, act = partition.collect_particles(
                self._pm, sp, self._orig_n
            )
            return ParticleState(
                pos=jax.numpy.asarray(pos, sp.pos.dtype),
                vel=jax.numpy.asarray(vel, sp.pos.dtype),
                disp=jax.numpy.zeros((self._orig_n, 3), sp.pos.dtype),
                tet_id=jax.numpy.asarray(tet),
                active=jax.numpy.asarray(act),
                rng_key=sp.rng_key,
                # the settle pass is displacement-free bookkeeping, not a
                # simulation sub-step: report the pre-settle cycle counter
                # (injection keys its RNG off state.step — a +1 here would
                # diverge the injected positions from a single-device run)
                step=self._sp.step,
                n_particles=self._orig_n,
            )
        st = self.state
        if st.n_particles != self._orig_n:   # dp padding
            n = self._orig_n
            st = dataclasses.replace(
                st,
                pos=st.pos[:n], vel=st.vel[:n], disp=st.disp[:n],
                tet_id=st.tet_id[:n], active=st.active[:n], n_particles=n,
            )
        return st

    def block(self) -> None:
        obj = self._sp.pos if self.strategy == "partitioned" else self.state.pos
        jax.block_until_ready(obj)
