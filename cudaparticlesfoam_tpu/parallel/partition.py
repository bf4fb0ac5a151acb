"""Spatially partitioned meshes with cross-shard particle migration.

The second multi-chip regime (SURVEY.md §2.3): when the tet mesh is too
large to replicate per chip, shard it spatially and let particles ride
their shard, migrating between devices when they cross a partition
boundary.
This *inverts* the reference's distribution (every rank gathers mesh and
particles to the MPI master which owns the only GPU,
``src/initCuda.H:209-322``): here no device ever sees the whole problem.

Design:
* Host-side partition: tets sorted by centroid along the domain's longest
  axis into equal contiguous slabs (tet ids are renumbered so
  ``shard_of(tet) = tet // tets_per_shard`` — the shard map needs no
  table).  Each shard holds only its slab of the packed walk table.
* The per-shard sub-step runs the standard advect/Brownian/walk/reflect
  cycle (reference semantics) except that a hop whose neighbor tet lives
  on another shard *pauses*: the particle is handed off with its global
  target tet, and the destination shard's next hop-0 barycentric check
  resumes the relocation.  Since dt keeps walks to 1-2 cells, a handoff
  is almost always already in the destination tet.
* Migration is a fixed-capacity ``lax.all_to_all`` over the shard axis
  inside ``shard_map`` — the collective is scheduled by XLA.
  Slot bookkeeping (free-slot compaction, overflow deferral) is fully
  static-shape.

Determinism note: Brownian noise is keyed by (run key, step, GLOBAL
particle id), so each particle's stream is stable across migrations and
shard counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..mesh import TetMesh
from ..stepper import StepConfig
from ..utils.pytree import pytree_dataclass


@pytree_dataclass(meta_fields=("n_shards", "tets_per_shard", "n_tets"))
class PartitionedMesh:
    """Slab-partitioned walk tables; arrays carry a leading shard axis."""

    tet_row: jnp.ndarray    # [S, P, 20|24|29] (embedded neighbor codes
    #                         LOCALLY encoded per shard, _encode_local_nbr)
    tet_nbr: jnp.ndarray    # [S, P, 4]   int32 global codes
    perm: jnp.ndarray       # [nt] old tet id -> new (sorted) id
    inv_perm: jnp.ndarray   # [nt] new -> old
    bd_escape: jnp.ndarray  # [n_bd] bool, replicated (absorbing patches)
    n_shards: int
    tets_per_shard: int
    n_tets: int


@pytree_dataclass(meta_fields=("n_shards", "capacity",))
class ShardedParticles:
    """Per-shard particle slots; [S, C, ...] with a residency mask."""

    pos: jnp.ndarray        # [S, C, 3]
    vel: jnp.ndarray        # [S, C, 3]
    disp: jnp.ndarray       # [S, C, 3] pending (unconsumed) displacement —
    #                         nonzero only for convex-mode mid-segment
    #                         handoffs awaiting settlement
    tet: jnp.ndarray        # [S, C] int32, GLOBAL new-numbering ids
    active: jnp.ndarray     # [S, C] bool (particle alive)
    resident: jnp.ndarray   # [S, C] bool (slot occupied)
    pid: jnp.ndarray        # [S, C] int32 global particle id (-1 = empty)
    rng_key: jnp.ndarray
    step: jnp.ndarray
    n_shards: int
    capacity: int


def _encode_local_nbr(nbr, per, R0, xp):
    """Per-shard local encoding of GLOBAL neighbor codes embedded in the
    packed walk rows ([S*per, 4], shard s owns rows [s*per, (s+1)*per)):
    in-shard tets -> LOCAL ids, boundary codes (< 0) unchanged, remote
    tets -> ``-(R0+1+g)``.  ``xp`` is numpy (partition time) or jnp
    (device-side geometry refresh); both produce bit-identical f32-exact
    codes (needs ``R0 + 1 + n_tets < 2**24``)."""
    n = nbr.shape[0]
    lo = (xp.arange(n, dtype=nbr.dtype) // per * per)[:, None]
    in_sh = (nbr >= lo) & (nbr < lo + per)
    return xp.where(
        in_sh, nbr - lo, xp.where(nbr < 0, nbr, -(R0 + 1 + nbr))
    )


def partition_mesh(mesh: TetMesh, n_shards: int,
                   layout: str = "tet") -> PartitionedMesh:
    """Slab-partition along the longest bounding-box axis.

    ``layout``: "tet" slices the 20-col TetVelocity walk rows, "pk" the
    29-col VertexVelocity rows (A/Tinv prefix identical; velocity payload
    is the 4 cached vertex velocities, blended per step), "cx" the 24-col
    ConvexPoly rows (inward planes 0:16, neighbor codes 16:20, per-tet
    velocity 20:23 — the fused_convex.cx_table layout)."""
    from .. import mesh as meshlib

    pts = meshlib.host_np(mesh, "points", np.float64)
    tets = meshlib.host_np(mesh, "tets")
    cen = pts[tets].mean(axis=1)
    extent = (meshlib.host_np(mesh, "bounds_hi", np.float64)
              - meshlib.host_np(mesh, "bounds_lo", np.float64))
    axis = int(np.argmax(extent))
    order = np.argsort(cen[:, axis], kind="stable")     # old ids in new order
    nt = len(order)
    per = -(-nt // n_shards)
    pad = per * n_shards - nt

    inv_perm = order.astype(np.int32)                   # new -> old
    perm = np.empty(nt, np.int32)                       # old -> new
    perm[order] = np.arange(nt, dtype=np.int32)

    if layout == "pk":
        if mesh.tet_row_pk is None:
            raise ValueError("pk layout needs mesh.tet_row_pk (with_pk_rows)")
        src = meshlib.host_np(mesh, "tet_row_pk")       # [nt,29]
    elif layout == "cx":
        if mesh.tet_row_cx is None:
            raise ValueError("cx layout needs mesh.tet_row_cx "
                             "(with_convex_rows)")
        cx = meshlib.host_np(mesh, "tet_row_cx")
        src = np.concatenate([
            cx[:, 0:20],
            meshlib.host_np(mesh, "tet_vel", cx.dtype),
            np.zeros((len(cx), 1), cx.dtype),
        ], axis=1)                                       # [nt,24]
    else:
        src = meshlib.host_np(mesh, "tet_row")          # [nt,20]
    w = src.shape[1]
    row = src[inv_perm]
    nbr_old = meshlib.host_np(mesh, "tet_nbr")[inv_perm]  # [nt,4] old codes
    nbr = np.where(nbr_old >= 0, perm[np.clip(nbr_old, 0, nt - 1)], nbr_old)
    row = row.copy()
    nbr_col = {"pk": 24, "cx": 16, "tet": 15}[layout]

    if pad:
        # padding tets: self-contained dummies (all-boundary) never reached
        prow = np.zeros((pad, w), row.dtype)
        prow[:, 3] = prow[:, 7] = prow[:, 11] = 1.0      # identity Tinv
        row = np.concatenate([row, prow])
        nbr = np.concatenate([nbr, np.full((pad, 4), -1, np.int32)])

    bd_esc = meshlib.host_np(mesh, "bd_escape")
    if bd_esc.size == 0:
        bd_esc = np.zeros(1, bool)
    # embed LOCALLY-ENCODED neighbor codes in the packed rows, hoisting
    # the cached shard cycle's per-cycle re-encode (a full-table copy per
    # sub-step) to partition time: in-shard neighbors as LOCAL ids,
    # boundary codes unchanged, remote tets as -(R0+1+g) — the encoding
    # _make_run_lanes_remote / the inline hop classify consume.  The raw
    # GLOBAL codes stay in ``tet_nbr`` (the convex tracer and migration
    # need them).
    row[:, nbr_col : nbr_col + 4] = _encode_local_nbr(
        nbr, per, bd_esc.shape[0], np
    ).astype(row.dtype)
    return PartitionedMesh(
        tet_row=jnp.asarray(row.reshape(n_shards, per, w)),
        tet_nbr=jnp.asarray(nbr.reshape(n_shards, per, 4), jnp.int32),
        perm=jnp.asarray(perm),
        inv_perm=jnp.asarray(inv_perm),
        bd_escape=jnp.asarray(bd_esc),
        n_shards=n_shards,
        tets_per_shard=per,
        n_tets=nt,
    )


def update_velocity(
    pm: PartitionedMesh, tet_vel, vert_vel=None, tets=None
) -> PartitionedMesh:
    """Refresh the velocity columns of the partitioned walk rows from
    GLOBAL (old-numbering) velocity arrays — the coupled/replay drivers'
    per-Eulerian-interval U refresh (``advect.H:44-83``) without
    re-partitioning.  TetVelocity (20-col) and convex (24-col) rows take
    the per-tet ``tet_vel``; pk (29-col) rows take ``vert_vel`` + the
    global ``tets`` connectivity (v0..v3 at row cols 12:24)."""
    import dataclasses

    if pm.tet_row.shape[-1] == 29:                       # pk layout
        if vert_vel is None or tets is None:
            raise ValueError(
                "pk-row velocity refresh needs vert_vel and tets"
            )
        tv = (
            jnp.asarray(vert_vel, pm.tet_row.dtype)[jnp.asarray(tets)]
            .reshape(-1, 12)[pm.inv_perm]
        )
        u0, uw = 12, 12
    else:
        if pm.tet_row.shape[-1] == 20:
            u0 = 12
        elif pm.tet_row.shape[-1] == 24:
            u0 = 20                                      # cx layout
        else:
            raise NotImplementedError(
                f"velocity refresh on {pm.tet_row.shape[-1]}-col rows"
            )
        tv = jnp.asarray(tet_vel, pm.tet_row.dtype)[pm.inv_perm]
        uw = 3
    total = pm.n_shards * pm.tets_per_shard
    pad = total - pm.n_tets
    if pad:
        tv = jnp.concatenate([tv, jnp.zeros((pad, uw), tv.dtype)])
    row = pm.tet_row.at[:, :, u0 : u0 + uw].set(
        tv.reshape(pm.n_shards, pm.tets_per_shard, uw)
    )
    return dataclasses.replace(pm, tet_row=row)


def refresh_geometry(pm: PartitionedMesh, mesh: TetMesh,
                     layout: str = "tet") -> PartitionedMesh:
    """Rebuild the per-shard geometry tables from a MOVED mesh without
    re-partitioning — the dynamic-mesh analog of :func:`update_velocity`.

    Mesh motion (rigid / Laplacian point motion, no topology changes)
    keeps tet ids and adjacency; the slab assignment stays pinned to the
    original decomposition so every shape (and therefore the compiled
    step functions and all particle tet ids) survives.  Only the row
    CONTENTS change: A/Tinv (or convex planes/offsets) come from the new
    point positions, velocities from the refreshed fields; neighbor codes
    are re-embedded from the existing partition.  All device-side array
    math — a moved mesh's tables are device-recomputed
    (mesh.refresh_geometry) and must not be read back per Eulerian step."""
    S, per = pm.n_shards, pm.tets_per_shard
    nt = pm.n_tets
    if layout == "pk":
        if mesh.tet_row_pk is None:
            raise ValueError("pk layout needs mesh.tet_row_pk (with_pk_rows)")
        src = mesh.tet_row_pk
    elif layout == "cx":
        if mesh.tet_row_cx is None:
            raise ValueError("cx layout needs mesh.tet_row_cx "
                             "(with_convex_rows)")
        cx = mesh.tet_row_cx
        src = jnp.concatenate([
            cx[:, 0:20],
            mesh.tet_vel.astype(cx.dtype),
            jnp.zeros((cx.shape[0], 1), cx.dtype),
        ], axis=1)
    else:
        src = mesh.tet_row
    w = src.shape[1]
    if w != pm.tet_row.shape[-1]:
        raise ValueError(
            f"geometry refresh changed the row width ({pm.tet_row.shape[-1]}"
            f" -> {w}); the partition layout must stay fixed"
        )
    row = src[pm.inv_perm]
    pad = S * per - nt
    if pad:
        prow = jnp.zeros((pad, w), row.dtype)
        prow = prow.at[:, 3].set(1.0).at[:, 7].set(1.0).at[:, 11].set(1.0)
        row = jnp.concatenate([row, prow])
    bd_esc = mesh.bd_escape
    if bd_esc.size == 0:
        bd_esc = jnp.zeros(1, bool)
    nbr_col = {"pk": 24, "cx": 16, "tet": 15}[layout]
    row = row.at[:, nbr_col : nbr_col + 4].set(
        _encode_local_nbr(
            pm.tet_nbr.reshape(-1, 4), per, bd_esc.shape[0], jnp
        ).astype(row.dtype)
    )
    return dataclasses.replace(
        pm,
        tet_row=row.reshape(S, per, w),
        bd_escape=jnp.asarray(bd_esc),
    )


def distribute_particles(
    pm: PartitionedMesh, pos, vel, tet_old, active, rng_key=None,
    slack: float = 2.0, capacity: int | None = None, step=0,
) -> ShardedParticles:
    """Host-side: route particles to the shard owning their tet.

    ``capacity`` pins the per-shard slot count (re-distribution into an
    existing engine must keep the compiled shapes); ``step`` carries the
    cycle counter across a re-distribution (Brownian streams are keyed by
    (step, global pid), so redistributed particles keep their noise)."""
    S, per = pm.n_shards, pm.tets_per_shard
    pos = np.asarray(pos)
    vel = np.asarray(vel)
    tet_old = np.asarray(tet_old)
    active = np.asarray(active)
    n = len(pos)
    perm = np.asarray(pm.perm)
    tet_new = np.where(tet_old >= 0, perm[np.clip(tet_old, 0, pm.n_tets - 1)], tet_old)
    dest = np.clip(np.where(tet_new >= 0, tet_new // per, 0), 0, S - 1)
    # capacity covers the worst-loaded shard at seeding (a small seeding box
    # can land every particle in one slab) plus migration slack
    max_load = int(np.bincount(dest, minlength=S).max()) if n else 0
    cap = max(int(n / S * slack), int(max_load * 1.25) + 1, 64)
    cap = -(-cap // 8) * 8      # BLOCK multiple: the mega-resident runner
    #                             carries slots directly in engine blocks
    if capacity is not None:
        if max_load > capacity:
            raise ValueError(
                f"shard capacity {capacity} exceeded at re-distribution "
                f"(worst shard holds {max_load}); rebuild the engine with "
                f"a larger slack"
            )
        cap = capacity

    out = ShardedParticles(
        pos=jnp.zeros((S, cap, 3), jnp.asarray(pos).dtype),
        vel=jnp.zeros((S, cap, 3), jnp.asarray(pos).dtype),
        disp=jnp.zeros((S, cap, 3), jnp.asarray(pos).dtype),
        tet=jnp.full((S, cap), -1, jnp.int32),
        active=jnp.zeros((S, cap), bool),
        resident=jnp.zeros((S, cap), bool),
        pid=jnp.full((S, cap), -1, jnp.int32),
        rng_key=rng_key if rng_key is not None else jax.random.PRNGKey(0),
        step=jnp.asarray(step, jnp.int32),
        n_shards=S,
        capacity=cap,
    )
    ppos = np.zeros((S, cap, 3))
    pvel = np.zeros((S, cap, 3))
    ptet = np.full((S, cap), -1, np.int32)
    pact = np.zeros((S, cap), bool)
    pres = np.zeros((S, cap), bool)
    ppid = np.full((S, cap), -1, np.int32)
    if n:
        if max_load > cap:
            raise ValueError("shard capacity exceeded at distribution")
        # vectorized placement, same order as the per-particle loop:
        # stable ascending pid within each shard
        order = np.argsort(dest, kind="stable")
        ds = dest[order]
        starts = np.searchsorted(ds, np.arange(S))
        k = np.arange(n, dtype=np.int64) - starts[ds]
        ppos[ds, k] = pos[order]
        pvel[ds, k] = vel[order]
        ptet[ds, k] = tet_new[order]
        pact[ds, k] = active[order]
        pres[ds, k] = True
        ppid[ds, k] = order
    return dataclasses.replace(
        out,
        pos=jnp.asarray(ppos, out.pos.dtype),
        vel=jnp.asarray(pvel, out.pos.dtype),
        tet=jnp.asarray(ptet),
        active=jnp.asarray(pact),
        resident=jnp.asarray(pres),
        pid=jnp.asarray(ppid),
    )


def collect_particles(pm: PartitionedMesh, sp: ShardedParticles, n_particles: int):
    """Host-side: gather shards back into globally-ordered arrays."""
    pos = np.zeros((n_particles, 3))
    vel = np.zeros((n_particles, 3))
    tet = np.full(n_particles, -1, np.int32)
    act = np.zeros(n_particles, bool)
    pids = np.asarray(sp.pid)
    res = np.asarray(sp.resident)
    inv = np.asarray(pm.inv_perm)
    ppos, pvel, ptet, pact = (
        np.asarray(sp.pos), np.asarray(sp.vel), np.asarray(sp.tet),
        np.asarray(sp.active),
    )
    for s in range(sp.n_shards):
        sel = res[s]
        ids = pids[s][sel]
        pos[ids] = ppos[s][sel]
        vel[ids] = pvel[s][sel]
        t = ptet[s][sel]
        # map BOTH hosting tets and -(tet+1) out-of-domain codes back to
        # the original numbering (escape/wall codes carry a tet id too)
        neg = t < 0
        t_new = np.where(neg, -t - 1, t)
        t_old = inv[np.clip(t_new, 0, pm.n_tets - 1)]
        tet[ids] = np.where(neg, -(t_old + 1), t_old)
        act[ids] = pact[s][sel]
    return pos, vel, tet, act


# ---------------------------------------------------------------------------
# per-shard cycle (inside shard_map)
# ---------------------------------------------------------------------------


def _make_run_lanes_remote(mesh_view, tab, cfg, ly, R0, per):
    """Arena lane resolver for partitioned shards: the standard walk +
    reflect (``fused._make_run_lanes``), except an exit through a
    remote-encoded neighbor code (< -R0) PAUSES the lane for migration --
    its mega tet becomes the sentinel ``-(per + g + 1)`` holding the
    global target tet g, decoded by :func:`_local_cycle_cached`."""
    from ..ops import fused

    P0, TET = fused.P0, fused.TET

    def run_lanes(mc, lanes_act):
        qx, qy, qz = mc[:, P0], mc[:, P0 + 1], mc[:, P0 + 2]
        mc2, code, slot = fused._walk_mega(
            tab, mc, qx, qy, qz, lanes_act, ly, cfg.max_hops
        )
        # classify walk exits: boundary wall vs remote shard
        exit_code = fused._pick4(mc2, ly.rn, slot).astype(jnp.int32)
        outm = lanes_act & (code < 0)
        rem = outm & (exit_code < -R0)
        gid = -exit_code - R0 - 1
        wall = outm & ~rem
        if cfg.reflect_wall:
            def do_reflect(args):
                mc2_, code_, slot_ = args
                return fused._reflect_mega(
                    mesh_view, tab, mc2_, qx, qy, qz, code_, slot_, wall,
                    ly, cfg.max_bounces, remote=(R0, per),
                )

            def no_reflect(args):
                mc2_, code_, slot_ = args
                return mc2_, qx, qy, qz, code_

            mc3, rx, ry, rz, tet_f = lax.cond(
                jnp.any(wall), do_reflect, no_reflect, (mc2, code, slot)
            )
        else:
            mc3, rx, ry, rz, tet_f = mc2, qx, qy, qz, code
        tet_f = jnp.where(rem, -(per + gid + 1), tet_f)
        upd = lanes_act
        mc3 = mc3.at[:, P0].set(jnp.where(upd, rx, mc3[:, P0]))
        mc3 = mc3.at[:, P0 + 1].set(jnp.where(upd, ry, mc3[:, P0 + 1]))
        mc3 = mc3.at[:, P0 + 2].set(jnp.where(upd, rz, mc3[:, P0 + 2]))
        mc3 = mc3.at[:, TET].set(
            jnp.where(upd, tet_f, mc3[:, TET].astype(jnp.int32)).astype(
                mc3.dtype
            )
        )
        return mc3

    return run_lanes


class _CachedCtx:
    """Per-shard cached-engine context shared by the per-cycle path and
    the mega-resident runner: locally-encoded walk table, engine view,
    inner cfg, and the remote-pausing rare-stage resolver."""

    __slots__ = ("tab", "mesh_view", "cfg", "cfg2", "ly", "run_lanes",
                 "R0", "per")

    def __init__(self, rows, bd_esc, per, cfg, fdt):
        import dataclasses as _dc

        from types import SimpleNamespace

        from ..ops import fused

        R0 = bd_esc.shape[0]
        w = rows.shape[1]
        ly = (fused.LAYOUT_PK if w == fused.LAYOUT_PK.row_w
              else fused.LAYOUT_TET)
        tab = rows                  # neighbor codes pre-encoded per shard
        self.tab, self.ly, self.R0, self.per, self.cfg = tab, ly, R0, per, cfg
        self.mesh_view = SimpleNamespace(
            tet_row=tab if ly is fused.LAYOUT_TET else None,
            tet_row_pk=tab if ly is fused.LAYOUT_PK else None,
            bd_escape=bd_esc,
            n_bd_faces=R0,
            points=jnp.zeros((1, 3), fdt),
        )
        self.cfg2 = _dc.replace(
            cfg, inline_bounce=False, escape_faces=False,
            cycle_chunks=1, engine="cached", locate_mode="bary",
            integrator="euler",
        )
        self.run_lanes = _make_run_lanes_remote(
            self.mesh_view, tab, self.cfg2, ly, R0, per
        )


def _cached_ctx(rows, bd_esc, per, cfg, fdt) -> _CachedCtx:
    return _CachedCtx(rows, bd_esc, per, cfg, fdt)


def _pid_noise(key, step, pid, cfg, fdt, padl=lambda x: x):
    """Brownian noise keyed by (run key, step, GLOBAL particle id):
    streams are stable across migrations and shard counts (a slot/shard
    keying changed a particle's stream whenever it migrated)."""
    if not cfg.use_brownian:
        return None
    kstep = jax.random.fold_in(key, step)
    ks = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        kstep, jnp.maximum(pid, 0)
    )
    xi = jax.vmap(lambda kk: jax.random.normal(kk, (3,), fdt))(ks)
    return padl(xi)


def _settle(ctx: _CachedCtx, m):
    """Settle migrated arrivals: hop-0 classify + rare stage with zero
    displacement (== the bespoke ``relocate(pos, tet, live)``).  A walk
    that crosses the slab face again pauses the lane once more."""
    from ..ops import fused

    n = m.shape[0]
    w4 = fused._bary4(m, fused.RA, m[:, 0], m[:, 1], m[:, 2])
    wmin = jnp.minimum(jnp.minimum(w4[0], w4[1]), jnp.minimum(w4[2], w4[3]))
    located = m[:, fused.TET] >= 0      # not escaped, not in flight
    pend0 = (m[:, fused.ACT] > 0.5) & located & (wmin < 0.0)
    return fused._rare_stage(
        ctx.mesh_view, ctx.tab, m, pend0, ctx.cfg2, ctx.ly, n,
        n // fused.BLOCK, ctx.ly.width, run_lanes=ctx.run_lanes,
    )


def _settle_and_cycle(ctx: _CachedCtx, m, noise, key, step, dt):
    """Settle migrated arrivals (:func:`_settle`), then run the standard
    cached advect/brownian/relocate cycle with the remote-pausing
    resolver."""
    from ..ops import fused

    m = _settle(ctx, m)
    if noise is None:
        noise = jnp.zeros((m.shape[0], 3), m.dtype)
    return fused._mega_cycle_aligned(
        ctx.mesh_view, m, key, step, ctx.cfg2, dt, noise=noise,
        run_lanes=ctx.run_lanes,
    )


# A lane whose path crosses the jagged slab boundary (slabs are cut by
# tet centroid) more than once in one sub-step is paused again by the
# settle walk on the far side.  Settle rounds hop it back and forth until
# it is located, so it never skips an advect.
MAX_SETTLE_ROUNDS = 8


def _local_cycle(rows, nbrs, bd_esc, shard_id, per, pos, vel, disp, tet,
                 act, res, pid, key, step, cfg, dt):
    """Shard-local sub-step; walks pause at remote neighbors (tet left as
    a remote GLOBAL id).  Dispatches to the ConvexPoly tracer when the
    rows carry the 24-col cx layout; bary/Pk layouts ride the CACHED mega
    engine (:func:`_local_cycle_cached`)."""
    if rows.shape[-1] == 24 and getattr(cfg, "locate_mode", "bary") == "convex":
        return _local_cycle_cx(
            rows, nbrs, bd_esc, shard_id, per, pos, vel, disp, tet, act,
            res, pid, key, step, cfg, dt
        )
    return _local_cycle_cached(
        rows, nbrs, bd_esc, shard_id, per, pos, vel, disp, tet, act,
        res, pid, key, step, cfg, dt
    )


def _local_cycle_cached(rows, nbrs, bd_esc, shard_id, per, pos, vel, disp,
                        tet, act, res, pid, key, step, cfg, dt):
    """Shard-local cycle on the CACHED mega engine (``ops/fused.py``) --
    the same row-cache + inline-hop + block-compacted rare stage as the
    single-device path.  Remote handling:

    * the slab's walk rows carry LOCALLY-ENCODED neighbor codes, embedded
      at partition/refresh time (:func:`_encode_local_nbr`): in-shard
      neighbors as LOCAL ids, boundary codes unchanged, remote tets as
      ``-(R0+1+g)`` (R0 = #boundary faces) -- the inline hop never steps
      them (code < 0) and the rare arena's :func:`_make_run_lanes_remote`
      pauses them with the sentinel tet ``-(per+g+1)``;
    * migrated arrivals are settled BEFORE the advect by a hop-0 classify
      + rare stage with zero displacement (identical math to the bespoke
      ``relocate(pos, tet, live)``), so trajectories match single-device;
    * Brownian noise stays keyed by (run key, step, GLOBAL particle id)
      -- migration- and shard-count-stable -- and enters the engine as
      its ``noise`` operand;
    * the inner cfg forces ``inline_bounce=False`` and ``escape_faces=False``
      (those inline branches would misread remote codes; walls + escapes
      ride the rare reflector, which is bit-identical per bounce).

    Needs ``per + n_tets < 2**24`` (sentinels are exact f32 ints -- the
    same bound as the engine's neighbor codes)."""
    from ..ops import fused

    lo = shard_id * per
    C = pos.shape[0]
    ctx = _cached_ctx(rows, bd_esc, per, cfg, pos.dtype)

    live = res & act & (tet >= lo) & (tet < lo + per)
    tl = jnp.where(live, tet - lo, 0)
    npad = (-C) % fused.BLOCK

    def padl(x):
        return jnp.pad(
            x, ((0, npad),) + ((0, 0),) * (x.ndim - 1)
        ) if npad else x

    m = fused.pack_state(
        ctx.mesh_view, padl(pos), padl(vel), padl(tl), padl(live), ctx.ly
    )
    noise = _pid_noise(key, step, pid, cfg, pos.dtype, padl)
    m = _settle_and_cycle(ctx, m, noise, key, step, dt)

    pos2, vel2, tl2, _ = fused.unpack_state(m[:C])
    settled = tl2 >= 0
    escaped = (tl2 < 0) & (tl2 >= -per)
    tet_g = jnp.where(
        settled, tl2 + lo,
        jnp.where(escaped, tl2 - lo, -tl2 - per - 1),
    )
    act_m_out = m[:C, fused.ACT] > 0.5
    pos = jnp.where(live[:, None], pos2, pos)
    vel = jnp.where(live[:, None], vel2, vel)
    tet_out = jnp.where(live, tet_g, tet)
    act_out = jnp.where(live, act_m_out, act)
    if cfg.use_advection:
        # advect kill (pre-cycle tet: escapes from THIS cycle die next
        # cycle, like the single-device engine)
        act_out = act_out & ((tet >= 0) | ~res)
    return pos, vel, jnp.zeros_like(pos), tet_out, act_out


def _local_cycle_cx(rows, nbrs, bd_esc, shard_id, per, pos, vel, disp, tet,
                    act, res, pid, key, step, cfg, dt):
    """ConvexPoly (segment-tracing) shard-local cycle.

    Mirrors the single-device convex path (``ops.convex.trace_segment`` +
    ``convex_reflect``): each tet's exit face comes from
    ``_exit_face_tables`` on the cached inward planes, with the inlet face
    suppressed by its came-from neighbor code.  A hop into a remote tet
    PAUSES the trace: the lane keeps its march point in ``pos`` and the
    unconsumed remainder in ``disp``, migrates, and the destination shard
    settles it next cycle (the convex analog of the bary walk handoff).
    Escape patches deactivate in the bounce loop; the single-device
    ``convex_bary_fix`` pass is not applied here (it needs the bary
    tables) — compare against ``convex_bary_fix=False`` runs.
    """
    from ..ops import convex as convex_ops

    lo = shard_id * per
    n_bd = bd_esc.shape[0]
    in_shard = lambda g: (g >= lo) & (g < lo + per)
    lane = jnp.arange(pos.shape[0])
    NO_INLET = jnp.int32(-(2 ** 30))

    def local_rows(g):
        return rows[jnp.clip(g - lo, 0, per - 1)]

    def local_nbr(g):
        return nbrs[jnp.clip(g - lo, 0, per - 1)]

    def trace(p0, p_end, tet0, act_mask):
        """March p0 -> p_end; pauses at remote hops and walls.
        Returns (p0', tet', wall_mask, wall_slot, remote_mask)."""

        def cond(c):
            p0, tet, inlet, done, wall, slot_w, i = c
            return (i < cfg.max_hops) & ~jnp.all(done)

        def body(c):
            p0, tet, inlet, done, wall, slot_w, i = c
            rl = local_rows(jnp.maximum(tet, 0))
            nrm = rl[:, 0:12].reshape(-1, 4, 3)
            dpl = rl[:, 12:16]
            nbr4 = local_nbr(jnp.maximum(tet, 0))
            dt_, slot = convex_ops._exit_face_tables(
                nrm, dpl, nbr4, p0, p_end - p0, nbr4 == inlet[:, None]
            )
            stepping = (~done) & (slot >= 0)
            code = nbr4[lane, jnp.maximum(slot, 0)]
            p0 = jnp.where(
                stepping[:, None], p0 + dt_[:, None] * (p_end - p0), p0
            )
            wall_new = stepping & (code < 0)
            remote = stepping & (code >= 0) & ~in_shard(code)
            moved = stepping & (code >= 0)
            inlet = jnp.where(moved, tet, inlet)
            tet = jnp.where(moved, code, tet)
            slot_w = jnp.where(wall_new, slot, slot_w)
            done = done | ((~done) & (slot < 0)) | wall_new | remote
            wall = wall | wall_new
            return p0, tet, inlet, done, wall, slot_w, i + 1

        done0 = (~act_mask) | (tet0 < 0) | ~in_shard(tet0)
        c = (p0, tet0, jnp.full_like(tet0, NO_INLET), done0,
             jnp.zeros_like(done0), jnp.zeros_like(tet0), jnp.zeros((), jnp.int32))
        p0, tet2, _, done, wall, slot_w, _ = lax.while_loop(cond, body, c)
        remote = act_mask & (tet2 >= 0) & ~in_shard(tet2) & ~wall
        return p0, tet2, wall & act_mask, slot_w, remote

    def resolve(p_start, dvec, tet0, act_mask, vel):
        """Trace + reflect (<= max_bounces mirrors, re-tracing after each,
        ConvexQuery.cu:320-436 semantics).  Returns
        (pos, disp_remaining, tet, vel, killed)."""
        p_end = p_start + dvec
        p0, tet2, wall, slot_w, remote = trace(p_start, p_end, tet0, act_mask)
        killed = jnp.zeros_like(act_mask)

        def rcond(c):
            p0, p_end, tet2, wall, slot_w, remote, vel, killed, b = c
            return (b < convex_ops.MAX_BOUNCES) & jnp.any(wall)

        def rbody(c):
            p0, p_end, tet2, wall, slot_w, remote, vel, killed, b = c
            rl = local_rows(jnp.maximum(tet2, 0))
            nbr4 = local_nbr(jnp.maximum(tet2, 0))
            code_w = nbr4[lane, jnp.maximum(slot_w, 0)]
            bd = jnp.clip(-code_w - 1, 0, n_bd - 1)
            esc = wall & (code_w < 0) & bd_esc[bd]
            tet2 = jnp.where(esc, -(tet2 + 1), tet2)
            killed = killed | esc
            refl = wall & ~esc
            # mirror segment end + velocity across the hit face plane
            # (convex_ops.convex_reflect's mirror expressions)
            nsel = rl[:, 0:12].reshape(-1, 4, 3)[lane, jnp.maximum(slot_w, 0)]
            dsel = rl[:, 12:16][lane, jnp.maximum(slot_w, 0)]
            pe = p_end - 2.0 * (
                jnp.sum(p_end * nsel, -1) - dsel
            )[:, None] * nsel
            un = vel - 2.0 * jnp.sum(vel * nsel, -1)[:, None] * nsel
            p_end = jnp.where(refl[:, None], pe, p_end)
            vel = jnp.where(refl[:, None], un, vel)
            # re-trace the mirrored remainder from the hit point
            p0n, tetn, walln, slotn, remoten = trace(
                p0, p_end, jnp.maximum(tet2, 0), refl
            )
            p0 = jnp.where(refl[:, None], p0n, p0)
            tet2 = jnp.where(refl, tetn, tet2)
            slot_w = jnp.where(refl, slotn, slot_w)
            remote = jnp.where(refl, remoten, remote)
            wall = refl & walln
            return p0, p_end, tet2, wall, slot_w, remote, vel, killed, b + 1

        p0, p_end, tet2, wall, slot_w, remote, vel, killed, _ = lax.while_loop(
            rcond, rbody,
            (p0, p_end, tet2, wall, slot_w, remote, vel, killed,
             jnp.zeros((), jnp.int32)),
        )
        settled = act_mask & ~remote & ~killed
        pos_new = jnp.where(settled[:, None], p_end,
                            jnp.where(remote[:, None], p0, p_start))
        disp_new = jnp.where(remote[:, None], p_end - p0, 0.0)
        return pos_new, disp_new, tet2, vel, killed

    # --- settle migrated arrivals: consume their pending displacement ---
    pend = (
        res & act & (tet >= 0) & in_shard(tet)
        & jnp.any(disp != 0.0, axis=1)
    )
    pos_s, disp_s, tet_s, vel_s, kill_s = resolve(pos, disp, tet, pend, vel)
    pos = jnp.where(pend[:, None], pos_s, pos)
    disp = jnp.where(pend[:, None], disp_s, disp)
    tet = jnp.where(pend, tet_s, tet)
    vel = jnp.where(pend[:, None], vel_s, vel)
    act = act & ~kill_s

    # --- advect + brownian (reference cycle; skip lanes still in limbo) ---
    live = (
        res & act & (tet >= 0) & in_shard(tet)
        & ~jnp.any(disp != 0.0, axis=1)
    )
    row = local_rows(jnp.maximum(tet, 0))
    u = row[:, 20:23]
    if cfg.use_advection:
        vel = jnp.where(live[:, None], u, vel)
        dnew = jnp.where(live[:, None], u * dt, 0.0)
    else:
        dnew = jnp.zeros_like(pos)
    if cfg.use_brownian:
        kstep = jax.random.fold_in(key, step)
        ks = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
            kstep, jnp.maximum(pid, 0)
        )
        xi = jax.vmap(lambda kk: jax.random.normal(kk, (3,), pos.dtype))(ks)
        sigma = jnp.sqrt(2.0 * cfg.diffusion_coeff * dt).astype(pos.dtype)
        dnew = dnew + jnp.where(live[:, None], sigma * xi, 0.0)
    if cfg.use_advection:
        act = act & ((tet >= 0) | ~res)

    pos_n, disp_n, tet_n, vel_n, kill_n = resolve(pos, dnew, tet, live, vel)
    pos = jnp.where(live[:, None], pos_n, pos)
    disp = jnp.where(live[:, None], disp_n, disp)
    tet = jnp.where(live, tet_n, tet)
    vel = jnp.where(live[:, None], vel_n, vel)
    act = act & ~kill_n
    return pos, vel, disp, tet, act


def _migrate(pos, vel, disp, tet, act, res, pid, shard_id, per, n_shards,
             cap_out):
    """Fixed-capacity ``all_to_all`` exchange of lanes owned by other shards.

    Loss-free: senders respect a per-destination quota derived from an
    all-gathered free-slot count (quota = free // S, so concurrent senders
    can never overflow a receiver).  Lanes over quota stay resident and
    retry next cycle ("in limbo": they idle, since their tet is remote)."""
    S = n_shards
    dest = jnp.where((tet >= 0) & res, tet // per, shard_id)
    leaving = res & (dest != shard_id)

    # 2-phase admission: (1) exchange per-destination request counts,
    # (2) each receiver waterfills its free slots over the requesting
    # senders (deterministic source order) and returns exact grants, so
    # transfers never overflow and capacity is fully utilized.
    onehot_req = (dest[:, None] == jnp.arange(S)[None, :]) & leaving[:, None]
    req = jnp.sum(onehot_req.astype(jnp.int32), axis=0)    # [S] my requests per dst
    req_in = lax.all_to_all(req, "s", split_axis=0, concat_axis=0)  # [S] per src
    my_free = jnp.sum((~res).astype(jnp.int32))
    cum_prev = jnp.cumsum(req_in) - req_in
    admit = jnp.clip(my_free - cum_prev, 0, req_in)        # [S] grant per src
    grant = lax.all_to_all(admit, "s", split_axis=0, concat_axis=0)  # [S] per dst

    # pack per destination: slot = rank of lane among its dest group
    payload = jnp.concatenate(
        [pos, vel, disp, tet[:, None].astype(pos.dtype),
         act[:, None].astype(pos.dtype),
         pid[:, None].astype(pos.dtype)], axis=1
    )                                                     # [C, 12]
    W = payload.shape[1]
    C = pos.shape[0]
    # rank within destination group via segment cumsum
    onehot = (dest[:, None] == jnp.arange(S)[None, :]) & leaving[:, None]
    ranks = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - 1   # [C, S]
    lane_rank = jnp.sum(jnp.where(onehot, ranks, 0), axis=1)
    fits = leaving & (lane_rank < cap_out) & (
        lane_rank < grant[jnp.clip(dest, 0, S - 1)]
    )
    # build the send buffer by SORT + GATHER, not row scatter: a row
    # scatter of C payload rows into the [S, cap_out, W] buffer pays per
    # index and per row; a stable group-by-destination sort (lexicographic
    # (key, lane) = stable by construction) + a cap_out-row gather does the
    # same packing at the table-gather rate.  Sort order == cumsum rank
    # order, so the packed slots are bit-identical to the scatter version.
    key = jnp.where(fits, dest, S).astype(jnp.int32)
    lane_iota = lax.broadcasted_iota(jnp.int32, (C, 1), 0)[:, 0]
    _, perm_sorted = lax.sort((key, lane_iota), dimension=0, num_keys=2)
    sent = jnp.minimum(grant, cap_out)                    # grant <= req
    offset = jnp.cumsum(sent) - sent                      # [S] group starts
    r_io = lax.broadcasted_iota(jnp.int32, (S, cap_out), 1)
    src = perm_sorted[
        jnp.clip(offset[:, None] + r_io, 0, C - 1)
    ].reshape(-1)                                         # [S*cap_out]
    valid_s = (r_io < sent[:, None]).reshape(-1)
    rows_g = payload[src]                                 # gather, not scatter
    send = jnp.where(
        valid_s[:, None], rows_g, 0.0
    ).reshape(S, cap_out, W)

    # exchange over the shard axis
    recv = lax.all_to_all(send, "s", split_axis=0, concat_axis=0, tiled=False)
    # recv: [S, cap_out, W] — chunks from every source shard
    recv = recv.reshape(S * cap_out, W)

    # drop sent lanes locally (only those that fit)
    res = res & ~fits

    # place received into free slots (guaranteed to fit by the quota):
    # MERGE-BY-GATHER, not scatter (seven per-array scatters, or one
    # merged-row scatter into a [C, W+1] staging buffer that XLA may lay
    # out column-major, so row scatters go lane by lane).  Free slot #k
    # GATHERs valid recv row #k instead; and since
    # the 2-phase admission pins the valid-row count of source chunk s
    # to exactly min(admit[s], cap_out), row #k is found by a cumsum
    # search over the S chunk counts — no validity sort, no validity
    # channel in the payload.
    chunk_n = jnp.minimum(admit, cap_out)                  # [S] rows per src
    cum = jnp.cumsum(chunk_n)
    n_recv = cum[S - 1]
    free = ~res
    fs_rank = jnp.cumsum(free.astype(jnp.int32)) - 1       # [C]
    placed = free & (fs_rank < n_recv)
    k = jnp.clip(fs_rank, 0, jnp.maximum(n_recv - 1, 0))
    s_of_k = jnp.sum((k[:, None] >= cum[None, :]).astype(jnp.int32), axis=1)
    base = jnp.where(s_of_k > 0, cum[jnp.clip(s_of_k - 1, 0, S - 1)], 0)
    recv_idx = s_of_k * cap_out + (k - base)
    staged = recv[jnp.where(placed, recv_idx, 0)]          # [C, W]
    pm3 = placed[:, None]
    pos = jnp.where(pm3, staged[:, 0:3], pos)
    vel = jnp.where(pm3, staged[:, 3:6], vel)
    disp = jnp.where(pm3, staged[:, 6:9], disp)
    tet = jnp.where(placed, staged[:, 9].astype(jnp.int32), tet)
    act = jnp.where(placed, staged[:, 10] > 0.5, act)
    pid = jnp.where(placed, staged[:, 11].astype(jnp.int32), pid)
    res = res | placed
    deferred = jnp.sum((leaving & ~fits).astype(jnp.int32))
    migrated = jnp.sum(fits.astype(jnp.int32))
    return pos, vel, disp, tet, act, res, pid, migrated, deferred


def _migrate_mega(ctx: _CachedCtx, m, act, res, pid, shard_id, per, n_shards,
                  cap_out):
    """:func:`_migrate` on resident MEGA rows (the mega-resident runner's
    exchange): payload is the mega state prefix ``[P0|V0|global tet|act]``
    plus two f32-exact 16-bit pid halves; arrival rows are re-packed
    against the DESTINATION shard's walk table (one cap_out-row table
    gather) before the merge-by-gather placement, so the carried mega
    never needs a full re-pack.  Also zeroes the mega ACT column of every
    remote-coded lane (sent slots become free; deferred lanes idle in
    limbo until a later round admits them)."""
    from ..ops import fused

    S = n_shards
    P0, V0, TET, ACT, ROW = fused.P0, fused.V0, fused.TET, fused.ACT, fused.ROW
    C = m.shape[0]
    fdt = m.dtype
    lo = shard_id * per

    tl = m[:, TET].astype(jnp.int32)
    leaving = res & (tl < -per)
    g = -tl - per - 1
    dest = jnp.where(leaving, g // per, shard_id)

    # 2-phase admission (identical to _migrate)
    onehot = (dest[:, None] == jnp.arange(S)[None, :]) & leaving[:, None]
    req = jnp.sum(onehot.astype(jnp.int32), axis=0)
    req_in = lax.all_to_all(req, "s", split_axis=0, concat_axis=0)
    my_free = jnp.sum((~res).astype(jnp.int32))
    cum_prev = jnp.cumsum(req_in) - req_in
    admit = jnp.clip(my_free - cum_prev, 0, req_in)
    grant = lax.all_to_all(admit, "s", split_axis=0, concat_axis=0)

    ranks = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - 1
    lane_rank = jnp.sum(jnp.where(onehot, ranks, 0), axis=1)
    fits = leaving & (lane_rank < cap_out) & (
        lane_rank < grant[jnp.clip(dest, 0, S - 1)]
    )

    # payload: the mega state prefix with TET rewritten to the GLOBAL
    # target and ACT to the authoritative side flag, plus pid halves
    # (pid up to 2**31 survives f32 transport as two 16-bit words)
    payload = jnp.concatenate(
        [
            m[:, :ROW]
            .at[:, TET].set(g.astype(fdt))
            .at[:, ACT].set(act.astype(fdt)),
            (pid & 0xFFFF).astype(fdt)[:, None],
            ((pid >> 16) & 0x7FFF).astype(fdt)[:, None],
        ],
        axis=1,
    )                                                      # [C, ROW+2]
    W = payload.shape[1]
    key = jnp.where(fits, dest, S).astype(jnp.int32)
    lane_iota = lax.broadcasted_iota(jnp.int32, (C, 1), 0)[:, 0]
    _, perm_sorted = lax.sort((key, lane_iota), dimension=0, num_keys=2)
    sent = jnp.minimum(grant, cap_out)
    offset = jnp.cumsum(sent) - sent
    r_io = lax.broadcasted_iota(jnp.int32, (S, cap_out), 1)
    src = perm_sorted[
        jnp.clip(offset[:, None] + r_io, 0, C - 1)
    ].reshape(-1)
    valid_s = (r_io < sent[:, None]).reshape(-1)
    send = jnp.where(
        valid_s[:, None], payload[src], 0.0
    ).reshape(S, cap_out, W)

    recv = lax.all_to_all(send, "s", split_axis=0, concat_axis=0,
                          tiled=False).reshape(S * cap_out, W)

    # sent slots become free; every remote-coded lane idles (ACT col 0)
    res = res & ~fits
    m = m.at[:, ACT].set(
        jnp.where(leaving, jnp.zeros((), fdt), m[:, ACT])
    )

    # re-pack arrivals against THIS shard's table (R-space), pid halves
    # riding the spare mega columns so ONE placement gather carries all
    rg = recv[:, TET].astype(jnp.int32)
    rtl = jnp.clip(rg - lo, 0, per - 1)
    arr = jnp.zeros((S * cap_out, ctx.ly.width), fdt)
    arr = arr.at[:, :ROW].set(recv[:, :ROW])
    arr = arr.at[:, TET].set(rtl.astype(fdt))
    arr = arr.at[:, ROW : ROW + ctx.ly.row_w].set(ctx.tab[rtl])
    spare = ROW + ctx.ly.row_w
    arr = arr.at[:, spare : spare + 2].set(recv[:, ROW : ROW + 2])

    chunk_n = jnp.minimum(admit, cap_out)
    cum = jnp.cumsum(chunk_n)
    n_recv = cum[S - 1]
    free = ~res
    fs_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    placed = free & (fs_rank < n_recv)
    k = jnp.clip(fs_rank, 0, jnp.maximum(n_recv - 1, 0))
    s_of_k = jnp.sum((k[:, None] >= cum[None, :]).astype(jnp.int32), axis=1)
    base = jnp.where(s_of_k > 0, cum[jnp.clip(s_of_k - 1, 0, S - 1)], 0)
    recv_idx = s_of_k * cap_out + (k - base)
    staged = arr[jnp.where(placed, recv_idx, 0)]           # [C, width]
    m = jnp.where(placed[:, None], staged, m)
    act = jnp.where(placed, staged[:, ACT] > 0.5, act)
    pid = jnp.where(
        placed,
        staged[:, spare].astype(jnp.int32)
        + (staged[:, spare + 1].astype(jnp.int32) << 16),
        pid,
    )
    res = res | placed
    deferred = jnp.sum((leaving & ~fits).astype(jnp.int32))
    migrated = jnp.sum(fits.astype(jnp.int32))
    return m, act, res, pid, migrated, deferred


def _settle_rounds_mega(ctx: _CachedCtx, m, act, res, pid, shard_id, per,
                       n_shards, cap_out, moved, deferred):
    """Settle + migrate while the previous migration moved anyone on any
    shard: arrivals whose settle walk pauses at the slab face again hop
    on until every lane is located (deferred lanes wait in limbo for
    capacity).  Returns the new (m, act, res, pid), this shard's lanes
    migrated in the rounds and its deferred count after the last
    migration (``deferred`` when no round ran)."""
    i32 = jnp.int32

    def cond(c):
        *_, moved, r = c
        return (moved > 0) & (r < MAX_SETTLE_ROUNDS)

    def body(c):
        m, act, res, pid, mig, _, _, r = c
        m = _settle(ctx, m)
        m, act, res, pid, mg, df = _migrate_mega(
            ctx, m, act, res, pid, shard_id, per, n_shards, cap_out
        )
        mg, df = mg.astype(i32), df.astype(i32)
        return (m, act, res, pid, mig + mg, df, lax.psum(mg, "s"), r + 1)

    zero_here = jnp.sum(res.astype(i32)).astype(i32) * 0   # per-shard
    m, act, res, pid, mig, defr, *_ = lax.while_loop(
        cond, body,
        (m, act, res, pid, zero_here, deferred.astype(i32),
         lax.psum(moved.astype(i32), "s"), jnp.zeros((), i32)),
    )
    return m, act, res, pid, mig, defr


def make_partitioned_step(pm: PartitionedMesh, cfg: StepConfig, device_mesh: Mesh,
                          cap_out_frac: float = 0.25):
    """Build the jitted multi-device step: shard_map over the shard axis of
    (mesh slabs + particle slots), one cycle + one migration round, then
    settle rounds until no lane is left in flight."""
    S = pm.n_shards
    per = pm.tets_per_shard
    cfg_settle = dataclasses.replace(cfg, use_advection=False,
                                     use_brownian=False)

    def shard_body(rows, nbrs, bd_esc, pos, vel, disp, tet, act, res, pid,
                   key, step, dt):
        rows, nbrs = rows[0], nbrs[0]
        pos, vel, disp, tet, act, res, pid = (
            x[0] for x in (pos, vel, disp, tet, act, res, pid)
        )
        sid = lax.axis_index("s")
        pos, vel, disp, tet, act = _local_cycle(
            rows, nbrs, bd_esc, sid, per, pos, vel, disp, tet, act, res, pid,
            key, step, cfg, dt
        )
        cap_out = max(int(pos.shape[0] * cap_out_frac), 16)
        pos, vel, disp, tet, act, res, pid, migrated, dropped = _migrate(
            pos, vel, disp, tet, act, res, pid, sid, per, S, cap_out
        )

        # settle rounds: arrivals whose settle walk pauses at the slab
        # face again hop on until every lane is located
        def cond(c):
            *_, moved, r = c
            return (moved > 0) & (r < MAX_SETTLE_ROUNDS)

        def body(c):
            pos, vel, disp, tet, act, res, pid, mig, _, _, r = c
            pos, vel, disp, tet, act = _local_cycle(
                rows, nbrs, bd_esc, sid, per, pos, vel, disp, tet, act, res,
                pid, key, step, cfg_settle, jnp.zeros_like(dt)
            )
            pos, vel, disp, tet, act, res, pid, mg, drop = _migrate(
                pos, vel, disp, tet, act, res, pid, sid, per, S, cap_out
            )
            return (pos, vel, disp, tet, act, res, pid, mig + mg, drop,
                    lax.psum(mg, "s"), r + 1)

        (pos, vel, disp, tet, act, res, pid, migrated, dropped, _, _) = (
            lax.while_loop(cond, body, (
                pos, vel, disp, tet, act, res, pid, migrated, dropped,
                lax.psum(migrated, "s"), jnp.zeros((), jnp.int32),
            ))
        )
        return (
            pos[None], vel[None], disp[None], tet[None], act[None], res[None],
            pid[None], migrated[None], dropped[None],
        )

    spec_s = P("s")
    smapped = shard_map(
        shard_body,
        mesh=device_mesh,
        in_specs=(spec_s, spec_s, P()) + (spec_s,) * 7 + (P(), P(), P()),
        out_specs=(spec_s,) * 9,
    )

    @jax.jit
    def step(pmesh: PartitionedMesh, sp: ShardedParticles, dt):
        pos, vel, disp, tet, act, res, pid, migrated, dropped = smapped(
            pmesh.tet_row, pmesh.tet_nbr, pmesh.bd_escape,
            sp.pos, sp.vel, sp.disp, sp.tet, sp.active, sp.resident, sp.pid,
            sp.rng_key, sp.step, jnp.asarray(dt, sp.pos.dtype),
        )
        return (
            dataclasses.replace(
                sp, pos=pos, vel=vel, disp=disp, tet=tet, active=act,
                resident=res, pid=pid, step=sp.step + 1,
            ),
            {"migrated": jnp.sum(migrated), "deferred": jnp.sum(dropped)},
        )

    return step


def make_partitioned_runner(pm: PartitionedMesh, cfg: StepConfig,
                            device_mesh: Mesh, n_cycles: int,
                            cap_out_frac: float = 0.25):
    """``n_cycles`` partitioned steps in ONE jit (one dispatch instead of
    a Python step() loop).

    Bary/Pk layouts with BLOCK-aligned capacity ride the MEGA-RESIDENT
    scan (:func:`make_partitioned_runner_mega`): the packed mega carries
    across cycles, so the per-cycle full re-pack (a [C]-row table gather
    + state rebuild) disappears.  ConvexPoly (and
    unaligned capacities) fall back to a ``lax.scan`` over the per-cycle
    step; both produce bit-identical trajectories (pinned by
    ``test_partitioned_runner_matches_step_loop``)."""
    from ..ops import fused

    w = pm.tet_row.shape[-1]
    is_cx = w == 24 and getattr(cfg, "locate_mode", "bary") == "convex"
    impls = {}

    def run(pmesh: PartitionedMesh, sp: ShardedParticles, dt):
        use_mega = (not is_cx) and sp.capacity % fused.BLOCK == 0
        kind = "mega" if use_mega else "step"
        fn = impls.get(kind)
        if fn is None:
            fn = (
                make_partitioned_runner_mega if use_mega
                else _make_partitioned_runner_steps
            )(pm, cfg, device_mesh, n_cycles, cap_out_frac)
            impls[kind] = fn
        return fn(pmesh, sp, dt)

    return run


def _make_partitioned_runner_steps(pm: PartitionedMesh, cfg: StepConfig,
                                   device_mesh: Mesh, n_cycles: int,
                                   cap_out_frac: float = 0.25):
    step = make_partitioned_step(pm, cfg, device_mesh, cap_out_frac)

    @jax.jit
    def run(pmesh: PartitionedMesh, sp: ShardedParticles, dt):
        def body(s, _):
            s2, diag = step(pmesh, s, dt)
            return s2, jnp.stack([diag["migrated"], diag["deferred"]])

        sp2, md = lax.scan(body, sp, None, length=n_cycles)
        return sp2, {"migrated": jnp.sum(md[:, 0]),
                     "deferred": jnp.sum(md[:, 1])}

    return run


def make_partitioned_runner_mega(pm: PartitionedMesh, cfg: StepConfig,
                                 device_mesh: Mesh, n_cycles: int,
                                 cap_out_frac: float = 0.25):
    """Mega-resident ``n_cycles`` scan: encode every slot into the packed
    mega ONCE (settled lanes -> local tet, limbo lanes -> remote sentinel
    with mega ACT 0, escaped lanes -> shard-local escape code), run the
    settle+cycle core per scan iteration with migration exchanged
    directly on mega rows (:func:`_migrate_mega`), and decode back to
    slot arrays at the end.  Trajectory-identical to the per-cycle step
    loop; the ``active``/``resident``/``pid`` side arrays stay authoritative
    (the mega ACT column only gates the engine)."""
    from ..ops import fused

    S = pm.n_shards
    per = pm.tets_per_shard

    def shard_body(rows, nbrs, bd_esc, pos, vel, disp, tet, act, res, pid,
                   key, step0, dt):
        rows = rows[0]
        pos, vel, tet, act, res, pid = (
            x[0] for x in (pos, vel, tet, act, res, pid)
        )
        sid = lax.axis_index("s")
        lo = sid * per
        C = pos.shape[0]
        fdt = pos.dtype
        ctx = _cached_ctx(rows, bd_esc, per, cfg, fdt)
        cap_out = max(int(C * cap_out_frac), 16)
        P0, V0, TET, ACT, ROW = (
            fused.P0, fused.V0, fused.TET, fused.ACT, fused.ROW
        )

        in_sh = (tet >= lo) & (tet < lo + per)
        tl0 = jnp.where(
            ~res, 0,
            jnp.where(
                in_sh & (tet >= 0), tet - lo,
                jnp.where(tet >= 0, -(per + tet + 1), tet + lo),
            ),
        )
        live0 = res & act & in_sh & (tet >= 0)
        m = jnp.zeros((C, ctx.ly.width), fdt)
        m = m.at[:, P0 : P0 + 3].set(pos)
        m = m.at[:, V0 : V0 + 3].set(vel)
        m = m.at[:, TET].set(tl0.astype(fdt))
        m = m.at[:, ACT].set(live0.astype(fdt))
        m = m.at[:, ROW : ROW + ctx.ly.row_w].set(
            ctx.tab[jnp.clip(tl0, 0, per - 1)]
        )

        def body(carry, stepc):
            m, act, res, pid = carry
            pre_tl = m[:, TET].astype(jnp.int32)
            # a lane that ESCAPED last cycle keeps act until the advect
            # kill below, but must not advect or settle this cycle — the
            # per-cycle path's re-pack encodes exactly live = res & act &
            # in-shard; replicate by gating the carried ACT on tl >= 0
            live_pre = (m[:, ACT] > 0.5) & (pre_tl >= 0)
            m = m.at[:, ACT].set(
                jnp.where(live_pre, m[:, ACT], jnp.zeros((), m.dtype))
            )
            noise = _pid_noise(key, stepc, pid, cfg, m.dtype)
            if noise is None:
                noise = jnp.zeros((C, 3), m.dtype)
            m = fused._mega_cycle_aligned(
                ctx.mesh_view, m, key, stepc, ctx.cfg2, dt, noise=noise,
                run_lanes=ctx.run_lanes,
            )
            act = jnp.where(live_pre, m[:, ACT] > 0.5, act)
            if cfg.use_advection:
                # advect kill by PRE-cycle location: escaped-coded lanes
                # die, settled and limbo lanes live (== slot tet >= 0)
                act = act & ((pre_tl >= 0) | (pre_tl < -per) | ~res)
                m = m.at[:, ACT].set(m[:, ACT] * act.astype(m.dtype))
            m, act, res, pid, mig, defr = _migrate_mega(
                ctx, m, act, res, pid, sid, per, S, cap_out
            )
            # arrivals settle here, so every lane starts the next cycle
            # located (as after a per-cycle step)
            m, act, res, pid, mig_s, defr = _settle_rounds_mega(
                ctx, m, act, res, pid, sid, per, S, cap_out, mig, defr
            )
            return (m, act, res, pid), jnp.stack([mig + mig_s, defr])

        (m, act, res, pid), md = lax.scan(
            body, (m, act, res, pid),
            step0 + jnp.arange(n_cycles, dtype=jnp.int32),
        )

        pos2, vel2, tl2, _ = fused.unpack_state(m)
        settled = tl2 >= 0
        escaped = (tl2 < 0) & (tl2 >= -per)
        tet_g = jnp.where(
            settled, tl2 + lo,
            jnp.where(escaped, tl2 - lo, -tl2 - per - 1),
        )
        pos = jnp.where(res[:, None], pos2, pos)
        vel = jnp.where(res[:, None], vel2, vel)
        tet = jnp.where(res, tet_g, tet)
        return (
            pos[None], vel[None], jnp.zeros_like(pos)[None], tet[None],
            act[None], res[None], pid[None],
            jnp.sum(md[:, 0])[None], jnp.sum(md[:, 1])[None],
        )

    spec_s = P("s")
    smapped = shard_map(
        shard_body,
        mesh=device_mesh,
        in_specs=(spec_s, spec_s, P()) + (spec_s,) * 7 + (P(), P(), P()),
        out_specs=(spec_s,) * 9,
    )

    @jax.jit
    def run(pmesh: PartitionedMesh, sp: ShardedParticles, dt):
        pos, vel, disp, tet, act, res, pid, migrated, deferred = smapped(
            pmesh.tet_row, pmesh.tet_nbr, pmesh.bd_escape,
            sp.pos, sp.vel, sp.disp, sp.tet, sp.active, sp.resident, sp.pid,
            sp.rng_key, sp.step, jnp.asarray(dt, sp.pos.dtype),
        )
        return (
            dataclasses.replace(
                sp, pos=pos, vel=vel, disp=disp, tet=tet, active=act,
                resident=res, pid=pid, step=sp.step + n_cycles,
            ),
            {"migrated": jnp.sum(migrated), "deferred": jnp.sum(deferred)},
        )

    return run


def make_settle_step(pm: PartitionedMesh, cfg: StepConfig, device_mesh: Mesh):
    """A displacement-free step (no advect, no Brownian): finishes pending
    migration handoffs (settle walk + reflect + migration, in rounds).  Run
    once before collecting results so snapshots match the single-device
    trajectory exactly (handoffs otherwise lag one cycle)."""
    import dataclasses as _dc

    cfg2 = _dc.replace(cfg, use_advection=False, use_brownian=False)
    return make_partitioned_step(pm, cfg2, device_mesh)


def shard_arrays(pm: PartitionedMesh, sp: ShardedParticles, device_mesh: Mesh):
    """Place the leading shard axis of all arrays over the device mesh."""
    sh = NamedSharding(device_mesh, P("s"))
    rep = NamedSharding(device_mesh, P())
    pm = dataclasses.replace(
        pm,
        tet_row=jax.device_put(pm.tet_row, sh),
        tet_nbr=jax.device_put(pm.tet_nbr, sh),
        perm=jax.device_put(pm.perm, rep),
        inv_perm=jax.device_put(pm.inv_perm, rep),
        bd_escape=jax.device_put(pm.bd_escape, rep),
    )
    sp = dataclasses.replace(
        sp,
        pos=jax.device_put(sp.pos, sh),
        vel=jax.device_put(sp.vel, sh),
        disp=jax.device_put(sp.disp, sh),
        tet=jax.device_put(sp.tet, sh),
        active=jax.device_put(sp.active, sh),
        resident=jax.device_put(sp.resident, sh),
        pid=jax.device_put(sp.pid, sh),
        rng_key=jax.device_put(sp.rng_key, rep),
        step=jax.device_put(sp.step, rep),
    )
    return pm, sp
