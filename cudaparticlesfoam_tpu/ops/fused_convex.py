"""Row-cached fused sub-step for the ConvexPoly locate mode.

The reference's DEFAULT build (``-DConvexPoly``,
``applications/*/Make/options:1-5``) traces displacement segments through
face planes (``query/ConvexQuery.cu``).  Phase-1 cached engine:

1. **Stream** the mega rows: advect velocity, Brownian, tentative end
   point, and a plane-based ``traceIntet`` EXIT test (``face_dist < tol``,
   ``tol < dT <= 1``, ``ConvexQuery.cu:77-101``) all come from the cached
   row — non-crossers (the common case at sane dt) touch no random memory
   and finish inline.
2. **Rare stage**: lanes whose segment exits their tet are block-compacted
   (the same two-stage 8-lane scheme as :mod:`.fused`) and resolved by the
   PROVEN simple-path sequence — :func:`..ops.convex.trace_segment` +
   :func:`..ops.convex.convex_reflect` (+ the barycentric safety net when
   configured) — inside the small buffer, then scattered back with
   refreshed row caches.  All reference semantics (inlet-face skip,
   -(startTet+1) wall codes, <=5 bounces) come from the tested tracer,
   not a re-implementation.

Mega-row layout (32 cols):
  0:3 pos (segment START inside the cycle; final pos after it) |
  3:6 vel | 6 tet (float int) | 7 active |
  8:32 cached tet_row_cx (inward plane normals 8:20, offsets 20:24,
  neighbor codes 24:28, per-tet velocity 28:31, pad 31)

Requires :func:`~cudaparticlesfoam_tpu.mesh.with_convex_rows` PLUS the
per-tet velocity appended (see :func:`cx_table`); f32 needs < 2^24 tets.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..mesh import TetMesh
from . import convex as convex_ops
from .fused import BLOCK, P0, V0, TET, ACT, ROW, _brownian_noise

WIDTH = 32
ROW_W = 24
RN = ROW                    # inward normals [4x3] at 8:20
RD = ROW + 12               # plane offsets at 20:24
RB = ROW + 16               # neighbor codes at 24:28
RU = ROW + 20               # tet velocity at 28:31


def cx_table(mesh: TetMesh):
    """[nt, 24] engine table: with_convex_rows' planes/offsets/neighbors
    with the per-tet velocity replacing the face-id block (the inline
    stage only needs an exit CLASSIFICATION; the rare stage re-traces with
    the full tables, where face ids live)."""
    if mesh.tet_row_cxe is not None:
        # precomputed mesh field: enters jit as a parameter (an in-jit
        # intermediate leaves XLA free to pick a column-major layout,
        # which the row gather pays for)
        return mesh.tet_row_cxe
    row = mesh.tet_row_cx
    return jnp.concatenate(
        [
            row[:, 0:16],                       # normals + offsets
            row[:, 16:20],                      # neighbor codes
            mesh.tet_vel.astype(row.dtype),
            jnp.zeros((mesh.n_tets, 1), row.dtype),
        ],
        axis=1,
    )


def pack_state(mesh: TetMesh, tab, pos, vel, tet_id, active):
    n = pos.shape[0]
    dt = pos.dtype
    m = jnp.zeros((n, WIDTH), dtype=dt)
    m = m.at[:, P0 : P0 + 3].set(pos)
    m = m.at[:, V0 : V0 + 3].set(vel)
    m = m.at[:, TET].set(tet_id.astype(dt))
    m = m.at[:, ACT].set(active.astype(dt))
    m = m.at[:, ROW : ROW + ROW_W].set(tab[jnp.maximum(tet_id, 0)])
    return m


def _row_tables(rows):
    """(normals[c,4,3], offsets[c,4], nbr[c,4]) views of [c,24] rows
    (same slicing as convex._tet_tables on tet_row_cx, minus face ids —
    the cached engine substitutes came-from-neighbor suppression)."""
    c = rows.shape[0]
    return (
        rows[:, 0:12].reshape(c, 4, 3),
        rows[:, 12:16],
        rows[:, 16:20].astype(jnp.int32),
    )


# inlet_nbr sentinel that can never equal a neighbor code (codes are
# >= -(n boundary faces) and < n_tets)
_NO_INLET = -(2 ** 30)


def mega_cycle(mesh: TetMesh, tab, m, rng_key, step, cfg, dt):
    n = m.shape[0]
    if n % BLOCK:
        pad = BLOCK - n % BLOCK
        mp = jnp.pad(m, ((0, pad), (0, 0)))
        return _cycle_aligned(mesh, tab, mp, rng_key, step, cfg, dt)[:n]
    return _cycle_aligned(mesh, tab, m, rng_key, step, cfg, dt)


def _cycle_aligned(mesh: TetMesh, tab, m, rng_key, step, cfg, dt):
    n = m.shape[0]
    nb = n // BLOCK

    tet = m[:, TET].astype(jnp.int32)
    act = m[:, ACT] > 0.5
    alive = (act & (tet >= 0)) if cfg.use_advection else act
    alf = alive.astype(m.dtype)

    ux, uy, uz = m[:, RU], m[:, RU + 1], m[:, RU + 2]
    if cfg.use_advection:
        dx, dy, dz = alf * ux * dt, alf * uy * dt, alf * uz * dt
        vx = jnp.where(alive, ux, m[:, V0])
        vy = jnp.where(alive, uy, m[:, V0 + 1])
        vz = jnp.where(alive, uz, m[:, V0 + 2])
    else:
        dx = dy = dz = jnp.zeros_like(ux)
        vx, vy, vz = m[:, V0], m[:, V0 + 1], m[:, V0 + 2]
    if cfg.use_brownian:
        sigma = jnp.sqrt(2.0 * cfg.diffusion_coeff * dt).astype(m.dtype)
        xi = _brownian_noise(rng_key, step, n, m.dtype, cfg)
        dx = dx + alf * sigma * xi[:, 0]
        dy = dy + alf * sigma * xi[:, 1]
        dz = dz + alf * sigma * xi[:, 2]
    actf = alf if cfg.use_advection else m[:, ACT]

    ex = m[:, P0] + dx
    ey = m[:, P0 + 1] + dy
    ez = m[:, P0 + 2] + dz
    p0 = m[:, P0 : P0 + 3]
    p_end = jnp.stack([ex, ey, ez], axis=1)
    seg = p_end - p0
    nrm0, dpl0, nbr0 = _row_tables(m[:, ROW : ROW + ROW_W])
    dt0, slot0 = convex_ops._exit_face_tables(
        nrm0, dpl0, nbr0, p0, seg, nbr0 == _NO_INLET
    )
    # leak guard: a lane whose START already sits outside its cached tet
    # (tolerance dust — the reference tracer cannot re-detect a face once
    # the point is a hair beyond it, ConvexQuery.cu:95, and an undetected
    # wall crossing would advect outward forever).  Inside points have
    # face_dist <= 0 for all four inward planes, so one max + compare
    # flags the dust; such lanes ride the rare stage, whose barycentric
    # safety net (cfg.convex_bary_fix) re-locates or reflects/escapes
    # them exactly like the simple engine's full-batch pass.
    # explicit per-component products (einsum's reduction order is not
    # bit-stable)
    fd0 = (
        nrm0[:, :, 0] * p0[:, None, 0]
        + nrm0[:, :, 1] * p0[:, None, 1]
        + nrm0[:, :, 2] * p0[:, None, 2]
        - dpl0
    )
    outside0 = alive & (jnp.max(fd0, axis=-1) > convex_ops.TOL)
    crossing = alive & ((slot0 >= 0) | outside0)
    # end-point guard: the tracer cannot see an exit it starts on (dT = 0
    # fails its tol < dT test) nor one already behind its march point near
    # an edge, so a lane resolved inline could end outside its tet.  The
    # simple engine's barycentric pass relocates such lanes; here they
    # ride the rare stage, whose tracer + barycentric pass match it.
    guard = cfg.reflect_wall and cfg.convex_bary_fix

    def ends_outside(nrm, dpl):
        fd = (
            nrm[:, :, 0] * ex[:, None]
            + nrm[:, :, 1] * ey[:, None]
            + nrm[:, :, 2] * ez[:, None]
            - dpl
        )
        return jnp.max(fd, axis=-1) > convex_ops.TOL

    if guard:
        crossing = crossing | (alive & ends_outside(nrm0, dpl0))

    # --- inline hop-1 (phase 2): the dominant crosser case is a single
    # interior face crossing (``traceIntet`` hop into the neighbor, then
    # the remaining segment ends there).  Resolve it with ONE cx-row
    # gather: march point p1 = p0 + dT*seg, exit-test the remaining
    # segment in the neighbor's cached planes with the inlet face
    # suppressed by its came-from neighbor code (exactly equivalent to
    # the reference's face-id skip — two tets share one face,
    # ConvexQuery.cu:87).  Wall hits and multi-hop lanes keep their
    # ORIGINAL state and ride the exact rare stage.
    res2 = jnp.zeros_like(crossing)
    if max(int(getattr(cfg, "inline_hops", 1)), 0) >= 1:
        lane4 = slot0[:, None] == jnp.arange(4, dtype=jnp.int32)[None, :]
        nxt0 = jnp.sum(jnp.where(lane4, nbr0, 0), axis=1)
        # dust lanes (slot0 < 0) are never "interior": lane4 selects no
        # slot, so nxt0 defaults to 0 — gate on a real exit slot
        interior = crossing & (nxt0 >= 0) & (slot0 >= 0)
        idx = jnp.where(interior, nxt0, jnp.maximum(tet, 0))
        rows_g = tab[idx]                      # ONE [n,24] gather
        p1 = p0 + dt0[:, None] * seg           # march point (trace_segment:127)
        nrm1, dpl1, nbr1 = _row_tables(rows_g)
        dt1, slot1 = convex_ops._exit_face_tables(
            nrm1, dpl1, nbr1, p1, p_end - p1, nbr1 == tet[:, None]
        )
        res2 = interior & (slot1 < 0)          # segment ends in the neighbor
        if guard:
            res2 = res2 & ~ends_outside(nrm1, dpl1)

    # inline resolution: final pos = segment end; hop-1 lanes refresh
    # tet/row from the gather.  Unresolved crossers keep their START in
    # the pos columns (the rare trace marches pos -> pos + disp) and the
    # displacement rides a side array (the mega is full).
    pending = crossing & ~res2
    fin = ~pending
    if max(int(getattr(cfg, "inline_hops", 1)), 0) >= 1:
        tet_new = jnp.where(res2, nxt0, tet)
        row_new = jnp.where(res2[:, None], rows_g, m[:, ROW : ROW + ROW_W])
        # vel columns stay the OLD tet's advected velocity — the next
        # cycle's advect reads the refreshed row, matching the reference's
        # tetVel[tetID]-at-advect-time order (particles.cu:361)
    else:
        tet_new = tet
        row_new = m[:, ROW : ROW + ROW_W]
    m = jnp.concatenate(
        [
            jnp.where(fin, ex, m[:, P0])[:, None],
            jnp.where(fin, ey, m[:, P0 + 1])[:, None],
            jnp.where(fin, ez, m[:, P0 + 2])[:, None],
            vx[:, None], vy[:, None], vz[:, None],
            tet_new[:, None].astype(m.dtype), actf[:, None],
            row_new,
        ],
        axis=1,
    )
    disp = jnp.stack([dx, dy, dz], axis=1)
    with jax.named_scope("rare_stage"):
        return _rare_stage(mesh, tab, m, disp, pending, cfg, n, nb)


def _make_run_lanes(mesh: TetMesh, tab, cfg):
    """Arena lane resolver of the convex rare stage."""

    def run_lanes(mc, dsub, lanes_act):
        """Resolve compacted lanes with the tested simple-path sequence
        (stepper.cycle's convex branch)."""
        pos = mc[:, P0 : P0 + 3]
        vel = mc[:, V0 : V0 + 3]
        tet_s = mc[:, TET].astype(jnp.int32)
        code, stop_tet, p_cross, hit_face = convex_ops.trace_segment(
            mesh, pos, dsub, tet_s, active=lanes_act, max_tets=cfg.max_hops
        )
        d2 = dsub
        if cfg.reflect_wall:
            pos, d2, vel, code = convex_ops.convex_reflect(
                mesh, pos, d2, vel, code, stop_tet, p_cross, hit_face
            )
            if cfg.convex_bary_fix:
                from . import locate as locate_ops

                p_land = pos + jnp.where(lanes_act[:, None], d2, 0.0)
                tet_chk, _ = locate_ops.walk(mesh, p_land, code)
                zero = jnp.zeros_like(d2)
                d_fix, vel, code = locate_ops.reflect_walls(
                    mesh, p_land, zero, vel, tet_chk,
                    max_bounces=cfg.max_bounces,
                )
                d2 = jnp.where(lanes_act[:, None], d2 + d_fix, d2)
        p_fin = pos + jnp.where(lanes_act[:, None], d2, 0.0)
        rows_new = tab[jnp.maximum(code, 0)]
        upd = lanes_act
        mc = mc.at[:, P0 : P0 + 3].set(
            jnp.where(upd[:, None], p_fin, mc[:, P0 : P0 + 3])
        )
        mc = mc.at[:, V0 : V0 + 3].set(
            jnp.where(upd[:, None], vel, mc[:, V0 : V0 + 3])
        )
        mc = mc.at[:, TET].set(
            jnp.where(upd, code, tet_s).astype(mc.dtype)
        )
        mc = mc.at[:, ROW : ROW + ROW_W].set(
            jnp.where(upd[:, None], rows_new, mc[:, ROW : ROW + ROW_W])
        )
        return mc

    return run_lanes


def _rare_stage(mesh: TetMesh, tab, m, disp, pending, cfg, n, nb):
    """Block-compacted resolution of pending convex lanes via the tested
    simple-path tracer."""
    run_lanes = _make_run_lanes(mesh, tab, cfg)

    # rare stage: identical block scheme to fused._mega_cycle_aligned,
    # with the side displacement array gathered/scattered alongside
    capb = min(max(int(nb * cfg.walk_capacity_frac), 32), nb)
    nl = capb * BLOCK
    cap_l = -(-max(int(nl * getattr(cfg, 'arena_lane_frac', 0.25)), 64) // 8) * 8
    max_rounds = -(-n // cap_l) + -(-nb // capb)

    def rare_cond(carry):
        m, disp, pending, r = carry
        return (r < max_rounds) & jnp.any(pending)

    def rare_round(carry):
        m, disp, pending, r = carry
        m3 = m.reshape(nb, BLOCK, WIDTH)
        d3 = disp.reshape(nb, BLOCK, 3)
        pend2 = pending.reshape(nb, BLOCK)
        bpend = jnp.any(pend2, axis=1)
        nbp = jnp.sum(bpend.astype(jnp.int32))
        # both compaction levels via SORT of iota-where-pending, as in
        # fused.py's rare stage
        blk_iota = lax.broadcasted_iota(jnp.int32, (nb, 1), 0)[:, 0]
        bidx = lax.sort(jnp.where(bpend, blk_iota, nb))[:capb]
        safe_b = jnp.minimum(bidx, nb - 1)
        mb = m3[safe_b].reshape(nl, WIDTH)
        db = d3[safe_b].reshape(nl, 3)
        lane_b = lax.broadcasted_iota(jnp.int32, (capb, BLOCK), 0)
        inrange = lane_b < jnp.minimum(nbp, capb)
        lanes_act = (pend2[safe_b] & inrange).reshape(-1)
        lane_iota = lax.broadcasted_iota(jnp.int32, (nl, 1), 0)[:, 0]
        skey = lax.sort(jnp.where(lanes_act, lane_iota, nl))
        idxl = skey[:cap_l]
        sub = mb[jnp.minimum(idxl, nl - 1)]
        dsub = db[jnp.minimum(idxl, nl - 1)]
        sub = run_lanes(sub, dsub, idxl < nl)
        mb = mb.at[idxl].set(sub, mode="drop")
        # handled = pending lanes at or below the last taken sorted id
        thresh = skey[cap_l - 1]
        handled = lanes_act & (lane_iota <= jnp.minimum(thresh, nl - 1))
        m3 = m3.at[bidx].set(mb.reshape(capb, BLOCK, WIDTH), mode="drop")
        pend2 = pend2.at[bidx].set(
            pend2[safe_b] & ~handled.reshape(capb, BLOCK), mode="drop"
        )
        return m3.reshape(n, WIDTH), disp, pend2.reshape(n), r + 1

    m, _, _, _ = lax.while_loop(
        rare_cond, rare_round,
        (m, disp, pending, jnp.zeros((), jnp.int32)),
    )
    return m
