"""Cell location: barycentric tet-walk + seeding-time point location.

XLA replacement for the reference's two locators:

* Per-step relocation — ``baryTetSearch`` / ``baryQueryDisp``
  (``query/RTQuery.cu:35-90,221-248``): walk from the previous tet through
  the face with the most-negative barycentric weight, <=50 hops,
  out-of-domain encoded as ``-(lastTet+1)``.  Here it is a vectorized
  ``lax.while_loop`` over all particles: the loop runs for
  max-hops-any-particle-needs iterations (typically 1-2 per sub-step since
  dt keeps displacements below a cell), with converged lanes masked.  Each
  hop is ONE row gather from the packed walk table (mesh.tet_a/tet_tinv/
  tet_nbr) — no face/vertex pointer chasing.

* Seeding-time location — replaces the OptiX BVH broad phase
  (``optix/OptixTetQuery.cpp``, used only at init per ``src/advect.H:126``):
  a uniform grid over tet centroids gives a starting tet, the same walk
  refines it, and a brute-force sweep resolves the few particles the walk
  cannot reach (non-convex domains).  The grid + walk is one gather + the
  standard walk, with no BVH to build or traverse.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..mesh import TetMesh
from ..utils.pytree import pytree_dataclass
from .geometry import bary_from_tinv

MAX_HOPS = 50  # RTQuery.cu:42


def _bary_at(mesh: TetMesh, p, tet):
    """Barycentric coords of p in (clamped) tet via the walk table."""
    a = mesh.tet_a[tet]
    tinv = mesh.tet_tinv[tet]
    return bary_from_tinv(p, a, tinv)


def walk(mesh: TetMesh, p, tet0, active=None, max_hops: int = MAX_HOPS):
    """Vectorized ``baryTetSearch``.

    Args:
      p: [n,3] query points.
      tet0: [n] starting tet ids; negative entries are returned unchanged
        (the reference would read out of bounds there; observable behavior
        in the default reflect-wall config never hits it).
      active: optional [n] mask; inactive lanes are passed through.

    Returns (tet, slot): ``tet`` is the hosting tet id, or ``-(lastTet+1)``
    if the walk exited the domain, or the last visited tet if ``max_hops``
    was exhausted (reference semantics).  ``slot`` is the local face slot
    (0..3) of the last face stepped through (-1 if none) — for a
    wall-exit, ``(-tet-1, slot)`` identifies the boundary face plane.
    """
    n = p.shape[0]
    tet0 = tet0.astype(jnp.int32)
    done0 = tet0 < 0
    if active is not None:
        done0 = done0 | (~active)
    slot0 = jnp.full((n,), -1, dtype=jnp.int32)
    hops0 = jnp.zeros((), dtype=jnp.int32)

    def cond(carry):
        tet, done, slot, hops = carry
        return (hops < max_hops) & jnp.logical_not(jnp.all(done))

    def body(carry):
        tet, done, slot, hops = carry
        safe = jnp.maximum(tet, 0)
        bary = _bary_at(mesh, p, safe)
        wmin = jnp.min(bary, axis=-1)
        exit_slot = jnp.argmin(bary, axis=-1).astype(jnp.int32)
        inside = wmin >= 0.0
        stepping = (~done) & (~inside)
        nbr = mesh.tet_nbr[safe, exit_slot]
        out = stepping & (nbr < 0)
        tet_next = jnp.where(stepping, jnp.where(nbr < 0, -(tet + 1), nbr), tet)
        slot_next = jnp.where(stepping, exit_slot, slot)
        done_next = done | inside | out
        return tet_next, done_next, slot_next, hops + 1

    tet, _, slot, _ = lax.while_loop(cond, body, (tet0, done0, slot0, hops0))
    return tet, slot


def reflect_walls(mesh: TetMesh, pos, disp, vel, tet_id, max_bounces: int = 10):
    """Vectorized ``RTreflection`` (``query/RTQuery.cu:109-186``).

    For particles whose relocation returned a wall-hit code (tet_id < 0):
    specular-reflect the end point and velocity across the exit face plane,
    re-walk, repeat up to ``max_bounces``; all boundaries reflect (the
    reference's documented TODO at RTQuery.cu:165-166 — patch-tagged outflow
    lives in :mod:`..ops.boundaries`).

    Returns (disp, vel, tet_id) updated.  Lanes with tet_id >= 0 pass
    through untouched.
    """
    hit = tet_id < 0
    tet_bd = jnp.where(hit, -(tet_id + 1), tet_id)
    p_end = pos + disp
    p_ref = p_end
    u_ref = vel
    settled = ~hit
    # slot of the face to reflect across; seeded by a fresh walk inside loop
    bounce0 = jnp.zeros((), dtype=jnp.int32)

    def cond(carry):
        p_ref, u_ref, tet_bd, settled, bounce = carry
        return (bounce < max_bounces) & jnp.logical_not(jnp.all(settled))

    def body(carry):
        p_ref, u_ref, tet_bd, settled, bounce = carry
        wtet, wslot = walk(mesh, p_ref, tet_bd, active=~settled)
        in_domain = wtet >= 0
        newly = (~settled) & in_domain
        tet_bd = jnp.where(newly, wtet, tet_bd)
        refl = (~settled) & (~in_domain)
        # exit tet/face of the failed walk
        ex_tet = jnp.where(refl, -(wtet + 1), 0)
        ex_slot = jnp.where(refl, jnp.maximum(wslot, 0), 0)
        # absorbing (outlet) faces: deactivate instead of reflect
        code_nbr = mesh.tet_nbr[ex_tet, ex_slot]
        bd = jnp.clip(-code_nbr - 1, 0, max(mesh.n_bd_faces - 1, 0))
        esc = refl & (code_nbr < 0) & mesh.bd_escape[bd]
        tet_bd = jnp.where(esc, -(ex_tet + 1), tet_bd)
        settled = settled | esc
        refl = refl & ~esc
        n = mesh.tet_face_n[ex_tet, ex_slot]
        d = mesh.tet_face_d[ex_tet, ex_slot]
        p_new = p_ref - 2.0 * (jnp.sum(p_ref * n, axis=-1) - d)[..., None] * n
        u_new = u_ref - 2.0 * jnp.sum(u_ref * n, axis=-1)[..., None] * n
        p_ref = jnp.where(refl[..., None], p_new, p_ref)
        u_ref = jnp.where(refl[..., None], u_new, u_ref)
        tet_bd = jnp.where(refl, ex_tet, tet_bd)
        settled = settled | newly
        return p_ref, u_ref, tet_bd, settled, bounce + 1

    p_ref, u_ref, tet_bd, settled, _ = lax.while_loop(
        cond, body, (p_ref, u_ref, tet_bd, settled, bounce0)
    )
    new_disp = jnp.where(hit[..., None], p_ref - pos, disp)
    new_vel = jnp.where(hit[..., None], u_ref, vel)
    new_tet = jnp.where(hit, tet_bd, tet_id)
    return new_disp, new_vel, new_tet


# ---------------------------------------------------------------------------
# seeding-time location (BVH replacement)
# ---------------------------------------------------------------------------


@pytree_dataclass(meta_fields=("shape",))
class GridLocator:
    """Uniform grid of candidate starting tets over the mesh bounds."""

    cell_tet: jnp.ndarray   # [gx*gy*gz] int32 candidate tet per cell
    origin: jnp.ndarray     # [3]
    inv_cell: jnp.ndarray   # [3]
    shape: tuple            # (gx, gy, gz)


def build_grid_locator(mesh: TetMesh, target_cells_per_tet: float = 1.0) -> GridLocator:
    """Host-side build: bin tet centroids; dilate to fill empty cells."""
    from .. import mesh as meshlib

    pts = meshlib.host_np(mesh, "points", np.float64)
    tets = meshlib.host_np(mesh, "tets")
    cen = pts[tets].mean(axis=1)
    lo = meshlib.host_np(mesh, "bounds_lo", np.float64)
    hi = meshlib.host_np(mesh, "bounds_hi", np.float64)
    extent = np.maximum(hi - lo, 1e-300)
    n_tets = tets.shape[0]
    # ~1 cell per tet, distributed by domain aspect ratio
    g = np.maximum(
        (extent / extent.prod() ** (1 / 3) * (n_tets * target_cells_per_tet) ** (1 / 3))
        .round()
        .astype(int),
        1,
    )
    gx, gy, gz = int(g[0]), int(g[1]), int(g[2])
    inv_cell = np.array([gx, gy, gz], dtype=np.float64) / extent

    idx = np.clip(((cen - lo) * inv_cell).astype(np.int64), 0, [gx - 1, gy - 1, gz - 1])
    flat = (idx[:, 0] * gy + idx[:, 1]) * gz + idx[:, 2]
    cell_tet = np.full(gx * gy * gz, -1, dtype=np.int32)
    cell_tet[flat] = np.arange(n_tets, dtype=np.int32)  # any tet per cell

    # dilate: fill empty cells from neighbors until full (bounded sweeps)
    grid = cell_tet.reshape(gx, gy, gz)
    for _ in range(max(gx, gy, gz)):
        empty = grid < 0
        if not empty.any():
            break
        for axis in (0, 1, 2):
            for shift in (1, -1):
                src = np.roll(grid, shift, axis=axis)
                grid = np.where((grid < 0) & (src >= 0), src, grid)
    grid = np.where(grid < 0, 0, grid)

    return GridLocator(
        cell_tet=jnp.asarray(grid.reshape(-1)),
        origin=jnp.asarray(lo, dtype=mesh.dtype),
        inv_cell=jnp.asarray(inv_cell, dtype=mesh.dtype),
        shape=(gx, gy, gz),
    )


def _grid_start_tet(loc: GridLocator, p):
    gx, gy, gz = loc.shape
    rel = (p - loc.origin) * loc.inv_cell
    ij = jnp.clip(
        rel.astype(jnp.int32),
        jnp.zeros(3, jnp.int32),
        jnp.array([gx - 1, gy - 1, gz - 1], jnp.int32),
    )
    flat = (ij[..., 0] * gy + ij[..., 1]) * gz + ij[..., 2]
    return loc.cell_tet[flat]


def brute_force_resolve(mesh: TetMesh, p, tet) -> np.ndarray:
    """Host-side exact fallback for lanes the walk could not place (tet < 0):
    test every tet (vectorized numpy, chunked over particles).

    Only runs at seeding time, on the (typically few) unresolved particles —
    non-convex domains where the walk exits a boundary although the point is
    inside elsewhere, or genuinely out-of-domain seeds (which stay -1, the
    reference's dead-seed convention: killed at the first advect,
    ``particles.cu:262-266``).
    """
    tet = np.asarray(tet).copy()
    bad = np.nonzero(tet < 0)[0]
    if len(bad) == 0:
        return tet
    from .. import mesh as meshlib

    # read back only the unresolved rows
    if isinstance(p, np.ndarray):
        p_bad = p[bad].astype(np.float64)
    else:
        p_bad = np.asarray(p[jnp.asarray(bad)], dtype=np.float64)
    a = meshlib.host_np(mesh, "tet_a", np.float64)
    tinv = meshlib.host_np(mesh, "tet_tinv", np.float64)
    for i0 in range(0, len(bad), 256):
        sel = bad[i0 : i0 + 256]
        rel = p_bad[i0 : i0 + 256][:, None, :] - a[None, :, :]  # [b, nt, 3]
        wbcd = np.einsum("tij,btj->bti", tinv, rel)
        inside = (wbcd.min(axis=-1) >= 0.0) & (wbcd.sum(axis=-1) <= 1.0)
        hit = inside.any(axis=1)
        first = inside.argmax(axis=1)
        tet[sel] = np.where(hit, first, -1).astype(np.int32)
    return tet


def first_locate(mesh: TetMesh, loc: GridLocator, p):
    """Initial point location for seeded particles (replaces OptiX query +
    ``baryQuery`` narrow phase, ``RTQuery.cu:295-310``): grid candidate tet
    then bary walk.  Lanes that come back negative should be passed through
    :func:`brute_force_resolve` once on the host.
    """
    start = _grid_start_tet(loc, p)
    tet, _ = walk(mesh, p, start)
    return tet


def locate_seeds(mesh: TetMesh, loc: GridLocator, p) -> jnp.ndarray:
    """first_locate + host brute-force fallback; returns final tet ids.

    The unresolved count is read back as ONE device scalar; the full id
    array only crosses to the host when there is something to resolve."""
    tet = first_locate(mesh, loc, p)
    if int(jnp.sum(tet < 0)):
        tet = jnp.asarray(
            brute_force_resolve(mesh, p, np.asarray(tet)), dtype=jnp.int32
        )
    return jnp.asarray(tet, dtype=jnp.int32)
