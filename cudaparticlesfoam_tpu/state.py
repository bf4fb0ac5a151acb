"""Particle state pytree and seeding.

Replaces the reference's raw device pointers (``src/initCuda.H:141-150``:
``d_particles`` double4 with status packed in ``.w``, ``d_particles_tetIDs``,
``d_particle_disps``, ``d_particle_vels``, curand states) with a functional
pytree.  The ``w``-in-double4 active flag becomes a real bool mask; curand
per-particle state becomes a single threefry key advanced per sub-step.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .dtypes import canonical_float
from .utils.pytree import pytree_dataclass


@pytree_dataclass(meta_fields=("n_particles",))
class ParticleState:
    pos: jnp.ndarray      # [n, 3] float
    vel: jnp.ndarray      # [n, 3] float      (d_particle_vels)
    disp: jnp.ndarray     # [n, 3] float      (d_particle_disps, zeroed after move)
    tet_id: jnp.ndarray   # [n] int32         (negative = out / wall-hit code)
    active: jnp.ndarray   # [n] bool          (double4 .w in the reference)
    rng_key: jnp.ndarray  # threefry key
    step: jnp.ndarray     # int32 scalar, completed Lagrangian sub-steps
    n_particles: int

    @property
    def dtype(self):
        return self.pos.dtype


def make_state(pos, tet_id=None, rng_seed: int = 0, dtype=None) -> ParticleState:
    fdtype = canonical_float(dtype)
    pos = jnp.asarray(pos, dtype=fdtype)
    n = pos.shape[0]
    if tet_id is None:
        tet_id = jnp.full((n,), -1, dtype=jnp.int32)
    return ParticleState(
        pos=pos,
        vel=jnp.zeros((n, 3), dtype=fdtype),
        disp=jnp.zeros((n, 3), dtype=fdtype),
        tet_id=jnp.asarray(tet_id, dtype=jnp.int32),
        active=jnp.ones((n,), dtype=bool),
        rng_key=jax.random.PRNGKey(rng_seed),
        step=jnp.zeros((), dtype=jnp.int32),
        n_particles=n,
    )


# ---------------------------------------------------------------------------
# seeding
# ---------------------------------------------------------------------------


def _owl_lcg_uniform3(n: int) -> np.ndarray:
    """Bit-exact reproduction of the reference's in-box seeding RNG.

    The reference seeds particle i with owl's 24-bit LCG after a 16-round
    TEA scramble of (threadIdx, blockIdx) = (i % 128, i / 128)
    (``cuda/particles.cu:78-97``, ``owl/common/math/random.h:57-91``), then
    draws x, y, z as ``float(state) * 2^-32``.  Reproducing it exactly gives
    bit-identical initial positions to the CUDA build — the strongest
    possible trajectory-parity anchor.
    """
    i = np.arange(n, dtype=np.uint32)
    v0 = i % np.uint32(128)
    v1 = i // np.uint32(128)
    s0 = np.uint32(0)
    with np.errstate(over="ignore"):
        for _ in range(16):
            s0 = np.uint32(s0 + np.uint32(0x9E3779B9))
            v0 = v0 + (
                ((v1 << np.uint32(4)) + np.uint32(0xA341316C))
                ^ (v1 + s0)
                ^ ((v1 >> np.uint32(5)) + np.uint32(0xC8013EA4))
            )
            v1 = v1 + (
                ((v0 << np.uint32(4)) + np.uint32(0xAD90777D))
                ^ (v0 + s0)
                ^ ((v0 >> np.uint32(5)) + np.uint32(0x7E95761E))
            )
        state = v0
        out = np.empty((n, 3), dtype=np.float64)
        lcg_a = np.uint32(1664525)
        lcg_c = np.uint32(1013904223)
        for axis in range(3):
            state = lcg_a * state + lcg_c
            # ldexpf(float(state), -32): f32 rounding of state, then * 2^-32
            out[:, axis] = state.astype(np.float32).astype(np.float64) * 2.0**-32
    return out


def seed_in_box(
    n: int,
    box_lo,
    box_hi,
    rng_seed: int = 0,
    method: str = "reference",
    dtype=None,
) -> ParticleState:
    """Uniform random seeding inside a box (``initParticlesKernel``,
    ``particles.cu:78-108``).

    method="reference": bit-exact owl-LCG positions (matches the CUDA build).
    method="threefry":  jax.random uniform keyed by rng_seed.
    """
    fdtype = canonical_float(dtype)
    lo = np.asarray(box_lo, dtype=np.float64)
    hi = np.asarray(box_hi, dtype=np.float64)
    if method == "reference":
        u = _owl_lcg_uniform3(n)
    elif method == "threefry":
        u = np.asarray(
            jax.random.uniform(jax.random.PRNGKey(rng_seed), (n, 3), dtype=jnp.float32),
            dtype=np.float64,
        )
    else:
        raise ValueError(f"unknown seeding method {method!r}")
    # worldBounds.lower + u * size — note lo/hi are used as given, matching
    # the reference which does NOT re-sort a min>max seedingBox (the pitzDaily
    # dict supplies an inverted box on purpose; box3d keeps raw corners).
    pos = lo + u * (hi - lo)
    return make_state(pos, rng_seed=rng_seed, dtype=fdtype)


def seed_from_file(path: str, n: int | None = None, rng_seed: int = 0, dtype=None):
    """File-based seeding (``cudaInitParticles(…, fileName)``,
    ``particles.cu:127-160``): header line ``<word> N``, comment line, then
    ``x y z tetID`` rows.

    Like the reference's reader (which assigns ``d_tetIDs[i] = tetID``
    directly, ``particles.cu:150-156``), a 4th column is honored as the
    starting tet — restarts skip the re-locate and are bit-identical with
    :func:`save_particle_file` output.  3-column files get tet_id = -1
    (caller locates)."""
    with open(path) as fh:
        header = fh.readline().split()
        n_file = int(float(header[-1]))
        fh.readline()
        data = np.loadtxt(fh, max_rows=n_file)
    if data.ndim == 1:
        data = data[None, :]
    if n is None:
        n = n_file
    pos = data[:n, :3]
    tet_id = None
    if data.shape[1] >= 4:
        tet_id = data[:n, 3].astype(np.int32)
    return make_state(pos, tet_id=tet_id, rng_seed=rng_seed, dtype=dtype)


def save_particle_file(path: str, state: ParticleState) -> None:
    """Writer for the seed-file format (round-trips with seed_from_file);
    the reference has the reader but no writer — this closes the
    checkpoint gap noted in SURVEY.md §5."""
    pos = np.asarray(state.pos)
    tet = np.asarray(state.tet_id)
    with open(path, "w") as fh:
        fh.write(f"NumParticles {len(pos)}\n")
        fh.write("x y z tetID\n")
        for p, t in zip(pos, tet):
            fh.write(f"{p[0]:.17g} {p[1]:.17g} {p[2]:.17g} {int(t)}\n")


def replace(state: ParticleState, **kw) -> ParticleState:
    return dataclasses.replace(state, **kw)


def inject_device(
    state: ParticleState,
    mesh,
    locator,
    box_lo,
    box_hi,
    count: int,
    rng_seed: int = 0,
) -> ParticleState:
    """:func:`inject`, fully device-side (jit-friendly, zero readbacks,
    where the host path reads ``active`` back): dead slots come from a ``lax.sort`` compaction, seeds
    from the same (key, step+7919+seed) uniform draw, location from the
    grid+walk :func:`~.ops.locate.first_locate` (no brute fallback —
    unresolved seeds stay dead, like the host path's ``ok`` mask).  With
    >= ``count`` dead slots and a grid-resolvable box, the result is
    bit-identical to :func:`inject`.  ``count`` is static (one compiled
    program per burst size)."""
    from jax import lax

    from .ops import locate as locate_ops

    n = state.n_particles
    count = int(count)
    if count <= 0:
        return state
    key = jax.random.fold_in(state.rng_key, state.step + 7919 + rng_seed)
    u = jax.random.uniform(key, (count, 3), dtype=state.pos.dtype)
    lo = jnp.asarray(box_lo, state.pos.dtype)
    hi = jnp.asarray(box_hi, state.pos.dtype)
    new_pos = lo + u * (hi - lo)
    tet = locate_ops.first_locate(mesh, locator, new_pos)
    lane = lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    slots = lax.sort(jnp.where(state.active, n, lane))[:count]
    ok = (slots < n) & (tet >= 0)
    zeros3 = jnp.zeros((count, 3), state.pos.dtype)
    return dataclasses.replace(
        state,
        pos=state.pos.at[slots].set(new_pos, mode="drop"),
        vel=state.vel.at[slots].set(zeros3, mode="drop"),
        disp=state.disp.at[slots].set(zeros3, mode="drop"),
        tet_id=state.tet_id.at[slots].set(tet, mode="drop"),
        active=state.active.at[slots].set(ok, mode="drop"),
    )


def inject(
    state: ParticleState,
    mesh,
    locator,
    box_lo,
    box_hi,
    count: int,
    rng_seed: int = 0,
) -> tuple[ParticleState, int]:
    """Continuous injection with slot reuse (BASELINE.json config 4):
    re-seed up to ``count`` dead slots uniformly in the box, locate them,
    and reactivate.  Dead slots come from absorbing boundaries
    (escapePatches) or reflection-off runs.  Returns (state, n_injected).

    Host-side (runs between fused chunks, like VTU writes); the reference
    has no injection machinery at all — particles only ever die
    (``particles.cu:262-266``).
    """
    import numpy as np

    from .ops import locate as locate_ops

    dead = np.nonzero(~np.asarray(state.active))[0]
    if len(dead) == 0 or count <= 0:
        return state, 0
    slots = dead[:count]
    k = len(slots)
    key = jax.random.fold_in(state.rng_key, int(state.step) + 7919 + rng_seed)
    u = jax.random.uniform(key, (k, 3), dtype=state.pos.dtype)
    lo = jnp.asarray(box_lo, state.pos.dtype)
    hi = jnp.asarray(box_hi, state.pos.dtype)
    new_pos = lo + u * (hi - lo)
    tet = locate_ops.locate_seeds(mesh, locator, new_pos)
    ok = np.asarray(tet) >= 0
    sl = jnp.asarray(slots, jnp.int32)
    pos = state.pos.at[sl].set(new_pos)
    vel = state.vel.at[sl].set(0.0)
    disp = state.disp.at[sl].set(0.0)
    tid = state.tet_id.at[sl].set(jnp.asarray(tet))
    act = state.active.at[sl].set(jnp.asarray(ok))
    return (
        dataclasses.replace(
            state, pos=pos, vel=vel, disp=disp, tet_id=tid, active=act
        ),
        int(ok.sum()),
    )
