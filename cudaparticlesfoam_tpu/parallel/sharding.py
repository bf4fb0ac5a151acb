"""Multi-chip execution: particle-data-parallel sharding.

The reference *shrinks* to one GPU: every rank gathers its mesh and fields
to the MPI master, which owns all particles and the only CUDA context
(``src/initCuda.H:209-270,322``; per step only U is re-gathered,
``src/advect.H:62-67``).  This design inverts that:

* **Particle DP (this module)** — particles are independent; shard them
  across the device mesh axis ``"p"`` and replicate the tet mesh.  Zero
  per-step communication; diagnostics reduce with ``psum``.  This is the
  production layout whenever the mesh fits per device (a 1M-tet walk
  table is ~130 MB in f32).

* **Spatial mesh partitioning** (:mod:`.partition`) — for meshes beyond
  HBM: tets spatially sharded, particles ride their shard, boundary
  crossers migrate via ``all_to_all``.

Implementation note: we use ``jax.sharding.NamedSharding`` constraints and
let pjit/XLA propagate — the stepper itself is unchanged (single-program,
compiler-partitioned), which is exactly the XLA-native way to scale this.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..mesh import TetMesh
from ..state import ParticleState
from ..stepper import StepConfig


def make_device_mesh(n_devices: int | None = None, axis: str = "p") -> Mesh:
    """1-D device mesh over the default backend's devices.  Asking for more
    devices than the backend has is an error: a program meant for several
    accelerators never falls back to CPU devices.  (CPU dry runs give the
    CPU backend virtual devices with
    ``--xla_force_host_platform_device_count``.)"""
    import numpy as np

    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} {jax.default_backend()} devices, have "
                f"{len(devs)}"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def pad_particles(state: ParticleState, multiple: int) -> ParticleState:
    """Pad particle arrays to a multiple of the shard count; padded lanes
    are inactive with tet_id = -1 (they behave as dead particles)."""
    n = state.n_particles
    target = -(-n // multiple) * multiple
    if target == n:
        return state
    pad = target - n

    def pad_arr(x, fill):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill)

    return dataclasses.replace(
        state,
        pos=pad_arr(state.pos, 0.0),
        vel=pad_arr(state.vel, 0.0),
        disp=pad_arr(state.disp, 0.0),
        tet_id=pad_arr(state.tet_id, -1),
        active=pad_arr(state.active, False),
        n_particles=target,
    )


def shard_state(state: ParticleState, mesh: Mesh, axis: str = "p") -> ParticleState:
    """Place particle arrays sharded over the mesh axis; rng/step replicated.

    Replicated scalars are deep-copied, not device_put: a layout-compatible
    device_put can ALIAS the caller's buffer, and the donated run_cycles
    variants would then delete an array the caller still holds (seen as
    "Array has been deleted" on a test fixture's rng_key)."""
    state = pad_particles(state, mesh.devices.size)
    sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    return dataclasses.replace(
        state,
        pos=jax.device_put(state.pos, sh),
        vel=jax.device_put(state.vel, sh),
        disp=jax.device_put(state.disp, sh),
        tet_id=jax.device_put(state.tet_id, sh),
        active=jax.device_put(state.active, sh),
        rng_key=jax.device_put(jnp.array(state.rng_key, copy=True), rep),
        step=jax.device_put(jnp.array(state.step, copy=True), rep),
    )


def replicate_mesh(tet_mesh: TetMesh, mesh: Mesh) -> TetMesh:
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), tet_mesh)


@partial(jax.jit, static_argnames=("cfg", "n_cycles"), donate_argnums=(1,))
def run_cycles_sharded(
    tet_mesh: TetMesh, state: ParticleState, cfg: StepConfig, n_cycles: int, dt=None
) -> ParticleState:
    """Sharded variant of :func:`~cudaparticlesfoam_tpu.stepper.run_cycles`:
    same program (incl. the cached-row fast engine); the particle-axis
    sharding placed by :func:`shard_state` propagates through, so each chip
    steps its own particle slice with no collectives.  Donates the input
    state (in-place update per chip)."""
    from ..stepper import _run_cycles_impl

    return _run_cycles_impl(tet_mesh, state, cfg, n_cycles, dt)


@jax.jit
def global_diagnostics(state: ParticleState) -> dict:
    """Cross-chip reductions (the psum analogue of the reference's
    thrust count_if + KE print, ``particles.cu:763-775``/``utils.cpp:258``)."""
    return {
        "out_of_domain": jnp.sum((state.tet_id < 0).astype(jnp.int32)),
        "active": jnp.sum(state.active.astype(jnp.int32)),
        "kinetic_energy": 0.5 * jnp.sum(state.vel * state.vel),
    }


def distribute(tet_mesh: TetMesh, state: ParticleState, n_devices: int | None = None):
    """One-call setup: device mesh + replicated tet mesh + sharded state."""
    dmesh = make_device_mesh(n_devices)
    return dmesh, replicate_mesh(tet_mesh, dmesh), shard_state(state, dmesh)
