"""Advection, Brownian diffusion, and move ops.

Functional re-design of the reference's per-cycle kernels
(``cuda/particles.cu``): each op maps old state -> new state arrays; the
stepper fuses them into one jitted program (the reference pays a kernel
launch + ``cudaDeviceSynchronize`` per op, ``particles.cu:447,597,655,715``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..mesh import TetMesh
from .geometry import bary_from_tinv

# velocity interpolation modes (src/initCuda.H:72 hardcodes "TetVelocity")
TET_VELOCITY = "TetVelocity"        # RT0: cell-constant (particles.cu:317-373)
VERTEX_VELOCITY = "VertexVelocity"  # Pk: barycentric vertex interp (:245-313)
CONSTANT_VELOCITY = "ConstantVelocity"  # keep current vel (:377-399)


def interp_velocity(mesh: TetMesh, pos, tet_id, vel_prev, mode: str):
    """Velocity at particle positions.  tet_id must be clamped >= 0."""
    safe = jnp.maximum(tet_id, 0)
    if mode == TET_VELOCITY:
        return mesh.tet_vel[safe]
    if mode == VERTEX_VELOCITY:
        bary = bary_from_tinv(pos, mesh.tet_a[safe], mesh.tet_tinv[safe])
        vverts = mesh.vert_vel[mesh.tets[safe]]          # [n,4,3]
        return jnp.einsum("nk,nkj->nj", bary, vverts,
                          precision=lax.Precision.HIGHEST)
    if mode == CONSTANT_VELOCITY:
        return vel_prev
    raise ValueError(f"unknown velocity interpolation mode {mode!r}")


def advect(mesh: TetMesh, pos, vel, tet_id, active, dt, mode: str = TET_VELOCITY,
           integrator: str = "euler"):
    """Advection displacement (``cudaAdvect``, ``particles.cu:403-448``).

    integrator="euler" is the reference's first-order step
    (``particles.cu:297-302``); "rk4" is the north-star upgrade
    (BASELINE.json): classical RK4 with each stage relocated by a bounded
    tet walk so stage velocities come from the right cell.

    Kills particles whose tet_id went negative (left domain with wall
    reflection off — ``particles.cu:333-338``).  Returns (disp, vel, active).
    """
    alive = active & (tet_id >= 0)
    v = interp_velocity(mesh, pos, tet_id, vel, mode)
    if integrator == "rk4":
        from . import locate as locate_ops

        def vel_at(p):
            t, _ = locate_ops.walk(mesh, p, tet_id, active=alive)
            t_ok = jnp.where(t >= 0, t, tet_id)
            return interp_velocity(mesh, p, t_ok, vel, mode)

        k1 = v
        k2 = vel_at(pos + 0.5 * dt * k1)
        k3 = vel_at(pos + 0.5 * dt * k2)
        k4 = vel_at(pos + dt * k3)
        v_eff = (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
    elif integrator == "euler":
        v_eff = v
    else:
        raise ValueError(f"unknown integrator {integrator!r}")
    disp = v_eff * dt
    zeros = jnp.zeros_like(disp)
    disp = jnp.where(alive[..., None], disp, zeros)
    new_vel = jnp.where(alive[..., None], v_eff, vel)
    return disp, new_vel, alive


def brownian(disp, active, rng_key, dt, diffusion_coeff):
    """Brownian displacement increment (``particleBrownianMotion``,
    ``particles.cu:551-599``): disp += sqrt(2 D dt) * N(0,1) per axis.

    curand per-particle Philox streams become one threefry draw; the
    statistics (iid standard normals per particle per axis per sub-step)
    are identical, bit-level streams are not (seedable, documented compat
    divergence — the reference hardcodes seed 1591593751,
    ``particles.cu:543-544``).
    """
    sigma = jnp.sqrt(2.0 * diffusion_coeff * dt).astype(disp.dtype)
    xi = jax.random.normal(rng_key, disp.shape, dtype=disp.dtype)
    return disp + jnp.where(active[..., None], sigma * xi, 0.0)


def move(pos, disp, active):
    """Apply displacement and reset it (``particleMoveKernel`` disp overload,
    ``particles.cu:659-716``): inactive particles keep pos *and* disp."""
    new_pos = jnp.where(active[..., None], pos + disp, pos)
    new_disp = jnp.where(active[..., None], jnp.zeros_like(disp), disp)
    return new_pos, new_disp


def count_out_of_domain(tet_id) -> jnp.ndarray:
    """``cudaReportParticles`` count (``particles.cu:763-775``)."""
    return jnp.sum((tet_id < 0).astype(jnp.int32))


def kinetic_energy(vel, mass: float = 1.0) -> jnp.ndarray:
    """Total system KE as printed at every VTU write (``utils.cpp:241-258``)."""
    return 0.5 * mass * jnp.sum(vel * vel)


def eval_timestep(mesh: TetMesh, diffusion_coeff: float):
    """Stable-dt estimate per tet (``evalTimestep``, ``particles.cu:164-237``;
    declared in the public API but not called by the reference solvers).

    Returns (dt_min, dt_max) over tets using the reference's formulas:
    velocity constraint dt <= 0.5 h / |u| with h = cbrt(6V... signed det), and
    the Brownian-root constraint.
    """
    a = mesh.points[mesh.tets[:, 0]]
    b = mesh.points[mesh.tets[:, 1]]
    c = mesh.points[mesh.tets[:, 2]]
    d = mesh.points[mesh.tets[:, 3]]
    volume = jnp.sum((d - a) * jnp.cross(b - a, c - a), axis=-1)
    grid_h = jnp.cbrt(volume)
    speed = jnp.linalg.norm(mesh.tet_vel, axis=-1)
    dt_vel = 0.5 * grid_h / speed
    dt_brown = (
        jnp.sqrt(6.0 * diffusion_coeff + 2.0 * speed * grid_h)
        - jnp.sqrt(6.0 * diffusion_coeff)
    ) / (2.0 * speed)
    dt_est = jnp.abs(jnp.minimum(dt_brown, dt_vel))
    dt_est = jnp.where(dt_est < 1e-8, 1.12345678, dt_est)  # particles.cu:195
    return jnp.min(dt_est), jnp.max(dt_est)
