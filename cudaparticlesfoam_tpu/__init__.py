"""cudaparticlesfoam_tpu — Lagrangian particle advection in JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of
simzero/cudaParticlesFoam (GPU/OptiX passive particle tracking for
OpenFOAM): tetrahedral mesh particle advection with Brownian diffusion,
barycentric tet-walk cell location, specular wall reflection, OpenFOAM
case compatibility, and multi-device scaling via jax.sharding.
"""

from .mesh import TetMesh, box_mesh, from_arrays, read_dataset, replace_velocity
from .state import ParticleState, make_state, seed_in_box, seed_from_file
from .stepper import StepConfig, cycle, run_cycles, step_once, n_cycles_for, diagnostics
from .ops.locate import (
    GridLocator,
    build_grid_locator,
    first_locate,
    locate_seeds,
    walk,
    reflect_walls,
)

__version__ = "0.1.0"

__all__ = [
    "TetMesh",
    "box_mesh",
    "from_arrays",
    "read_dataset",
    "replace_velocity",
    "ParticleState",
    "make_state",
    "seed_in_box",
    "seed_from_file",
    "StepConfig",
    "cycle",
    "run_cycles",
    "step_once",
    "n_cycles_for",
    "diagnostics",
    "GridLocator",
    "build_grid_locator",
    "first_locate",
    "locate_seeds",
    "walk",
    "reflect_walls",
]
