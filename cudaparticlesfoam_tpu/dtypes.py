"""Precision policy.

The reference (simzero/cudaParticlesFoam) computes everything in float64 on
the GPU (``cuda/common.h:26`` — ``Particle = double4``).  Here precision is
a configuration knob rather than a hardcoded choice:

* ``float32`` — the production dtype.  Positions/velocities/geometry in
  f32; the tet-walk sign tests are robust at tutorial scales because a
  particle moves a small fraction of a cell per sub-step (dt is chosen that
  way, see ``cuda/particles.cu:164-237`` dt estimation).  The reference
  itself mixes f32 (OptiX broad phase) with f64 narrow phase.  Small f32
  contractions that feed sign tests pin ``Precision.HIGHEST``, so a GPU
  never runs them in TF32.
* ``float64`` — the reference's own precision, which the GPU runs
  natively; also the bit-faithful parity mode of the CPU tests.  Requires
  ``jax_enable_x64`` (the CLI's ``--f64``).

Use :func:`default_float` to resolve the active dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Index dtype: tet/face ids.  int32 everywhere (reference uses int).
INDEX_DTYPE = jnp.int32


def x64_enabled() -> bool:
    return jax.config.read("jax_enable_x64")


def default_float():
    """float64 when x64 is enabled (parity/test mode), else float32."""
    return jnp.float64 if x64_enabled() else jnp.float32


def canonical_float(dtype=None):
    """Resolve a user-provided dtype argument to a concrete float dtype."""
    if dtype is None:
        return default_float()
    dtype = jnp.dtype(dtype)
    if dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError(f"unsupported float dtype {dtype}; use float32/float64")
    if dtype == np.dtype(np.float64) and not x64_enabled():
        raise ValueError(
            "float64 requested but jax_enable_x64 is off; "
            "set JAX_ENABLE_X64=1 or jax.config.update('jax_enable_x64', True)"
        )
    return dtype
