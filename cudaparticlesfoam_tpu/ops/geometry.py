"""Pure-JAX tetrahedral geometry primitives.

Re-implements the semantics of the reference's device geometry library
(``third_party/RTXAdvect/cuda/DeviceTetMesh.cuh:82-211``) as vectorizable
functional ops (plain ``jnp`` expressions that XLA fuses).

All functions operate on arrays whose last dimension is 3 (points) and
broadcast over leading dimensions, so they can be applied per-particle,
per-tet, or per-(particle, face) without ``vmap`` ceremony.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def dot3(a, b):
    return jnp.sum(a * b, axis=-1)


def cross3(a, b):
    return jnp.cross(a, b)


def det4(a, b, c, d):
    """Signed 6*volume of tet (a,b,c,d): dot(d-a, cross(b-a, c-a)).

    Matches ``det(A,B,C,D)`` at ``DeviceTetMesh.cuh:82-88``.
    """
    return dot3(d - a, cross3(b - a, c - a))


def tet_bary_coords(p, a, b, c, d):
    """Barycentric weights (wA, wB, wC, wD) of point p in tet (a,b,c,d).

    Reference semantics (``DeviceTetMesh.cuh:108-156``): three determinant
    ratios plus wD = 1 - wA - wB - wC.  Weight i is negative iff p is on the
    far side of the face opposite vertex i.  Orientation-invariant (ratios).

    Returns an array with trailing dimension 4.
    """
    den = det4(a, b, c, d)
    inv = 1.0 / den
    wa = det4(p, b, c, d) * inv
    wb = det4(a, p, c, d) * inv
    wc = det4(a, b, p, d) * inv
    wd = 1.0 - wa - wb - wc
    return jnp.stack([wa, wb, wc, wd], axis=-1)


def tet_edge_matrix(a, b, c, d):
    """Edge matrix M with columns (b-a, c-a, d-a); bary = M^-1 (p-a)."""
    return jnp.stack([b - a, c - a, d - a], axis=-1)


def invert3x3(m):
    """Closed-form inverse of a 3x3 matrix (batched over leading dims)."""
    # Cofactor/adjugate form: pure elementwise math, no linalg solve.
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a10, a11, a12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    a20, a21, a22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = 1.0 / det
    row0 = jnp.stack([c00, c01, c02], axis=-1)
    row1 = jnp.stack([c10, c11, c12], axis=-1)
    row2 = jnp.stack([c20, c21, c22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]


def bary_from_tinv(p, a, tinv):
    """Barycentric weights using the precomputed per-tet inverse edge matrix.

    ``tinv`` is ``invert3x3(tet_edge_matrix(...))``; returns (wA,wB,wC,wD)
    in the same vertex order as :func:`tet_bary_coords`.  This is the fast
    path used in the walk kernels: one 3x3 matvec per hop instead of four
    3x3 determinants.
    """
    rel = p - a
    # full f32 products: a TF32 contraction would blur the sign tests
    wbcd = jnp.einsum("...ij,...j->...i", tinv, rel, precision=lax.Precision.HIGHEST)
    wa = 1.0 - jnp.sum(wbcd, axis=-1, keepdims=True)
    return jnp.concatenate([wa, wbcd], axis=-1)


def tri_bary_coords(p, a, b, c):
    """Barycentric (u,v,w) of p in triangle abc (``DeviceTetMesh.cuh:158-177``)."""
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00, d01 = dot3(v0, v0), dot3(v0, v1)
    d11 = dot3(v1, v1)
    d20, d21 = dot3(v2, v0), dot3(v2, v1)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    return jnp.stack([u, v, w], axis=-1)


def tri_normal(a, b, c):
    """Unit normal of triangle abc; orientation defined by vertex order
    (``DeviceTetMesh.cuh:193-199``)."""
    n = cross3(b - a, c - a)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def reflect_point(p, n, d):
    """Mirror point p across the plane {x : n.x = d} (unit normal n).

    Sign-insensitive in n, like the reference's ``triReflect``
    (``DeviceTetMesh.cuh:201-211``) / ``specularReflect`` (``RTQuery.cu:92-107``).
    """
    return p - 2.0 * (dot3(p, n) - d)[..., None] * n


def reflect_vector(v, n):
    """Mirror direction v across a plane with unit normal n."""
    return v - 2.0 * dot3(v, n)[..., None] * n


def tet_volume(a, b, c, d):
    """Signed volume (det/6)."""
    return det4(a, b, c, d) / 6.0
