"""Tetrahedral mesh container and builders.

XLA re-design of the reference's ``HostTetMesh`` / ``DeviceTetMesh``
(``third_party/RTXAdvect/cuda/HostTetMesh.h``, ``DeviceTetMesh.cuh``): the
mesh is an immutable structure-of-arrays pytree of device arrays, plus a
precomputed **walk table** so the hot tet-walk kernel does exactly one row
gather per hop instead of the reference's pointer-chasing
(tet -> tetfacets -> faceinfos -> facets -> 3 vertex fetches,
``query/RTQuery.cu:35-90``):

* ``tet_a`` / ``tet_tinv``   — barycentric coords via one 3x3 matvec
* ``tet_nbr``                — neighbor tet across each local face
                               (negative = boundary, encodes -(bdFace+1))
* ``tet_face_n``/``tet_face_d`` — outward unit face planes for reflection

Face/topology construction mirrors ``HostTetMesh::getBoundaryMesh``
(``HostTetMesh.h:265-430``): faces deduped by sorted vertex key, front/back
adjacency by orientation parity, boundary = faces seen once.  The O(n log n)
vectorized dedup replaces the reference's std::map loop.

Local face ordering is the reference's Gmsh order (``HostTetMesh.h:350-358``):
slot i is the face opposite vertex i, so ``argmin(bary)`` indexes the exit
slot directly.  Tets are canonicalized to positive volume up-front (the
reference reorients per-face during table build, ``HostTetMesh.h:334-343``,
with identical resulting adjacency for well-formed meshes).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .dtypes import canonical_float
from .utils.pytree import pytree_dataclass

# Gmsh-order local faces: slot i opposite vertex i; outward-oriented for
# positive-volume tets (HostTetMesh.h:350-358).
FACE_SLOTS = np.array([[1, 2, 3], [2, 0, 3], [0, 1, 3], [0, 2, 1]], dtype=np.int64)


@pytree_dataclass(meta_fields=("n_points", "n_tets", "n_faces", "n_bd_faces"))
class TetMesh:
    # --- core SoA (reference HostTetMesh.h:33-60) ---
    points: jnp.ndarray        # [nv, 3] float
    tets: jnp.ndarray          # [nt, 4] int32, positive volume
    tet_vel: jnp.ndarray       # [nt, 3] float   (RT0 / "TetVelocity")
    vert_vel: jnp.ndarray      # [nv, 3] float   (Pk / "VertexVelocity")
    faces: jnp.ndarray         # [nf, 3] int32, sorted vertex ids
    tet_faces: jnp.ndarray     # [nt, 4] int32  tet -> global face id
    face_front: jnp.ndarray    # [nf] int32  (negative -(bd+1) at boundary)
    face_back: jnp.ndarray     # [nf] int32
    # --- walk table ---
    tet_a: jnp.ndarray         # [nt, 3]  first vertex position
    tet_tinv: jnp.ndarray      # [nt, 3, 3]  inverse edge matrix
    tet_nbr: jnp.ndarray       # [nt, 4] int32 neighbor (or -(bdFace+1))
    tet_face_n: jnp.ndarray    # [nt, 4, 3] outward unit normals
    tet_face_d: jnp.ndarray    # [nt, 4] plane offsets (n.x = d)
    # packed hot row for the cached fast engine: ONE gather serves advect
    # velocity + barycentric test + neighbor step + reflection plane (via
    # Tinv gradients).  cols 0:3 = A, 3:12 = Tinv row-major, 12:15 = tet
    # velocity, 15:19 = neighbor codes as exact float integers (works in
    # f32: |codes| < 2^24 tets, and f64), 19 = pad.
    tet_row: jnp.ndarray       # [nt, 20] float
    # --- boundary surface mesh (for I/O + tagged BCs) ---
    bd_tris: jnp.ndarray       # [nbd, 3] int32 into points, outward-oriented
    bd_tet: jnp.ndarray        # [nbd] int32 owning tet
    bd_patch: jnp.ndarray      # [nbd] int32 patch/region tag (0 = untagged)
    bd_escape: jnp.ndarray     # [nbd] bool: True = absorbing (outlet), False
                               # = specular wall.  All-False reproduces the
                               # reference's reflect-at-all-boundaries TODO
                               # (RTQuery.cu:165-166).
    # --- bounds ---
    bounds_lo: jnp.ndarray     # [3]
    bounds_hi: jnp.ndarray     # [3]
    # --- static meta ---
    n_points: int
    n_tets: int
    n_faces: int
    n_bd_faces: int
    # packed hot row for the VertexVelocity ("Pk", particles.cu:245-313)
    # cached engine: cols 0:3 A, 3:12 Tinv, 12:24 the 4 vertex velocities,
    # 24:28 neighbor codes.  Built lazily by :func:`with_pk_rows` (it costs
    # +112 MB at 1M tets, so TetVelocity-only runs skip it).
    tet_row_pk: jnp.ndarray | None = None
    # packed row for the ConvexPoly tracer (``traceIntet``,
    # ``ConvexQuery.cu:32-131``): cols 0:12 the 4 inward face normals,
    # 12:16 plane offsets, 16:20 neighbor codes, 20:24 global face ids
    # (exact float integers, < 2^24 faces in f32).  ONE gather per trace
    # hop instead of four; built lazily by :func:`with_convex_rows`.
    tet_row_cx: jnp.ndarray | None = None
    # ConvexPoly ENGINE table (ops/fused_convex.cx_table): cols 0:16 the
    # planes/offsets of tet_row_cx, 16:20 neighbor codes, 20:23 tet
    # velocity, 23 pad.  Kept as a mesh field so it enters jitted
    # programs as a PARAMETER (an in-jit intermediate leaves XLA free to
    # pick a column-major layout for it, which the row gather pays for).
    tet_row_cxe: jnp.ndarray | None = None

    @property
    def dtype(self):
        return self.points.dtype


# ---------------------------------------------------------------------------
# host-side (numpy) construction
# ---------------------------------------------------------------------------


def _cross(a, b):
    """Component-form cross product: ~3-4x faster than np.cross on big
    batches (np.cross pays generic moveaxis/broadcast machinery)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return np.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], axis=-1
    )


def _inv3(m):
    """Batched 3x3 inverse via the adjugate (beats LAPACK-per-matrix
    np.linalg.inv on millions of small matrices)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv = np.stack(
        [
            np.stack([A, B, C], axis=-1),
            np.stack([D, E, F], axis=-1),
            np.stack([G, H, I], axis=-1),
        ],
        axis=-2,
    )
    return inv / det[..., None, None]


def _inv3_jnp(m):
    """_inv3 in jnp (same adjugate formula) for on-device geometry
    refresh; elementwise only, no LAPACK/LU padding."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = a * A + b * D + c * G
    inv = jnp.stack(
        [
            jnp.stack([A, B, C], axis=-1),
            jnp.stack([D, E, F], axis=-1),
            jnp.stack([G, H, I], axis=-1),
        ],
        axis=-2,
    )
    return inv / det[..., None, None]


def _canonicalize_winding(points: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """Swap first two vertices of negative-volume tets (HostTetMesh.h:334-343).

    Degenerate (zero-volume) tets are left as-is; like the reference they get
    no usable faces and should not appear in valid inputs.
    """
    a, b, c, d = (points[tets[:, i]] for i in range(4))
    vol = np.einsum("ij,ij->i", d - a, _cross(b - a, c - a))
    tets = tets.copy()
    neg = vol < 0.0
    tets[neg, 0], tets[neg, 1] = tets[neg, 1].copy(), tets[neg, 0].copy()
    return tets


def build_face_tables(tets: np.ndarray):
    """Vectorized shared-face construction.

    Returns (faces[nf,3] sorted ids, tet_faces[nt,4], face_front[nf],
    face_back[nf], bd_face_ids, bd_tet, bd_slot) with the reference's
    front/back orientation-parity semantics (``HostTetMesh.h:265-304``):
    a tet is the *front* of a face iff sorting the Gmsh-order face triple
    ascending takes an odd number of swaps.  Boundary faces get their missing
    side filled with -(bdID+1) (1-based, ``HostTetMesh.h:393-411``).
    """
    nt = tets.shape[0]
    slot_faces = tets[:, FACE_SLOTS]                     # [nt, 4, 3]
    flat = slot_faces.reshape(-1, 3)                     # [4nt, 3]

    # orientation parity via the reference's 3-step sorting network
    f = flat.copy()
    front = np.zeros(len(f), dtype=bool)                 # starts False
    for i, j in ((0, 2), (1, 2), (0, 1)):
        swap = f[:, i] > f[:, j]
        fi, fj = f[swap, i].copy(), f[swap, j].copy()
        f[swap, i], f[swap, j] = fj, fi
        front ^= swap
    sorted_faces = f                                     # ascending triples

    # dedup by sorted triple.  For meshes with < 2^21 points, pack the
    # ascending triple into ONE int64 key (the reference's own trick,
    # ``HostTetMesh.h:279``): np.unique on a 1-D int64 is ~5x faster than
    # the axis=0 row unique (which sorts void views), and the key order
    # equals the lexicographic row order, so face numbering is identical.
    n_pts_max = int(flat.max()) + 1 if len(flat) else 1
    if n_pts_max < (1 << 21):
        key = (
            (sorted_faces[:, 0].astype(np.int64) << 42)
            | (sorted_faces[:, 1].astype(np.int64) << 21)
            | sorted_faces[:, 2].astype(np.int64)
        )
        _, first_idx, inverse, counts = np.unique(
            key, return_index=True, return_inverse=True, return_counts=True
        )
        faces = sorted_faces[first_idx]
    else:
        faces, inverse, counts = np.unique(
            sorted_faces, axis=0, return_inverse=True, return_counts=True
        )
    inverse = inverse.reshape(nt, 4)
    tet_faces = inverse.astype(np.int32)

    tet_ids = np.repeat(np.arange(nt, dtype=np.int32), 4)
    face_front = np.full(len(faces), -1, dtype=np.int32)
    face_back = np.full(len(faces), -1, dtype=np.int32)
    front_flat = front
    inv_flat = inverse.reshape(-1)
    face_front[inv_flat[front_flat]] = tet_ids[front_flat]
    face_back[inv_flat[~front_flat]] = tet_ids[~front_flat]

    # boundary faces: seen exactly once; number them in face-id order
    bd_mask = counts == 1
    bd_face_ids = np.nonzero(bd_mask)[0].astype(np.int32)
    bd_code = np.zeros(len(faces), dtype=np.int32)
    bd_code[bd_face_ids] = -(np.arange(len(bd_face_ids), dtype=np.int32) + 1)
    missing_front = bd_mask & (face_front == -1)
    missing_back = bd_mask & (face_back == -1)
    face_front[missing_front] = bd_code[missing_front]
    face_back[missing_back] = bd_code[missing_back]

    # owning (tet, slot) of each boundary face
    # For a boundary face there is exactly one incidence.
    order = np.argsort(inv_flat, kind="stable")
    first_idx = np.searchsorted(inv_flat[order], bd_face_ids)
    owner_flat = order[first_idx]
    bd_tet = (owner_flat // 4).astype(np.int32)
    bd_slot = (owner_flat % 4).astype(np.int32)

    return faces.astype(np.int32), tet_faces, face_front, face_back, bd_face_ids, bd_tet, bd_slot


def _build_walk_table(points, tets, tet_faces, face_front, face_back, bd_face_ids):
    """Precompute per-tet hop data: Tinv, neighbor ids, outward face planes."""
    a = points[tets[:, 0]]
    b = points[tets[:, 1]]
    c = points[tets[:, 2]]
    d = points[tets[:, 3]]
    m = np.stack([b - a, c - a, d - a], axis=-1)         # [nt,3,3]
    tinv = _inv3(m)

    # neighbor across slot face: the faceinfo side that isn't me; boundary
    # sides already hold -(bdID+1) so they flow through as negative codes —
    # but re-encode them as -(bdFaceSlot+1) in *boundary-face numbering* so a
    # negative neighbor identifies the boundary face (data-driven BCs).
    nf_front = face_front[tet_faces]                     # [nt,4]
    nf_back = face_back[tet_faces]
    tet_ids = np.arange(tets.shape[0], dtype=np.int32)[:, None]
    nbr = np.where(nf_front == tet_ids, nf_back, nf_front).astype(np.int32)
    # map negative bd codes (per-face numbering is already -(bdID+1)) as-is.

    # outward face planes from Gmsh-slot orientation (positive tets)
    slot_pts = points[tets[:, FACE_SLOTS]]               # [nt,4,3verts,3]
    p0, p1, p2 = slot_pts[:, :, 0], slot_pts[:, :, 1], slot_pts[:, :, 2]
    n = _cross(p1 - p0, p2 - p0)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    # explicit sequential dot, NOT einsum: einsum's SIMD accumulation
    # differs in the last ulp for ~30% of entries, and the native C++
    # builder (csrc/meshbuild.cpp) must be bit-faithful to this path
    dpl = n[..., 0] * p0[..., 0] + n[..., 1] * p0[..., 1] + n[..., 2] * p0[..., 2]
    return a, tinv, nbr, n, dpl


def from_arrays_host(
    points: np.ndarray,
    tets: np.ndarray,
    tet_vel: np.ndarray | None = None,
    vert_vel: np.ndarray | None = None,
    bd_patch: np.ndarray | None = None,
    dtype=None,
) -> dict:
    """All-numpy :class:`TetMesh` payload: field name -> numpy array (final
    dtypes) or python-int meta.

    The build never touches the accelerator; the payload pickles cleanly
    (on-disk tet cache) and uploads with :func:`host_to_device` in one
    host->device pass, with no device round trip in the build.
    """
    fdtype = np.dtype(canonical_float(dtype))
    points = np.asarray(points, dtype=np.float64)
    tets = np.asarray(tets, dtype=np.int64)

    from .io import native

    nat = native.build_tet_tables(points, tets) if len(tets) else None
    if nat is not None:
        # OpenMP C++ build (csrc/meshbuild.cpp) — bit-faithful to the numpy
        # path below (tests/test_mesh.py pins exact equality); ~15x faster
        # at reference-coupled scale (33 s -> ~2 s for 2.98M tets)
        (tets, faces, tet_faces, face_front, face_back, bd_face_ids,
         bd_tet, bd_slot, a, tinv, nbr, n, dpl) = nat
    else:
        tets = _canonicalize_winding(points, tets)
        faces, tet_faces, face_front, face_back, bd_face_ids, bd_tet, bd_slot = (
            build_face_tables(tets)
        )
        a, tinv, nbr, n, dpl = _build_walk_table(
            points, tets, tet_faces, face_front, face_back, bd_face_ids
        )

    nv, nt, nf, nbd = len(points), len(tets), len(faces), len(bd_face_ids)
    if tet_vel is None:
        tet_vel = np.zeros((nt, 3))
    if vert_vel is None:
        vert_vel = np.zeros((nv, 3))
    if bd_patch is None:
        bd_patch = np.zeros(nbd, dtype=np.int32)

    # outward-oriented boundary triangles = the owning tet's Gmsh slot face
    bd_tris = tets[bd_tet[:, None], FACE_SLOTS[bd_slot]].astype(np.int32)

    lo = points.min(axis=0) if nv else np.zeros(3)
    hi = points.max(axis=0) if nv else np.zeros(3)

    row = np.zeros((nt, 20))
    row[:, 0:3] = a
    row[:, 3:12] = tinv.reshape(nt, 9)
    row[:, 12:15] = tet_vel
    row[:, 15:19] = nbr.astype(np.float64)

    as_f = lambda x: np.asarray(x, dtype=fdtype)
    as_i = lambda x: np.asarray(x, dtype=np.int32)
    return dict(
        points=as_f(points),
        tets=as_i(tets),
        tet_vel=as_f(tet_vel),
        vert_vel=as_f(vert_vel),
        faces=as_i(faces),
        tet_faces=as_i(tet_faces),
        face_front=as_i(face_front),
        face_back=as_i(face_back),
        tet_a=as_f(a),
        tet_tinv=as_f(tinv),
        tet_nbr=as_i(nbr),
        tet_face_n=as_f(n),
        tet_face_d=as_f(dpl),
        tet_row=as_f(row),
        bd_tris=as_i(bd_tris),
        bd_tet=as_i(bd_tet),
        bd_patch=as_i(bd_patch),
        bd_escape=np.zeros(nbd, dtype=bool),
        bounds_lo=as_f(lo),
        bounds_hi=as_f(hi),
        n_points=nv,
        n_tets=nt,
        n_faces=nf,
        n_bd_faces=nbd,
    )


# --------------------------------------------------------------------------
# host mirror registry
#
# Host-side consumers (grid locator build, engine auto-tuning, spatial
# partitioning, VTK export) need numpy views of mesh arrays.  Rather than
# read them back from the device, every mesh built from a host payload
# keeps its numpy arrays alive in this id-keyed side table and
# :func:`host_np` serves reads from it.
# Derived meshes (velocity refresh, escape tags, lazy row tables) propagate
# the mirror with the affected fields updated host-side when the update
# came from numpy, or dropped when it was device-computed.
# --------------------------------------------------------------------------

import weakref

_HOST_MIRRORS: dict = {}


def _attach_mirror(mesh: "TetMesh", host: dict) -> None:
    key = id(mesh)
    _HOST_MIRRORS[key] = host
    weakref.finalize(mesh, _HOST_MIRRORS.pop, key, None)


def _mirror_of(mesh: "TetMesh") -> dict | None:
    return _HOST_MIRRORS.get(id(mesh))


def host_np(mesh: "TetMesh", name: str, dtype=None) -> np.ndarray:
    """Numpy view of a mesh field: mirror hit (free) or device readback
    (fallback — correct everywhere, costs a device->host copy)."""
    mirror = _HOST_MIRRORS.get(id(mesh))
    if mirror is not None and mirror.get(name) is not None:
        arr = mirror[name]
    else:
        arr = np.asarray(getattr(mesh, name))
    if dtype is not None and arr.dtype != np.dtype(dtype):
        arr = arr.astype(dtype)
    return arr


def _propagate_mirror(old_mesh, new_mesh, updates: dict | None = None,
                      drop: tuple = ()) -> None:
    """Carry the host mirror onto a derived mesh.  ``updates`` values that
    are numpy land in the mirror; device-computed values (jax arrays /
    tracers) invalidate their field instead."""
    mirror = _HOST_MIRRORS.get(id(old_mesh))
    if mirror is None:
        return
    new = dict(mirror)
    for name in drop:
        new.pop(name, None)
    for name, val in (updates or {}).items():
        if isinstance(val, np.ndarray):
            new[name] = val
        else:
            new.pop(name, None)
    _attach_mirror(new_mesh, new)


def host_to_device(host: dict) -> TetMesh:
    """Upload a :func:`from_arrays_host` payload: one h2d transfer per field,
    dtypes already final.  The numpy payload stays attached as the mesh's
    host mirror (see :func:`host_np`)."""
    m = TetMesh(
        **{
            k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in host.items()
        }
    )
    _attach_mirror(m, host)
    return m


def from_arrays(
    points: np.ndarray,
    tets: np.ndarray,
    tet_vel: np.ndarray | None = None,
    vert_vel: np.ndarray | None = None,
    bd_patch: np.ndarray | None = None,
    dtype=None,
) -> TetMesh:
    """Build a :class:`TetMesh` from raw numpy arrays.

    ``bd_patch``: optional per-boundary-face patch tags keyed by the
    boundary-face ordering produced here (use :func:`boundary_face_centroids`
    to map external patch data onto it).
    """
    return host_to_device(
        from_arrays_host(
            points, tets, tet_vel=tet_vel, vert_vel=vert_vel,
            bd_patch=bd_patch, dtype=dtype,
        )
    )


# ---------------------------------------------------------------------------
# builders / fixtures
# ---------------------------------------------------------------------------


def box_points_tets(nx: int, ny: int, nz: int):
    """Host-only (points, tets, vert_vel) of the box fixture — the
    topology/geometry of :func:`box_mesh` without building any tables
    (callers that perturb the points first avoid a second table build)."""
    xs = np.arange(nx + 1, dtype=np.float64)
    ys = np.arange(ny + 1, dtype=np.float64)
    zs = np.arange(nz + 1, dtype=np.float64)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)

    center = np.array([nx, ny, nz], dtype=np.float64) / 2.0
    rel = points - center
    norm = np.linalg.norm(rel, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        vert_vel = np.where(norm > 0.0, rel / norm, np.array([1.0, 0.0, 0.0]))

    iz, iy, ix = np.meshgrid(
        np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
    )
    v0 = (iz * (nx + 1) * (ny + 1) + iy * (nx + 1) + ix).ravel()
    v1 = v0 + 1
    v2 = v0 + (nx + 1)
    v3 = v1 + (nx + 1)
    v4 = v0 + (nx + 1) * (ny + 1)
    v5 = v1 + (nx + 1) * (ny + 1)
    v6 = v2 + (nx + 1) * (ny + 1)
    v7 = v3 + (nx + 1) * (ny + 1)
    # same 6-tet split as HostTetMesh.h:131-136
    tets = np.stack(
        [
            np.stack([v0, v1, v3, v7], axis=-1),
            np.stack([v0, v1, v7, v5], axis=-1),
            np.stack([v0, v5, v7, v4], axis=-1),
            np.stack([v0, v3, v2, v7], axis=-1),
            np.stack([v0, v6, v4, v7], axis=-1),
            np.stack([v0, v2, v6, v7], axis=-1),
        ],
        axis=1,
    ).reshape(-1, 4)
    return points, tets, vert_vel


def box_mesh(nx: int, ny: int, nz: int, dtype=None) -> TetMesh:
    """Synthetic box fixture: nx*ny*nz hexes, 6 tets each, radial velocity.

    Bit-matches the reference's ``HostTetMesh::createBoxMesh``
    (``HostTetMesh.h:62-144``): unit-spaced vertices over [0,n]^3, the 6-tet
    Kuhn split per hex in the same vertex order, per-vertex velocity
    normalize(pos - center) (with the center vertex itself set to (1,0,0)).
    """
    points, tets, vert_vel = box_points_tets(nx, ny, nz)
    # per-tet velocity: vertex average (for the TetVelocity fast path)
    tet_vel = vert_vel[tets].mean(axis=1)
    return from_arrays(points, tets, tet_vel=tet_vel, vert_vel=vert_vel, dtype=dtype)


def read_dataset(
    vert_fname: str,
    cell_fname: str,
    solv_fname: str | None = None,
    solc_fname: str | None = None,
    dtype=None,
) -> TetMesh:
    """ASCII vert/cell/solution reader (``HostTetMesh::readDataSet``,
    ``HostTetMesh.h:146-262``): vert.dat (header + xyz rows), cell.dat
    (header + 4 ids), solution.dat (p u v w rows, per-vertex or per-cell)."""
    with open(vert_fname) as fh:
        header = fh.readline().split()
        nv = int(header[-1])
        fh.readline()  # column comment
        points = np.loadtxt(fh, max_rows=nv, ndmin=2)
    with open(cell_fname) as fh:
        header = fh.readline().split()
        nt = int(header[-1])
        fh.readline()
        tets = np.loadtxt(fh, dtype=np.int64, max_rows=nt, ndmin=2)

    vert_vel = None
    tet_vel = None
    if solv_fname:
        with open(solv_fname) as fh:
            fh.readline()
            sol = np.loadtxt(fh, max_rows=nv, ndmin=2)
        vert_vel = sol[:, 1:4]
    elif solc_fname:
        with open(solc_fname) as fh:
            fh.readline()
            sol = np.loadtxt(fh, max_rows=nt, ndmin=2)
        tet_vel = sol[:, 1:4]

    return from_arrays(points, tets, tet_vel=tet_vel, vert_vel=vert_vel, dtype=dtype)


def replace_velocity(mesh: TetMesh, tet_vel=None, vert_vel=None) -> TetMesh:
    """Functional velocity refresh (replaces ``cudaUpdateVelocity``,
    ``particles.cu:733-749``): returns a mesh with new velocity arrays."""
    import dataclasses

    kw = {}
    mirror_updates = {}
    if tet_vel is not None:
        tv = jnp.asarray(tet_vel, dtype=mesh.dtype)
        kw["tet_vel"] = tv
        kw["tet_row"] = mesh.tet_row.at[:, 12:15].set(tv)
        if mesh.tet_row_cxe is not None:
            kw["tet_row_cxe"] = mesh.tet_row_cxe.at[:, 20:23].set(tv)
            mirror_updates["tet_row_cxe"] = tv           # invalidates
        if isinstance(tet_vel, np.ndarray):
            tv_np = tet_vel.astype(np.dtype(mesh.dtype), copy=False)
            mirror_updates["tet_vel"] = tv_np
            old_row = _mirror_of(mesh) and _mirror_of(mesh).get("tet_row")
            if old_row is not None:
                row = old_row.copy()
                row[:, 12:15] = tv_np
                mirror_updates["tet_row"] = row
        else:
            mirror_updates["tet_vel"] = tet_vel      # invalidates
            mirror_updates["tet_row"] = tet_vel
    if vert_vel is not None:
        vv = jnp.asarray(vert_vel, dtype=mesh.dtype)
        kw["vert_vel"] = vv
        mirror_updates["vert_vel"] = (
            vert_vel if isinstance(vert_vel, np.ndarray) else vv
        )
        if mesh.tet_row_pk is not None:
            kw["tet_row_pk"] = mesh.tet_row_pk.at[:, 12:24].set(
                vv[mesh.tets].reshape(mesh.n_tets, 12)
            )
            mirror_updates["tet_row_pk"] = kw["tet_row_pk"]  # invalidates
    new = dataclasses.replace(mesh, **kw)
    _propagate_mirror(mesh, new, mirror_updates)
    return new


def refresh_geometry(mesh: TetMesh, new_points) -> TetMesh:
    """Recompute all geometric tables for MOVED vertices (same topology).

    The moving-mesh path (``mesh.controlledUpdate()``,
    ``cudaParticlesPimpleFoam.C:147``): tets/faces/neighbor codes are
    unchanged, so only A, Tinv, face planes, packed-row geometry columns,
    and bounds refresh — all jittable array math (runs on device each
    Eulerian step)."""
    import dataclasses

    pts = jnp.asarray(new_points, mesh.dtype)
    tets = mesh.tets
    nt = mesh.n_tets
    a = pts[tets[:, 0]]
    b = pts[tets[:, 1]]
    c = pts[tets[:, 2]]
    d = pts[tets[:, 3]]
    m3 = jnp.stack([b - a, c - a, d - a], axis=-1)
    # adjugate inverse (the device twin of _inv3): the closed form is pure
    # elementwise math, where jnp.linalg.inv is a batched LU whose
    # temporaries can dwarf the operand at millions of tets
    tinv = _inv3_jnp(m3)
    slot_pts = pts[tets[:, FACE_SLOTS]]                  # [nt,4,3,3]
    p0, p1, p2 = slot_pts[:, :, 0], slot_pts[:, :, 1], slot_pts[:, :, 2]
    n = jnp.cross(p1 - p0, p2 - p0)
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    dpl = jnp.einsum("ntk,ntk->nt", n, p0, precision=lax.Precision.HIGHEST)
    row = mesh.tet_row.at[:, 0:3].set(a).at[:, 3:12].set(tinv.reshape(nt, 9))
    kw = {}
    if mesh.tet_row_pk is not None:
        kw["tet_row_pk"] = (
            mesh.tet_row_pk.at[:, 0:3].set(a).at[:, 3:12].set(
                tinv.reshape(nt, 9)
            )
        )
    if mesh.tet_row_cx is not None:
        kw["tet_row_cx"] = (
            mesh.tet_row_cx.at[:, 0:12].set(n.reshape(nt, 12))
            .at[:, 12:16].set(dpl)
        )
    if mesh.tet_row_cxe is not None:
        kw["tet_row_cxe"] = (
            mesh.tet_row_cxe.at[:, 0:12].set(n.reshape(nt, 12))
            .at[:, 12:16].set(dpl)
        )
    new = dataclasses.replace(
        mesh,
        points=pts,
        tet_a=a,
        tet_tinv=tinv,
        tet_face_n=n,
        tet_face_d=dpl,
        tet_row=row,
        bounds_lo=jnp.min(pts, axis=0),
        bounds_hi=jnp.max(pts, axis=0),
        **kw,
    )
    # geometry fields are device-recomputed: drop them from the mirror
    # (topology/meta fields stay valid).  No-op under jit tracing.
    if not isinstance(pts, jax.core.Tracer):
        _propagate_mirror(
            mesh, new,
            drop=("points", "tet_a", "tet_tinv", "tet_face_n", "tet_face_d",
                  "tet_row", "tet_row_pk", "tet_row_cx", "tet_row_cxe",
                  "bounds_lo", "bounds_hi"),
        )
    return new


def with_convex_rows(mesh: TetMesh) -> TetMesh:
    """Attach the ConvexPoly packed row table (lazy: +24 floats/tet).

    Collapses the tracer's four per-hop gathers (face normals, plane
    offsets, neighbor codes, face ids) into one — gather cost is per
    INDEX, so the trace's while-loop trips get ~4x cheaper."""
    import dataclasses

    if mesh.tet_row_cx is not None:
        return mesh
    nt = mesh.n_tets
    row = jnp.concatenate(
        [
            mesh.tet_face_n.reshape(nt, 12),
            mesh.tet_face_d,
            mesh.tet_nbr.astype(mesh.dtype),
            mesh.tet_faces.astype(mesh.dtype),
        ],
        axis=1,
    )
    cxe = jnp.concatenate(
        [
            row[:, 0:20],
            mesh.tet_vel.astype(mesh.dtype),
            jnp.zeros((nt, 1), mesh.dtype),
        ],
        axis=1,
    )
    new = dataclasses.replace(mesh, tet_row_cx=row, tet_row_cxe=cxe)
    mirror = _mirror_of(mesh)
    updates = {}
    if mirror is not None and all(
        mirror.get(k) is not None
        for k in ("tet_face_n", "tet_face_d", "tet_nbr", "tet_faces",
                  "tet_vel")
    ):
        fdt = np.dtype(mesh.dtype)
        updates["tet_row_cx"] = np.concatenate(
            [
                mirror["tet_face_n"].reshape(nt, 12),
                mirror["tet_face_d"],
                mirror["tet_nbr"].astype(fdt),
                mirror["tet_faces"].astype(fdt),
            ],
            axis=1,
        )
        updates["tet_row_cxe"] = np.concatenate(
            [
                updates["tet_row_cx"][:, 0:20],
                mirror["tet_vel"].astype(fdt),
                np.zeros((nt, 1), fdt),
            ],
            axis=1,
        )
    else:
        updates["tet_row_cx"] = row                      # invalidates
        updates["tet_row_cxe"] = cxe
    _propagate_mirror(mesh, new, updates)
    return new


def with_pk_rows(mesh: TetMesh) -> TetMesh:
    """Attach the VertexVelocity packed row table (lazy: +29 floats/tet).

    Row: A 0:3 | Tinv 3:12 | v0..v3 12:24 | neighbor codes 24:28 |
    escape mask 28 — one gather serves the bary test, the Pk velocity
    interpolation (``particles.cu:245-313``), the neighbor step, the
    reflection plane, and the absorbing-patch check, exactly like
    ``tet_row`` does for TetVelocity (whose mask rides pad col 19).
    The mask column is copied from ``tet_row`` col 19, so a prior
    :func:`set_boundary_escape` is inherited."""
    import dataclasses

    if mesh.tet_row_pk is not None:
        return mesh
    nt = mesh.n_tets
    row = jnp.concatenate(
        [
            mesh.tet_row[:, 0:12],
            mesh.vert_vel[mesh.tets].reshape(nt, 12),
            mesh.tet_row[:, 15:19],
            mesh.tet_row[:, 19:20],
        ],
        axis=1,
    )
    new = dataclasses.replace(mesh, tet_row_pk=row)
    mirror = _mirror_of(mesh)
    updates = {}
    if mirror is not None and all(
        mirror.get(k) is not None for k in ("tet_row", "vert_vel", "tets")
    ):
        updates["tet_row_pk"] = np.concatenate(
            [
                mirror["tet_row"][:, 0:12],
                mirror["vert_vel"][mirror["tets"]].reshape(nt, 12),
                mirror["tet_row"][:, 15:19],
                mirror["tet_row"][:, 19:20],
            ],
            axis=1,
        )
    else:
        updates["tet_row_pk"] = row                      # invalidates
    _propagate_mirror(mesh, new, updates)
    return new


def set_boundary_escape(mesh: TetMesh, escape_patch_ids) -> TetMesh:
    """Mark boundary faces of the given patch ids as absorbing (particles
    crossing them leave the domain and are deactivated instead of being
    specularly reflected).  This is the data-driven fix for the reference's
    reflect-everywhere TODO (``RTQuery.cu:165-166``), keyed off the OpenFOAM
    patch tags carried by ``bd_patch``."""
    import dataclasses

    ids = jnp.asarray(list(escape_patch_ids), dtype=jnp.int32)
    esc = jnp.isin(mesh.bd_patch, ids) if len(escape_patch_ids) else jnp.zeros(
        mesh.n_bd_faces, dtype=bool
    )
    # bake the per-tet 4-bit escape mask into tet_row col 19 (the walk
    # row's pad column): bit s = bd_escape of slot s's boundary face.
    # A stream kernel can read it in place of the bd_escape gather; the
    # XLA engine keeps gathering bd_escape — same booleans.
    nbr = mesh.tet_nbr
    bdi = jnp.clip(-nbr - 1, 0, max(mesh.n_bd_faces - 1, 0))
    bits = (nbr < 0) & esc[bdi]
    maskv = (
        bits.astype(jnp.int32) * jnp.asarray([1, 2, 4, 8], jnp.int32)
    ).sum(axis=1)
    row = mesh.tet_row.at[:, 19].set(maskv.astype(mesh.tet_row.dtype))
    kw = {"bd_escape": esc, "tet_row": row}
    if mesh.tet_row_pk is not None:
        # the Pk row carries the same mask at its col 28
        kw["tet_row_pk"] = mesh.tet_row_pk.at[:, 28].set(
            maskv.astype(mesh.tet_row_pk.dtype)
        )
    new = dataclasses.replace(mesh, **kw)
    mirror = _mirror_of(mesh)
    updates = {}
    if mirror is not None and mirror.get("bd_patch") is not None:
        esc_np = (
            np.isin(mirror["bd_patch"], np.asarray(list(escape_patch_ids)))
            if len(escape_patch_ids)
            else np.zeros(mesh.n_bd_faces, dtype=bool)
        )
        updates["bd_escape"] = esc_np
        if mirror.get("tet_nbr") is not None and mirror.get("tet_row") is not None:
            nbr_np = mirror["tet_nbr"]
            bdi_np = np.clip(-nbr_np - 1, 0, max(mesh.n_bd_faces - 1, 0))
            bits_np = (nbr_np < 0) & esc_np[bdi_np]
            row_np = np.array(mirror["tet_row"], copy=True)
            maskv_np = (
                bits_np.astype(np.int64) * np.array([1, 2, 4, 8])
            ).sum(axis=1)
            row_np[:, 19] = maskv_np
            updates["tet_row"] = row_np
            if mesh.tet_row_pk is not None:
                if mirror.get("tet_row_pk") is not None:
                    pk_np = np.array(mirror["tet_row_pk"], copy=True)
                    pk_np[:, 28] = maskv_np
                    updates["tet_row_pk"] = pk_np
                else:
                    updates["tet_row_pk"] = kw["tet_row_pk"]  # invalidates
        else:
            updates["tet_row"] = row                     # invalidates
            if mesh.tet_row_pk is not None:
                updates["tet_row_pk"] = kw["tet_row_pk"]
    else:
        updates["bd_escape"] = esc                       # invalidates
        updates["tet_row"] = row
        if mesh.tet_row_pk is not None:
            updates["tet_row_pk"] = kw["tet_row_pk"]
    _propagate_mirror(mesh, new, updates)
    return new
