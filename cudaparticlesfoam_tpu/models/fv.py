"""Unstructured finite-volume operators and linear solvers in JAX.

The XLA foundation for the flow solvers (:mod:`.simple`,
:mod:`.pimple`) that replace the reference's OpenFOAM side
(``applications/cudaParticlesPimpleFoam/{UEqn.H,pEqn.H}``): collocated
FV on the same ``constant/polyMesh``, matrix-free LDU operators assembled
per face with ``segment_sum``, Jacobi-smoothed momentum and
Jacobi-preconditioned CG pressure solves, everything jit-compiled with
static iteration structure (``lax.while_loop`` on residuals).

Discretization notes (kept deliberately standard):
* face interpolation: linear, distance-weighted
* convection: first-order upwind (bounded; the tutorials' limitedLinear /
  linearUpwind schemes differ mainly in smearing, not topology)
* diffusion: orthogonal component implicit; non-orthogonal correction
  explicit (over-relaxed approach), optional correctors
* boundary conditions: affine per-face form ``phi_f = a * phi_P + b``
  which covers fixedValue (a=0,b=v), zeroGradient (a=1,b=0), noSlip,
  and 2-D ``empty`` patches (zero-flux)
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..io.polymesh import PolyMesh, cell_centres_volumes, face_centres_areas
from ..utils.pytree import pytree_dataclass


@pytree_dataclass(meta_fields=("n_cells", "n_faces", "n_internal", "patch_slices"))
class FvMesh:
    """Device-resident FV geometry derived from a PolyMesh."""

    owner: jnp.ndarray        # [nf] int32
    neighbour: jnp.ndarray    # [n_int] int32
    sf: jnp.ndarray           # [nf, 3] face area vectors (outward from owner)
    mag_sf: jnp.ndarray       # [nf]
    cf: jnp.ndarray           # [nf, 3] face centres
    cc: jnp.ndarray           # [nc, 3] cell centres
    vol: jnp.ndarray          # [nc]
    w: jnp.ndarray            # [n_int] linear weights (owner side)
    delta: jnp.ndarray        # [n_int] orthogonal delta coeffs |Sf|/(Sf.d/|Sf|)
    bd_delta: jnp.ndarray     # [n_bd] boundary delta coeffs
    nonortho: jnp.ndarray     # [n_int, 3] non-orthogonal correction vector k
    n_cells: int
    n_faces: int
    n_internal: int
    patch_slices: tuple       # ((name, type, start, count), ...) in bd-face numbering


def fv_mesh(pm: PolyMesh, dtype=jnp.float32) -> FvMesh:
    f_ctr, f_area = face_centres_areas(pm)
    c_ctr, c_vol = cell_centres_volumes(pm, f_ctr, f_area)
    n_int = pm.n_internal_faces
    own, nei = pm.owner, pm.neighbour

    mag = np.linalg.norm(f_area, axis=1)
    # linear interpolation weights (OpenFOAM surfaceInterpolation):
    # w = |Cf - Cn| projected : use distance along face normal
    d_on = c_ctr[nei] - c_ctr[own[:n_int]]
    nhat = f_area[:n_int] / np.maximum(mag[:n_int], 1e-300)[:, None]
    d_fn = np.einsum("ij,ij->i", c_ctr[nei] - f_ctr[:n_int], nhat)
    d_of = np.einsum("ij,ij->i", f_ctr[:n_int] - c_ctr[own[:n_int]], nhat)
    w = d_fn / np.maximum(d_fn + d_of, 1e-300)

    # orthogonal delta coefficient (over-relaxed): |Sf|^2 / (Sf . d)
    sf_dot_d = np.einsum("ij,ij->i", f_area[:n_int], d_on)
    delta = mag[:n_int] ** 2 / np.maximum(sf_dot_d, 1e-300)
    # non-orthogonal correction vector: k = Sf - delta * d
    k = f_area[:n_int] - delta[:, None] * d_on

    # boundary deltas: |Sf| / (n . (Cf - Co))
    bd_own = own[n_int:]
    d_b = np.einsum(
        "ij,ij->i",
        f_ctr[n_int:] - c_ctr[bd_own],
        f_area[n_int:] / np.maximum(mag[n_int:], 1e-300)[:, None],
    )
    bd_delta = mag[n_int:] / np.maximum(d_b, 1e-300)

    patch_slices = tuple(
        (name, ptype, start - n_int, cnt) for name, ptype, start, cnt in pm.patches
    )
    as_f = lambda x: jnp.asarray(x, dtype=dtype)
    return FvMesh(
        owner=jnp.asarray(own, jnp.int32),
        neighbour=jnp.asarray(nei, jnp.int32),
        sf=as_f(f_area),
        mag_sf=as_f(mag),
        cf=as_f(f_ctr),
        cc=as_f(c_ctr),
        vol=as_f(c_vol),
        w=as_f(w),
        delta=as_f(delta),
        bd_delta=as_f(bd_delta),
        nonortho=as_f(k),
        n_cells=pm.n_cells,
        n_faces=pm.n_faces,
        n_internal=n_int,
        patch_slices=patch_slices,
    )


# ---------------------------------------------------------------------------
# boundary conditions: phi_f = a * phi_owner + b  (per boundary face)
# ---------------------------------------------------------------------------


@pytree_dataclass
class BoundaryCoeffs:
    a: jnp.ndarray   # [n_bd] or [n_bd,1] multiplier on owner value
    b: jnp.ndarray   # [n_bd, ncomp] offset
    # inletOutlet-family switching (OpenFOAM inletOutlet: zeroGradient on
    # outflow, fixedValue(inletValue) on backflow): faces flagged here flip
    # per outer iteration based on the current flux sign
    io_mask: jnp.ndarray | None = None    # [n_bd] bool
    io_value: jnp.ndarray | None = None   # [n_bd, ncomp]
    # slip/symmetry faces: for vector fields the face value is the owner
    # value with the face-normal component removed (U_f = U_P - (U_P.n)n);
    # a tensor relation the scalar affine form cannot express, handled as
    # a projection in boundary_value.  Scalars fall back to zeroGradient.
    slip_mask: jnp.ndarray | None = None  # [n_bd] bool


def make_bcs(m: FvMesh, spec: dict, n_comp: int, default="zeroGradient", dtype=None):
    """Build affine BC coefficients from a {patch: (type, value)} spec.

    Supported types: fixedValue, zeroGradient, noSlip, empty, slip,
    calculated; pressure-coupled OpenFOAM types are mapped to their
    affine essence: totalPressure/uniformTotalPressure -> fixedValue (at
    the supplied value), inletOutlet / pressureInletOutletVelocity /
    outletInlet / pressureInletOutletParSlipVelocity -> zeroGradient (the
    outflow branch; backflow limiting is not modeled).
    """
    dtype = dtype or m.sf.dtype
    n_bd = m.n_faces - m.n_internal
    a = np.ones(n_bd)
    b = np.zeros((n_bd, n_comp))
    io_mask = np.zeros(n_bd, bool)
    io_value = np.zeros((n_bd, n_comp))
    slip_mask = np.zeros(n_bd, bool)
    fixed_types = ("fixedValue", "noSlip", "totalPressure", "uniformTotalPressure",
                   "uniformFixedValue", "movingWallVelocity")
    grad_types = ("zeroGradient", "empty", "calculated",
                  "outletInlet", "waveTransmissive")
    # tangential projection for vectors; identical to zeroGradient for
    # scalars (parSlip's tangential part is slip too)
    slip_types = ("slip", "symmetry", "symmetryPlane",
                  "pressureInletOutletParSlipVelocity")
    io_types = ("inletOutlet", "pressureInletOutletVelocity")
    for name, ptype, start, cnt in m.patch_slices:
        entry = spec.get(name)
        btype = entry[0] if entry else default
        val = entry[1] if entry and len(entry) > 1 else 0.0
        sl = slice(start, start + cnt)
        if btype in fixed_types:
            a[sl] = 0.0
            b[sl] = np.broadcast_to(
                np.zeros(n_comp) if btype == "noSlip"
                else np.asarray(0.0 if val is None else val, float),
                (cnt, n_comp),
            )
        elif btype in grad_types:
            a[sl] = 1.0
            b[sl] = 0.0
        elif btype in slip_types:
            a[sl] = 1.0
            b[sl] = 0.0
            slip_mask[sl] = True
        elif btype in io_types:
            # outflow branch (zeroGradient) as the base; backflow flips to
            # fixedValue(inletValue) via effective_bcs per outer iteration
            a[sl] = 1.0
            b[sl] = 0.0
            io_mask[sl] = True
            io_value[sl] = np.broadcast_to(
                np.asarray(0.0 if val is None else val, float), (cnt, n_comp)
            )
        else:
            raise ValueError(f"unsupported BC type {btype!r} on patch {name!r}")
    return BoundaryCoeffs(
        a=jnp.asarray(a, dtype),
        b=jnp.asarray(b, dtype).reshape(n_bd, n_comp),
        io_mask=jnp.asarray(io_mask),
        io_value=jnp.asarray(io_value, dtype).reshape(n_bd, n_comp),
        slip_mask=jnp.asarray(slip_mask) if slip_mask.any() else None,
    )


def effective_bcs(bc: BoundaryCoeffs, flux_b) -> BoundaryCoeffs:
    """Per-iteration inletOutlet switching: faces with inflow (flux < 0)
    become fixedValue(inletValue); outflow faces stay zeroGradient
    (OpenFOAM inletOutlet / pressureInletOutletVelocity semantics — the
    backflow limiting the round-1 build collapsed to zeroGradient)."""
    if bc.io_mask is None:
        return bc
    import dataclasses as _dc

    inflow = bc.io_mask & (flux_b < 0.0)
    a = jnp.where(inflow, 0.0, bc.a)
    b = jnp.where(inflow[:, None], bc.io_value, bc.b)
    return _dc.replace(bc, a=a, b=b)


def boundary_value(m: FvMesh, bc: BoundaryCoeffs, phi):
    """phi on boundary faces: a * phi_owner + b (slip faces: tangential
    projection for vectors — zeroes the wall-normal component so slip
    walls carry no mass flux)."""
    own = m.owner[m.n_internal :]
    po = phi[own]
    if phi.ndim == 1:
        return bc.a * po + bc.b[:, 0]
    out = bc.a[:, None] * po + bc.b
    if bc.slip_mask is not None:
        nhat = m.sf[m.n_internal :] / m.mag_sf[m.n_internal :, None]
        tang = po - jnp.sum(po * nhat, axis=-1, keepdims=True) * nhat
        out = jnp.where(bc.slip_mask[:, None], tang, out)
    return out


# ---------------------------------------------------------------------------
# core operators
# ---------------------------------------------------------------------------


def face_interp(m: FvMesh, phi):
    """Linear face interpolation (internal faces)."""
    o = phi[m.owner[: m.n_internal]]
    n = phi[m.neighbour]
    w = m.w if phi.ndim == 1 else m.w[:, None]
    return w * o + (1.0 - w) * n


def surface_sum(m: FvMesh, face_vals):
    """Sum of per-face values into cells with owner +, neighbour - signs."""
    nc = m.n_cells
    out = jnp.zeros((nc,) + face_vals.shape[1:], dtype=face_vals.dtype)
    out = out.at[m.owner].add(face_vals)
    out = out.at[m.neighbour].add(-face_vals[: m.n_internal])
    return out


def divergence(m: FvMesh, face_flux):
    """div of a face flux field -> per-cell (per unit volume)."""
    v = m.vol if face_flux.ndim == 1 else m.vol[:, None]
    return surface_sum(m, face_flux) / v


def gradient(m: FvMesh, phi, bc: BoundaryCoeffs):
    """Gauss gradient of a scalar field -> [nc, 3]."""
    pf_i = face_interp(m, phi)
    pf_b = boundary_value(m, bc, phi)
    pf = jnp.concatenate([pf_i, pf_b])
    return surface_sum(m, pf[:, None] * m.sf) / m.vol[:, None]


def flux_of(m: FvMesh, u, bc_u: BoundaryCoeffs):
    """Mass flux phi = U_f . Sf on all faces."""
    uf_i = face_interp(m, u)
    uf_b = boundary_value(m, bc_u, u)
    uf = jnp.concatenate([uf_i, uf_b])
    return jnp.sum(uf * m.sf, axis=-1)


def convection_correction(m: FvMesh, flux, phi, bc: BoundaryCoeffs, scheme: str,
                          grad=None):
    """Deferred second-order convection correction source [nc, ncomp].

    The implicit matrix stays first-order upwind (bounded, diagonally
    dominant); the difference between the high-order face value and the
    upwind value is added explicitly:  b += -sum_f F (phi_HO - phi_UD).
    Schemes (``system/fvSchemes`` divSchemes):

    * ``linearUpwind``: phi_HO = phi_UP + grad(phi)_UP . (Cf - C_UP)
      (``bounded Gauss linearUpwind grad(U)``, pitzDaily fvSchemes:31)
    * ``limitedLinear`` (k=1): phi_HO = phi_UD + psi (phi_lin - phi_UD)
      with the OpenFOAM limiter psi = clamp(2 r, 0, 1),
      r = 2 (d . grad(phi)_UP) / (phi_D - phi_UP) - 1; for vectors the
      face limiter is the min over components (the ``V``-scheme's
      conservative direction, ``Gauss limitedLinearV 1``,
      TJunction fvSchemes:31)
    * ``linear``: unlimited central difference (deferred)
    """
    if scheme in ("upwind", "", None):
        nc = m.n_cells
        ncomp = 1 if phi.ndim == 1 else phi.shape[1]
        return jnp.zeros((nc, ncomp), m.sf.dtype)
    ph = phi[:, None] if phi.ndim == 1 else phi
    n_int = m.n_internal
    f_i = flux[:n_int]
    own = m.owner[:n_int]
    nei = m.neighbour
    up = jnp.where(f_i >= 0.0, own, nei)
    dn = jnp.where(f_i >= 0.0, nei, own)
    phi_up = ph[up]
    phi_dn = ph[dn]
    w = m.w[:, None]
    phi_lin = w * ph[own] + (1.0 - w) * ph[nei]

    # per-component Gauss gradient (one surface sum for all components);
    # sharded callers pass a halo-refreshed gradient so remote upwind
    # cells see correct values
    if grad is None:
        pf_i = w * ph[own] + (1.0 - w) * ph[nei]
        pf_b = boundary_value(m, bc, ph)
        pf = jnp.concatenate([pf_i, pf_b])
        grad = surface_sum(m, pf[:, :, None] * m.sf[:, None, :]) / m.vol[:, None, None]

    if scheme == "linearUpwind":
        d_up = m.cf[:n_int] - m.cc[up]
        phi_ho = phi_up + jnp.einsum("fcd,fd->fc", grad[up], d_up,
                                     precision=lax.Precision.HIGHEST)
    elif scheme == "limitedLinear":
        d = m.cc[nei] - m.cc[own]
        # r in upwind orientation: d points up->down for F>=0, down->up else
        dsign = jnp.where(f_i >= 0.0, 1.0, -1.0)[:, None]
        dgrad = jnp.einsum("fcd,fd->fc", grad[up], d,
                           precision=lax.Precision.HIGHEST) * dsign
        denom = phi_dn - phi_up
        r = 2.0 * dgrad / jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30) - 1.0
        psi = jnp.clip(2.0 * r, 0.0, 1.0)
        psi = jnp.min(psi, axis=1, keepdims=True)      # V-scheme direction
        phi_ho = phi_up + psi * (phi_lin - phi_up)
    elif scheme == "linear":
        phi_ho = phi_lin
    else:
        raise ValueError(f"unknown convection scheme {scheme!r}")

    corr_f = f_i[:, None] * (phi_ho - phi_up)
    out = jnp.zeros((m.n_cells, ph.shape[1]), m.sf.dtype)
    out = out.at[own].add(-corr_f)
    out = out.at[nei].add(corr_f)
    return out


def nonortho_flux(m: FvMesh, rau_f, p, p_bcs: BoundaryCoeffs):
    """Explicit non-orthogonal pressure-diffusion flux on internal faces:
    rau_f (k . grad(p)_f) with k the over-relaxed correction vector
    (``pEqn.H:42-57`` non-orthogonal corrector loop)."""
    n_int = m.n_internal
    gp = gradient(m, p, p_bcs)
    w = m.w[:, None]
    gpf = w * gp[m.owner[:n_int]] + (1.0 - w) * gp[m.neighbour]
    return rau_f[:n_int] * jnp.sum(m.nonortho * gpf, axis=-1)


def surface_sum_internal(m: FvMesh, face_vals):
    """surface_sum restricted to internal faces."""
    nc = m.n_cells
    out = jnp.zeros((nc,) + face_vals.shape[1:], dtype=face_vals.dtype)
    out = out.at[m.owner[: m.n_internal]].add(face_vals)
    out = out.at[m.neighbour].add(-face_vals)
    return out


# ---------------------------------------------------------------------------
# matrix-free LDU operator: A(phi) with upwind convection + diffusion
# ---------------------------------------------------------------------------


@pytree_dataclass
class FvMatrix:
    """Implicit coefficients of a transport operator.

    A phi |_P = diag_P phi_P + sum_f lower/upper couplings; assembled
    matrix-free: ``matvec`` gathers neighbor values per face.
    Convention: A(phi) = b  discretizes  conv + diff (+ ddt).
    """

    diag: jnp.ndarray      # [nc]
    lower: jnp.ndarray     # [n_int] coeff of owner in neighbour's eq
    upper: jnp.ndarray     # [n_int] coeff of neighbour in owner's eq
    source: jnp.ndarray    # [nc, ncomp] rhs


def assemble_transport(
    m: FvMesh,
    flux,                 # [nf] mass flux
    gamma,                # scalar or [nf] diffusivity (times rho)
    bc: BoundaryCoeffs,
    n_comp: int,
    ddt_coeff=None,       # [nc] V/dt for transient, None for steady
    phi_old=None,         # [nc, ncomp]
):
    """Upwind convection + orthogonal diffusion matrix + BC/source terms."""
    n_int = m.n_internal
    f_i = flux[:n_int]
    f_b = flux[n_int:]
    gamma = jnp.broadcast_to(jnp.asarray(gamma, m.sf.dtype), (m.n_faces,))

    d_i = gamma[:n_int] * m.delta
    d_b = gamma[n_int:] * m.bd_delta

    # upwind convection: owner eq gets +max(F,0) on diag, +min(F,0) on N
    upper = jnp.minimum(f_i, 0.0) - d_i          # coeff of phi_N in owner eq
    lower = -jnp.maximum(f_i, 0.0) - d_i         # coeff of phi_P in neighbour eq
    diag = jnp.zeros(m.n_cells, m.sf.dtype)
    diag = diag.at[m.owner[:n_int]].add(jnp.maximum(f_i, 0.0) + d_i)
    diag = diag.at[m.neighbour].add(-jnp.minimum(f_i, 0.0) + d_i)

    # boundary: phi_f = a phi_P + b
    own_b = m.owner[n_int:]
    # convection (outflow: phi_f upwinded to owner when F>0; inflow uses b)
    conv_diag_b = jnp.maximum(f_b, 0.0) + jnp.minimum(f_b, 0.0) * bc.a
    conv_src_b = -jnp.minimum(f_b, 0.0)[:, None] * bc.b
    # diffusion: flux = d_b (phi_f - phi_P) = d_b ((a-1) phi_P + b)
    diff_diag_b = d_b * (1.0 - bc.a)
    diff_src_b = d_b[:, None] * bc.b
    diag = diag.at[own_b].add(conv_diag_b + diff_diag_b)
    source = jnp.zeros((m.n_cells, n_comp), m.sf.dtype)
    source = source.at[own_b].add(conv_src_b + diff_src_b)

    if ddt_coeff is not None:
        diag = diag + ddt_coeff
        source = source + ddt_coeff[:, None] * phi_old

    return FvMatrix(diag=diag, lower=lower, upper=upper, source=source)


def matvec(m: FvMesh, A: FvMatrix, phi):
    """A @ phi (per component)."""
    n_int = m.n_internal
    out = A.diag[:, None] * phi if phi.ndim == 2 else A.diag * phi
    po = phi[m.owner[:n_int]]
    pn = phi[m.neighbour]
    if phi.ndim == 2:
        out = out.at[m.owner[:n_int]].add(A.upper[:, None] * pn)
        out = out.at[m.neighbour].add(A.lower[:, None] * po)
    else:
        out = out.at[m.owner[:n_int]].add(A.upper * pn)
        out = out.at[m.neighbour].add(A.lower * po)
    return out


def h_operator(m: FvMesh, A: FvMatrix, phi):
    """H(phi) = source - offdiag @ phi (OpenFOAM's H)."""
    return A.source - (matvec(m, A, phi) - A.diag[:, None] * phi)


# ---------------------------------------------------------------------------
# algebraic multigrid (GAMG stand-in for the pressure equation)
# ---------------------------------------------------------------------------


@pytree_dataclass(meta_fields=("sizes",))
class AmgHierarchy:
    """Aggregation hierarchy built once per mesh (host side).

    Pairwise greedy matching on the face graph weighted by the orthogonal
    diffusion coefficient (strongest couplings aggregate first), one
    pairing per level, down to a few hundred cells.  Plays the role of
    OpenFOAM's GAMG agglomeration (``TJunction/system/fvSolution:19-33``);
    per-solve coarse operators are Galerkin sums (piecewise-constant
    prolongation), built in :func:`amg_coarse_ops`.
    """

    aggs: tuple        # per level: [nc_l] int32 -> coarse cell id
    owners: tuple      # per level: coarse-face owner ids [n_cf_l]
    neighs: tuple      # per level: coarse-face neighbour ids
    f2cf: tuple        # per level: fine internal face -> coarse face (-1 intra)
    sizes: tuple       # coarse sizes per level (static)


def _amg_pair_level(own, nei, w, nc):
    """One greedy pairwise-aggregation level on a face graph.

    Returns (matched[nc] fine->coarse, nc_c, own_c, nei_c, w_c, f2cf):
    the coarse cell map, coarse size, coarse face graph with summed
    weights, and the fine-face -> coarse-face map (-1 intra)."""
    order = np.argsort(-w, kind="stable")
    matched = np.full(nc, -1, np.int64)
    nxt = 0
    for f in order:
        a, b = own[f], nei[f]
        if matched[a] < 0 and matched[b] < 0:
            matched[a] = matched[b] = nxt
            nxt += 1
    single = matched < 0
    matched[single] = nxt + np.arange(int(single.sum()))
    nc_c = nxt + int(single.sum())
    co, cn = matched[own], matched[nei]
    inter = co != cn
    pmin = np.minimum(co[inter], cn[inter])
    pmax = np.maximum(co[inter], cn[inter])
    key = pmin.astype(np.int64) * nc_c + pmax
    ukey, inv = np.unique(key, return_inverse=True)
    f2cf = np.full(own.shape[0], -1, np.int64)
    f2cf[inter] = inv
    w_c = np.zeros(len(ukey))
    np.add.at(w_c, inv, w[inter])
    return matched, nc_c, ukey // nc_c, ukey % nc_c, w_c, f2cf


def build_amg(m: FvMesh, min_coarse: int = 200, max_levels: int = 16) -> AmgHierarchy:
    """Greedy pairwise aggregation on the owner/neighbour graph."""
    own = np.asarray(m.owner[: m.n_internal])
    nei = np.asarray(m.neighbour)
    w = np.asarray(m.delta, dtype=np.float64)
    nc = m.n_cells
    aggs, owners, neighs, f2cfs, sizes = [], [], [], [], []
    while nc > min_coarse and len(aggs) < max_levels:
        matched, nc_c, own_c, nei_c, w_c, f2cf = _amg_pair_level(own, nei, w, nc)
        aggs.append(jnp.asarray(matched, jnp.int32))
        owners.append(jnp.asarray(own_c, jnp.int32))
        neighs.append(jnp.asarray(nei_c, jnp.int32))
        f2cfs.append(jnp.asarray(f2cf, jnp.int32))
        sizes.append(nc_c)
        own, nei, w, nc = own_c, nei_c, w_c, nc_c
    return AmgHierarchy(
        aggs=tuple(aggs), owners=tuple(owners), neighs=tuple(neighs),
        f2cf=tuple(f2cfs), sizes=tuple(sizes),
    )


def amg_coarse_ops(m: FvMesh, h: AmgHierarchy, A: FvMatrix):
    """Galerkin coarse (diag, offdiag) per level for a SYMMETRIC operator
    (off = upper = lower, the pressure Laplacian)."""
    diag, off = A.diag, A.upper
    own = m.owner[: m.n_internal]
    levels = []
    for li in range(len(h.sizes)):
        agg, f2cf, ncl = h.aggs[li], h.f2cf[li], h.sizes[li]
        n_cf = h.owners[li].shape[0]
        intra = f2cf < 0
        diag_c = jnp.zeros(ncl, diag.dtype).at[agg].add(diag)
        diag_c = diag_c.at[
            jnp.where(intra, agg[own], ncl)
        ].add(2.0 * jnp.where(intra, off, 0.0), mode="drop")
        off_c = jnp.zeros(n_cf, off.dtype).at[
            jnp.where(intra, n_cf, f2cf)
        ].add(jnp.where(intra, 0.0, off), mode="drop")
        levels.append((diag_c, off_c))
        diag, off, own = diag_c, off_c, h.owners[li]
    return levels


def _sym_matvec(diag, off, own, nei, x):
    out = diag * x
    out = out.at[own].add(off * x[nei])
    out = out.at[nei].add(off * x[own])
    return out


def amg_vcycle(m: FvMesh, h: AmgHierarchy, A: FvMatrix, levels, r):
    """One V(1,1) cycle with damped-Jacobi smoothing; coarsest level gets
    a fixed Jacobi sweep block.  Used as the CG preconditioner."""
    omega = 0.65

    def descend(li, r):
        if li == 0:
            diag, off, own, nei = (
                A.diag, A.upper, m.owner[: m.n_internal], m.neighbour
            )
        else:
            diag, off = levels[li - 1]
            own, nei = h.owners[li - 1], h.neighs[li - 1]
        x = omega * r / diag
        if li == len(h.sizes):
            for _ in range(12):
                x = x + omega * (r - _sym_matvec(diag, off, own, nei, x)) / diag
            return x
        r1 = r - _sym_matvec(diag, off, own, nei, x)
        rc = jnp.zeros(h.sizes[li], r.dtype).at[h.aggs[li]].add(r1)
        xc = descend(li + 1, rc)
        x = x + xc[h.aggs[li]]
        x = x + omega * (r - _sym_matvec(diag, off, own, nei, x)) / diag
        return x

    return descend(0, r)


def amg_cg_solve(m: FvMesh, h: AmgHierarchy, A: FvMatrix, b, x0,
                 tol=1e-7, max_iter=200):
    """AMG-preconditioned CG (the GAMG stand-in): V-cycle as M^{-1}.
    Iteration counts stay roughly mesh-size independent, unlike the
    Jacobi-CG fallback."""
    levels = amg_coarse_ops(m, h, A)

    def dot(a_, b_):
        return jnp.sum(a_ * b_)

    r0 = b - matvec(m, A, x0)
    z0 = amg_vcycle(m, h, A, levels, r0)
    norm_b = jnp.sqrt(dot(b, b)) + 1e-300

    def cond(st):
        x, r, p, rz, it = st
        return (jnp.sqrt(dot(r, r)) / norm_b > tol) & (it < max_iter)

    def body(st):
        x, r, p, rz, it = st
        ap = matvec(m, A, p)
        alpha = rz / (dot(p, ap) + 1e-300)
        x = x + alpha * p
        r = r - alpha * ap
        z = amg_vcycle(m, h, A, levels, r)
        rz_new = dot(r, z)
        beta = rz_new / (rz + 1e-300)
        p = z + beta * p
        return x, r, p, rz_new, it + 1

    x, r, _, _, it = lax.while_loop(cond, body, (x0, r0, z0, dot(r0, z0), 0))
    return x, jnp.sqrt(dot(r, r)) / norm_b, it


# ---------------------------------------------------------------------------
# linear solvers (jit-able, fixed max iterations + residual exit)
# ---------------------------------------------------------------------------


def jacobi_solve(m: FvMesh, A: FvMatrix, b, x0, sweeps: int = 5, relax=1.0):
    """Damped Jacobi sweeps (the smoothSolver stand-in for momentum)."""
    inv_d = 1.0 / A.diag

    def body(_, x):
        r = b - matvec(m, A, x)
        upd = inv_d[:, None] * r if x.ndim == 2 else inv_d * r
        return x + relax * upd

    return lax.fori_loop(0, sweeps, body, x0)


def cg_solve(m: FvMesh, A: FvMatrix, b, x0, tol=1e-7, max_iter=500):
    """Jacobi-preconditioned conjugate gradients for symmetric operators
    (the pressure equation; stands in for OpenFOAM's GAMG,
    ``TJunction/system/fvSolution:19-33``).  Returns (x, final_residual,
    n_iterations)."""
    inv_d = 1.0 / A.diag

    def dot(a_, b_):
        return jnp.sum(a_ * b_)

    r0 = b - matvec(m, A, x0)
    z0 = inv_d * r0
    p0 = z0
    rz0 = dot(r0, z0)
    norm_b = jnp.sqrt(dot(b, b)) + 1e-300

    def cond(st):
        x, r, p, rz, it = st
        return (jnp.sqrt(dot(r, r)) / norm_b > tol) & (it < max_iter)

    def body(st):
        x, r, p, rz, it = st
        ap = matvec(m, A, p)
        alpha = rz / (dot(p, ap) + 1e-300)
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_d * r
        rz_new = dot(r, z)
        beta = rz_new / (rz + 1e-300)
        p = z + beta * p
        return x, r, p, rz_new, it + 1

    x, r, _, _, it = lax.while_loop(cond, body, (x0, r0, p0, rz0, 0))
    return x, jnp.sqrt(dot(r, r)) / norm_b, it
