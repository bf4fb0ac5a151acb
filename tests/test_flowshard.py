"""Domain-decomposed PIMPLE on the 8-virtual-CPU-device mesh must match
the single-device solver to float64 tolerance (the XLA
decomposePar/mpirun equivalent, TJunction/Allrun-parallel:10-11)."""

import os
import tempfile
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudaparticlesfoam_tpu.io import blockmesh
from cudaparticlesfoam_tpu.models import fv
from cudaparticlesfoam_tpu.models.pimple import PimpleConfig, pimple_step
from cudaparticlesfoam_tpu.models.simple import FlowState
from cudaparticlesfoam_tpu.parallel import flowshard, sharding


def n_cpu():
    try:
        return len(jax.devices("cpu"))
    except RuntimeError:
        return 0


def duct_pm(nx=24, ny=4, nz=4):
    d = tempfile.mkdtemp()
    path = os.path.join(d, "blockMeshDict")
    open(path, "w").write(textwrap.dedent(f"""
        FoamFile {{ version 2.0; format ascii; class dictionary; object blockMeshDict; }}
        convertToMeters 1;
        vertices ( (0 0 0) (6 0 0) (6 1 0) (0 1 0)
                   (0 0 1) (6 0 1) (6 1 1) (0 1 1) );
        blocks ( hex (0 1 2 3 4 5 6 7) ({nx} {ny} {nz}) simpleGrading (1 1 1) );
        boundary (
          inlet  {{ type patch; faces ((0 4 7 3)); }}
          outlet {{ type patch; faces ((1 2 6 5)); }}
          walls  {{ type wall;  faces ((0 1 5 4) (3 7 6 2) (0 3 2 1) (4 5 6 7)); }}
        );
    """))
    return blockmesh.generate(path)


@pytest.mark.parametrize("div_scheme", ["upwind", "linearUpwind"])
def test_sharded_pimple_matches_single(div_scheme):
    n_dev = 8
    try:
        if len(jax.devices("cpu")) < n_dev:
            pytest.skip("needs 8 virtual devices")
    except RuntimeError:
        pytest.skip("no CPU backend")
    pm = duct_pm()
    m = fv.fv_mesh(pm, dtype=jnp.float64)
    u_bcs = fv.make_bcs(
        m, {"inlet": ("fixedValue", [1.0, 0.0, 0.0]), "walls": ("noSlip", 0.0)}, 3
    )
    p_bcs = fv.make_bcs(m, {"outlet": ("fixedValue", 0.0)}, 1)
    u0 = jnp.tile(jnp.asarray([1.0, 0.0, 0.0]), (m.n_cells, 1))
    st = FlowState(u=u0, p=jnp.zeros(m.n_cells, jnp.float64),
                   flux=fv.flux_of(m, u0, u_bcs))
    cfg = PimpleConfig(nu=1e-3, n_outer=1, n_correctors=2, n_jacobi=8,
                       p_tol=1e-12, p_max_iter=600, div_scheme=div_scheme)
    dt = 0.02
    n_steps = 3
    for _ in range(n_steps):
        st, res = pimple_step(m, st, u_bcs, p_bcs, cfg, dt)

    # sharded run from the same initial condition
    smesh, bglob = flowshard.decompose(pm, n_dev, dtype=jnp.float64)
    dmesh = sharding.make_device_mesh(n_dev, axis="f")
    u_bcs_s = flowshard.shard_bcs(u_bcs, bglob)
    p_bcs_s = flowshard.shard_bcs(p_bcs, bglob)
    u_s = flowshard.scatter_cells(smesh, np.asarray(u0))
    p_s = flowshard.scatter_cells(smesh, np.zeros(m.n_cells))
    flux_s = flowshard.make_flux_init(smesh, dmesh)(smesh, u_s, u_bcs_s)
    step = flowshard.make_sharded_pimple(smesh, cfg, dmesh)
    for _ in range(n_steps):
        u_s, p_s, flux_s, diag = step(
            smesh, u_s, p_s, flux_s, u_bcs_s, p_bcs_s, dt
        )

    u_g = flowshard.gather_cells(smesh, u_s)
    p_g = flowshard.gather_cells(smesh, p_s)
    u_ref = np.asarray(st.u)
    p_ref = np.asarray(st.p)
    du = np.abs(u_g - u_ref).max()
    dp = np.abs(p_g - p_ref).max()
    uref_scale = np.abs(u_ref).max()
    assert du < 1e-8 * max(uref_scale, 1.0), du
    assert dp < 1e-6 * max(np.abs(p_ref).max(), 1.0), dp
    # flow physically sane + parallel continuity closed
    assert np.isfinite(u_g).all() and np.isfinite(p_g).all()
    assert float(np.asarray(diag["continuity"])[0]) < 1e-8


@pytest.mark.parametrize("grid", [(2, 2, 2), (4, 2, 1), (2, 1, 2)])
def test_sharded_pimple_multiaxis_grid(grid):
    """Multi-axis block decomposition (decomposeParDict simple n (gx gy
    gz)): 2-D and 3-D device grids with per-axis ppermute halo rounds
    must match the single-device solver like the 1-D slabs do."""
    n_dev = int(np.prod(grid))
    if n_cpu() < n_dev:
        pytest.skip(f"needs {n_dev} virtual devices")
    pm = duct_pm(nx=12, ny=6, nz=6)
    m = fv.fv_mesh(pm, dtype=jnp.float64)
    u_bcs = fv.make_bcs(
        m, {"inlet": ("fixedValue", [1.0, 0.0, 0.0]), "walls": ("noSlip", 0.0)}, 3
    )
    p_bcs = fv.make_bcs(m, {"outlet": ("fixedValue", 0.0)}, 1)
    u0 = jnp.tile(jnp.asarray([1.0, 0.0, 0.0]), (m.n_cells, 1))
    st = FlowState(u=u0, p=jnp.zeros(m.n_cells, jnp.float64),
                   flux=fv.flux_of(m, u0, u_bcs))
    cfg = PimpleConfig(nu=1e-3, n_outer=1, n_correctors=2, n_jacobi=8,
                       p_tol=1e-12, p_max_iter=600)
    dt = 0.02
    for _ in range(3):
        st, res = pimple_step(m, st, u_bcs, p_bcs, cfg, dt)

    smesh, bglob = flowshard.decompose(pm, n_dev, dtype=jnp.float64,
                                       grid=grid)
    dmesh = sharding.make_device_mesh(n_dev, axis="f")
    u_bcs_s = flowshard.shard_bcs(u_bcs, bglob)
    p_bcs_s = flowshard.shard_bcs(p_bcs, bglob)
    u_s = flowshard.scatter_cells(smesh, np.asarray(u0))
    p_s = flowshard.scatter_cells(smesh, np.zeros(m.n_cells))
    flux_s = flowshard.make_flux_init(smesh, dmesh)(smesh, u_s, u_bcs_s)
    step = flowshard.make_sharded_pimple(smesh, cfg, dmesh)
    for _ in range(3):
        u_s, p_s, flux_s, diag = step(
            smesh, u_s, p_s, flux_s, u_bcs_s, p_bcs_s, dt
        )
    u_g = flowshard.gather_cells(smesh, u_s)
    p_g = flowshard.gather_cells(smesh, p_s)
    du = np.abs(u_g - np.asarray(st.u)).max()
    dp = np.abs(p_g - np.asarray(st.p)).max()
    assert du < 1e-8, du
    assert dp < 1e-6 * max(np.abs(np.asarray(st.p)).max(), 1.0), dp
    assert float(np.asarray(diag["continuity"])[0]) < 1e-8


def _duct_mrf(m, omega_z=6.0):
    """MRFZones with a rotor zone in the middle third of the duct,
    rotating about z through the duct centre (mirrors mrf.from_case's
    face classification on a directly constructed zone)."""
    from cudaparticlesfoam_tpu.models.mrf import MRFZones

    nc, nf, n_int = m.n_cells, m.n_faces, m.n_internal
    cc = np.asarray(m.cc)
    own = np.asarray(m.owner)
    nei = np.asarray(m.neighbour)
    in_zone = (cc[:, 0] > 2.0) & (cc[:, 0] < 4.0)
    origin = np.array([3.0, 0.5, 0.5])
    omega = np.array([0.0, 0.0, omega_z])
    cell_om = np.where(in_zone[:, None], omega, 0.0)
    cell_or = np.where(in_zone[:, None], origin, 0.0)
    face_om = np.zeros((nf, 3))
    face_or = np.zeros((nf, 3))
    f_int = in_zone[own[:n_int]] & in_zone[nei]
    face_om[:n_int][f_int] = omega
    face_or[:n_int][f_int] = origin
    f_bd = in_zone[own[n_int:]]
    face_om[n_int:][f_bd] = omega
    face_or[n_int:][f_bd] = origin
    dt = np.asarray(m.sf).dtype
    return MRFZones(
        cell_omega=jnp.asarray(cell_om, dt), cell_origin=jnp.asarray(cell_or, dt),
        face_omega=jnp.asarray(face_om, dt), face_origin=jnp.asarray(face_or, dt),
    )


def test_sharded_pimple_mrf_matches_single():
    """MRF zones inside the shard_map PIMPLE (VERDICT r2 item 3's last
    piece): Coriolis source + relative flux + rotating-wall BCs must
    reproduce the single-device MRF step to f64 tolerance."""
    n_dev = 8
    try:
        if len(jax.devices("cpu")) < n_dev:
            pytest.skip("needs 8 virtual devices")
    except RuntimeError:
        pytest.skip("no CPU backend")
    from cudaparticlesfoam_tpu.models import mrf as mrf_mod

    pm = duct_pm()
    m = fv.fv_mesh(pm, dtype=jnp.float64)
    mrf = _duct_mrf(m)
    u_bcs = fv.make_bcs(
        m, {"inlet": ("fixedValue", [1.0, 0.0, 0.0]), "walls": ("noSlip", 0.0)}, 3
    )
    p_bcs = fv.make_bcs(m, {"outlet": ("fixedValue", 0.0)}, 1)
    u0 = jnp.tile(jnp.asarray([1.0, 0.0, 0.0]), (m.n_cells, 1))
    # initial flux from the rotating-wall-corrected BCs on BOTH legs
    u_bcs_c0 = mrf_mod.correct_boundary_velocity(mrf, m, u_bcs)
    flux0 = mrf_mod.make_relative(mrf, m, fv.flux_of(m, u0, u_bcs_c0))
    st = FlowState(u=u0, p=jnp.zeros(m.n_cells, jnp.float64), flux=flux0)
    cfg = PimpleConfig(nu=1e-3, n_outer=1, n_correctors=2, n_jacobi=8,
                       p_tol=1e-12, p_max_iter=600, div_scheme="upwind")
    dt = 0.02
    for _ in range(3):
        st, _ = pimple_step(m, st, u_bcs, p_bcs, cfg, dt, mrf=mrf)

    smesh, bglob = flowshard.decompose(pm, n_dev, dtype=jnp.float64)
    dmesh = sharding.make_device_mesh(n_dev, axis="f")
    # rotating-wall BC correction folded into the global BCs pre-shard
    # (exactly what ShardedFlowSolver does; pimple_step applies it inside)
    u_bcs_c = mrf_mod.correct_boundary_velocity(mrf, m, u_bcs)
    u_bcs_s = flowshard.shard_bcs(u_bcs_c, bglob)
    p_bcs_s = flowshard.shard_bcs(p_bcs, bglob)
    om_s, ff_s = flowshard.shard_mrf(smesh, mrf, m)
    u_s = flowshard.scatter_cells(smesh, np.asarray(u0))
    p_s = flowshard.scatter_cells(smesh, np.zeros(m.n_cells))
    flux_s = flowshard.make_flux_init(smesh, dmesh)(smesh, u_s, u_bcs_s) - ff_s
    step = flowshard.make_sharded_pimple(smesh, cfg, dmesh, with_mrf=True)
    for _ in range(3):
        u_s, p_s, flux_s, diag = step(
            smesh, u_s, p_s, flux_s, u_bcs_s, p_bcs_s, dt, om_s, ff_s
        )

    u_g = flowshard.gather_cells(smesh, u_s)
    p_g = flowshard.gather_cells(smesh, p_s)
    u_ref = np.asarray(st.u)
    p_ref = np.asarray(st.p)
    assert np.abs(u_g - u_ref).max() < 1e-8 * max(np.abs(u_ref).max(), 1.0)
    assert np.abs(p_g - p_ref).max() < 1e-6 * max(np.abs(p_ref).max(), 1.0)
    # the zone actually does something: swirl appears in the zone cells
    assert np.abs(u_ref[:, 1]).max() > 1e-3


def test_decompose_structure():
    pm = duct_pm()
    smesh, bglob = flowshard.decompose(pm, 4, dtype=jnp.float64)
    # every global cell appears exactly once across shards
    gl = np.asarray(smesh.glob_cell)
    owned = gl[np.asarray(smesh.cell_mask)]
    assert sorted(owned.tolist()) == list(range(pm.n_cells))
    # every global boundary face appears exactly once
    bg = np.asarray(bglob)
    bvals = bg[bg >= 0]
    assert len(np.unique(bvals)) == len(bvals)
    assert len(bvals) == pm.n_faces - pm.n_internal_faces


def test_coupled_with_sharded_flow(tmp_path):
    """run_coupled --flow-devices: the full product path with the fluid
    solve decomposed over 4 virtual devices."""
    try:
        if len(jax.devices("cpu")) < 4:
            pytest.skip("needs 4 virtual devices")
    except RuntimeError:
        pytest.skip("no CPU backend")
    from cudaparticlesfoam_tpu.models import coupled
    from test_coupled_e2e import shrink_tjunction
    from cudaparticlesfoam_tpu.io import polymesh

    case = shrink_tjunction(tmp_path, num_particles=500)
    pm = blockmesh.generate(os.path.join(case, "system", "blockMeshDict"))
    polymesh.write_polymesh(pm, os.path.join(case, "constant", "polyMesh"))
    out = str(tmp_path / "out")
    os.makedirs(out)
    _, state, stats = coupled.run_coupled(
        case, out_dir=out, n_steps=2, flow_devices=4, log=lambda *a: None
    )
    assert stats["cycles"] >= 20
    assert np.asarray(state.active).all()
    assert np.isfinite(np.asarray(state.pos)).all()


@pytest.mark.skipif(n_cpu() < 4, reason="needs 4 virtual devices")
def test_local_amg_preconditioner_cuts_iterations(tmp_path):
    """The additive-Schwarz per-shard AMG V-cycle preconditioner must cut
    the pressure-CG iteration count substantially vs Jacobi-CG on the
    same sharded solve (the sharded stand-in for GAMG), while matching
    the converged fields."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from test_coupled_e2e import shrink_tjunction
    from cudaparticlesfoam_tpu.io import blockmesh, polymesh
    from cudaparticlesfoam_tpu.models import case as caselib
    from cudaparticlesfoam_tpu.parallel.flowshard import ShardedFlowSolver

    case_dir = shrink_tjunction(tmp_path, num_particles=10)
    pm = blockmesh.generate(os.path.join(case_dir, "system", "blockMeshDict"))
    polymesh.write_polymesh(pm, os.path.join(case_dir, "constant", "polyMesh"))
    case = caselib.load_case(case_dir, log=lambda *a: None)

    runs = {}
    for solver_kind in ("amg", "cg"):
        fs = ShardedFlowSolver(case, 4, log=lambda *a: None,
                               p_solver=solver_kind)
        iters = 0
        for _ in range(2):
            res = fs.advance(0.005)
            iters += res["p_iters"]
        runs[solver_kind] = (iters, np.asarray(fs.state.p))
    it_amg, p_amg = runs["amg"]
    it_cg, p_cg = runs["cg"]
    assert it_amg < 0.5 * it_cg, (it_amg, it_cg)
    # both converge to the same pressure field (same tolerance)
    scale = np.abs(p_cg).max() + 1e-12
    assert np.abs(p_amg - p_cg).max() / scale < 5e-3


def test_sharded_pimple_slip_bcs_match_single():
    """Slip/symmetry vector BCs on the sharded solver: the tangential
    projection is per-face local (fv.boundary_value on each device's own
    boundary normals), so a duct with slip side walls must match the
    single-device solver exactly (VERDICT r3 next-round item 6)."""
    n_dev = 8
    try:
        if len(jax.devices("cpu")) < n_dev:
            pytest.skip("needs 8 virtual devices")
    except RuntimeError:
        pytest.skip("no CPU backend")
    pm = duct_pm()
    m = fv.fv_mesh(pm, dtype=jnp.float64)
    u_bcs = fv.make_bcs(
        m, {"inlet": ("fixedValue", [1.0, 0.0, 0.0]),
            "walls": ("slip", 0.0)}, 3
    )
    assert u_bcs.slip_mask is not None
    p_bcs = fv.make_bcs(m, {"outlet": ("fixedValue", 0.0)}, 1)
    u0 = jnp.tile(jnp.asarray([1.0, 0.0, 0.0]), (m.n_cells, 1))
    st = FlowState(u=u0, p=jnp.zeros(m.n_cells, jnp.float64),
                   flux=fv.flux_of(m, u0, u_bcs))
    cfg = PimpleConfig(nu=1e-3, n_outer=1, n_correctors=2, n_jacobi=8,
                       p_tol=1e-12, p_max_iter=600)
    dt = 0.02
    n_steps = 3
    for _ in range(n_steps):
        st, res = pimple_step(m, st, u_bcs, p_bcs, cfg, dt)

    smesh, bglob = flowshard.decompose(pm, n_dev, dtype=jnp.float64)
    dmesh = sharding.make_device_mesh(n_dev, axis="f")
    u_bcs_s = flowshard.shard_bcs(u_bcs, bglob)
    assert bool(np.asarray(u_bcs_s.slip_mask).any())
    p_bcs_s = flowshard.shard_bcs(p_bcs, bglob)
    u_s = flowshard.scatter_cells(smesh, np.asarray(u0))
    p_s = flowshard.scatter_cells(smesh, np.zeros(m.n_cells))
    flux_s = flowshard.make_flux_init(smesh, dmesh)(smesh, u_s, u_bcs_s)
    step = flowshard.make_sharded_pimple(smesh, cfg, dmesh)
    for _ in range(n_steps):
        u_s, p_s, flux_s, diag = step(
            smesh, u_s, p_s, flux_s, u_bcs_s, p_bcs_s, dt
        )
    u_g = flowshard.gather_cells(smesh, u_s)
    p_g = flowshard.gather_cells(smesh, p_s)
    du = np.abs(u_g - np.asarray(st.u)).max()
    dp = np.abs(p_g - np.asarray(st.p)).max()
    assert du < 1e-8, du
    assert dp < 1e-6, dp
    # the slip walls really did something: tangential flow survives at the
    # walls (a noSlip duct would drag it toward zero)
    assert np.abs(u_g[:, 0]).min() > 0.5


@pytest.mark.parametrize("decomp", ["rcb", "strided"])
def test_sharded_pimple_general_decomposition(decomp):
    """General (non-axis-adjacent) decompositions: recursive coordinate
    bisection and a deliberately pathological strided cell->device map
    must both run the sharded PIMPLE to single-device parity — the halo
    exchange is one directed ppermute round per observed device-id delta,
    never an adjacency error (VERDICT r3 next-round item 8)."""
    n_dev = 8
    try:
        if len(jax.devices("cpu")) < n_dev:
            pytest.skip("needs 8 virtual devices")
    except RuntimeError:
        pytest.skip("no CPU backend")
    pm = duct_pm()
    m = fv.fv_mesh(pm, dtype=jnp.float64)
    u_bcs = fv.make_bcs(
        m, {"inlet": ("fixedValue", [1.0, 0.0, 0.0]), "walls": ("noSlip", 0.0)}, 3
    )
    p_bcs = fv.make_bcs(m, {"outlet": ("fixedValue", 0.0)}, 1)
    u0 = jnp.tile(jnp.asarray([1.0, 0.0, 0.0]), (m.n_cells, 1))
    st = FlowState(u=u0, p=jnp.zeros(m.n_cells, jnp.float64),
                   flux=fv.flux_of(m, u0, u_bcs))
    cfg = PimpleConfig(nu=1e-3, n_outer=1, n_correctors=2, n_jacobi=8,
                       p_tol=1e-12, p_max_iter=600)
    dt = 0.02
    n_steps = 3
    for _ in range(n_steps):
        st, res = pimple_step(m, st, u_bcs, p_bcs, cfg, dt)

    if decomp == "rcb":
        kw = dict(grid="rcb")
    else:
        # stride cells round-robin over devices: EVERY internal face is a
        # cross face and the delta set is large — worst case for the
        # generic halo machinery, still correct
        kw = dict(cell_map=np.arange(m.n_cells) % n_dev)
    smesh, bglob = flowshard.decompose(pm, n_dev, dtype=jnp.float64, **kw)
    dmesh = sharding.make_device_mesh(n_dev, axis="f")
    u_bcs_s = flowshard.shard_bcs(u_bcs, bglob)
    p_bcs_s = flowshard.shard_bcs(p_bcs, bglob)
    u_s = flowshard.scatter_cells(smesh, np.asarray(u0))
    p_s = flowshard.scatter_cells(smesh, np.zeros(m.n_cells))
    flux_s = flowshard.make_flux_init(smesh, dmesh)(smesh, u_s, u_bcs_s)
    step = flowshard.make_sharded_pimple(smesh, cfg, dmesh)
    for _ in range(n_steps):
        u_s, p_s, flux_s, diag = step(
            smesh, u_s, p_s, flux_s, u_bcs_s, p_bcs_s, dt
        )
    u_g = flowshard.gather_cells(smesh, u_s)
    p_g = flowshard.gather_cells(smesh, p_s)
    du = np.abs(u_g - np.asarray(st.u)).max()
    dp = np.abs(p_g - np.asarray(st.p)).max()
    assert du < 1e-8, du
    assert dp < 1e-6, dp
    assert float(np.asarray(diag["continuity"])[0]) < 1e-8


def test_rcb_map_balances_cells():
    pm = duct_pm()
    m = fv.fv_mesh(pm, dtype=jnp.float64)
    dev = flowshard.rcb_map(np.asarray(m.cc), 6)   # non-power-of-two too
    counts = np.bincount(dev, minlength=6)
    assert counts.sum() == m.n_cells
    assert counts.max() - counts.min() <= 1


def test_sharded_pimple_rcb_pitzdaily_parity():
    """VERDICT r3 item 8's own acceptance case: a recursive-coordinate-
    bisection decomposition of the (graded, multi-block) pitzDaily mesh
    passes the sharded parity test — RCB parts of this mesh are NOT
    axis-adjacent block slabs, which used to raise."""
    n_dev = 8
    try:
        if len(jax.devices("cpu")) < n_dev:
            pytest.skip("needs 8 virtual devices")
    except RuntimeError:
        pytest.skip("no CPU backend")
    bmd = os.path.join(
        os.path.dirname(__file__), "..", "tutorials", "incompressible",
        "cudaParticlesUncoupledFoam", "pitzDaily", "system", "blockMeshDict",
    )
    pm = blockmesh.generate(bmd)
    m = fv.fv_mesh(pm, dtype=jnp.float64)
    u_bcs = fv.make_bcs(
        m, {"inlet": ("fixedValue", [10.0, 0.0, 0.0]),
            "upperWall": ("noSlip", 0.0), "lowerWall": ("noSlip", 0.0),
            "frontAndBack": ("empty", 0.0)}, 3
    )
    p_bcs = fv.make_bcs(m, {"outlet": ("fixedValue", 0.0)}, 1)
    u0 = jnp.tile(jnp.asarray([10.0, 0.0, 0.0]), (m.n_cells, 1))
    st = FlowState(u=u0, p=jnp.zeros(m.n_cells, jnp.float64),
                   flux=fv.flux_of(m, u0, u_bcs))
    cfg = PimpleConfig(nu=1e-5, n_outer=1, n_correctors=2, n_jacobi=8,
                       p_tol=1e-11, p_max_iter=2000)
    dt = 5e-5
    n_steps = 2
    for _ in range(n_steps):
        st, res = pimple_step(m, st, u_bcs, p_bcs, cfg, dt)

    smesh, bglob = flowshard.decompose(pm, n_dev, dtype=jnp.float64,
                                       grid="rcb")
    # RCB on pitzDaily produces non-slab parts: more than the 2 deltas a
    # 1-D slab decomposition would have
    assert len(smesh.halo_perms) > 2
    dmesh = sharding.make_device_mesh(n_dev, axis="f")
    u_bcs_s = flowshard.shard_bcs(u_bcs, bglob)
    p_bcs_s = flowshard.shard_bcs(p_bcs, bglob)
    u_s = flowshard.scatter_cells(smesh, np.asarray(u0))
    p_s = flowshard.scatter_cells(smesh, np.zeros(m.n_cells))
    flux_s = flowshard.make_flux_init(smesh, dmesh)(smesh, u_s, u_bcs_s)
    step = flowshard.make_sharded_pimple(smesh, cfg, dmesh)
    for _ in range(n_steps):
        u_s, p_s, flux_s, diag = step(
            smesh, u_s, p_s, flux_s, u_bcs_s, p_bcs_s, dt
        )
    u_g = flowshard.gather_cells(smesh, u_s)
    p_g = flowshard.gather_cells(smesh, p_s)
    du = np.abs(u_g - np.asarray(st.u)).max() / 10.0
    dp_rel = np.abs(p_g - np.asarray(st.p)).max() / (
        np.abs(np.asarray(st.p)).max() + 1e-12
    )
    assert du < 1e-6, du
    assert dp_rel < 1e-5, dp_rel


def test_graph_partition_beats_rcb_pitzdaily():
    """The multilevel graph partitioner (decomposeParDict scotch/metis
    parity, VERDICT r4 item 8): lower edge-cut than RCB on pitzDaily,
    with bounded imbalance."""
    from cudaparticlesfoam_tpu.parallel import graphpart

    bmd = os.path.join(
        os.path.dirname(__file__), "..", "tutorials", "incompressible",
        "cudaParticlesUncoupledFoam", "pitzDaily", "system", "blockMeshDict",
    )
    pm = blockmesh.generate(bmd)
    m = fv.fv_mesh(pm, dtype=jnp.float64)
    own = np.asarray(m.owner)[: m.n_internal]
    nei = np.asarray(m.neighbour)
    cc = np.asarray(m.cc)
    for k in (4, 8):
        gp = graphpart.graph_map(pm.n_cells, own, nei, k, coords=cc)
        rcb = flowshard.rcb_map(cc, k)
        cut_g = graphpart.edge_cut(pm.n_cells, own, nei, gp)
        cut_r = graphpart.edge_cut(pm.n_cells, own, nei, rcb)
        assert cut_g < cut_r, (k, cut_g, cut_r)
        counts = np.bincount(gp, minlength=k)
        assert counts.sum() == pm.n_cells
        # recursive-bisection balance envelope (UB per level)
        assert counts.max() <= pm.n_cells / k * graphpart.UB ** 3 + 1


def test_read_decompose_par_scotch_routes_graph(tmp_path):
    (tmp_path / "system").mkdir()
    (tmp_path / "system" / "decomposeParDict").write_text(
        "FoamFile { version 2.0; format ascii; object decomposeParDict; }\n"
        "numberOfSubdomains 8;\nmethod scotch;\n"
    )
    msgs = []
    out = flowshard.read_decompose_par(str(tmp_path), 8, log=msgs.append)
    assert out == "graph"
    assert any("graph bisection" in m for m in msgs)


def test_sharded_pimple_graph_pitzdaily_parity():
    """Sharded PIMPLE on the graph-partitioned pitzDaily decomposition
    matches the single-device solver (the scotch/metis-parity partition
    rides the generic per-delta halo machinery)."""
    n_dev = 8
    try:
        if len(jax.devices("cpu")) < n_dev:
            pytest.skip("needs 8 virtual devices")
    except RuntimeError:
        pytest.skip("no CPU backend")
    bmd = os.path.join(
        os.path.dirname(__file__), "..", "tutorials", "incompressible",
        "cudaParticlesUncoupledFoam", "pitzDaily", "system", "blockMeshDict",
    )
    pm = blockmesh.generate(bmd)
    m = fv.fv_mesh(pm, dtype=jnp.float64)
    u_bcs = fv.make_bcs(
        m, {"inlet": ("fixedValue", [10.0, 0.0, 0.0]),
            "upperWall": ("noSlip", 0.0), "lowerWall": ("noSlip", 0.0),
            "frontAndBack": ("empty", 0.0)}, 3
    )
    p_bcs = fv.make_bcs(m, {"outlet": ("fixedValue", 0.0)}, 1)
    u0 = jnp.tile(jnp.asarray([10.0, 0.0, 0.0]), (m.n_cells, 1))
    st = FlowState(u=u0, p=jnp.zeros(m.n_cells, jnp.float64),
                   flux=fv.flux_of(m, u0, u_bcs))
    cfg = PimpleConfig(nu=1e-5, n_outer=1, n_correctors=2, n_jacobi=8,
                       p_tol=1e-11, p_max_iter=2000)
    dt = 5e-5
    n_steps = 2
    for _ in range(n_steps):
        st, res = pimple_step(m, st, u_bcs, p_bcs, cfg, dt)

    smesh, bglob = flowshard.decompose(pm, n_dev, dtype=jnp.float64,
                                       grid="graph")
    dmesh = sharding.make_device_mesh(n_dev, axis="f")
    u_bcs_s = flowshard.shard_bcs(u_bcs, bglob)
    p_bcs_s = flowshard.shard_bcs(p_bcs, bglob)
    u_s = flowshard.scatter_cells(smesh, np.asarray(u0))
    p_s = flowshard.scatter_cells(smesh, np.zeros(m.n_cells))
    flux_s = flowshard.make_flux_init(smesh, dmesh)(smesh, u_s, u_bcs_s)
    step = flowshard.make_sharded_pimple(smesh, cfg, dmesh)
    for _ in range(n_steps):
        u_s, p_s, flux_s, diag = step(
            smesh, u_s, p_s, flux_s, u_bcs_s, p_bcs_s, dt
        )
    u_g = flowshard.gather_cells(smesh, u_s)
    p_g = flowshard.gather_cells(smesh, p_s)
    du = np.abs(u_g - np.asarray(st.u)).max() / 10.0
    dp_rel = np.abs(p_g - np.asarray(st.p)).max() / (
        np.abs(np.asarray(st.p)).max() + 1e-12
    )
    assert du < 1e-6, du
    assert dp_rel < 1e-5, dp_rel
