"""Cached (mega-row) engine vs simple engine equivalence.

The fast engine restructures the cycle (row cache, compaction, gradient-
plane reflection) but must reproduce the simple engine's trajectories to
floating-point roundoff — both implement the reference semantics
(advect -> brownian -> baryQueryDisp walk -> RTreflection -> move).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cudaparticlesfoam_tpu import (
    StepConfig,
    box_mesh,
    build_grid_locator,
    locate_seeds,
    replace_velocity,
    run_cycles,
    seed_in_box,
)
from cudaparticlesfoam_tpu.state import replace as rs


@pytest.fixture(scope="module")
def setup():
    mesh = box_mesh(6, 6, 6)
    loc = build_grid_locator(mesh)
    pts = np.asarray(mesh.points, dtype=np.float64)
    cen = pts[np.asarray(mesh.tets)].mean(axis=1)
    outward = cen - 3.0
    outward /= np.linalg.norm(outward, axis=1, keepdims=True) + 1e-12
    mesh = replace_velocity(mesh, tet_vel=outward * 1.5)
    st = seed_in_box(256, (0.5,) * 3, (5.5,) * 3, method="threefry")
    st = rs(st, tet_id=locate_seeds(mesh, loc, st.pos))
    return mesh, st


def compare(mesh, st, n=120, atol=1e-9, **cfg_kw):
    a = run_cycles(mesh, st, StepConfig(engine="simple", **cfg_kw), n)
    b = run_cycles(mesh, st, StepConfig(engine="cached", **cfg_kw), n)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), atol=atol)
    np.testing.assert_array_equal(np.asarray(a.tet_id), np.asarray(b.tet_id))
    np.testing.assert_array_equal(np.asarray(a.active), np.asarray(b.active))
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), atol=atol)
    return a, b


def test_pure_advect_with_reflection(setup):
    mesh, st = setup
    a, b = compare(mesh, st, dt=0.08, use_brownian=False)
    assert np.asarray(b.active).all()
    assert (np.asarray(b.tet_id) >= 0).all()


def test_brownian(setup):
    mesh, st = setup
    compare(mesh, st, dt=0.08, diffusion_coeff=1e-3)


def test_rk4_cached_matches_simple(setup):
    """RK4 on the cached engine (stage walks via _stage_velocity) must
    match the simple engine's rk4 branch — incl. crossings, wall
    reflections, and out-of-domain stage-point fallbacks."""
    mesh, st = setup
    a, b = compare(mesh, st, n=120, dt=0.08, use_brownian=False,
                   integrator="rk4")
    assert np.asarray(b.active).all()
    # the outward field really does cross cells (stage walks exercised)
    assert (np.asarray(a.tet_id) != np.asarray(st.tet_id)).any()


def test_rk4_cached_matches_simple_brownian(setup):
    mesh, st = setup
    compare(mesh, st, n=60, dt=0.08, diffusion_coeff=1e-3, integrator="rk4")


def test_rk4_cached_tiny_capacity_overflow(setup):
    """Stage-walk arena far below the crossing count: the round loop must
    retire every pending lane with identical results."""
    mesh, st = setup
    a = run_cycles(
        mesh, st,
        StepConfig(engine="simple", dt=0.08, use_brownian=False,
                   integrator="rk4"), 60,
    )
    c = run_cycles(
        mesh, st,
        StepConfig(engine="cached", dt=0.08, use_brownian=False,
                   integrator="rk4", walk_capacity_frac=1e-3), 60,
    )
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(c.pos), atol=1e-9)
    np.testing.assert_array_equal(np.asarray(a.tet_id), np.asarray(c.tet_id))


def test_no_reflect_dead_particles(setup):
    mesh, st = setup
    a, b = compare(mesh, st, dt=0.08, use_brownian=False, reflect_wall=False)
    assert not np.asarray(b.active).any()  # all escaped the outward field


def test_overflow_fallback(setup):
    # capacity far below the crossing count: the lax.cond full-batch branch
    # must produce identical results
    mesh, st = setup
    a = run_cycles(
        mesh, st, StepConfig(engine="simple", dt=0.08, use_brownian=False), 120
    )
    c = run_cycles(
        mesh,
        st,
        StepConfig(
            engine="cached", dt=0.08, use_brownian=False, walk_capacity_frac=1e-3
        ),
        120,
    )
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(c.pos), atol=1e-9)
    np.testing.assert_array_equal(np.asarray(a.tet_id), np.asarray(c.tet_id))


def test_auto_engine_picks_cached_for_tetvelocity():
    assert StepConfig().resolved_engine() == "cached"
    # VertexVelocity now has a cached fast path too (pk row table)
    assert StepConfig(velocity_interp="VertexVelocity").resolved_engine() == "cached"
    assert StepConfig(engine="simple").resolved_engine() == "simple"
    # rk4 rides the cached engine too since round 5 (stage walks via
    # _stage_velocity); convex + rk4 stays on the simple engine
    assert StepConfig(integrator="rk4").resolved_engine() == "cached"
    assert (
        StepConfig(integrator="rk4", locate_mode="convex").resolved_engine()
        == "simple"
    )


# ------------------------------------------------- VertexVelocity (Pk) layout

@pytest.fixture(scope="module")
def setup_pk():
    """Box fixture with its native per-vertex radial velocity
    (HostTetMesh.h:62-144) — the Pk workload."""
    from cudaparticlesfoam_tpu.mesh import with_pk_rows

    mesh = box_mesh(6, 6, 6)
    loc = build_grid_locator(mesh)
    mesh = with_pk_rows(mesh)
    st = seed_in_box(256, (0.5,) * 3, (5.5,) * 3, method="threefry")
    st = rs(st, tet_id=locate_seeds(mesh, loc, st.pos))
    return mesh, st


def compare_pk(mesh, st, n=120, atol=1e-9, **cfg_kw):
    kw = dict(velocity_interp="VertexVelocity", **cfg_kw)
    a = run_cycles(mesh, st, StepConfig(engine="simple", **kw), n)
    b = run_cycles(mesh, st, StepConfig(engine="cached", **kw), n)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), atol=atol)
    np.testing.assert_array_equal(np.asarray(a.tet_id), np.asarray(b.tet_id))
    np.testing.assert_array_equal(np.asarray(a.active), np.asarray(b.active))
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), atol=atol)
    return a, b


def test_pk_advect_reflect(setup_pk):
    mesh, st = setup_pk
    a, b = compare_pk(mesh, st, dt=0.05, use_brownian=False)
    assert np.asarray(b.active).all()
    assert (np.asarray(b.tet_id) >= 0).all()
    # the radial field actually moved particles
    assert np.abs(np.asarray(b.pos) - np.asarray(st.pos)).max() > 0.1


def test_pk_brownian(setup_pk):
    mesh, st = setup_pk
    compare_pk(mesh, st, dt=0.05, diffusion_coeff=1e-3)


def test_pk_rk4_cached_matches_simple(setup_pk):
    """RK4 stage evaluation in VertexVelocity mode: each stage's velocity
    is the bary blend of the STAGE tet's vertex velocities at the stage
    point (cached _stage_velocity vs the simple engine's vel_at)."""
    mesh, st = setup_pk
    a, b = compare_pk(mesh, st, n=80, dt=0.05, use_brownian=False,
                      integrator="rk4")
    assert (np.asarray(a.tet_id) != np.asarray(st.tet_id)).any()


def test_pk_missing_rows_falls_back(setup):
    """VertexVelocity on a mesh without pk rows silently uses the simple
    engine (identical physics, no crash)."""
    mesh, st = setup
    a = run_cycles(
        mesh, st,
        StepConfig(velocity_interp="VertexVelocity", dt=0.05, use_brownian=False),
        20,
    )
    b = run_cycles(
        mesh, st,
        StepConfig(engine="simple", velocity_interp="VertexVelocity", dt=0.05,
                   use_brownian=False),
        20,
    )
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))


def test_pk_update_velocity_refreshes_rows(setup_pk):
    """replace_velocity(vert_vel=...) must refresh the pk row cache."""
    from cudaparticlesfoam_tpu.mesh import with_pk_rows

    mesh, st = setup_pk
    vv = np.asarray(mesh.vert_vel) * 2.0
    m2 = replace_velocity(mesh, vert_vel=vv)
    rows = np.asarray(m2.tet_row_pk)
    tets = np.asarray(m2.tets)
    np.testing.assert_allclose(
        rows[:, 12:24], vv[tets].reshape(len(tets), 12), rtol=1e-6
    )


def test_pk_sharded_dp(setup_pk):
    """VertexVelocity cached engine under particle-DP sharding (8 virtual
    devices): matches the single-device result."""
    import jax

    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs 8 virtual devices")
    from cudaparticlesfoam_tpu.parallel import sharding

    mesh, st = setup_pk
    cfg = StepConfig(velocity_interp="VertexVelocity", dt=0.05,
                     use_brownian=False)
    ref = run_cycles(mesh, st, cfg, 30)
    dmesh, rmesh, sst = sharding.distribute(mesh, st, 8)
    out = sharding.run_cycles_sharded(rmesh, sst, cfg, 30)
    n = st.n_particles
    np.testing.assert_allclose(
        np.asarray(out.pos)[:n], np.asarray(ref.pos), atol=1e-9
    )
    np.testing.assert_array_equal(
        np.asarray(out.tet_id)[:n], np.asarray(ref.tet_id)
    )


def test_cycle_chunks_bit_identical():
    """cycle_chunks sub-batching must be bit-identical to the full-batch
    cycle (noise drawn once and sliced; lanes independent)."""
    import dataclasses

    import numpy as np

    from cudaparticlesfoam_tpu import (
        StepConfig, box_mesh, build_grid_locator, locate_seeds,
        replace_velocity, run_cycles, seed_in_box,
    )
    from cudaparticlesfoam_tpu.state import replace as rs

    mesh = box_mesh(6, 6, 6)
    loc = build_grid_locator(mesh)
    cen = np.asarray(mesh.points, dtype=np.float64)[np.asarray(mesh.tets)].mean(axis=1)
    outward = cen - 3.0
    outward /= np.linalg.norm(outward, axis=1, keepdims=True) + 1e-12
    mesh = replace_velocity(mesh, tet_vel=outward * 1.2)
    st = seed_in_box(4096, (0.5,) * 3, (5.5,) * 3, method="threefry")
    st = rs(st, tet_id=locate_seeds(mesh, loc, st.pos))
    base = StepConfig(dt=0.07, diffusion_coeff=1e-3, engine="cached")
    a = run_cycles(mesh, st, base, 25)
    b = run_cycles(mesh, st, dataclasses.replace(base, cycle_chunks=4), 25)
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))
    np.testing.assert_array_equal(np.asarray(a.tet_id), np.asarray(b.tet_id))
    np.testing.assert_array_equal(np.asarray(a.vel), np.asarray(b.vel))


def test_fuzz_cached_vs_simple(setup):
    """Seeded fuzz over the StepConfig surface: random combinations of
    dt / diffusion / toggles / hops / capacity / chunks must keep the
    cached engine on the simple engine's trajectories.  Broad-net
    regression guard for engine rewrites (the targeted tests above pin
    the individually interesting regimes)."""
    import dataclasses as dc

    mesh, st = setup
    rng = np.random.default_rng(2024)
    for trial in range(8):
        kw = dict(
            dt=float(rng.uniform(0.02, 0.5)),
            diffusion_coeff=float(10 ** rng.uniform(-5, -2.5)),
            use_advection=bool(rng.random() < 0.85),
            use_brownian=bool(rng.random() < 0.7),
            reflect_wall=bool(rng.random() < 0.85),
            inline_hops=int(rng.integers(0, 5)),
            inline_bounce=bool(rng.random() < 0.7),
            walk_capacity_frac=float(rng.choice([1 / 32, 1 / 16, 1 / 4])),
            cycle_chunks=int(rng.choice([1, 1, 2])),
        )
        n = int(rng.integers(20, 60))
        try:
            compare(mesh, st, n=n, atol=1e-9, **kw)
        except AssertionError as e:
            raise AssertionError(f"fuzz trial {trial} failed for {kw}") from e


# ---------------------------------------------------------------------------
# engine-agnostic checks (the mesh-side escape mask, the plain XLA engine
# on every backend) and the cached-vs-simple matrix at both precisions
# ---------------------------------------------------------------------------


def test_jnp_fallback_runs_everywhere():
    """The cached XLA engine runs on every backend, no kernel envelope."""
    import dataclasses

    from cudaparticlesfoam_tpu import state as statelib
    from cudaparticlesfoam_tpu.ops import locate as locate_ops

    mesh = box_mesh(4, 4, 4)
    n = 512
    rng = np.random.default_rng(7)
    pos = jnp.asarray(rng.uniform(0.5, 3.5, (n, 3)), mesh.dtype)
    st = statelib.make_state(pos)
    loc = locate_ops.build_grid_locator(mesh)
    st = dataclasses.replace(
        st, tet_id=locate_ops.locate_seeds(mesh, loc, st.pos)
    )
    cfg = StepConfig(dt=0.02, diffusion_coeff=1e-4, inline_hops=1)
    out = run_cycles(mesh, st, cfg, 5)
    assert int(jnp.sum(out.tet_id < 0)) == 0


def _escape_mesh(dtype=None):
    """8^3 box whose +x boundary faces form an absorbing patch, with a
    uniform +x wind."""
    import dataclasses as dc

    from cudaparticlesfoam_tpu.mesh import set_boundary_escape

    mesh = box_mesh(8, 8, 8, dtype=dtype)
    pts = np.asarray(mesh.points, np.float64)
    ctr = pts[np.asarray(mesh.bd_tris)].mean(axis=1)
    patch = np.where(ctr[:, 0] > 7.999, 1, 0).astype(np.int32)
    mesh = dc.replace(mesh, bd_patch=jnp.asarray(patch))
    mesh = set_boundary_escape(mesh, [1])
    u = np.zeros((mesh.n_tets, 3))
    u[:, 0] = 1.5
    return replace_velocity(mesh, tet_vel=u)


def test_escape_mask_baked_into_rows():
    """set_boundary_escape writes the per-tet 4-bit escape mask into
    tet_row col 19, consistent with a bd_escape gather."""
    mesh = _escape_mesh()
    nbr = np.asarray(mesh.tet_nbr)
    esc = np.asarray(mesh.bd_escape)
    bd = np.clip(-nbr - 1, 0, mesh.n_bd_faces - 1)
    want = ((nbr < 0) & esc[bd]).astype(np.int64) @ np.array([1, 2, 4, 8])
    got = np.asarray(mesh.tet_row[:, 19]).astype(np.int64)
    np.testing.assert_array_equal(want, got)
    assert want.max() > 0   # the fixture really has absorbing faces


def test_pk_escape_mask_baked_both_orders():
    """set_boundary_escape bakes the same 4-bit mask into tet_row col 19
    and tet_row_pk col 28, regardless of whether with_pk_rows ran before
    or after it."""
    from cudaparticlesfoam_tpu.mesh import set_boundary_escape, with_pk_rows

    mesh0 = box_mesh(3, 3, 3)
    m1 = set_boundary_escape(with_pk_rows(mesh0), [0])
    m2 = with_pk_rows(set_boundary_escape(mesh0, [0]))
    a1 = np.asarray(m1.tet_row_pk[:, 28])
    a2 = np.asarray(m2.tet_row_pk[:, 28])
    np.testing.assert_array_equal(a1, np.asarray(m1.tet_row[:, 19]))
    np.testing.assert_array_equal(a1, a2)
    assert a1.max() > 0          # the box has boundary tets on patch 0


def _matrix_case(variant, dtype):
    """(mesh, state, StepConfig kwargs) for one cached-vs-simple case."""
    from cudaparticlesfoam_tpu.mesh import with_convex_rows, with_pk_rows

    if variant == "pk_escape":
        mesh = with_pk_rows(_escape_mesh(dtype))
        kw = dict(velocity_interp="VertexVelocity", escape_faces=True,
                  dt=0.05, diffusion_coeff=1e-3)
        lo, hi = (0.5,) * 3, (7.5,) * 3
    else:
        mesh = box_mesh(6, 6, 6, dtype=dtype)
        pts = np.asarray(mesh.points, dtype=np.float64)
        cen = pts[np.asarray(mesh.tets)].mean(axis=1)
        outward = cen - 3.0
        outward /= np.linalg.norm(outward, axis=1, keepdims=True) + 1e-12
        mesh = replace_velocity(mesh, tet_vel=outward * 1.5)
        lo, hi = (0.5,) * 3, (5.5,) * 3
        kw = {
            "bary": dict(dt=0.08, diffusion_coeff=1e-3),
            "convex": dict(locate_mode="convex", dt=0.08,
                           use_brownian=False),
            "rk4": dict(integrator="rk4", dt=0.08, use_brownian=False),
            "chunks": dict(cycle_chunks=3, dt=0.08, diffusion_coeff=1e-3),
        }[variant]
        if variant == "convex":
            mesh = with_convex_rows(mesh)
    loc = build_grid_locator(mesh)
    st = seed_in_box(1024, lo, hi, method="threefry", dtype=dtype)
    st = rs(st, tet_id=locate_seeds(mesh, loc, st.pos))
    return mesh, st, kw


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("variant",
                         ["bary", "convex", "pk_escape", "rk4", "chunks"])
def test_cached_matches_simple_matrix(variant, dtype):
    """The cached engine against the plain simple engine, 20 cycles.

    f64: identical tet ids and positions to 1e-9.  f32: the two engines
    round in different orders, so a particle within a few ulps of a face
    may land on the other side (or escape one step apart); the bound is
    tet and active agreement >= 99% and positions within 1e-4 (box cells
    are 1 unit) on the agreeing lanes."""
    mesh, st, kw = _matrix_case(variant, np.dtype(dtype))
    a = run_cycles(mesh, st, StepConfig(engine="simple", **kw), 20)
    b = run_cycles(mesh, st, StepConfig(engine="cached", **kw), 20)
    assert a.pos.dtype == np.dtype(dtype)
    ta, tb = np.asarray(a.tet_id), np.asarray(b.tet_id)
    # live = active and located: a lane that escapes in the last cycle is
    # deactivated at once by the cached inline bounce, and by the next
    # advect in the simple engine; both give it the same -(t+1) tet id
    aa = np.asarray(a.active) & (ta >= 0)
    ab = np.asarray(b.active) & (tb >= 0)
    if dtype == "float64":
        np.testing.assert_array_equal(aa, ab)
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                                   atol=1e-9)
    else:
        same = (ta == tb) & (aa == ab)
        assert same.mean() >= 0.99
        np.testing.assert_allclose(np.asarray(a.pos)[same],
                                   np.asarray(b.pos)[same], atol=1e-4)
    if variant == "pk_escape":
        # the wind really pushes lanes out through the absorbing patch
        assert (~ab).any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("variant",
                         ["bary", "convex", "pk_escape", "rk4", "chunks"])
def test_cached_matches_simple_matrix_gpu(variant, dtype):
    """The same matrix on the GPU backend, with XLA's GPU fusion and the
    card's own contraction precision."""
    test_cached_matches_simple_matrix(variant, dtype)
