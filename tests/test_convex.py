"""ConvexPoly locate mode (query/ConvexQuery.cu semantics) vs the
barycentric walk: both algorithms must produce identical trajectories."""

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
from cudaparticlesfoam_tpu.ops import convex
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


def test_trace_segment_basic(setup):
    mesh, st = setup
    # zero displacement: stays put, same tet
    code, stop_tet, p_cross, hit_face = convex.trace_segment(
        mesh, st.pos, jnp.zeros_like(st.pos), st.tet_id
    )
    np.testing.assert_array_equal(np.asarray(code), np.asarray(st.tet_id))
    # long displacement out of the domain: wall code -(startTet+1)
    disp = jnp.tile(jnp.asarray([[100.0, 0.0, 0.0]]), (st.n_particles, 1))
    code, stop_tet, p_cross, hit_face = convex.trace_segment(mesh, st.pos, disp, st.tet_id)
    code = np.asarray(code)
    assert (code < 0).all()
    np.testing.assert_array_equal(-code - 1, np.asarray(st.tet_id))
    # hit points on the x=6 wall
    np.testing.assert_allclose(np.asarray(p_cross)[:, 0], 6.0, atol=1e-9)


def test_convex_matches_bary(setup):
    mesh, st = setup
    a = run_cycles(
        mesh, st,
        StepConfig(dt=0.08, use_brownian=False, locate_mode="bary", engine="simple"),
        100,
    )
    b = run_cycles(
        mesh, st, StepConfig(dt=0.08, use_brownian=False, locate_mode="convex"), 100
    )
    np.testing.assert_array_equal(np.asarray(a.tet_id), np.asarray(b.tet_id))
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), atol=1e-12)
    assert np.asarray(b.active).all()


def test_convex_with_brownian_containment(setup):
    mesh, st = setup
    out = run_cycles(
        mesh, st,
        StepConfig(dt=0.08, diffusion_coeff=1e-3, locate_mode="convex"),
        100,
    )
    pos = np.asarray(out.pos)
    # the convex tracer tolerates sub-cell transient excursions at corner
    # reflections (the reference shares this: its testNStracing replays
    # exactly such historical failure cases, ConvexQuery.cu:498-569);
    # particles must stay assigned and within a small dust tolerance
    assert (pos >= -1e-3).all() and (pos <= 6.0 + 1e-3).all()
    assert (np.asarray(out.tet_id) >= 0).all()
    assert np.asarray(out.active).all()


def test_packed_rows_identical(setup):
    """with_convex_rows collapses the tracer's per-hop gathers into one;
    results must be bit-identical to the unpacked tables."""
    from cudaparticlesfoam_tpu.mesh import with_convex_rows

    mesh, st = setup
    cfg = StepConfig(dt=0.08, use_brownian=False, locate_mode="convex",
                     engine="simple")
    a = run_cycles(mesh, st, cfg, 60)
    b = run_cycles(with_convex_rows(mesh), st, cfg, 60)
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))
    np.testing.assert_array_equal(np.asarray(a.tet_id), np.asarray(b.tet_id))
    np.testing.assert_array_equal(np.asarray(a.vel), np.asarray(b.vel))


def test_cached_convex_matches_simple(setup):
    """Phase-1 cached ConvexPoly engine (inline exit classification +
    block-compacted simple-path resolution) reproduces the simple engine
    exactly: pure advection with wall reflection, and with Brownian."""
    from cudaparticlesfoam_tpu.mesh import with_convex_rows

    mesh, st = setup
    mesh_cx = with_convex_rows(mesh)
    for kw in (dict(use_brownian=False), dict(diffusion_coeff=1e-3)):
        a = run_cycles(
            mesh_cx, st,
            StepConfig(engine="simple", locate_mode="convex", dt=0.08, **kw),
            60,
        )
        b = run_cycles(
            mesh_cx, st,
            StepConfig(engine="cached", locate_mode="convex", dt=0.08, **kw),
            60,
        )
        np.testing.assert_allclose(
            np.asarray(a.pos), np.asarray(b.pos), atol=1e-9
        )
        np.testing.assert_array_equal(
            np.asarray(a.tet_id), np.asarray(b.tet_id)
        )
        np.testing.assert_array_equal(
            np.asarray(a.active), np.asarray(b.active)
        )
        np.testing.assert_allclose(
            np.asarray(a.vel), np.asarray(b.vel), atol=1e-9
        )


def test_cached_convex_without_rows_falls_back(setup):
    """auto engine on convex mode without with_convex_rows: simple path."""
    mesh, st = setup
    cfg = StepConfig(locate_mode="convex", dt=0.08, use_brownian=False)
    assert cfg.resolved_engine() == "cached"
    a = run_cycles(mesh, st, cfg, 20)          # falls back silently
    b = run_cycles(
        mesh, st,
        StepConfig(engine="simple", locate_mode="convex", dt=0.08,
                   use_brownian=False),
        20,
    )
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cached_convex_segment_starting_on_a_face(dtype):
    """A segment that starts exactly on a face of its tet and leaves
    through it has its exit at dT = 0, below the tracer's tolerance; the
    cached engine must still relocate it, as the simple engine's
    barycentric pass does."""
    from cudaparticlesfoam_tpu import locate_seeds, replace_velocity
    from cudaparticlesfoam_tpu.mesh import with_convex_rows
    from cudaparticlesfoam_tpu.state import make_state, replace as rs

    mesh = box_mesh(3, 3, 3, dtype=np.dtype(dtype))
    u = np.tile([0.1, -0.1, 0.0], (mesh.n_tets, 1))
    mesh = with_convex_rows(replace_velocity(mesh, tet_vel=u))
    loc = build_grid_locator(mesh)
    # points on the x = y plane of a unit cube, each given the tet on the
    # x < y side (found from a point nudged there), moving to x > y
    p = np.array([[1.25, 1.25, 1.6], [0.5, 0.5, 0.3], [2.4, 2.4, 2.9]])
    nudged = p + np.array([-1e-3, 1e-3, 0.0])
    tet0 = locate_seeds(mesh, loc, jnp.asarray(nudged, mesh.dtype))
    st = rs(make_state(jnp.asarray(p, mesh.dtype)), tet_id=tet0)
    kw = dict(locate_mode="convex", dt=1.0, use_brownian=False)
    a = run_cycles(mesh, st, StepConfig(engine="simple", **kw), 1)
    b = run_cycles(mesh, st, StepConfig(engine="cached", **kw), 1)
    assert (np.asarray(a.tet_id) != np.asarray(tet0)).all()
    np.testing.assert_array_equal(np.asarray(b.tet_id), np.asarray(a.tet_id))
    np.testing.assert_allclose(np.asarray(b.pos), np.asarray(a.pos), atol=1e-6)
