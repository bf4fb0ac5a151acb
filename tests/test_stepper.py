"""End-to-end stepper tests on the box fixture: containment invariant,
advection against analytic fields, Brownian statistics, sub-cycling."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudaparticlesfoam_tpu import (
    StepConfig,
    box_mesh,
    build_grid_locator,
    locate_seeds,
    make_state,
    run_cycles,
    seed_in_box,
    step_once,
    diagnostics,
    replace_velocity,
)
from cudaparticlesfoam_tpu.state import replace as replace_state
from cudaparticlesfoam_tpu.stepper import n_cycles_for


@pytest.fixture(scope="module")
def box():
    return box_mesh(4, 4, 4)


@pytest.fixture(scope="module")
def grid(box):
    return build_grid_locator(box)


def seeded(box, grid, n=128, seed=0, lo=(0.5, 0.5, 0.5), hi=(3.5, 3.5, 3.5)):
    st = seed_in_box(n, lo, hi, rng_seed=seed)
    tet = locate_seeds(box, grid, st.pos)
    return replace_state(st, tet_id=tet)


def test_uniform_velocity_advection(box, grid):
    # constant field: straight-line motion, exact
    m = replace_velocity(box, tet_vel=np.tile([0.5, 0.25, -0.125], (box.n_tets, 1)))
    st = seeded(m, grid, n=32)
    cfg = StepConfig(dt=0.01, use_brownian=False)
    p0 = np.asarray(st.pos)
    out = run_cycles(m, st, cfg, 100)
    p1 = np.asarray(out.pos)
    np.testing.assert_allclose(
        p1 - p0, np.tile([0.5, 0.25, -0.125], (32, 1)), atol=1e-9
    )
    assert np.asarray(out.active).all()
    assert (np.asarray(out.tet_id) >= 0).all()


def test_containment_with_reflection(box, grid):
    # strong outward radial field + reflection: particles must stay in box
    pts = np.asarray(box.points, dtype=np.float64)
    tets = np.asarray(box.tets)
    cen = pts[tets].mean(axis=1)
    outward = cen - 2.0
    outward /= np.linalg.norm(outward, axis=1, keepdims=True) + 1e-12
    m = replace_velocity(box, tet_vel=outward * 2.0)
    st = seeded(m, grid, n=64, seed=1)
    cfg = StepConfig(dt=0.05, use_brownian=False)
    out = run_cycles(m, st, cfg, 200)
    pos = np.asarray(out.pos)
    assert (pos >= -1e-9).all() and (pos <= 4.0 + 1e-9).all()
    assert np.asarray(out.active).all()
    assert (np.asarray(out.tet_id) >= 0).all()
    # tet assignment consistent with position
    from tests.test_locate import tet_containing

    for i in range(0, 64, 8):
        assert int(out.tet_id[i]) in tet_containing(box, pos[i])


def test_brownian_msd(box, grid):
    # pure diffusion: <|x - x0|^2> = 6 D t
    m = replace_velocity(box, tet_vel=np.zeros((box.n_tets, 3)))
    st = seeded(m, grid, n=4096, seed=2, lo=(1.8, 1.8, 1.8), hi=(2.2, 2.2, 2.2))
    D = 1e-3
    cfg = StepConfig(dt=1e-2, diffusion_coeff=D, use_advection=True)
    n_steps = 50
    out = run_cycles(m, st, cfg, n_steps)
    msd = float(jnp.mean(jnp.sum((out.pos - st.pos) ** 2, axis=-1)))
    expect = 6.0 * D * cfg.dt * n_steps
    assert msd == pytest.approx(expect, rel=0.1)


def test_dead_particles_stay_dead(box, grid):
    # reflection off: outward particles leave the domain and freeze
    pts = np.asarray(box.points, dtype=np.float64)
    cen = pts[np.asarray(box.tets)].mean(axis=1)
    outward = cen - 2.0
    outward /= np.linalg.norm(outward, axis=1, keepdims=True) + 1e-12
    m = replace_velocity(box, tet_vel=outward * 2.0)
    st = seeded(m, grid, n=64, seed=3)
    cfg = StepConfig(dt=0.1, use_brownian=False, reflect_wall=False)
    out = run_cycles(m, st, cfg, 100)
    act = np.asarray(out.active)
    assert not act.any()  # all escaped by t=10 at speed 2 in a 4-box
    pos = np.asarray(out.pos)
    # frozen inside the domain (they stop at the step they left)
    assert (pos >= -0.3).all() and (pos <= 4.3).all()
    d = diagnostics(out)
    assert int(d["active"]) == 0
    assert int(d["out_of_domain"]) == 64


def test_step_determinism(box, grid):
    st = seeded(box, grid, n=64, seed=4)
    cfg = StepConfig(dt=0.01)
    a = run_cycles(box, st, cfg, 10)
    b = run_cycles(box, st, cfg, 10)
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))
    # and sequential composition == one fused run
    c = run_cycles(box, run_cycles(box, st, cfg, 5), cfg, 5)
    np.testing.assert_allclose(np.asarray(c.pos), np.asarray(a.pos), atol=1e-12)


def test_n_cycles_for():
    n, cdt = n_cycles_for(0.1, 1e-4)
    assert n == 1000
    assert cdt == pytest.approx(1e-4)
    n, cdt = n_cycles_for(1e-5, 1e-4)
    assert n == 1
    assert cdt == pytest.approx(1e-5)


def test_vertex_velocity_interp(box, grid):
    # linear field u(x) = x is exactly represented by P1 vertex interp
    pts = np.asarray(box.points, dtype=np.float64)
    m = replace_velocity(box, vert_vel=pts.copy())
    st = seeded(m, grid, n=16, seed=5)
    cfg = StepConfig(dt=1e-3, use_brownian=False, velocity_interp="VertexVelocity")
    out = step_once(m, st, cfg, 1e-3)
    # displacement == dt * pos (Euler on u=x)
    np.testing.assert_allclose(
        np.asarray(out.pos - st.pos), 1e-3 * np.asarray(st.pos), atol=1e-10
    )


# ---------------------------------------------------------------------------
# option surface and tuning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(hop_compact=4),
    dict(hop_compact_frac=0.45),
    dict(macro_cycles=2),
    dict(engine_impl="pallas_packed"),
    dict(brownian_rng="rbg_kernel"),
], ids=lambda kw: next(iter(kw)))
def test_removed_option_raises(kw):
    """Options whose only paths were deleted kernels fail loudly, naming
    the option, through the constructor and through dataclasses.replace."""
    import dataclasses

    name = next(iter(kw))
    with pytest.raises(ValueError, match=name):
        StepConfig(**kw)
    with pytest.raises(ValueError, match=name):
        dataclasses.replace(StepConfig(), **kw)


@pytest.mark.parametrize("dt,hops,frac", [
    (0.1, 1, 1 / 16),     # ~0.15 crossings per sub-step
    (0.4, 2, 1 / 8),      # ~0.6
    (0.8, 4, 1 / 4),      # ~1.2
    (2.0, 8, 1 / 4),      # ~3: capped at 8 inline hops
])
def test_suggest_tuning_crossing_regimes(box, dt, hops, frac):
    """Unit-volume hexes (h = 1) in a uniform unit wind: the expected
    crossings are 1.5 * dt, and the rule maps them to inline hops and the
    rare-stage round buffer; multi-hop regimes get the lean arena."""
    from cudaparticlesfoam_tpu.stepper import suggest_tuning

    mesh = replace_velocity(box, tet_vel=np.tile([1.0, 0.0, 0.0],
                                                 (box.n_tets, 1)))
    cfg = suggest_tuning(mesh, StepConfig(dt=dt, use_brownian=False),
                         n_particles=1000)
    assert cfg.inline_hops == hops
    assert cfg.walk_capacity_frac == pytest.approx(frac)
    assert cfg.cycle_chunks == 1
    assert cfg.arena_lane_frac == (0.125 if hops >= 2 else 0.25)


@pytest.mark.parametrize("locate_mode,n,chunks,arena", [
    ("bary", 1_000_000, 1, 0.25),
    ("bary", 12_000_000, 2, 0.25),
    ("convex", 1_000_000, 1, 0.125),
])
def test_suggest_tuning_batch_and_mode(box, locate_mode, n, chunks, arena):
    """Large batches are cut into ~5M-lane sub-batches; the convex
    stream pends few lanes, so it gets the lean arena at any size."""
    from cudaparticlesfoam_tpu.stepper import suggest_tuning

    mesh = replace_velocity(box, tet_vel=np.tile([1.0, 0.0, 0.0],
                                                 (box.n_tets, 1)))
    cfg = suggest_tuning(
        mesh, StepConfig(dt=0.1, use_brownian=False, locate_mode=locate_mode),
        n_particles=n,
    )
    assert cfg.cycle_chunks == chunks
    assert cfg.arena_lane_frac == arena


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rbg_noise_moments(dtype):
    """brownian_rng='rbg' (lax.rng_bit_generator + Box-Muller): standard
    normal moments, independent axes, a fresh draw per step, and a
    different stream per key."""
    from cudaparticlesfoam_tpu.ops import fused

    cfg = StepConfig(brownian_rng="rbg")
    key = jax.random.PRNGKey(3)
    n = 200_000
    xi = np.asarray(fused._brownian_noise(key, 5, n, jnp.dtype(dtype), cfg))
    assert xi.shape == (n, 3) and xi.dtype == np.dtype(dtype)
    assert np.isfinite(xi).all()
    se = 5.0 / np.sqrt(n)      # five standard errors
    np.testing.assert_allclose(xi.mean(axis=0), 0.0, atol=se)
    np.testing.assert_allclose(xi.var(axis=0), 1.0, atol=5.0 * np.sqrt(2.0 / n))
    c = np.corrcoef(xi.T)
    np.testing.assert_allclose(c[np.triu_indices(3, 1)], 0.0, atol=se)
    # 4th moment of a normal is 3
    np.testing.assert_allclose((xi ** 4).mean(axis=0), 3.0, atol=0.1)
    xi6 = np.asarray(fused._brownian_noise(key, 6, n, jnp.dtype(dtype), cfg))
    assert abs(np.corrcoef(xi[:, 0], xi6[:, 0])[0, 1]) < se
    xk = np.asarray(fused._brownian_noise(jax.random.PRNGKey(4), 5, n,
                                          jnp.dtype(dtype), cfg))
    assert abs(np.corrcoef(xi[:, 0], xk[:, 0])[0, 1]) < se
