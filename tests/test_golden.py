"""Golden regression anchors: engines diffed against a COMMITTED f64
artifact (tests/golden/particles_f64.npz, generated by
tools/make_goldens.py), so engine rewrites are checked against a fixed
history — not just against the simple engine of the same commit
(round-2 verdict item 8).

Tolerances: f64 runs must reproduce the artifact to 1e-12 (identical
math, CPU) and to 1e-9 on the GPU (``gpu`` marker); any drift beyond that
is a semantics change and must be an explicit, reviewed regeneration of
the artifact.
"""

import os

import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "particles_f64.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def box_setup():
    from cudaparticlesfoam_tpu import (
        box_mesh, build_grid_locator, locate_seeds, replace_velocity,
        seed_in_box,
    )
    from cudaparticlesfoam_tpu.mesh import with_convex_rows
    from cudaparticlesfoam_tpu.state import replace as rs

    mesh = box_mesh(6, 6, 6, dtype=np.float64)
    loc = build_grid_locator(mesh)
    pts = np.asarray(mesh.points, dtype=np.float64)
    cen = pts[np.asarray(mesh.tets)].mean(axis=1)
    outward = cen - 3.0
    outward /= np.linalg.norm(outward, axis=1, keepdims=True) + 1e-12
    mesh = replace_velocity(mesh, tet_vel=outward * 1.5)
    mesh = with_convex_rows(mesh)
    st = seed_in_box(256, (0.5,) * 3, (5.5,) * 3, method="threefry")
    st = rs(st, tet_id=locate_seeds(mesh, loc, st.pos))
    return mesh, st


CONFIGS = [
    ("bary_adv", dict(locate_mode="bary", use_brownian=False)),
    ("bary_brownian", dict(locate_mode="bary", diffusion_coeff=1e-3)),
    ("convex_adv", dict(locate_mode="convex", use_brownian=False)),
]


def _replay_box(golden, box_setup, name, kw, engine, atol):
    from cudaparticlesfoam_tpu import StepConfig, run_cycles

    mesh, st = box_setup
    cfg = StepConfig(engine=engine, dt=0.08, **kw)
    fin = run_cycles(mesh, st, cfg, 60)
    np.testing.assert_allclose(
        np.asarray(fin.pos), golden[f"box_{name}_pos"], atol=atol,
        err_msg=f"box {name} [{engine}] drifted from the golden anchor",
    )
    np.testing.assert_array_equal(
        np.asarray(fin.tet_id), golden[f"box_{name}_tet"]
    )
    np.testing.assert_array_equal(
        np.asarray(fin.active), golden[f"box_{name}_active"]
    )


@pytest.mark.parametrize("name,kw", CONFIGS)
@pytest.mark.parametrize("engine", ["simple", "cached"])
def test_box_engines_match_golden(golden, box_setup, name, kw, engine):
    _replay_box(golden, box_setup, name, kw, engine, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw", CONFIGS)
@pytest.mark.parametrize("engine", ["simple", "cached"])
def test_box_engines_match_golden_gpu(golden, box_setup, name, kw, engine):
    """The same replay in f64 on the GPU: identical ids; positions to
    1e-9, since the GPU's fused multiply-adds round differently from the
    CPU that wrote the anchor."""
    _replay_box(golden, box_setup, name, kw, engine, atol=1e-9)


def test_pitz_driver_matches_golden(golden, tmp_path):
    """The full uncoupled driver (pitzDaily-shrunk shear field) against
    the committed anchor — pins the whole case pipeline: blockMesh,
    tet decomposition, seeding, locate, tuned engine, sub-cycling.

    Flavor-gated: the graded pitz cells have exact quality TIES among
    base-point candidates, where the native C++ and numpy builders make
    different-but-equivalent picks; the anchor records which builder
    produced it (box anchors are tie-free and flavor-independent)."""
    import shutil

    from cudaparticlesfoam_tpu.models.case import _builder_flavor

    want = str(golden.get("builder_flavor", "numpy"))
    if _builder_flavor() != want:
        pytest.skip(f"golden anchor was built with the {want} base-point "
                    f"builder; this host runs {_builder_flavor()}")

    from cudaparticlesfoam_tpu.io import blockmesh, foamfile, polymesh
    from cudaparticlesfoam_tpu.io.polymesh import cell_centres_volumes
    from cudaparticlesfoam_tpu.models import uncoupled

    src = os.path.join(
        os.path.dirname(__file__), "..", "tutorials", "incompressible",
        "cudaParticlesUncoupledFoam", "pitzDaily",
    )
    case = str(tmp_path / "pitzDaily")
    shutil.copytree(src, case)
    d = foamfile.read(os.path.join(case, "system", "cudaParticlesDict"))
    d.pop("FoamFile", None)
    d["numParticles"] = 200
    foamfile.write(os.path.join(case, "system", "cudaParticlesDict"), d,
                   obj_name="cudaParticlesDict")
    cd = foamfile.read(os.path.join(case, "system", "controlDict"))
    cd.pop("FoamFile", None)
    cd.pop("functions", None)
    cd["deltaT"] = 0.01
    foamfile.write(os.path.join(case, "system", "controlDict"), cd,
                   obj_name="controlDict")
    pm = blockmesh.generate(os.path.join(case, "system", "blockMeshDict"))
    ctrs, _ = cell_centres_volumes(pm)
    os.makedirs(os.path.join(case, "282"), exist_ok=True)
    u = np.zeros((pm.n_cells, 3))
    u[:, 0] = 1.0 + 20.0 * ctrs[:, 1]
    polymesh.write_field(os.path.join(case, "282", "U"), "U", u)

    _, state, stats = uncoupled.run(
        case, out_dir=str(tmp_path / "out"), write_output=False,
        log=lambda *a: None,
    )
    assert stats["cycles"] == 100
    np.testing.assert_allclose(
        np.asarray(state.pos), golden["pitz_pos"], atol=1e-12,
        err_msg="pitzDaily driver drifted from the golden anchor",
    )
    np.testing.assert_array_equal(np.asarray(state.tet_id), golden["pitz_tet"])
    np.testing.assert_array_equal(
        np.asarray(state.active), golden["pitz_active"]
    )
