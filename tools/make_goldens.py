"""Generate the committed golden regression anchors (tests/golden/*.npz).

Run EXPLICITLY (and review the diff) only when a deliberate
physics/semantics change invalidates the anchors:

    JAX_PLATFORMS=cpu python tools/make_goldens.py

The anchors pin the particle engines against a fixed artifact so engine
rewrites are checked against history, not just against the simple engine
of the same commit (round-2 verdict item 8).  Everything is f64 on CPU
with Brownian either off or threefry-seeded (fully deterministic).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")


def box_workloads():
    """The box fixture (HostTetMesh.h:62-144 geometry) under an outward
    draining field — crossings, reflections, and wall grinding all active."""
    from cudaparticlesfoam_tpu import (
        StepConfig, box_mesh, build_grid_locator, locate_seeds,
        replace_velocity, run_cycles, seed_in_box,
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

    out = {}
    for name, kw in (
        ("bary_adv", dict(locate_mode="bary", use_brownian=False)),
        ("bary_brownian", dict(locate_mode="bary", diffusion_coeff=1e-3)),
        ("convex_adv", dict(locate_mode="convex", use_brownian=False)),
    ):
        cfg = StepConfig(engine="simple", dt=0.08, **kw)
        fin = run_cycles(mesh, st, cfg, 60)
        out[f"box_{name}_pos"] = np.asarray(fin.pos)
        out[f"box_{name}_tet"] = np.asarray(fin.tet_id)
        out[f"box_{name}_active"] = np.asarray(fin.active)
        print(f"box_{name}: mean|pos|={np.abs(out[f'box_{name}_pos']).mean():.6f}")
    return out


def pitz_workload(tmpdir):
    """pitzDaily-shrunk frozen-field run (the reference's headline case
    shape): shear field, 200 particles, 100 sub-steps."""
    import shutil

    from cudaparticlesfoam_tpu.io import blockmesh, foamfile, polymesh
    from cudaparticlesfoam_tpu.models import uncoupled

    src = os.path.join(
        os.path.dirname(__file__), "..", "tutorials", "incompressible",
        "cudaParticlesUncoupledFoam", "pitzDaily",
    )
    case = os.path.join(tmpdir, "pitzDaily")
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
    from cudaparticlesfoam_tpu.io.polymesh import cell_centres_volumes

    ctrs, _ = cell_centres_volumes(pm)
    os.makedirs(os.path.join(case, "282"), exist_ok=True)
    u = np.zeros((pm.n_cells, 3))
    u[:, 0] = 1.0 + 20.0 * ctrs[:, 1]
    polymesh.write_field(os.path.join(case, "282", "U"), "U", u)

    _, state, stats = uncoupled.run(
        case, out_dir=os.path.join(tmpdir, "out"), write_output=False,
        log=lambda *a: None,
    )
    assert stats["cycles"] == 100
    print(f"pitz: mean dx={np.asarray(state.pos)[:, 0].mean():.6f}")
    return {
        "pitz_pos": np.asarray(state.pos),
        "pitz_tet": np.asarray(state.tet_id),
        "pitz_active": np.asarray(state.active),
    }


def main():
    import tempfile

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    data = box_workloads()
    with tempfile.TemporaryDirectory() as td:
        data.update(pitz_workload(td))
    # record which base-point builder produced the pitz mesh: native C++
    # and numpy pick different-but-equivalent bases on exact quality ties
    # (graded cells), so the anchor is flavor-specific (box fixtures are
    # tie-free regular hexes — flavor-independent)
    from cudaparticlesfoam_tpu.models.case import _builder_flavor

    data["builder_flavor"] = np.array(_builder_flavor())
    path = os.path.join(GOLDEN_DIR, "particles_f64.npz")
    np.savez_compressed(path, **data)
    print(f"wrote {path} ({os.path.getsize(path)} bytes, "
          f"builder={data['builder_flavor']})")


if __name__ == "__main__":
    main()
