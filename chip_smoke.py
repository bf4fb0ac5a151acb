"""End-to-end check of the particle tracker on an NVIDIA GPU.

Usage:
    python chip_smoke.py               # one card: every single-card phase
    python chip_smoke.py --devices 4   # four cards: the multi-card phases

One card, in this order (any failure exits non-zero):

* device      -- JAX's default backend is a GPU; prints its kind and the
                 name and power limit nvidia-smi reports.
* tutorial    -- the pitzDaily tutorial at its published size through the
                 CLI: blockmesh -> simple (--iters bounded) -> uncoupled,
                 1e5 particles x 1000 sub-steps, 101 VTU frames.  The last
                 frame must have every ParticleTetID >= 0 and every
                 position inside the mesh bounds.
* coupled     -- the TJunction tutorial through the coupled case driver at
                 its published 4e6 particles for 2 Eulerian steps (native
                 PIMPLE + kEpsilon): finite U, a falling continuity
                 residual, every active particle located.
* parity      -- the cached engine against the plain ``engine="simple"``
                 reference at f32 on the 1M-particle / 998k-tet box of
                 bench.py, in four variants (bary without Brownian motion,
                 bary with threefry noise, convex, VertexVelocity with an
                 absorbing outlet).  Tolerances, in cell lengths (the box
                 cells are 1 unit; f32 spacing at coordinate 55 is 3.8e-6):
                 stepping both engines one cycle at a time from a shared
                 state, every lane they put on different tets lies within
                 1e-5 of a face of its tet (a rounding tie on which side of
                 that face it landed) and every other lane's position
                 agrees to 1e-4; after 50 free cycles >= 99.99% of lanes
                 are on the same tet with positions within 1e-4 (a lane
                 that took a tie the other way once used its neighbour's
                 velocity for that step and keeps the offset).
* throughput  -- one informational line: particle-steps/s on the 1M box
                 with the tuned production config.
* f64         -- the golden box trajectories (tests/golden/particles_f64.npz)
                 replayed in float64 on the card: identical tet ids, and
                 the position tolerance actually needed is printed (the
                 CPU pins 1e-12; the bound here is 1e-9).  Then the tests
                 marked ``gpu`` run in this same process (pytest -m gpu on
                 the modules that hold them).

Four cards (``--devices 4``), each compared with the same program on one
card: particle data parallelism on the 1M box, spatial partitioning with
migration on the box vortex (advection only), and ``coupled
--flow-devices 4`` on TJunction for 2 steps.  It also prints the
collectives found in the compiled 4-card data-parallel cycle.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
A machine without a GPU makes the script fail; it never falls back to the
CPU.  Everything runs in this one process.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from cudaparticlesfoam_tpu import StepConfig, run_cycles  # noqa: E402
from cudaparticlesfoam_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

PITZ = os.path.join(ROOT, "tutorials", "incompressible",
                    "cudaParticlesUncoupledFoam", "pitzDaily")
TJUNCTION = os.path.join(ROOT, "tutorials", "incompressible",
                         "cudaParticlesPimpleFoam", "TJunction")
N_SIDE = 55                 # bench.py's headline box: 998,250 tets
N_HEADLINE = 1_000_000
PARITY_CYCLES = 50
POS_TOL = 1e-4              # cell lengths, lanes whose tets agree
TET_AGREE = 0.9999          # fraction of lanes on the same tet
FACE_TOL = 1e-5             # cell lengths, per-cycle disagreeing lanes
F64_TOL = 1e-9
U_REL_TOL = 1e-3            # relative L2 of the 4-card vs 1-card flow U
U_MAX_TOL = 1e-2            # max cell difference, fraction of max |U|


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    say(f"[{name}] start")
    yield
    say(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------------------
# one card
# --------------------------------------------------------------------------


def vtu_array(path, name):
    txt = open(path).read()
    m = re.search(rf"Name='{name}' format='ascii'>\n(.*?)</DataArray>", txt,
                  re.S)
    check(m is not None, f"{path}: no {name} array")
    return np.array(m.group(1).split(), dtype=np.float64)


def tutorial_phase(work):
    from cudaparticlesfoam_tpu import cli
    from cudaparticlesfoam_tpu.io import foamfile, polymesh

    case = os.path.join(work, "pitzDaily")
    out = os.path.join(work, "pitzDaily_out")
    shutil.copytree(PITZ, case)
    pd = foamfile.read(os.path.join(case, "system", "cudaParticlesDict"))
    cd = foamfile.read(os.path.join(case, "system", "controlDict"))
    n_p = int(float(pd["numParticles"]))
    n_sub = round(float(cd["deltaT"]) / float(pd["dt"]))
    n_frames = n_sub // int(pd["saveInterval"]) + 1
    say(f"[tutorial] pitzDaily: {n_p} particles x {n_sub} sub-steps, "
        f"{n_frames} frames expected")
    cli.main(["blockmesh", case])
    cli.main(["simple", case, "--iters", "100"])
    t0 = time.perf_counter()
    cli.main(["uncoupled", case, "--out", out])
    wall = time.perf_counter() - t0
    frames = sorted(glob.glob(os.path.join(out, "particle_*.vtu")))
    check(len(frames) == n_frames,
          f"{len(frames)} frames written, {n_frames} expected")
    tet = vtu_array(frames[-1], "ParticleTetID")
    pos = vtu_array(frames[-1], "Position").reshape(-1, 3)
    check(len(tet) == n_p, f"last frame holds {len(tet)} particles")
    n_out = int((tet < 0).sum())
    check(n_out == 0, f"{n_out} particles out of the domain")
    pts = polymesh.read_polymesh(
        os.path.join(case, "constant", "polyMesh")).points
    lo, hi = pts.min(axis=0) - 1e-6, pts.max(axis=0) + 1e-6
    inside = np.all((pos >= lo) & (pos <= hi), axis=1)
    check(inside.all(), f"{int((~inside).sum())} positions outside the mesh "
          f"bounds {lo} .. {hi}")
    say(f"[tutorial] {len(frames)} frames, out-of-domain 0, all positions "
        f"inside {np.round(lo, 5).tolist()} .. {np.round(hi, 5).tolist()}; "
        f"uncoupled wall time {wall:.2f} s (CLI, incl. mesh, seeding, "
        f"compile and frame output)")


def tjunction_case(work, name, n_particles=None):
    """Copy of the TJunction tutorial whose particle window opens at t=0,
    so the first Eulerian steps already carry particles."""
    from cudaparticlesfoam_tpu import cli
    from cudaparticlesfoam_tpu.io import foamfile

    case = os.path.join(work, name)
    shutil.copytree(TJUNCTION, case)
    path = os.path.join(case, "system", "cudaParticlesDict")
    d = foamfile.read(path)
    d.pop("FoamFile", None)
    d["startTime"] = 0.0
    if n_particles is not None:
        d["numParticles"] = n_particles
    foamfile.write(path, d, obj_name="cudaParticlesDict")
    cli.main(["blockmesh", case])
    return case


def run_coupled_logged(case, **kw):
    from cudaparticlesfoam_tpu.models import coupled

    lines = []

    def log(*a, **k):
        s = " ".join(str(x) for x in a)
        lines.append(s)
        print(s, flush=True)

    case_obj, state, stats = coupled.run_coupled(
        case, write_output=False, n_steps=2, log=log, **kw
    )
    cont = [float(m.group(1)) for s in lines
            for m in [re.search(r"continuity=([0-9.eE+-]+)", s)] if m]
    return case_obj, state, stats, cont


def tet_velocity(case_obj):
    from cudaparticlesfoam_tpu.mesh import host_np

    return host_np(case_obj.tet_mesh, "tet_vel", np.float64)


def coupled_phase(work):
    case = tjunction_case(work, "TJunction")
    t0 = time.perf_counter()
    case_obj, state, stats, cont = run_coupled_logged(case)
    wall = time.perf_counter() - t0
    u = tet_velocity(case_obj)
    check(np.isfinite(u).all(), "non-finite U")
    check(len(cont) >= 2, f"continuity residuals logged: {cont}")
    check(cont[-1] < cont[0], f"continuity did not fall: {cont}")
    tet = np.asarray(state.tet_id)
    act = np.asarray(state.active)
    lost = int((act & (tet < 0)).sum())
    check(lost == 0, f"{lost} active particles not located")
    say(f"[coupled] TJunction {case_obj.tet_mesh.n_tets} tets, "
        f"{state.n_particles} particles ({int(act.sum())} active), "
        f"{stats['cycles']} sub-steps to t={stats['time']:g}; continuity "
        f"{cont}; max|U| {np.abs(u).max():.4g}; wall {wall:.2f} s")


def face_distance(pts, tets, p, t):
    """Distance from points p [k,3] to the nearest face plane of tets t."""
    v = pts[tets[t]]                                   # [k,4,3]
    best = np.full(len(p), np.inf)
    for i in range(4):
        a, b, c = (v[:, j] for j in range(4) if j != i)
        n = np.cross(b - a, c - a)
        d = np.abs(np.einsum("kj,kj->k", p - a, n)) / np.linalg.norm(n, axis=1)
        best = np.minimum(best, d)
    return best


def compare_states(a, b):
    """(fraction of lanes on the same tet and within POS_TOL, max position
    diff over the lanes on the same tet, same-tet mask)."""
    ta, tb = np.asarray(a.tet_id), np.asarray(b.tet_id)
    la = np.asarray(a.active) & (ta >= 0)
    lb = np.asarray(b.active) & (tb >= 0)
    same = (ta == tb) & (la == lb)
    dpos = np.abs(np.asarray(a.pos, np.float64)
                  - np.asarray(b.pos, np.float64)).max(axis=1)
    agree = same & (dpos <= POS_TOL)
    return agree.mean(), float(dpos[same].max(initial=0.0)), same


def parity_workloads():
    """(name, mesh, state, StepConfig kwargs) for the four variants."""
    from cudaparticlesfoam_tpu import replace_velocity
    from cudaparticlesfoam_tpu.mesh import (
        host_np, with_convex_rows, with_pk_rows,
    )

    mesh, st = bench.build_workload(N_SIDE, N_HEADLINE)
    base = dict(dt=0.05, diffusion_coeff=1e-3)
    yield "bary-advect", mesh, st, dict(base, use_brownian=False)
    yield "bary-threefry", mesh, st, dict(base)
    yield "convex-threefry", with_convex_rows(mesh), st, dict(
        base, locate_mode="convex")
    del mesh
    mesh_u, st_u = bench.build_unstructured_workload(N_SIDE, N_HEADLINE)
    pts = host_np(mesh_u, "points", np.float64)
    r = pts[:, :2] - N_SIDE / 2.0
    r2 = (r * r).sum(axis=1) / (N_SIDE / 2.0) ** 2
    omega = (5.2 / N_SIDE) * np.maximum(1.0 - r2, 0.0)
    vv = np.zeros_like(pts)
    vv[:, 0] = -r[:, 1] * omega
    vv[:, 1] = r[:, 0] * omega
    mesh_pk = with_pk_rows(replace_velocity(mesh_u, vert_vel=vv))
    yield "pk-escape-threefry", mesh_pk, st_u, dict(
        base, velocity_interp="VertexVelocity", escape_faces=True)


def parity_phase():
    from cudaparticlesfoam_tpu.mesh import host_np
    from cudaparticlesfoam_tpu.stepper import suggest_tuning

    for name, mesh, st, kw in parity_workloads():
        simple = StepConfig(engine="simple", **kw)
        cached = suggest_tuning(mesh, StepConfig(engine="cached", **kw),
                                n_particles=st.n_particles)
        a = run_cycles(mesh, st, simple, PARITY_CYCLES)
        b = run_cycles(mesh, st, cached, PARITY_CYCLES)
        agree, dmax, _ = compare_states(a, b)
        say(f"[parity] {name}: {PARITY_CYCLES} free cycles: lanes on the "
            f"same tet and within {POS_TOL}: {agree:.6f} (>= {TET_AGREE}); "
            f"max |dpos| on same-tet lanes {dmax:.3e}")
        pts = host_np(mesh, "points", np.float64)
        tets = host_np(mesh, "tets")
        s, n_dis, worst, step_dmax = st, 0, 0.0, 0.0
        for _ in range(PARITY_CYCLES):
            a = run_cycles(mesh, s, simple, 1)
            b = run_cycles(mesh, s, cached, 1)
            _, d1, same = compare_states(a, b)
            step_dmax = max(step_dmax, d1)
            bad = np.nonzero(~same)[0]
            if len(bad):
                n_dis += len(bad)
                ta = np.asarray(a.tet_id)[bad]
                ta = np.where(ta < 0, -ta - 1, ta)
                dist = face_distance(
                    pts, tets, np.asarray(a.pos, np.float64)[bad], ta)
                worst = max(worst, float(dist.max()))
            s = a
        say(f"[parity] {name}: per-cycle from a shared state: "
            f"{n_dis} disagreeing lane-steps of "
            f"{PARITY_CYCLES * st.n_particles}, farthest from a face "
            f"{worst:.3e} (<= {FACE_TOL}); max |dpos| {step_dmax:.3e}")
        check(worst <= FACE_TOL, f"{name}: disagreeing lane {worst} from "
              f"the nearest face")
        check(step_dmax <= POS_TOL, f"{name}: per-cycle position diff")
        check(agree >= TET_AGREE, f"{name}: free-run agreement {agree}")
        del a, b, s
        gc.collect()


def throughput_phase(card):
    from cudaparticlesfoam_tpu.stepper import suggest_tuning

    mesh, st = bench.build_workload(N_SIDE, N_HEADLINE)
    cfg = suggest_tuning(
        mesh, StepConfig(dt=0.05, diffusion_coeff=1e-3, brownian_rng="rbg"),
        n_particles=N_HEADLINE,
    )
    n_cyc = 200
    out = run_cycles(mesh, st, cfg, n_cyc)
    jax.block_until_ready(out.pos)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = run_cycles(mesh, st, cfg, n_cyc)
        jax.block_until_ready(out.pos)
        best = min(best, time.perf_counter() - t0)
    rate = N_HEADLINE * n_cyc / best
    say(f"[throughput] headline 1M particles / {mesh.n_tets} tets, f32, "
        f"rbg noise, {n_cyc} cycles in {best * 1e3:.2f} ms: "
        f"{rate:.1f} particle-steps/s on {card}")


def f64_phase():
    jax.config.update("jax_enable_x64", True)
    from cudaparticlesfoam_tpu import (
        box_mesh, build_grid_locator, locate_seeds, replace_velocity,
        seed_in_box,
    )
    from cudaparticlesfoam_tpu.mesh import with_convex_rows
    from cudaparticlesfoam_tpu.state import replace as rs

    golden = np.load(os.path.join(ROOT, "tests", "golden",
                                  "particles_f64.npz"))
    mesh = box_mesh(6, 6, 6, dtype=np.float64)
    loc = build_grid_locator(mesh)
    pts = np.asarray(mesh.points, dtype=np.float64)
    cen = pts[np.asarray(mesh.tets)].mean(axis=1)
    outward = cen - 3.0
    outward /= np.linalg.norm(outward, axis=1, keepdims=True) + 1e-12
    mesh = with_convex_rows(replace_velocity(mesh, tet_vel=outward * 1.5))
    st = seed_in_box(256, (0.5,) * 3, (5.5,) * 3, method="threefry")
    st = rs(st, tet_id=locate_seeds(mesh, loc, st.pos))
    check(st.pos.dtype == jnp.float64, "f64 state expected")
    worst = 0.0
    for name, kw in (
        ("bary_adv", dict(locate_mode="bary", use_brownian=False)),
        ("bary_brownian", dict(locate_mode="bary", diffusion_coeff=1e-3)),
        ("convex_adv", dict(locate_mode="convex", use_brownian=False)),
    ):
        for engine in ("simple", "cached"):
            fin = run_cycles(mesh, st, StepConfig(engine=engine, dt=0.08,
                                                  **kw), 60)
            tet_ok = np.array_equal(np.asarray(fin.tet_id),
                                    golden[f"box_{name}_tet"])
            act_ok = np.array_equal(np.asarray(fin.active),
                                    golden[f"box_{name}_active"])
            d = float(np.abs(np.asarray(fin.pos)
                             - golden[f"box_{name}_pos"]).max())
            worst = max(worst, d)
            say(f"[f64] golden {name} [{engine}]: tet ids identical "
                f"{tet_ok}, active identical {act_ok}, max |dpos| {d:.3e}")
            check(tet_ok and act_ok, f"{name} [{engine}] ids differ")
    say(f"[f64] position tolerance needed on this card: {worst:.3e} "
        f"(bound {F64_TOL}; the CPU pins 1e-12)")
    check(worst <= F64_TOL, f"f64 golden drift {worst}")
    import pytest

    # only the modules that hold gpu tests: collecting the others would
    # import them all, and ``tests`` is a namespace package that any
    # installed package of that name shadows
    files = [f for f in sorted(glob.glob(os.path.join(ROOT, "tests",
                                                      "test_*.py")))
             if "pytest.mark.gpu" in open(f).read()]
    check(files, "no test module holds gpu-marked tests")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", *files])
    check(rc == 0, f"pytest -m gpu exited {rc}")


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------


def collectives_in_loops(hlo: str):
    """(op kind, computation, in a while body?) for every collective in
    an optimized HLO module."""
    bodies = set(re.findall(r"body=%?([\w.\-]+)", hlo))
    found = []
    comp = None
    for line in hlo.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if m and not line.startswith(" "):
            comp = m.group(1)
            continue
        k = re.search(r"\b(all-gather|all-reduce|all-to-all|reduce-scatter|"
                      r"collective-permute)(?:-start)?\(", line)
        if k:
            found.append((k.group(1), comp, comp in bodies))
    return found


def dp_phase(n_dev, hlo_dir):
    from cudaparticlesfoam_tpu.parallel import sharding

    mesh, st = bench.build_workload(N_SIDE, N_HEADLINE)
    cfg = StepConfig(dt=0.05, diffusion_coeff=1e-3)   # threefry, cached
    ref = run_cycles(mesh, st, cfg, PARITY_CYCLES)
    jax.block_until_ready(ref.pos)
    _, rmesh, sst = sharding.distribute(mesh, st, n_dev)
    hlo = sharding.run_cycles_sharded.lower(
        rmesh, sst, cfg, PARITY_CYCLES).compile().as_text()
    if hlo_dir:
        os.makedirs(hlo_dir, exist_ok=True)
        with open(os.path.join(hlo_dir, "dp_cycle.hlo.txt"), "w") as fh:
            fh.write(hlo)
    t0 = time.perf_counter()
    out = sharding.run_cycles_sharded(rmesh, sst, cfg, PARITY_CYCLES)
    jax.block_until_ready(out.pos)
    wall = time.perf_counter() - t0
    n = st.n_particles
    out = dataclasses.replace(out, pos=out.pos[:n], tet_id=out.tet_id[:n],
                              active=out.active[:n], n_particles=n)
    agree, dmax, _ = compare_states(ref, out)
    say(f"[dp] {n_dev} cards vs 1: {PARITY_CYCLES} cycles, lanes on the "
        f"same tet and within {POS_TOL}: {agree:.6f}, max |dpos| on "
        f"same-tet lanes {dmax:.3e} (first call incl. compile {wall:.2f} s)")
    check(agree >= TET_AGREE, "DP diverges from 1 card")
    found = collectives_in_loops(hlo)
    kinds = {}
    for kind, comp, in_loop in found:
        key = (kind, in_loop)
        kinds[key] = kinds.get(key, 0) + 1
    say(f"[dp] collectives in the compiled {n_dev}-card cycle: "
        + (", ".join(f"{k} x{c} ({'inside' if loop else 'outside'} a loop)"
                     for (k, loop), c in sorted(kinds.items())) or "none"))
    for kind, comp, in_loop in found:
        if in_loop:
            say(f"[dp]   {kind} in while body {comp}")


def partitioned_phase(n_dev):
    from cudaparticlesfoam_tpu.parallel import partition, sharding

    mesh, st = bench.build_workload(N_SIDE, N_HEADLINE)
    cfg = StepConfig(dt=0.05, use_brownian=False)
    ref = run_cycles(mesh, st, cfg, PARITY_CYCLES)
    pm = partition.partition_mesh(mesh, n_dev)
    sp = partition.distribute_particles(
        pm, st.pos, st.vel, st.tet_id, st.active)
    dmesh = sharding.make_device_mesh(n_dev, axis="s")
    pm, sp = partition.shard_arrays(pm, sp, dmesh)
    run = partition.make_partitioned_runner(pm, cfg, dmesh, PARITY_CYCLES)
    settle = partition.make_settle_step(pm, cfg, dmesh)
    t0 = time.perf_counter()
    sp, stats = run(pm, sp, cfg.dt)
    sp, _ = settle(pm, sp, 0.0)
    jax.block_until_ready(sp.pos)
    wall = time.perf_counter() - t0
    check(int(np.asarray(sp.resident).sum()) == st.n_particles,
          "particles lost in migration")
    pos, _vel, tet, act = partition.collect_particles(pm, sp, st.n_particles)
    part = dataclasses.replace(ref, pos=jnp.asarray(pos),
                               tet_id=jnp.asarray(tet),
                               active=jnp.asarray(act))
    agree, dmax, _ = compare_states(ref, part)
    say(f"[partitioned] {n_dev} slabs vs 1 card: {PARITY_CYCLES} cycles, "
        f"migrated {int(np.asarray(stats['migrated']).sum())} lane-moves, "
        f"deferred {int(np.asarray(stats['deferred']).sum())}, "
        f"lanes on the same tet and within {POS_TOL}: {agree:.6f}, max "
        f"|dpos| on same-tet lanes {dmax:.3e} (first call incl. compile "
        f"{wall:.2f} s)")
    check(agree >= TET_AGREE, "partitioned run diverges from 1 card")


def flow_sharded_phase(work, n_dev):
    case1 = tjunction_case(work, "TJ1", n_particles=100_000)
    case4 = tjunction_case(work, "TJ4", n_particles=100_000)
    c1, _, _, cont1 = run_coupled_logged(case1, devices=1)
    c4, st4, _, cont4 = run_coupled_logged(case4, flow_devices=n_dev)
    u1, u4 = tet_velocity(c1), tet_velocity(c4)
    du = float(np.abs(u1 - u4).max())
    scale = float(np.abs(u1).max())
    rel_l2 = float(np.linalg.norm(u1 - u4) / np.linalg.norm(u1))
    say(f"[flow] coupled --flow-devices {n_dev} vs 1 card on TJunction, "
        f"2 steps: |dU|/|U| (L2) {rel_l2:.3e} (bound {U_REL_TOL}), max "
        f"|dU| {du:.3e} of max |U| {scale:.4g} (bound {U_MAX_TOL} of it); "
        f"continuity 1 card {cont1}, {n_dev} cards {cont4}")
    check(np.isfinite(u4).all(), "non-finite sharded U")
    check(rel_l2 <= U_REL_TOL and du <= U_MAX_TOL * scale,
          "sharded flow diverges from 1 card")


# --------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="1: single-card phases; 4: multi-card phases")
    ap.add_argument("--hlo-dir", default=None,
                    help="with --devices 4: write the compiled DP cycle here")
    args = ap.parse_args(argv)

    devs = jax.devices()
    kind = devs[0].device_kind
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's default device is {devs[0].platform} ({kind})")
    check(len(devs) >= args.devices,
          f"{args.devices} GPUs asked for, {len(devs)} visible")
    enable_compile_cache()
    card = card_line()
    say(f"[device] {kind} x{len(devs)}; nvidia-smi: {card}")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.devices == 1:
            with phase("tutorial"):
                tutorial_phase(work)
            gc.collect()
            with phase("coupled"):
                coupled_phase(work)
            gc.collect()
            with phase("parity"):
                parity_phase()
            gc.collect()
            with phase("throughput"):
                throughput_phase(card)
            gc.collect()
            with phase("f64"):
                f64_phase()
        else:
            with phase("dp"):
                dp_phase(args.devices, args.hlo_dir)
            gc.collect()
            with phase("partitioned"):
                partitioned_phase(args.devices)
            gc.collect()
            with phase("flow"):
                flow_sharded_phase(work, args.devices)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
