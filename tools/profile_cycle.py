"""Device-side op-level profile of the fused cycle on the bench workload.

Usage: python tools/profile_cycle.py [n_side] [n_particles] [n_cycles] [frac]

Runs the exact headline-bench workload, captures a jax.profiler trace of
one warmed-up run_cycles call, and prints device time by named scope
(``stream``, ``rare_stage``) and by kernel, from the GPU device planes.
"""

import glob
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cached_box_mesh(n_side):
    """Cache the box mesh's host arrays between runs of this tool."""
    import pickle

    import jax

    from cudaparticlesfoam_tpu import box_mesh

    import jax.numpy as jnp

    from cudaparticlesfoam_tpu import mesh as meshlib

    path = os.path.join(tempfile.gettempdir(), f"boxmesh_{n_side}_v2.pkl")
    if os.path.exists(path):
        with open(path, "rb") as fh:
            host = pickle.load(fh)
        return meshlib.host_to_device(host)
    mesh = box_mesh(n_side, n_side, n_side)
    host = meshlib._mirror_of(mesh)      # box_mesh builds host-side
    with open(path, "wb") as fh:
        pickle.dump(host, fh)
    return mesh


def build(n_side, n_particles):
    from cudaparticlesfoam_tpu import (
        build_grid_locator,
        locate_seeds,
        replace_velocity,
        seed_in_box,
    )
    from cudaparticlesfoam_tpu.state import replace as replace_state

    mesh = _cached_box_mesh(n_side)
    # confined vortex (same field as bench.py)
    from cudaparticlesfoam_tpu.mesh import host_np

    cen = host_np(mesh, "points", np.float64)[host_np(mesh, "tets")].mean(axis=1)
    r = cen[:, :2] - n_side / 2.0
    r2 = (r * r).sum(axis=1) / (n_side / 2.0) ** 2
    omega = (5.2 / n_side) * np.maximum(1.0 - r2, 0.0)
    u = np.zeros_like(cen)
    u[:, 0] = -r[:, 1] * omega
    u[:, 1] = r[:, 0] * omega
    mesh = replace_velocity(mesh, tet_vel=u)
    loc = build_grid_locator(mesh)
    lo, hi = 0.05 * n_side, 0.95 * n_side
    st = seed_in_box(n_particles, (lo,) * 3, (hi,) * 3, method="threefry")
    tet = locate_seeds(mesh, loc, st.pos)
    return mesh, replace_state(st, tet_id=tet)


SCOPES = ("stream", "rare_stage")


def parse_trace(tdir, scopes=SCOPES, top=40):
    """Device time per kernel and per named scope from a jax.profiler
    trace directory (the ``.xplane.pb`` JAX writes); prints the table and
    returns ``{"busy_ms", "span_ms", "ops", "scopes"}``.

    Device planes are the ``/device:GPU:N`` ones; each kernel event's
    ``name`` stat carries the op path, so a ``jax.named_scope`` in the
    engine (``stream``, ``rare_stage``) attributes it to a phase."""
    from jax.profiler import ProfileData

    files = glob.glob(f"{tdir}/**/*.xplane.pb", recursive=True)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {tdir}")
    pd = ProfileData.from_file(sorted(files)[-1])
    by_op = defaultdict(float)
    cnt = defaultdict(int)
    by_scope = defaultdict(float)
    busy = 0.0
    lo, hi = None, None
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                dur = ev.duration_ns
                by_op[ev.name] += dur
                cnt[ev.name] += 1
                busy += dur
                lo = ev.start_ns if lo is None else min(lo, ev.start_ns)
                hi = max(hi or 0.0, ev.start_ns + dur)
                path = dict(ev.stats).get("name", "")
                hit = [sc for sc in scopes if f"/{sc}/" in f"/{path}/"]
                by_scope[hit[0] if hit else "other"] += dur
    if lo is None:
        raise RuntimeError(f"no GPU device events in {files[-1]}")
    span = hi - lo
    print(f"\ndevice busy {busy/1e6:.3f} ms over {span/1e6:.3f} ms "
          f"(idle share {1.0 - busy/span:.3f}); by scope:")
    for sc, ns in sorted(by_scope.items(), key=lambda kv: -kv[1]):
        print(f"  {ns/1e6:9.3f} ms  {sc}")
    print("by kernel:")
    for name, ns in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ns/1e6:9.3f} ms  x{cnt[name]:<5d} {name[:110]}")
    return {
        "busy_ms": busy / 1e6, "span_ms": span / 1e6,
        "ops": {k: v / 1e6 for k, v in by_op.items()},
        "scopes": {k: v / 1e6 for k, v in by_scope.items()},
    }


def main():
    import jax

    from cudaparticlesfoam_tpu import StepConfig, run_cycles

    n_side = int(sys.argv[1]) if len(sys.argv) > 1 else 55
    n_particles = int(float(sys.argv[2])) if len(sys.argv) > 2 else 1_000_000
    n_cycles = int(sys.argv[3]) if len(sys.argv) > 3 else 20
    frac = float(sys.argv[4]) if len(sys.argv) > 4 else 0.125
    rng = sys.argv[5] if len(sys.argv) > 5 else "threefry"
    dt = float(sys.argv[6]) if len(sys.argv) > 6 else 0.05

    t0 = time.perf_counter()
    mesh, st = build(n_side, n_particles)
    print(f"build {time.perf_counter()-t0:.1f}s; {mesh.n_tets} tets", file=sys.stderr)
    cfg = StepConfig(dt=dt, diffusion_coeff=1e-3, walk_capacity_frac=frac,
                     brownian_rng=rng)
    if len(sys.argv) > 7:
        import dataclasses

        if sys.argv[7] == "auto":
            from cudaparticlesfoam_tpu.stepper import suggest_tuning
            cfg = suggest_tuning(mesh, cfg, dt, n_particles=n_particles)
        elif "=" not in sys.argv[7]:
            cfg = dataclasses.replace(cfg, inline_hops=int(sys.argv[7]))
        for kv in sys.argv[7:]:
            if "=" not in kv:
                continue
            k, v = kv.split("=", 1)
            cur = getattr(cfg, k)
            if isinstance(cur, bool):
                v = v.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                v = int(v)
            elif isinstance(cur, float):
                v = float(v)
            cfg = dataclasses.replace(cfg, **{k: v})
    if cfg.locate_mode == "convex" and mesh.tet_row_cx is None:
        from cudaparticlesfoam_tpu.mesh import with_convex_rows

        mesh = with_convex_rows(mesh)
    print("cfg:", cfg.inline_hops, "hops, frac", cfg.walk_capacity_frac,
          file=sys.stderr)

    t0 = time.perf_counter()
    st2 = run_cycles(mesh, st, cfg, n_cycles)
    jax.block_until_ready(st2.pos)
    print(f"compile+run {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    tdir = tempfile.mkdtemp(prefix="jxtrace_")
    jax.profiler.start_trace(tdir)
    t0 = time.perf_counter()
    st2 = run_cycles(mesh, st2, cfg, n_cycles)
    jax.block_until_ready(st2.pos)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    print(f"timed run: {wall*1e3:.0f} ms wall for {n_cycles} cycles "
          f"({n_particles*n_cycles/wall/1e6:.1f}M steps/s)", file=sys.stderr)
    parse_trace(tdir)


if __name__ == "__main__":
    main()
