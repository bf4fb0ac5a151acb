"""Command-line entry points.

Replaces the reference's OpenFOAM executables and Allrun scripts:

    python -m cudaparticlesfoam_tpu uncoupled <case>   # cudaParticlesUncoupledFoam
    python -m cudaparticlesfoam_tpu replay <case>      # coupled particle replay
    python -m cudaparticlesfoam_tpu coupled <case>     # cudaParticlesPimpleFoam
    python -m cudaparticlesfoam_tpu blockmesh <case>   # blockMesh
    python -m cudaparticlesfoam_tpu simple <case>      # steady flow (simpleFoam)
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cudaparticlesfoam_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_case_cmd(name, help_):
        p = sub.add_parser(name, help=help_)
        p.add_argument("case", help="OpenFOAM-style case directory")
        p.add_argument("--out", default=None, help="output directory")
        p.add_argument("--no-write", action="store_true", help="skip VTU output")
        p.add_argument(
            "--f64", action="store_true", help="run in float64 (parity mode)"
        )
        return p

    p = add_case_cmd("uncoupled", "frozen-field particle tracking")
    p.add_argument("--profile", default=None, help="write a jax.profiler trace here")
    p.add_argument(
        "--devices", type=int, default=None,
        help="particle devices (default: all); >1 auto-selects DP vs "
             "spatially-partitioned by mesh size",
    )
    p.add_argument(
        "--strategy", default="auto",
        choices=("auto", "single", "dp", "partitioned"),
        help="multi-chip execution strategy override",
    )
    def add_particle_parallel(p):
        p.add_argument(
            "--devices", type=int, default=None,
            help="particle devices (default: all); >1 auto-selects DP vs "
                 "spatially-partitioned by mesh size",
        )
        p.add_argument(
            "--strategy", default="auto",
            choices=("auto", "single", "dp", "partitioned"),
            help="multi-chip particle strategy override",
        )

    p = add_case_cmd("replay", "particle tracking over recorded U snapshots")
    add_particle_parallel(p)
    p = add_case_cmd("coupled", "native PIMPLE flow + particle tracking")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument(
        "--flow-devices", type=int, default=None,
        help="domain-decompose the fluid solve over N devices "
             "(decomposePar/mpirun equivalent)",
    )
    add_particle_parallel(p)
    p = add_case_cmd("simple", "steady incompressible flow (SIMPLE)")
    p.add_argument("--iters", type=int, default=None)

    p = sub.add_parser("blockmesh", help="generate constant/polyMesh from blockMeshDict")
    p.add_argument("case")

    p = sub.add_parser(
        "dict", help="read/modify a dictionary entry (foamDictionary equivalent)"
    )
    p.add_argument("file")
    p.add_argument("-entry", required=True)
    p.add_argument("-set", dest="value", default=None)

    args = ap.parse_args(argv)

    if args.cmd == "dict":
        from .io import foamfile

        d = foamfile.read(args.file)
        obj = d.pop("FoamFile", {}).get("object") or os.path.basename(args.file)
        if args.value is None:
            print(d.get(args.entry))
            return 0
        try:
            val = float(args.value)
            val = int(val) if val.is_integer() and "." not in args.value else val
        except ValueError:
            val = args.value
        d[args.entry] = val
        foamfile.write(args.file, d, obj_name=str(obj))
        return 0

    if getattr(args, "f64", False):
        import jax

        jax.config.update("jax_enable_x64", True)

    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.cmd == "blockmesh":
        from .io import blockmesh, polymesh

        pm = blockmesh.generate(os.path.join(args.case, "system", "blockMeshDict"))
        out = os.path.join(args.case, "constant", "polyMesh")
        polymesh.write_polymesh(pm, out)
        print(f"wrote {pm.n_cells} cells to {out}")
        return 0

    dtype = None
    if args.cmd == "uncoupled":
        from .models import uncoupled

        uncoupled.run(
            args.case,
            out_dir=args.out,
            write_output=not args.no_write,
            dtype=dtype,
            profile_dir=args.profile,
            devices=args.devices,
            strategy=args.strategy,
        )
    elif args.cmd == "replay":
        from .models import coupled

        coupled.run_replay(
            args.case, out_dir=args.out, write_output=not args.no_write,
            dtype=dtype, devices=args.devices, strategy=args.strategy,
        )
    elif args.cmd == "coupled":
        from .models import coupled

        coupled.run_coupled(
            args.case,
            out_dir=args.out,
            write_output=not args.no_write,
            dtype=dtype,
            n_steps=args.steps,
            flow_devices=args.flow_devices,
            devices=args.devices,
            strategy=args.strategy,
        )
    elif args.cmd == "simple":
        from .models import simple

        simple.run(args.case, n_iters=args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
