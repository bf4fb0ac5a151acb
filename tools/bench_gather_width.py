"""Gather rate vs table size, engine-like conditions.

The headline cycle's inline hop is ONE full-batch [n]-index gather from
the [nt, 20] f32 walk table (80 MB at 1M tets).  Whether a narrower
table (one that fits the 50 MB L2) gathers faster per index is the
premise of a quantized-classify-table plan.  This tool measures that
under ENGINE-like conditions: the gather rides a
fori_loop over cycles with the table as a jit parameter, indices are a
mix of self-refetch + random-neighbor like the masked hop gather, and
the output feeds a cheap reduction carried to the next iteration (so the
loop is chained and nothing elides).

Usage: python tools/bench_gather_width.py [n_idx] [n_tets] [cycles]
Prints ns/idx for row widths 4..24 f32 cols (16..96 MB at 1M tets).
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def main():
    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else 1_000_000
    nt = int(float(sys.argv[2])) if len(sys.argv) > 2 else 1_000_000
    cycles = int(sys.argv[3]) if len(sys.argv) > 3 else 100

    rng = np.random.default_rng(0)
    # engine-like index stream: ~87% self-refetch (lane's own tet), ~13%
    # random neighbor
    base = rng.integers(0, nt, n, dtype=np.int32)
    base = jnp.asarray(base)

    for w in (4, 6, 8, 10, 12, 16, 20, 24):
        tab = jnp.asarray(rng.standard_normal((nt, w), dtype=np.float32))

        @jax.jit
        def run(tab, base, acc0):
            def body(i, acc):
                # perturb ~13% of indices per cycle, dependent on acc so
                # iterations chain
                salt = (acc.astype(jnp.int32) & 0x7FFF) + i
                idx = jnp.where(
                    (base + i) % 8 == 0, (base * 2654435761 + salt) % nt, base
                )
                rows = tab[idx]
                return acc + rows[:, 0].sum()

            return lax.fori_loop(0, cycles, body, acc0)

        out = run(tab, base, jnp.float32(0.0))
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = run(tab, base, jnp.float32(1.0))
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        ns = best / cycles / n * 1e9
        mb = nt * w * 4 / 1e6
        print(f"w={w:2d} ({mb:7.1f} MB): {ns:6.2f} ns/idx "
              f"({n / (best / cycles) / 1e6:7.1f}M idx/s)", flush=True)


if __name__ == "__main__":
    main()
