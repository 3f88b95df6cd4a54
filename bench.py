#!/usr/bin/env python
"""Benchmark entry: particle-substeps/s of the dam-break on one GPU.

Runs in one process and prints one JSON line per (backend, size) run; the
last line is the last run. Each line names the device (platform, kind,
count, card name and power limit). Exits non-zero unless JAX's first device
is a GPU: a CPU number is never reported as a benchmark result.

    python bench.py                              # default backend, 1,048,576
    python bench.py --neighbor gather,slotted,sites \\
        --particles 262144,1048576 --late-after 100 --trace-dir DIR
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def build_parser() -> argparse.ArgumentParser:
    from sphfluidsimulation_tpu.bench import BENCH_BACKENDS, DEFAULT_NEIGHBOR

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--neighbor", default=DEFAULT_NEIGHBOR,
                    help="comma-separated backends from "
                         f"{','.join(BENCH_BACKENDS)}")
    ap.add_argument("--particles", default="1048576",
                    help="comma-separated particle counts")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--late-after", type=int, default=100,
                    help="start of the late window (0 = spawn window only)")
    ap.add_argument("--site-bands", type=int, default=0,
                    help="sites backend z-bands (0 = auto)")
    ap.add_argument("--trace-dir", default=None,
                    help="trace one more window per run here and print "
                         "its per-phase device time")
    ap.add_argument("--out", default=None,
                    help="also append each JSON line to this file")
    return ap


def main(argv=None) -> int:
    from sphfluidsimulation_tpu.bench import BENCH_BACKENDS, run_bench

    ap = build_parser()
    a = ap.parse_args(argv)
    backends = a.neighbor.split(",")
    bad = [b for b in backends if b not in BENCH_BACKENDS]
    if bad:
        ap.error(f"unknown backend(s) {bad}; choose from {BENCH_BACKENDS}")

    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"bench.py needs a GPU; JAX's first device is {platform!r}",
              file=sys.stderr)
        return 1
    from sphfluidsimulation_tpu.utils.compcache import (
        enable_compilation_cache)
    enable_compilation_cache()

    for n in (int(x) for x in a.particles.split(",")):
        for nb in backends:
            trace_dir = (os.path.join(a.trace_dir, f"{nb}_{n}")
                         if a.trace_dir else None)
            res = run_bench(n_particles=n, frames=a.frames, neighbor=nb,
                            site_bands=a.site_bands,
                            late_after=a.late_after,
                            trace_dir=trace_dir)
            line = json.dumps(res)
            print(line, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
