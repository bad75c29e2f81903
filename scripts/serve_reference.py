#!/usr/bin/env python3
"""The JAX package's per-job results of the serving runs that
``chip_smoke.py`` holds the port's card runs to (``SERVE_REFERENCE``).

    JAX_PLATFORMS=cpu python scripts/serve_reference.py [--jobs 1024]
        [--nodes 32] [--trace-len 32] [--small-jobs 640]
        [--small-nodes 16] [--slots 256] [--chunk 32]

Runs the JAX package's ``serve.serve`` on the CPU over
``serve.mixed_jobs(jobs, nodes, trace_len)`` and over
``mixed_jobs(small_jobs, small_nodes, small_nodes)`` (``slots`` slots,
``chunk`` cycles a chunk, queue capacity 64, dumps written to a
temporary ``--out-dir``) and prints one JSON line: for each job shape
``"NxT"``, the first ``--hex`` hex digits of every job's
``serve.job_digest`` (sha256 of its dumps and metrics doc), in job
order, joined. A job's result does not depend on its slot or its wave,
so the same digits hold the daemon's results of jobs of that spec.
About 5 min at the defaults on one CPU core.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

# run as a file from anywhere: the packages sit at the repo root
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def digests(jobs: int, nodes: int, trace_len: int, slots: int,
            chunk: int) -> list:
    """Full job digests of the JAX serve run of the mix."""
    from ue22cs343bb1_openmp_assignment_tpu import serve
    from ue22cs343bb1_openmp_assignment_tpu_torch.serve import (
        job_digest, read_job_dumps)
    specs = serve.mixed_jobs(jobs, nodes=nodes, trace_len=trace_len)
    with tempfile.TemporaryDirectory() as tmp:
        doc = serve.serve(specs, slots=min(slots, jobs), chunk=chunk,
                          queue_capacity=64, out_dir=tmp)
        if doc["jobs_quiesced"] != jobs:
            raise SystemExit(f"{doc['jobs_total'] - doc['jobs_quiesced']} "
                             f"job(s) did not quiesce")
        return [job_digest(read_job_dumps(pathlib.Path(tmp) / s.name,
                                          nodes),
                           doc["jobs"][s.name]["metrics"])
                for s in specs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=1024)
    ap.add_argument("--nodes", type=int, default=32)
    ap.add_argument("--trace-len", type=int, default=32)
    ap.add_argument("--small-jobs", type=int, default=640)
    ap.add_argument("--small-nodes", type=int, default=16)
    ap.add_argument("--slots", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--hex", type=int, default=12)
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = {}
    for jobs, n, t in ((args.jobs, args.nodes, args.trace_len),
                       (args.small_jobs, args.small_nodes,
                        args.small_nodes)):
        if jobs:
            out[f"{n}x{t}"] = "".join(
                d[:args.hex] for d in digests(jobs, n, t, args.slots,
                                              args.chunk))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
