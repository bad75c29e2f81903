#!/usr/bin/env python3
"""The JAX package's final state of the async main path, as the numbers
``chip_smoke.py`` holds the port's card runs to.

    JAX_PLATFORMS=cpu python scripts/async_reference.py [--nodes 4096]
        [--trace-len 512] [--chunk 64] [--queue-capacity 64]

Runs the JAX message-level engine (``ops.step.run_chunked_to_quiescence``)
on the CPU at the async bench config (scatter INV, locality 0.8) with the
``procedural_uniform`` stream, and prints one JSON line: cycles, retired
instructions, dropped messages, the nonzero invariant counts of both
tiers, and ``convert.leaves_digest`` of the final state's leaves in the
JAX dtypes. The procedural stream is a counter hash, so the card's run
of the port must reach the same digest. About 30 s at the defaults.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

# run as a file from anywhere: the packages sit at the repo root
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--trace-len", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--queue-capacity", type=int, default=64)
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from ue22cs343bb1_openmp_assignment_tpu.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu.ops import invariants, step
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    cfg = SystemConfig.scale(args.nodes, queue_capacity=args.queue_capacity,
                             max_instrs=args.trace_len,
                             proc_local_permille=800)
    sys_ = CoherenceSystem.from_workload(cfg, "procedural_uniform")
    final = step.run_chunked_to_quiescence(cfg, sys_.state, args.chunk,
                                           200 * args.trace_len)

    def nonzero(d):
        return {k: int(v) for k, v in d.items() if int(v)}

    print(json.dumps({
        "nodes": args.nodes, "trace_len": args.trace_len,
        "chunk": args.chunk, "queue_capacity": args.queue_capacity,
        "cycles": int(final.cycle),
        "instrs_retired": int(final.metrics.instrs_retired),
        "msgs_dropped": int(final.metrics.msgs_dropped),
        "step_violations": nonzero(invariants.step_violations(cfg, final)),
        "coherence": nonzero(invariants.quiescent_violations(cfg, final)),
        "digest": convert.leaves_digest(convert.sim_numpy_leaves(final)),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
