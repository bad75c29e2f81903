#!/usr/bin/env python3
"""The final states of the port's plain sync rounds at the sync bench
defaults, as the numbers ``chip_smoke.py`` holds the fused rounds'
runs to quiescence to (``SYNC_REFERENCE``).

    python3 scripts/sync_reference.py [--nodes 4096] [--trace-len 4096]
        [--chunk 64] [--device cuda]

For txn_width 3 (drain_depth 4) and txn_width 1 (drain_depth 16) it
runs ``TransactionalSystem.procedural`` through the plain rounds (no
kernel launched; ``pallas_burst`` off) with ``run(chunk=...)`` to
quiescence and prints one JSON line: for each width its rounds, retired
instructions and ``convert.leaves_digest`` of the final state's leaves.
The plain rounds are held to the JAX package's on the CPU by
tests/test_torch_system.py and tests/test_torch_sync_reference.py at
small copies of these configs; the digest is the same for a JAX and a
port state with equal leaves. About two minutes at the defaults on an
H100, where the fused rounds take under a second.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

# run as a file from anywhere: the packages sit at the repo root
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def reference(nodes: int, trace_len: int, chunk: int, txn_width: int,
              device: str) -> dict:
    """Rounds, retired instructions and the digest of one width's plain
    run to quiescence."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench, convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional \
        import TransactionalSystem
    cfg = bench.sync_config(nodes, txn_width, window_kernels=False)
    bench.reset_launch_counts()
    done = TransactionalSystem.procedural(cfg, trace_len,
                                          device=device).run(chunk=chunk)
    launched = {k: n for k, n in bench.launch_counts().items() if n}
    if not done.quiescent or launched:
        raise SystemExit(f"txn_width {txn_width}: quiescent "
                         f"{done.quiescent}, kernel launches {launched}")
    return {"rounds": done.metrics["rounds"],
            "instrs_retired": done.metrics["instrs_retired"],
            "digest": convert.leaves_digest(convert.to_numpy(done.state))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--trace-len", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps({
        "nodes": args.nodes, "trace_len": args.trace_len,
        "chunk": args.chunk,
        **{str(k): reference(args.nodes, args.trace_len, args.chunk, k,
                             args.device) for k in (3, 1)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
