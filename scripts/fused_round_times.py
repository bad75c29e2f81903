"""Time the two fused sync round kernels of one source tree on the card.

    python scripts/fused_round_times.py TREE [--phases [--ensembles]]

TREE is the root of a checkout of the repository: this one, or a parent
commit unpacked beside it with ``git archive``, so that two trees can be
held against each other in one call, run in the order parent, change,
change, parent. By default it prints, three times for each kernel, the
median device time of 20 launches (torch.profiler) at sync@4096
(txn_width 3 / drain_depth 4, and txn_width 1 / drain_depth 16) on the
state 8 plain rounds in, with ptxas's registers and spills. With
``--phases`` it runs the tree's own ``chip_smoke.py`` phases of both
kernels instead (kernel against plain at three sizes, time, bound,
ptxas), and with ``--ensembles`` also the tree's ensemble phase. Needs a
CUDA card; the kernels are built from the tree's sources.
"""

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", help="root of a checkout of the repository")
    ap.add_argument("--phases", action="store_true",
                    help="run the tree's chip_smoke phases of both kernels")
    ap.add_argument("--ensembles", action="store_true",
                    help="with --phases, also the tree's ensemble phase")
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    if args.phases:
        rows = {"sync_round": cs.phase_sync_round_kernel(),
                "sync_multi_round": cs.phase_sync_multi_round_kernel()}
        if args.ensembles:
            cs.phase_ensembles(rows)
        print("ROWS " + json.dumps(rows))
        return 0
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_multi_round_kernel as smk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_round_kernel as srk)
    for name, mod, K in (("sync_multi_round", smk, 3),
                         ("sync_round", srk, 1)):
        cfg = cs.sync_cfg(4096, K)
        st = se.run_rounds(cfg, se.procedural_state(cfg, 4096,
                                                    device="cuda"),
                           8, fold_impl="plain")
        operands = mod.round_inputs(cfg, st)
        ms = [cs.kernel_ms(lambda: [mod.fused_round(*operands)
                                    for _ in range(20)], name + "_kernel")
              for _ in range(3)]
        print(args.tree, name, "ms", [f"{m:.5f}" for m in ms],
              mod.LIBRARY.ptxas_summary(cfg), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
