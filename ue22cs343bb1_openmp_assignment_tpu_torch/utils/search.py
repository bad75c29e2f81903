"""Schedule search: run many arbitration seeds at once, match goldens.

The port of the JAX package's ``utils/search.py``. The reference
validates its racy suites by re-running the binary until some accepted
interleaving happens to occur (``test3.sh:6-33``, ``test4.sh:6-32``:
sleep, kill, diff, repeat). Here the schedule is an explicit, seedable
parameter, so the search is a batched sweep: an ensemble of identical
machines that differ only in their arbitration seed
(``ops.sync_engine`` ensembles), and every replica's final dump compared
with the accepted ``run_*`` outcomes on the host.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Sequence

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
from ue22cs343bb1_openmp_assignment_tpu_torch.utils.golden import (
    format_node_dump, state_to_dumps)


def sweep_seeds(cfg: SystemConfig, sim_state, seeds: Sequence[int],
                chunk: int = 16, max_rounds: int = 50_000):
    """Run one transactional machine per seed from the pre-run SimState
    ``sim_state``; returns the [S, ...] ensemble's final state."""
    reps = [se.from_sim_state(cfg, sim_state, seed=int(s)) for s in seeds]
    ens = se.make_ensemble(reps)
    return se.run_ensemble_to_quiescence(cfg, ens, chunk, max_rounds)


def replica_dumps(cfg: SystemConfig, ens, r: int) -> List[str]:
    """Golden-format dumps of ensemble replica r."""
    rep = se.ensemble_replica(ens, r)
    return [format_node_dump(d)
            for d in state_to_dumps(cfg, se.to_dump_view(cfg, rep))]


def match_accepted(cfg: SystemConfig, sim_state,
                   accepted: Sequence[List[str]],
                   seeds: Sequence[int] = range(16),
                   chunk: int = 16,
                   max_rounds: int = 50_000) -> Dict[int, int]:
    """Map seed -> index of the accepted run its outcome reproduces.

    ``accepted``: one list of per-core dump strings per accepted run
    (as loaded from a racy suite's ``run_*/core_<n>_output.txt``). Seeds
    whose outcome matches no accepted run are left out: as in the
    reference harness, no match proves nothing by itself (the accepted
    sets are samples, not every outcome)."""
    ens = sweep_seeds(cfg, sim_state, seeds, chunk, max_rounds)
    out: Dict[int, int] = {}
    for r, seed in enumerate(seeds):
        dumps = replica_dumps(cfg, ens, r)
        for i, acc in enumerate(accepted):
            if dumps == list(acc):
                out[int(seed)] = i
                break
    return out


def load_accepted_named(suite_dir: str, num_cores: int = 4):
    """[(run_dir_name, per-core dumps)] for a racy suite's run_* dirs."""
    out = []
    for rd in sorted(glob.glob(f"{suite_dir}/run_*")):
        dumps = []
        for n in range(num_cores):
            with open(f"{rd}/core_{n}_output.txt") as f:
                dumps.append(f.read())
        out.append((os.path.basename(rd), dumps))
    return out


def load_accepted(suite_dir: str, num_cores: int = 4) -> List[List[str]]:
    """The accepted run_* dump sets of a racy suite."""
    return [dumps for _, dumps in load_accepted_named(suite_dir, num_cores)]
