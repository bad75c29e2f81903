"""The analysis gate, ported from the JAX package: its protocol half

* :mod:`.model_check`: the small-scope explicit-state model checker,
  with ``ops/step.cycle`` under ``torch.func.vmap`` as its transition
  oracle (on the card unless ``device="cpu"``), symmetry reduction and
  SCC-based livelock detection;
* :mod:`.protocol_table`: the declarative MESI/MOESI/MESIF tables and
  their compiler to a torch ``message_phase``; :mod:`.verify_table` their
  static passes; :mod:`.conformance` the table-vs-handlers gate;
* :mod:`.litmus`: the memory-consistency litmus suite, enumerated by the
  model checker;
* :mod:`.lint_trace`: the AST linter of the port's device code;
* :mod:`.mutations`: the seeded bugs every gate must catch;
  :mod:`.runner`: the ``analyze`` verb;

and its fuzzing half:

* :mod:`.fuzz`: the coverage-guided differential fuzzer (async engine on
  the card unless ``device="cpu"``, the native C++ oracle on the host,
  the sync engine on node-local cases), the counterpart of the JAX
  package's ``analysis/fuzz.py``;
* :mod:`.axioms`: the po/rf/co/fr checker over a run's message ledger;
* :mod:`.shrink`: ddmin of a finding (instructions) or of a recording
  (jobs), the counterpart of the JAX package's ``analysis/shrink.py``;
* :mod:`.fixtures`: the ``cache-sim/repro/v1`` fixture format.

and its static walkers, the counterparts of the JAX package's jaxpr
walkers:

* :mod:`.lint_aten`: the IR lint over the aten op stream a hot path
  dispatches and the replay guard (JAX ``lint_jaxpr``);
* :mod:`.indexcheck`: the index-pressure auditor (aten index sites);
* :mod:`.kernelcheck`: the CUDA kernels' contracts (packed-word bit
  budgets, shared memory, ptxas resources, residency, the gate).
"""

from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.model_check import (  # noqa: F401
    ModelChecker, Scope, builtin_scopes, check_scope)
