"""`python -m ue22cs343bb1_openmp_assignment_tpu_torch.analysis` ==
`cache-sim-torch analyze`."""

import sys

from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.runner import main

if __name__ == "__main__":
    sys.exit(main())
