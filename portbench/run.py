#!/usr/bin/env python3
"""The benchmark of coolchic_tpu_torch on one NVIDIA card: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics and a breakdown), device, and the compared
numbers with their limits under "checks". Exits non-zero, printing no
result, without a CUDA card, outside a checkout of the repo, or when JAX
or the JAX package was loaded.
"""

import os
import sys
from pathlib import Path

# The deployment the cells stand for runs one host OpenMP thread per
# process, set before any library starts its pool: the load is one process
# with a fixed, small host thread pool (at each library's default width a
# hop decode call took twice as long and spread far more from run to run).
os.environ["OMP_NUM_THREADS"] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main())
