#!/usr/bin/env python3
"""The benchmark of pygpa_tpu_torch: one run of one cell on CUDA cards.

    python3 gpabench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout that holds the program (pygpa_tpu_torch/)
and BENCHMARK.json. The cell, its configuration (gpabench/configs/), its
traffic mix (gpabench/traffic/), its limits (gpabench/limits/) and its
per-layer metrics' readers (gpabench/metrics/) are found by name. The run
makes its inputs on the card from the seed, warms up every shape it will
use (set-up), calls the program back to back for --seconds (each call
ending in a device synchronize), judges sampled calls' outputs against
the plain reference (gpabench/reference/), and prints one JSON object as
its last line: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics from a torch.profiler trace of the
window's last seconds and CUDA events of every call. Standard error ends
with each number compared beside its limit.

Exit codes: 2 unknown cell, 3 too few CUDA cards, 4 the process loaded
JAX or the JAX package; an error in the program raises (code 1). No
result is printed in any of these cases.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gpabench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
