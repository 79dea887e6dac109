"""Run one cell of the benchmark of pysdr_tpu_torch once, from the root of
a checkout:

    python3 sdrbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

It needs a CUDA device (it exits with code 3 and no result without one).
The last line of its output is the run's JSON result; see harness.py.
"""

import os
import sys
import time

T_START = time.perf_counter()
_HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(_HERE)
# the checkout's root, not this directory, heads the import path
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The program runs with one OpenMP and one MKL thread. With PyTorch's
# default, a pool of one thread a core, the pool spins between the
# executive's small host copies (50-67 ms of CPU a 21 ms block on an
# H100's 8-core host) and a live block's latency swings with it. Set
# before numpy and torch are imported, which read it once.
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

from sdrbench import harness  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(harness.main(sys.argv[1:], t_start=T_START))
