"""Run one cell of the port's benchmark once.

    python essbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA card(s) the cell
asks for.  The last line of standard output is the result (JSON); the
numbers the check compared, each beside its limit, are the last lines of
standard error.  Every cache lives at a fixed path inside the checkout:
the port's nvcc builds in ``src/repro_torch/kernels/build/``, anything else
under ``essbench/.cache/``.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from essbench import entry  # noqa: E402

entry.prepare()

from essbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
