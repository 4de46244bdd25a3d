"""What each command of the benchmark does before it imports torch.

``run.py``, ``calibrate.py`` and ``sweep.py`` put the checkout's root first
on ``sys.path`` (in place of their own folder, whose module names would
shadow top-level ones such as ``trace``), import this module and call
:func:`prepare`: every build and kernel cache then lives at a fixed path
inside the checkout, and the port's package ``src/repro_torch`` imports.
"""

import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / "essbench" / ".cache"


def prepare() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    if str(REPO / "src") not in sys.path:
        sys.path.insert(1, str(REPO / "src"))
