"""Run one benchmark cell of the PyTorch and CUDA port on the CUDA devices of
this machine:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the compared numbers with their limits
as the last lines of standard error and one JSON object as the last line of
standard output; exits non-zero, printing no result, without enough CUDA
devices or with JAX or the JAX package loaded. Build and kernel caches stay
under ``build/`` in the checkout.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
