"""The port's benchmark: one run of one cell on the card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as the last line of standard output (one JSON
object) and the numbers that decide ``correct``, each beside its limit, as
the last lines of standard error. The cells are listed in ``BENCHMARK.json``
at the root of the checkout; see ``port_bench/core/registry.py`` for how a
cell's pieces are found. Exits non-zero, printing no result, without a CUDA
device or with fewer cards than the cell asks for.
"""

import os
import sys
import time

T_START = time.perf_counter()

_BENCH = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_BENCH)
# every build and kernel cache inside the checkout, at fixed paths (the
# program builds its CUDA kernels into build/kernels/ of the checkout)
_CACHE = os.path.join(_BENCH, ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "cuda")
# one process with few threads: the host side of a call is serial, and an
# idle pool of eight only competes with it for the machine's cores
os.environ["OMP_NUM_THREADS"] = "2"
os.environ["MKL_NUM_THREADS"] = "2"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, _ROOT)

from port_bench.core.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
