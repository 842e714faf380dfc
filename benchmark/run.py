"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads and warms up the cell (set-up), measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints
one JSON object as the last line of standard output (BENCHMARK.json
names the cells and metrics).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# no library the program uses may load JAX behind its back
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
# kernel caches at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, ".bench_cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, ".bench_cache", "torch_extensions"))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchmark.core.harness import main
    sys.exit(main(sys.argv[1:], ROOT, T_START))
