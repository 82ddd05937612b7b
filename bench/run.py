"""Run one benchmark cell once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout: set up, warm up the cell's shapes, measure
for ``--seconds``, judge what the timed path produced against the plain
reference, and print the result as the last line of standard output.
Every build and kernel cache stays under ``bench/_build/`` in the
checkout.
"""
import os
import pathlib
import sys
import time

STARTED = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent.parent
BUILD = ROOT / "bench" / "_build"
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
# the package is imported from the root; its files are not top-level names
sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
    p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT / "bench"]

if __name__ == "__main__":
    from bench import harness

    sys.exit(harness.main(ROOT, sys.argv[1:], STARTED))
