"""Run one benchmark cell once and print its result as the last line.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout that holds BENCHMARK.json.  The import
guard goes in before anything else is loaded; see harness.py for the run.
"""
import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import guard  # noqa: E402

guard.install()

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T0))
