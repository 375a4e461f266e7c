"""Run one benchmark cell of the PyTorch port once and print its result.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the checkout's root. The last line of standard output is the
result object; the compared numbers and their limits are the last lines
of standard error. See README.md beside this file.
"""

import time

T_START = time.monotonic()  # set-up is timed from here

import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from pb import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], T_START))
