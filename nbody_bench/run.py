"""The benchmark's command: one run of one cell.

    python3 -m nbody_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``,
``nbody_bench/`` and the program, ``n_body_problem_tpu_torch/``. Prints one
JSON line last on standard output (``harness.run_cell``); exits with 2 and
prints no result without as many CUDA devices as the cell asks for, and with
3 when a module of JAX or of the JAX package was loaded.
"""

import pathlib
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (Linux), else now."""
    now = time.perf_counter()
    try:
        import os

        ticks = os.sysconf("SC_CLK_TCK")
        start = int(pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return now - max(0.0, uptime - start / ticks)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

if __name__ == "__main__":
    import sys

    from nbody_bench.harness import main

    sys.exit(main(t_start=T_START))
