"""Pin the port's tests to their share of the CPU.

Imported first by every ``tests/test_torch_*.py``. Under ``pytest -n W``
each of the W xdist workers would otherwise run torch's intra-op pool at
the machine's CPU count, W times over: six workers on 8 CPUs step a
256-body run hundreds of times slower than one. So each worker takes
``cpu_count // W`` threads (xdist sets ``PYTEST_XDIST_WORKER_COUNT`` in
its workers; a serial run keeps them all), and the processes the tests
start (the CLI, ``validate``, the streamed and sharded runs) inherit the
same count through ``OMP_NUM_THREADS``, unless the caller set it. The gloo
ranks of ``parallel.spawn_ring`` divide this process's count among
themselves.
"""

import os

THREADS = max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))

import torch  # noqa: E402  (after OMP_NUM_THREADS, which torch reads as it loads)

torch.set_num_threads(THREADS)
