"""The benchmark of ``n_body_problem_tpu_torch`` on one NVIDIA card:
``python3 -m nbody_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout (``harness``, ``spec``)."""
