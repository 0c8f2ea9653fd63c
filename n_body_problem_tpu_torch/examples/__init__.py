"""The JAX package's four examples (``examples/*.py``), on the port.

Each is a module with ``main(argv=None)`` whose defaults are the JAX
example's own values, run with ``python -m``:

    python -m n_body_problem_tpu_torch.examples.quickstart
    python -m n_body_problem_tpu_torch.examples.galaxy_collision_movie [out_dir]
    python -m n_body_problem_tpu_torch.examples.multichip_ring [--devices D]
    python -m n_body_problem_tpu_torch.examples.treecode_large_n --n 262144 --steps 64

Each runs on ``--device cuda`` unless ``--device cpu`` is given.
"""
