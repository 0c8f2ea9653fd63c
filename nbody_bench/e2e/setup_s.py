"""``setup_s``: seconds from the process's start to the end of the warm
call (imports, the inputs, the system under test with its planning, the
kernels' library, the CUDA graphs' capture and one call of the loop)."""


def read(run) -> float:
    return run.setup_s
