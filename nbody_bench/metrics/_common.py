"""What several per-layer readers share: kernel names and per-step sums."""

# The program's treecode kernels (``csrc/*.cu``), as ``treecode_profile._KERNELS``
# of ``n_body_problem_tpu_torch`` at commit c8a9ef2832dd3ca6223213d0b57046ed74f6d186
# matches them by name.
TREE_KERNELS = ("near_field_kernel", "far_field_kernel", "vip_both_kernel", "vip_sum_kernel",
                "far_single_kernel", "gather_panels_kernel", "near_panel_kernel")
REBUILD_LABELS = ("treecode.resort", "treecode.build")


def is_tree(run) -> bool:
    return run.cell.traffic["solver"] == "treecode"


def kernels(trace, names):
    """Device kernels whose name holds one of ``names``."""
    return [o for o in trace.device if o[3] == "kernel" and any(k in o[2] for k in names)]


def step_kernels(trace):
    """Device kernels launched outside the rebuild labels."""
    return [o for o in trace.device if o[3] == "kernel" and o[4] not in REBUILD_LABELS]
