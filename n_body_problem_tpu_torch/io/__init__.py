"""State I/O: checkpoints in the JAX package's ``.npz`` layout."""

from n_body_problem_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
