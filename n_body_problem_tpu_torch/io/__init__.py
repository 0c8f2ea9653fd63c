"""State I/O: the reference's dataset formats, the dataset registry,
checkpoints in the JAX package's ``.npz`` layout, and the converter.

Counterpart of ``n_body_problem_tpu.io``, exporting the same names."""

from n_body_problem_tpu_torch.io.tipsy import read_tipsy, write_tipsy
from n_body_problem_tpu_torch.io.text import (
    read_tab,
    read_dat,
    read_snap,
    read_csv,
    write_tab,
    write_snap,
)
from n_body_problem_tpu_torch.io.datasets import DATASETS, DatasetSpec, load_dataset
from n_body_problem_tpu_torch.io.checkpoint import save_checkpoint, load_checkpoint
from n_body_problem_tpu_torch.io.convert import tipsy_to_csv

__all__ = [
    "read_tipsy",
    "write_tipsy",
    "read_tab",
    "read_dat",
    "read_snap",
    "read_csv",
    "write_tab",
    "write_snap",
    "DATASETS",
    "DatasetSpec",
    "load_dataset",
    "save_checkpoint",
    "load_checkpoint",
    "tipsy_to_csv",
]
