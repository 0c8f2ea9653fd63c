"""The port's device order held to the JAX package's where it departs by
design: the same sequence of 30-bit Morton keys, and inside a run of equal
keys (a crowded key cell) the port's own order, by the fine key of
``utils.morton.morton_keys_wide``, where the JAX package keeps the order of
the last sort. Slot by slot, the two bodies then share a 30-bit key: the
same body wherever that key is unique, the same bodies within a tie."""

import jax.numpy as jnp
import numpy as np

from n_body_problem_tpu.utils import morton as jm
from n_body_problem_tpu_torch.utils import morton as tm


def keys(pos: np.ndarray, n_real: int) -> np.ndarray:
    """The JAX package's 30-bit keys of the real rows of ``pos`` (N, 3)."""
    cols = (jnp.asarray(np.ascontiguousarray(pos[:, i])) for i in range(3))
    return np.asarray(jm.morton_keys_cols(*cols, n_real))[:n_real]


def assert_jax_order_but_ties(order, jax_order, keys_by_id: np.ndarray) -> None:
    """``order`` and ``jax_order`` (input ids slot by slot) hold the same
    30-bit key in every slot, and the same ids."""
    order, jax_order = np.asarray(order), np.asarray(jax_order)
    np.testing.assert_array_equal(keys_by_id[order], keys_by_id[jax_order])
    np.testing.assert_array_equal(np.sort(order), np.sort(jax_order))


def last_resort(sim) -> tuple[np.ndarray, np.ndarray]:
    """Of a port ``Simulation`` stopped where its next call's first chunk
    resorts: ``(keys_by_id, order)``, the 30-bit keys of its real bodies by
    input index, and the ``sort_perm`` that the resort gives (its wide keys'
    order)."""
    s = sim.state
    k = s.n_real
    pos = s.pos.numpy()
    by_id = np.empty(k, np.int64)
    by_id[sim.sort_perm] = keys(pos, k)
    perm = tm.morton_order(*s.pos.unbind(1), k)[:k].numpy()
    return by_id, np.asarray(sim.sort_perm)[perm]
