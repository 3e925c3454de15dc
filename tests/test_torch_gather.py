"""P1 ``kernels.gather_along`` (the Pallas probe's take_along_axis
kernel, scripts/probe_pallas_gather.py) through its plain version on the
CPU, against np.take_along_axis (the probe's reference) and
jnp.take_along_axis (the body of its Pallas kernels); exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu_torch import kernels
from torch_one_thread import one_thread  # noqa: F401


@pytest.mark.parametrize("N,W,axis", [(8, 128, 0), (1024, 128, 0),
                                      (1024, 8, 0), (8, 2048, 1),
                                      (256, 512, 1), (3, 5, 1)])
def test_gather_along_matches_take_along_axis(N, W, axis):
    rng = np.random.default_rng(N * W + axis)
    tbl = np.arange(N * W, dtype=np.int32).reshape(N, W)
    idx = rng.integers(0, N if axis == 0 else W, (N, W)).astype(np.int32)
    kernels.reset_launch_counts()
    got = kernels.gather_along(torch.from_numpy(tbl), torch.from_numpy(idx),
                               axis).numpy()
    assert kernels.LAUNCHES["gather_along"] == 0     # plain version on CPU
    np.testing.assert_array_equal(got, np.take_along_axis(tbl, idx, axis))
    np.testing.assert_array_equal(
        got, np.asarray(jnp.take_along_axis(jnp.asarray(tbl),
                                            jnp.asarray(idx), axis=axis)))


def test_gather_along_refuses_bad_arguments():
    t = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="axis"):
        kernels.gather_along(t, t, 2)
    with pytest.raises(ValueError, match="shape"):
        kernels.gather_along(t, t[:2], 0)


@pytest.mark.parametrize("axis", [0, 1])
def test_gather_along_raises_out_of_range(axis):
    """An index at the extent of its axis raises IndexError (the plain
    version here; the kernel's flag on the card)."""
    tbl = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    idx = torch.zeros((3, 4), dtype=torch.int32)
    idx[1, 2] = tbl.shape[axis]
    with pytest.raises(IndexError):
        kernels.gather_along(tbl, idx, axis)
