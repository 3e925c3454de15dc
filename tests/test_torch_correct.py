"""sage2_tpu_torch two-phase correction against sage2_tpu (CPU;
byte-equal reads)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.kmer.correct import correct_reads_twophase as jcorrect
from sage2_tpu.kmer.count import count_kmers as jcount
from sage2_tpu_torch.kmer.correct import correct_reads_twophase as tcorrect
from sage2_tpu_torch.kmer.count import count_kmers as tcount
from torch_one_thread import one_thread  # noqa: F401


@pytest.mark.parametrize("k,err,seed", [(25, 0.01, 11), (21, 0.02, 12)])
def test_twophase_two_rounds_byte_equal(k, err, seed):
    g = simulate_genome(6000, seed=seed)
    reads, _ = simulate_reads(g, read_len=90, coverage=25, error_rate=err,
                              seed=seed + 100)
    r = reads.astype(np.int32)
    want = np.asarray(jcorrect(jnp.asarray(r), k, 2, 2,
                               table=jcount(jnp.asarray(r), k)))
    got = tcorrect(torch.from_numpy(r), k, 2, 2,
                   table=tcount(torch.from_numpy(r), k)).numpy()
    assert (want != r).sum() > 0          # the input had errors to fix
    np.testing.assert_array_equal(want, got)
