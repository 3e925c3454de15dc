"""sage2_tpu_torch.ops.bitpack and the overlap seed keys against
sage2_tpu (CPU; exact equality)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.ops import bitpack as jbp
from sage2_tpu.overlap.detect import seed_keys_at_positions
from sage2_tpu_torch.ops import bitpack as tbp
from sage2_tpu_torch.overlap.detect import seed_keys
from torch_one_thread import one_thread  # noqa: F401


def _reads(rng, n=300, L=70):
    return rng.integers(0, 4, size=(n, L)).astype(np.int32)


def _joined(hi, lo, k):
    """The reference's (hi, lo) pair as the port's int64 key."""
    v = (np.asarray(hi).astype(np.uint64) << np.uint64(32)
         | np.asarray(lo).astype(np.uint64)) if k > 16 else (
        np.asarray(lo).astype(np.uint64))
    if k == 32:
        v = v ^ np.uint64(1 << 63)
    return v.view(np.int64)


@pytest.mark.parametrize("k", [15, 25, 31, 32])
def test_kmer_keys_match_reference(rng, k):
    reads = _reads(rng)
    r = jnp.asarray(reads)
    fwd, rc, canon = tbp.kmer_keys(torch.from_numpy(reads), k)
    for (hi, lo), got in [(jbp.kmer_keys(r, k), fwd),
                          (jbp.revcomp_kmer_keys(r, k), rc),
                          (jbp.canonical_kmer_keys(r, k), canon)]:
        np.testing.assert_array_equal(_joined(hi, lo, k), got.numpy())


@pytest.mark.parametrize("k", [25, 31])
def test_key_order_is_reference_lex_order(rng, k):
    reads = _reads(rng, n=50)
    hi, lo = jbp.canonical_kmer_keys(jnp.asarray(reads), k)
    _, _, canon = tbp.kmer_keys(torch.from_numpy(reads), k)
    ref = np.lexsort((np.asarray(lo).reshape(-1), np.asarray(hi).reshape(-1)))
    got = torch.sort(canon.reshape(-1), stable=True).indices.numpy()
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("s", [12, 20, 32])
def test_seed_keys_and_sign_flip_order(rng, s):
    reads = _reads(rng, n=400, L=60)
    reads[:5] = 3                      # all-T seeds: the all-ones key
    reads[5:10] = 0
    positions = [0, 3, 8, 16, 17, 28]
    shifted = jbp.shifted_word_packs(jnp.asarray(reads))
    hi, lo = seed_keys_at_positions(shifted, s, positions, 60)
    words0 = tbp.pack_read_words(torch.from_numpy(reads))
    got = torch.stack([seed_keys(words0, s, p) for p in positions], 1)
    np.testing.assert_array_equal(_joined(hi, lo, 32), got.numpy())
    # signed int64 order == unsigned (hi, lo) order, sentinel last
    ref = np.lexsort((np.asarray(lo).reshape(-1), np.asarray(hi).reshape(-1)))
    order = torch.sort(got.reshape(-1), stable=True).indices.numpy()
    np.testing.assert_array_equal(ref, order)
    if s == 32:
        assert int(got[0, 0]) == np.iinfo(np.int64).max


def test_pack_and_word_at_match_shifted_packs(rng):
    reads = _reads(rng, n=40, L=75)
    shifted = np.asarray(jbp.shifted_word_packs(jnp.asarray(reads)))
    words0 = tbp.pack_read_words(torch.from_numpy(reads))
    np.testing.assert_array_equal(
        np.asarray(jbp.pack_read_words(jnp.asarray(reads))), words0.numpy())
    for q in range(0, 80):
        want = (shifted[:, q % 16, q // 16] if q // 16 < shifted.shape[2]
                else np.zeros(40, np.uint32))
        np.testing.assert_array_equal(want, tbp.word_at(words0, q).numpy())
    np.testing.assert_array_equal(
        tbp.unpack_read_words(words0.numpy(), 75), reads)


def test_revcomp_and_ascii_helpers(rng):
    reads = _reads(rng, n=5, L=33)
    np.testing.assert_array_equal(
        np.asarray(jbp.revcomp_codes(jnp.asarray(reads))),
        tbp.revcomp_codes(torch.from_numpy(reads)).numpy())
    s = "ACGTNacgt"
    np.testing.assert_array_equal(jbp.str_to_codes(s), tbp.str_to_codes(s))
    assert tbp.codes_to_str(tbp.str_to_codes("ACGT")) == "ACGT"
