"""The voting rule on the port's device mesh against the reference, on
the CPU, exactly: K5's routed mode (``vote_add`` chained over the k
window positions, then ``vote_apply``) against K5's fused round
(``plain.vote_windows``) and the reference's ``voting_round``; K22 at
every window position against ``set_base`` + ``canonicalize_pair``;
``sharded_correct_reads(rule="vote_all_windows")``, fixed-length and
ragged, on 1, 2 and 8 CPU shards against the reference's single-device
``correct_reads`` (and on 8 against its sharded function under
shard_map, tests/test_parallel.py:292); and a meshed voting ``assemble``,
fixed and ragged, on 2 shards against the reference's single-device
run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu import AssemblyConfig as RefConfig
from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.kmer import correct_reads
from sage2_tpu.kmer.correct import voting_round
from sage2_tpu.kmer.count import count_kmers, lookup_counts
from sage2_tpu.ops import bitpack
from sage2_tpu.parallel import make_mesh as ref_mesh
from sage2_tpu.parallel import sharded as ref_sharded
from sage2_tpu.pipeline import assemble as ref_assemble
from sage2_tpu_torch import AssemblyConfig
from sage2_tpu_torch.data import simulate_ragged_reads
from sage2_tpu_torch.kernels import plain
from sage2_tpu_torch.parallel import make_mesh, sharded_correct_reads
from sage2_tpu_torch.pipeline import assemble
from torch_one_thread import one_thread  # noqa: F401

K, THR, ROUNDS = 11, 3, 2


def _reads(ragged: bool, seed=311):
    """128 reads of an 800 bp genome with 2% errors: 40 bp, or ragged
    (28-40 bp with contained ones, zero-padded) with their lengths."""
    genome = simulate_genome(800, seed=seed)
    if ragged:
        reads, lens = simulate_ragged_reads(genome, 28, 40, 12.0, 0.02,
                                            seed=seed + 1,
                                            contained_frac=0.15)
        return reads[:128].astype(np.int32), lens[:128]
    reads, _ = simulate_reads(genome, read_len=40, coverage=6.4,
                              error_rate=0.02, seed=seed + 1)
    return reads[:128].astype(np.int32), None


@pytest.fixture(scope="module")
def corrected():
    """The reference's single-device voting correction of both inputs."""
    out = {}
    for ragged in (False, True):
        reads, lens = _reads(ragged)
        out[ragged] = np.asarray(correct_reads(
            jnp.asarray(reads), K, THR, ROUNDS,
            lengths=None if lens is None else jnp.asarray(lens),
            rule="vote_all_windows"))
        assert (out[ragged] != reads).any()
    return out


@pytest.mark.parametrize("ragged", [False, True])
def test_routed_vote_matches_voting_round(ragged):
    """vote_add over j = 0..k-1 with the table's counts of K22's keys,
    then vote_apply: K5's fused round and the reference's voting_round,
    bit for bit."""
    reads, lens = _reads(ragged, seed=331)
    jl = None if lens is None else jnp.asarray(lens)
    table = count_kmers(jnp.asarray(reads), K, jl)
    n = int(table.n_unique)
    keys = torch.from_numpy((np.asarray(table.hi[:n]).astype(np.int64) << 32)
                            | np.asarray(table.lo[:n]).astype(np.int64))
    counts = torch.from_numpy(np.asarray(table.count[:n]).astype(np.int32))
    want = np.asarray(voting_round(
        jnp.asarray(reads), lambda ch, cl: lookup_counts(table, ch, cl), K,
        THR, jl))
    r = torch.from_numpy(reads)
    tl = None if lens is None else torch.from_numpy(lens)
    votes = torch.zeros(r.shape + (4,), dtype=torch.uint8)
    for j in range(K):
        cnt = plain._count_of(keys, counts, plain.window_variants(r, K, j))
        assert plain.vote_add(votes, cnt, j, K, THR, tl) is votes
    assert int(votes.max()) <= K
    got = plain.vote_apply(r, votes)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        plain.vote_windows(r, keys, counts, K, THR, tl).numpy(), want)
    assert (want != reads).any()
    if lens is not None:
        past = np.arange(reads.shape[1])[None, :] >= lens[:, None]
        assert not votes.numpy()[past].any()    # vote_apply needs no mask
        assert (want[past] == reads[past]).all()


VOTE_EDGES = ("below_k", "exact_k", "full_L", "at_threshold")


@pytest.mark.parametrize("case", VOTE_EDGES)
def test_routed_vote_edge_cases(case):
    """vote_add chained over j, then vote_apply, against the reference's
    voting_round on the ragged input of the test above with the edges of
    vote_add's window mask: 16 reads shorter than k (lengths 1 to k - 1:
    no valid window), of exactly k bases (one window) or of the full L
    (every window), the bases past a length zeroed; or every count
    mapped to threshold or threshold - 1 (0 stays 0) on both sides, so
    that the solid test meets counts equal to the threshold."""
    reads, lens = _reads(True, seed=331)
    reads, lens = reads.copy(), lens.copy()
    L = reads.shape[1]
    edge = {"below_k": np.arange(16) % (K - 1) + 1,
            "exact_k": np.full(16, K), "full_L": np.full(16, L)}.get(case)
    if edge is not None:
        lens[:16] = edge
    reads[np.arange(L)[None, :] >= lens[:, None]] = 0
    jl = jnp.asarray(lens)
    table = count_kmers(jnp.asarray(reads), K, jl)

    def at_threshold(c):
        return c if case != "at_threshold" else (
            (c > 0) * (THR - c % 2))

    want = np.asarray(voting_round(
        jnp.asarray(reads),
        lambda ch, cl: at_threshold(lookup_counts(table, ch, cl)), K, THR,
        jl))
    n = int(table.n_unique)
    keys = torch.from_numpy((np.asarray(table.hi[:n]).astype(np.int64) << 32)
                            | np.asarray(table.lo[:n]).astype(np.int64))
    counts = torch.from_numpy(np.asarray(table.count[:n]).astype(np.int32))
    r, tl = torch.from_numpy(reads), torch.from_numpy(lens)
    votes = torch.zeros(r.shape + (4,), dtype=torch.uint8)
    at_thr = 0
    for j in range(K):
        cnt = at_threshold(plain._count_of(keys, counts,
                                           plain.window_variants(r, K, j)))
        at_thr += int((cnt == THR).sum())
        plain.vote_add(votes, cnt, j, K, THR, tl)
    np.testing.assert_array_equal(plain.vote_apply(r, votes).numpy(), want)
    assert (want != reads).any()
    v = votes.numpy()
    if case == "below_k":
        assert not v[:16].any()
    elif case == "exact_k":
        assert v[:16, :K].any() and not v[:16, K:].any()
    elif case == "full_L":
        assert v[:16, -1].any()
    else:
        assert at_thr > 0


@pytest.mark.parametrize("k", [11, 25])
def test_window_variants_every_position_matches_reference(k):
    rng = np.random.default_rng(k)
    reads = rng.integers(0, 4, size=(24, 40)).astype(np.int32)
    jr = jnp.asarray(reads)
    fh, fl = bitpack.kmer_keys(jr, k)
    rh, rl = bitpack.revcomp_kmer_keys(jr, k)
    P = reads.shape[1] - k + 1
    for j in range(k):
        cur = jr[..., j:j + P]
        want = []
        for b in range(4):
            bb = jnp.full(cur.shape, b, cur.dtype)
            vfh, vfl = bitpack.set_base(fh, fl, k, j, cur, bb)
            vrh, vrl = bitpack.set_base(rh, rl, k, k - 1 - j, 3 - cur,
                                        3 - bb)
            ch, cl = bitpack.canonicalize_pair(vfh, vfl, vrh, vrl)
            want.append((np.asarray(ch).astype(np.int64) << 32)
                        | np.asarray(cl).astype(np.int64))
        got = plain.window_variants(torch.from_numpy(reads), k, j)
        np.testing.assert_array_equal(got.numpy(), np.stack(want, -1))
    with pytest.raises(ValueError):
        plain.window_variants(torch.from_numpy(reads), k, k)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("nd", [1, 2, 8])
def test_sharded_voting_correct_matches_reference(corrected, nd, ragged):
    reads, lens = _reads(ragged)
    cap = 4 * reads.shape[0] * (reads.shape[1] - K + 1) // nd
    out, overflow = sharded_correct_reads(
        make_mesh(nd, devices="cpu"), reads, K, THR, ROUNDS, cap, cap,
        lengths=lens, rule="vote_all_windows")
    assert not overflow
    np.testing.assert_array_equal(out.numpy(), corrected[ragged])
    if nd == 8:
        ref, ovf = ref_sharded.sharded_correct_reads(
            ref_mesh(nd), jnp.asarray(reads), K, THR, ROUNDS, cap, cap,
            lengths=None if lens is None else jnp.asarray(lens),
            rule="vote_all_windows")
        assert not bool(ovf)
        np.testing.assert_array_equal(np.asarray(ref), corrected[ragged])
    # a query capacity below one owner's share overflows, as the
    # reference's does
    _, overflow = sharded_correct_reads(
        make_mesh(nd, devices="cpu"), reads, K, THR, 1, cap, 16,
        lengths=lens, rule="vote_all_windows")
    assert overflow


CFG = dict(k=15, min_overlap=25, min_contig_len=150,
           correction_rule="vote_all_windows")


@pytest.mark.parametrize("ragged", [False, True])
def test_meshed_voting_assembly_matches_single_device(ragged):
    genome = simulate_genome(2000, seed=351)
    if ragged:
        reads, lens = simulate_ragged_reads(genome, 40, 60, 12.0, 0.01,
                                            seed=352)
    else:
        reads, _ = simulate_reads(genome, read_len=50, coverage=12.5,
                                  error_rate=0.01, seed=352)
        lens = None
    if reads.shape[0] % 2 == 0:         # padded to the mesh
        reads = reads[:-1]
        lens = None if lens is None else lens[:-1]
    ref_contigs, ref_stats = ref_assemble(reads, RefConfig(**CFG),
                                          lengths=lens)
    contigs, stats = assemble(reads, AssemblyConfig(**CFG, mesh_shape=(2,)),
                              device="cpu", lengths=lens)
    assert stats == ref_stats
    assert len(contigs) == len(ref_contigs) >= 1
    for a, b in zip(contigs, ref_contigs):
        np.testing.assert_array_equal(a, b)
