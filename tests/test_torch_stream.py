"""sage2_tpu_torch.stream and the plain versions of its kernels (K9
seed_table, K10 probe_join, K11 merge_runs) against sage2_tpu, on the
CPU with exact equality; and the port's watchdog.

Where the reference's streamed function is slow on CPU JAX (its chunk
merges run op by op and compile anew for every table size: 38 s for the
chunk-7 count alone), the port's streamed result is held to the
reference's in-core one, which the reference proves equal to its
streamed one (tests/test_stream.py). The reference's streamed pipeline
itself is run in tests/test_torch_spill.py.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu import stream as jstream
from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.kmer import correct_reads as jcorrect
from sage2_tpu.kmer import count_kmers as jcount
from sage2_tpu.kmer.count import count_from_keys as jcount_from_keys
from sage2_tpu.ops import bitpack as jbitpack
from sage2_tpu.ops.sort import expand_with_payload as jexpand
from sage2_tpu.ops.sort import sort_by_keys as jsort
from sage2_tpu.overlap import detect as jdetect
from sage2_tpu.overlap import find_overlaps as jfind
from sage2_tpu.overlap import prepare_reads as jprepare
from sage2_tpu_torch import stream as tstream
from sage2_tpu_torch.kernels import plain
from sage2_tpu_torch.kmer import count_kmers as tcount
from sage2_tpu_torch.kmer.count import KmerTable
from sage2_tpu_torch.ops import bitpack as tbitpack
from sage2_tpu_torch.overlap import detect as tdetect
from torch_one_thread import one_thread  # noqa: F401

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reads(n_genome, read_len, cov, err, seed):
    g = simulate_genome(n_genome, seed=seed)
    r, _ = simulate_reads(g, read_len=read_len, coverage=cov,
                          error_rate=err, seed=seed + 1)
    return r


def _ref_keys(t, n):
    return (np.asarray(t.hi)[:n].astype(np.int64) << 32) | np.asarray(
        t.lo)[:n].astype(np.int64)


# --- count, K11 ---------------------------------------------------------

@pytest.fixture(scope="module")
def count_reads():
    return _reads(1000, 40, 12, 0.01, 401).astype(np.int32)


@pytest.fixture(scope="module")
def ref_table(count_reads):
    t = jcount(jnp.asarray(count_reads), 15)
    n = int(t.n_unique)
    return _ref_keys(t, n), np.asarray(t.count)[:n]


@pytest.mark.parametrize("chunk", [7, 64, 1000])
def test_count_kmers_chunked_matches_reference(count_reads, ref_table,
                                               chunk):
    t = tstream.count_kmers_chunked(count_reads, 15, chunk, device=CPU)
    keys, counts = ref_table
    assert t.n_unique == keys.shape[0]
    np.testing.assert_array_equal(t.keys.numpy(), keys)
    np.testing.assert_array_equal(t.count.numpy(), counts)
    incore = tcount(torch.from_numpy(count_reads), 15)
    assert torch.equal(incore.keys, t.keys)
    assert torch.equal(incore.count, t.count)


def test_merge_runs_plain_matches_count_from_keys_and_merge_tables():
    """K11's plain version against the run accounting it replaces: the
    reference's count_from_keys (unit weights) and _merge_tables (summed
    counts), on keys with long runs and both halves of a key."""
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 6, 3000).astype(np.uint32)
    lo = rng.integers(0, 40, 3000).astype(np.uint32)
    valid = rng.random(3000) < 0.9
    keys = (hi.astype(np.int64) << 32) | lo
    parts = []
    for sl in (slice(0, 1500), slice(1500, 3000)):
        ref = jcount_from_keys(jnp.asarray(hi[sl]), jnp.asarray(lo[sl]), 31,
                               valid=jnp.asarray(valid[sl]))
        n = int(ref.n_unique)
        s = torch.sort(torch.from_numpy(keys[sl][valid[sl]])).values
        got_keys, got_counts = plain.merge_runs(s)
        np.testing.assert_array_equal(got_keys.numpy(), _ref_keys(ref, n))
        np.testing.assert_array_equal(got_counts.numpy(),
                                      np.asarray(ref.count)[:n])
        parts.append((ref, KmerTable(got_keys, got_counts, n, 31)))
    ref = jstream._merge_tables([p[0] for p in parts], 31)
    got = tstream._merge_tables([p[1] for p in parts], 31)
    n = int(ref.n_unique)
    assert got.n_unique == n
    np.testing.assert_array_equal(got.keys.numpy(), _ref_keys(ref, n))
    np.testing.assert_array_equal(got.count.numpy(),
                                  np.asarray(ref.count)[:n])
    assert plain.merge_runs(s[:0])[0].shape == (0,)


# --- correct, dedup -----------------------------------------------------

@pytest.fixture(scope="module")
def correct_reads():
    return _reads(800, 36, 20, 0.02, 411).astype(np.int32)


@pytest.mark.parametrize("rule", ["single_window", "vote_all_windows"])
def test_correct_reads_chunked_matches_reference(correct_reads, rule):
    ref = np.asarray(jcorrect(jnp.asarray(correct_reads), 11, 3, 2,
                              rule=rule), dtype=np.int8)
    got = tstream.correct_reads_chunked(correct_reads, 11, 3, 2, 64,
                                        rule=rule, device=CPU)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, ref)
    assert (got != correct_reads).any()


@pytest.fixture(scope="module")
def dedup():
    """reads (with exact and reverse-complement duplicates) and the
    reference's streamed dedup of them."""
    r = _reads(700, 60, 12, 0.005, 421).astype(np.int8)
    r = np.concatenate([r, r[:9], (3 - r[5:12])[:, ::-1]])
    return r, jstream.prepare_reads_chunked(r, 37)


def test_prepare_reads_chunked_matches_reference(dedup):
    reads, ref = dedup
    got = tstream.prepare_reads_chunked(reads, 37, device=CPU)
    assert got[3] == ref[3] and got[5] is None and ref[5] is None
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(got[i], ref[i])
        assert got[i].dtype == ref[i].dtype
    incore = jprepare(jnp.asarray(reads.astype(np.int32)))
    np.testing.assert_array_equal(got[2], np.asarray(incore.multiplicity))


# --- the streamed join: plain K9 and K10, the chunked join --------------

GEO = dict(L=60, min_overlap=40, s=32, g=8, pa=20)


def _ref_entry_side(reads2, valid2, b0, nb, B):
    """sage2_tpu/stream.py:375-397 for the block [b0, b0 + nb)."""
    g, s, L = GEO["g"], GEO["s"], GEO["L"]
    blk = jnp.asarray(reads2[b0 : b0 + nb].astype(np.int32))
    words0b = jbitpack.pack_read_words(blk)
    b_hi, _ = jdetect.seed_keys_from_words0(words0b, s, list(range(g)), L)
    ev = jnp.repeat(jnp.asarray(valid2[b0 : b0 + nb]), g)
    hi = jnp.where(ev, b_hi.reshape(-1), jnp.uint32(0xFFFFFFFF))
    entry = jnp.uint32(b0 * g) + jnp.arange(hi.shape[0], dtype=jnp.uint32)
    packed = jnp.where(ev, jnp.uint32(0), jnp.uint32(0x80000000)) | entry
    hs, ps = jsort([hi, packed])
    st = jdetect.table_from_sorted(
        hs, (ps & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32),
        ((ps >> 31) == 0).astype(jnp.int32), B)
    local = jnp.clip((st.entry - b0 * g) // g, 0, nb - 1)
    slab = jnp.concatenate(
        [st.entry[:, None].astype(jnp.uint32), words0b[local]], axis=1)
    return st, slab


def _words(rows):
    return tbitpack.pack_read_words(torch.from_numpy(rows.astype(np.int32)))


@pytest.fixture(scope="module")
def join(dedup):
    """One entry block [70, 70 + 150) and one query chunk [32, 32 + 96)
    of the deduplicated reads, built by the reference and by K9's plain
    version."""
    reads2, valid2 = dedup[1][0], dedup[1][1]
    b0, nb, B = 70, 150, 18
    st, slab = _ref_entry_side(reads2, valid2, b0, nb, B)
    got = plain.seed_table(_words(reads2[b0 : b0 + nb]),
                           torch.from_numpy(valid2[b0 : b0 + nb]),
                           GEO["L"], GEO["s"], GEO["g"], B, b0)
    return reads2, valid2, st, slab, got


def test_seed_table_plain_matches_table_from_sorted(join):
    _, _, st, slab, (table, got_slab) = join
    assert table.dtype == torch.int32 and got_slab.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), np.asarray(st.packed))
    np.testing.assert_array_equal(
        got_slab.numpy(), np.asarray(slab).view(np.int32))
    assert int(table[:, 1].sum()) == 8 * int(join[1][70:220].sum()) > 0


def test_build_seed_table_matches_reference():
    rng = np.random.default_rng(9)
    hi = rng.integers(0, 1 << 32, 2000, dtype=np.uint64).astype(np.uint32)
    hi[:300] = 0xFFFFFFFF                  # real all-T seeds
    valid = rng.random(2000) < 0.8
    ref = jdetect.build_seed_table(jnp.asarray(hi), jnp.asarray(hi),
                                   jnp.asarray(valid), 12)
    got = tdetect.build_seed_table(torch.from_numpy(hi.astype(np.int64)),
                                   torch.from_numpy(valid), 12)
    np.testing.assert_array_equal(got.entry.numpy(), np.asarray(ref.entry))
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(ref.packed))


def test_probe_join_plain_matches_reference_slot_for_slot(join):
    """K10's plain version against probe_seed_table +
    expand_with_payload + the slab decode + verify_candidates_words0 of
    sage2_tpu/stream.py:402-428, slot for slot."""
    reads2, valid2, st, slab, (table, got_slab) = join
    L, s, g, pa = GEO["L"], GEO["s"], GEO["g"], GEO["pa"]
    n_pos = -(-pa // g)
    i, mc, cap = 32, 96, 1 << 12
    chunk = jnp.asarray(reads2[i : i + mc].astype(np.int32))
    cvalid = jnp.asarray(valid2[i : i + mc])
    words0c = jbitpack.pack_read_words(chunk)
    a_hi, _ = jdetect.seed_keys_from_words0(
        words0c, s, [g * (j + 1) for j in range(n_pos)], L)
    lo_idx, counts = jdetect.probe_seed_table(st, a_hi, cvalid)
    n_cand = int(jnp.sum(counts))
    entry_q, rank, lo_of, cand_valid = jexpand(
        counts.reshape(-1), lo_idx.reshape(-1), cap)
    cand_a = i + entry_q // n_pos
    cand_p = (entry_q % n_pos + 1) * g
    row = slab[jnp.minimum(lo_of + rank, slab.shape[0] - 1)]
    e_b = row[:, 0].astype(jnp.int32)
    cand_b = e_b // g
    cand_p0 = cand_p - (e_b - cand_b * g)
    cand_valid = cand_valid & (cand_a != cand_b) & (cand_p0 <= pa)
    cand_p0 = jnp.clip(cand_p0, 1, pa)
    ok = jdetect.verify_candidates_words0(
        words0c, cand_a - i, cand_p0, row[:, 1:], L, max_p=pa) & cand_valid

    args = (_words(reads2[i : i + mc]), torch.from_numpy(valid2[i : i + mc]),
            table, got_slab, L, s, g, pa, i)
    got = plain.probe_join(*args, capacity=cap, block=50)
    assert got[4] == n_cand > 100
    for x, y in zip(got[:4], (ok, cand_a, cand_b, L - cand_p0)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y)[:n_cand])
    assert bool(got[0].any()) and not bool(got[0].all())
    over = plain.probe_join(*args, capacity=n_cand - 1)
    assert over[4] == n_cand and all(a.shape == (0,) for a in over[:4])


@pytest.fixture(scope="module")
def incore_edges(dedup):
    """The reference's in-core edges. Every probe stride finds every
    exact overlap once, so they are every stride's edges."""
    reads2, valid2 = dedup[1][0], dedup[1][1]
    res = jfind(jnp.asarray(reads2.astype(np.int32)), jnp.asarray(valid2),
                40, capacity=1 << 16)
    assert not bool(res.overflow)
    n = int(res.n_edges)
    return tuple(np.asarray(a)[:n] for a in (res.src, res.dst, res.ovl))


@pytest.mark.parametrize("chunk,stride,block", [
    (64, None, None), (300, None, None), (128, 4, None), (256, None, 70)])
def test_find_overlaps_chunked_matches_reference(dedup, incore_edges, chunk,
                                                 stride, block):
    """Identical edges in identical order, single table and entry
    blocks of 70 reads."""
    reads2, valid2 = dedup[1][0], dedup[1][1]
    src, dst, ovl, n, overflow = tstream.find_overlaps_chunked(
        reads2, valid2, 40, chunk_reads=chunk, capacity_per_chunk=1 << 15,
        stride=stride, entry_block_reads=block, device=CPU)
    assert not overflow
    want = incore_edges
    assert n == want[0].shape[0] > 100
    for x, y in zip((src, dst, ovl), want):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.int32


@pytest.mark.parametrize("block", [None, 50])
def test_find_overlaps_chunked_overflow_fails_fast(dedup, tmp_path, block):
    from sage2_tpu_torch.utils.spill import SpillStore

    reads2, valid2 = dedup[1][0], dedup[1][1]
    store = SpillStore(str(tmp_path))
    out = tstream.find_overlaps_chunked(
        reads2, valid2, 40, chunk_reads=64, capacity_per_chunk=8,
        store=store, entry_block_reads=block, device=CPU)
    assert out[3:] == (0, True)
    assert all(a.shape == (0,) for a in out[:3])
    assert not [f for f in tmp_path.iterdir() if f.suffix == ".bin"]
    # a retry at a real capacity over the same store works
    retry = tstream.find_overlaps_chunked(
        reads2, valid2, 40, chunk_reads=64, capacity_per_chunk=1 << 15,
        store=store, entry_block_reads=block, device=CPU)
    assert retry[4] is False
    want = tstream.find_overlaps_chunked(reads2, valid2, 40, 64, device=CPU)
    for x, y in zip(retry[:3], want[:3]):
        np.testing.assert_array_equal(np.asarray(x)[:want[3]], y)


def test_streamed_stages_refuse_bad_requests(dedup, monkeypatch):
    """An unknown rule raises; the default device is the GPU and,
    without one, the streamed stages raise instead of running on the
    CPU."""
    reads = dedup[0][:10]
    with pytest.raises(ValueError, match="rule"):
        tstream.correct_reads_chunked(reads, 11, 3, 1, 4, rule="x",
                                      device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tstream.count_kmers_chunked(reads, 11, 4),
                 lambda: tstream.prepare_reads_chunked(reads, 4),
                 lambda: tstream.find_overlaps_chunked(
                     dedup[1][0], dedup[1][1], 40, 64)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# --- the port's watchdog (model: tests/test_watchdog.py) ----------------

def _run(code):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=25,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))


def test_watchdog_fires_on_stall():
    r = _run("""
        import time
        from sage2_tpu_torch.utils import watchdog
        watchdog.start(1.0)
        watchdog.touch("before stall")
        time.sleep(30)
        print("UNREACHABLE")
    """)
    assert r.returncode == 42
    assert "NO PROGRESS" in r.stderr and "before stall" in r.stderr
    assert "UNREACHABLE" not in r.stdout


def test_watchdog_heartbeats_keep_alive():
    r = _run("""
        import time
        from sage2_tpu_torch.utils import watchdog
        watchdog.start(2.0)
        for i in range(6):
            time.sleep(0.5)
            watchdog.touch(f"step {i}")
        watchdog.stop()
        print("OK")
    """)
    assert r.returncode == 0 and "OK" in r.stdout


def test_watchdog_touched_by_chunks_and_metrics(count_reads):
    from sage2_tpu_torch.utils import watchdog
    from sage2_tpu_torch.utils.metrics import MetricsLog

    tstream.count_kmers_chunked(count_reads, 15, 100, device=CPU)
    assert watchdog._note == "count chunk 200/300"
    MetricsLog(echo=False).log("x")
    assert watchdog._note == "metrics:x"
