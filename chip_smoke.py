#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sage2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (one flushed line each, with its seconds):

  0  the card (nvidia-smi name and power limit) and torch/CUDA versions;
  1  build the twenty-three CUDA kernels (nvcc, sm_90a, one process per
     source, all at once) and the host libraries;
  11 the benches, before anything is kept on the card: bench_gpu.py
     (the overlap join of 16 shards of 100,000 reads against the C++
     baseline, one shard a call and all 16 through
     find_overlaps_stacked; every shard's verified count equal to the
     baseline's, asserted inside it; shard 0's 680,790 asserted here)
     and bench_e2e_gpu.py (phase 4's assembly without artifacts; its
     N50 and contig count asserted equal to phase 4's once phase 4 has
     run), each a subprocess whose JSON line is printed with a prefix;
     then in this process the bench's 16 shards at the bench's capacity
     through find_overlaps_stacked under
     torch.cuda.set_sync_debug_mode("error") (no host synchronisation
     from its first launch to its return), shard 0's row bit-equal to
     find_overlaps at that capacity, counts included. Its kernels (K13
     and K3 in their fixed-capacity modes, K14 deferred) are phase 2's
     rows "seed_rows:stacked", "overlap_join:stacked" and
     "longest_edges:deferred" (shard 0's inputs; K14's with a copy of
     1% of the ok rows at an overlap one shorter, so that n_dups > 0);
  3  the overlap join at the bench's shard 0 (100,000 reads x 100 bp,
     genome 222,222 bp, seeds 7/8, min_overlap 40, seed 32): asserts the
     reference's 1,044,016 candidates and 680,790 verified overlaps; the
     same reads again as ragged reads of length 100 each: arrays and
     counts bit-equal to the fixed call's, no containment;
  12 phase 4's reads and config on a device mesh of four shards, all on
     this card (AssemblyConfig(mesh_shape=(4,)), outdir=None): the
     sharded count, correction, overlap, reduction and unitig labeling
     (K19 route_rows, K20 routed_gather, K21 reduce_requests, K22
     window_variants, with K1, K2, K3, K11, K13 and K14 on each shard's
     work and K8/K12 for the dedup); stage seconds, peak device memory,
     the collective ledger's bytes by stage, every retry and the
     capacities; genome_fraction >= 0.99, N50 and contig count equal to
     bench_e2e_gpu.py's (asserted here), contigs and stats equal to
     phase 4's (asserted after phase 4); it runs before phase 4, while
     few kernel inputs are kept on the card;
  13 phase 8's ragged reads (simulated here) on the same four-shard mesh,
     right after phase 12 for the same reason: 13a phase 8a's config
     (ragged single_window correction: K22's verdicts with lengths; the
     ragged routed join: K13 with lengths, K3 with containment marks and
     the owners' permutation at once; the meshed containment removal; the
     ragged sharded reduction: K21's probe with each shard's lengths),
     13b phase 8b's (the voting rule on the mesh: K22 at every window
     position, K5's routed vote_add and vote_apply); each prints its
     stage seconds, peak device memory, collective bytes by stage,
     retries and capacities and its containment count, and asserts
     genome_fraction >= 0.99; contigs, stats and containment counts
     asserted equal to 8a's and 8b's after phase 8;
  14 streaming on the same four-shard mesh, right after phase 13 for the
     same reason, with phase 10a's flags (1,000,000-read chunks, a spill
     dir; artifacts for 14a only): 14a phase 4's reads and config (the
     streamed sharded count with its running tables (K11 weighted), the
     chunked routed correction, the owners' accumulated entry rows and
     each query chunk's join (K13 entries/queries, K3 under the owners'
     permutation, K14), the edges gathered into the spill store
     (gather_edge_shards_spill), the sharded reduction and labeling),
     14b phase 8's ragged reads and 8a's config (K3's containment marks
     OR-ed over chunks and owners, the meshed containment removal, the
     edges gathered to the host as with an outdir; no artifacts: the
     full edges.npz with reads2 took ~120 s of the script's time); each
     prints its stage seconds, peak device memory, collective bytes by
     stage, retries and capacities and its spill files, and asserts
     genome_fraction >= 0.99; contigs and stats asserted equal to phase
     4's (14a) and 8a's with its containment count (14b) after those
     phases;
  4  reads to contigs at E. coli scale (4.6 Mbp genome, 50x, 100 bp,
     error 0.005, seeds 7/8, default AssemblyConfig: single_window
     corrector, host-native reduction) through
     pipeline.assemble(device="cuda"): per-stage seconds, the device
     split of the dedup and overlap stages (CUDA events: K8, the sort
     chain, the grouping, the RC rows; the seed rows, the row sort, K3,
     K14), contig stats, genome_fraction >= 0.99 asserted;
  5  the same reads through the voting corrector and the device
     reduction (correction_rule="vote_all_windows",
     reduce_backend="device", no artifacts written): the same report
     and split, genome_fraction >= 0.99 asserted;
  6  phase 4's edge list reduced by the device backend and by the host
     native backend: equal arrays, n_edges and n_expansions asserted;
  7  the Pallas probe's path (scripts/probe_pallas_gather.py): its
     largest gathers, (65536, 128) and (1 << 20, 128) on axis 0 and
     (2048, 2048) on axis 1, through kernels.gather_along;
  8  ragged reads at E. coli scale (the same genome; lengths uniform in
     [75, 150], either strand, error 0.005 on real bases, 50x of real
     bases, plus 10% contained reads of 47-72 bp; zero-padded to 150;
     simulated before phase 13) through
     pipeline.assemble(lengths=..., outdir=None): 8a the
     default config (native reduction with per-vertex lengths), 8b
     vote_all_windows + the device reduction; each prints the split and
     asserts genome_fraction >= 0.99 and containments removed;
  9  8a's ragged edge list reduced by the device backend and by the
     native one, both with per-vertex lengths: equal arrays, n_edges
     and n_expansions asserted;
  10 phase 4's reads streamed beyond device memory in chunks of
     1,000,000 reads (the reference README's --max-device-reads): 10a
     the default config with a spill dir and artifacts (3 count/correct
     chunks, 3 overlap query chunks of 2 M reads against one seed table,
     the spilled native reduction), 10b the voting corrector and the
     device reduction with --entry-block-reads 3,000,000 (2 entry
     blocks: the block-nested join), no artifacts; 10a's contigs and
     stats asserted equal to phase 4's, 10b's to phase 5's; 10c phase
     8's ragged reads streamed alike with a spill dir and artifacts (one
     entry slab of K13 rows, 3 query chunks of 2 M reads2 joined by K3
     with lengths), 10d the same reads with the voting corrector, the
     device reduction and 3,000,000-read entry blocks (2 slabs), no
     spill; 10c's contigs and stats asserted equal to 8a's, 10d's to
     8b's. Phases 4, 5, 10a-10d each print their peak device memory
     (torch.cuda.max_memory_allocated after a reset), 10a-10d the host
     split of their streamed dedup (K8's words, the host sort and
     grouping, the representative rows);
  2a right after phase 13: phase 2's rows of paths 11, 12, 13a and 13b
     (2b right after phase 14: those of 14a and 14b),
     so that their kept inputs leave the card before the next phases
     keep theirs (else those phases' copies go to the host inside their
     timed stages, or their plain versions run out of device memory);
  2  (the card's clocks, power, temperature and throttle reasons
     printed before and after it, 2a and 2b) each kernel
     against its plain PyTorch version on the inputs that
     its path's run gave it (captured during that run, so phase 2 comes
     last): one row for each kernel of each path (PATHS), "name" on its
     first path and "name:<path>" on every other (phases 4, 5, 7, 8a,
     8b, 10a-10d; not 3, 6 or 9). A row takes the path's call with the
     most input elements (for reduce_marks the largest slot range;
     pointer_jump once for each of its ops none/min/add; gather_along
     once per probe shape; the kernels with a ragged branch as
     "name:ragged" on a call with lengths, K11 as "merge_runs:weighted"
     on a table merge, K8's rows-only call (the unique reads' reverse
     complements, written into reads2's second half) as
     "canonical_reads:rc" on paths 4 and 8a); K9 and K10 take a later entry block's table
     (base > 0) and a query chunk after the first where the path has
     them. Bit equality of outputs and in-place results asserted,
     median times (CUDA events), the bound from bytes and operations,
     a K2 or K5 row the time of its first launch (the bucket directory,
     "index_ms") beside the whole call, a K16 row the time of its
     round's membership table build ("build_ms", three launches under
     K16's name in the path's counts), a K5 row the share of its
     (window, position) pairs that the skip leaves to look up
     ("pair_share", on the path's first voting round's input), a P1 row
     the bare launch without the flag read ("kernel_ms") beside the
     wrapper's "ms", and the
     device times of that launch and of torch.gather, each enqueued
     behind a spin of the card ("device_ms", "library_device_ms"),
     K21's row table the same of the call and of its library call,
     a K15 row the device time of its bare launch ("device_ms"), the
     call and torch.masked_select behind the spin, each with its host
     read of the kept count ("spun_call_ms", "library_spun_ms"), and what
     a copy of its kept entries to their own size would take ("copy_ms";
     the outputs are views),
     the heads row of K20 its device time, the time of
     torch.sort of the same requests (which its caller runs before it,
     "sort_ms") and its bound with a 32-byte sector a scattered store
     ("sector_bound_ms"),
     and one PyTorch call computing the same function where there is
     one. Two rows take inputs made from another row's (DERIVED):
     "fix_windows:fallback", phase 4's K17 call through K2's directory
     alone (no membership table), and "dedup_reads:skew", phase 4's K12
     call with the first 32 bases of every tenth read set to A (a run
     of 230,000 equal leading words, sorted by the whole grid; K8 run
     again on them); their "launches" are their kernel's on phase 4
     (torch.searchsorted beside K2 and beside K9's bucket table,
     torch.gather beside P1, torch.unique_consecutive beside K11,
     torch.unique(dim=0) of the canonical words (the length first for
     ragged reads) beside K12, torch.masked_select of the keys and
     the counts beside K15; for K4
     none the path's `steps` chained index_select(p, 0, p)). A K2 row
     takes the pruned table of its path's K16 row and the canonical keys
     of that row's reads (K1, in phase 2): K16 makes those lookups inside
     its own launch now (in its membership table of the solid keys), and
     the path launches K2 only for the bucket directory that K17 uses
     (and K16 where it builds no table): a K2 row's "launches" are that
     directory's, printed as such, and its search is timed on inputs
     the path never gave it. A K4 row
     times one whole doubling loop (one launch) and prints its time a
     step beside one index_select a step and the cost of one grid
     barrier (the loop on 4 vertices, less one step, over steps - 1);
     its bound is steps times a step's bytes. A K11 row whose table is
     under half its input prints the time of the copy to exact size that
     count_from_keys makes after the kernel. A K19 row prints its mode
     (one-way: no per-row answers; two-way) and the device time of its
     histogram, host read and scatter; a K21 row whether it searched
     from the shard's vertex row table, and its ranges, cumsum, host read
     and expand; "reduce_requests:rows" is that table's launch (once a
     shard and reduction pass, beside torch.searchsorted).

Each path runs with the launch counts set to 0 just before it and read
just after it: phase 11 for K13, K3 and K14 in the stacked path's
modes (the sync-checked call), phase 12 for the mesh (K19-K22, with
K1, K2, K3 (its payload-permutation mode), K8, K11-K14; the ":12"
rows), 13a and 13b for the ragged and voting mesh (the same with
lengths: "window_variants:ragged", "reduce_requests:probe_ragged",
"overlap_join:ragged_perm"; 13b K22 at a window position,
"window_variants:position", the one nearest the window's middle, and
K5's routed mode, "vote_windows:routed" (the last position's call) and
"vote_windows:apply"; the ":13a"/":13b" rows), 14a and 14b for the
streamed mesh (K1, K11 unit and weighted, K19, K2, K20 and K22 a chunk;
K13 entries and queries, K3 with the permutation (14b: and marks) and
K14; K8; K21; the ":14a"/":14b" rows), phase 4 for K1-K4, K8
and K11-K18,
phase 5 for K5-K7,
K12-K15 and K18, phase 7 for P1, phases 8a and 8b for the ragged path
(K12 to K18 too), 10a and 10b for the streamed path (K9-K11 with K1,
K2, K8, K4, K14, K15 and K18, and K16-K17 or K5-K7), 10c and 10d for
the streamed ragged path (K13 and K3 in their streamed mode: the
":entries", ":queries" and ":streamed" keys; K1, K2, K4, K8 and K11 on
ragged chunks, K14 a query chunk, K15-K18, and K5-K7 with lengths on
10d). Every kernel of a path (PATHS) must have launched on it, and is
held against its plain version on that path's own inputs; on 8a/8b,
10c and 10d K3, K5, K6, K7, K8, K12, K13 and K16 launch with their
lengths pointers (the ":ragged" keys). pointer_jump's
counts are split by op: one launch a doubling loop, so 2 none, 1 min
and 1 add a unitig contraction (asserted); K11 one launch a call
(asserted). The kernels' captured inputs wait in device
memory outside PyTorch's allocator, so they do not count in the peaks;
each path starts with PyTorch's cached memory released, to leave them
room. The last two lines are the kernel table and
{"ok": true, "device": {...}}. Any failure exits non-zero before them;
without a GPU the script exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

# card peaks (H100 SXM data sheet): device memory rate, and the 32-bit
# rate outside the tensor cores, used for the integer kernels' work
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

SHARD0 = dict(n_reads=100_000, read_len=100, coverage=45.0,
              error_rate=0.005, seeds=(7, 8), min_overlap=40)
SHARD0_CANDIDATES = 1_044_016
SHARD0_VERIFIED = 680_790
ECOLI = dict(genome_len=4_600_000, coverage=50.0, read_len=100,
             error_rate=0.005, seeds=(7, 8))
# phase 8: ragged reads of the same genome (simulate_ragged_reads, the
# recipe of tests/test_ragged.py:15-36 with lo = 75)
ECOLI_RAGGED = dict(lo=75, hi=150, coverage=50.0, error_rate=0.005,
                    contained_frac=0.1, seed=8)
# phase 10: the reference README's streaming flags (README.md:66-72)
STREAM_CHUNK = 1_000_000
# phase 12: shards of the device mesh, all on the one card
MESH_SHARDS = 4
ENTRY_BLOCK = 3_000_000
# the reference (sage2_tpu) on the same input, BASELINE.md round 4:
# printed as a guide, not a gate
REFERENCE_ASSEMBLY = {"n_contigs": 5, "n50": 1_435_616,
                      "genome_fraction": 1.0}

# the probe's largest gathers (scripts/probe_pallas_gather.py:95,100,103)
PROBE_SHAPES = ((65536, 128, 0), (1 << 20, 128, 0), (2048, 2048, 1))

_CSRC = "sage2_tpu_torch/kernels/csrc/"
# one row of the kernel table per key (pointer_jump once per op,
# gather_along once per probe shape, ":ragged" for a call with lengths,
# a ":<phase>" suffix for a second row from another path): source, the
# TPU kernel it replaces, and the phase whose run gives the row its
# inputs and its launch count
KERNEL_INFO = {
    "kmer_keys": (_CSRC + "kmer_keys.cu",
                  "sage2_tpu/ops/bitpack.py:126", "4"),
    "lookup_counts": (_CSRC + "lookup_counts.cu",
                      "sage2_tpu/kmer/count.py:97", "4"),
    "overlap_join": (_CSRC + "overlap_join.cu",
                     "sage2_tpu/overlap/detect.py:863", "4"),
    "pointer_jump:none": (_CSRC + "pointer_jump.cu",
                          "sage2_tpu/graph/traverse.py:81", "4"),
    "pointer_jump:min": (_CSRC + "pointer_jump.cu",
                         "sage2_tpu/graph/traverse.py:88", "4"),
    "pointer_jump:add": (_CSRC + "pointer_jump.cu",
                         "sage2_tpu/graph/traverse.py:114", "4"),
    "vote_windows": (_CSRC + "vote_windows.cu",
                     "sage2_tpu/kmer/correct.py:134", "5"),
    "reduce_counts": (_CSRC + "reduce_counts.cu",
                      "sage2_tpu/graph/reduce.py:133", "5"),
    "reduce_marks": (_CSRC + "reduce_marks.cu",
                     "sage2_tpu/graph/reduce.py:520", "5"),
    "canonical_reads": (_CSRC + "canonical_reads.cu",
                        "sage2_tpu/overlap/prepare.py:55", "4"),
    "canonical_reads:ragged": (_CSRC + "canonical_reads.cu",
                               "sage2_tpu/overlap/prepare.py:55", "8a"),
    # K8's second call: the unique reads' reverse complements, written
    # into reads2's second half (rc_only, ``out``)
    "canonical_reads:rc": (_CSRC + "canonical_reads.cu",
                           "sage2_tpu/overlap/prepare.py:132", "4"),
    "overlap_join:ragged": (_CSRC + "overlap_join.cu",
                            "sage2_tpu/overlap/detect.py:863", "8a"),
    "vote_windows:ragged": (_CSRC + "vote_windows.cu",
                            "sage2_tpu/kmer/correct.py:134", "8b"),
    "reduce_counts:ragged": (_CSRC + "reduce_counts.cu",
                             "sage2_tpu/graph/reduce.py:133", "8b"),
    "reduce_marks:ragged": (_CSRC + "reduce_marks.cu",
                            "sage2_tpu/graph/reduce.py:520", "8b"),
    "seed_table": (_CSRC + "seed_table.cu", "sage2_tpu/stream.py:193",
                   "10a"),
    "probe_join": (_CSRC + "probe_join.cu", "sage2_tpu/stream.py:240",
                   "10a"),
    "merge_runs": (_CSRC + "merge_runs.cu", "sage2_tpu/kmer/count.py:72",
                   "10a"),
    "merge_runs:weighted": (_CSRC + "merge_runs.cu",
                            "sage2_tpu/stream.py:30", "10a"),
    "dedup_reads": (_CSRC + "dedup_reads.cu",
                    "sage2_tpu/overlap/prepare.py:67", "4"),
    "dedup_reads:ragged": (_CSRC + "dedup_reads.cu",
                           "sage2_tpu/overlap/prepare.py:67", "8a"),
    "seed_rows": (_CSRC + "seed_rows.cu", "sage2_tpu/overlap/detect.py:642",
                  "4"),
    "seed_rows:ragged": (_CSRC + "seed_rows.cu",
                         "sage2_tpu/overlap/detect.py:642", "8a"),
    "longest_edges": (_CSRC + "longest_edges.cu",
                      "sage2_tpu/overlap/detect.py:1015", "4"),
    "prune_table": (_CSRC + "prune_table.cu",
                    "sage2_tpu/kmer/correct.py:246", "4"),
    "weak_windows": (_CSRC + "weak_windows.cu",
                     "sage2_tpu/kmer/correct.py:270", "4"),
    "weak_windows:ragged": (_CSRC + "weak_windows.cu",
                            "sage2_tpu/kmer/correct.py:270", "8a"),
    "fix_windows": (_CSRC + "fix_windows.cu",
                    "sage2_tpu/kmer/correct.py:293", "4"),
    # rows whose inputs phase 2 makes from another row's (DERIVED)
    "fix_windows:fallback": (_CSRC + "fix_windows.cu",
                             "sage2_tpu/kmer/correct.py:293", "4"),
    "dedup_reads:skew": (_CSRC + "dedup_reads.cu",
                         "sage2_tpu/overlap/prepare.py:67", "4"),
    "chain_links": (_CSRC + "chain_links.cu",
                    "sage2_tpu/graph/traverse.py:40", "4"),
    "chain_links:cut": (_CSRC + "chain_links.cu",
                        "sage2_tpu/graph/traverse.py:96", "4"),
    "seed_rows:entries": (_CSRC + "seed_rows.cu", "sage2_tpu/stream.py:835",
                          "10c"),
    "seed_rows:queries": (_CSRC + "seed_rows.cu", "sage2_tpu/stream.py:847",
                          "10c"),
    "overlap_join:streamed": (_CSRC + "overlap_join.cu",
                              "sage2_tpu/stream.py:847", "10c"),
    "seed_rows:stacked": (_CSRC + "seed_rows.cu",
                          "sage2_tpu/overlap/detect.py:1108", "11"),
    "overlap_join:stacked": (_CSRC + "overlap_join.cu",
                             "sage2_tpu/overlap/detect.py:1108", "11"),
    "longest_edges:deferred": (_CSRC + "longest_edges.cu",
                               "sage2_tpu/overlap/detect.py:1015", "11"),
    "route_rows": (_CSRC + "route_rows.cu",
                   "sage2_tpu/parallel/sharded.py:73", "12"),
    "routed_gather": (_CSRC + "routed_gather.cu",
                      "sage2_tpu/parallel/sharded.py:120", "12"),
    "routed_gather:heads": (_CSRC + "routed_gather.cu",
                            "sage2_tpu/parallel/sharded.py:575", "12"),
    "routed_gather:gather": (_CSRC + "routed_gather.cu",
                             "sage2_tpu/parallel/sharded.py:607", "12"),
    "reduce_requests": (_CSRC + "reduce_requests.cu",
                        "sage2_tpu/parallel/sharded.py:493", "12"),
    "reduce_requests:probe": (_CSRC + "reduce_requests.cu",
                              "sage2_tpu/parallel/sharded.py:518", "12"),
    # K21's vertex row table of a shard, once a reduction pass (the
    # reference searched the whole adjacency in phases 2 and 4 instead)
    "reduce_requests:rows": (_CSRC + "reduce_requests.cu",
                             "sage2_tpu/parallel/sharded.py:493", "12"),
    "window_variants": (_CSRC + "window_variants.cu",
                        "sage2_tpu/kmer/correct.py:36", "12"),
    "window_variants:verdicts": (_CSRC + "window_variants.cu",
                                 "sage2_tpu/kmer/correct.py:86", "12"),
    # the ragged and voting mesh (phases 13a, 13b): K5's routed mode, K22
    # at any window position and with lengths, K21's probe with lengths,
    # K3 with containment marks and the owners' permutation at once
    "vote_windows:routed": (_CSRC + "vote_windows.cu",
                            "sage2_tpu/kmer/correct.py:171", "13b"),
    "vote_windows:apply": (_CSRC + "vote_windows.cu",
                           "sage2_tpu/kmer/correct.py:174", "13b"),
    "window_variants:position": (_CSRC + "window_variants.cu",
                                 "sage2_tpu/kmer/correct.py:161", "13b"),
    "window_variants:ragged": (_CSRC + "window_variants.cu",
                               "sage2_tpu/parallel/sharded.py:334", "13a"),
    "reduce_requests:probe_ragged": (_CSRC + "reduce_requests.cu",
                                     "sage2_tpu/parallel/sharded.py:524",
                                     "13a"),
    "overlap_join:ragged_perm": (_CSRC + "overlap_join.cu",
                                 "sage2_tpu/parallel/sharded.py:957", "13a"),
}
# the rows whose inputs are made from another row's (derived_inputs), and
# that row
DERIVED = {"fix_windows:fallback": "fix_windows",
           "dedup_reads:skew": "dedup_reads"}
# the wrapper of each row whose kernel is called through another wrapper
# than its own name
WRAPPER = {"chain_links:cut": "chain_cut",
           "seed_rows:stacked": "seed_rows_stacked",
           "overlap_join:stacked": "overlap_join_stacked",
           "longest_edges:deferred": "longest_edges_deferred",
           "routed_gather": "route_back",
           "routed_gather:heads": "dedup_heads",
           "routed_gather:gather": "gather_rows",
           "reduce_requests:probe": "reduce_probe",
           "reduce_requests:rows": "reduce_rows",
           "window_variants:verdicts": "apply_verdicts",
           "vote_windows:routed": "vote_add",
           "vote_windows:apply": "vote_apply",
           "window_variants:ragged": "apply_verdicts",
           "reduce_requests:probe_ragged": "reduce_probe"}
# the wrappers with a branch that takes tensors where their other calls
# pass None (lengths; K11's weights; K3's marks and the owners'
# permutation): a call given tensors at all of a branch's positions is
# counted under its row, the first that matches
BRANCH_AT = {"canonical_reads": [((1,), "canonical_reads:ragged")],
             "dedup_reads": [((1,), "dedup_reads:ragged")],
             "weak_windows": [((1,), "weak_windows:ragged")],
             "seed_rows": [((2,), "seed_rows:ragged")],
             "overlap_join": [((7, 12), "overlap_join:ragged_perm"),
                              ((7,), "overlap_join:ragged")],
             "vote_windows": [((5,), "vote_windows:ragged")],
             "reduce_counts": [((5,), "reduce_counts:ragged")],
             "reduce_marks": [((9,), "reduce_marks:ragged")],
             "merge_runs": [((1,), "merge_runs:weighted")],
             "apply_verdicts": [((5,), "window_variants:ragged")],
             "reduce_probe": [((4,), "reduce_requests:probe_ragged")]}
# K5's routed mode: no bucket directory, no skip
_ROUTED_VOTE = ("vote_windows:routed", "vote_windows:apply")
for _n, _w, _a in PROBE_SHAPES:
    KERNEL_INFO[f"gather_along:{_a}:{_n}x{_w}"] = (
        _CSRC + "gather_along.cu", "scripts/probe_pallas_gather.py:73", "7")

_JUMPS = ["pointer_jump:none", "pointer_jump:min", "pointer_jump:add"]
_CHAIN = ["chain_links", "chain_links:cut"]
# the two-phase corrector: K2's directory, K15 (also pruned for K5), K16
# and K17
_TWOPHASE = ["lookup_counts", "prune_table", "weak_windows", "fix_windows"]
# the keys that must launch on each path
_STREAMED = ["seed_table", "probe_join", "merge_runs", "merge_runs:weighted",
             "canonical_reads", "kmer_keys", "longest_edges", "prune_table",
             *_JUMPS, *_CHAIN]
_STREAMED_RAGGED = ["seed_rows:entries", "seed_rows:queries",
                    "overlap_join:streamed", "merge_runs",
                    "merge_runs:weighted", "canonical_reads:ragged",
                    "kmer_keys", "longest_edges", "prune_table", *_JUMPS,
                    *_CHAIN]
_DEDUP_JOIN = ["dedup_reads", "seed_rows", "longest_edges"]
_RAGGED_DEDUP_JOIN = ["dedup_reads:ragged", "seed_rows:ragged",
                      "longest_edges"]
# the meshed ragged path's kernels under either rule
_MESH_RAGGED = ["kmer_keys", "merge_runs", "lookup_counts",
                "canonical_reads:ragged", *_RAGGED_DEDUP_JOIN,
                "overlap_join:ragged_perm", "route_rows", "routed_gather",
                "routed_gather:heads", "routed_gather:gather",
                "reduce_requests", "reduce_requests:rows",
                "reduce_requests:probe_ragged"]
# the streamed mesh's kernels under single_window: the chunked count and
# correction, K13's entry and query rows, the owners' join, the edge merge,
# the sharded reduction and labeling
_MESH_STREAMED = ["kmer_keys", "merge_runs", "merge_runs:weighted",
                  "lookup_counts", "route_rows", "routed_gather",
                  "routed_gather:heads", "routed_gather:gather",
                  "window_variants", "seed_rows:entries", "seed_rows:queries",
                  "longest_edges", "reduce_requests", "reduce_requests:rows"]
# the TPU programs of sharded_stream.py that the streamed mesh's rows
# replace (their first rows name the single-device or in-core ones)
_SS = "sage2_tpu/parallel/sharded_stream.py:"
STREAM_MESH_REPLACES = {
    "kmer_keys": _SS + "131", "merge_runs": _SS + "145",
    "merge_runs:weighted": _SS + "82", "route_rows": _SS + "141",
    "lookup_counts": _SS + "272", "routed_gather": _SS + "272",
    "window_variants": _SS + "267", "window_variants:verdicts": _SS + "277",
    "window_variants:ragged": _SS + "277", "seed_rows:entries": _SS + "381",
    "seed_rows:queries": _SS + "445", "overlap_join": _SS + "474",
    "overlap_join:ragged_perm": _SS + "474", "longest_edges": _SS + "524",
}
# the mesh's paths: K2 makes real lookups at the k-mer owners there
MESH_PATHS = ("12", "13a", "13b", "14a", "14b")
# the paths that run before phase 4, whose rows phase 2a (11-13b, right
# after phase 13) and phase 2b (14a, 14b, right after phase 14) check
EARLY_PATHS = ("11", *MESH_PATHS)
STREAM_MESH_PATHS = ("14a", "14b")
PATHS = {
    "4": ["kmer_keys", *_TWOPHASE, "canonical_reads", "canonical_reads:rc",
          "overlap_join", "merge_runs", *_JUMPS, *_DEDUP_JOIN, *_CHAIN],
    "5": ["vote_windows", "reduce_counts", "reduce_marks", "prune_table",
          *_DEDUP_JOIN, *_CHAIN],
    "7": [k for k in KERNEL_INFO if k.startswith("gather_along")],
    "8a": ["kmer_keys", "lookup_counts", "prune_table",
           "weak_windows:ragged", "fix_windows", "canonical_reads:ragged",
           "canonical_reads:rc", "overlap_join:ragged", *_JUMPS,
           *_RAGGED_DEDUP_JOIN, *_CHAIN],
    "8b": ["kmer_keys", "vote_windows:ragged", "prune_table",
           "canonical_reads:ragged", "overlap_join:ragged",
           "reduce_counts:ragged", "reduce_marks:ragged", *_JUMPS,
           *_RAGGED_DEDUP_JOIN, *_CHAIN],
    "10a": [*_STREAMED, "lookup_counts", "weak_windows", "fix_windows"],
    "10b": [*_STREAMED, "vote_windows", "reduce_counts", "reduce_marks"],
    "10c": [*_STREAMED_RAGGED, "lookup_counts", "weak_windows:ragged",
            "fix_windows"],
    "10d": [*_STREAMED_RAGGED, "vote_windows:ragged", "reduce_counts:ragged",
            "reduce_marks:ragged"],
    "11": ["seed_rows:stacked", "overlap_join:stacked",
           "longest_edges:deferred"],
    "12": ["kmer_keys", "merge_runs", "lookup_counts", "canonical_reads",
           *_DEDUP_JOIN, "overlap_join", "route_rows", "routed_gather",
           "routed_gather:heads", "routed_gather:gather", "reduce_requests",
           "reduce_requests:probe", "reduce_requests:rows", "window_variants",
           "window_variants:verdicts"],
    "13a": [*_MESH_RAGGED, "window_variants", "window_variants:ragged"],
    "13b": [*_MESH_RAGGED, "window_variants:position", *_ROUTED_VOTE],
    "14a": [*_MESH_STREAMED, "canonical_reads", "overlap_join",
            "window_variants:verdicts", "reduce_requests:probe"],
    "14b": [*_MESH_STREAMED, "canonical_reads:ragged",
            "overlap_join:ragged_perm", "window_variants:ragged",
            "reduce_requests:probe_ragged"],
}
# every kernel of a path is held against its plain version at that
# path's shapes: a second row "<key>:<path>" where its first row comes
# from another path
for _path, _keys in PATHS.items():
    for _key in _keys:
        if KERNEL_INFO[_key][2] != _path:
            _replaces = KERNEL_INFO[_key][1]
            if _path.startswith("14"):
                _replaces = STREAM_MESH_REPLACES.get(_key, _replaces)
            KERNEL_INFO[f"{_key}:{_path}"] = (KERNEL_INFO[_key][0], _replaces,
                                              _path)

T_START = time.perf_counter()


def say(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, t0: float, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    say(f"[phase {name}] {time.perf_counter() - t0:.3f} s "
        f"(at {time.perf_counter() - T_START:.1f} s) {extra}".rstrip())


def time_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over reps runs, by CUDA events, after
    one warm-up run."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 5) -> float:
    """Median device milliseconds of fn()'s work, by CUDA events, each run
    enqueued behind a ~2 ms spin of the card so that the host's launch
    cost is hidden; after one warm-up run."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def base_key(row: str) -> str:
    """The launch-count key of a kernel-table row (its ":<phase>" suffix
    dropped)."""
    path = KERNEL_INFO[row][2]
    return row[:-len(path) - 1] if row.endswith(":" + path) else row


class RawDeviceCopies:
    """Device copies of tensors in memory from cudaMalloc itself, outside
    PyTorch's caching allocator, so that torch.cuda.max_memory_allocated
    does not count them. The copy is a device-to-device copy_ on the
    current stream; ``free`` releases the memory (cudaFree waits for the
    device). A large int32 tensor whose values all lie in [0, 255] (read
    codes, overlap lengths) is kept as uint8: ``copy`` converts it on the
    copy, ``Capture.inputs`` widens it back. A large 1-D tensor that ends
    in a run of one value (the padding rows of an edge list) is kept
    without the run, which ``Capture.inputs`` appends again. Past
    DEVICE_BUDGET bytes the copies go to host memory instead (their
    handle is None), so that phase 2 keeps room on the card for its
    plain versions; ``Capture.inputs`` brings them back."""

    DEVICE_BUDGET = 48 << 30
    TAIL_MIN = 1 << 20          # elements: the shortest tail cut off

    _TYPESTR = {"int8": "|i1", "uint8": "|u1", "bool": "|b1",
                "int32": "<i4", "int64": "<i8"}

    def __init__(self):
        import ctypes

        try:                    # the runtime PyTorch itself loaded
            rt = ctypes.CDLL("libcudart.so.12")
        except OSError:
            rt = ctypes.CDLL(os.path.join(
                os.environ.get("CUDA_HOME", "/usr/local/cuda"), "lib64",
                "libcudart.so"))
        rt.cudaMalloc.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.c_size_t]
        rt.cudaFree.argtypes = [ctypes.c_void_p]
        self.ctypes, self.rt = ctypes, rt
        self.kept = 0           # bytes held on the card
        self.kept_host = 0      # bytes copied to the host
        self.copy_s = 0.0       # host seconds spent in copy()
        self.sizes = {}         # bytes of each raw copy

    def copy(self, t):
        """(a tensor viewing the raw copy of ``t``, its handle, and the
        (length, value) of the run cut from its end, or None)."""
        import torch

        tail = None
        if t.dim() == 1 and t.numel() >= self.TAIL_MIN:
            differs = (t != t[-1]).flip(0).to(torch.uint8)
            n = t.numel() - (int(torch.argmax(differs)) if int(
                differs.max()) else t.numel())
            if t.numel() - n >= self.TAIL_MIN:
                tail = (t.numel() - n, t[-1].item())
                t = t[:n]
            del differs
        dtype = t.dtype
        if dtype == torch.int32 and t.numel() >= 1 << 20:
            lo, hi = (int(x) for x in torch.aminmax(t))
            if 0 <= lo and hi <= 255:
                dtype = torch.uint8
        size = max(1, t.numel() * dtype.itemsize)
        if self.kept + size > self.DEVICE_BUDGET:
            self.kept_host += size
            return t.to("cpu", dtype), None, tail
        ptr = self.ctypes.c_void_p()
        rc = self.rt.cudaMalloc(self.ctypes.byref(ptr), size)
        if rc != 0:     # PyTorch's cache may hold the memory: release it
            self.rt.cudaGetLastError()
            torch.cuda.empty_cache()
            rc = self.rt.cudaMalloc(self.ctypes.byref(ptr), size)
        if rc != 0:
            raise RuntimeError(f"cudaMalloc failed: error {rc}")
        view = types.SimpleNamespace(__cuda_array_interface__={
            "shape": tuple(t.shape), "data": (ptr.value, False),
            "typestr": self._TYPESTR[str(dtype).split(".")[1]],
            "strides": None, "version": 2})
        out = torch.as_tensor(view, device="cuda")
        if out.numel() and out.data_ptr() != ptr.value:
            raise RuntimeError("torch.as_tensor copied the raw buffer")
        out.copy_(t)
        self.kept += size
        self.sizes[ptr.value] = size
        return out, ptr.value, tail

    def free(self, handle) -> None:
        self.rt.cudaFree(self.ctypes.c_void_p(handle))
        self.kept -= self.sizes.pop(handle)


class Capture:
    """Wraps the kernel wrappers of ``sage2_tpu_torch.kernels`` (the
    callers look them up on the module at each call). For each row of
    KERNEL_INFO it keeps a copy of the arguments of the call with the
    most input elements made on the row's own path, in device memory
    outside PyTorch's allocator (``RawDeviceCopies``: fast, and unseen
    by the phases' peak-memory readings); ``inputs`` hands them back as
    ordinary tensors. It splits the wrappers' own launch counts
    (``kernels.LAUNCHES``) by key."""

    # wrappers outside KERNELS, and the kernel whose launches they count
    EXTRA = {"lookup_directory": "lookup_counts", "chain_cut": "chain_links",
             "solid_table": "weak_windows",
             **{w: k.split(":")[0] for k, w in WRAPPER.items()}}
    # the round's lookup structures (the bucket directory, K16's membership
    # table): counted, never kept as a call of their kernel
    BUILDS = ("lookup_directory", "solid_table")
    # the row key of a wrapper's calls where it is not the kernel's name
    # (a call in a branch of BRANCH_AT gets that row's key in ``counted``)
    KEY_OF = {w: k for k, w in WRAPPER.items()
              if k not in {row for b in BRANCH_AT.values() for _, row in b}}

    def __init__(self, kernels):
        self.kernels = kernels
        self.originals = {n: getattr(kernels, n)
                          for n in (*kernels.KERNELS, *self.EXTRA)
                          if hasattr(kernels, n)}
        self.copies = RawDeviceCopies()
        self.args: dict = {}
        self.phase = None
        self.since = (0, 0, 0.0)    # copies' (kept, kept_host, copy_s)
        self.depth = 0          # wrapped calls in progress
        self.keeping = True     # False: count only (copies would sync)
        self.entry_base = 0     # the first read of the last seed table
        self.launches = {base_key(row): 0 for row in KERNEL_INFO}
        self.calls = dict.fromkeys(self.launches, 0)    # non-empty ones
        for attr, fn in self.originals.items():
            setattr(kernels, attr, self._wrap(attr, fn))

    def _wrap(self, attr, fn):
        import torch

        name = self.EXTRA.get(attr, attr)
        default = self.KEY_OF.get(attr, name)

        def call(*args, **kw):
            # a wrapper called by another (K2's and K5's directory) is
            # counted and kept as part of the outer call
            if self.depth:
                return fn(*args, **kw)
            self.depth += 1
            try:
                return counted(*args, **kw)
            finally:
                self.depth -= 1

        def counted(*args, **kw):
            # keyword arguments (a stage's DeviceSplit) are not kept
            key = default
            size = sum(a.numel() for a in args
                       if isinstance(a, torch.Tensor))
            if key != name:
                pass                             # a mode of its own
            elif name == "pointer_jump":
                key = f"{name}:{args[2] if len(args) > 2 else 'none'}"
            elif name == "gather_along":
                key = f"{name}:{args[2]}:{args[0].shape[0]}x{args[0].shape[1]}"
            elif name == "reduce_marks":
                size += args[-1] - args[-2]      # the slot range
            elif key == "reduce_requests":
                size += args[3]     # the candidate capacity: a retry's pass
            elif name == "canonical_reads" and len(args) > 2 and args[2]:
                key = f"{name}:rc"               # the rows alone
            elif name == "seed_rows" and len(args) > 8 and args[8] != "all":
                key = f"{name}:{args[8]}"        # the streamed join's rows
            elif name == "overlap_join" and len(args) > 9 and isinstance(
                    args[9], torch.Tensor):
                key = f"{name}:streamed"         # an entry slab's payload
            elif name == "window_variants" and args[2] not in ("last",
                                                               "first"):
                key = f"{name}:position"         # the voting rule's j
            if key == default:
                key = next((row for at, row in BRANCH_AT.get(attr, ())
                            if len(args) > max(at) and all(isinstance(
                                args[i], torch.Tensor) for i in at)), key)
            if attr == "solid_table":   # the K16 calls' key on this path
                key = next((k for k in PATHS.get(self.phase, ())
                            if k.startswith("weak_windows")), key)
            # the streamed join's rows prefer a later entry block (a
            # table and slab of global ids from base > 0) and a query
            # chunk after the first, then the most input elements
            rank = (size,)
            if key == "window_variants:position":
                # the position nearest the window's middle
                rank = (-abs(2 * args[2] - (args[1] - 1)), size)
            elif key == "vote_windows:routed":
                rank = (args[2], size)      # the last position's votes
            if name == "seed_table":
                self.entry_base = args[6] if len(args) > 6 else 0
                rank = (self.entry_base > 0, size)
            elif name == "probe_join":
                rank = (self.entry_base > 0,
                        (args[8] if len(args) > 8 else 0) > 0, size)
            row = (key if KERNEL_INFO[key][2] == self.phase
                   else f"{key}:{self.phase}")
            kept = self.args.get(row)
            # the directory alone is no K2 call: its launch counts, and the
            # K2 row takes other inputs (see phase 2); K16's table alike
            keep = self.keeping and row in KERNEL_INFO and (
                attr not in self.BUILDS) and (
                kept is None or rank > kept[0])
            if keep:        # copied before the call: some update in place
                self._drop(row)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                copies = [self.copies.copy(a) if isinstance(
                    a, torch.Tensor) else (a, None, None) for a in args]
                torch.cuda.synchronize()
                self.copies.copy_s += time.perf_counter() - t0
                kept = [c[0] for c in copies]
                handles = [c[1] for c in copies if c[1] is not None]
                dtypes = [(getattr(a, "dtype", None), c[2])
                          for a, c in zip(args, copies)]
            before = self.kernels.LAUNCHES[name]
            out = fn(*args, **kw)
            self.launches[key] += self.kernels.LAUNCHES[name] - before
            self.calls[key] += args[0].numel() > 0
            if keep:
                if name == "overlap_join" and len(args) > 8 and callable(
                        args[8]):
                    kept[8] = out[0].shape[0]   # the slots a rule let in
                self.args[row] = (rank, tuple(kept), handles, dtypes)
            return out

        return call

    def _drop(self, row: str) -> None:
        if row in self.args:
            for h in self.args.pop(row)[2]:
                self.copies.free(h)

    def inputs(self, row: str) -> tuple:
        """The kept arguments of ``row`` as tensors of PyTorch's own (the
        raw copies are freed)."""
        args = self.peek(row)
        self._drop(row)
        return args

    def peek(self, row: str) -> tuple:
        """The kept arguments of ``row`` as tensors of PyTorch's own; the
        raw copies stay."""
        import torch

        _, kept, _, dtypes = self.args[row]
        out = []
        for a, (dtype, tail) in zip(kept, dtypes):
            if isinstance(a, torch.Tensor):
                a = a.to("cuda", dtype, copy=True)
                if tail is not None:
                    a = torch.cat([a, torch.full((tail[0],), tail[1],
                                                 dtype=dtype, device="cuda")])
            out.append(a)
        return tuple(out)

    def reset_launch_counts(self, phase: str) -> None:
        """Counts to 0, for the path of ``phase``; PyTorch's cached
        memory goes back to the card, so the kept copies have room."""
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        self.kernels.reset_launch_counts()
        self.launches = dict.fromkeys(self.launches, 0)
        self.calls = dict.fromkeys(self.calls, 0)
        self.phase = phase
        c = self.copies
        self.since = (c.kept, c.kept_host, c.copy_s)

    def copies_note(self) -> str:
        """What keeping phase 2's inputs added since the last reset: bytes
        on the card and in host memory (past DEVICE_BUDGET) and the host
        seconds of the copies, which fall inside the stages' times and
        their device splits."""
        c = self.copies
        return (f"kernel inputs kept for phase 2 during this run: "
                f"{(c.kept - self.since[0]) / 2**30:.3f} GiB to the card, "
                f"{(c.kept_host - self.since[1]) / 2**30:.3f} GiB to the "
                f"host, {c.copy_s - self.since[2]:.3f} s of copies")

    def path_launches(self, path: str) -> dict:
        """Launches by key since the last reset; raises unless every
        kernel of ``path`` launched and the counts add up to the
        wrappers' own."""
        if sum(self.launches.values()) != sum(self.kernels.LAUNCHES.values()):
            raise AssertionError(f"launch counts {self.kernels.LAUNCHES} "
                                 f"do not add up to {self.launches}")
        for key in PATHS[path]:
            if self.launches[key] == 0:
                raise AssertionError(f"kernel {key} not launched on the "
                                     f"path of phase {path}")
        # K4 and K11: one launch a call; one contraction a path
        for key in self.launches:
            if key.startswith(("pointer_jump", "merge_runs")) and (
                    self.launches[key] != self.calls[key]):
                raise AssertionError(f"{key}: {self.launches[key]} launches "
                                     f"in {self.calls[key]} calls")
        jumps = [self.launches[k] for k in _JUMPS]
        if _JUMPS[0] in PATHS[path] and jumps != [2, 1, 1]:
            raise AssertionError(f"phase {path}: pointer_jump launches "
                                 f"{jumps} (none, min, add), not [2, 1, 1]")
        return dict(self.launches)

    def close(self) -> None:
        for attr, fn in self.originals.items():
            setattr(self.kernels, attr, fn)


def valid_windows(lengths, N: int, P: int, k: int) -> int:
    """The windows of N reads of P windows each that lie inside their
    read: sum(clamp(len - (k - 1), 0, P)), or N * P without lengths."""
    if lengths is None:
        return N * P
    return int((lengths.long() - (k - 1)).clamp(0, P).sum())


def work(key: str, args: tuple, total=0):
    """(bytes moved, integer operations) of one call: each input read
    once and each output written once; operations counted from this
    call's shapes and, for ragged reads, from their lengths. ``total``:
    the candidates (K3, K10), marks set (K7) or unique keys (K11) of
    the call, or for K5 its vote_pairs."""
    name = key.split(":")[0]
    if key == "seed_rows:stacked":
        reads2, _, s, g, n_pos, trim = args
        M, L = reads2.shape
        n = M * (g + n_pos)
        Wt = -(-(L - g) // 16) - trim
        # codes and flags in; every row's payload, and the whole buffer's
        # keys and ids (live and dead) out; the row build and the sort of
        # the whole buffer
        return (reads2.numel() * 4 + M + n * (Wt + 2) * 4 + n * 12,
                n * (Wt + 4) * 3 + n * max(1, math.ceil(math.log2(n + 1)))
                * 2)
    if key == "overlap_join:stacked":
        s_keys, _, payload, _, _, _, _, _, capacity = args
        n, W = s_keys.numel(), payload.shape[1]
        # the buffer's keys and ids and the payload in; exactly
        # `capacity` slots (13 bytes) out
        return (n * 12 + payload.numel() * 4 + capacity * 13,
                n * 8 + total * (6 * (W - 2) + 22))
    if name == "route_rows":
        rows, _, _, owner, keys, _, valid, answers = route_args(args)
        Q, K = rows.shape
        src = 4 if owner is not None else 8
        flag = 0 if valid is None else 1
        # rows that are the keys themselves: the scatter hashes its rows
        same = (keys is not None and K == 2 and Q > 0
                and rows.data_ptr() == keys.data_ptr())
        # the owner source and flags read by the histogram and the
        # scatter, each row read once and each accepted row written once;
        # the two-way mode writes dest, rank and sent_ok; a hash and a
        # rank an input
        return (Q * (src + flag) + Q * ((0 if same else src) + flag)
                + Q * K * 4 + total * K * 4 + (Q * 9 if answers else 0),
                Q * 24)
    if key == "routed_gather":
        back, dest, _, _, offsets, pos, valid = args
        Q0 = dest.numel()
        Q = Q0 if pos is None else pos.numel()
        A, K = back.shape
        # pos and valid in, the inputs' dest/rank/sent_ok and the answer
        # rows each at most once, the answers out
        return (Q * (4 if pos is not None else 0) + (
            Q if valid is not None else 0) + min(Q, Q0) * 9
            + min(Q, A) * K * 4 + offsets.numel() * 8 + Q * K * 4, Q * 8)
    if key == "routed_gather:heads":
        s_key = args[0]
        Q = s_key.numel()
        # sorted keys and positions in, uniq and pos_of_orig out; a
        # compare, a max and two selects a request (a warp's look at the
        # 32 keys before a tile of 1,024, or its 32-way search, for the run
        # that enters the tile: under one operation a request)
        return Q * 20, Q * 4
    if key == "routed_gather:gather":
        idx, _, *tables = args
        R, K = idx.numel(), len(tables)
        v_d = tables[0].numel()
        # the requests in, each table row at most once, the answers out
        return R * 4 + min(R, v_d) * K * 4 + R * K * 4, R * 4
    if key == "reduce_requests:rows":
        import torch

        ss_key, vbase, v_d = args
        # the keys up to the table's end in (the padding after them is not
        # needed), the table out; a shift and two compares a key
        end = torch.tensor([(vbase + v_d) << 32], device=ss_key.device)
        E = int(torch.searchsorted(ss_key, end))
        return E * 8 + (v_d + 1) * 8, E * 3
    if key == "reduce_requests":
        ss_key, _, req, cand_cap, row = args[:5]
        R, E = req.shape[0], ss_key.numel()
        C = min(total, cand_cap)
        steps = run_steps(row)
        # the requests in, the table's starts of their vertices (at most
        # the table), the adjacency rows the candidates read (12 bytes
        # each, at most the adjacency), the candidates and flags out; a
        # binary search a request in its vertex's run
        return (R * 16 + table_bytes(row, 2 * R) + min(C, E) * 12 + C * 13,
                R * steps * 4 + C * 6)
    if key.startswith("reduce_requests:probe"):
        src, _, _, cand, read_len, _, row = args[:7]
        E, C = src.numel(), cand.shape[0]
        steps = run_steps(row)
        # the candidates in, the table's starts of their vertices, the
        # probed edge rows (at most the edges) and their vertices' lengths
        # (at most the shard's), the marks out; a binary search a
        # candidate in its vertex's run
        lens = (min(C, read_len.numel()) * 4 if hasattr(read_len, "numel")
                else 0)
        return (C * 12 + table_bytes(row, 2 * C) + min(C, E) * 12 + lens
                + E, C * steps * 6)
    if key == "vote_windows:routed":
        votes, counts, _, k, _, lengths = args
        N, P = counts.shape[:2]
        W = valid_windows(lengths, N, P, k)
        # each valid window's 4 counts in, the vote word of its base read
        # and written (a window past its read's end reads neither); 4
        # compares and a pack a window
        return (W * 24 + (0 if lengths is None else N * 4), W * 8)
    if key == "vote_windows:apply":
        reads, votes = args
        # codes and votes in, codes out; the rule's compares a base
        return reads.numel() * 8 + votes.numel(), reads.numel() * 12
    if key in ("window_variants", "window_variants:position"):
        reads, k = args[:2]
        N, L = reads.shape
        NP = N * (L - k + 1)
        return reads.numel() * 4 + NP * 32, NP * (6 * k + 24)
    if key in ("window_variants:verdicts", "window_variants:ragged"):
        reads, counts, k = args[:3]
        lengths = args[5] if len(args) > 5 else None
        N, P = counts.shape[:2]
        W = valid_windows(lengths, N, P, k)
        # every base in and out; each valid window's 4 counts in (a base
        # past its read's last window reads none); the rule a window
        return (reads.numel() * 8 + W * 16
                + (0 if lengths is None else N * 4), W * 24)
    if key == "kmer_keys":
        reads, k = args
        N, L = reads.shape
        NP = N * (L - k + 1)
        return reads.numel() * 4 + 3 * NP * 8, NP * k * 6
    if key == "lookup_counts":
        table, counts, queries = args
        T, Q = table.numel(), queries.numel()
        steps = max(1, math.ceil(math.log2(T + 1)))
        return T * 12 + Q * 12, Q * steps * 4
    if name == "overlap_join":
        s_keys, s_rows, payload = args[:3]
        contained = args[7] if len(args) > 7 else None
        entries = args[9] if len(args) > 9 else None   # a streamed slab's
        W = payload.shape[1]
        n = s_keys.numel()
        marks = 0 if contained is None else contained.numel()
        pay = payload.numel() + (0 if entries is None else entries.numel())
        perm = args[12] if len(args) > 12 else None     # the meshed join's
        return (n * 12 + pay * 4 + total * 13 + marks
                + (0 if perm is None else perm.numel() * 8),
                n * 8 + total * (6 * (W - 2) + 22))
    if key.startswith("pointer_jump"):
        p, val, op, steps = args
        per = 8 if op == "none" else 16
        return p.numel() * per * steps, p.numel() * 2 * steps
    if name == "vote_windows":
        reads, table = args[:2]
        lengths = args[5] if len(args) > 5 else None
        n_windows, pairs, _ = total         # vote_pairs(args)
        # reads in and out, lengths, the table's keys and counts once;
        # a lookup of each valid window's own key and of the three
        # variant keys of each pair the skip leaves, LOOKUP_OPS each
        return (reads.numel() * 8 + table.numel() * 12
                + (0 if lengths is None else lengths.numel() * 4),
                (n_windows + 3 * pairs) * LOOKUP_OPS)
    if name == "reduce_counts":
        keys, src, dst, ovl, V, read_len = args
        E = keys.numel()
        real = int((src != 2**31 - 1).sum())
        lens = read_len.numel() * 4 if hasattr(read_len, "numel") else 0
        # the real rows' keys and edge arrays in (the padding rows after
        # them need not be read: the sorted order puts them last), the
        # tables and every count out; a shift and two compares a key for
        # the row table, and the counts' reads of the dst runs
        return (real * 8 + real * 12 + (3 * V + 1) * 4 + E * 4 + lens,
                real * 3 + run_count_ops(keys, src, dst, ovl, V, read_len))
    if name == "reduce_marks":
        return marks_work(args, total)
    if name == "canonical_reads":
        reads, lengths, rc_only, words_only = (tuple(args) + (
            None, False, False))[:4]
        N, L = reads.shape
        W = -(-L // 16)
        rows = 0 if words_only else reads.numel() * 4
        words = 0 if rc_only else N * W * 16 + N
        # codes (and lengths) in; the RC rows, where asked for, out; the
        # two word rows and a flag, where asked for, out; a shift and an
        # or per base for each of the two packings, three operations a
        # base of a row
        return (reads.numel() * 4 + rows + words
                + (0 if lengths is None else N * 4),
                (0 if rc_only else reads.numel() * 4)
                + (0 if words_only else reads.numel() * 3))
    if name == "seed_table":
        words0, valid, _, _, g = args[:5]
        m, W = words0.shape
        n, nb = m * g, 1 << args[5]
        # words and flags in; the bucket table and the slab out; a key
        # built, sorted and decoded per entry
        return (words0.numel() * 8 + m + nb * 8 + n * (W + 1) * 4,
                n * (40 + 2 * W))
    if name == "probe_join":
        words0, valid, table, slab, _, _, g, pa = args[:8]
        m, W = words0.shape
        Q = m * -(-pa // g)
        steps = max(1, math.ceil(math.log2(Q + 1)))
        # words, flags, the probed table rows and candidate slab rows in
        # (each at most once); 13 bytes a candidate out
        return (words0.numel() * 8 + m + min(Q, table.shape[0]) * 8
                + min(total, slab.shape[0]) * (W + 1) * 4 + total * 13,
                Q * 12 + total * (steps * 4 + W * 8 + 20))
    if name == "merge_runs":
        keys, weights = args[0], args[1] if len(args) > 1 else None
        n = keys.numel()
        # keys (and weights) in; each unique key and its sum out
        return (n * 8 + (0 if weights is None else n * 4) + total * 12,
                n * 4)
    if name == "dedup_reads":
        reads, lengths, _, fwd_w = args[:4]
        N, L = reads.shape
        lens = 0 if lengths is None else N * 4
        n_keys = -(-(2 * L + (0 if lengths is None else L.bit_length()))
                   // 64)
        # the canonical words (one of the two), the flags and lengths
        # in; the unique rows (their codes are the sorted words'),
        # multiplicities, vertices and lengths out; a comparison of each
        # key at each of log2 N levels of the sort
        return (fwd_w.numel() * 8 + N + lens + N * (L * 4 + 8) + lens,
                N * n_keys * max(1, math.ceil(math.log2(N))) * 2)
    if name == "seed_rows":
        reads2, valid2, lengths, s, g, n_pos, trim = args[:7]
        rows = args[8] if len(args) > 8 else "all"
        prior = args[9] if len(args) > 9 else None
        M, L = reads2.shape
        Rw = {"all": g + n_pos, "entries": g, "queries": n_pos}[rows]
        n = M * Rw
        n_prior = 0 if prior is None else prior.numel()
        Wt = -(-(L - g) // 16) - trim
        sorted_rows = 0 if rows == "entries" else total
        # codes, flags and lengths (and a slab's keys and ids) in; every
        # built row's payload and the live rows' keys and ids out; two
        # shifts and an or a payload word, and the sort's comparisons of
        # the live keys (none for an unsorted slab)
        return (reads2.numel() * 4 + M + (0 if lengths is None else M * 4)
                + n_prior * 12 + n * (Wt + 2) * 4 + total * 12,
                n * (Wt + 4) * 3 + sorted_rows
                * max(1, math.ceil(math.log2(sorted_rows + 1))) * 2)
    if name == "prune_table":
        keys, counts = args[:2]
        T = keys.numel()
        # the table in, the kept entries out; a compare a count
        return T * 12 + total * 12, T * 2
    if name == "weak_windows":
        reads, lengths, table = args[:3]
        k = args[5]
        N, L = reads.shape
        n_windows = N * (L - k + 1)
        # codes, lengths and the table (keys and counts) in, the weak
        # windows' indices out; a lookup of every window's canonical key
        return (reads.numel() * 4 + (0 if lengths is None else N * 4)
                + table.numel() * 12 + total * 8,
                n_windows * (LOOKUP_OPS + 2 * k))
    if name == "fix_windows":
        reads, widx, table = args[:3]
        k = args[5]
        # codes and the table in, the indices in, the copy out; the 4
        # variant lookups of each weak window
        return (reads.numel() * 8 + widx.numel() * 8 + table.numel() * 12,
                widx.numel() * (4 * LOOKUP_OPS + 3 * k))
    if key.startswith("chain_links"):
        if key == "chain_links:cut":
            p = args[0]
            # p, pf, m in; p' and d0 out (the few breakers' edits aside)
            return p.numel() * 20, p.numel() * 6
        src, V = args[0], args[3]
        n_real = int((src != 2**31 - 1).sum())
        # the edge rows' src in (a padding row needs no more), a real
        # edge's dst and ovl; degrees, links and parents out; 2 atomics
        # and 3 stores an edge, the masks a vertex
        return (src.numel() * 4 + n_real * 8 + V * 20,
                src.numel() + n_real * 6 + V * 10)
    if name == "longest_edges":
        ok, capacity = args[0], args[6]
        n = ok.numel()
        # the candidates in, the padded edges out; the sort's comparisons
        return (n * 13 + capacity * 12,
                n * max(1, math.ceil(math.log2(n + 1))) * 2)
    tbl = args[0]                                   # gather_along
    return tbl.numel() * 12, tbl.numel() * 2


def route_args(args: tuple) -> tuple:
    """A route_rows call's positional arguments with their defaults:
    (rows, n, cap, owner, keys, flip, valid, answers)."""
    return tuple(args) + (None, None, False, None, True)[len(args) - 3:]


def key_rows_alias(args: tuple) -> tuple:
    """A route_rows call whose rows were its int64 keys (a lookup's
    ``_key_rows``), as the path made it: the kept copies of the two are
    apart, so the rows become a view of the keys again."""
    import torch

    rows, keys = args[0], route_args(args)[4]
    if keys is None or rows.shape[1] != 2:
        return args
    alias = keys.view(torch.int32).reshape(-1, 2)
    return (alias, *args[1:]) if torch.equal(rows, alias) else args


def split_ms(fn, reps: int = 5) -> dict:
    """Median device milliseconds of each part of ``fn(split)``, a
    utils.metrics.DeviceSplit a run (CUDA events between the parts),
    after one warm-up."""
    import torch

    from sage2_tpu_torch.utils.metrics import DeviceSplit

    fn(None)
    runs = []
    for _ in range(reps):
        split = DeviceSplit("cuda")
        fn(split)
        torch.cuda.synchronize()
        runs.append(split.ms())
    return {part: statistics.median(r[part] for r in runs)
            for part in runs[0]}


def run_steps(row) -> int:
    """Steps of a binary search in a vertex's run of K21's row table (the
    longest run)."""
    longest = int((row[1:] - row[:-1]).max()) if row.numel() > 1 else 0
    return max(1, math.ceil(math.log2(longest + 1)))


def run_count_ops(keys, src, dst, ovl, V: int, read_len) -> int:
    """Operations of K6's edge launch on this call's data: 10 a real edge,
    and for each edge whose bound maxsl[src] - (len(src) - ovl) is not
    negative the reading of its dst's run: 32 a 16-byte chunk of the
    8-bit copy for a run of up to 128 rows, else 4 a step of a bisection
    (ceil(log2(run + 1)) steps; a bound past 254 bisects too)."""
    import torch

    real = src != 2**31 - 1
    if not keys.numel() or not bool(real.any()):
        return 0
    vk = torch.arange(V + 1, dtype=torch.int64, device=keys.device) << 32
    row = torch.searchsorted(keys, vk)
    run = row[1:] - row[:-1]
    last = keys[(row[1:] - 1).clamp(min=0)] & 0xFFFFFFFF
    maxsl = torch.where(run > 0, last, -1)
    v = src[real].long()
    n = read_len[v].long() if hasattr(read_len, "numel") else read_len
    bound = maxsl[v] - (n - ovl[real].long())
    w = dst[real].long()
    chunks = ((row[1:] + 15) >> 4) - (row[:-1] >> 4)
    steps = torch.ceil(torch.log2(run.double() + 1)).long()
    per = torch.where((run[w] <= 128) & (bound < 255), chunks[w] * 32,
                      steps[w] * 4)
    return int(per[bound >= 0].sum()) + int(real.sum()) * 10


def table_bytes(row, reads: int) -> int:
    """Bytes of K21's row table that ``reads`` lookups read: each start
    at most once."""
    return min(reads, row.numel()) * 8


# operations a count-table lookup is counted at in K5's bound, whatever
# the search: a key's bucket (subtract, shift, compare), its two
# directory entries, two compare-and-step rounds of a search in the
# bucket, and the verdict
LOOKUP_OPS = 16


def vote_pairs(args: tuple, rows_per_chunk: int = 1 << 18):
    """(valid windows, pairs the skip leaves, all pairs) of a K5 call's
    inputs, by torch ops: a (window w, position j) pair of a valid window
    is looked up (three variant keys) only where its base w + j has a
    weak valid covering window (its own key counted below the
    threshold); all pairs are the valid windows times k."""
    import torch

    from sage2_tpu_torch.kernels import plain

    reads, table, counts, k, threshold = args[:5]
    lengths = args[5] if len(args) > 5 else None
    N, L = reads.shape
    P = L - k + 1
    dev = reads.device
    p = torch.arange(L, device=dev)
    lo = (p - k + 1).clamp(min=0)
    n_windows = pairs = total = 0
    for r0 in range(0, N, rows_per_chunk):
        r = reads[r0 : r0 + rows_per_chunk]
        n = r.shape[0]
        ln = (torch.full((n,), L, device=dev) if lengths is None
              else lengths[r0 : r0 + rows_per_chunk].long())
        pv = (ln - k + 1).clamp(min=0, max=P)[:, None]
        valid = torch.arange(P, device=dev)[None, :] < pv
        canon = plain.kmer_keys(r, k)[2]
        weak = (plain._count_of(table, counts, canon) < threshold) & valid
        zero = torch.zeros((n, 1), dtype=torch.int64, device=dev)
        wsum = torch.cat([zero, torch.cumsum(weak.long(), 1)], 1)
        hi = torch.minimum(p[None, :], pv - 1)           # (n, L)
        lo2 = lo[None, :].expand(n, L)
        cover = (hi - lo2 + 1).clamp(min=0)
        hi1 = (hi + 1).clamp(min=0)
        n_weak = wsum.gather(1, hi1) - wsum.gather(1, lo2.clamp(max=P))
        n_weak = torch.where(cover > 0, n_weak, 0)
        n_windows += int(valid.sum())
        pairs += int(torch.where(n_weak > 0, cover, 0).sum())
        total += int(cover.sum())
    return n_windows, pairs, total


def marks_work(args: tuple, n_marked: int):
    """(bytes, operations) that K7's slot range [j0, j1) needs on these
    inputs: the edges whose expansions hold the slots (offsets, src,
    dst, ovl and start of dst: 24 bytes each), the distinct (src, sl)
    rows they expand into (ss_sl, ss_dst: 8 bytes each), the
    (src, dst)-order runs of their sources searched for membership (dst,
    ovl: 8 bytes a row, startd) and one byte per mark set; two binary
    searches a slot. The lengths of ragged reads cancel in the marks'
    test, so they are not counted."""
    import torch

    (_, offsets, src, dst, _, _, _, start, startd, _, j0, j1) = args
    E = src.numel()
    bounds = torch.searchsorted(
        offsets, torch.tensor([j0, j1 - 1], device=offsets.device),
        right=True)
    e_lo, e_hi = (int(b) for b in bounds)
    e = slice(e_lo, e_hi + 1)
    before = offsets[e_lo - 1] if e_lo else offsets.new_zeros(())
    counts = torch.diff(offsets[e], prepend=before.reshape(1))
    first = start[dst[e].long()].long()
    cover = torch.zeros(E + 1, dtype=torch.int32, device=src.device)
    cover.index_add_(0, first, torch.ones_like(first, dtype=torch.int32))
    cover.index_add_(0, first + counts,
                     -torch.ones_like(first, dtype=torch.int32))
    n_rows = int((torch.cumsum(cover, 0) > 0).sum())
    v_lo, v_hi = int(src[e_lo]), int(src[e_hi])
    run_rows = int(startd[v_hi + 1] - startd[v_lo])
    n_e = e_hi - e_lo + 1
    max_deg = int((startd[1:] - startd[:-1]).max())
    steps = (max(1, math.ceil(math.log2(E + 1)))
             + max(1, math.ceil(math.log2(max_deg + 1))))
    n_v = v_hi - v_lo + 2       # startd
    nbytes = n_e * 24 + n_rows * 8 + run_rows * 8 + n_v * 4 + n_marked
    return nbytes, (j1 - j0) * (steps * 4 + 20)


def max_abs_err(a, b) -> float:
    """Largest absolute difference between two outputs (a tensor, or a
    tuple of tensors and ints)."""
    import torch

    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    worst = 0.0
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            if x != y:
                return float("inf")
        elif isinstance(x, torch.Tensor):
            if x.shape != y.shape:
                return float("inf")
            # the float64 difference only where they differ: it takes
            # four times an int32 output's memory
            if x.numel() and not torch.equal(x, y):
                d = (x.to(torch.float64) - y.to(torch.float64)).abs().max()
                worst = max(worst, float(d))
        elif x != y:
            worst = max(worst, abs(float(x) - float(y)))
    return worst


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.config import AssemblyConfig
    from sage2_tpu_torch import pipeline
    from sage2_tpu_torch.data import (
        simulate_genome,
        simulate_ragged_reads,
        simulate_reads,
    )
    from sage2_tpu_torch.graph import flow_native, reduce_native
    from sage2_tpu_torch.graph.reduce import transitive_reduction_auto
    from sage2_tpu_torch.kernels import plain
    from sage2_tpu_torch.overlap import find_overlaps_auto
    from sage2_tpu_torch.pipeline import assemble
    from sage2_tpu_torch.utils.metrics import MetricsLog
    from sage2_tpu_torch.utils.stats import genome_fraction

    # --- phase 0: the card ---------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")
    phase("0 card", t0)

    dev = torch.device("cuda")

    # --- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    kernels.load_all()
    reduce_native._load()
    if not flow_native.available():
        raise RuntimeError("native flow solver did not build")
    phase("1 build", t0, kernels=len(kernels.KERNELS))
    capture = Capture(kernels)

    # phase 2's rows (run as phases 2a and 2b for EARLY_PATHS after phases
    # 13 and 14, as phase 2 for the rest at the end)
    rows = []

    def kern(name):
        """A wrapper of ``kernels`` as it is, not Capture's (phase 2a runs
        while Capture wraps them)."""
        return capture.originals.get(name) or getattr(kernels, name)

    def check_rows(label, selected):
        """Phase 2's rows of ``selected`` (KERNEL_INFO items): each held
        against its plain version, timed, its bound computed; appended to
        ``rows``. Each row's kept inputs are freed after it."""
        t0 = time.perf_counter()
        say(f"card before phase {label}: {card_state()}")
        # K2's rows first, then the derived rows: they read other rows'
        # inputs
        order = sorted(selected, key=lambda item: (
            not base_key(item[0]).startswith("lookup_counts"),
            item[0] not in DERIVED))
        for row, (source, replaces, path) in order:
            t1 = time.perf_counter()
            key = base_key(row)
            name = key.split(":")[0]
            # K2 on a path whose lookups K16/K17 make: only its directory ran
            k2_dir = name == "lookup_counts" and path not in MESH_PATHS
            if k2_dir:
                args = k2_inputs(capture, path)
            elif row in DERIVED:
                args = derived_inputs(row, capture.peek(DERIVED[row]), kern)
            else:
                args = capture.inputs(row)      # freed after its row
            if key == "longest_edges:deferred":
                args = with_duplicates(args)
            if name == "route_rows":
                args = key_rows_alias(args)
            fn = WRAPPER.get(key, name)
            wrapper = kern(fn)
            ref = getattr(plain, fn)
            if fn == "longest_edges":   # a shard's sources only split K14's
                ref = (lambda *a, _ref=ref: _ref(*a[:7]))   # buckets

            # reduce_marks, overlap_join (its containment marks) and the cut
            # (nxt, ovl_next) update an argument in place: the kernel takes a
            # copy of the inputs, the plain version the inputs themselves, and
            # the two must end equal
            a_got = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args)
            if name == "route_rows":    # reads only; keeps the keys' alias
                a_got = args
            a_want = args
            unmarked = args[0].clone() if name == "reduce_marks" else None
            got = wrapper(*a_got)
            want = ref(*a_want)
            torch.cuda.synchronize()
            err = max(max_abs_err(got, want), max_abs_err(a_got, a_want))
            if err != 0:
                raise AssertionError(f"{row}: kernel differs from its plain "
                                     f"version (max abs err {err})")
            if name in ("overlap_join", "probe_join"):
                total = int(got[4])
            elif name == "reduce_marks":            # marks this range sets
                total = int((got != unmarked).sum())
            elif name == "merge_runs":              # unique keys
                total = got[0].numel()
            elif name == "vote_windows" and key not in _ROUTED_VOTE:
                total = vote_pairs(args)            # the lookups it needs
            elif name == "dedup_reads":             # unique reads
                total = got[3]
            elif key == "seed_rows:stacked":        # live seed rows
                total = int(got[3])
            elif name == "seed_rows":
                total = got[0].numel()
            elif name == "longest_edges":           # edges kept
                total = int(got[3])
            elif name == "prune_table":             # entries kept
                total = got[0].numel()
            elif name == "weak_windows":            # weak windows
                total = got.numel()
            elif name == "route_rows":              # rows accepted
                total = sum(got.counts)
            elif key == "reduce_requests":          # candidates expanded
                total = got[2]
            else:
                total = 0
            heavy = name in ("vote_windows", "weak_windows") and (
                key not in _ROUTED_VOTE)
            ms = time_ms(lambda: wrapper(*args), reps=3 if heavy else 5)
            plain_ms = time_ms(lambda: ref(*args), reps=1 if heavy else 3)
            library_ms, library = library_time(key, args)
            nbytes, ops = work(key, args, total)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / OPS_PER_S * 1e3
            n_launches = launches_by_key[path][DERIVED.get(row, key)]
            rows.append({
                "name": row, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms,
            })
            shape = [tuple(a.shape) for a in args
                     if isinstance(a, torch.Tensor)]
            per_step = ""
            if row in DERIVED:
                rows[-1]["launches_of"] = (f"{DERIVED[row]} on phase {path}"
                                           " (inputs made from its row's)")
            if name == "lookup_counts":         # K2's first launch alone
                if k2_dir:      # the path's K2 launches: directory launches
                    rows[-1]["launches_of"] = "bucket directory"
                rows[-1]["index_ms"] = time_ms(
                    lambda: kern("lookup_directory")(args[0], args[1]))
                per_step = (f", of which the bucket directory "
                            f"{rows[-1]['index_ms']:.3f} ms")
            elif name == "vote_windows" and key not in _ROUTED_VOTE:
                # K5's first launch; the skip
                rows[-1]["index_ms"] = time_ms(
                    lambda: kern("lookup_directory")(args[1], args[2],
                                                     "vote_windows"))
                n_windows, pairs, all_pairs = total
                rows[-1]["pair_share"] = pairs / max(all_pairs, 1)
                per_step = (f", of which the bucket directory "
                            f"{rows[-1]['index_ms']:.3f} ms; the path's "
                            f"first voting round's input (round 1): "
                            f"{n_windows} valid windows, {pairs} of "
                            f"{all_pairs} (w, j) pairs left by the skip "
                            f"({rows[-1]['pair_share']:.4f})")
            elif name == "weak_windows":    # the round's membership table
                reads, _, table, counts, directory, k, threshold = args
                if kernels.solid_bits(table.numel(), k) is not None:
                    spare = directory.clone()
                    rows[-1]["build_ms"] = time_ms(lambda: kern(
                        "solid_table")(table, counts, k, threshold, spare))
                    per_step = (f", the round's membership table built in "
                                f"{rows[-1]['build_ms']:.3f} ms")
                    del spare
                else:
                    per_step = ", no membership table (K2's directory)"
            elif name == "prune_table":
                # the bare launch behind a spin; the call and the library
                # call behind it too, each with its host read
                keys, counts, threshold = args
                rows[-1].update(
                    device_ms=device_ms(lambda: kern("prune_table_launch")(
                        *args)),
                    spun_call_ms=device_ms(lambda: wrapper(*args)),
                    library_spun_ms=device_ms(lambda: (
                        torch.masked_select(keys, counts >= threshold),
                        torch.masked_select(counts, counts >= threshold))),
                    copy_ms=time_ms(lambda: (got[0].clone(),
                                             got[1].clone())))
                per_step = (f"; the launch on the device behind a spin "
                            f"{rows[-1]['device_ms']:.4f} ms; behind the "
                            f"spin with their host reads of the kept count: "
                            f"the call {rows[-1]['spun_call_ms']:.4f} ms, "
                            f"masked_select "
                            f"{rows[-1]['library_spun_ms']:.4f} ms; a "
                            f"copy of the kept entries to their own size "
                            f"(not made: the outputs are views) "
                            f"{rows[-1]['copy_ms']:.4f} ms")
            elif key == "routed_gather:heads":
                # the launch behind a spin; torch.sort of the same
                # requests, which the caller runs before it; the floor of
                # the scatter to input order at a 32-byte sector a request
                s_key, s_ord = args
                key_in = torch.empty_like(s_key)
                key_in[s_ord] = s_key
                Q = s_key.numel()
                rows[-1].update(
                    device_ms=device_ms(lambda: wrapper(*args)),
                    sort_ms=time_ms(lambda: torch.sort(key_in, stable=True)),
                    sector_bound_ms=Q * (12 + 4 + 32) / HBM_BYTES_PER_S
                    * 1e3)
                per_step = (f"; on the device behind a spin "
                            f"{rows[-1]['device_ms']:.4f} ms; torch.sort "
                            f"of the requests {rows[-1]['sort_ms']:.4f} ms; "
                            f"bound with a 32-byte sector a scattered "
                            f"store {rows[-1]['sector_bound_ms']:.4f} ms")
                del key_in
            elif key == "reduce_requests:rows":     # the launch alone
                ss_key, vbase, v_d = args
                firsts = (torch.arange(v_d + 1, device=dev) + vbase) << 32
                rows[-1].update(
                    device_ms=device_ms(lambda: wrapper(*args)),
                    library_device_ms=device_ms(
                        lambda: torch.searchsorted(ss_key, firsts)))
                per_step = (f"; device times behind a spin: kernel "
                            f"{rows[-1]['device_ms']:.4f} ms, searchsorted "
                            f"{rows[-1]['library_device_ms']:.4f} ms")
            elif name == "gather_along":    # the launch, no flag read
                out, flag = torch.empty_like(args[0]), torch.zeros(
                    1, dtype=torch.int32, device=dev)

                def bare():
                    kern("gather_along_launch")(*args, out, flag)

                idx64 = args[1].long()
                rows[-1].update(
                    kernel_ms=time_ms(bare), device_ms=device_ms(bare),
                    library_device_ms=device_ms(
                        lambda: torch.gather(args[0], args[2], idx64)))
                per_step = (f", the bare launch "
                            f"{rows[-1]['kernel_ms']:.4f} ms "
                            f"(no flag read); device times behind a spin: "
                            f"kernel {rows[-1]['device_ms']:.4f} ms, gather "
                            f"{rows[-1]['library_device_ms']:.4f} ms")
            elif name == "pointer_jump":        # a whole loop of args[3] steps
                p, val, op, steps = args
                step_ms = time_ms(lambda: torch.index_select(p, 0, p))
                # a grid barrier: the same loop on 4 vertices, less one step
                few = [None if t is None else t[:4].clone() for t in (p, val)]
                few[0].zero_()
                barrier_ms = (
                    time_ms(lambda: wrapper(few[0], few[1], op, steps))
                    - time_ms(lambda: wrapper(few[0], few[1], op, 1))
                ) / max(steps - 1, 1)
                per_step = (f", {steps} steps: {ms / steps:.4f} ms a step "
                            f"(index_select {step_ms:.4f} ms, bound "
                            f"{max(t_bytes, t_ops) / steps:.4f} ms, grid "
                            f"barrier {barrier_ms:.4f} ms)")
            elif name == "route_rows" or key == "reduce_requests":
                # the mode, and each launch's device time (and the host
                # read between them) from a DeviceSplit a run
                parts = split_ms(lambda sp: wrapper(*args, split=sp))
                mode = ("row table" if name != "route_rows" else
                        "two-way" if route_args(args)[7] else "one-way")
                rows[-1].update(mode=mode, launch_ms=parts)
                per_step = f", {mode}: " + ", ".join(
                    f"{p[:-3]} {v:.4f} ms" for p, v in parts.items())
            elif name == "merge_runs" and 2 * total < args[0].numel():
                # what a count table's copy to storage of its own size costs
                # (kmer/count.py count_from_keys, after the kernel)
                copy_ms = time_ms(lambda: (got[0].clone(), got[1].clone()))
                per_step = (f", count_from_keys' copy to exact size "
                            f"{copy_ms:.3f} ms")
            say(f"  {row}: equal, {ms:.3f} ms (plain {plain_ms:.3f} ms"
                + (f", {library} {library_ms:.3f} ms" if library else "")
                + f"), bound {max(t_bytes, t_ops):.3f} ms, launches "
                f"{n_launches}"
                + (" (bucket directory only; the search is built from the "
                   "weak_windows row's inputs)" if k2_dir else "")
                + f" (phase {path}), inputs {shape}" + per_step
                + (f", {total} candidates" if name in ("overlap_join",
                                                       "probe_join") else "")
                + (f", {int(got[4])} duplicate rows" if key ==
                   "longest_edges:deferred" else "")
                + (f", {total} rows accepted" if name == "route_rows" else "")
                + (f", {total} candidates expanded" if key == "reduce_requests"
                   else "")
                + ({"dedup_reads": f", {total} unique reads",
                    "seed_rows": f", {total} live rows",
                    "longest_edges": f", {total} edges",
                    "prune_table": f", {total} solid entries",
                    "weak_windows": f", {total} weak windows"}.get(name, ""))
                + (f", {args[1].numel()} weak windows" if name == "fix_windows"
                   else "")
                + f", check {time.perf_counter() - t1:.1f} s")
            # the row's tensors go, and PyTorch's cache with them, before the
            # next row's inputs come back
            del args, a_got, a_want, got, want, unmarked
            torch.cuda.empty_cache()
        say(f"card after phase {label}: {card_state()}")
        phase(f"{label} kernels vs plain", t0, rows=len(order))

    # --- phase 11: the benches (before anything is kept on the card) ----
    t0 = time.perf_counter()
    bench = run_bench("bench_gpu.py")
    if bench["detail"]["verified_overlaps_shard0"] != SHARD0_VERIFIED:
        raise AssertionError(f"bench_gpu.py: shard 0 verified "
                             f"{bench['detail']['verified_overlaps_shard0']}"
                             f", expected {SHARD0_VERIFIED}")
    e2e = run_bench("bench_e2e_gpu.py")
    stacked = stacked_checks(capture, kernels, dev)
    launches_by_key = {"11": stacked.pop("launches")}
    phase("11 benches", t0, amortized_reads_per_s=bench["value"],
          vs_baseline=bench["vs_baseline"],
          e2e_s=e2e["value"], **stacked)

    # --- inputs (set-up, not part of any phase) -------------------------
    t0 = time.perf_counter()
    s = SHARD0
    g_len = int(s["n_reads"] * s["read_len"] / s["coverage"])
    g0 = simulate_genome(g_len, seed=s["seeds"][0])
    shard0, _ = simulate_reads(g0, read_len=s["read_len"],
                               coverage=s["coverage"],
                               error_rate=s["error_rate"], seed=s["seeds"][1])
    shard0 = shard0[: s["n_reads"]]
    e = ECOLI
    genome = simulate_genome(e["genome_len"], seed=e["seeds"][0])
    reads, _ = simulate_reads(genome, read_len=e["read_len"],
                              coverage=e["coverage"],
                              error_rate=e["error_rate"], seed=e["seeds"][1])
    phase("inputs", t0, shard0_genome=g_len, shard0_reads=shard0.shape[0],
          ecoli_reads=reads.shape[0])

    # --- phase 3: overlap join at the bench's shard 0 -------------------
    t0 = time.perf_counter()
    r0 = torch.from_numpy(shard0.astype(np.int32)).to(dev)
    v0 = torch.ones(r0.shape[0], dtype=torch.bool, device=dev)
    find_overlaps_auto(r0, v0, s["min_overlap"], 32)   # first (cold) run
    torch.cuda.synchronize()
    capture.reset_launch_counts("3")
    runs = []
    for _ in range(3):
        t1 = time.perf_counter()
        res = find_overlaps_auto(r0, v0, s["min_overlap"], 32)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t1)
        if (res.n_candidates, res.n_verified) != (SHARD0_CANDIDATES,
                                                  SHARD0_VERIFIED):
            raise AssertionError(
                f"shard 0: {res.n_candidates} candidates, "
                f"{res.n_verified} verified; expected "
                f"{SHARD0_CANDIDATES}, {SHARD0_VERIFIED}")
    best = min(runs)
    launches = {k: v // 3 for k, v in kernels.LAUNCHES.items()}
    # the same reads as ragged reads of length 100 each: the second
    # call starts from its own memoized capacity, as the fixed calls do
    full = torch.full((r0.shape[0],), s["read_len"], dtype=torch.int32,
                      device=dev)
    for _ in range(2):
        rag = find_overlaps_auto(r0, v0, s["min_overlap"], 32,
                                 lengths=full)
    torch.cuda.synchronize()
    for field in ("src", "dst", "ovl"):
        if not torch.equal(getattr(rag, field), getattr(res, field)):
            raise AssertionError(f"shard 0 with full lengths differs from "
                                 f"the fixed call in {field}")
    if (rag.n_edges, rag.n_candidates, rag.n_verified, rag.overflow) != (
            res.n_edges, res.n_candidates, res.n_verified, res.overflow):
        raise AssertionError(f"shard 0 with full lengths: counts {rag[3:7]}"
                             f" != fixed {res[3:7]}")
    if rag.n_contained != 0 or bool(rag.contained.any()):
        raise AssertionError(f"shard 0: {rag.n_contained} containments "
                             f"among reads of one length")
    phase("3 overlap shard0", t0, n_candidates=res.n_candidates,
          n_verified=res.n_verified, n_edges=res.n_edges,
          best_s=f"{best:.4f}", reads_per_s=f"{s['n_reads'] / best:.0f}",
          launches=json.dumps(launches), full_lengths_equal=True,
          n_contained=rag.n_contained)
    del r0, v0, res, rag, full

    # --- phase 12: the device mesh, four shards on this card ------------
    t0 = time.perf_counter()
    log = MetricsLog(None, echo=False)
    torch.cuda.reset_peak_memory_stats()
    capture.reset_launch_counts("12")
    mesh_contigs, mesh_stats = assemble(
        reads, AssemblyConfig(mesh_shape=(MESH_SHARDS,)), outdir=None,
        metrics=log, device="cuda")
    launches = dict(kernels.LAUNCHES)
    launches_by_key["12"] = capture.path_launches("12")
    report_assembly(f"12 ecoli mesh{MESH_SHARDS}", t0,
                    time.perf_counter() - t0, log, launches, mesh_contigs,
                    mesh_stats, genome, genome_fraction,
                    copies=capture.copies_note())
    peaks = {"12": peak_gib()}
    report_mesh("12", log, peaks["12"])
    got = {k: e2e["detail"][k] for k in ("n50", "n_contigs")}
    if got != {k: mesh_stats[k] for k in got}:
        raise AssertionError(f"phase 12: n50 {mesh_stats['n50']}, n_contigs "
                             f"{mesh_stats['n_contigs']} differ from "
                             f"bench_e2e_gpu.py's {got}")

    # --- phase 13: ragged reads on the mesh, four shards on this card ---
    # (phase 8's reads and configs; run here, as phase 12 is, while few
    # kernel inputs are kept on the card; asserted equal to 8a and 8b
    # after phase 8)
    t0 = time.perf_counter()
    rr = ECOLI_RAGGED
    ragged, lengths = simulate_ragged_reads(
        genome, rr["lo"], rr["hi"], rr["coverage"], rr["error_rate"],
        seed=rr["seed"], contained_frac=rr["contained_frac"])
    phase("8 inputs", t0, reads=ragged.shape[0], width=ragged.shape[1],
          real_bases=int(lengths.sum()),
          coverage=f"{lengths.sum() / len(genome):.2f}")
    # phases 8 and 13: the default config (8a, 13a), and the voting
    # corrector with the device reduction (8b, 13b; the mesh reduces
    # sharded whatever the backend)
    ragged_configs = (("a", AssemblyConfig()), ("b", AssemblyConfig(
        correction_rule="vote_all_windows", reduce_backend="device")))
    meshed = {}
    for part, cfg in ragged_configs:
        label = "13" + part
        t0 = time.perf_counter()
        log = MetricsLog(None, echo=False)
        torch.cuda.reset_peak_memory_stats()
        capture.reset_launch_counts(label)
        contigs, stats = assemble(
            ragged, dataclasses.replace(cfg, mesh_shape=(MESH_SHARDS,)),
            outdir=None, metrics=log, lengths=lengths, device="cuda")
        launches = dict(kernels.LAUNCHES)
        launches_by_key[label] = capture.path_launches(label)
        report_assembly(f"{label} ecoli ragged mesh{MESH_SHARDS}", t0,
                        time.perf_counter() - t0, log, launches, contigs,
                        stats, genome, genome_fraction,
                        copies=capture.copies_note())
        peaks[label] = peak_gib()
        report_mesh(label, log, peaks[label])
        meshed[label] = (contigs, stats, contained_count(log, label))
        say(f"  n_contained={meshed[label][2]}")
        del contigs, stats

    # --- phase 2a: the rows of the paths run so far ---------------------
    # (their kept inputs leave the card before phases 14 and 4-10 keep
    # theirs, so those phases' copies stay on the card and out of their
    # stages' times)
    capture.keeping = False
    check_rows("2a", [item for item in KERNEL_INFO.items()
                      if item[1][2] in EARLY_PATHS
                      and item[1][2] not in STREAM_MESH_PATHS])
    capture.keeping = True

    # --- phase 14: streaming on the mesh, four shards on this card ------
    # (phase 10a's flags: 14a phase 4's reads and config, 14b phase 8's
    # ragged reads and 8a's config; run here, as phases 12 and 13 are;
    # asserted equal to 4 and 8a after those phases)
    for label, cfg, stream_reads, stream_lengths in (
            ("14a", AssemblyConfig(), reads, None),
            ("14b", ragged_configs[0][1], ragged, lengths)):
        t0 = time.perf_counter()
        log = MetricsLog(None, echo=False)
        with tempfile.TemporaryDirectory() as tmp:
            cfg = dataclasses.replace(
                cfg, mesh_shape=(MESH_SHARDS,), max_device_reads=STREAM_CHUNK,
                spill_dir=os.path.join(tmp, "spill"))
            torch.cuda.reset_peak_memory_stats()
            capture.reset_launch_counts(label)
            contigs, stats = assemble(
                stream_reads, cfg, outdir=os.path.join(tmp, "out")
                if stream_lengths is None else None,
                metrics=log, device="cuda", lengths=stream_lengths)
            launches = dict(kernels.LAUNCHES)
            launches_by_key[label] = capture.path_launches(label)
            t_asm = time.perf_counter() - t0
            spilled = sorted(os.listdir(cfg.spill_dir))
        report_assembly(f"{label} ecoli streamed mesh{MESH_SHARDS}", t0,
                        t_asm, log, launches, contigs, stats, genome,
                        genome_fraction,
                        copies=capture.copies_note())
        peaks[label] = peak_gib()
        report_mesh(label, log, peaks[label])
        # 14a gathers its edges into the spill store, shard by shard
        if stream_lengths is None and "edges_src.bin" not in spilled:
            raise AssertionError(f"phase {label}: no edges_src in the spill "
                                 f"store ({spilled})")
        n_contained = (None if stream_lengths is None
                       else contained_count(log, label))
        meshed[label] = (contigs, stats, n_contained)
        say(f"  spill files {spilled}"
            + ("" if n_contained is None else f", n_contained={n_contained}"))
        del contigs, stats

    # --- phase 2b: the streamed mesh's rows ----------------------------
    capture.keeping = False
    check_rows("2b", [item for item in KERNEL_INFO.items()
                      if item[1][2] in STREAM_MESH_PATHS])
    capture.keeping = True

    # --- phase 4: E. coli scale, reads to contigs -----------------------
    t0 = time.perf_counter()
    log = MetricsLog(None, echo=False)
    with tempfile.TemporaryDirectory() as outdir:
        torch.cuda.reset_peak_memory_stats()
        capture.reset_launch_counts("4")
        contigs, stats = assemble(reads, AssemblyConfig(), outdir=outdir,
                                  metrics=log, device="cuda")
        launches = dict(kernels.LAUNCHES)
        launches_by_key["4"] = capture.path_launches("4")
        t_asm = time.perf_counter() - t0
        with open(os.path.join(outdir, "stats.json")) as f:
            json.load(f)
        with np.load(os.path.join(outdir, "edges.npz")) as z:
            edges = (z["src"], z["dst"], z["ovl"])
            n_vertices = z["valid2"].shape[0]
    report_assembly("4 ecoli", t0, t_asm, log, launches, contigs, stats,
                    genome, genome_fraction,
                    copies=capture.copies_note())
    peaks["4"] = peak_gib()
    incore = {"4": (contigs, stats)}
    for label, (m_contigs, m_stats) in (("12", (mesh_contigs, mesh_stats)),
                                        ("14a", meshed.pop("14a")[:2])):
        if m_stats != stats or len(m_contigs) != len(contigs) or any(
                not np.array_equal(a, b) for a, b in zip(m_contigs, contigs)):
            raise AssertionError(f"phase {label}: the meshed assembly "
                                 f"differs from phase 4's")
        say(f"  phase {label}'s meshed assembly equals phase 4's: contigs "
            f"and stats")
    del mesh_contigs, mesh_stats, m_contigs, m_stats
    got = {k: e2e["detail"][k] for k in ("n50", "n_contigs")}
    if got != {k: stats[k] for k in got}:
        raise AssertionError(f"bench_e2e_gpu.py: {got} differs from phase "
                             f"4's n50 {stats['n50']}, n_contigs "
                             f"{stats['n_contigs']}")
    say(f"  bench_e2e_gpu.py's n50 and n_contigs equal phase 4's: {got}")

    # --- phase 5: voting corrector + device reduction -------------------
    t0 = time.perf_counter()
    log = MetricsLog(None, echo=False)
    torch.cuda.reset_peak_memory_stats()
    capture.reset_launch_counts("5")
    contigs, stats = assemble(
        reads, AssemblyConfig(correction_rule="vote_all_windows",
                              reduce_backend="device"),
        outdir=None, metrics=log, device="cuda")
    launches = dict(kernels.LAUNCHES)
    launches_by_key["5"] = capture.path_launches("5")
    report_assembly("5 ecoli vote+device", t0, time.perf_counter() - t0,
                    log, launches, contigs, stats, genome, genome_fraction,
                    copies=capture.copies_note())
    peaks["5"] = peak_gib()
    incore["5"] = (contigs, stats)

    # --- phase 6: device reduction against the native one ---------------
    t0 = time.perf_counter()
    capture.reset_launch_counts("6")    # no row takes this phase's calls
    t1 = time.perf_counter()
    nat = transitive_reduction_auto(*edges, n_vertices, ECOLI["read_len"],
                                    backend="native")
    t_nat = time.perf_counter() - t1
    t1 = time.perf_counter()
    dev_red = transitive_reduction_auto(*edges, n_vertices,
                                        ECOLI["read_len"], backend="device",
                                        device="cuda")
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t1
    for field in ("src", "dst", "ovl"):
        got = getattr(dev_red, field).cpu().numpy()
        if not np.array_equal(got, getattr(nat, field)):
            raise AssertionError(f"device reduction differs from the "
                                 f"native one in {field}")
    if (dev_red.n_edges, dev_red.n_expansions, dev_red.overflow) != (
            nat.n_edges, nat.n_expansions, nat.overflow):
        raise AssertionError(
            f"device reduction n_edges/n_expansions/overflow "
            f"{dev_red[3:]} != native {nat[3:]}")
    phase("6 reduce device vs native", t0, n_edges_in=int(
        np.count_nonzero(edges[0] != 2**31 - 1)), n_edges=nat.n_edges,
        n_expansions=nat.n_expansions, native_s=f"{t_nat:.3f}",
        device_s=f"{t_dev:.3f}", equal=True)
    del nat, dev_red, edges

    # --- phase 7: the Pallas probe's gathers ----------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    capture.reset_launch_counts("7")
    for n, w, axis in PROBE_SHAPES:
        tbl = torch.arange(n * w, dtype=torch.int32, device=dev).reshape(n, w)
        idx = torch.randint(0, n if axis == 0 else w, (n, w), generator=gen,
                            dtype=torch.int32, device=dev)
        kernels.gather_along(tbl, idx, axis)
    torch.cuda.synchronize()
    launches_by_key["7"] = capture.path_launches("7")
    phase("7 probe gathers", t0, shapes=json.dumps(PROBE_SHAPES))

    # --- phase 8: ragged reads at E. coli scale -------------------------
    # (the reads of phase 13's inputs)
    # 8a's reduce-stage input, kept for phase 9
    reduce_input = {}

    def keep_reduce_input(src, dst, ovl, n_vertices, read_len, **kw):
        reduce_input.update(edges=(src, dst, ovl), n_vertices=n_vertices,
                            lens=read_len)
        return transitive_reduction_auto(src, dst, ovl, n_vertices,
                                         read_len, **kw)

    for part, cfg in ragged_configs:
        label, mesh_label = "8" + part, "13" + part
        t0 = time.perf_counter()
        log = MetricsLog(None, echo=False)
        pipeline.transitive_reduction_auto = (
            keep_reduce_input if label == "8a" else transitive_reduction_auto)
        capture.reset_launch_counts(label)
        contigs, stats = assemble(ragged, cfg, outdir=None, metrics=log,
                                  lengths=lengths, device="cuda")
        launches = dict(kernels.LAUNCHES)
        launches_by_key[label] = capture.path_launches(label)
        ragged_launches = {k: v for k, v in launches_by_key[label].items()
                           if k.endswith(":ragged")}
        pipeline.transitive_reduction_auto = transitive_reduction_auto
        n_contained = contained_count(log, label)
        report_assembly(f"{label} ecoli ragged", t0,
                        time.perf_counter() - t0, log, launches, contigs,
                        stats, genome, genome_fraction,
                        copies=capture.copies_note())
        say(f"  n_contained={n_contained} ragged_launches="
            f"{json.dumps(ragged_launches)}")
        incore[label] = (contigs, stats)
        # 13a and 14b (the streamed mesh) are 8a's twins, 13b is 8b's
        for twin in (mesh_label, "14b")[:2 if part == "a" else 1]:
            m_contigs, m_stats, m_contained = meshed.pop(twin)
            if m_stats != stats or m_contained != n_contained or len(
                    m_contigs) != len(contigs) or any(
                    not np.array_equal(a, b)
                    for a, b in zip(m_contigs, contigs)):
                raise AssertionError(f"phase {twin}: the meshed assembly "
                                     f"differs from phase {label}'s")
            say(f"  phase {twin}'s meshed assembly equals phase {label}'s:"
                f" contigs, stats and n_contained {m_contained}")
            del m_contigs, m_stats
        del contigs, stats

    # --- phase 9: ragged device reduction against the native one --------
    t0 = time.perf_counter()
    capture.reset_launch_counts("9")    # no row takes this phase's calls
    edges, V, lens = (reduce_input["edges"], reduce_input["n_vertices"],
                      reduce_input["lens"])
    t1 = time.perf_counter()
    nat = transitive_reduction_auto(*edges, V, lens, backend="native")
    t_nat = time.perf_counter() - t1
    t1 = time.perf_counter()
    dev_red = transitive_reduction_auto(*edges, V, lens, backend="device",
                                        device="cuda")
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t1
    for field in ("src", "dst", "ovl"):
        got = getattr(dev_red, field).cpu().numpy()
        if not np.array_equal(got, getattr(nat, field)):
            raise AssertionError(f"ragged device reduction differs from "
                                 f"the native one in {field}")
    if (dev_red.n_edges, dev_red.n_expansions, dev_red.overflow) != (
            nat.n_edges, nat.n_expansions, nat.overflow):
        raise AssertionError(
            f"ragged device reduction n_edges/n_expansions/overflow "
            f"{dev_red[3:]} != native {nat[3:]}")
    phase("9 ragged reduce device vs native", t0, n_edges_in=int(
        np.count_nonzero(edges[0] != 2**31 - 1)), n_edges=nat.n_edges,
        n_expansions=nat.n_expansions, native_s=f"{t_nat:.3f}",
        device_s=f"{t_dev:.3f}", equal=True)
    del nat, dev_red, edges, reduce_input

    # --- phase 10: streamed beyond device memory ------------------------
    # (label, config, the in-core twin, reads, lengths); 10a and 10c with
    # a spill dir and artifacts
    default = AssemblyConfig(max_device_reads=STREAM_CHUNK)
    voting = AssemblyConfig(correction_rule="vote_all_windows",
                            reduce_backend="device",
                            max_device_reads=STREAM_CHUNK,
                            entry_block_reads=ENTRY_BLOCK)
    streamed = (("10a", default, "4", reads, None),
                ("10b", voting, "5", reads, None),
                ("10c", default, "8a", ragged, lengths),
                ("10d", voting, "8b", ragged, lengths))
    for label, cfg, twin, stream_reads, stream_lengths in streamed:
        t0 = time.perf_counter()
        log = MetricsLog(None, echo=False)
        spill = label in ("10a", "10c")
        with tempfile.TemporaryDirectory() as tmp:
            if spill:
                cfg = dataclasses.replace(
                    cfg, spill_dir=os.path.join(tmp, "spill"))
            torch.cuda.reset_peak_memory_stats()
            capture.reset_launch_counts(label)
            contigs, stats = assemble(
                stream_reads, cfg, outdir=os.path.join(tmp, "out") if
                spill else None, metrics=log, device="cuda",
                lengths=stream_lengths)
            launches = dict(kernels.LAUNCHES)
            launches_by_key[label] = capture.path_launches(label)
            t_asm = time.perf_counter() - t0
            spilled = sorted(os.listdir(cfg.spill_dir)) if cfg.spill_dir \
                else []
        peaks[label] = peak_gib()
        report_assembly(f"{label} ecoli streamed", t0, t_asm, log, launches,
                        contigs, stats, genome, genome_fraction,
                        copies=capture.copies_note())
        want_contigs, want_stats = incore[twin]
        if stats != want_stats or len(contigs) != len(want_contigs) or any(
                not np.array_equal(a, b)
                for a, b in zip(contigs, want_contigs)):
            raise AssertionError(f"phase {label}: streamed assembly differs "
                                 f"from phase {twin}'s in-core one")
        chunks = [r for r in log.records if r["stage"] == "streaming"]
        retries = [r for r in log.records if r["stage"] == "overlap_retry"]
        contained = [r["n_contained"] for r in log.records
                     if r["stage"] == "containment"]
        say(f"  equal to phase {twin}: contigs and stats; streaming "
            f"{json.dumps(chunks[0]['chunk_reads'])} reads a chunk, "
            f"overlap retries {len(retries)}, spill files {spilled}"
            + (f", n_contained {contained[0]}" if contained else ""))
        del contigs, stats
    del ragged, lengths
    capture.close()
    say("peak device memory (GiB, max_memory_allocated): "
        + json.dumps(peaks) + f"; kernel inputs kept for phase 2: "
        f"{capture.copies.kept / 2**30:.3f} GiB on the card, "
        f"{capture.copies.kept_host / 2**30:.3f} GiB on the host")
    del incore

    # --- phase 2: each kernel against its plain version -----------------
    check_rows("2", [item for item in KERNEL_INFO.items()
                     if item[1][2] not in EARLY_PATHS])

    say(f"total {time.perf_counter() - T_START:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_bench(script: str) -> dict:
    """Run a bench of the repo (a sibling of this file) at its defaults
    in a subprocess; print its standard error indented and its JSON line
    with a prefix; return the parsed line. Raises on a non-zero exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.join(root, script)],
                         cwd=root, capture_output=True, text=True,
                         timeout=900)
    for line in res.stderr.splitlines()[-40:]:
        say(f"  {script}: {line}")
    if res.returncode != 0:
        raise AssertionError(f"{script} exited {res.returncode}")
    lines = [x for x in res.stdout.splitlines() if x.strip()]
    if len(lines) != 1:
        raise AssertionError(f"{script} printed {len(lines)} lines: {lines}")
    say(f"  {script} JSON ({time.perf_counter() - t0:.1f} s): {lines[0]}")
    return json.loads(lines[0])


def stacked_checks(capture, kernels, dev) -> dict:
    """The bench's 16 shards (bench_gpu.py's inputs) through
    find_overlaps_stacked at the bench's capacity (shard 0's candidates
    + 6% on a 64k grain, doubled while a shard overflows): once to keep
    shard 0's kernel inputs for phase 2, once with the launch counts
    reset under torch.cuda.set_sync_debug_mode("error"), which raises at
    any host synchronisation. Shard 0's row must equal find_overlaps at
    that capacity, counts included, and no shard keep a duplicate row.
    Returns the phase's fields and the path's launches."""
    import numpy as np
    import torch

    from sage2_tpu_torch.data import simulate_genome, simulate_reads
    from sage2_tpu_torch.overlap import find_overlaps, find_overlaps_stacked

    s = SHARD0
    n_stack = 16
    g_len = int(s["n_reads"] * s["read_len"] / s["coverage"])
    shards = []
    for kk in range(n_stack):
        genome = simulate_genome(g_len, seed=s["seeds"][0] + 1000 * kk)
        rd, _ = simulate_reads(genome, read_len=s["read_len"],
                               coverage=s["coverage"],
                               error_rate=s["error_rate"],
                               seed=s["seeds"][1] + 1000 * kk)
        shards.append(rd[: s["n_reads"]].astype(np.int32))
    reads3 = torch.from_numpy(np.stack(shards)).to(dev)
    valid3 = torch.ones(reads3.shape[:2], dtype=torch.bool, device=dev)
    del shards
    cap = -(-int(SHARD0_CANDIDATES * 1.06) // (1 << 16)) * (1 << 16)

    def run():
        out = find_overlaps_stacked(reads3, valid3, s["min_overlap"], 32,
                                    capacity=cap, device=dev)
        torch.cuda.synchronize()
        return out

    capture.reset_launch_counts("11")
    capture.keeping = False
    while bool(run()[6].any()):
        cap *= 2
    capture.keeping = True              # shard 0's inputs for phase 2
    run()
    capture.keeping = False
    capture.reset_launch_counts("11")
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = find_overlaps_stacked(reads3, valid3, s["min_overlap"], 32,
                                    capacity=cap, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t_stacked = time.perf_counter() - t1
    launches = capture.path_launches("11")
    res = find_overlaps(reads3[0], valid3[0], s["min_overlap"], 32,
                        capacity=cap)
    torch.cuda.synchronize()
    capture.keeping = True
    fields = ("src", "dst", "ovl", "n_edges", "n_candidates", "n_verified",
              "overflow", "n_dups")
    for i, name in enumerate(fields):
        want = getattr(res, name)
        got = out[i][0]
        if not (torch.equal(got, want) if isinstance(want, torch.Tensor)
                else got.item() == want):
            raise AssertionError(f"find_overlaps_stacked shard 0 differs "
                                 f"from find_overlaps in {name}")
    if bool(out[6].any()) or bool(out[7].any()):
        raise AssertionError("find_overlaps_stacked: an overflow or "
                             "duplicate rows in the bench's shards")
    verified = out[5].cpu().tolist()
    return {"sync_free": True, "capacity": cap,
            "stacked_s": f"{t_stacked:.4f}",
            "shard0_equal_to_find_overlaps": True,
            "verified": json.dumps(verified),
            "launches": launches}


def card_state() -> str:
    """The card's SM and memory clocks, power draw, temperature and
    active clock-throttle reasons, as nvidia-smi reads them (its error
    text where a field is not known to it)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu,clocks_throttle_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return (res.stdout or res.stderr).strip()


def peak_gib() -> float:
    """Peak device memory allocated since the last reset, GiB."""
    import torch

    return round(torch.cuda.max_memory_allocated() / 2**30, 3)


def report_mesh(label, log, peak) -> None:
    """Print a meshed run's peak device memory, the bytes its exchanges
    moved by stage (the comm ledger), its retries and capacities."""
    say(f"  peak device memory {peak} GiB ({MESH_SHARDS} shards on one "
        f"card)")
    ledger = next(r for r in log.records if r["stage"] == "comm")
    say(f"  phase {label} collective bytes by stage (summed over its "
        "dispatches): " + json.dumps({
            name: e["total_bytes"] for name, e in ledger["programs"].items()}))
    for r in log.records:
        if r["stage"].endswith(("_retry", "_device_memory")):
            say(f"  {r['stage']}: " + json.dumps(
                {k: v for k, v in r.items() if k != "stage"}))


def contained_count(log, label) -> int:
    """The contained reads a ragged run removed; raises unless some
    were."""
    n = [r["n_contained"] for r in log.records if r["stage"] == "containment"]
    if not n or n[0] <= 0:
        raise AssertionError(f"phase {label}: no contained reads removed "
                             f"({n})")
    return n[0]


def report_assembly(label, t0, t_asm, log, launches, contigs, stats, genome,
                    genome_fraction, copies: str) -> None:
    """Print an assemble run's stage seconds, launches and contig stats,
    and ``copies`` (Capture.copies_note); raise unless genome_fraction >=
    0.99."""
    stages: dict = {}
    for r in log.records:
        if "seconds" in r:
            stages[r["stage"]] = round(stages.get(r["stage"], 0.0)
                                       + r["seconds"], 3)
    stages["untimed"] = round(t_asm - sum(stages.values()), 3)
    gf = genome_fraction(contigs, genome)
    phase(label, t0, assemble_s=f"{t_asm:.3f}", stages=json.dumps(stages),
          launches=json.dumps(launches))
    # the parts of dedup and overlap: device time (CUDA events) in core,
    # the host clock in the streamed dedup
    splits = {r["stage"]: {k: round(v, 3) for k, v in r.items()
                           if k.endswith("_ms")}
              for r in log.records if r["stage"].endswith("_split")}
    if splits:
        say(f"  {'host' if '10' in label else 'device'} split, ms: "
            f"{json.dumps(splits)}")
    say(f"  {copies}")
    say(f"assembly: n_contigs={stats['n_contigs']} n50={stats['n50']} "
        f"total_bases={stats['total_bases']} genome_fraction={gf:.6f} "
        f"(sage2_tpu reference on this input, default config, for comparison: "
        f"{json.dumps(REFERENCE_ASSEMBLY)})")
    if gf < 0.99:
        raise AssertionError(f"{label}: genome_fraction {gf} < 0.99")


def with_duplicates(args: tuple) -> tuple:
    """K14's deferred-mode inputs with a copy of every 100th ok candidate
    behind them at an overlap one shorter, and the capacity grown by as
    many: each copy is a pair verified at two lengths, so the row has
    duplicate rows to keep (the bench's shards have none)."""
    import torch

    ok, a, b, ovl, n_vertices, read_len, capacity = args
    pick = torch.nonzero(ok).flatten()[::100]
    ok, a, b = (torch.cat([x, x[pick]]) for x in (ok, a, b))
    ovl = torch.cat([ovl, ovl[pick] - 1])
    return ok, a, b, ovl, n_vertices, read_len, capacity + pick.numel()


def derived_inputs(row: str, args: tuple, kern) -> tuple:
    """The inputs of a DERIVED row from its base row's ``args`` (``kern``:
    the kernel wrappers as they are): K17's call with K2's bucket
    directory alone, so that every variant is looked up through it; K12's
    with every tenth read's first 32 bases set to A, and K8's outputs for
    those reads."""
    if row == "fix_windows:fallback":
        reads, widx, table, counts, _, *rest = args
        return (reads, widx, table, counts,
                kern("lookup_directory")(table, counts), *rest)
    reads, lengths = args[:2]
    skew = reads.clone()
    skew[::10, :32] = 0
    # K8's words alone, as the path's call (one pass: K12 reads no rows)
    return (skew, lengths) + tuple(kern("canonical_reads")(skew, lengths,
                                                           False, True))


def k2_inputs(capture, path: str) -> tuple:
    """K2's row inputs on ``path``: the pruned table of the path's K16
    row, and the canonical keys of that row's reads (K1). K16 looks every
    window's canonical key up inside its own launch; the path launches
    K2 only for the bucket directory of that table."""
    from sage2_tpu_torch import kernels

    weak = next(row for row, info in KERNEL_INFO.items()
                if info[2] == path and base_key(row).startswith(
                    "weak_windows"))
    reads, _, table, counts, _, k, _ = capture.peek(weak)
    return table, counts, kernels.kmer_keys(reads, k)[2]


def library_time(key: str, args: tuple):
    """(ms, name) of one PyTorch call computing the kernel's function on
    the same inputs, or (None, None) where there is none."""
    import torch

    if key == "prune_table":
        keys, counts, threshold = args

        def masked():
            keep = counts >= threshold
            return (torch.masked_select(keys, keep),
                    torch.masked_select(counts, keep))

        return time_ms(masked), "masked_select"

    if key == "lookup_counts":
        table, _, queries = args
        return time_ms(lambda: torch.searchsorted(table, queries)), \
            "searchsorted"
    if key == "route_rows":
        # the slot order alone: a stable sort of the owners (invalid rows
        # last), the reference's sort_by_keys of _route
        from sage2_tpu_torch.kernels import plain

        _, n, _, owner, keys, flip, valid, _ = route_args(args)
        if owner is None:
            owner = plain.owner_hash(keys, n, flip).to(torch.int32)
        own = owner if valid is None else torch.where(valid, owner, n)
        return time_ms(lambda: torch.sort(own, stable=True)), \
            "sort(owner, stable=True)"
    if key == "pointer_jump:none":         # the whole loop, step by step
        p, steps = args[0], args[3]

        def chained():
            q = p
            for _ in range(steps):
                q = torch.index_select(q, 0, q)

        return time_ms(chained), f"{steps} x index_select"
    if key.startswith("gather_along"):
        tbl, idx, axis = args
        idx64 = idx.long()
        return time_ms(lambda: torch.gather(tbl, axis, idx64)), "gather"
    if key == "seed_table":
        from sage2_tpu_torch.kernels import plain

        # the bucket table's starts: a search of every bucket in the
        # sorted bucket column of the valid entries
        table = plain.seed_table(*args)[0]
        nb = table.shape[0]
        column = torch.repeat_interleave(
            torch.arange(nb, device=table.device), table[:, 1].long())
        buckets = torch.arange(nb, device=table.device)
        return time_ms(lambda: torch.searchsorted(column, buckets)), \
            "searchsorted"
    if key == "reduce_requests:rows":
        # the table's starts: a search of every vertex's first key
        ss_key, vbase, v_d = args
        firsts = (torch.arange(v_d + 1, device=ss_key.device) + vbase) << 32
        return time_ms(lambda: torch.searchsorted(ss_key, firsts)), \
            "searchsorted"
    if key == "merge_runs":
        keys = args[0]
        return time_ms(lambda: torch.unique_consecutive(
            keys, return_counts=True)), "unique_consecutive"
    if key.startswith("dedup_reads"):
        # the sort and the grouping of the canonical words in one call
        _, lengths, _, fwd_w, rc_w, take_rc = args[:6]
        rows = torch.where(take_rc[:, None], rc_w, fwd_w)
        if lengths is not None:
            rows = torch.cat([lengths[:, None].to(torch.int64), rows], 1)
        return time_ms(lambda: torch.unique(
            rows, dim=0, sorted=True, return_inverse=True,
            return_counts=True), reps=3), "unique(dim=0)"
    return None, None


if __name__ == "__main__":
    sys.exit(main())
