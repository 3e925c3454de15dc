"""k-mer layer: exact counting and spectrum error correction."""

from sage2_tpu_torch.kmer.correct import correct_reads_twophase
from sage2_tpu_torch.kmer.count import KmerTable, count_kmers, lookup_counts

__all__ = ["KmerTable", "count_kmers", "lookup_counts",
           "correct_reads_twophase"]
