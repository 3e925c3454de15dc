"""Sequence I/O: FASTA/FASTQ ingest and FASTA output."""

from sage2_tpu_torch.io.fastq import load_reads, read_fasta, read_fastq
from sage2_tpu_torch.io.writer import write_fasta

__all__ = ["load_reads", "read_fasta", "read_fastq", "write_fasta"]
