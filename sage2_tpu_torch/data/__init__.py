"""Synthetic dataset generation (no network: datasets are simulated)."""

from sage2_tpu_torch.data.simulate import (
    simulate_complex_genome,
    simulate_genome,
    simulate_ragged_reads,
    simulate_read_pairs,
    simulate_reads,
    write_fastq,
)

__all__ = [
    "simulate_complex_genome",
    "simulate_genome",
    "simulate_ragged_reads",
    "simulate_read_pairs",
    "simulate_reads",
    "write_fastq",
]
