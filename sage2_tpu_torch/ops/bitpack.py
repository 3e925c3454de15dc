"""2-bit base encoding and k-mer key arithmetic (port of
sage2_tpu/ops/bitpack.py).

Bases are the 2-bit codes A=0, C=1, G=2, T=3 (complement = 3 - code).
Where the reference holds a k-mer as a pair of uint32 words (hi, lo),
the port holds one int64: for k <= 31 it is the exact 2k-bit
big-endian base-4 value, which equals hi << 32 | lo, so int64 order is
the reference's lexicographic (hi, lo) order. A 32-base key (overlap
seeds, s = 32) needs all 64 bits: it is stored with its top bit flipped
(value ^ 1 << 63), so that signed int64 order is still the unsigned
order, and the all-ones sentinel maps to INT64_MAX.

Words of packed bases are carried as int64 holding a uint32 value,
because torch on the CPU has no shift or compare for uint32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sage2_tpu_torch import kernels

# 2-bit base codes.
BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3

_ASCII_TO_CODE = np.full(256, 0, dtype=np.uint8)   # unknown (incl. 'N') -> A
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3),
                   ("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    _ASCII_TO_CODE[ord(_ch)] = _code
_CODE_TO_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)  # 4 = scaffold gap


def encode_ascii(seqs: np.ndarray) -> np.ndarray:
    """ASCII byte array -> 2-bit codes (host side). 'N'/unknown map to A."""
    return _ASCII_TO_CODE[seqs]


def decode_to_ascii(codes: np.ndarray) -> np.ndarray:
    """2-bit codes -> ASCII byte array (host side)."""
    return _CODE_TO_ASCII[np.asarray(codes, dtype=np.int64)]


def codes_to_str(codes: np.ndarray) -> str:
    return decode_to_ascii(codes).tobytes().decode()


def str_to_codes(s: str) -> np.ndarray:
    return encode_ascii(np.frombuffer(s.encode(), dtype=np.uint8))


def revcomp_codes(reads: torch.Tensor) -> torch.Tensor:
    """Reverse complement of fixed-length reads, shape (..., L)."""
    return (3 - reads).flip(-1)


def kmer_keys(
    reads: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward, reverse-complement and canonical keys of every k-mer.

    reads: (N, L) int32 codes. Returns three int64 (N, L - k + 1) arrays,
    the counterparts of the reference's kmer_keys, revcomp_kmer_keys and
    canonical_kmer_keys (canonical = min of the two strands). One
    launch of kernel K1 on the card.
    """
    return kernels.kmer_keys(reads, k)


def set_base(key: torch.Tensor, k: int, pos: int, old: torch.Tensor,
             new: torch.Tensor) -> torch.Tensor:
    """Replace the base at static k-mer position ``pos`` (0 = first,
    most significant) of int64 keys (k <= 31), old code -> new code."""
    w = 1 << (2 * (k - 1 - pos))
    return key + (new.to(torch.int64) - old.to(torch.int64)) * w


_POW4_16 = [1 << (2 * (15 - i)) for i in range(16)]


def pack_read_words(reads: torch.Tensor) -> torch.Tensor:
    """Pack fixed-length reads to words of 16 bases (int64 holding a
    uint32): (..., L) codes -> (..., ceil(L/16)), big-endian within a
    word, final word left-aligned, so word-wise order is base-wise
    order."""
    L = reads.shape[-1]
    W = -(-L // 16)
    r = reads.to(torch.int64)
    pad = W * 16 - L
    if pad:
        r = torch.cat([r, r.new_zeros(r.shape[:-1] + (pad,))], dim=-1)
    grouped = r.reshape(r.shape[:-1] + (W, 16))
    w = torch.tensor(_POW4_16, dtype=torch.int64, device=r.device)
    return (grouped * w).sum(-1)


def word_at(words0: torch.Tensor, q: int) -> torch.Tensor:
    """The word of bases [q, q + 16) of every read (zero past the end)
    from the unshifted packing ``words0`` (M, W): the reference's
    ``shifted_word_packs(...)[:, q % 16, q // 16]``."""
    W = words0.shape[1]
    w, r = q // 16, q % 16
    if w >= W:
        return words0.new_zeros(words0.shape[0])
    head = words0[:, w]
    if r == 0:
        return head.clone()
    out = (head << (2 * r)) & 0xFFFFFFFF
    if w + 1 < W:
        out |= words0[:, w + 1] >> (32 - 2 * r)
    return out


def unpack_read_words(words: np.ndarray, L: int) -> np.ndarray:
    """Inverse of pack_read_words (host side)."""
    words = np.asarray(words, dtype=np.uint64)
    W = words.shape[-1]
    shifts = np.arange(30, -2, -2, dtype=np.uint64)
    codes = (words[..., :, None] >> shifts) & np.uint64(3)
    return codes.reshape(words.shape[:-1] + (W * 16,))[..., :L].astype(np.uint8)
