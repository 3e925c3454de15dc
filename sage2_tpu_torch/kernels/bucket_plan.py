"""The host side of the bucketed sort K13 and K14 share
(kernels/csrc/bucket_sort.cuh): how many buckets, and the scratch's
size. Plain Python, so that the CPU tests hold the plan to the layout.
"""

from __future__ import annotations

# threads of a block of the bucket sort (kThreads in csrc/common.cuh)
SORT_THREADS = 256
# elements a thread sorts (bsort::kItems)
ITEMS = 8
# elements a block sorts in shared memory (bsort::kBlock); a bucket past
# it is sorted by the whole grid
BLOCK = SORT_THREADS * ITEMS
# the most bucket bits (bsort::kMaxBits)
MAX_BUCKET_BITS = 20
# counts a block of the bucket scan takes (bsort::kCountTile)
SCAN_TILE = 2048
# the most coarse bucket bits (bsort::kCoarseBits)
COARSE_BITS = 8
# the most blocks of the sort's launch (bsort::kMaxGrid)
MAX_GRID = 2048
# an average bucket is at most this share of a block
FILL = 0.75


def bucket_bits(n: int) -> int:
    """d: the fewest bucket bits (2^d buckets) that bring the average of
    ``n`` elements a bucket to FILL of a block, at most
    MAX_BUCKET_BITS."""
    per = int(BLOCK * FILL)
    d = 0
    while d < MAX_BUCKET_BITS and n > per << d:
        d += 1
    return d


def edge_bucket_bits(n: int, span: int) -> int:
    """K14's bucket bits for n candidates whose sources lie in a range of
    ``span`` ids: ``bucket_bits``, at most log2(span) (a bucket is a range
    of sources, so more buckets than sources would stay empty, and the
    kernel's multiplier stays within 32 bits)."""
    return min(bucket_bits(n), max(span, 1).bit_length() - 1)


def coarse_bits(d: int) -> int:
    """dc: the fine buckets' top dc bits are their coarse bucket
    (bsort::coarse_bits)."""
    return min(d, COARSE_BITS)


def scratch_words(d: int, n: int) -> int:
    """int64 words of a bucket sort's scratch for at most ``n`` elements
    (bsort::scratch_words): the total, the kernel's count, two tickets,
    2^dc coarse counts, the scan's status words, 2^d fine buckets' status
    words, 2^dc + 1 and 2^d + 1 first slots; then the big buckets' area:
    each block's sums and largest bucket, three words of totals, the list
    of big buckets and their tiles' keepers."""
    nb, nbc = 1 << d, 1 << coarse_bits(d)
    tiles = -(-nbc // SCAN_TILE)
    base = 3 + (nbc + 1) // 2 + tiles + nb + (nbc + 2) // 2 + (nb + 2) // 2
    big = n // (BLOCK + 1)
    big_tiles = n // BLOCK + big + 1
    return base + MAX_GRID + MAX_GRID // 2 + 3 + big + (big_tiles + 1) // 2


# K12's sort of whole key strings (kernels/csrc/dedup_reads.cu): the
# element widths (int64 words) it is built for, and the 32-bit string
# words a pass of a string too long for one element takes (the widest
# element's halves less the previous pass's group id and the read's index)
DEDUP_WIDTHS = (2, 4, 6, 8)
DEDUP_SEGMENT = 2 * DEDUP_WIDTHS[-1] - 2
# canonical first words crowd the low half of their range (twice the mean
# at its low end), and ragged reads' lengths lead them: buckets for this
# many times the reads
DEDUP_SKEW = 2
DEDUP_SKEW_RAGGED = 4


def dedup_string_words(L: int, lb: int) -> int:
    """32-bit words of a read's key string: lb bits of its length, then
    2 L bits of its canonical codes."""
    return -(-(2 * L + lb) // 32)


def dedup_passes(L: int, lb: int) -> list:
    """K12's passes, in launch order, as (s0, ns, NW): the string words
    [s0, s0 + ns) a pass sorts and its element's int64 words. One pass
    where the string and the index fit the widest element (the narrowest
    that holds them); else segments of DEDUP_SEGMENT words from the last
    to the first, each pass after the first also sorting by the previous
    pass's group id."""
    S = dedup_string_words(L, lb)
    if S + 1 <= 2 * DEDUP_WIDTHS[-1]:
        NW = min(w for w in DEDUP_WIDTHS if 2 * w >= S + 1)
        return [(0, S, NW)]
    return [(s0, min(DEDUP_SEGMENT, S - s0), DEDUP_WIDTHS[-1])
            for s0 in reversed(range(0, S, DEDUP_SEGMENT))]


def dedup_bucket_bits(n: int, ragged: bool) -> int:
    """d of K12's bucket sort of n reads: ``bucket_bits`` of DEDUP_SKEW
    (ragged: DEDUP_SKEW_RAGGED) times n, so that the crowded buckets
    still fit a block."""
    return bucket_bits((DEDUP_SKEW_RAGGED if ragged else DEDUP_SKEW) * n)
