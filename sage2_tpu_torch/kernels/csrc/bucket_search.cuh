// A bucket directory over a sorted int64 key table, and the short search
// inside one bucket that it leaves (kernels K2 and K5: every kernel that
// looks keys up in a count table).
//
// The keys of a table of T sorted keys span [lo, hi]. A key q of that span
// falls in bucket (uint64)(q - lo) >> shift, with shift = max(0,
// bitlen((uint64)(hi - lo)) - bits): the buckets are 2^shift apart, at most
// 2^bits of them hold keys, and an in-span key's offset and bucket are exact
// in unsigned arithmetic for any sorted table (negative keys and the int64
// extremes included). dir[j] is the first table index whose bucket is at
// least j, dir[2^bits] = T, so bucket j's keys are table[dir[j]:dir[j+1]).
// bits = clamp(ceil(log2 T) - 2, 0, 22) puts 2-8 keys in an occupied
// bucket of a table whose keys spread evenly.
//
// Building: one thread a directory entry, a lower-bound search of the whole
// table (as K9 builds its bucket starts), so no thread's work grows with a
// gap between keys or a run of keys in one bucket: a skewed table (every key
// but one in bucket 0) costs the same as an even one. Where the buckets are
// at most 2^32 apart (shift <= 32: a table of 2^20 keys or more over 50-bit
// keys) each entry is packed as 8 bytes, (uint32 offset below its bucket,
// int32 count), so that a bucket's keys and counts share one or two
// sectors and the packed table is two thirds of keys and counts; wider
// buckets search the int64 keys and read the count beside them.
// Searching: an exact search inside the query's bucket, log2 of the
// bucket's size steps (2-3 at an even table), several queries a thread
// stepping together so that their loads overlap.
//
// Memory (int64 words): a header {lo, hi - lo, shift, packed}, T packed
// entries (unused where not packed), then the int32 directory, 2^bits + 1
// entries; T must stay below 2^31. The caller chooses bits (the Python
// wrapper, kernels.lookup_directory) and launches the directory with
// bucket_directory_launch.

#pragma once

#include <cstdint>

#include "common.cuh"

constexpr int kBucketHeader = 4;    // int64 words before the entries

// A key through the read-only path.
__device__ __forceinline__ int64_t ldg_key(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

struct BucketSpan {
  int64_t lo;       // the table's lowest key
  uint64_t range;   // its highest key less lo
  int shift;        // bucket width, log2
};

__device__ __forceinline__ BucketSpan bucket_span(
    const int64_t* __restrict__ table, int64_t T, int bits) {
  BucketSpan s{0, 0, 0};
  if (T == 0) return s;
  s.lo = ldg_key(table);
  s.range = static_cast<uint64_t>(ldg_key(table + T - 1)) -
            static_cast<uint64_t>(s.lo);
  const int len = 64 - __clzll(static_cast<long long>(s.range));
  s.shift = len > bits ? len - bits : 0;
  return s;
}

// The bucket of an in-span offset d (shift is 64 only with bits = 0).
__device__ __forceinline__ int64_t bucket_of(uint64_t d, int shift) {
  return shift >= 64 ? 0 : static_cast<int64_t>(d >> shift);
}

// The bits of an offset below its bucket's lowest key.
__device__ __forceinline__ uint64_t suffix_mask(int shift) {
  return shift >= 64 ? ~uint64_t{0} : (uint64_t{1} << shift) - 1;
}

// dir[j] for j < 2^bits: the first index whose key's offset reaches
// j << shift (T where none does).
__device__ __forceinline__ int32_t bucket_start(
    const int64_t* __restrict__ table, int64_t T, const BucketSpan& s,
    int64_t j) {
  if (j == 0) return 0;
  const uint64_t floor = static_cast<uint64_t>(j) << s.shift;  // shift < 64
  int64_t a = 0, n = T;
  while (n > 0) {
    const int64_t half = n >> 1;
    const uint64_t d = static_cast<uint64_t>(ldg_key(table + a + half)) -
                       static_cast<uint64_t>(s.lo);
    if (d < floor) {
      a += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return static_cast<int32_t>(a);
}

// The header, and for entry i < 2^bits + 1 of the directory its value,
// for i beyond it table entry i - 2^bits - 1 packed as (its offset below
// its bucket, its count) where the bucket width allows (shift <= 32); one
// thread an item (grid-stride over 2^bits + 1 + T items).
__device__ __forceinline__ void bucket_directory(
    const int64_t* __restrict__ table, const int32_t* __restrict__ counts,
    int64_t T, int bits, int64_t* __restrict__ header,
    uint2* __restrict__ packed, int32_t* __restrict__ dir, int64_t i) {
  const BucketSpan s = bucket_span(table, T, bits);
  const bool packing = T > 0 && s.shift <= 32;
  const int64_t nb = int64_t{1} << bits;
  if (i == 0) {
    header[0] = s.lo;
    header[1] = static_cast<int64_t>(s.range);
    header[2] = s.shift;
    header[3] = packing;
  }
  if (i <= nb) {
    dir[i] = i == nb ? static_cast<int32_t>(T) : bucket_start(table, T, s, i);
  } else if (packing) {
    const int64_t k = i - nb - 1;
    const uint64_t d =
        static_cast<uint64_t>(ldg_key(table + k)) - static_cast<uint64_t>(s.lo);
    packed[k] = make_uint2(static_cast<uint32_t>(d & suffix_mask(s.shift)),
                           static_cast<uint32_t>(__ldg(counts + k)));
  }
}

__device__ __forceinline__ BucketSpan load_span(
    const int64_t* __restrict__ header) {
  return BucketSpan{ldg_key(header),
                    static_cast<uint64_t>(ldg_key(header + 1)),
                    static_cast<int>(ldg_key(header + 2))};
}

// What a bucket's search compares, and where an entry's count is: the
// int64 keys themselves and the counts beside them, or the packed
// entries' uint32 offsets below the bucket and their own counts.
struct Int64Keys {
  using Key = int64_t;
  const int64_t* __restrict__ table;
  const int32_t* __restrict__ counts;
  __device__ __forceinline__ Key key(int64_t q, uint64_t) const { return q; }
  __device__ __forceinline__ Key at(int32_t i) const {
    return ldg_key(table + i);
  }
  __device__ __forceinline__ int32_t count(int32_t i) const {
    return __ldg(counts + i);
  }
};

struct PackedKeys {
  using Key = uint32_t;
  const uint2* __restrict__ packed;
  uint64_t mask;
  __device__ __forceinline__ Key key(int64_t, uint64_t d) const {
    return static_cast<uint32_t>(d & mask);
  }
  __device__ __forceinline__ Key at(int32_t i) const {
    return __ldg(packed + i).x;
  }
  __device__ __forceinline__ int32_t count(int32_t i) const {
    return static_cast<int32_t>(__ldg(packed + i).y);
  }
};

// The table index of each of C query keys, -1 where absent or where
// live[c] is false; the C searches step together. Keys: Int64Keys over
// sorted unique int64 keys, or PackedKeys over their packed entries.
template <int C, typename Keys>
__device__ __forceinline__ void bucket_find(
    const Keys& keys, const int32_t* __restrict__ dir, const BucketSpan& s,
    const int64_t (&q)[C], const bool (&live)[C], int32_t (&pos)[C]) {
  using Key = typename Keys::Key;
  int32_t a[C], n[C];
  Key want[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const uint64_t d =
        static_cast<uint64_t>(q[c]) - static_cast<uint64_t>(s.lo);
    pos[c] = -1;
    a[c] = 0;
    n[c] = 0;
    want[c] = keys.key(q[c], d);
    if (live[c] && d <= s.range) {
      const int64_t j = bucket_of(d, s.shift);
      a[c] = __ldg(dir + j);
      n[c] = __ldg(dir + j + 1) - a[c];
    }
  }
  bool more = true;
  while (more) {
    Key v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (n[c] > 0) v[c] = keys.at(a[c] + (n[c] >> 1));
    }
    more = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (n[c] > 0) {
        const int32_t half = n[c] >> 1;
        if (v[c] == want[c]) {
          pos[c] = a[c] + half;
          n[c] = 0;
        } else if (v[c] < want[c]) {
          a[c] += half + 1;
          n[c] -= half + 1;
        } else {
          n[c] = half;
        }
        more |= n[c] > 0;
      }
    }
  }
}

// The scratch of a table of T keys (int64 words): the header, T packed
// entries, the directory.
__device__ __forceinline__ const uint2* packed_of(const int64_t* scratch) {
  return reinterpret_cast<const uint2*>(scratch + kBucketHeader);
}
__device__ __forceinline__ const int32_t* dir_of(const int64_t* scratch,
                                                 int64_t T) {
  return reinterpret_cast<const int32_t*>(scratch + kBucketHeader + T);
}

__global__ void bucket_directory_kernel(const int64_t* __restrict__ table,
                                        const int32_t* __restrict__ counts,
                                        int64_t T, int bits,
                                        int64_t* __restrict__ scratch) {
  uint2* packed = reinterpret_cast<uint2*>(scratch + kBucketHeader);
  int32_t* dir = reinterpret_cast<int32_t*>(scratch + kBucketHeader + T);
  SAGE2_GRID_STRIDE(i, (int64_t{1} << bits) + 1 + T) {
    bucket_directory(table, counts, T, bits, scratch, packed, dir, i);
  }
}

// table: (T,) sorted unique int64 keys, T < 2^31; counts: (T,) int32;
// scratch: 4 + T + 2^(bits - 1) + 1 int64 words.
static int bucket_directory_launch(const void* table, const void* counts,
                                   int64_t T, int bits, void* scratch,
                                   void* stream) {
  bucket_directory_kernel<<<sage2_blocks((int64_t{1} << bits) + 1 + T),
                            kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), static_cast<const int32_t*>(counts),
      T, bits, static_cast<int64_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
