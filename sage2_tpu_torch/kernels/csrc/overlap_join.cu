// K3: the overlap join after the seed-row sort: the runs of the sorted
// rows, candidate expansion, and the word-wise suffix-prefix verify.
//
// Replaces sage2_tpu/overlap/detect.py fused_join_core (:863) minus its
// sort (K13 sorts the rows), with the row layout of build_seed_rows /
// _row_payload (:642, :562). On the TPU the run accounting was two
// cummax scans, the expansion a scatter plus a cummax over the whole
// candidate capacity, and the verify two wide row gathers; every step
// was shaped by the TPU's fixed cost per gather and scatter.
//
// The unit of work here is the run: the rows of one seed key, its e
// entry rows (slot t < g of a read) first, then its q query rows. A run
// owns e * q consecutive candidate slots, and the slot of (query rank
// qi, entry rank ei) is run_base + qi * e + ei: sorted-query order, entry
// order inside a query, the reference's candidate order exactly. Two
// launches:
//
//   runs   (sage2_join_runs) a block a tile of kCountTile sorted rows, in
//          ticket order. A row is a run head where its key differs from
//          the row before; a block scan lists the tile's heads with the
//          entry rows before each, so a run inside the tile has its e
//          and q from two neighbouring entries, and only the tile's last
//          run, which may go on past the tile, is searched (galloping,
//          in device memory: a hot key costs a logarithm, not a walk).
//          The runs with candidates (e > 0 and q > 0) are counted and
//          their slots summed by block scans, and two decoupled
//          look-backs (lookback.cuh, 128 tiles a round trip) give each
//          its rank among them and its first slot: records (base, first
//          row, e) in key order, and the total and the run count in
//          device scalars. No per-row array and no torch.cumsum.
//   slots  (sage2_join_slots) a block of kSlotThreads threads takes a
//          contiguous range of slot tiles of kSlotTile = 128 slots (the
//          grid one wave; the first tile's run is found by a binary
//          search over the run bases, later tiles carry it on). For a
//          tile, the block reads the bases and records of the runs that
//          cover it, works out each run's part (its first query and
//          entry rank in the tile, how many of each it needs) and
//          stages those payload rows, with their reads and seed slots,
//          in shared memory, two rows a thread at once: each payload
//          row is read once a tile, not
//          once a candidate. A run larger than a tile is taken in
//          tile-sized chunks across blocks. Consecutive threads then
//          verify consecutive slots from shared memory and store them:
//          every store of (ok, a, b, ovl) is coalesced.
//
// A tile stages at most twice as many rows as it has slots: a run's part
// of len slots needs min(e, len) entry rows and at most len / e + 2 query
// rows, at most 2 len in all.
//
// Precondition: rows are sorted by key and, within a key, entries before
// queries, each by row id. Dead rows (invalid reads, and for ragged reads
// the seeds that pass a read's end) are not passed at all. n < 2^31.
//
// Ragged reads: each payload row carries its read's length, and the
// verify compares min(len_a - p, len_b - o) bases, so nothing past either
// read's end takes part. The slots launch then also marks containments
// (the reference's ok_contained, :1011, scattered at :836-843): a
// verified pair with len_b <= ovl stores contained[b] = 1. Racing stores
// write the same 1, so the marks need no atomics. Only slots below the
// caller's limit (`n_out`) are written and marked: the reference's
// candidate capacity, when the caller keeps fewer slots than there are
// candidates.
//
// The streamed join (sage2_tpu/stream.py:835-887) joins an entry slab
// with one query chunk: its rows carry global ids (read * R + t), but the
// payload rows lie in two arrays, the slab's entries ((read - entry
// base) * g + t) and the chunk's queries ((read - query base) * n_pos +
// t - g): PayloadMap below. The in-core join passes one payload with both
// bases 0 and both strides R, which is the row id itself. The meshed
// join (parallel/sharded.py:921-929) passes the sort's permutation: the
// payload row of sorted row i is perm[i].
//
// The fixed-capacity mode (find_overlaps_stacked, detect.py:1108) reads
// no count on the host: the rows come as K13's fixed buffer, the live
// rows first and the live count in device memory, and the runs launch
// stops there (a live all-T seed and a dead row share the key
// INT64_MAX). The slots launch reads the total from device memory and
// writes exactly `capacity` slots: the candidates below min(total,
// capacity), then not-ok slots (a, b, ovl 0). Nothing waits on the host.
//
// Bound: bytes. The runs launch reads each key and row id once; the slots
// launch reads each needed payload row once a tile and writes 13 bytes a
// candidate. On an H100 at phase 4's size the slots launch without its
// payload gather and its stores still takes two thirds of its time (the
// tiles' searches, divisions and barriers); the random 24-byte payload
// rows (about 1.75 sectors each) and the stores take the rest.

#include "lookback.cuh"
#include "scan.cuh"

namespace {

constexpr int kCountItems = 8;                      // rows a thread
constexpr int kCountTile = kThreads * kCountItems;  // rows a runs tile
// the slots launch: small blocks, so that many of them on an SM overlap
// their phases (each tile is a chain of dependent loads and barriers; on
// an H100, 64 threads of 2 slots each beat 32-256 threads of 2-8)
constexpr int kSlotThreads = 64;
constexpr int kSlotItems = 2;                       // slots (and runs) a thread
constexpr int kSlotTile = kSlotItems * kSlotThreads;  // slots a tile
// the run bases a tile reads: at most kSlotTile runs cover it, and the
// base after them ends the last
constexpr int kBaseBuf = kSlotTile + 1;
constexpr int kWordChunk = 8;   // payload words a staged row loads at once

__device__ __forceinline__ int64_t ldg64(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ bool is_entry(const int32_t* __restrict__ rows,
                                         int64_t j, int R, int g) {
  return __ldg(rows + j) % R < g;
}

// The first row past the run of `key` that holds row i (n at most): a
// galloping search from i, then a bisection (the run that goes on past
// its runs tile).
__device__ int64_t run_end(const int64_t* __restrict__ keys, int64_t i,
                           int64_t n, int64_t key) {
  int64_t lo = i, hi = n, step = 1;
  for (;;) {
    const int64_t j = lo + step;
    if (j >= n) break;
    if (ldg64(keys + j) != key) {
      hi = j;
      break;
    }
    lo = j;
    step <<= 1;
  }
  while (hi - lo > 1) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (ldg64(keys + mid) == key) lo = mid; else hi = mid;
  }
  return hi;
}

// The first query row in [i, end) of a run (end where there is none).
__device__ int64_t first_query(const int32_t* __restrict__ rows, int64_t i,
                               int64_t end, int R, int g) {
  if (i >= end || !is_entry(rows, i, R, g)) return i;
  int64_t lo = i, hi = end, step = 1;
  for (;;) {
    const int64_t j = lo + step;
    if (j >= end) break;
    if (!is_entry(rows, j, R, g)) {
      hi = j;
      break;
    }
    lo = j;
    step <<= 1;
  }
  while (hi - lo > 1) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (is_entry(rows, mid, R, g)) lo = mid; else hi = mid;
  }
  return hi;
}

// Control words (int64): [0] the total, [1] the runs with candidates,
// [2] the tile ticket, then the look-back status words of the slots and
// of the runs, one a runs tile each (all but [0] and [1] zeroed by the
// launcher).
struct Ctl {
  int64_t* total;
  int64_t* runs;
  unsigned* ticket;
  unsigned long long* slot_status;
  unsigned long long* run_status;
};

__host__ __device__ inline int64_t count_tiles(int64_t n) {
  const int64_t t = (n + kCountTile - 1) / kCountTile;
  return t < 1 ? 1 : t;
}

__host__ __device__ inline Ctl ctl_of(int64_t* ctl, int64_t tiles) {
  Ctl c;
  c.total = ctl;
  c.runs = ctl + 1;
  c.ticket = reinterpret_cast<unsigned*>(ctl + 2);
  c.slot_status = reinterpret_cast<unsigned long long*>(ctl + 3);
  c.run_status = c.slot_status + tiles;
  return c;
}

// base: (runs + 1,) each run's first slot and, behind the last, the
// total; run: (runs,) its first row and its entries.
__global__ void __launch_bounds__(kThreads)
    join_runs_kernel(const int64_t* __restrict__ keys,
                     const int32_t* __restrict__ rows, int64_t n_rows,
                     const int64_t* __restrict__ n_live, int R, int g,
                     int64_t* ctl_words, int64_t* __restrict__ base,
                     int2* __restrict__ run) {
  // the tile's run heads (tile positions, then the tile's end) and the
  // tile's entry rows before each
  __shared__ int32_t shead[kCountTile + 1], sent[kCountTile + 1];
  __shared__ int64_t s_last[2];       // the last head's entries, queries
  __shared__ bool s_on;               // its run goes on past the tile
  const int64_t tiles = count_tiles(n_rows);
  const Ctl ctl = ctl_of(ctl_words, tiles);
  const int64_t tile = lookback::block_ticket(ctl.ticket);
  const int64_t n = n_live == nullptr ? n_rows : ldg64(n_live);
  const int64_t t0 = tile * kCountTile;
  const int64_t t_end = min64(t0 + kCountTile, n);
  const int tid = threadIdx.x;
  // this thread's kCountItems consecutive rows: head and entry bits
  const int64_t i0 = t0 + static_cast<int64_t>(tid) * kCountItems;
  unsigned heads = 0, entries = 0;
  {
    int64_t prev = i0 > 0 && i0 - 1 < n ? ldg64(keys + i0 - 1) : 0;
#pragma unroll
    for (int it = 0; it < kCountItems; ++it) {
      const int64_t i = i0 + it;
      if (i < n) {
        const int64_t k = ldg64(keys + i);
        if (i == 0 || k != prev) heads |= 1u << it;
        if (is_entry(rows, i, R, g)) entries |= 1u << it;
        prev = k;
      }
    }
    if (tid == kThreads - 1) s_on = t_end < n && ldg64(keys + t_end) == prev;
  }
  // heads and entries before this thread's rows (a block scan of both
  // counts at once: each stays below 2^16 in a tile)
  int both;
  const int before = block_exclusive_scan<int>(
      (__popc(heads) << 16) | __popc(entries), &both);
  const int H = both >> 16;
  {
    int h = before >> 16, e = before & 0xffff;
    for (int it = 0; it < kCountItems; ++it) {
      if (heads >> it & 1) {
        shead[h] = tid * kCountItems + it;
        sent[h] = e;
        ++h;
      }
      e += entries >> it & 1;
    }
  }
  if (tid == 0) {
    shead[H] = static_cast<int32_t>(t_end > t0 ? t_end - t0 : 0);
    sent[H] = both & 0xffff;
  }
  __syncthreads();
  // the last head's run may go on past the tile: its end and its first
  // query by searches in device memory
  if (tid == 0 && H > 0) {
    const int64_t start = t0 + shead[H - 1];
    int64_t end = t0 + shead[H];
    int64_t e = sent[H] - sent[H - 1];
    if (s_on) {
      const int64_t in = end;
      end = run_end(keys, in - 1, n, ldg64(keys + start));
      if (e == in - start) e = first_query(rows, in, end, R, g) - start;
    }
    s_last[0] = e;
    s_last[1] = end - start - e;
  }
  __syncthreads();
  // thread tid takes heads [tid * per, (tid + 1) * per): their entries and
  // queries in O(1) from the tables above
  const int per = (H + kThreads - 1) / kThreads;
  const int k0 = tid * per, k1 = min(k0 + per, H);
  auto split_of = [&](int k, int64_t* e, int64_t* q) {
    if (k == H - 1) {
      *e = s_last[0];
      *q = s_last[1];
    } else {
      *e = sent[k + 1] - sent[k];
      *q = shead[k + 1] - shead[k] - *e;
    }
    if (*e == 0 || *q == 0) *e = *q = 0;
  };
  uint64_t slots = 0, runs = 0;
  for (int k = k0; k < k1; ++k) {
    int64_t e, q;
    split_of(k, &e, &q);
    slots += static_cast<uint64_t>(e * q);
    runs += e > 0;
  }
  uint64_t tile_slots, tile_runs;
  const uint64_t slots_before =
      block_exclusive_scan<uint64_t>(slots, &tile_slots);
  const uint64_t runs_before = block_exclusive_scan<uint64_t>(runs, &tile_runs);
  uint64_t s = lookback::tile_prefix<4>(ctl.slot_status, tile, tile_slots) +
               slots_before;
  uint64_t r = lookback::tile_prefix<4>(ctl.run_status, tile, tile_runs) +
               runs_before;
  for (int k = k0; k < k1; ++k) {
    int64_t e, q;
    split_of(k, &e, &q);
    if (e > 0) {
      base[r] = static_cast<int64_t>(s);
      run[r] = make_int2(static_cast<int32_t>(t0 + shead[k]),
                         static_cast<int32_t>(e));
      s += static_cast<uint64_t>(e * q);
      ++r;
    }
  }
  // the last thread of the last tile holds the totals
  if (tile == tiles - 1 && tid == kThreads - 1) {
    *ctl.total = static_cast<int64_t>(s);
    *ctl.runs = static_cast<int64_t>(r);
    base[r] = static_cast<int64_t>(s);
  }
}

// Where the payload row of a seed row lies: entry rows (t < g) in `ent`
// at (read - ent_base) * ent_stride + t, query rows in `qry` at (read -
// qry_base) * qry_stride + t - qry_off; W2 int32 words a row. With `perm`
// the row of sorted row `pos` is qry's row perm[pos].
struct PayloadMap {
  const uint32_t* ent;
  int64_t ent_base;
  int ent_stride;
  const uint32_t* qry;
  int64_t qry_base;
  int qry_stride;
  int qry_off;
  int W2;
  const int64_t* perm;

  __device__ __forceinline__ const uint32_t* row(int32_t id, int64_t pos,
                                                 int R, int g) const {
    if (perm != nullptr) return qry + ldg64(perm + pos) * W2;
    const int64_t read = id / R;
    const int t = id % R;
    if (t < g) return ent + ((read - ent_base) * ent_stride + t) * W2;
    return qry + ((read - qry_base) * qry_stride + t - qry_off) * W2;
  }
};

// Exclusive prefix sum of v over the slots launch's kSlotThreads threads;
// *total gets their sum. Every thread of the block calls it.
__device__ __forceinline__ int slots_scan(int v, int* total) {
  constexpr int kWarps = kSlotThreads / 32;
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int y = warp_sum[w];
    before += w < warp ? y : 0;
    all += y;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// The last index j in [0, m) with a[j] <= x (a ascending, a[0] <= x).
__device__ __forceinline__ int last_at_most(const int32_t* a, int m, int x) {
  int lo = 0, hi = m;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid; else hi = mid;
  }
  return lo;
}

// Dynamic shared memory of a slots tile: the staged rows' payload words,
// word-major ([W2][2 kSlotTile]), then their reads and seed slots (2
// kSlotTile each).
__host__ __device__ inline size_t slots_smem(int W2) {
  return static_cast<size_t>(W2 + 2) * 2 * kSlotTile * sizeof(uint32_t);
}

__global__ void __launch_bounds__(kSlotThreads, 1024 / kSlotThreads)
    join_slots_kernel(const int32_t* __restrict__ rows, const PayloadMap pm,
                      const int64_t* __restrict__ ctl,
                      const int64_t* __restrict__ base,
                      const int2* __restrict__ run, int R, int g, int trim,
                      int min_overlap, int64_t n_out,
                      bool* __restrict__ ok, int32_t* __restrict__ cand_a,
                      int32_t* __restrict__ cand_b,
                      int32_t* __restrict__ cand_ovl,
                      uint8_t* __restrict__ contained) {
  extern __shared__ uint32_t stage[];
  __shared__ int64_t rbase[kBaseBuf];
  // each run of the tile: its first slot in the tile, its staged rows'
  // first index, entries, first entry and query rank, entry rows staged,
  // first row
  __shared__ int32_t rrel[kSlotTile], rsoff[kSlotTile + 1], re[kSlotTile],
      rei0[kSlotTile], rqi0[kSlotTile], rce[kSlotTile], rstart[kSlotTile];
  __shared__ int64_t s_cursor;
  constexpr int st = kSlotTile, cap = 2 * kSlotTile;
  const int W2 = pm.W2, Wt = W2 - 2;
  uint32_t* pay = stage;
  int32_t* srd = reinterpret_cast<int32_t*>(stage + W2 * cap);
  int32_t* stt = srd + cap;
  const int tid = threadIdx.x;
  const int64_t total = ldg64(ctl);
  const int64_t n_runs = ldg64(ctl + 1);
  const int64_t used = total < n_out ? total : n_out;
  const int64_t tiles = (n_out + st - 1) / st;
  const int64_t per = (tiles + gridDim.x - 1) / gridDim.x;
  const int64_t t_end = min64(tiles, (blockIdx.x + 1) * per);
  int64_t cur = -1;       // the run that holds the tile's first slot
  for (int64_t tile = blockIdx.x * per; tile < t_end; ++tile) {
    const int64_t s = tile * st;
    const int64_t s_end = min64(s + st, n_out);
    const int64_t live = min64(s_end, used);
    if (s >= live) {      // the fixed capacity's slots past the total
      for (int64_t i = s + tid; i < s_end; i += kSlotThreads) {
        ok[i] = false;
        cand_a[i] = 0;
        cand_b[i] = 0;
        cand_ovl[i] = 0;
      }
      continue;
    }
    if (cur < 0) {        // the last run whose base is at most s
      if (tid == 0) {
        int64_t lo = 0, hi = n_runs;
        while (hi - lo > 1) {
          const int64_t mid = lo + ((hi - lo) >> 1);
          if (ldg64(base + mid) <= s) lo = mid; else hi = mid;
        }
        s_cursor = lo;
      }
      __syncthreads();
      cur = s_cursor;
    }
    // the runs that cover [s, live): the bases from cur on, kSlotItems a
    // thread and thread 0 one more (base[n_runs], the total, ends them)
#pragma unroll
    for (int h = 0; h <= kSlotItems; ++h) {
      const int j = h * kSlotThreads + tid;
      if (h < kSlotItems || tid == 0) {
        const int64_t r = cur + j;
        rbase[j] = r <= n_runs ? ldg64(base + r) : INT64_MAX;
      }
    }
    __syncthreads();
    int m;                // the first base that reaches `live` (m <= st)
    {
      int lo = 0, hi = kSlotTile;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (rbase[mid] < live) lo = mid; else hi = mid;
      }
      m = hi;
    }
    // the next tile's first run: the one that holds s_end
    const int64_t next =
        s_end < used ? cur + m - 1 + (rbase[m] == s_end ? 1 : 0) : -1;
    // each run's part of the tile and the rows it stages; thread tid
    // takes runs kSlotItems tid + h (m <= kSlotTile)
    int n_rows[kSlotItems], my_rows = 0;
#pragma unroll
    for (int h = 0; h < kSlotItems; ++h) {
      const int j = kSlotItems * tid + h;
      n_rows[h] = 0;
      if (j < m) {
        const int64_t b = rbase[j];
        const int64_t from = s > b ? s : b;
        const int64_t lo = from - b;           // its first slot in the tile
        const int len = static_cast<int>(min64(rbase[j + 1], live) - from);
        const int2 ru = __ldg(run + cur + j);
        const int e = ru.y;
        int64_t qi0 = 0;
        int ei0 = 0;
        if (lo > 0) {
          qi0 = lo / e;
          ei0 = static_cast<int>(lo - qi0 * e);
        }
        const int ce = e < len ? e : len;
        const int cq = (ei0 + len - 1) / e + 1;
        rrel[j] = static_cast<int32_t>(from - s);
        re[j] = e;
        rei0[j] = ei0;
        rqi0[j] = static_cast<int32_t>(qi0);
        rce[j] = ce;
        rstart[j] = ru.x;
        n_rows[h] = ce + cq;
        my_rows += ce + cq;
      }
    }
    int n_stage;
    int before = slots_scan(my_rows, &n_stage);
#pragma unroll
    for (int h = 0; h < kSlotItems; ++h) {
      if (kSlotItems * tid + h < m) rsoff[kSlotItems * tid + h] = before;
      before += n_rows[h];
    }
    if (tid == 0) rsoff[m] = n_stage;
    __syncthreads();
    // stage the rows, two a thread at once (their ids, then their words
    // in registers, so that the loads overlap): run j's entries in rank
    // order from rei0 (mod e), then its queries from rqi0
    for (int k0 = tid; k0 < n_stage; k0 += 2 * kSlotThreads) {
      int64_t pos[2];
      bool have[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + h * kSlotThreads;
        have[h] = k < n_stage;
        pos[h] = 0;
        if (have[h]) {
          const int j = last_at_most(rsoff, m, k);
          const int u = k - rsoff[j];
          pos[h] = rstart[j];
          if (u < rce[j]) {
            int ei = rei0[j] + u;
            if (ei >= re[j]) ei -= re[j];
            pos[h] += ei;
          } else {
            pos[h] += static_cast<int64_t>(re[j]) + rqi0[j] + (u - rce[j]);
          }
        }
      }
      int32_t id[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) id[h] = have[h] ? __ldg(rows + pos[h]) : 0;
      const uint32_t* p[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h] = nullptr;
        if (have[h]) {
          const int k = k0 + h * kSlotThreads;
          srd[k] = id[h] / R;
          stt[k] = id[h] % R;
          p[h] = pm.row(id[h], pos[h], R, g);
        }
      }
      for (int w0 = 0; w0 < W2; w0 += kWordChunk) {
        uint32_t v[2][kWordChunk];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int w = 0; w < kWordChunk; ++w) {
            if (have[h] && w0 + w < W2) v[h][w] = __ldg(p[h] + w0 + w);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int w = 0; w < kWordChunk; ++w) {
            if (have[h] && w0 + w < W2)
              pay[(w0 + w) * cap + k0 + h * kSlotThreads] = v[h][w];
          }
        }
      }
    }
    __syncthreads();
    // verify and write the tile's slots, consecutive threads on
    // consecutive slots
    for (int64_t i = s + tid; i < s_end; i += kSlotThreads) {
      if (i >= live) {
        ok[i] = false;
        cand_a[i] = 0;
        cand_b[i] = 0;
        cand_ovl[i] = 0;
        continue;
      }
      const int rel = static_cast<int>(i - s);
      const int j = last_at_most(rrel, m, rel);
      const int e = re[j];
      const int t = rei0[j] + (rel - rrel[j]);
      const int qr = t / e;
      int ue = t - qr * e - rei0[j];
      if (ue < 0) ue += e;
      const int ka = rsoff[j] + rce[j] + qr;   // the query's staged row
      const int kb = rsoff[j] + ue;            // the entry's
      const int32_t a = srd[ka], b = srd[kb];
      const int p = (stt[ka] - g + 1) * g;     // query probe position in a
      const int o = stt[kb];                   // entry offset in b's prefix
      const int len_a = static_cast<int>(pay[(Wt + 1) * cap + ka]);
      const int len_b = static_cast<int>(pay[(Wt + 1) * cap + kb]);
      const int ovl = len_a - (p - o);
      bool match = a != b;
      // words past the seed (the first `trim` words are equal by the
      // key sort), compared over min(len_a - p, len_b - o) bases
      const int lc2 = 2 * min(len_a - p, len_b - o);
      for (int w = 0; w < Wt; ++w) {
        int vb = lc2 - (w + trim) * 32;
        vb = vb < 0 ? 0 : (vb > 32 ? 32 : vb);
        if (vb > 0 &&
            ((pay[w * cap + ka] ^ pay[w * cap + kb]) >> (32 - vb)) != 0u)
          match = false;
      }
      // the o bases of a before p equal b's first o bases
      const uint32_t lhs = pay[Wt * cap + ka] & ((1u << (2 * o)) - 1u);
      const uint32_t rhs = o == 0 ? 0u : (pay[Wt * cap + kb] >> (32 - 2 * o));
      match = match && lhs == rhs;
      ok[i] = match && ovl < len_b && ovl >= min_overlap;
      if (contained != nullptr && match && len_b <= ovl) contained[b] = 1;
      cand_a[i] = a;
      cand_b[i] = b;
      cand_ovl[i] = ovl;
    }
    cur = next;
    __syncthreads();      // the next tile overwrites the stage and the runs
  }
}

}  // namespace

// keys: (n,) sorted int64; rows: (n,) int32 row ids (read * R + slot);
// n_live: NULL (every row live) or an int64 in device memory, the live
// rows at the front; ctl: (3 + 2 tiles,) int64, tiles = max(1,
// ceil(n / 2048)), its words from 2 on zeroed here; base: (n / 2 + 1,)
// int64 and run: (n / 2,) int2 records (a run with candidates holds at
// least two rows). Writes ctl[0] = total, ctl[1] = runs, base[:runs + 1]
// and run[:runs].
SAGE2_EXPORT int sage2_join_runs(const void* keys, const void* rows,
                                 int64_t n, const void* n_live, int R, int g,
                                 void* ctl, void* base, void* run,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = count_tiles(n);
  cudaError_t rc = cudaMemsetAsync(static_cast<int64_t*>(ctl) + 2, 0,
                                   (1 + 2 * tiles) * sizeof(int64_t), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  join_runs_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(rows),
      n, static_cast<const int64_t*>(n_live), R, g,
      static_cast<int64_t*>(ctl), static_cast<int64_t*>(base),
      static_cast<int2*>(run));
  return static_cast<int>(cudaGetLastError());
}

// rows: the sorted row ids; ent_payload, qry_payload: (rows, W2) int32
// payload words, a row's at PayloadMap::row (in core: one payload indexed
// by row id, bases 0, strides R, qry_off 0; meshed: `perm` (n,) int64,
// the payload row of each sorted row in qry_payload, else NULL); ctl,
// base, run: sage2_join_runs'; n_out: the slots to write (at most the
// total; past it, in the fixed-capacity mode, the slots from the total on
// are not ok, with a, b and ovl 0); ok/cand_*: (n_out,) outputs;
// contained: (reads,) uint8 marks, or NULL.
SAGE2_EXPORT int sage2_join_slots(const void* rows, const void* ent_payload,
                                  int64_t ent_base, int ent_stride,
                                  const void* qry_payload, int64_t qry_base,
                                  int qry_stride, int qry_off, int W2,
                                  const void* perm, const void* ctl,
                                  const void* base, const void* run, int R,
                                  int g, int trim, int min_overlap,
                                  int64_t n_out, void* ok,
                                  void* cand_a, void* cand_b, void* cand_ovl,
                                  void* contained, void* stream) {
  static int sms = 0, device = -1;
  static size_t opted = 0;      // the dynamic shared memory allowed so far
  const auto s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev != device) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaFuncSetAttribute(join_slots_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    device = dev;
    opted = 0;
  }
  // past 48 KB with the static arrays, the stage needs the opt-in (which
  // refuses a stage past the block's 227 KB: rows of ~200 words)
  const size_t smem = slots_smem(W2);
  if (smem > opted) {
    rc = cudaFuncSetAttribute(join_slots_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    opted = smem;
  }
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, join_slots_kernel, kSlotThreads, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t tiles = (n_out + kSlotTile - 1) / kSlotTile;
  int64_t blocks = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > tiles) blocks = tiles;
  if (blocks < 1) blocks = 1;
  const PayloadMap pm{static_cast<const uint32_t*>(ent_payload), ent_base,
                      ent_stride, static_cast<const uint32_t*>(qry_payload),
                      qry_base, qry_stride, qry_off, W2,
                      static_cast<const int64_t*>(perm)};
  join_slots_kernel<<<static_cast<unsigned>(blocks), kSlotThreads, smem,
                      s>>>(
      static_cast<const int32_t*>(rows), pm, static_cast<const int64_t*>(ctl),
      static_cast<const int64_t*>(base), static_cast<const int2*>(run), R, g,
      trim, min_overlap, n_out, static_cast<bool*>(ok),
      static_cast<int32_t*>(cand_a), static_cast<int32_t*>(cand_b),
      static_cast<int32_t*>(cand_ovl), static_cast<uint8_t*>(contained));
  return static_cast<int>(cudaGetLastError());
}
