// The wave step above wave_peel's shared memory, for Hopper (sm_90a): peel
// W lanes to the k-core fixpoint with the lane state in global memory, and
// emit the packed core mask, the TTI and the edge count.
//
// Stands in for: src/repro/kernels/wave_peel/kernel.py::wave_peel_pallas
// above its VMEM budget, where the JAX package leaves the fused step for the
// XLA composite (src/repro/core/wave.py's peel_to_fixpoint chain).  Below
// the budget's counterpart here, V <= 370,688, csrc/wave_peel.cu runs.
//
// It computes what wave_peel.cu computes, in the same pair-level form
// (see there): per lane (window [ts, te], thresholds k and h, the lane's
// alive bytes a warm-start superset)
//   pairact(p) = (alive[u_p] && alive[v_p] ? wincnt(p) : 0) >= h
//   deg(v)     = number of half-pairs (v, p) with pairact(p)
//   alive(v)  &= deg(v) >= k
// until no vertex of any lane changes; then n_edges, TTI lo/hi, the
// LSB-first mask words and the iteration count, shared by the lanes as
// the composite's is; beside them, for each lane, how many half-pairs
// phase A kept of the table it walked (the pass's useful share).
//
// Where the state lives.  A lane's mask (V/8 bytes) and degrees do not fit
// a cluster's shared memory above that V, so they live in global memory,
// which L2 holds: the mask is the packed output itself ([W, V/32] words),
// the degrees two [W, V] int32 buffers that only the window's vertices
// ever touch.  One cooperative launch runs the whole step; grid-wide
// barriers separate its phases and the host reads nothing until it ends.
//
// Bound: phase A's pass over the half-pair table (its gathers of the pair
// tables, poff and t), then latency: two grid barriers an iteration over
// the few kept half-pairs of each lane.
//
// Each block takes one contiguous chunk of the half-pair table (sorted by
// vertex) for every lane.
//   A. For each chunk entry, its pair's band ends are read once for all
//      lanes; each lane's window count comes from two t-compares and binary
//      searches only where the band straddles a window end.  Entries that
//      can matter (wincnt >= 1, or all of them when h <= 0) are compacted in
//      order into the block's region of the lane's scratch: (vertex, other
//      endpoint, wincnt, first in-window edge).  The other endpoint of a kept
//      entry is a kept entry's vertex too, so only kept vertices ("touched")
//      can keep a degree above 0.
//   T. Each run of one vertex in a block's kept entries marks the vertex
//      touched and zeroes its two degree counters.
//   F. The lane's alive bytes become its mask words; where k > 0 a vertex
//      that is not touched has degree 0 and leaves now, which is iteration
//      1's verdict on it, so the change counts for iteration 1.
//   B. Jacobi iterations over the kept entries alone.  Accumulate: each
//      entry whose pair is active adds one to its vertex's degree, one
//      atomic per run of equal vertices in a warp (the entries are sorted
//      by vertex).  Update: each run's first entry clears its vertex's bit
//      where the degree is below k and zeroes the other buffer's counter,
//      which the next iteration accumulates into.  A vertex split between
//      two blocks is updated by both, with the same verdict.  The loop ends
//      after the first iteration that changes no vertex of any lane.
//   C. n_edges and the TTI come from the kept entries whose pair has both
//      endpoints alive (each pair counted at its lower endpoint), plus any
//      edge outside every pair band whose t the window holds; the mask
//      words are the packed output, and the alive bytes are rewritten in
//      place.
// Data other blocks change during the launch (mask words, degrees, touched
// words, the change flags) is read with ld.global.cg, past the SM's L1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 2;      // half-pairs a thread takes per round of A
constexpr int kGroup = 4;          // lanes compacted by one 64-bit scan
constexpr int kInitWords = 8;      // mask words a warp packs at once in F
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool bit_cg(const unsigned* mask, int v) {
  return (__ldcg(mask + (v >> 5)) >> (v & 31)) & 1u;
}

// First index in [lo, hi) whose t is >= key (t[lo, hi) sorted).
__device__ __forceinline__ int lower_bound(const int* __restrict__ t, int lo,
                                           int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (t[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First index in [lo, hi) whose t is > key.
__device__ __forceinline__ int upper_bound(const int* __restrict__ t, int lo,
                                           int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (t[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Exclusive prefix of `x` over the block (in thread order) and the total;
// x holds kGroup 16-bit counts, which the sums keep apart.
__device__ __forceinline__ unsigned long long block_exclusive_scan(
    unsigned long long x, unsigned long long* s_warp,
    unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned long long w = lane < kWarps ? s_warp[lane] : 0ull;
    unsigned long long wi = w;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < kWarps) s_warp[lane] = wi - w;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  return s_warp[warp] + incl - x;
}

__device__ __forceinline__ int field(unsigned long long x, int l) {
  return static_cast<int>((x >> (16 * l)) & 0xffffu);
}

// The lane of flattened entry j of a block: the last l with koff[l] <= j.
__device__ __forceinline__ int lane_of(const int* koff, int w, int j) {
  int lo = 0, hi = w;          // koff[0] = 0 <= j < koff[w]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (koff[mid] <= j) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads, 2) wave_peel_global_kernel(
    const int* __restrict__ ts, const int* __restrict__ te,
    const int* __restrict__ kk, const int* __restrict__ hh,
    const int* __restrict__ t, const int* __restrict__ src,
    const int* __restrict__ dst, int num_edges,
    const int* __restrict__ pair_u, const int* __restrict__ pair_v,
    const int* __restrict__ poff, int num_pairs,
    const int* __restrict__ hp_src, const int* __restrict__ hp_pair,
    const int* __restrict__ hoff, int num_vertices, int orphan_tmin,
    int orphan_tmax, uint8_t* alive_all, int4* halves_all, int halves_cap,
    unsigned* mask_all, unsigned* touched_all, int* deg_all, int* flags,
    int num_words, int* __restrict__ lo_out, int* __restrict__ hi_out,
    int* __restrict__ ne_out, int* __restrict__ it_out,
    int* __restrict__ kept_out, int num_lanes) {
  cg::grid_group grid = cg::this_grid();
  // per lane: ts, te, k, h, kept count, and the kept counts' prefix
  extern __shared__ int s_dyn[];
  int* s_ts = s_dyn;
  int* s_te = s_ts + num_lanes;
  int* s_k = s_te + num_lanes;
  int* s_h = s_k + num_lanes;
  int* s_kept = s_h + num_lanes;
  int* s_koff = s_kept + num_lanes;          // num_lanes + 1 entries
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ unsigned long long s_total;
  __shared__ int s_red[3][kWarps];

  const int W = num_lanes, nv = num_vertices;
  const int tid = threadIdx.x, lid = tid & 31, warp = tid >> 5;
  const int nblocks = gridDim.x, b = blockIdx.x;
  const size_t lane_verts = static_cast<size_t>(W) * nv;
  const size_t gtid = static_cast<size_t>(b) * kThreads + tid;
  const size_t gstride = static_cast<size_t>(nblocks) * kThreads;

  for (int l = tid; l < W; l += kThreads) {
    s_ts[l] = ts[l];
    s_te[l] = te[l];
    s_k[l] = kk[l];
    s_h[l] = hh[l];
    s_kept[l] = 0;
  }
  for (size_t i = gtid; i < static_cast<size_t>(W) * num_words;
       i += gstride) {
    touched_all[i] = 0u;
  }
  if (b == 0) {
    for (int l = tid; l < W; l += kThreads) {
      lo_out[l] = INT_MAX;
      hi_out[l] = INT_MIN;
      ne_out[l] = 0;
      kept_out[l] = 0;
    }
    if (tid < 2) flags[tid] = 0;
  }
  grid.sync();          // touched words and flags are zero

  // A: this block's chunk of the half-pairs, each lane's kept entries
  // compacted in order into the chunk's region of the lane's scratch
  const int nh = hoff[nv];
  const int per = (nh + nblocks - 1) / nblocks;
  const int hs = min(b * per, nh), he = min(hs + per, nh);
  for (int base = hs; base < he; base += kThreads * kPerThread) {
    int v[kPerThread], other[kPerThread], a0[kPerThread], b0[kPerThread];
    int ta[kPerThread], tb[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = base + tid * kPerThread + j;
      v[j] = i < he ? hp_src[i] : -1;
      other[j] = i < he ? hp_pair[i] : 0;       // the pair, for now
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int p = other[j];
      a0[j] = v[j] >= 0 ? poff[p] : 0;
      b0[j] = v[j] >= 0 ? poff[p + 1] : 0;
      const int u = v[j] >= 0 ? pair_u[p] : 0;
      other[j] = u == v[j] ? pair_v[p] : u;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const bool some = a0[j] < b0[j];
      ta[j] = some ? t[a0[j]] : INT_MAX;
      tb[j] = some ? t[b0[j] - 1] : INT_MIN;
    }
    for (int g0 = 0; g0 < W; g0 += kGroup) {
      int cnt[kGroup][kPerThread], first[kGroup][kPerThread];
      unsigned long long keep = 0ull;
#pragma unroll
      for (int l = 0; l < kGroup; ++l) {
        const int L = g0 + l;
        const int t0 = L < W ? s_ts[L] : 1, t1 = L < W ? s_te[L] : 0;
        const int h = L < W ? s_h[L] : 1;
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          int a = a0[j], c = 0;
          if (t0 <= t1 && ta[j] <= t1 && tb[j] >= t0) {
            const int bb = b0[j];
            if (ta[j] < t0) a = lower_bound(t, a + 1, bb, t0);
            c = (tb[j] > t1 ? upper_bound(t, a, bb - 1, t1) : bb) - a;
          }
          cnt[l][j] = c;
          first[l][j] = a;
          const bool kept = L < W && v[j] >= 0 && (c > 0 || h <= 0);
          keep += static_cast<unsigned long long>(kept) << (16 * l);
        }
      }
      const unsigned long long pos = block_exclusive_scan(keep, s_warp,
                                                          &s_total);
      const unsigned long long total = s_total;
#pragma unroll
      for (int l = 0; l < kGroup; ++l) {
        const int L = g0 + l;
        if (L >= W) break;
        const int h = s_h[L];
        int at = s_kept[L] + field(pos, l);
        int4* halves = halves_all + static_cast<size_t>(L) * halves_cap + hs;
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          if (v[j] >= 0 && (cnt[l][j] > 0 || h <= 0)) {
            halves[at++] = make_int4(v[j], other[j], cnt[l][j], first[l][j]);
          }
        }
      }
      __syncthreads();       // every thread has read s_kept
      if (tid == 0) {
        for (int l = 0; l < kGroup && g0 + l < W; ++l) {
          s_kept[g0 + l] += field(total, l);
        }
      }
      __syncthreads();
    }
  }
  if (tid == 0) {
    s_koff[0] = 0;
    for (int l = 0; l < W; ++l) s_koff[l + 1] = s_koff[l] + s_kept[l];
  }
  __syncthreads();
  for (int l = tid; l < W; l += kThreads) {
    if (s_kept[l]) atomicAdd(kept_out + l, s_kept[l]);
  }
  const int kept_all = s_koff[W];
  const int rounds = (kept_all + kThreads - 1) / kThreads * kThreads;

  // T: every run of one vertex marks it touched and zeroes its counters
  for (int j = tid; j < kept_all; j += kThreads) {
    const int L = lane_of(s_koff, W, j), jl = j - s_koff[L];
    const int4* halves = halves_all + static_cast<size_t>(L) * halves_cap + hs;
    const int x = halves[jl].x;
    if (jl == 0 || halves[jl - 1].x != x) {
      atomicOr(touched_all + static_cast<size_t>(L) * num_words + (x >> 5),
               1u << (x & 31));
      const size_t at = static_cast<size_t>(L) * nv + x;
      deg_all[at] = 0;
      deg_all[lane_verts + at] = 0;
    }
  }
  grid.sync();

  // F: alive bytes -> mask words; untouched vertices leave where k > 0
  const int all_words = W * num_words;
  {
    int changed = 0;
    const int gwarp = static_cast<int>(gtid >> 5);
    const int nwarps = static_cast<int>(gstride >> 5);
    for (int base = gwarp * kInitWords; base < all_words;
         base += nwarps * kInitWords) {
      bool on[kInitWords];
#pragma unroll
      for (int j = 0; j < kInitWords; ++j) {
        const int wi = base + j, L = wi / num_words;
        const int vv = (wi - L * num_words) * 32 + lid;
        on[j] = wi < all_words && vv < nv &&
                alive_all[static_cast<size_t>(L) * nv + vv] != 0;
      }
#pragma unroll
      for (int j = 0; j < kInitWords; ++j) {
        const int wi = base + j;
        const unsigned cw = __ballot_sync(kFull, on[j]);
        if (lid == 0 && wi < all_words) {
          const int L = wi / num_words;
          const unsigned nw =
              s_k[L] > 0 ? cw & __ldcg(touched_all + wi) : cw;
          changed |= nw != cw;
          mask_all[wi] = nw;
        }
      }
    }
    if (changed) atomicExch(flags, 1);
  }
  grid.sync();

  // B: Jacobi iterations over the kept entries
  int iters = 0;
  for (;;) {
    const int cur = iters & 1;
    int* dacc = deg_all + cur * lane_verts;
    int* dnext = deg_all + (cur ^ 1) * lane_verts;
    for (int j = tid; j < rounds; j += kThreads) {
      bool act = false;
      unsigned long long key = ~0ull;
      if (j < kept_all) {
        const int L = lane_of(s_koff, W, j);
        const int4 r = halves_all[static_cast<size_t>(L) * halves_cap + hs +
                                  (j - s_koff[L])];
        const unsigned* mask = mask_all + static_cast<size_t>(L) * num_words;
        act = ((bit_cg(mask, r.x) && bit_cg(mask, r.y)) ? r.z : 0) >= s_h[L];
        key = static_cast<unsigned long long>(L) * nv + r.x;
      }
      const unsigned on = __ballot_sync(kFull, act);
      const unsigned same = __match_any_sync(kFull, key) & on;
      if (act && lid == __ffs(same) - 1) {
        atomicAdd(dacc + key, __popc(same));
      }
    }
    grid.sync();            // every degree of this iteration is in
    int changed = 0;
    for (int j = tid; j < kept_all; j += kThreads) {
      const int L = lane_of(s_koff, W, j), jl = j - s_koff[L];
      const int4* halves = halves_all + static_cast<size_t>(L) * halves_cap +
                           hs;
      const int x = halves[jl].x;
      if (jl == 0 || halves[jl - 1].x != x) {
        const size_t at = static_cast<size_t>(L) * nv + x;
        unsigned* word = mask_all + static_cast<size_t>(L) * num_words +
                         (x >> 5);
        const unsigned m = 1u << (x & 31);
        if ((__ldcg(word) & m) && __ldcg(dacc + at) < s_k[L]) {
          atomicAnd(word, ~m);
          changed = 1;
        }
        dnext[at] = 0;
      }
    }
    // the other flag was last read before this iteration's first barrier
    if (b == 0 && tid == 0) flags[cur ^ 1] = 0;
    changed = __syncthreads_or(changed);
    if (changed && tid == 0) atomicExch(flags + cur, 1);
    grid.sync();            // every mask holds next, every flag is in
    ++iters;
    if (!__ldcg(flags + cur)) break;
  }

  // C: outputs from the final masks
  for (int L = 0; L < W; ++L) {
    const unsigned* fin = mask_all + static_cast<size_t>(L) * num_words;
    const int4* halves = halves_all + static_cast<size_t>(L) * halves_cap + hs;
    const int t0 = s_ts[L], t1 = s_te[L];
    int ne = 0, lo = INT_MAX, hi = INT_MIN;
    for (int j = tid; j < s_kept[L]; j += kThreads) {
      const int4 r = halves[j];
      if (r.z > 0 && r.x < r.y && bit_cg(fin, r.x) && bit_cg(fin, r.y)) {
        ne += r.z;
        lo = min(lo, t[r.w]);
        hi = max(hi, t[r.w + r.z - 1]);
      }
    }
    if (t0 <= orphan_tmax && t1 >= orphan_tmin && t0 <= t1) {
      for (size_t e = poff[num_pairs] + gtid;
           e < static_cast<size_t>(num_edges); e += gstride) {
        const int te_ = t[e];
        if (te_ >= t0 && te_ <= t1 && bit_cg(fin, src[e]) &&
            bit_cg(fin, dst[e])) {
          ++ne;
          lo = min(lo, te_);
          hi = max(hi, te_);
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      ne += __shfl_down_sync(kFull, ne, off);
      lo = min(lo, __shfl_down_sync(kFull, lo, off));
      hi = max(hi, __shfl_down_sync(kFull, hi, off));
    }
    if (lid == 0) {
      s_red[0][warp] = ne;
      s_red[1][warp] = lo;
      s_red[2][warp] = hi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) {
        ne += s_red[0][w];
        lo = min(lo, s_red[1][w]);
        hi = max(hi, s_red[2][w]);
      }
      if (ne) {
        atomicAdd(ne_out + L, ne);
        atomicMin(lo_out + L, lo);
        atomicMax(hi_out + L, hi);
      }
    }
    __syncthreads();
  }
  // a warp a mask word: its 32 alive bytes
  for (int wi = static_cast<int>(gtid >> 5); wi < all_words;
       wi += static_cast<int>(gstride >> 5)) {
    const int L = wi / num_words, vv = (wi - L * num_words) * 32 + lid;
    if (vv < nv) {
      alive_all[static_cast<size_t>(L) * nv + vv] =
          (__ldcg(mask_all + wi) >> lid) & 1u;
    }
  }
  if (b == 0) {
    for (int l = tid; l < W; l += kThreads) it_out[l] = iters;
  }
}

}  // namespace

// One cooperative launch of as many blocks as the card holds at once.
// alive [W, V] uint8 is peeled in place; halves is a [W, halves_cap] int4
// scratch (halves_cap = the half-pair count, 2P), touched a [W, num_words]
// and deg a [2, W, V] int32 scratch, flags 2 ints; none needs to be zeroed.
// poff [P + 1] and hoff [V + 1] are the first edge of each pair band and the
// first half-pair of each vertex.  Outputs: packed [W, num_words] int32
// (uint32 bit patterns, the lanes' masks during the launch), lo/hi/ne/iters
// [W] int32, and kept [W] int32: the half-pairs phase A kept for each lane.
// Launches on `stream`; returns the launch's CUDA error code.
extern "C" int wave_peel_global_launch(
    const void* ts, const void* te, const void* k, const void* h,
    const void* t, const void* src, const void* dst, int num_edges,
    const void* pair_u, const void* pair_v, const void* poff, int num_pairs,
    const void* hp_src, const void* hp_pair, const void* hoff,
    int num_vertices, int orphan_tmin, int orphan_tmax, void* alive,
    void* halves, int halves_cap, void* packed, void* touched, void* deg,
    void* flags, int num_words, void* lo, void* hi, void* ne, void* iters,
    void* kept, int num_lanes, void* stream) {
  if (num_lanes <= 0) return 0;
  const size_t smem = sizeof(int) * (6 * static_cast<size_t>(num_lanes) + 1);
  // the grid the card holds at once, kept for the last (device, W)
  static int last_dev = -1, last_lanes = -1, last_grid = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != last_dev || num_lanes != last_lanes) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, wave_peel_global_kernel, kThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) {
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    }
    last_dev = dev;
    last_lanes = num_lanes;
    last_grid = sms * per_sm;
  }
  void* args[] = {
      const_cast<void**>(&ts), const_cast<void**>(&te),
      const_cast<void**>(&k), const_cast<void**>(&h),
      const_cast<void**>(&t), const_cast<void**>(&src),
      const_cast<void**>(&dst), &num_edges,
      const_cast<void**>(&pair_u), const_cast<void**>(&pair_v),
      const_cast<void**>(&poff), &num_pairs,
      const_cast<void**>(&hp_src), const_cast<void**>(&hp_pair),
      const_cast<void**>(&hoff), &num_vertices, &orphan_tmin, &orphan_tmax,
      &alive, &halves, &halves_cap, &packed, &touched, &deg, &flags,
      &num_words, &lo, &hi, &ne, &iters, &kept, &num_lanes};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(wave_peel_global_kernel),
      dim3(last_grid), dim3(kThreads), args, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
