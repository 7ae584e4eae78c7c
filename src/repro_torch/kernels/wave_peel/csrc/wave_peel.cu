// One whole wave step for Hopper (sm_90a): peel W lanes to the k-core
// fixpoint and emit the packed core mask, the TTI and the edge count.
//
// Replaces: src/repro/kernels/wave_peel/kernel.py::wave_peel_pallas (body
// `_kernel`, helper `_banded_count`).
//
// Per lane (one query cell: window [ts, te], thresholds k and h), with the
// lane's vertex mask `alive` as a warm-start superset, the TPU kernel loops
// until no vertex of the lane changes:
//   ea(e)      = ts <= t[e] <= te  &&  alive[src[e]]  &&  alive[dst[e]]
//   pairact(p) = |{e in band(p) : ea(e)}| >= h
//   deg(v)     = number of half-pairs (v, p) with pairact(p)
//   alive(v)  &= deg(v) >= k
// then emits n_edges = |ea|, TTI lo/hi = min/max t over ea (INT_MAX/INT_MIN
// when the lane is empty), the LSB-first 32-bit mask words and the lane's
// iteration count.
//
// Every edge of pair p joins pair_u[p] and pair_v[p], and the band of p is
// sorted by t (the canonical TEL order, checked by the wrapper), so
//   |{e in band(p) : ea(e)}| = alive[u_p] && alive[v_p] ? wincnt(p) : 0
// where wincnt(p), the edges of the band inside the window, is fixed for the
// launch and comes from two binary searches.  The fixpoint therefore never
// reads an edge, and a pair with wincnt(p) = 0 can matter only when h <= 0.
//
// Bound: latency.  The TPU kernel re-derives edge activity densely every
// iteration because a [w, E] pass is what its VMEM and vector unit do well;
// here that would walk 262k edges per iteration to touch the few thousand
// pairs a query window meets.  Design: one thread-block cluster of 8
// blocks per lane (W lanes run as W clusters, in waves).  Block r of a
// lane owns a slice of vertices (a whole number of mask words): their
// degree counters and the authority over their mask bits.  The work is
// split apart from that: block r takes the r-th eighth of the half-pair
// table (sorted by vertex), so a hub vertex's thousands of half-pairs
// spread over the cluster instead of landing on one block.
//   A. Each block computes wincnt for its half-pairs (the window's edges in
//      the pair's band: two t-compares, and binary searches only when the
//      band straddles a window end) and compacts the ones that can matter
//      (wincnt >= 1, or all of them when h <= 0), in order, into its own
//      region of a global scratch: (vertex, other endpoint, wincnt, first
//      in-window edge).
//   B. Jacobi iterations.  Each block keeps the lane's whole alive bitmask
//      in shared memory (V/8 bytes) and the degree counters of its slice.
//      It adds one to a vertex's counter for each kept half-pair whose pair
//      is active under the mask (distributed-shared-memory atomics into the
//      owner block, one per run of equal vertices in a warp); after a
//      cluster barrier each block computes its slice of
//      next = cur & (deg >= k) and stores those words into the mask of
//      every block of the cluster; after a second barrier all masks hold
//      next.  A block reads only its own slice's words while others write
//      theirs, so one mask suffices.  The loop ends after the first
//      iteration that changes no vertex of the lane, and counts it, as the
//      composite does.
//   C. n_edges and the TTI come from the kept half-pairs whose pair has
//      both endpoints alive (each pair counted at its lower endpoint), plus
//      any edge outside every pair band (capacity padding) whose t the
//      window holds; block 0 gathers the blocks' partials.  Each block
//      writes its slice of the alive bytes (in place) and of the packed
//      words.
// Size limit: the mask and the degree slice take 5 bytes per vertex slot
// of shared memory in each block, so V <= 8 x 46,336 = 370,688 on an H100
// (wave_peel_max_vertices; the wrapper raises above it).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;        // blocks per lane (portable cluster size)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;      // half-pairs a thread takes per round of A
constexpr int kInitWords = 8;      // mask words a warp loads at once
constexpr unsigned kFull = 0xffffffffu;

// Vertices each block of a lane owns: a whole number of 32-bit mask words,
// at least one.
__host__ __device__ __forceinline__ int slice_vertices(int v) {
  const int per = ((v + kCluster - 1) / kCluster + 31) / 32 * 32;
  return per < 32 ? 32 : per;
}

// Dynamic shared memory of one block: the full mask and a degree slice.
__host__ __device__ __forceinline__ long long smem_bytes(int v) {
  const long long vb = slice_vertices(v);
  return 4 * (vb / 32 * kCluster) + 4 * vb;
}

__device__ __forceinline__ bool bit(const unsigned* mask, int v) {
  return (mask[v >> 5] >> (v & 31)) & 1u;
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

// Exclusive prefix of `x` over the block (in thread order) and the total.
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = s_warp[lane];
    int wi = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, off);
      if (lane >= off) wi += y;
    }
    s_warp[lane] = wi - w;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  return s_warp[warp] + incl - x;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
wave_peel_kernel(
    const int* __restrict__ ts, const int* __restrict__ te,
    const int* __restrict__ kk, const int* __restrict__ hh,
    const int* __restrict__ t, const int* __restrict__ src,
    const int* __restrict__ dst, int num_edges,
    const int* __restrict__ pair_u, const int* __restrict__ pair_v,
    const int* __restrict__ poff, int num_pairs,
    const int* __restrict__ hp_src, const int* __restrict__ hp_pair,
    const int* __restrict__ hoff, int num_vertices, int orphan_tmin,
    int orphan_tmax, uint8_t* alive_all, int4* halves_all, int halves_cap,
    int* __restrict__ packed, int num_words, int* __restrict__ lo_out,
    int* __restrict__ hi_out, int* __restrict__ ne_out,
    int* __restrict__ it_out) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned smem[];
  __shared__ int s_flags[kCluster];
  __shared__ int s_part[3][kCluster];
  __shared__ int s_warp[kWarps];
  __shared__ int s_red[3][kWarps];
  __shared__ int s_total, s_kept;

  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lid = tid & 31, warp = tid >> 5;
  const int nv = num_vertices;
  const int vb = slice_vertices(nv);
  const int words = vb / 32 * kCluster;      // words of one full mask
  const int v0 = rank * vb, w0 = v0 / 32;    // this block's slice
  unsigned* const mask = smem;
  int* deg = reinterpret_cast<int*>(smem + words);
  const int t0 = ts[lane], t1 = te[lane], k = kk[lane], h = hh[lane];
  uint8_t* alive = alive_all + static_cast<size_t>(lane) * nv;

  // the lane's mask (bits past V stay 0) and this slice's zero degrees;
  // each warp loads kInitWords words' bytes before it packs them
  for (int base = warp * 32 * kInitWords; base < words * 32;
       base += kThreads * kInitWords) {
    bool on[kInitWords];
#pragma unroll
    for (int j = 0; j < kInitWords; ++j) {
      const int v = base + j * 32 + lid;
      on[j] = v < nv && alive[v] != 0;
    }
#pragma unroll
    for (int j = 0; j < kInitWords; ++j) {
      const unsigned w = __ballot_sync(kFull, on[j]);
      const int wi = (base >> 5) + j;
      if (lid == 0 && wi < words) mask[wi] = w;
    }
  }
  for (int i = tid; i < vb; i += kThreads) deg[i] = 0;
  if (tid == 0) s_kept = 0;

  // A: window counts of this block's eighth of the half-pairs, compacted
  // in order
  const int nh = hoff[nv], per = (nh + kCluster - 1) / kCluster;
  const int hs = min(rank * per, nh), he = min(hs + per, nh);
  int4* halves = halves_all + static_cast<size_t>(lane) * halves_cap + hs;
  for (int base = hs; base < he; base += kThreads * kPerThread) {
    // each stage's loads are independent across the thread's half-pairs,
    // so they are in flight together
    int4 rec[kPerThread];     // (vertex, pair -> other end, band a, band b)
    int ta[kPerThread], tb[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = base + tid * kPerThread + j;
      rec[j].x = i < he ? hp_src[i] : -1;
      rec[j].y = i < he ? hp_pair[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int p = rec[j].y;
      rec[j].z = poff[p];
      rec[j].w = poff[p + 1];
      const int u = pair_u[p];
      rec[j].y = u == rec[j].x ? pair_v[p] : u;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const bool some = rec[j].z < rec[j].w && t0 <= t1;
      ta[j] = some ? t[rec[j].z] : INT_MAX;
      tb[j] = some ? t[rec[j].w - 1] : INT_MIN;
    }
    int keep = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      int a = rec[j].z, cnt = 0;
      if (ta[j] <= t1 && tb[j] >= t0) {
        const int b = rec[j].w;
        if (ta[j] < t0) a = lower_bound(t, a + 1, b, t0);
        cnt = (tb[j] > t1 ? upper_bound(t, a, b - 1, t1) : b) - a;
      }
      const bool kept = rec[j].x >= 0 && (cnt > 0 || h <= 0);
      rec[j] = make_int4(kept ? rec[j].x : -1, rec[j].y, cnt, a);
      keep += kept;
    }
    int pos = block_exclusive_scan(keep, s_warp, &s_total);
    pos += s_kept;      // read after the scan's barriers
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (rec[j].x >= 0) halves[pos++] = rec[j];
    }
    __syncthreads();
    if (tid == 0) s_kept += s_total;
    __syncthreads();
  }
  cluster.sync();       // every block of the lane is running and set up
  const int kept = s_kept;

  // B: Jacobi iterations on the pair graph
  int iters = 0;
  for (;;) {
    for (int base = 0; base < kept; base += kThreads) {
      const int j = base + tid;
      int v = -1;
      bool act = false;
      if (j < kept) {
        const int4 r = halves[j];
        v = r.x;
        act = ((bit(mask, r.x) && bit(mask, r.y)) ? r.z : 0) >= h;
      }
      const unsigned on = __ballot_sync(kFull, act);
      const unsigned same = __match_any_sync(kFull, v) & on;
      if (act && lid == __ffs(same) - 1) {
        atomicAdd(cluster.map_shared_rank(deg, v / vb) + v % vb,
                  __popc(same));
      }
    }
    cluster.sync();     // every degree of this iteration is in
    int changed = 0;
    for (int base = warp * 32; base < vb; base += kThreads) {
      const int wi = w0 + (base >> 5);
      const unsigned cw = mask[wi];
      const int d = deg[base + lid];
      deg[base + lid] = 0;
      const unsigned nw = __ballot_sync(kFull, ((cw >> lid) & 1u) && d >= k);
      changed |= nw != cw;
      if (lid < kCluster) cluster.map_shared_rank(mask, lid)[wi] = nw;
    }
    changed = __syncthreads_or(changed);
    if (tid < kCluster) cluster.map_shared_rank(s_flags, tid)[rank] = changed;
    cluster.sync();     // every mask holds next
    int any = 0;
    for (int r = 0; r < kCluster; ++r) any |= s_flags[r];
    ++iters;
    if (!any) break;
  }

  // C: outputs from the final mask
  const unsigned* fin = mask;
  int ne = 0, lo = INT_MAX, hi = INT_MIN;
  for (int j = tid; j < kept; j += kThreads) {
    const int4 r = halves[j];
    if (r.z > 0 && r.x < r.y && bit(fin, r.x) && bit(fin, r.y)) {
      ne += r.z;
      lo = min(lo, t[r.w]);
      hi = max(hi, t[r.w + r.z - 1]);
    }
  }
  if (t0 <= orphan_tmax && t1 >= orphan_tmin && t0 <= t1) {
    for (int e = poff[num_pairs] + rank * kThreads + tid; e < num_edges;
         e += kCluster * kThreads) {
      const int te_ = t[e];
      if (te_ >= t0 && te_ <= t1 && bit(fin, src[e]) && bit(fin, dst[e])) {
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
    int* part = cluster.map_shared_rank(&s_part[0][0], 0);
    part[rank] = ne;
    part[kCluster + rank] = lo;
    part[2 * kCluster + rank] = hi;
  }
  for (int i = tid; i < vb && v0 + i < nv; i += kThreads) {
    alive[v0 + i] = bit(fin, v0 + i);
  }
  for (int w = tid; w < vb / 32 && w0 + w < num_words; w += kThreads) {
    packed[static_cast<size_t>(lane) * num_words + w0 + w] =
        static_cast<int>(fin[w0 + w]);
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    ne = 0;
    lo = INT_MAX;
    hi = INT_MIN;
    for (int r = 0; r < kCluster; ++r) {
      ne += s_part[0][r];
      lo = min(lo, s_part[1][r]);
      hi = max(hi, s_part[2][r]);
    }
    ne_out[lane] = ne;
    lo_out[lane] = lo;
    hi_out[lane] = hi;
    it_out[lane] = iters;
  }
}

}  // namespace

// Largest V whose mask and degree slice (smem_bytes = 5 x slice_vertices)
// fit one block's shared memory on the current device; -1 if the device
// cannot be queried.
extern "C" int wave_peel_max_vertices() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, wave_peel_kernel) != cudaSuccess) {
    return -1;
  }
  const long long room = optin - static_cast<long long>(attr.sharedSizeBytes);
  return static_cast<int>(room / 5 / 32 * 32 * kCluster);
}

// One cluster of 8 blocks per lane.  alive [W, V] uint8 is peeled in place;
// halves is a [W, halves_cap] int4 scratch (halves_cap = the half-pair
// count, 2P).  poff [P + 1] and hoff [V + 1] are the first edge of each
// pair band and the first half-pair of each vertex.  Outputs: packed
// [W, num_words] int32 (uint32 bit patterns), lo/hi/ne/iters [W] int32.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int wave_peel_launch(
    const void* ts, const void* te, const void* k, const void* h,
    const void* t, const void* src, const void* dst, int num_edges,
    const void* pair_u, const void* pair_v, const void* poff, int num_pairs,
    const void* hp_src, const void* hp_pair, const void* hoff,
    int num_vertices, int orphan_tmin, int orphan_tmax, void* alive,
    void* halves, int halves_cap, void* packed, int num_words, void* lo,
    void* hi, void* ne, void* iters, int num_lanes, void* stream) {
  static long long configured = 48 * 1024;
  const long long smem = smem_bytes(num_vertices);
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wave_peel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  if (num_lanes > 0) {
    wave_peel_kernel<<<num_lanes * kCluster, kThreads,
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ts), static_cast<const int*>(te),
        static_cast<const int*>(k), static_cast<const int*>(h),
        static_cast<const int*>(t), static_cast<const int*>(src),
        static_cast<const int*>(dst), num_edges,
        static_cast<const int*>(pair_u), static_cast<const int*>(pair_v),
        static_cast<const int*>(poff), num_pairs,
        static_cast<const int*>(hp_src), static_cast<const int*>(hp_pair),
        static_cast<const int*>(hoff), num_vertices, orphan_tmin,
        orphan_tmax, static_cast<uint8_t*>(alive),
        static_cast<int4*>(halves), halves_cap, static_cast<int*>(packed),
        num_words, static_cast<int*>(lo), static_cast<int*>(hi),
        static_cast<int*>(ne), static_cast<int*>(iters));
  }
  return static_cast<int>(cudaGetLastError());
}
