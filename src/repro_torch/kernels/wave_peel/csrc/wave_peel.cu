// One whole wave step for Hopper (sm_90a): peel W lanes to the k-core
// fixpoint and emit the packed core mask, the TTI and the edge count.
//
// Replaces: src/repro/kernels/wave_peel/kernel.py::wave_peel_pallas (body
// `_kernel`, helper `_banded_count`).
//
// Per lane (one query cell: window [ts, te], thresholds k and h), with the
// lane's vertex mask `alive` as a warm-start superset, loop until no vertex
// of the lane changes:
//   ea(e)      = ts <= t[e] <= te  &&  alive[src[e]]  &&  alive[dst[e]]
//   pairact(p) = |{e in band(p) : ea(e)}| >= h        band(p) = [ps[p], pe[p])
//   deg(v)     = sum of pairact(hp_pair[i]) over i in [vs[v], ve[v])
//   alive(v)  &= deg(v) >= k
// then emit n_edges = |ea|, TTI lo/hi = min/max t over ea (INT_MAX/INT_MIN
// when the lane is empty), the LSB-first 32-bit mask words and the lane's
// iteration count.  The bands come from the canonical TEL sort: edges by
// (pair_id, t), half-pairs by vertex, so each segment is a contiguous run.
//
// Bound: memory.  Each iteration of each lane reads the pair and vertex
// band tables and gathers endpoint bits; there is a compare or an add per
// element read.  The TPU kernel keeps the whole TEL resident in VMEM
// (12 MiB budget); a Hopper SM has 227 KB of shared memory, so here the
// tables stream from L2/HBM every iteration and only the lane state is the
// block's own.  Design: one thread block per lane runs that lane's whole
// fixpoint, with no grid-wide sync.  Phase 1 strides threads over pairs and
// walks each pair's edge band directly (the TPU's prefix-sum range
// difference existed only to vectorise), stopping once the count reaches h;
// it writes one byte per pair to a per-lane scratch.  Phase 2 strides
// threads over alive vertices, sums the active half-pairs of the vertex
// band, stopping once the sum reaches k, and clears the vertex in place.
// That is safe because phase 2 reads only the scratch and the vertex's own
// byte, so the update is exactly the composite's Jacobi step
// new = cur & (deg(cur) >= k); __syncthreads_or ends the loop.  A lane is
// unchanged from its first fixpoint iteration on, so the maximum of the
// per-lane counts equals the composite's shared iteration count.  Known
// costs, left for later work: W <= 64 blocks under-fill 132 SMs, and hub
// vertices make the vertex bands uneven, so a warp can wait on one vertex.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) wave_peel_kernel(
    const int* __restrict__ ts, const int* __restrict__ te,
    const int* __restrict__ kk, const int* __restrict__ hh,
    const int* __restrict__ t, const int* __restrict__ src,
    const int* __restrict__ dst, int num_edges,
    const int* __restrict__ hp_pair, const int* __restrict__ ps,
    const int* __restrict__ pe, int num_pairs, const int* __restrict__ vs,
    const int* __restrict__ ve, int num_vertices, uint8_t* alive_all,
    uint8_t* pairact_all, int* __restrict__ packed, int num_words,
    int* __restrict__ lo_out, int* __restrict__ hi_out,
    int* __restrict__ ne_out, int* __restrict__ it_out) {
  const int lane = blockIdx.x;
  const int t0 = ts[lane], t1 = te[lane], k = kk[lane], h = hh[lane];
  // written by this block only; not __restrict__, since other threads of the
  // block update them between barriers
  uint8_t* alive = alive_all + static_cast<size_t>(lane) * num_vertices;
  uint8_t* pairact = pairact_all + static_cast<size_t>(lane) * num_pairs;

  int iters = 0;
  int changed;
  do {
    for (int p = threadIdx.x; p < num_pairs; p += kThreads) {
      int cnt = 0;
      const int end = pe[p];
      for (int e = ps[p]; e < end && cnt < h; ++e) {
        const int te_ = t[e];
        cnt += (te_ >= t0) & (te_ <= t1) & (alive[src[e]] != 0) &
               (alive[dst[e]] != 0);
      }
      pairact[p] = cnt >= h;
    }
    __syncthreads();
    int mine = 0;
    for (int v = threadIdx.x; v < num_vertices; v += kThreads) {
      if (!alive[v]) continue;
      int deg = 0;
      const int end = ve[v];
      for (int i = vs[v]; i < end && deg < k; ++i) deg += pairact[hp_pair[i]];
      if (deg < k) {
        alive[v] = 0;
        mine = 1;
      }
    }
    ++iters;
    changed = __syncthreads_or(mine);
  } while (changed);

  // the last iteration changed nothing, so ea over the final mask is the
  // fixpoint's edge activity
  int ne = 0, lo = INT_MAX, hi = INT_MIN;
  for (int e = threadIdx.x; e < num_edges; e += kThreads) {
    const int te_ = t[e];
    if (te_ >= t0 && te_ <= t1 && alive[src[e]] && alive[dst[e]]) {
      ++ne;
      lo = min(lo, te_);
      hi = max(hi, te_);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    ne += __shfl_down_sync(0xffffffffu, ne, off);
    lo = min(lo, __shfl_down_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_down_sync(0xffffffffu, hi, off));
  }
  __shared__ int s_ne[kWarps], s_lo[kWarps], s_hi[kWarps];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    s_ne[warp] = ne;
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      ne += s_ne[w];
      lo = min(lo, s_lo[w]);
      hi = max(hi, s_hi[w]);
    }
    ne_out[lane] = ne;
    lo_out[lane] = lo;
    hi_out[lane] = hi;
    it_out[lane] = iters;
  }

  // vertex v is bit v % 32 of word v / 32; bits past num_vertices stay 0
  for (int w = threadIdx.x; w < num_words; w += kThreads) {
    unsigned word = 0u;
    const int base = w * 32;
    for (int b = 0; b < 32 && base + b < num_vertices; ++b) {
      word |= static_cast<unsigned>(alive[base + b] != 0) << b;
    }
    packed[static_cast<size_t>(lane) * num_words + w] = static_cast<int>(word);
  }
}

}  // namespace

// One block per lane.  alive [W, V] uint8 is peeled in place; pairact is a
// [W, P] uint8 scratch.  Outputs: packed [W, num_words] int32 (uint32 bit
// patterns), lo/hi/ne/iters [W] int32.  Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int wave_peel_launch(
    const void* ts, const void* te, const void* k, const void* h,
    const void* t, const void* src, const void* dst, int num_edges,
    const void* hp_pair, const void* ps, const void* pe, int num_pairs,
    const void* vs, const void* ve, int num_vertices, void* alive,
    void* pairact, void* packed, int num_words, void* lo, void* hi, void* ne,
    void* iters, int num_lanes, void* stream) {
  if (num_lanes > 0) {
    wave_peel_kernel<<<num_lanes, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ts), static_cast<const int*>(te),
        static_cast<const int*>(k), static_cast<const int*>(h),
        static_cast<const int*>(t), static_cast<const int*>(src),
        static_cast<const int*>(dst), num_edges,
        static_cast<const int*>(hp_pair), static_cast<const int*>(ps),
        static_cast<const int*>(pe), num_pairs, static_cast<const int*>(vs),
        static_cast<const int*>(ve), num_vertices,
        static_cast<uint8_t*>(alive), static_cast<uint8_t*>(pairact),
        static_cast<int*>(packed), num_words, static_cast<int*>(lo),
        static_cast<int*>(hi), static_cast<int*>(ne), static_cast<int*>(iters));
  }
  return static_cast<int>(cudaGetLastError());
}
