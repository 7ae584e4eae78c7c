// Sorted-segment sum for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/segdeg/kernel.py::banded_segsum_pallas, which
// contracts a one-hot segment-membership tile with each input tile of its
// output tile's band on the TPU's matrix unit.
//
// Computes out[s, q] = sum over {i : seg[i] == s} of values[i, q], for
// values [N, Q] float32 and sorted seg [N] int32; ids >= S are dropped.
// off [S + 1] is the CSR form of seg: segment s owns rows [off[s],
// off[s + 1]), and off[S] rows carry an id < S.  The wrapper checks the
// ids once, where it takes off; the kernel itself writes and reads no row
// outside out, part and off whatever seg and off hold (an id outside
// [0, S) is skipped, off[S] is clamped to [0, N]).
//
// Bound: bytes.  Each value is read once, each output written once, and
// there is one add per value, far below the card's arithmetic rate; a
// one-hot product would only add operations.  Design: work is split by
// rows, not by segments, so a hub segment of 50k rows costs what any 50k
// rows cost.  Each block takes a tile of `tile` consecutive rows (the same
// for every block), copies it into shared memory with coalesced loads, and
// splits it into at most 32 chunks of consecutive rows per column.  One
// thread walks one (chunk, column) in row order and writes every run that
// lies inside its chunk; the first and last run of each chunk go to a
// per-column pass over the chunks in order, which writes the runs that lie
// inside the tile.  A run that crosses tiles leaves its share of each tile
// in part [tiles, 2, Q] (slot 0: the run holding the tile's first row,
// slot 1: the one holding its last row), and the last block to finish
// (a ticket counter) adds those shares in tile order.  Sums are carried
// in float64 and rounded to float32 once, so a result is the float32
// nearest its exact sum whatever the run's length, and every sum is taken
// in a fixed order, so it does not depend on scheduling; on the 0/1 values
// the wave step feeds it the sums are exact.  Segments with no row are
// written as zeros by a grid-stride pass over off.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 32;
constexpr size_t kMaxSmem = 48 * 1024;   // static limit, no opt-in needed

// Shared-memory index with one pad word per 32, so the chunk walkers of a
// warp (rows a chunk apart) fall on different banks.
__host__ __device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__host__ __device__ __forceinline__ int chunks_for(int q) {
  const int g = kThreads / q;
  return g < 1 ? 1 : (g > kMaxChunks ? kMaxChunks : g);
}

__host__ __device__ __forceinline__ size_t smem_bytes(int tile, int q) {
  const int g = chunks_for(q);
  return sizeof(double) * 2 * g * q + sizeof(float) * (padded(tile * q) + 1) +
         sizeof(int) * (padded(tile) + 1) + sizeof(int) * 3 * g;
}

__device__ __forceinline__ bool in_range(int id, int s) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(s);
}

__global__ void __launch_bounds__(kThreads) segdeg_kernel(
    const float* __restrict__ values, const int* __restrict__ seg,
    const int* __restrict__ off, int n, int q, int s, int tile,
    float* __restrict__ out, double* part, unsigned* ticket) {
  extern __shared__ double smem[];
  const int chunks = chunks_for(q);
  double* first_sum = smem;
  double* last_sum = first_sum + chunks * q;
  float* sval = reinterpret_cast<float*>(last_sum + chunks * q);
  int* sseg = reinterpret_cast<int*>(sval + padded(tile * q) + 1);
  int* first_id = sseg + padded(tile) + 1;
  int* last_id = first_id + chunks;
  int* runs = last_id + chunks;     // 0: empty chunk, 1: one run, 2: more
  __shared__ bool s_last;
  __shared__ int s_prev, s_next;   // ids of the rows just before / after

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int nvalid = max(0, min(off[s], n));   // rows past it: ids >= s

  for (long long g = static_cast<long long>(b) * kThreads + tid; g < s;
       g += static_cast<long long>(gridDim.x) * kThreads) {
    if (off[g] == off[g + 1]) {
      for (int c = 0; c < q; ++c) out[static_cast<size_t>(g) * q + c] = 0.f;
    }
  }

  const int r0 = b * tile;
  const int r1 = min(r0 + tile, nvalid);
  if (r0 < r1) {
    const int rows = r1 - r0;
    const float* src = values + static_cast<size_t>(r0) * q;
    for (int f = tid; f < rows * q; f += kThreads) sval[padded(f)] = src[f];
    for (int i = tid; i < rows; i += kThreads) sseg[padded(i)] = seg[r0 + i];
    if (tid == 0) {
      s_prev = r0 > 0 ? seg[r0 - 1] : -1;
      s_next = r1 < nvalid ? seg[r1] : -1;
    }
    __syncthreads();

    // one thread per (chunk, column): runs inside the chunk are whole
    // segments; the first and last run are kept for the pass below
    const int len = (rows + chunks - 1) / chunks;
    for (int item = tid; item < chunks * q; item += kThreads) {
      const int g = item / q, c = item % q;
      const int c0 = g * len, c1 = min(rows, c0 + len);
      if (c0 >= c1) {
        if (c == 0) runs[g] = 0;
        continue;
      }
      int cur = sseg[padded(c0)];
      double acc = 0.0, head = 0.0;
      bool multi = false;
      for (int i = c0; i < c1; ++i) {
        const int id = sseg[padded(i)];
        if (id != cur) {
          if (multi) {
            if (in_range(cur, s)) {
              out[static_cast<size_t>(cur) * q + c] = static_cast<float>(acc);
            }
          } else {
            head = acc;
            multi = true;
          }
          cur = id;
          acc = 0.0;
        }
        acc += sval[padded(i * q + c)];
      }
      first_sum[item] = multi ? head : acc;
      last_sum[item] = acc;
      if (c == 0) {
        first_id[g] = sseg[padded(c0)];
        last_id[g] = cur;
        runs[g] = multi ? 2 : 1;
      }
    }
    __syncthreads();

    // per column, the chunks in order: join runs that cross chunks, write
    // those inside the tile, keep the tile's first and last run in part
    // (a run crosses into a neighbouring tile iff it holds that end row of
    // the tile and the neighbour's row has its id)
    const int first = sseg[0], last = sseg[padded(rows - 1)];
    const bool from_prev = first == s_prev, into_next = last == s_next;
    auto emit = [&](int id, double sum, int c) {
      const bool h = from_prev && id == first, t = into_next && id == last;
      if (!h && !t && in_range(id, s)) {
        out[static_cast<size_t>(id) * q + c] = static_cast<float>(sum);
      }
      if (h) part[static_cast<size_t>(2 * b) * q + c] = sum;
      if (t) part[static_cast<size_t>(2 * b + 1) * q + c] = sum;
    };
    for (int c = tid; c < q; c += kThreads) {
      int cid = -1;
      double csum = 0.0;
      for (int g = 0; g < chunks && runs[g]; ++g) {
        const double fs = first_sum[g * q + c];
        if (first_id[g] == cid) {
          csum += fs;
        } else {
          if (cid >= 0) emit(cid, csum, c);
          cid = first_id[g];
          csum = fs;
        }
        if (runs[g] == 2) {
          emit(cid, csum, c);
          cid = last_id[g];
          csum = last_sum[g * q + c];
        }
      }
      emit(cid, csum, c);
    }
  }

  // the last block to finish adds the shares of tile-crossing runs
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long items = static_cast<long long>(gridDim.x) * q;
  for (long long item = tid; item < items; item += kThreads) {
    const int t = static_cast<int>(item / q), c = static_cast<int>(item % q);
    const int t0 = t * tile, t1 = min(t0 + tile, nvalid);
    if (t0 >= t1) continue;
    const int id = seg[t1 - 1];
    if (!in_range(id, s)) continue;
    const int a = off[id], e = off[id + 1];
    if (e <= t1 || a < t0) continue;   // ends here, or began earlier
    const int last = min((e - 1) / tile, static_cast<int>(gridDim.x) - 1);
    double sum = __ldcg(&part[static_cast<size_t>(2 * t + 1) * q + c]);
#pragma unroll 8
    for (int u = t + 1; u <= last; ++u) {
      sum += __ldcg(&part[static_cast<size_t>(2 * u) * q + c]);
    }
    out[static_cast<size_t>(id) * q + c] = static_cast<float>(sum);
  }
  if (tid == 0) *ticket = 0u;
}

}  // namespace

// values: [n, q] float32; seg: [n] int32 sorted; off: [s + 1] int32, the
// first row of each id; out: [s, q] float32; part: [ceil(n / tile), 2, q]
// float64 scratch; ticket: one uint32, 0 between launches (the last block
// resets it), so launches that share it must share a stream.  Launches on
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int segdeg_launch(const void* values, const void* seg,
                             const void* off, int n, int q, int s, int tile,
                             void* out, void* part, void* ticket,
                             void* stream) {
  if (q <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = smem_bytes(tile, q);
  if (tile <= 0 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = n > 0 ? (static_cast<long long>(n) + tile - 1) / tile
                                : 1;
  segdeg_kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(seg),
      static_cast<const int*>(off), n, q, s, tile, static_cast<float*>(out),
      static_cast<double*>(part), static_cast<unsigned*>(ticket));
  return static_cast<int>(cudaGetLastError());
}
