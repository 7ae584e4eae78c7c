// Sorted-segment sum for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/segdeg/kernel.py::banded_segsum_pallas, which
// contracts a one-hot segment-membership tile with each input tile of its
// output tile's band on the TPU's matrix unit.
//
// Computes out[s, q] = sum over {i : seg[i] == s} of values[i, q], for
// values [N, Q] float32 and sorted seg [N] int32; ids >= S are dropped.
//
// Bound: bytes.  Each value is read once, each output written once, and
// there is one add per value, far below the card's arithmetic rate; a
// one-hot product would only add operations.  Design: one thread per
// (s, q), neighbouring threads on neighbouring q, so a warp reads
// neighbouring addresses of a values row.  Each thread finds its run
// [lo, hi) of the sorted ids with two binary searches and adds the run in
// index order: the sum is sequential and deterministic, exact on the 0/1
// values the wave step feeds it, and a run of any length is taken (no band
// cap, so no fallback for hub segments).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int lower_bound(const int* __restrict__ seg, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (seg[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void segdeg_kernel(const float* __restrict__ values,
                              const int* __restrict__ seg, int n, int q, int s,
                              float* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(s) * q) return;
  const int seg_id = static_cast<int>(idx / q);
  const int col = static_cast<int>(idx % q);
  const int lo = lower_bound(seg, n, seg_id);
  const int hi = lower_bound(seg, n, seg_id + 1);
  float acc = 0.f;
  for (int i = lo; i < hi; ++i) {
    acc += values[static_cast<long long>(i) * q + col];
  }
  out[idx] = acc;
}

}  // namespace

// values: [n, q] float32; seg: [n] int32 sorted; out: [s, q] float32.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int segdeg_launch(const void* values, const void* seg, int n, int q,
                             int s, void* out, void* stream) {
  constexpr int kThreads = 256;
  const long long total = static_cast<long long>(s) * q;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    segdeg_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), static_cast<const int*>(seg), n, q,
        s, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
