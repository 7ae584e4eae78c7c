// Diagonal SSM scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssm_scan/kernel.py::ssm_scan_pallas, which
// walks S in chunks on the TPU's sequential grid axis and carries the state
// between chunks in a VMEM scratch.
//
// Computes s_t = exp(log_a_t) * s_{t-1} + bx_t for t = 0..S-1 from s_{-1} =
// s0, writing every state: log_a, bx [B, S, F] float32 and s0 [B, F] float32
// give out [B, S, F] float32.  This is the Mamba recurrence of the Jamba
// hybrid, with F = d_inner * d_state.
//
// Bound: bytes.  The function reads log_a and bx once and writes every state
// once (12 bytes per element of [B, S, F]) for one exp, one multiply and one
// add, far below the card's arithmetic rate.  Design: one thread per (b, f)
// column keeps its state in a register and loops over S, so nothing but the
// three streams touches device memory; neighbouring threads take
// neighbouring f, so every step's loads and stores are coalesced.  The
// blocks of a batch row are independent, so no state crosses blocks.  expf
// (not __expf) and an explicitly rounded multiply then add (no fused
// multiply-add) repeat the plain version's arithmetic step for step.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void ssm_scan_kernel(const float* __restrict__ log_a,
                                const float* __restrict__ bx,
                                const float* __restrict__ s0, int s, int f,
                                int f_blocks, float* __restrict__ out) {
  const int b = blockIdx.x / f_blocks;
  const int col = (blockIdx.x % f_blocks) * kThreads + threadIdx.x;
  if (col >= f) return;
  const long long row = static_cast<long long>(b) * s * f + col;
  float state = s0[static_cast<long long>(b) * f + col];
  // unrolled, so each thread keeps several steps' loads in flight
#pragma unroll 8
  for (int t = 0; t < s; ++t) {
    const long long i = row + static_cast<long long>(t) * f;
    state = __fadd_rn(__fmul_rn(expf(log_a[i]), state), bx[i]);
    out[i] = state;
  }
}

}  // namespace

// log_a, bx: [b, s, f] float32 contiguous; s0: [b, f] float32 contiguous;
// out: [b, s, f] float32.  Launches on `stream`; returns cudaGetLastError()
// after the launch.
extern "C" int ssm_scan_launch(const void* log_a, const void* bx,
                               const void* s0, int b, int s, int f, void* out,
                               void* stream) {
  if (b > 0 && s > 0 && f > 0) {
    const int f_blocks = (f + kThreads - 1) / kThreads;
    const long long blocks = static_cast<long long>(b) * f_blocks;
    ssm_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(log_a), static_cast<const float*>(bx),
        static_cast<const float*>(s0), s, f, f_blocks,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
