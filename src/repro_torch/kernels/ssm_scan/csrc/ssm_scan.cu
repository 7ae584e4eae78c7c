// Diagonal SSM scan for Hopper (sm_90a): the forward recurrence and its
// adjoint (the reverse scan training needs).
//
// Forward.  Replaces: src/repro/kernels/ssm_scan/kernel.py::ssm_scan_pallas,
// which walks S in chunks on the TPU's sequential grid axis and carries the
// state between chunks in a VMEM scratch.
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
//
// Backward.  The TPU package has no backward kernel: it differentiates a
// plain chunked scan through XLA.  ssm_scan_bwd_kernel is the adjoint of the
// forward above.  From log_a, the saved states s, s0 and the incoming
// gradient g (all float32) it walks t = S-1 .. 0 with the adjoint carry
//   c_t = g_t + exp(log_a_{t+1}) * c_{t+1},   c_{S-1} = g_{S-1},
// and writes dbx_t = c_t, dlog_a_t = c_t * exp(log_a_t) * s_{t-1} (s_{-1} =
// s0), and ds0 = exp(log_a_0) * c_0.
//
// Bound: bytes again.  Each element reads g, log_a and s_{t-1} and writes
// dlog_a and dbx (20 bytes); exp(log_a_{t+1}) is carried over from the
// previous step in a register, so log_a is read once.  The same design as
// the forward: one thread per (b, f) column, the carry in a register,
// neighbouring f per warp, explicitly rounded arithmetic in the plain
// version's order (ref.py::ssm_scan_bwd_ref).

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

__global__ void ssm_scan_bwd_kernel(const float* __restrict__ log_a,
                                    const float* __restrict__ states,
                                    const float* __restrict__ s0,
                                    const float* __restrict__ g, int s, int f,
                                    int f_blocks, float* __restrict__ dlog_a,
                                    float* __restrict__ dbx,
                                    float* __restrict__ ds0) {
  const int b = blockIdx.x / f_blocks;
  const int col = (blockIdx.x % f_blocks) * kThreads + threadIdx.x;
  if (col >= f) return;
  const long long row = static_cast<long long>(b) * s * f + col;
  const long long at0 = static_cast<long long>(b) * f + col;
  // c_{t+1} and exp(log_a_{t+1}); both 0 before the last step, so that
  // c_{S-1} = g_{S-1} + 0 * 0 = g_{S-1}
  float carry = 0.0f;
  float a_next = 0.0f;
#pragma unroll 8
  for (int t = s - 1; t >= 0; --t) {
    const long long i = row + static_cast<long long>(t) * f;
    const float c = __fadd_rn(g[i], __fmul_rn(a_next, carry));
    const float a = expf(log_a[i]);
    const float prev = t > 0 ? states[i - f] : s0[at0];
    dbx[i] = c;
    dlog_a[i] = __fmul_rn(__fmul_rn(c, a), prev);
    carry = c;
    a_next = a;
  }
  ds0[at0] = __fmul_rn(a_next, carry);
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

// log_a, states, g: [b, s, f] float32 contiguous; s0: [b, f] float32
// contiguous; dlog_a, dbx: [b, s, f] float32; ds0: [b, f] float32.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int ssm_scan_bwd_launch(const void* log_a, const void* states,
                                   const void* s0, const void* g, int b,
                                   int s, int f, void* dlog_a, void* dbx,
                                   void* ds0, void* stream) {
  if (b > 0 && s > 0 && f > 0) {
    const int f_blocks = (f + kThreads - 1) / kThreads;
    const long long blocks = static_cast<long long>(b) * f_blocks;
    ssm_scan_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(log_a), static_cast<const float*>(states),
        static_cast<const float*>(s0), static_cast<const float*>(g), s, f,
        f_blocks, static_cast<float*>(dlog_a), static_cast<float*>(dbx),
        static_cast<float*>(ds0));
  }
  return static_cast<int>(cudaGetLastError());
}
