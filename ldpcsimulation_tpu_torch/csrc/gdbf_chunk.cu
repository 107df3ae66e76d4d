// A chunk of parallel GDBF steps issued from one host call, and the
// per-frame bookkeeping of a step as one kernel.
//
// The decoder (decoders/gdbf.py) reads its all-done flag from the card
// every DONE_CHECK_EVERY steps.  Between two such reads nothing of the card
// reaches the host, so the steps in between are issued here in one call:
// per step, on the caller's stream and in the decoder's order,
//   1. kernel B6 (ldpc_parity_check): the bipolar syndrome and the
//      satisfied flags of the current decisions;
//   2. gdbf_lanes_kernel: the step's [B] bookkeeping (below);
//   3. kernel B4 (ldpc_gauss_philox), when the decoder draws noise: the
//      step's perturbation [N, B], keyed (seed, frame0, 1 + 2 * step);
//   4. kernel B7 (ldpc_gdbf_parallel_step): the VN side, in place.
// The kernels and their arguments are those of the per-step wrappers
// (kernels/check.py, kernels/channel.py, kernels/gdbf.py), which the
// decoder's plan has validated once for the whole decode.
//
// gdbf_lanes_kernel, per frame b, in integers only (kernels/gdbf.py::
// gdbf_lanes_plain is the plain twin):
//   newly = !done & sat;  where newly: iters = step, phases = phase + 1,
//   sat_at_exit = 1, and inside the smoothing window smooth_used += 1;
//   done |= sat;  act = !done (the lanes B7 changes);  sat = 1 (B6 only
//   clears the flags of odd frames, so the next check starts from 1).
// One thread a frame: a few bytes a frame, ~2 us at B = 32768 on the H100.
#include <cuda_runtime.h>

#include <cstdint>

extern "C" int ldpc_parity_check(const int64_t* cols, int64_t m, int dc,
                                 int64_t n, const void* d, int d_is_int8,
                                 int64_t batch, int lanes, void* sat,
                                 void* syn, int device, void* stream);
extern "C" int ldpc_gauss_philox(uint64_t seed, uint64_t frame0,
                                 int64_t batch, int64_t n, uint32_t stream,
                                 int layout, float offset, float scale,
                                 float* out, int32_t* bits, int device,
                                 void* cuda_stream, int* fast);
extern "C" int ldpc_gdbf_parallel_step(
    void* d, int d_is_int8, const float* y, const void* syn,
    const int64_t* vn_checks, int64_t n, int64_t m, int dv, float* thetas,
    int32_t* dsum, const void* act, float w, const float* wv,
    const float* pert, float lam, int adapt, int smooth, int64_t batch,
    int lanes, int device, void* stream);

namespace {

constexpr int kThreads = 256;
constexpr int kLayoutColMajor = 1;  // B4's [n, batch] layout

__global__ void __launch_bounds__(kThreads)
    gdbf_lanes_kernel(unsigned char* __restrict__ sat,
                      unsigned char* __restrict__ done,
                      unsigned char* __restrict__ act,
                      int32_t* __restrict__ iters,
                      int32_t* __restrict__ phases,
                      int32_t* __restrict__ smooth_used,
                      unsigned char* __restrict__ sat_at_exit, int64_t batch,
                      int32_t step, int32_t phase, int in_window) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const bool s = sat[b] != 0;
  const bool was_done = done[b] != 0;
  if (s && !was_done) {
    iters[b] = step;
    phases[b] = phase + 1;
    sat_at_exit[b] = 1;
    if (in_window) smooth_used[b] += 1;
  }
  const bool now_done = was_done || s;
  done[b] = now_done ? 1 : 0;
  act[b] = now_done ? 0 : 1;
  sat[b] = 1;
}

}  // namespace

// counts (six ints, added to): B6, gdbf_lanes_kernel, B4 and B7 launches,
// then B4's wide-store and tail instances.  Returns the first CUDA error
// (0 when clean); the counts then hold what was issued before it.
extern "C" int ldpc_gdbf_chunk(
    const int64_t* check_cols, int64_t m, int dc, const int64_t* vn_checks,
    int dv, int64_t n, int64_t batch, void* d, int d_is_int8, const float* y,
    float* thetas, int32_t* dsum, void* syn, void* sat, float* pert,
    void* done, void* act, int32_t* iters, int32_t* phases,
    int32_t* smooth_used, void* sat_at_exit, int64_t step0, int64_t count,
    int64_t T, int64_t window_start, uint64_t seed, uint64_t frame0,
    float noise_scale, float w, const float* wv, float lam, int adapt,
    int check_lanes, int step_lanes, int device, void* stream,
    int* counts) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T <= 0 || step0 < 0 || count < 0 || step0 + count > 0x7fffffffLL ||
      batch <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  for (int64_t step = step0; step < step0 + count; ++step) {
    const int64_t phase = step / T, it = step % T;
    const int smooth = it >= window_start ? 1 : 0;
    int rc = ldpc_parity_check(check_cols, m, dc, n, d, d_is_int8, batch,
                               check_lanes, sat, syn, device, stream);
    if (rc != 0) return rc;
    counts[0] += 1;
    gdbf_lanes_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<unsigned char*>(sat), static_cast<unsigned char*>(done),
        static_cast<unsigned char*>(act), iters, phases, smooth_used,
        static_cast<unsigned char*>(sat_at_exit), batch, (int32_t)step,
        (int32_t)phase, smooth);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    counts[1] += 1;
    if (pert != nullptr) {
      int fast = -1;
      rc = ldpc_gauss_philox(seed, frame0, batch, n,
                             (uint32_t)(1 + 2 * step), kLayoutColMajor, 0.0f,
                             noise_scale, pert, nullptr, device, stream,
                             &fast);
      if (rc != 0) return rc;
      if (fast >= 0) {
        counts[2] += 1;
        counts[fast ? 4 : 5] += 1;
      }
    }
    rc = ldpc_gdbf_parallel_step(d, d_is_int8, y, syn, vn_checks, n, m, dv,
                                 thetas, dsum, act, w, wv, pert, lam, adapt,
                                 smooth, batch, step_lanes, device, stream);
    if (rc != 0) return rc;
    counts[3] += 1;
  }
  return (int)cudaSuccess;
}
