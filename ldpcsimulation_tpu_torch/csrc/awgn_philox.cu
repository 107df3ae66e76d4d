// Kernel B2: keyed AWGN samples of the all-(+1) BPSK word, y = 1 + sigma*n.
//
// Replaces ldpcsimulation_tpu/kernels/channel_pallas.py::awgn_all_zero_pallas
// (its _kernel): two 32-bit draws become 24-bit uniforms (k + 0.5) * 2^-24,
// then Box-Muller r * cos(2 pi u2).  The TPU kernel seeded its hardware PRNG
// per (seed, tile); here the generator is Philox4x32-10 (philox.cuh) keyed by
// the seed, with the counter (pair index j, frame lo, frame hi, 0).  One call
// yields 4 words = two Box-Muller pairs: column 2j takes (x0, x1) and column
// 2j+1 takes (x2, x3).  A frame's noise therefore depends only on
// (seed, frame index) — never on the batch size or the launch shape — which
// keeps the Monte-Carlo harness's replay-by-coordinates property.
//
// Bound on the H100: the output store, 4 bytes per sample (plus 8 bytes per
// sample when the 24-bit integers are also written for checking); per sample
// the ALU does half a Philox call (10 rounds of two 32x32 multiplies) plus
// logf, cosf and sqrtf.  At the main path's [32768, 1008] that is 132 MB of
// stores.  Design: one thread per Box-Muller pair, neighbouring threads on
// neighbouring columns so the stores coalesce; no shared memory, no state.
// Products and sums use the _rn intrinsics so nvcc contracts nothing into an
// FMA and the arithmetic is the plain PyTorch twin's, operation for operation
// (kernels/channel.py::awgn_philox_plain).
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

__global__ void awgn_philox_kernel(uint32_t key0, uint32_t key1,
                                   uint64_t frame0, int64_t batch, int64_t n,
                                   int64_t npairs, float sigma,
                                   float* __restrict__ y,
                                   int32_t* __restrict__ bits) {
  const int64_t gid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (gid >= batch * npairs) return;
  const int64_t row = gid / npairs;
  const int64_t j = gid - row * npairs;
  const uint64_t frame = frame0 + (uint64_t)row;
  const uint32_t ctr[4] = {(uint32_t)j, (uint32_t)frame,
                           (uint32_t)(frame >> 32), 0u};
  const uint32_t key[2] = {key0, key1};
  uint32_t x[4];
  ldpc::philox4x32_10(ctr, key, x);
  const float two_pi = 6.28318530717958647692f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t col = 2 * j + h;
    if (col >= n) break;
    const uint32_t ka = x[2 * h] >> 8, kb = x[2 * h + 1] >> 8;
    // (k + 0.5) * 2^-24: k < 2^24 converts exactly; the sum rounds in f32
    // exactly as the TPU kernel's and the twin's do.
    const float u1 = __fmul_rn(__fadd_rn((float)ka, 0.5f), 0x1p-24f);
    const float u2 = __fmul_rn(__fadd_rn((float)kb, 0.5f), 0x1p-24f);
    const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
    const float nrm = __fmul_rn(r, cosf(__fmul_rn(two_pi, u2)));
    const int64_t at = row * n + col;
    y[at] = __fadd_rn(1.0f, __fmul_rn(sigma, nrm));
    if (bits != nullptr) {
      bits[2 * at] = (int32_t)ka;
      bits[2 * at + 1] = (int32_t)kb;
    }
  }
}

}  // namespace

extern "C" int ldpc_awgn_philox(uint64_t seed, uint64_t frame0, int64_t batch,
                                int64_t n, float sigma, float* y,
                                int32_t* bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t npairs = (n + 1) / 2;
  const int64_t total = batch * npairs;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  awgn_philox_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t)seed, (uint32_t)(seed >> 32), frame0, batch, n, npairs, sigma,
      y, bits);
  return (int)cudaGetLastError();
}

extern "C" const char* ldpc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
