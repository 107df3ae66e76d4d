// Kernels B3 and B4: keyed uniforms, and Gaussians by the inverse error
// function, for the bit-flip decoders' internal noise.
//
// B3 replaces ldpcsimulation_tpu/kernels/channel_pallas.py::uniform_pallas
// (its _uniform_kernel): one 32-bit draw becomes the uniform
// u = (k + 0.5) * 2^-24 with k = bits >> 8.  B4 replaces
// channel_pallas.py::awgn_all_zero_hybrid (B3's uniforms, then XLA's
// 1 + sigma * sqrt(2) * erfinv(2u - 1)) as one kernel writing
// offset + scale * (sqrt(2) * erfinv(2u - 1)): offset 1, scale sigma is the
// TPU function's channel form, offset 0 the decoder's perturbation.
//
// The TPU kernels seeded the hardware PRNG per (seed, tile).  Here the
// generator is B2's Philox4x32-10 (philox.cuh) keyed by the run seed, with
// the counter (column quad j, frame lo, frame hi, stream).  One call yields
// four words, for columns 4j .. 4j+3.  The decoders take stream
// 1 + 2*step + domain (domain 0 the perturbation, 1 the stochastic flips);
// B2 keeps stream 0, so no decoder draw repeats a channel draw.  A sample is
// a pure function of (seed, frame, column, stream), whatever the batch or
// layout.
//
// (k + 0.5) is rounded to f32: above k = 2^23 the half step does not exist
// and the sum rounds to even, so k = 2^24 - 1 gives u = 1.0 exactly and B4
// gives +inf there (once in 2^24 draws), as the TPU functions do.
//
// Bound on the H100: the store, 4 bytes per sample (plus 4 for the 24-bit
// integer when it is written for checking); per sample the ALU does a
// quarter of a Philox call, and B4 adds erfinvf.  At the decoder's
// [1008, 32768] that is 132 MB of stores per draw.  Design: one thread per
// (column quad, frame).  In the decoder's [n, batch] layout neighbouring
// threads take neighbouring frames, so each of a warp's four stores is one
// contiguous 128-byte row segment and no transpose is needed; in the
// [batch, n] layout they take neighbouring quads.  No shared memory, no
// state.  Products and sums use the _rn intrinsics so nvcc contracts no
// FMA: the arithmetic is the plain twin's (kernels/channel.py), operation
// for operation, and only erfinvf comes from another math library.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kLayoutBatchMajor = 0;  // out[frame * n + col]   ([batch, n])
constexpr int kLayoutColMajor = 1;    // out[col * batch + frame] ([n, batch])

template <bool kGauss>
__global__ void philox_draw_kernel(uint32_t key0, uint32_t key1,
                                   uint64_t frame0, int64_t batch, int64_t n,
                                   int64_t nquads, uint32_t stream,
                                   int layout, float offset, float scale,
                                   float* __restrict__ out,
                                   int32_t* __restrict__ bits) {
  const int64_t gid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (gid >= batch * nquads) return;
  int64_t row, j;
  if (layout == kLayoutColMajor) {
    j = gid / batch;
    row = gid - j * batch;
  } else {
    row = gid / nquads;
    j = gid - row * nquads;
  }
  const uint64_t frame = frame0 + (uint64_t)row;
  const uint32_t ctr[4] = {(uint32_t)j, (uint32_t)frame,
                           (uint32_t)(frame >> 32), stream};
  const uint32_t key[2] = {key0, key1};
  uint32_t x[4];
  ldpc::philox4x32_10(ctr, key, x);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int64_t col = 4 * j + h;
    if (col >= n) break;
    const uint32_t k = x[h] >> 8;
    const float u = __fmul_rn(__fadd_rn((float)k, 0.5f), 0x1p-24f);
    float v = u;
    if (kGauss) {
      // 2u - 1 is exact on this grid; sqrt(2) is rounded to f32 as the TPU
      // function's jnp.float32(math.sqrt(2.0)) is.
      const float t = __fsub_rn(__fmul_rn(2.0f, u), 1.0f);
      const float nrm = __fmul_rn(1.41421356237309505f, erfinvf(t));
      v = __fadd_rn(offset, __fmul_rn(scale, nrm));
    }
    const int64_t at =
        layout == kLayoutColMajor ? col * batch + row : row * n + col;
    out[at] = v;
    if (bits != nullptr) bits[at] = (int32_t)k;
  }
}

template <bool kGauss>
int launch(uint64_t seed, uint64_t frame0, int64_t batch, int64_t n,
           uint32_t stream, int layout, float offset, float scale, float* out,
           int32_t* bits, int device, void* cuda_stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (layout != kLayoutBatchMajor && layout != kLayoutColMajor) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t nquads = (n + 3) / 4;
  const int64_t total = batch * nquads;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  philox_draw_kernel<kGauss>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)cuda_stream>>>(
          (uint32_t)seed, (uint32_t)(seed >> 32), frame0, batch, n, nquads,
          stream, layout, offset, scale, out, bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ldpc_uniform_philox(uint64_t seed, uint64_t frame0,
                                   int64_t batch, int64_t n, uint32_t stream,
                                   int layout, float* out, int32_t* bits,
                                   int device, void* cuda_stream) {
  return launch<false>(seed, frame0, batch, n, stream, layout, 0.0f, 1.0f,
                       out, bits, device, cuda_stream);
}

extern "C" int ldpc_gauss_philox(uint64_t seed, uint64_t frame0,
                                 int64_t batch, int64_t n, uint32_t stream,
                                 int layout, float offset, float scale,
                                 float* out, int32_t* bits, int device,
                                 void* cuda_stream) {
  return launch<true>(seed, frame0, batch, n, stream, layout, offset, scale,
                      out, bits, device, cuda_stream);
}
