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
// Bound on the H100: not the 4-byte store per sample (132 MB at the main
// path's [32768, 1008], 0.039 ms at 3.35 TB/s) but instruction issue.  Per
// sample a thread issues half a Philox call (10 rounds of two 32x32->64
// multiplies), the accurate logf, cosf and sqrtf, and the _rn products; those
// must stay as they are (no __logf, __cosf, sincosf or fast math) because
// they make the samples equal to the plain twin's
// (kernels/channel.py::awgn_philox_plain) bit for bit.
//
// Design, for the issue rate:
//   * one thread per (frame, column quad): two independent Philox calls
//     (pairs 2q and 2q+1) give the compiler two dependent chains to
//     interleave, and four samples share one thread's index arithmetic;
//   * a 2-D grid, x over frames (no cap on the batch), y over quad tiles,
//     so no thread divides: 32-bit indices, 64-bit only in the final address;
//   * one 16-byte float4 store per quad when n % 4 == 0 (the main path's
//     1008), a warp writing 512 contiguous bytes of one frame; any other n
//     takes the tail instance, scalar stores behind column guards;
//   * the checking output (the 24-bit integers) is a template parameter, so
//     the harness's launch carries no debug branch.
// No shared memory, TMA or wgmma: nothing is reused, and a staged TMA store
// would only add a round trip through shared memory to stores that already
// coalesce.  __launch_bounds__(256): ptxas (-Xptxas -v, the build log) gives
// the float4 instance 28 registers without the integers and 32 with them,
// no spills, so eight blocks of 256 fit an SM: 64 warps, full occupancy.
// The 32-byte stack frame is cosf's Payne-Hanek buffer, reached only for
// |2 pi u2| >= 105615, which never happens here.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kQuadsPerBlock = 32;  // threadIdx.x: one warp along a frame
constexpr int kFramesPerBlock = 8;  // threadIdx.y
constexpr int kThreads = kQuadsPerBlock * kFramesPerBlock;

// One sample from the 24-bit integers (ka, kb): the plain twin's f32
// operations in its order.  (k + 0.5) * 2^-24: k < 2^24 converts exactly; the
// sum rounds in f32 exactly as the TPU kernel's and the twin's do.
__device__ __forceinline__ float awgn_sample(uint32_t ka, uint32_t kb,
                                             float sigma) {
  const float two_pi = 6.28318530717958647692f;
  const float u1 = __fmul_rn(__fadd_rn((float)ka, 0.5f), 0x1p-24f);
  const float u2 = __fmul_rn(__fadd_rn((float)kb, 0.5f), 0x1p-24f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float nrm = __fmul_rn(r, cosf(__fmul_rn(two_pi, u2)));
  return __fadd_rn(1.0f, __fmul_rn(sigma, nrm));
}

template <bool kVec, bool kBits>
__global__ void __launch_bounds__(kThreads)
    awgn_philox_kernel(uint32_t key0, uint32_t key1, uint64_t frame0,
                       uint32_t batch, uint32_t n, float sigma,
                       float* __restrict__ y, int32_t* __restrict__ bits) {
  const uint32_t row = blockIdx.x * kFramesPerBlock + threadIdx.y;
  const uint32_t q = blockIdx.y * kQuadsPerBlock + threadIdx.x;
  if (row >= batch || 4 * q >= n) return;
  const uint64_t frame = frame0 + row;
  const uint32_t key[2] = {key0, key1};
  const uint32_t ca[4] = {2 * q, (uint32_t)frame, (uint32_t)(frame >> 32),
                          0u};
  const uint32_t cb[4] = {2 * q + 1, ca[1], ca[2], 0u};
  // words 4h'..4h'+3 of pair 2q+h'; column 4q+h takes (x[2h], x[2h+1])
  uint32_t x[8];
  ldpc::philox4x32_10(ca, key, x);
  ldpc::philox4x32_10(cb, key, x + 4);
  uint32_t k[8];
  float v[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    k[2 * h] = x[2 * h] >> 8;
    k[2 * h + 1] = x[2 * h + 1] >> 8;
    v[h] = awgn_sample(k[2 * h], k[2 * h + 1], sigma);
  }
  const int64_t at = (int64_t)row * n + 4 * q;
  if (kVec) {
    *reinterpret_cast<float4*>(y + at) = make_float4(v[0], v[1], v[2], v[3]);
    if (kBits) {
      int4* b = reinterpret_cast<int4*>(bits + 2 * at);
      b[0] = make_int4(k[0], k[1], k[2], k[3]);
      b[1] = make_int4(k[4], k[5], k[6], k[7]);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if (4 * q + h >= n) break;
      y[at + h] = v[h];
      if (kBits) {
        bits[2 * (at + h)] = (int32_t)k[2 * h];
        bits[2 * (at + h) + 1] = (int32_t)k[2 * h + 1];
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

}  // namespace

// Launches kernel B2 on [batch, n] (y) and, when bits is not null, its
// [batch, n, 2] 24-bit integers.  *fast is set to 1 when the float4 instance
// runs (n % 4 == 0 and aligned outputs), 0 when the tail instance does, and
// left as it was when an empty shape launches nothing.
extern "C" int ldpc_awgn_philox(uint64_t seed, uint64_t frame0, int64_t batch,
                                int64_t n, float sigma, float* y,
                                int32_t* bits, int device, void* stream,
                                int* fast) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t nquads = (n + 3) / 4;
  const int64_t qtiles = (nquads + kQuadsPerBlock - 1) / kQuadsPerBlock;
  if (batch < 0 || batch > 0x7fffffffLL || n < 0 || qtiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || n == 0) return (int)cudaSuccess;
  const bool vec = n % 4 == 0 && aligned(y, 16) &&
                   (bits == nullptr || aligned(bits, 16));
  *fast = vec ? 1 : 0;
  const dim3 grid((unsigned)((batch + kFramesPerBlock - 1) / kFramesPerBlock),
                  (unsigned)qtiles);
  const dim3 block(kQuadsPerBlock, kFramesPerBlock);
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  const uint32_t b = (uint32_t)batch, w = (uint32_t)n;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec && bits == nullptr) {
    awgn_philox_kernel<true, false>
        <<<grid, block, 0, s>>>(k0, k1, frame0, b, w, sigma, y, bits);
  } else if (vec) {
    awgn_philox_kernel<true, true>
        <<<grid, block, 0, s>>>(k0, k1, frame0, b, w, sigma, y, bits);
  } else if (bits == nullptr) {
    awgn_philox_kernel<false, false>
        <<<grid, block, 0, s>>>(k0, k1, frame0, b, w, sigma, y, bits);
  } else {
    awgn_philox_kernel<false, true>
        <<<grid, block, 0, s>>>(k0, k1, frame0, b, w, sigma, y, bits);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ldpc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
