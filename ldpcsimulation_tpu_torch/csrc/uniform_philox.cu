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
// Bound on the H100: B3 is near its store bound (4 bytes per sample, 132 MB
// per draw at the decoder's [1008, 32768], 0.039 ms at 3.35 TB/s); B4 adds
// libdevice's erfinvf per sample, which with the quarter Philox call makes
// instruction issue its bound.  erfinvf stays: it equals PyTorch's CUDA
// erfinv, which the plain twin (kernels/channel.py) uses, bit for bit.
// Products and sums use the _rn intrinsics so nvcc contracts no FMA.
//
// Design, for the issue rate (B4) and the store width (both):
//   * the layout, the store width and the checking output are template
//     parameters, so no store carries a run-time test;
//   * decoder layout [n, batch]: one thread per (column quad, frame pair)
//     makes two independent Philox calls (two chains to interleave) and
//     writes each of its four columns with one 8-byte float2 store of the
//     two frames, a warp covering 256 contiguous bytes of a column row; an
//     odd batch takes the tail instance (scalar stores);
//   * channel layout [batch, n]: one thread per (frame, column quad), one
//     16-byte float4 store when n % 4 == 0, as B2 does; else the tail;
//   * 2-D grids with the frames on x (no cap on the batch) and the quads on
//     y, so no thread divides: 32-bit indices, 64-bit only in the address.
// No shared memory, TMA or wgmma: nothing is reused and the stores coalesce
// as they are.
//
// The per-lane entries (ldpc_uniform_philox_lanes, ldpc_gauss_philox_lanes)
// serve a streaming decoder whose lanes each hold their own frame at their
// own step: column b of the draw takes frame gid[b] (int64) and stream
// 1 + 2*step[b] + domain (step int32, domain 0 or 1), the counter the
// contiguous entries give frame frame0 + b on stream 1 + 2*step + domain.
// So on contiguous gids and one step both entries write the same bits.  The
// same body, layouts and store widths; each thread reads its frames' gid and
// step once (12 bytes per frame, a re-read from L2 per column quad).  __launch_bounds__(256): ptxas (-Xptxas -v, the build log)
// gives every instance 16-30 registers (the decoder layout's float2
// instances 24 for B4 and 18 for B3, without the integers), no spills and
// no stack, so eight blocks of 256 fit an SM: 64 warps, full occupancy.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kLayoutBatchMajor = 0;  // out[frame * n + col]   ([batch, n])
constexpr int kLayoutColMajor = 1;    // out[col * batch + frame] ([n, batch])
constexpr int kThreads = 256;
// [batch, n]: a warp along one frame's quads, 8 frames per block
constexpr int kQuadsPerBlock = 32;
constexpr int kFramesPerBlock = kThreads / kQuadsPerBlock;

// The sample of one 32-bit word: the plain twin's f32 operations in order.
template <bool kGauss>
__device__ __forceinline__ float draw(uint32_t k, float offset, float scale) {
  const float u = __fmul_rn(__fadd_rn((float)k, 0.5f), 0x1p-24f);
  if (!kGauss) return u;
  // 2u - 1 is exact on this grid; sqrt(2) is rounded to f32 as the TPU
  // function's jnp.float32(math.sqrt(2.0)) is.
  const float t = __fsub_rn(__fmul_rn(2.0f, u), 1.0f);
  const float nrm = __fmul_rn(1.41421356237309505f, erfinvf(t));
  return __fadd_rn(offset, __fmul_rn(scale, nrm));
}

__device__ __forceinline__ void philox_at(uint32_t q, uint64_t frame,
                                          uint32_t stream, uint32_t key0,
                                          uint32_t key1, uint32_t x[4]) {
  const uint32_t ctr[4] = {q, (uint32_t)frame, (uint32_t)(frame >> 32),
                           stream};
  const uint32_t key[2] = {key0, key1};
  ldpc::philox4x32_10(ctr, key, x);
}

// Frame and stream of draw column r: frame0 + r on one stream, or, for the
// per-lane entries (kLanes), gid[r] on stream 1 + 2 * step[r] + domain.
struct Keys {
  uint64_t frame0;
  uint32_t stream;  // the stream, or the domain with kLanes
  const int64_t* gid;
  const int32_t* step;
};

template <bool kLanes>
__device__ __forceinline__ void key_of(const Keys& ks, uint32_t r,
                                       uint64_t* frame, uint32_t* stream) {
  if constexpr (kLanes) {
    const long long* g = reinterpret_cast<const long long*>(ks.gid);
    *frame = (uint64_t)__ldg(g + r);
    *stream = 1u + 2u * (uint32_t)__ldg(ks.step + r) + ks.stream;
  } else {
    *frame = ks.frame0 + r;
    *stream = ks.stream;
  }
}

template <bool kGauss, int kLayout, bool kVec, bool kBits, bool kLanes>
__device__ __forceinline__ void draw_body(uint32_t key0, uint32_t key1,
                                          const Keys& ks, uint32_t batch,
                                          uint32_t n, float offset,
                                          float scale,
                                          float* __restrict__ out,
                                          int32_t* __restrict__ bits) {
  if constexpr (kLayout == kLayoutColMajor) {
    // frames r0 = 2p and r0 + 1 of column quad q = blockIdx.y
    const uint32_t r0 = 2 * (blockIdx.x * kThreads + threadIdx.x);
    const uint32_t q = blockIdx.y;
    if (r0 >= batch) return;
    uint64_t fa, fb;
    uint32_t sa, sb;
    key_of<kLanes>(ks, r0, &fa, &sa);
    if (kLanes && r0 + 1 >= batch) {
      fb = fa;  // no second frame: a copy of the first, never stored
      sb = sa;
    } else {
      key_of<kLanes>(ks, r0 + 1, &fb, &sb);
    }
    uint32_t xa[4], xb[4];
    philox_at(q, fa, sa, key0, key1, xa);
    philox_at(q, fb, sb, key0, key1, xb);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint32_t col = 4 * q + h;
      if (col >= n) break;  // the same for the whole block
      const uint32_t ka = xa[h] >> 8, kb = xb[h] >> 8;
      const float va = draw<kGauss>(ka, offset, scale);
      const float vb = draw<kGauss>(kb, offset, scale);
      const int64_t at = (int64_t)col * batch + r0;
      if (kVec) {
        *reinterpret_cast<float2*>(out + at) = make_float2(va, vb);
        if (kBits) {
          *reinterpret_cast<int2*>(bits + at) = make_int2(ka, kb);
        }
      } else {
        out[at] = va;
        if (kBits) bits[at] = (int32_t)ka;
        if (r0 + 1 < batch) {
          out[at + 1] = vb;
          if (kBits) bits[at + 1] = (int32_t)kb;
        }
      }
    }
  } else {
    const uint32_t row = blockIdx.x * kFramesPerBlock + threadIdx.y;
    const uint32_t q = blockIdx.y * kQuadsPerBlock + threadIdx.x;
    if (row >= batch || 4 * q >= n) return;
    uint64_t frame;
    uint32_t stream;
    key_of<kLanes>(ks, row, &frame, &stream);
    uint32_t x[4];
    philox_at(q, frame, stream, key0, key1, x);
    uint32_t k[4];
    float v[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      k[h] = x[h] >> 8;
      v[h] = draw<kGauss>(k[h], offset, scale);
    }
    const int64_t at = (int64_t)row * n + 4 * q;
    if (kVec) {
      *reinterpret_cast<float4*>(out + at) =
          make_float4(v[0], v[1], v[2], v[3]);
      if (kBits) {
        *reinterpret_cast<int4*>(bits + at) =
            make_int4(k[0], k[1], k[2], k[3]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (4 * q + h >= n) break;
        out[at + h] = v[h];
        if (kBits) bits[at + h] = (int32_t)k[h];
      }
    }
  }
}

template <bool kGauss, int kLayout, bool kVec, bool kBits>
__global__ void __launch_bounds__(kThreads)
    philox_draw_kernel(uint32_t key0, uint32_t key1, uint64_t frame0,
                       uint32_t batch, uint32_t n, uint32_t stream,
                       float offset, float scale, float* __restrict__ out,
                       int32_t* __restrict__ bits) {
  const Keys ks{frame0, stream, nullptr, nullptr};
  draw_body<kGauss, kLayout, kVec, kBits, false>(key0, key1, ks, batch, n,
                                                 offset, scale, out, bits);
}

template <bool kGauss, int kLayout, bool kVec, bool kBits>
__global__ void __launch_bounds__(kThreads)
    philox_lanes_kernel(uint32_t key0, uint32_t key1,
                        const int64_t* __restrict__ gid,
                        const int32_t* __restrict__ step, uint32_t batch,
                        uint32_t n, uint32_t domain, float offset,
                        float scale, float* __restrict__ out,
                        int32_t* __restrict__ bits) {
  const Keys ks{0, domain, gid, step};
  draw_body<kGauss, kLayout, kVec, kBits, true>(key0, key1, ks, batch, n,
                                                offset, scale, out, bits);
}

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

struct Draw {
  uint32_t key0, key1;
  uint64_t frame0;
  uint32_t batch, n, stream;  // stream: the domain for the per-lane draw
  float offset, scale;
  float* out;
  int32_t* bits;
  const int64_t* gid;  // non-null: the per-lane draw
  const int32_t* step;
};

template <bool kGauss, int kLayout, bool kVec, bool kBits>
void start(const Draw& d, dim3 grid, dim3 block, cudaStream_t s) {
  if (d.gid != nullptr) {
    philox_lanes_kernel<kGauss, kLayout, kVec, kBits><<<grid, block, 0, s>>>(
        d.key0, d.key1, d.gid, d.step, d.batch, d.n, d.stream, d.offset,
        d.scale, d.out, d.bits);
  } else {
    philox_draw_kernel<kGauss, kLayout, kVec, kBits><<<grid, block, 0, s>>>(
        d.key0, d.key1, d.frame0, d.batch, d.n, d.stream, d.offset, d.scale,
        d.out, d.bits);
  }
}

template <bool kGauss, int kLayout>
void start_layout(const Draw& d, bool vec, dim3 grid, dim3 block,
                  cudaStream_t s) {
  const bool with_bits = d.bits != nullptr;
  if (vec && !with_bits) {
    start<kGauss, kLayout, true, false>(d, grid, block, s);
  } else if (vec) {
    start<kGauss, kLayout, true, true>(d, grid, block, s);
  } else if (!with_bits) {
    start<kGauss, kLayout, false, false>(d, grid, block, s);
  } else {
    start<kGauss, kLayout, false, true>(d, grid, block, s);
  }
}

// *fast is set to 1 when the wide-store instance runs (even batch for
// [n, batch], n % 4 == 0 for [batch, n], aligned outputs), 0 for the tail,
// and left as it was when an empty shape launches nothing.
template <bool kGauss>
int launch(uint64_t seed, uint64_t frame0, int64_t batch, int64_t n,
           uint32_t stream, int layout, float offset, float scale, float* out,
           int32_t* bits, int device, void* cuda_stream, int* fast,
           const int64_t* gid = nullptr, const int32_t* step = nullptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool col_major = layout == kLayoutColMajor;
  const int64_t nquads = (n + 3) / 4;
  // grid y: column quads ([n, batch]) or tiles of 32 quads ([batch, n])
  const int64_t ytiles =
      col_major ? nquads : (nquads + kQuadsPerBlock - 1) / kQuadsPerBlock;
  if (batch < 0 || batch > 0x7fffffffLL || n < 0 || ytiles > 65535 ||
      (!col_major && layout != kLayoutBatchMajor)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || n == 0) return (int)cudaSuccess;
  const Draw d{(uint32_t)seed, (uint32_t)(seed >> 32), frame0,
               (uint32_t)batch, (uint32_t)n, stream, offset, scale, out,
               bits, gid, step};
  const uintptr_t width = col_major ? 8 : 16;
  const bool vec_shape = col_major ? batch % 2 == 0 : n % 4 == 0;
  const bool vec = vec_shape && aligned(out, width) &&
                   (bits == nullptr || aligned(bits, width));
  *fast = vec ? 1 : 0;
  cudaStream_t s = (cudaStream_t)cuda_stream;
  if (col_major) {
    const int64_t pairs = (batch + 1) / 2;
    const dim3 grid((unsigned)((pairs + kThreads - 1) / kThreads),
                    (unsigned)ytiles);
    start_layout<kGauss, kLayoutColMajor>(d, vec, grid, dim3(kThreads), s);
  } else {
    const dim3 grid(
        (unsigned)((batch + kFramesPerBlock - 1) / kFramesPerBlock),
        (unsigned)ytiles);
    start_layout<kGauss, kLayoutBatchMajor>(
        d, vec, grid, dim3(kQuadsPerBlock, kFramesPerBlock), s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ldpc_uniform_philox(uint64_t seed, uint64_t frame0,
                                   int64_t batch, int64_t n, uint32_t stream,
                                   int layout, float* out, int32_t* bits,
                                   int device, void* cuda_stream, int* fast) {
  return launch<false>(seed, frame0, batch, n, stream, layout, 0.0f, 1.0f,
                       out, bits, device, cuda_stream, fast);
}

extern "C" int ldpc_gauss_philox(uint64_t seed, uint64_t frame0,
                                 int64_t batch, int64_t n, uint32_t stream,
                                 int layout, float offset, float scale,
                                 float* out, int32_t* bits, int device,
                                 void* cuda_stream, int* fast) {
  return launch<true>(seed, frame0, batch, n, stream, layout, offset, scale,
                      out, bits, device, cuda_stream, fast);
}

// Per-lane keys: column b draws frame gid[b] on stream
// 1 + 2 * step[b] + domain (gid and step on the device, batch entries each).
extern "C" int ldpc_uniform_philox_lanes(uint64_t seed, const int64_t* gid,
                                         const int32_t* step, int64_t batch,
                                         int64_t n, uint32_t domain,
                                         int layout, float* out,
                                         int32_t* bits, int device,
                                         void* cuda_stream, int* fast) {
  if (domain > 1) return (int)cudaErrorInvalidValue;
  return launch<false>(seed, 0, batch, n, domain, layout, 0.0f, 1.0f, out,
                       bits, device, cuda_stream, fast, gid, step);
}

extern "C" int ldpc_gauss_philox_lanes(uint64_t seed, const int64_t* gid,
                                       const int32_t* step, int64_t batch,
                                       int64_t n, uint32_t domain, int layout,
                                       float offset, float scale, float* out,
                                       int32_t* bits, int device,
                                       void* cuda_stream, int* fast) {
  if (domain > 1) return (int)cudaErrorInvalidValue;
  return launch<true>(seed, 0, batch, n, domain, layout, offset, scale, out,
                      bits, device, cuda_stream, fast, gid, step);
}
