// Kernel B10: the early-termination decision merge of the flooding soft
// decoders, one pass over a round's posterior.
//
// No Pallas original: it replaces the XLA fusion of the JAX loop body's
// latch (ldpcsimulation_tpu/decoders/base.py::run_flooding_soft: the
// decisions d_of(total) masked into d, and the round counts' where).  In
// the port that latch was plain torch (kernels/merge.py::et_merge_plain,
// now done in place): a compare, three selects and the mask's negation,
// ~7 launches and four passes over [rows, B] a round.
//
// The function, per row r and batch lane b, in round `round`:
//   * lane b not done: d[r, b] = total[r, b] > 0 ? +1 : -1 (sgn(0) = -1;
//     -0.0 and NaN give -1), iters[b] = round;
//   * lane b done: both keep their values.
// total is f32, f16 or bf16.  "total > 0" is read off the bits: a value
// lies above zero when its sign bit is clear and it is neither +0.0 nor a
// NaN, that is when bits - 1, unsigned, lies below the bits of +inf.  That
// is exact for every value of the three types and needs no conversion.
//
// Bound on the H100: device memory.  A round reads every lane's posterior
// once and writes every lane's decision once, reads done and writes iters
// once: B * (rows * (arith + 1) + 5) bytes, 2.65 GB on the DVB-S2 frame
// (64800 rows, B = 8192, f32), 0.79 ms at 3.35 TB/s.  The kernel also reads
// the old decisions and counts (one byte more a column-lane: with f32 at
// most ~83 % of that bound), because it stores every lane, done or not: it
// never moves fewer bytes than the count says.  A few integer operations a
// lane.
//
// Design: a pure stream.  Thread x of the grid takes a group of L
// contiguous lanes (L = 16 where the batch is a multiple of 16 and the four
// planes are 16-byte aligned, kernels/merge.py::merge_lane_width; else 1),
// grid y a slice of rows; neighbouring threads take neighbouring groups, so
// a warp's accesses to a row are contiguous.  The thread loads its L done
// flags once, as byte masks, and walks its rows in ascending order: per row
// the L posterior values as 16-byte streaming loads (__ldcs: read once),
// the L old decisions as one 16-byte load, a bitwise select and one 16-byte
// store.  The slices are cut so that the grid is about kBlocksPerSm blocks
// an SM, one wave.  The threads of slice 0 write the round counts.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kWide = 16;  // lanes of the wide instance

// Bits of +inf in each posterior type (f32; f16; bf16).
constexpr uint32_t kInfF32 = 0x7f800000u;
constexpr uint32_t kInfF16 = 0x7c00u;
constexpr uint32_t kInfBF16 = 0x7f80u;

__device__ __forceinline__ bool positive(uint32_t bits, uint32_t inf) {
  return bits - 1u < inf;
}

// Lane l's bits among the posterior words (E: 4 or 2 bytes a value).
template <typename E>
__device__ __forceinline__ uint32_t lane_bits(const uint32_t* w, int l) {
  if constexpr (sizeof(E) == 4) {
    return w[l];
  } else {
    return (w[l / 2] >> (16 * (l % 2))) & 0xffffu;
  }
}

// E: the posterior's storage word (uint32_t for f32, uint16_t for f16 and
// bf16); kInf: its +inf; L: lanes a thread (kWide or 1).
template <typename E, uint32_t kInf, int L>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    et_merge_kernel(const E* __restrict__ total,
                    const uint8_t* __restrict__ done, int8_t* __restrict__ d,
                    int32_t* __restrict__ iters, int64_t rows, int64_t batch,
                    int64_t rows_per_slice, int round) {
  const int64_t b = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * L;
  if (b >= batch) return;  // batch % L == 0: all L lanes or none
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_slice;
  const int64_t r1 = r0 + rows_per_slice < rows ? r0 + rows_per_slice : rows;
  if constexpr (L == kWide) {
    // done flags (bytes 0 or 1) as byte masks: 0xff where done
    const uint4 dv = *reinterpret_cast<const uint4*>(done + b);
    const uint32_t keep[4] = {dv.x * 0xffu, dv.y * 0xffu, dv.z * 0xffu,
                              dv.w * 0xffu};
    constexpr int kLoads = L * (int)sizeof(E) / 16;
#pragma unroll 2
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t at = r * batch + b;
      const uint4* src = reinterpret_cast<const uint4*>(total + at);
      uint32_t w[kLoads * 4];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const uint4 v = __ldcs(src + k);
        w[4 * k] = v.x;
        w[4 * k + 1] = v.y;
        w[4 * k + 2] = v.z;
        w[4 * k + 3] = v.w;
      }
      uint4* dst = reinterpret_cast<uint4*>(d + at);
      const uint4 old = *dst;
      uint32_t dec[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint32_t byte =
            positive(lane_bits<E>(w, l), kInf) ? 0x01u : 0xffu;
        dec[l / 4] |= byte << (8 * (l % 4));
      }
      *dst = make_uint4((old.x & keep[0]) | (dec[0] & ~keep[0]),
                        (old.y & keep[1]) | (dec[1] & ~keep[1]),
                        (old.z & keep[2]) | (dec[2] & ~keep[2]),
                        (old.w & keep[3]) | (dec[3] & ~keep[3]));
    }
    if (blockIdx.y == 0) {
      int4* it = reinterpret_cast<int4*>(iters + b);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int4 o = it[k];
        o.x = keep[k] & 0xffu ? o.x : round;
        o.y = keep[k] >> 8 & 0xffu ? o.y : round;
        o.z = keep[k] >> 16 & 0xffu ? o.z : round;
        o.w = keep[k] >> 24 ? o.w : round;
        it[k] = o;
      }
    }
  } else {
    const uint32_t keep = done[b] ? 0xffu : 0u;
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t at = r * batch + b;
      uint32_t bits;
      if constexpr (sizeof(E) == 4) {
        bits = __ldcs(reinterpret_cast<const unsigned int*>(total + at));
      } else {
        bits = __ldcs(reinterpret_cast<const unsigned short*>(total + at));
      }
      const uint32_t dec = positive(bits, kInf) ? 0x01u : 0xffu;
      const uint32_t old = (uint8_t)d[at];
      d[at] = (int8_t)(uint8_t)((old & keep) | (dec & ~keep));
    }
    if (blockIdx.y == 0) iters[b] = keep ? iters[b] : round;
  }
}

template <typename E, uint32_t kInf, int L>
cudaError_t launch(const void* total, const void* done, void* d, void* iters,
                   int64_t rows, int64_t batch, int round, int sms,
                   cudaStream_t stream) {
  const int64_t groups = batch / L;
  const int64_t gx = (groups + kThreads - 1) / kThreads;
  if (gx > 0x7fffffff) return cudaErrorInvalidValue;
  // slices of rows: about kBlocksPerSm blocks an SM in all, none empty
  int64_t slices = ((int64_t)sms * kBlocksPerSm + gx - 1) / gx;
  if (slices > rows) slices = rows;
  if (slices > 65535) slices = 65535;
  if (slices < 1) slices = 1;
  int64_t per = (rows + slices - 1) / slices;
  if (per < 1) per = 1;
  slices = rows > 0 ? (rows + per - 1) / per : 1;
  et_merge_kernel<E, kInf, L>
      <<<dim3((unsigned)gx, (unsigned)slices), kThreads, 0, stream>>>(
          static_cast<const E*>(total), static_cast<const uint8_t*>(done),
          static_cast<int8_t*>(d), static_cast<int32_t*>(iters), rows, batch,
          per, round);
  return cudaGetLastError();
}

template <typename E, uint32_t kInf>
cudaError_t launch_lanes(const void* total, const void* done, void* d,
                         void* iters, int64_t rows, int64_t batch, int lanes,
                         int round, int sms, cudaStream_t stream) {
  if (lanes == kWide) {
    return launch<E, kInf, kWide>(total, done, d, iters, rows, batch, round,
                                  sms, stream);
  }
  if (lanes == 1) {
    return launch<E, kInf, 1>(total, done, d, iters, rows, batch, round, sms,
                              stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// kind: the posterior's type, 0 f32, 1 f16, 2 bf16.
extern "C" int ldpc_et_merge(const void* total, int kind, const void* done,
                             void* d, void* iters, int64_t rows,
                             int64_t batch, int lanes, int round, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaSuccess;
  if (rows < 0 || (lanes == kWide && batch % kWide != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0:
      return (int)launch_lanes<uint32_t, kInfF32>(total, done, d, iters, rows,
                                                  batch, lanes, round, sms, s);
    case 1:
      return (int)launch_lanes<uint16_t, kInfF16>(total, done, d, iters, rows,
                                                  batch, lanes, round, sms, s);
    case 2:
      return (int)launch_lanes<uint16_t, kInfBF16>(total, done, d, iters,
                                                   rows, batch, lanes, round,
                                                   sms, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
