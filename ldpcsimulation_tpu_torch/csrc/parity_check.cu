// Kernel B6: the parity check of the bit-flip and min-sum decoders.
//
// No Pallas original: it replaces the XLA fusions of the JAX package's
// parity checks, decoders/minsum_qc.py::qc_check_satisfied (the min-sum
// and BP decoders' early-termination test), decoders/qc_ops.py::
// qc_syndrome_bipolar and decoders/base.py::syndrome_from_hard /
// check_satisfied (the bit-flip decoders' CN update).  In the port these
// were one gather and one XOR (or product) pass over [M, B] per check slot,
// after a copy of the whole [N, B] decision plane with a zero row appended.
//
// The function (kernels/check.py has the plain twin), per check c and
// batch lane b:
//   * odd = XOR over the slots t of (d[cols[c, t], b] < 0); an entry
//     cols[c, t] outside [0, N) (the sentinel N of an absent slot) is no
//     term.  The XOR of the values' sign bits is the XOR of "negative", so
//     the kernel folds raw words: exact for any integer decisions;
//   * syn[c, b] = odd ? -1 : +1 in d's type, when asked for;
//   * sat[b] = no check of lane b is odd.  The wrapper fills sat with true;
//     a block writes false for each lane where one of its checks is odd
//     (every writer writes the same value, so no atomic is needed).
//
// Bound on the H100: device memory.  A call must read the [N, B] decision
// plane once and write the [M, B] syndrome once (when asked): 132 MB for
// the flagship's int32 [1008, 32768] plane, 0.04 ms at 3.35 TB/s.  Each
// check reads its dc rows, so the plane is read dc_avg * M / N times over;
// the design keeps the repeats in L2.
//
// Design: a block is 32 lane threads (L contiguous lanes each: 16 int8 or
// 4 int32 lanes, one 16-byte load a row, where the batch and d's address
// allow it, else 1) by kRows check rows; thread (x, y) takes the checks
// y, y + kRows, ... of the block's chunk of kRows * kPer checks.  Grid x
// runs over the check chunks, grid y over the lane chunks.  Blocks are
// issued x fastest, so the blocks in flight cover every check of a few
// narrow lane chunks (~17 MB of the flagship's int32 plane): the rows
// that neighbouring checks share come from L2.  Every thread of a row
// reads the same table entries (broadcast loads).  The block ORs its
// rows' odd-lane bits in shared memory, and row 0 writes sat once per
// lane, only where it still reads true (on a batch of failed frames every
// block finds odd checks: the read keeps the stores to the shared flags
// few).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLaneThreads = 32;
constexpr int kRows = 8;  // check rows of a block
constexpr int kPer = 2;   // checks a thread

template <typename D, int L>
struct alignas(sizeof(D) * L) Vec {
  D v[L];
};

template <typename D, int L>
__global__ void __launch_bounds__(kLaneThreads * kRows)
    parity_check_kernel(const int64_t* __restrict__ cols, int64_t m, int dc,
                        int64_t n, const D* __restrict__ d, int64_t batch,
                        bool* sat, D* __restrict__ syn) {
  using V = Vec<D, L>;
  __shared__ unsigned odd_bits[kLaneThreads];
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (ty == 0) odd_bits[tx] = 0;
  __syncthreads();
  const int64_t b = ((int64_t)blockIdx.y * kLaneThreads + tx) * L;
  if (b < batch) {  // batch % L == 0: all L lanes or none
    unsigned bits = 0;
    for (int k = 0; k < kPer; ++k) {
      const int64_t c = ((int64_t)blockIdx.x * kPer + k) * kRows + ty;
      if (c >= m) break;
      const int64_t* row = cols + c * dc;
      D acc[L];
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = 0;
#pragma unroll 4
      for (int t = 0; t < dc; ++t) {
        const int64_t col = row[t];
        if ((uint64_t)col >= (uint64_t)n) continue;  // an absent slot
        const V v = *reinterpret_cast<const V*>(d + col * batch + b);
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l] ^= v.v[l];
      }
      if (syn != nullptr) {
        V out;
#pragma unroll
        for (int l = 0; l < L; ++l) out.v[l] = acc[l] < 0 ? D(-1) : D(1);
        *reinterpret_cast<V*>(syn + c * batch + b) = out;
      }
#pragma unroll
      for (int l = 0; l < L; ++l) bits |= (acc[l] < 0 ? 1u : 0u) << l;
    }
    if (bits) atomicOr(&odd_bits[tx], bits);
  }
  __syncthreads();
  if (ty == 0 && b < batch) {
    const unsigned bits = odd_bits[tx];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if ((bits >> l & 1u) && sat[b + l]) sat[b + l] = false;
    }
  }
}

template <typename D, int L>
cudaError_t launch(const int64_t* cols, int64_t m, int dc, int64_t n,
                   const void* d, int64_t batch, bool* sat, void* syn,
                   cudaStream_t stream) {
  const int64_t lane_blocks = (batch / L + kLaneThreads - 1) / kLaneThreads;
  const int64_t check_blocks = (m + kRows * kPer - 1) / (kRows * kPer);
  if (lane_blocks > 65535 || check_blocks > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  parity_check_kernel<D, L>
      <<<dim3((unsigned)check_blocks, (unsigned)lane_blocks),
         dim3(kLaneThreads, kRows), 0, stream>>>(
          cols, m, dc, n, static_cast<const D*>(d), batch, sat,
          static_cast<D*>(syn));
  return cudaGetLastError();
}

template <typename D>
cudaError_t launch_lanes(const int64_t* cols, int64_t m, int dc, int64_t n,
                         const void* d, int64_t batch, int lanes, bool* sat,
                         void* syn, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(D);  // one 16-byte load a row
  if (lanes == kWide) {
    return launch<D, kWide>(cols, m, dc, n, d, batch, sat, syn, stream);
  }
  if (lanes == 1) {
    return launch<D, 1>(cols, m, dc, n, d, batch, sat, syn, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ldpc_parity_check(const int64_t* cols, int64_t m, int dc,
                                 int64_t n, const void* d, int d_is_int8,
                                 int64_t batch, int lanes, void* sat,
                                 void* syn, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || batch <= 0) return (int)cudaSuccess;
  if (dc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  bool* out = static_cast<bool*>(sat);
  if (d_is_int8) {
    err = launch_lanes<int8_t>(cols, m, dc, n, d, batch, lanes, out, syn, s);
  } else {
    err = launch_lanes<int32_t>(cols, m, dc, n, d, batch, lanes, out, syn,
                                s);
  }
  return (int)err;
}
