// Kernel B8: the sum-product check-node update, the Tanner-graph routing
// inside, the hyperbolic (s, d) pair folds in registers.
//
// Replaces no Pallas kernel: the JAX package leaves this update to XLA,
// which fuses ldpcsimulation_tpu/decoders/bp_qc.py::qc_cn_bp_slots (the
// pair folds of decoders/bp.py) into its own loops.  The port's plain form
// (kernels/bp.py::bp_cn_pair_plain, the twin) computes it one whole
// [M, B] plane at a time: a gather, exp and abs per slot, four multiplies
// and four adds per slot in each of the two folds, the combine, a
// division, a log, a sign multiply and a scatter per output slot, ~210
// kernels a call that each read and write f32 planes in device memory.
//
// Routing as kernel B1's: for check c and slot t it reads row
// cn_rows[c, t] of v2c [R, B] (f16 or f32) and writes its output, f32, to
// the SAME row of c2v [R, B]; -1 names no row (an absent slot), and a row
// that no slot names is left unwritten (the caller zeroes the rows of
// absent edges).
//
// The function, per check and batch lane, bit for bit the twin's on the
// card (the same operations in the same order, each correctly rounded):
//  * u_t = expf(-|m_t|), CUDA's accurate expf (no __expf), as torch.exp;
//    the sign bit of slot t is set where !(m_t >= 0): -0.0 counts as +.
//  * pre_t folds (1, 0) left to right over u_0..u_{t-1} and suf_t right to
//    left over u_{k-1}..u_{t+1}, each step (s + d·u, d + s·u) written
//    with __fmul_rn/__fadd_rn, so nvcc cannot contract it into an FMA.
//    An absent slot is the fold's neutral element bit for bit (u = 0:
//    s + d·0 == s, d + s·0 == d, every s, d finite and positive), so
//    folding only the named slots, as this kernel does, gives the twin's
//    pairs, which fold every slot with +inf in the absent ones.
//  * num = sp·ss + dp·ds, den = sp·ds + dp·ss, in that order; the output
//    is logf(__fdiv_rn(num, den)) (accurate logf, IEEE division, as
//    torch.log and torch's `/`) times the product of the OTHER slots'
//    signs as ±1.0f, so a zero magnitude keeps the sign that the twin's
//    sp * mg gives it.
//  * Built without --use_fast_math (kernels/build.py's flags).
//
// Bounds on the H100.  Memory: each named row read once (2 or 4 bytes an
// edge-lane) and written once (4 bytes): 6 bytes an edge-lane in f16, for
// the benchmark's call (qc_1008_504, 3024 edges x 32768 lanes) 198.2 MB in
// and 396.4 MB out, 0.1775 ms at 3.35 TB/s.  Issue: an accurate expf, a
// logf and an IEEE division per edge-lane besides the 14 multiplies and
// adds of the folds and the combine: 65 SASS instructions an edge-lane on a
// thread's path through the 8-slot, 4-lane f16 instance (chip_smoke.py's
// count), 0.193 ms at the card's issue rate.  The two bounds lie close, so
// the design keeps both low; the main path's call takes 0.318 ms on an
// H100 80GB HBM3 at 700 W (56 % of the memory bound, 61 % of the issue
// bound), and blocks of 64-256 threads with 63-115 registers a thread
// time alike, so occupancy is not what holds it:
//  * Several lanes per thread, as in B1 (and with its vector accesses,
//    lanes.cuh).  A thread takes L contiguous lanes of one check: one
//    vector load per slot (8-byte f16 or 16-byte f32 at L = 4) and one
//    vector store per slot (a float4), the row index and its address once
//    per slot for all L lanes.
//  * Everything in registers.  The slot cap CAP is a template parameter
//    (8/16/32/64, the smallest that holds dc_max): the loops are unrolled
//    to it, so u_t, pre_t and the sign bits live in registers (3 x CAP x L
//    floats: L = 4 up to 8 slots, 2 up to 16, 1 beyond; ptxas gives the
//    8- and 16-slot instances 37-115 registers a thread, the 32-slot ones
//    128 with a 12-byte spill, the 64-slot ones 254), and each row is read
//    from device memory once.  A thread issues all its loads of a check
//    (one a named slot) before the first expf.
//  * The suffix fold runs backwards and emits each output as it goes: no
//    suffix array, no second pass over device memory.
//  * Only the named slots.  Every thread of a block works on the same check,
//    so each warp loads the check's row list once and compacts it past the
//    -1 entries (ballot, prefix popcount, a store to shared memory), in slot
//    order, as B1 does; the loops run to the check's degree.
//
// Blocks of up to 128 threads (4 warps) cover 128 * L lanes of one check;
// checks sit on grid y, which stops at 65535, so a table of more checks
// launches once per chunk of 65535.  Row addresses are 64-bit (any batch).
// kernels/bp.py::bp_instance, the one place that decides, takes CAP from
// dc_max and L from the batch and both pointers' alignment.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "lanes.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

using ldpc::Lanes;
using ldpc::load_lanes;
using ldpc::store_lanes;

// One step of a pair fold: (s, d) <- (s + d·u, d + s·u), no contraction.
__device__ __forceinline__ void fold(float& s, float& d, float u) {
  const float s2 = __fadd_rn(s, __fmul_rn(d, u));
  d = __fadd_rn(d, __fmul_rn(s, u));
  s = s2;
}

// Checks c0 + blockIdx.y; L lanes per thread on grid x; at most CAP slots.
template <typename T, int CAP, int L>
__global__ void __launch_bounds__(kThreads)
    bp_cn_pair_kernel(const T* __restrict__ v2c,
                      const int32_t* __restrict__ cn_rows, int c0,
                      int dc_max, int64_t batch, float* __restrict__ c2v) {
  using Mask = std::conditional_t<(CAP > 32), uint64_t, uint32_t>;
  __shared__ int32_t staged[kWarps][CAP];
  const int lane = threadIdx.x & 31;
  const int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * L;
  const char* in = reinterpret_cast<const char*>(v2c + b);
  char* out = reinterpret_cast<char*>(c2v + b);
  // row r's lanes sit r * stride bytes on
  const uint64_t in_stride = (uint64_t)batch * sizeof(T);
  const uint64_t out_stride = (uint64_t)batch * sizeof(float);

  // the check's named rows, compacted in slot order (per warp)
  const int32_t* rows = cn_rows + ((int64_t)c0 + blockIdx.y) * dc_max;
  const unsigned below = (1u << lane) - 1u;
  int32_t* list = staged[threadIdx.x >> 5];
  const int32_t ra = lane < dc_max ? rows[lane] : -1;
  const unsigned va = __ballot_sync(kFull, ra >= 0);
  if (ra >= 0) list[__popc(va & below)] = ra;
  int deg = __popc(va);
  if constexpr (CAP > 32) {
    const int32_t rb = lane + 32 < dc_max ? rows[lane + 32] : -1;
    const unsigned vb = __ballot_sync(kFull, rb >= 0);
    if (rb >= 0) list[deg + __popc(vb & below)] = rb;
    deg += __popc(vb);
  }
  __syncwarp();
  // batch % L == 0: a thread has all L lanes or none, and past the ballots
  // an idle one has no more work
  if (b >= batch) return;

  // every named row's lanes in flight before the first expf
  Lanes<T, L> raw[CAP];
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k < deg) {
      const uint64_t at = (uint32_t)list[k] * in_stride;
      raw[k] = load_lanes<T, L>(reinterpret_cast<const T*>(in + at));
    }
  }

  // forward: u_k, the sign bits, and pre_k = the fold over slots < k
  float u[CAP][L], ps[CAP][L], pd[CAP][L];
  Mask neg[L];
  float s[L], d[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    neg[l] = 0;
    s[l] = 1.0f;
    d[l] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k < deg) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float m = raw[k].at(l);
        if (!(m >= 0.0f)) neg[l] |= (Mask)1 << k;
        u[k][l] = expf(-fabsf(m));
        ps[k][l] = s[l];
        pd[k][l] = d[l];
        fold(s[l], d[l], u[k][l]);
      }
    }
  }

  // backward: suf_k = the fold over slots > k, each output as it comes
  int par[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if constexpr (CAP > 32) {
      par[l] = __popcll(neg[l]) & 1;
    } else {
      par[l] = __popc(neg[l]) & 1;
    }
    s[l] = 1.0f;
    d[l] = 0.0f;
  }
#pragma unroll
  for (int k = CAP - 1; k >= 0; --k) {
    if (k < deg) {
      uint32_t o[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float num = __fadd_rn(__fmul_rn(ps[k][l], s[l]),
                                    __fmul_rn(pd[k][l], d[l]));
        const float den = __fadd_rn(__fmul_rn(ps[k][l], d[l]),
                                    __fmul_rn(pd[k][l], s[l]));
        const float mag = logf(__fdiv_rn(num, den));
        const int odd = par[l] ^ (int)((neg[l] >> k) & 1);
        o[l] = __float_as_uint(__fmul_rn(odd ? -1.0f : 1.0f, mag));
        fold(s[l], d[l], u[k][l]);
      }
      const uint64_t at = (uint32_t)list[k] * out_stride;
      store_lanes<float, L>(reinterpret_cast<float*>(out + at), o);
    }
  }
}

template <typename T, int CAP, int L>
cudaError_t launch_lanes(const T* v2c, const int32_t* cn_rows, int m,
                         int dc_max, int64_t batch, float* c2v,
                         cudaStream_t stream) {
  const int64_t threads_needed = batch / L;
  const int threads = threads_needed >= kThreads
                          ? kThreads
                          : (int)((threads_needed + 31) / 32 * 32);
  const int64_t blocks = (threads_needed + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  for (int c0 = 0; c0 < m; c0 += 65535) {
    const int chunk = m - c0 < 65535 ? m - c0 : 65535;
    bp_cn_pair_kernel<T, CAP, L>
        <<<dim3((unsigned)blocks, chunk), threads, 0, stream>>>(
            v2c, cn_rows, c0, dc_max, batch, c2v);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The instance of slot cap `cap` and `lanes` lanes per thread:
// kernels/bp.py::bp_instance picks them, the cap from dc_max and the lanes
// from the cap's register budget, the batch and both pointers' alignment.
template <typename T>
cudaError_t launch(const T* v2c, const int32_t* cn_rows, int m, int dc_max,
                   int64_t batch, int cap, int lanes, float* c2v,
                   cudaStream_t stream) {
  const int key = cap * 8 + lanes;
  switch (key) {
    case 8 * 8 + 4:
      return launch_lanes<T, 8, 4>(v2c, cn_rows, m, dc_max, batch, c2v,
                                   stream);
    case 8 * 8 + 2:
      return launch_lanes<T, 8, 2>(v2c, cn_rows, m, dc_max, batch, c2v,
                                   stream);
    case 8 * 8 + 1:
      return launch_lanes<T, 8, 1>(v2c, cn_rows, m, dc_max, batch, c2v,
                                   stream);
    case 16 * 8 + 2:
      return launch_lanes<T, 16, 2>(v2c, cn_rows, m, dc_max, batch, c2v,
                                    stream);
    case 16 * 8 + 1:
      return launch_lanes<T, 16, 1>(v2c, cn_rows, m, dc_max, batch, c2v,
                                    stream);
    case 32 * 8 + 1:
      return launch_lanes<T, 32, 1>(v2c, cn_rows, m, dc_max, batch, c2v,
                                    stream);
    case 64 * 8 + 1:
      return launch_lanes<T, 64, 1>(v2c, cn_rows, m, dc_max, batch, c2v,
                                    stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// c2v is f32 whatever v2c's type (the VN side subtracts it in f32).
extern "C" int ldpc_bp_cn_pair(const void* v2c, int v2c_is_f16,
                               const int32_t* cn_rows, int m, int dc_max,
                               int64_t batch, int cap, int lanes, void* c2v,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || batch <= 0) return (int)cudaSuccess;
  if (dc_max > cap) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (v2c_is_f16) {
    err = launch(static_cast<const __half*>(v2c), cn_rows, m, dc_max, batch,
                 cap, lanes, static_cast<float*>(c2v), s);
  } else {
    err = launch(static_cast<const float*>(v2c), cn_rows, m, dc_max, batch,
                 cap, lanes, static_cast<float*>(c2v), s);
  }
  return (int)err;
}
