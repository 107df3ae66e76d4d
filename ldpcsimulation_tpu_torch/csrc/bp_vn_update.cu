// Kernel B9: the sum-product variable-node update, in one pass.
//
// Replaces no Pallas kernel: the JAX package leaves this step to XLA, which
// fuses the VN side of ldpcsimulation_tpu/decoders/bp_qc.py::qc_bp_step
// (fold, posterior, extrinsic, clip, storage cast) into one loop.  The
// port's plain form (kernels/bp.py::bp_vn_update_plain, the twin) ran it as
// ~11 plain-torch kernels a round (three row gathers and two adds for the
// fold, the channel add, the total[row_col] gather, the subtraction, two
// clamps, the cast), each reading and writing whole [edges, B] f32 planes.
//
// Beside kernel B5 (csrc/minsum_vn_update.cu), not an adaptation of it: B5
// reads c2v in the storage type, folds in the channel's type and writes
// v2c' in place over c2v; BP reads f32 c2v (kernel B8's output), adds in f32
// whatever the channel's type, clips to +-max_llr and writes v2c' to a
// separate plane in the storage type (f16 or f32).
//
// The function, per column j and batch lane, bit for bit the twin's on the
// card (each operation correctly rounded, in the twin's order; built
// without --use_fast_math, and written with __fadd_rn/__fsub_rn so that
// nvcc contracts nothing):
//   * acc = left fold of the terms of vn_rows[j, :] in table order, from
//     -0.0 (the identity of IEEE addition: the first term enters
//     unchanged, signed zero and all);
//   * total = y + acc, y widened to f32, written to total [N, B] in f32;
//   * for each term c of row r: x = total - c, then torch.clamp's
//     +-max_llr (NaN passes; min(max(x, lo), hi) keeps -0.0), and for f16
//     storage the saturating cast's +-65504 clamp (a no-op for a clip
//     bound below it), then the round to nearest f16, written to row r of
//     v2c' [R, B].
// vn_rows entries, as B5's: r >= 0 reads row r; -1 is no term (a position
// past the column's degree in an irregular QC fold); -(r + 2) is a +0.0
// term whose output still goes to row r (an absent QC edge, whose c2v row
// the check update zeroes).
//
// Bound on the H100: device memory.  A call reads each c2v row (f32) and y
// once and writes total (f32) and each v2c' row once: at f16 storage and an
// f32 channel 4 + 2 bytes an edge-lane and 4 + 4 a column-lane, 858.8 MB on
// qc_1008_504 at B=32768 (0.2564 ms at 3.35 TB/s).  The arithmetic is a
// handful of adds, compares and one conversion per edge-lane.
//
// Design: B5's grid.  Every thread of a block works on the same column
// (grid y, one launch per 65535 columns), so the column's table entries are
// broadcast loads; each thread takes L contiguous lanes (L = 4, 2 or 1:
// kernels/bp.py::bp_vn_update takes the widest that the batch and the four
// planes' alignment allow) with one vector access per row (lanes.cuh:
// 16-byte f32 loads and 8-byte f16 stores at L = 4).  The first kHeld terms
// stay in registers between the fold and the stores, all their loads (and
// y's) issued before the first add; a column of higher degree
// (wifi_1944_972's 11) reads its later rows a second time.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "lanes.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHeld = 8;  // terms kept in registers (dv_max of DVB-S2: 8)
constexpr float kHalfMax = 65504.0f;

// torch.clamp(x, lo, hi) on the card: NaN passes, else min(max(x, lo), hi)
__device__ __forceinline__ float clamp_as_torch(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// Y: the channel's type (y); S: the storage type (v2c').  Columns
// col0 + blockIdx.y; L lanes per thread on grid x.
template <typename Y, typename S, int L>
__global__ void __launch_bounds__(kThreads)
    bp_vn_kernel(const float* __restrict__ c2v, const Y* __restrict__ y,
                 const int32_t* __restrict__ vn_rows, int col0, int dv,
                 int64_t batch, float max_llr, float* __restrict__ total,
                 S* __restrict__ v2c) {
  const int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * L;
  // batch % L == 0: a thread has all L lanes or none
  if (b >= batch) return;
  const int64_t col = (int64_t)col0 + blockIdx.y;
  const int32_t* rows = vn_rows + col * dv;
  // table entry e's term (+0.0 for e <= -2)
  auto term = [&](int32_t e, float (&t)[L]) {
    if (e >= 0) {
      const auto v = ldpc::load_lanes<float, L>(c2v + (int64_t)e * batch + b);
#pragma unroll
      for (int l = 0; l < L; ++l) t[l] = v.at(l);
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) t[l] = 0.0f;
    }
  };
  float acc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) acc[l] = -0.0f;
  auto fold = [&](const float (&t)[L]) {
#pragma unroll
    for (int l = 0; l < L; ++l) acc[l] = __fadd_rn(acc[l], t[l]);
  };

  const auto yv = ldpc::load_lanes<Y, L>(y + col * batch + b);
  int32_t ent[kHeld];
  float held[kHeld][L];
#pragma unroll
  for (int s = 0; s < kHeld; ++s) {
    ent[s] = s < dv ? rows[s] : -1;
    if (ent[s] != -1) term(ent[s], held[s]);
  }
#pragma unroll
  for (int s = 0; s < kHeld; ++s) {
    if (ent[s] != -1) fold(held[s]);
  }
#pragma unroll 1
  for (int s = kHeld; s < dv; ++s) {
    const int32_t e = rows[s];
    if (e != -1) {
      float t[L];
      term(e, t);
      fold(t);
    }
  }

  float tot[L];
  uint32_t out[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    tot[l] = __fadd_rn(yv.at(l), acc[l]);
    out[l] = __float_as_uint(tot[l]);
  }
  ldpc::store_lanes<float, L>(total + col * batch + b, out);

  // v2c' = storage_cast(clamp(total - term, +-max_llr)), to the term's row
  auto emit = [&](int32_t e, const float (&t)[L]) {
    uint32_t o[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float x = clamp_as_torch(__fsub_rn(tot[l], t[l]), -max_llr, max_llr);
      if constexpr (std::is_same_v<S, __half>) {
        x = clamp_as_torch(x, -kHalfMax, kHalfMax);
      }
      o[l] = __float_as_uint(x);
    }
    ldpc::store_lanes<S, L>(v2c + (int64_t)(e >= 0 ? e : -e - 2) * batch + b,
                            o);
  };
#pragma unroll
  for (int s = 0; s < kHeld; ++s) {
    if (ent[s] != -1) emit(ent[s], held[s]);
  }
#pragma unroll 1
  for (int s = kHeld; s < dv; ++s) {
    const int32_t e = rows[s];
    if (e != -1) {
      float t[L];
      term(e, t);
      emit(e, t);
    }
  }
}

template <typename Y, typename S, int L>
cudaError_t launch_lanes(const float* c2v, const void* y,
                         const int32_t* vn_rows, int n, int dv, int64_t batch,
                         float max_llr, float* total, void* v2c,
                         cudaStream_t stream) {
  const int64_t threads_needed = batch / L;
  const int threads = threads_needed >= kThreads
                          ? kThreads
                          : (int)((threads_needed + 31) / 32 * 32);
  const int64_t blocks = (threads_needed + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  for (int c0 = 0; c0 < n; c0 += 65535) {
    const int chunk = n - c0 < 65535 ? n - c0 : 65535;
    bp_vn_kernel<Y, S, L><<<dim3((unsigned)blocks, chunk), threads, 0,
                            stream>>>(
        c2v, static_cast<const Y*>(y), vn_rows, c0, dv, batch, max_llr, total,
        static_cast<S*>(v2c));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename Y, typename S>
cudaError_t launch(const float* c2v, const void* y, const int32_t* vn_rows,
                   int n, int dv, int64_t batch, float max_llr, int lanes,
                   float* total, void* v2c, cudaStream_t stream) {
  switch (lanes) {
    case 1:
      return launch_lanes<Y, S, 1>(c2v, y, vn_rows, n, dv, batch, max_llr,
                                   total, v2c, stream);
    case 2:
      return launch_lanes<Y, S, 2>(c2v, y, vn_rows, n, dv, batch, max_llr,
                                   total, v2c, stream);
    case 4:
      return launch_lanes<Y, S, 4>(c2v, y, vn_rows, n, dv, batch, max_llr,
                                   total, v2c, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ldpc_bp_vn_update(const void* c2v, const void* y,
                                 int y_is_f16, const int32_t* vn_rows, int n,
                                 int dv, int64_t batch, float max_llr,
                                 int lanes, void* total, void* v2c,
                                 int v2c_is_f16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || batch <= 0) return (int)cudaSuccess;
  if (dv <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* c = static_cast<const float*>(c2v);
  float* t = static_cast<float*>(total);
  if (y_is_f16 && v2c_is_f16) {
    err = launch<__half, __half>(c, y, vn_rows, n, dv, batch, max_llr, lanes,
                                 t, v2c, s);
  } else if (y_is_f16) {
    err = launch<__half, float>(c, y, vn_rows, n, dv, batch, max_llr, lanes,
                                t, v2c, s);
  } else if (v2c_is_f16) {
    err = launch<float, __half>(c, y, vn_rows, n, dv, batch, max_llr, lanes,
                                t, v2c, s);
  } else {
    err = launch<float, float>(c, y, vn_rows, n, dv, batch, max_llr, lanes,
                               t, v2c, s);
  }
  return (int)err;
}
