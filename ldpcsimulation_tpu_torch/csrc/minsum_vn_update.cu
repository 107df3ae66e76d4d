// Kernel B5: the flooding min-sum variable-node update, in one pass.
//
// No Pallas original: it replaces the XLA fusion of the JAX QC step
// (ldpcsimulation_tpu/decoders/minsum_qc.py::qc_minsum_step, whose fold and
// extrinsic subtraction "XLA CSEs into one fused computation with no
// materialized c2v buffer") and the slot-array step's vn_update + storage
// cast (ldpcsimulation_tpu/decoders/minsum.py::minsum_step).  In the port
// these were ~10 plain-torch passes over [edges, B] f32 temporaries.
//
// The function, per column j and batch lane (kernels/minsum.py has the
// plain twin):
//   * each c2v term of the column, in the order of the table vn_rows[j, :],
//     cast to the channel's type C (f32 or f16);
//   * acc = left fold of the terms, each add rounded to C (an f16 channel
//     folds in f16: an f32 add rounded to f16 is the f16 add, since
//     24 >= 2 * 11 + 2 bits make the double rounding harmless);
//   * total = y + acc, rounded to C, written to total [N, B];
//   * for each term c: v2c' = storage_cast(total - c): the difference
//     rounded to C, then for f16 storage clamped to +-65504 before the cast
//     (an f32 value in (65504, 65520) gives 65504, never inf), written IN
//     PLACE over the c2v row it came from.
// vn_rows entries: r >= 0 reads row r; -1 is no term (a position past the
// column's degree in an irregular QC fold); -(r + 2) is a +0.0 term whose
// output still goes to row r (a padding slot of the slot arrays, an absent
// QC edge: the JAX decoders add an exact zero there, and -0.0 + 0.0 = +0.0
// matters to the sign bits B1 reads).  The fold starts from -0.0, the
// identity of IEEE addition, so the first term enters unchanged.
//
// In place: a thread reads every row of its column before it writes any,
// and no row belongs to two columns, so no other thread touches them.
//
// Bound on the H100: device memory.  A call reads each c2v row and y once
// and writes each row and total once: at f16 storage with an f32 channel,
// 2 + 2 bytes per edge-lane and 4 + 4 per column-lane (0.197 ms on
// qc_1008_504 at B=32768 over 3.35 TB/s), against ~10 f32 passes before.
// The arithmetic is a handful of adds and conversions per edge-lane.
//
// Design: B1's grid.  Every thread of a block works on the same column
// (grid y, one launch per 65535 columns), so the column's table entries are
// broadcast loads; each thread takes L contiguous lanes (L = 4, 2 or 1:
// kernels/minsum.py::vn_lane_width picks the widest that the batch and the
// pointers' alignment allow) with one vector access per row.  The first
// kHeld terms stay in registers between the fold and the stores, all their
// loads in flight together; a column of higher degree reads its later rows
// a second time (they are still unwritten: every row is written only at its
// own slot).
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kHeld = 8;  // terms kept in registers (dv_max of DVB-S2: 8)
constexpr float kHalfMax = 65504.0f;

// The storage word of a type: f16 values move as raw 16-bit words.
template <typename T>
struct Raw {
  using type = float;
};
template <>
struct Raw<__half> {
  using type = unsigned short;
};

template <typename T, int L>
struct alignas(sizeof(typename Raw<T>::type) * L) Vec {
  typename Raw<T>::type v[L];
};

__device__ __forceinline__ float widen(unsigned short h) {
  return __half2float(__ushort_as_half(h));
}
__device__ __forceinline__ float widen(float x) { return x; }

// x rounded to T's precision, kept as float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same_v<T, __half>) {
    return __half2float(__float2half_rn(x));
  } else {
    return x;
  }
}

// x (already in T's precision) as T's storage word
template <typename T>
__device__ __forceinline__ typename Raw<T>::type narrow(float x) {
  if constexpr (std::is_same_v<T, __half>) {
    return __half_as_ushort(__float2half_rn(x));
  } else {
    return x;
  }
}

// S: c2v and v2c' (the storage type); C: y and total (the channel's type).
// Columns col0 + blockIdx.y; L lanes per thread on grid x.
template <typename S, typename C, int L>
__global__ void __launch_bounds__(kThreads)
    minsum_vn_kernel(typename Raw<S>::type* __restrict__ c2v,
                     const typename Raw<C>::type* __restrict__ y,
                     const int32_t* __restrict__ vn_rows, int col0, int dv,
                     int64_t batch, typename Raw<C>::type* __restrict__ total) {
  using SV = Vec<S, L>;
  using CV = Vec<C, L>;
  const int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * L;
  // batch % L == 0: a thread has all L lanes or none
  if (b >= batch) return;
  const int64_t col = (int64_t)col0 + blockIdx.y;
  const int32_t* rows = vn_rows + col * dv;
  auto row_at = [&](int32_t r) {
    return reinterpret_cast<SV*>(c2v + (int64_t)r * batch + b);
  };
  // table entry e's term in the channel's precision (+0.0 for e <= -2)
  auto term = [&](int32_t e, float (&t)[L]) {
    if (e >= 0) {
      const SV v = *row_at(e);
#pragma unroll
      for (int l = 0; l < L; ++l) t[l] = round_to<C>(widen(v.v[l]));
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
    for (int l = 0; l < L; ++l) acc[l] = round_to<C>(__fadd_rn(acc[l], t[l]));
  };

  const CV yv = *reinterpret_cast<const CV*>(y + col * batch + b);
  float held[kHeld][L];
#pragma unroll
  for (int s = 0; s < kHeld; ++s) {
    if (s < dv) {
      const int32_t e = rows[s];
      if (e != -1) {
        term(e, held[s]);
        fold(held[s]);
      }
    }
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
  CV out;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    tot[l] = round_to<C>(__fadd_rn(widen(yv.v[l]), acc[l]));
    out.v[l] = narrow<C>(tot[l]);
  }
  *reinterpret_cast<CV*>(total + col * batch + b) = out;

  // v2c' = storage_cast(total - term), over the term's own row
  auto emit = [&](int32_t e, const float (&t)[L]) {
    SV o;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float x = round_to<C>(__fsub_rn(tot[l], t[l]));
      if constexpr (std::is_same_v<S, __half>) {  // NaN passes, as in clamp
        x = x > kHalfMax ? kHalfMax : (x < -kHalfMax ? -kHalfMax : x);
      }
      o.v[l] = narrow<S>(x);
    }
    *row_at(e >= 0 ? e : -e - 2) = o;
  };
#pragma unroll
  for (int s = 0; s < kHeld; ++s) {
    if (s < dv) {
      const int32_t e = rows[s];
      if (e != -1) emit(e, held[s]);
    }
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

template <typename S, typename C, int L>
cudaError_t launch_lanes(void* c2v, const void* y, const int32_t* vn_rows,
                         int n, int dv, int64_t batch, void* total,
                         cudaStream_t stream) {
  using SW = typename Raw<S>::type;
  using CW = typename Raw<C>::type;
  const int64_t threads_needed = batch / L;
  const int threads = threads_needed >= kThreads
                          ? kThreads
                          : (int)((threads_needed + 31) / 32 * 32);
  const int64_t blocks = (threads_needed + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  for (int c0 = 0; c0 < n; c0 += 65535) {
    const int chunk = n - c0 < 65535 ? n - c0 : 65535;
    minsum_vn_kernel<S, C, L>
        <<<dim3((unsigned)blocks, chunk), threads, 0, stream>>>(
            static_cast<SW*>(c2v), static_cast<const CW*>(y), vn_rows, c0,
            dv, batch, static_cast<CW*>(total));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename S, typename C>
cudaError_t launch(void* c2v, const void* y, const int32_t* vn_rows, int n,
                   int dv, int64_t batch, int lanes, void* total,
                   cudaStream_t stream) {
  switch (lanes) {
    case 1:
      return launch_lanes<S, C, 1>(c2v, y, vn_rows, n, dv, batch, total,
                                   stream);
    case 2:
      return launch_lanes<S, C, 2>(c2v, y, vn_rows, n, dv, batch, total,
                                   stream);
    case 4:
      return launch_lanes<S, C, 4>(c2v, y, vn_rows, n, dv, batch, total,
                                   stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ldpc_minsum_vn_update(void* c2v, int c2v_is_f16,
                                     const void* y, int y_is_f16,
                                     const int32_t* vn_rows, int n, int dv,
                                     int64_t batch, int lanes, void* total,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || batch <= 0) return (int)cudaSuccess;
  if (dv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (c2v_is_f16 && y_is_f16) {
    err = launch<__half, __half>(c2v, y, vn_rows, n, dv, batch, lanes, total,
                                 s);
  } else if (c2v_is_f16) {
    err = launch<__half, float>(c2v, y, vn_rows, n, dv, batch, lanes, total,
                                s);
  } else if (y_is_f16) {
    err = launch<float, __half>(c2v, y, vn_rows, n, dv, batch, lanes, total,
                                s);
  } else {
    err = launch<float, float>(c2v, y, vn_rows, n, dv, batch, lanes, total,
                               s);
  }
  return (int)err;
}
