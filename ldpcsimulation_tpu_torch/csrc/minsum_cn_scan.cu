// Kernel B1: min-sum check-node update with the Tanner-graph routing inside.
//
// Replaces ldpcsimulation_tpu/kernels/minsum_pallas.py::minsum_cn_scan_pallas
// (its _kernel), which scanned PRE-GATHERED [M, dc_max, B] blocks because
// Mosaic had no row gathers.  Hopper gathers rows well, so this kernel reads
// each check's messages straight from the VN-ordered message planes: for
// check c and slot t it reads row cn_rows[c, t] of v2c [R, B] and writes its
// output to the SAME row of c2v [R, B].  For a QC code that row is
// plane(bj, slot) * z + (r + shift) % z, so the read is the JAX decoder's
// roll by -shift and the write its roll back by +shift
// (decoders/minsum_qc.py:278,311); every row is written exactly once.
//
// Per check and batch lane: the sign product (sgn(0) = +1, tested as
// x >= 0 so -0.0 counts as +1) and the two smallest magnitudes, with `<=`
// for min1 and `<` for min2 so the LAST minimum in slot order wins the index;
// each slot then gets sprod * (min2 if idx == t else min1) * sgn(msg).  The
// scan only selects stored values, so it is exact in f32 for f16 or f32
// storage.  The variant post-op (normalized: / alpha; offset: |out| - delta,
// clamped at 0) runs in the STORAGE precision, as the JAX decoder does: the
// f32 result is rounded to the storage type and widened back (alpha and delta
// arrive already rounded to it).
//
// Bound on the H100: device memory.  Per call it reads v2c once
// (2 or 4 bytes per edge message) and writes c2v once (4 bytes); at the main
// path's (1008, 504) code, B = 32768, f16 storage that is 198 MB read and
// 396 MB written.  Design: one thread per (check, batch lane) with lanes
// contiguous, so each slot's load and store coalesce along B; the check's
// row indices are the same for the whole block (broadcast loads); the
// messages stay in registers between the scan and the emission (slot loops
// unrolled to a compile-time cap of 8, 16 or 32 slots).
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __half* p) {
  return __half2float(*p);
}

// Round to the storage type and widen back (identity for f32 storage).
__device__ __forceinline__ float in_storage(float x, const float*) {
  return x;
}
__device__ __forceinline__ float in_storage(float x, const __half*) {
  return __half2float(__float2half_rn(x));
}

template <typename T, int MAXDC>
__global__ void minsum_cn_scan_kernel(const T* __restrict__ v2c,
                                      const int32_t* __restrict__ cn_rows,
                                      int dc_max, int64_t batch, int variant,
                                      float alpha, float delta,
                                      float* __restrict__ c2v) {
  const int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int32_t* rows = cn_rows + (int64_t)blockIdx.y * dc_max;
  const float inf = __int_as_float(0x7f800000);

  int32_t row[MAXDC];
  float msg[MAXDC];
  float min1 = inf, min2 = inf, sprod = 1.0f;
  int idx = -1;
#pragma unroll
  for (int t = 0; t < MAXDC; ++t) {
    row[t] = t < dc_max ? rows[t] : -1;
    msg[t] = 0.0f;
    if (row[t] >= 0) {
      const float x = load_f32(v2c + (int64_t)row[t] * batch + b);
      msg[t] = x;
      const float a = fabsf(x);
      sprod = sprod * (x >= 0.0f ? 1.0f : -1.0f);
      const bool is_min = a <= min1;
      min2 = is_min ? min1 : (a < min2 ? a : min2);
      idx = is_min ? t : idx;
      min1 = is_min ? a : min1;
    }
  }
#pragma unroll
  for (int t = 0; t < MAXDC; ++t) {
    if (row[t] < 0) continue;
    const float mag = idx == t ? min2 : min1;
    float out = sprod * mag * (msg[t] >= 0.0f ? 1.0f : -1.0f);
    if (variant == 1) {
      out = in_storage(__fdiv_rn(out, alpha), v2c);
    } else if (variant == 2) {
      const float m2 = in_storage(__fsub_rn(fabsf(out), delta), v2c);
      out = m2 > 0.0f ? (out >= 0.0f ? m2 : -m2) : 0.0f;
    }
    c2v[(int64_t)row[t] * batch + b] = out;
  }
}

template <typename T>
cudaError_t launch(const T* v2c, const int32_t* cn_rows, int m, int dc_max,
                   int64_t batch, int variant, float alpha, float delta,
                   float* c2v, cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((batch + threads - 1) / threads), (unsigned)m);
  if (dc_max <= 8) {
    minsum_cn_scan_kernel<T, 8><<<grid, threads, 0, stream>>>(
        v2c, cn_rows, dc_max, batch, variant, alpha, delta, c2v);
  } else if (dc_max <= 16) {
    minsum_cn_scan_kernel<T, 16><<<grid, threads, 0, stream>>>(
        v2c, cn_rows, dc_max, batch, variant, alpha, delta, c2v);
  } else if (dc_max <= 32) {
    minsum_cn_scan_kernel<T, 32><<<grid, threads, 0, stream>>>(
        v2c, cn_rows, dc_max, batch, variant, alpha, delta, c2v);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int ldpc_minsum_cn_scan(const void* v2c, int v2c_is_f16,
                                   const int32_t* cn_rows, int m, int dc_max,
                                   int64_t batch, int variant, float alpha,
                                   float delta, float* c2v, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || batch <= 0) return (int)cudaSuccess;
  if (m > 65535 || variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  if (v2c_is_f16) {
    err = launch(static_cast<const __half*>(v2c), cn_rows, m, dc_max, batch,
                 variant, alpha, delta, c2v, (cudaStream_t)stream);
  } else {
    err = launch(static_cast<const float*>(v2c), cn_rows, m, dc_max, batch,
                 variant, alpha, delta, c2v, (cudaStream_t)stream);
  }
  return (int)err;
}
