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
// unrolled to a compile-time cap of 8, 16, 32 or 64 slots).
//
// The 64-slot instance (high-rate codes: dc_max 33..64) keeps neither the
// rows nor the messages in registers: 64 of each would spill.  The emission
// needs only each message's sign, so the scan packs the signs into one
// 64-bit mask, and the emission re-reads the check's row table (a broadcast
// load that the cache serves).  Row offsets staged in shared memory instead
// ran 2.2x slower on the H100.  Checks sit on grid y, which stops at 65535, so a table
// of more checks launches once per chunk of 65535 (a loop over the checks
// inside the kernel cost the 8-slot instance 8 % of its time).
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

// The scan of one check for one lane, rows and messages in registers
// (instances of up to 32 slots).
template <typename T, int MAXDC>
__device__ __forceinline__ void scan_check(const T* __restrict__ v2c,
                                           const int32_t* __restrict__ rows,
                                           int dc_max, int64_t batch,
                                           int64_t b, int variant, float alpha,
                                           float delta,
                                           float* __restrict__ c2v) {
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

// The scan for up to 64 slots: signs in a bit mask, rows read twice.
template <typename T, int MAXDC>
__device__ __forceinline__ void scan_check_wide(
    const T* __restrict__ v2c, const int32_t* __restrict__ rows, int dc_max,
    int64_t batch, int64_t b, int variant, float alpha, float delta,
    float* __restrict__ c2v) {
  const float inf = __int_as_float(0x7f800000);
  float min1 = inf, min2 = inf, sprod = 1.0f;
  int idx = -1;
  uint64_t neg = 0;  // bit t: message t is not >= 0 (sgn -1)
#pragma unroll
  for (int t = 0; t < MAXDC; ++t) {
    const int32_t r = t < dc_max ? rows[t] : -1;
    if (r >= 0) {
      const float x = load_f32(v2c + (int64_t)r * batch + b);
      const float a = fabsf(x);
      const bool pos = x >= 0.0f;
      neg |= pos ? 0ull : (1ull << t);
      sprod = sprod * (pos ? 1.0f : -1.0f);
      const bool is_min = a <= min1;
      min2 = is_min ? min1 : (a < min2 ? a : min2);
      idx = is_min ? t : idx;
      min1 = is_min ? a : min1;
    }
  }
#pragma unroll
  for (int t = 0; t < MAXDC; ++t) {
    const int32_t r = t < dc_max ? rows[t] : -1;
    if (r < 0) continue;
    const float mag = idx == t ? min2 : min1;
    float out = sprod * mag * (((neg >> t) & 1ull) ? -1.0f : 1.0f);
    if (variant == 1) {
      out = in_storage(__fdiv_rn(out, alpha), v2c);
    } else if (variant == 2) {
      const float m2 = in_storage(__fsub_rn(fabsf(out), delta), v2c);
      out = m2 > 0.0f ? (out >= 0.0f ? m2 : -m2) : 0.0f;
    }
    c2v[(int64_t)r * batch + b] = out;
  }
}

// Checks c0 + blockIdx.y; lanes on grid x.
template <typename T, int MAXDC>
__global__ void minsum_cn_scan_kernel(const T* __restrict__ v2c,
                                      const int32_t* __restrict__ cn_rows,
                                      int c0, int dc_max, int64_t batch,
                                      int variant, float alpha, float delta,
                                      float* __restrict__ c2v) {
  const int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int32_t* rows = cn_rows + ((int64_t)c0 + blockIdx.y) * dc_max;
  if constexpr (MAXDC <= 32) {
    scan_check<T, MAXDC>(v2c, rows, dc_max, batch, b, variant, alpha, delta,
                         c2v);
  } else {
    scan_check_wide<T, MAXDC>(v2c, rows, dc_max, batch, b, variant, alpha,
                              delta, c2v);
  }
}

template <typename T, int MAXDC>
cudaError_t launch_chunks(const T* v2c, const int32_t* cn_rows, int m,
                          int dc_max, int64_t batch, int variant, float alpha,
                          float delta, float* c2v, cudaStream_t stream) {
  const int threads = 256;
  const unsigned lanes = (unsigned)((batch + threads - 1) / threads);
  for (int c0 = 0; c0 < m; c0 += 65535) {
    const int chunk = m - c0 < 65535 ? m - c0 : 65535;
    minsum_cn_scan_kernel<T, MAXDC><<<dim3(lanes, chunk), threads, 0, stream>>>(
        v2c, cn_rows, c0, dc_max, batch, variant, alpha, delta, c2v);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const T* v2c, const int32_t* cn_rows, int m, int dc_max,
                   int64_t batch, int variant, float alpha, float delta,
                   float* c2v, cudaStream_t stream) {
  if (dc_max <= 8) {
    return launch_chunks<T, 8>(v2c, cn_rows, m, dc_max, batch, variant,
                               alpha, delta, c2v, stream);
  } else if (dc_max <= 16) {
    return launch_chunks<T, 16>(v2c, cn_rows, m, dc_max, batch, variant,
                                alpha, delta, c2v, stream);
  } else if (dc_max <= 32) {
    return launch_chunks<T, 32>(v2c, cn_rows, m, dc_max, batch, variant,
                                alpha, delta, c2v, stream);
  } else if (dc_max <= 64) {
    return launch_chunks<T, 64>(v2c, cn_rows, m, dc_max, batch, variant,
                                alpha, delta, c2v, stream);
  }
  return cudaErrorInvalidValue;
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
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  if (v2c_is_f16) {
    err = launch(static_cast<const __half*>(v2c), cn_rows, m, dc_max, batch,
                 variant, alpha, delta, c2v, (cudaStream_t)stream);
  } else {
    err = launch(static_cast<const float*>(v2c), cn_rows, m, dc_max, batch,
                 variant, alpha, delta, c2v, (cudaStream_t)stream);
  }
  return (int)err;
}
