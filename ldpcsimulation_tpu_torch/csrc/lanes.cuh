// One thread's L contiguous batch lanes of one message row, moved by one
// vector access: the kernels that take several lanes per thread (B1
// minsum_cn_scan.cu, B8 bp_cn_pair.cu).  L lanes of T load as L * sizeof(T)
// bytes (16, 8, 4 or 2), which the caller keeps aligned
// (kernels/minsum.py::lane_width).
#pragma once

#include <cuda_fp16.h>

#include <cstdint>
#include <type_traits>

namespace ldpc {

// One thread's L lanes of one row, as 32-bit words (a 1-lane f16 row: the
// value in the low half of word 0).
template <typename T, int L>
struct Lanes {
  static constexpr int kBytes = L * (int)sizeof(T);
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  uint32_t w[kWords];

  // lane l's value as f32 (exact for f16)
  __device__ __forceinline__ float at(int l) const {
    if constexpr (std::is_same_v<T, __half>) {
      const uint32_t x = w[l / 2];
      return __half2float(
          __ushort_as_half((unsigned short)(l % 2 ? x >> 16 : x & 0xffffu)));
    } else {
      return __uint_as_float(w[l]);
    }
  }
};

template <typename T, int L>
__device__ __forceinline__ Lanes<T, L> load_lanes(const T* p) {
  Lanes<T, L> v;
  if constexpr (Lanes<T, L>::kBytes == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = x.x;
    v.w[1] = x.y;
    v.w[2] = x.z;
    v.w[3] = x.w;
  } else if constexpr (Lanes<T, L>::kBytes == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v.w[0] = x.x;
    v.w[1] = x.y;
  } else if constexpr (Lanes<T, L>::kBytes == 4) {
    v.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    v.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return v;
}

// L outputs, f32 bit patterns, stored in the output type O: f32, or f16
// rounded to nearest (exact where every output is an f16 value already, as
// B1's f16 store makes sure).
template <typename O, int L>
__device__ __forceinline__ void store_lanes(O* p, const uint32_t (&o)[L]) {
  if constexpr (std::is_same_v<O, __half>) {
    uint32_t h[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      h[l] = __half_as_ushort(__float2half_rn(__uint_as_float(o[l])));
    }
    if constexpr (L == 4) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
    } else if constexpr (L == 2) {
      *reinterpret_cast<uint32_t*>(p) = h[0] | h[1] << 16;
    } else {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)h[0];
    }
  } else if constexpr (L == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(o[0], o[1], o[2], o[3]);
  } else if constexpr (L == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(o[0], o[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = o[0];
  }
}

}  // namespace ldpc
