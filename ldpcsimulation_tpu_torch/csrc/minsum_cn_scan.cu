// Kernel B1: min-sum check-node update with the Tanner-graph routing inside.
//
// Replaces ldpcsimulation_tpu/kernels/minsum_pallas.py::minsum_cn_scan_pallas
// (its _kernel), which scanned PRE-GATHERED [M, dc_max, B] blocks because
// Mosaic had no row gathers.  Hopper gathers rows well, so this kernel reads
// each check's messages straight from the VN-ordered message planes: for
// check c and slot t it reads row cn_rows[c, t] of v2c [R, B] and writes its
// output to the SAME row of c2v [R, B] (f32, or f16 for f16 storage: the
// flooding steps ask for the storage type, which kernel B5 then overwrites
// in place with v2c'; see store_lanes).  For a QC code that row is
// plane(bj, slot) * z + (r + shift) % z, so the read is the JAX decoder's
// roll by -shift and the write its roll back by +shift
// (decoders/minsum_qc.py:278,311); every named row is written exactly once.
//
// The function: per check and batch lane, the sign product (sgn(0) = +1:
// x >= 0, so -0.0 counts as +1) and the two smallest magnitudes; each slot
// gets sprod * (min2 if it holds the minimum, else min1) * sgn(msg), then the
// variant post-op (normalized: / alpha; offset: |out| - delta, clamped at 0)
// rounded to the STORAGE type, as the JAX decoder computes it.
//
// Bound on the H100: device memory.  A call reads each named row of v2c
// once (2 or 4 bytes per edge and lane) and writes it once to c2v (4
// bytes, or 2 in the f16 store): 6 bytes per edge-lane in f16 (4 with the
// f16 store), which 3.35 TB/s moves at 0.56e12 (0.84e12) edge-lanes/s.
// The card issues ~33e12 thread instructions/s, so memory
// decides while a thread spends fewer than ~60 instructions per edge-lane.
// The first design (one thread per (check, lane), every slot unrolled to a
// cap of 8/16/32/64 slots, the post-op per slot) spent 60-130 and stayed
// at 44-80 % of the memory bound; this one spends 18-31 in its 4-lane
// instances on the callers' tables (51 in the 1-lane one) and reaches
// 82-88 % of it at B=32768 (PERF.md, B1's row, from chip_smoke.py):
//
//  * Several lanes per thread.  A thread takes L contiguous lanes, one
//    vector load per slot and one vector store (4 lanes: 8-byte f16 or
//    16-byte f32 loads, a float4 store); the row index and its address cost
//    once per slot for all L lanes.  Instances <__half, 4/2/1, float>,
//    <float, 4/2/1, float> and <__half, 4/2/1, __half> (the f16 store:
//    8-, 4- or 2-byte stores): kernels/minsum.py::lane_width, the one
//    place that decides, takes the widest L that the batch and both
//    pointers' alignment allow, so an odd batch or a misaligned view runs
//    the 1- or 2-lane instance of the same kernel.  An 8-lane f16
//    instance ran slower.
//  * An integer scan.  A magnitude is the bit pattern without its sign, and
//    for finite values and +-inf integer order is float order.  f16 packs
//    the magnitude and the slot into one 32-bit key (mag << 16 | slot), so
//    min1, min2 and the argmin are three integer min/max per lane; f32 keeps
//    the slot beside the magnitude.  Which of tied minima is "the" argmin
//    cannot change an output (tied minima make min2 == min1).  The sign of
//    each message goes into a per-lane bit mask (64 bits: one per slot) by
//    a predicated OR on x < 0, so -0.0 sets no bit.  The messages are not
//    kept.
//  * The post-op on the two minima only.  Division, subtraction and the
//    rounding to the storage type are symmetric in sign under
//    round-to-nearest-even, so p1 = post(min1) and p2 = post(min2) are
//    computed once per (check, lane), and each slot's output is p1 or p2
//    with its sign bit XORed in: the product of the OTHER slots' signs (the
//    mask XOR its parity).  offset's corners: a pre-op +-0 gives +post (its
//    `out >= 0` holds for -0.0) and a clamped result is +0, so there the
//    sign bits are cleared; normalized and plain keep a zero's sign.
//  * Only the named slots.  Every thread of a block works on the same check,
//    so each warp loads the check's row list once and compacts it past the
//    -1 entries (ballot, prefix popcount, a store to shared memory), in slot
//    order; the loops then run over the check's degree, not dc_max: 32 of
//    the stratified table's 60 slots.  The scan takes slots four at a time
//    (four loads in flight per thread), then two, then one; the emission one
//    at a time, each slot's row a broadcast load from the compacted list (a
//    warp shuffle from registers in its place ran no faster).
//
// Blocks of up to 128 threads (4 warps) cover 128 * L lanes of one check;
// checks sit on grid y, which stops at 65535, so a table of more checks
// launches once per chunk of 65535.  Row addresses are 64-bit (any batch).
// No shared memory beyond the compacted lists (256 bytes a warp); no block
// barrier.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "lanes.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDc = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kSign = 0x80000000u;

using ldpc::Lanes;
using ldpc::load_lanes;
using ldpc::store_lanes;

// Round to the storage type and widen back (identity for f32 storage).
template <typename T>
__device__ __forceinline__ float in_storage(float x) {
  if constexpr (std::is_same_v<T, __half>) {
    return __half2float(__float2half_rn(x));
  } else {
    return x;
  }
}

// The scan state of one thread's L lanes over one check.  f16: key =
// magnitude << 16 | slot, so key1 holds min1 and its slot, key2 min2.  f32:
// the magnitudes and min1's slot.  neg[l][h] bit t: slot 32h + t < 0.
template <typename T, int L>
struct Scan;

template <int L>
struct Scan<__half, L> {
  uint32_t key1[L], key2[L], neg[L][2];

  __device__ __forceinline__ Scan() {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      key1[l] = 0xffffffffu;
      key2[l] = 0x7c00ffffu;  // +inf, the min2 of a degree-1 check
      neg[l][0] = neg[l][1] = 0u;
    }
  }

  template <int H>
  __device__ __forceinline__ void step(const Lanes<__half, L>& v, int k) {
    const uint32_t bit = 1u << (k - 32 * H);
    const __half zero = __ushort_as_half(0);
#pragma unroll
    for (int j = 0; j < Lanes<__half, L>::kWords; ++j) {
      const uint32_t mag = v.w[j] & 0x7fff7fffu;
#pragma unroll
      for (int h = 0; h < 2 && 2 * j + h < L; ++h) {
        const int l = 2 * j + h;
        const uint32_t key =
            (h ? (mag & 0xffff0000u) : (mag << 16)) | (uint32_t)k;
        key2[l] = min(key2[l], max(key1[l], key));
        key1[l] = min(key1[l], key);
        const __half x = __ushort_as_half(
            (unsigned short)(h ? v.w[j] >> 16 : v.w[j] & 0xffffu));
        if (__hlt(x, zero)) neg[l][H] |= bit;  // -0.0 < 0 is false
      }
    }
  }

  __device__ __forceinline__ void minima(int l, float& m1, float& m2,
                                         int& idx) const {
    m1 = __half2float(__ushort_as_half((unsigned short)(key1[l] >> 16)));
    m2 = __half2float(__ushort_as_half((unsigned short)(key2[l] >> 16)));
    idx = (int)(key1[l] & 0xffffu);
  }
};

template <int L>
struct Scan<float, L> {
  uint32_t mag1[L], mag2[L], neg[L][2];
  int idx1[L];

  __device__ __forceinline__ Scan() {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      mag1[l] = mag2[l] = 0x7f800000u;  // +inf
      idx1[l] = 0;
      neg[l][0] = neg[l][1] = 0u;
    }
  }

  template <int H>
  __device__ __forceinline__ void step(const Lanes<float, L>& v, int k) {
    const uint32_t bit = 1u << (k - 32 * H);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t mag = v.w[l] & 0x7fffffffu;
      const bool is_min = mag <= mag1[l];
      mag2[l] = min(mag2[l], max(mag1[l], mag));
      idx1[l] = is_min ? k : idx1[l];
      mag1[l] = min(mag1[l], mag);
      if (__uint_as_float(v.w[l]) < 0.0f) neg[l][H] |= bit;  // not -0.0
    }
  }

  __device__ __forceinline__ void minima(int l, float& m1, float& m2,
                                         int& idx) const {
    m1 = __uint_as_float(mag1[l]);
    m2 = __uint_as_float(mag2[l]);
    idx = idx1[l];
  }
};

// The variant post-op on a magnitude v >= 0: the output's magnitude bits,
// and (offset only) whether the output keeps the sign the slot's messages
// give it.
template <typename T, int VARIANT>
__device__ __forceinline__ uint32_t post(float v, float alpha, float delta,
                                         bool& signed_out) {
  signed_out = true;
  if constexpr (VARIANT == 1) {
    return __float_as_uint(in_storage<T>(__fdiv_rn(v, alpha)));
  } else if constexpr (VARIANT == 2) {
    const float q = in_storage<T>(__fsub_rn(v, delta));
    signed_out = q > 0.0f && v != 0.0f;
    return q > 0.0f ? __float_as_uint(q) : 0u;
  } else {
    return __float_as_uint(v);
  }
}

// Checks c0 + blockIdx.y; L lanes per thread on grid x; outputs in O.
template <typename T, int L, typename O>
__global__ void __launch_bounds__(kThreads)
    minsum_cn_lanes_kernel(const T* __restrict__ v2c,
                           const int32_t* __restrict__ cn_rows, int c0,
                           int dc_max, int64_t batch, int variant,
                           float alpha, float delta, O* __restrict__ c2v) {
  __shared__ int32_t staged[kWarps][kMaxDc];
  const int lane = threadIdx.x & 31;
  const int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * L;
  const char* in = reinterpret_cast<const char*>(v2c + b);
  char* out = reinterpret_cast<char*>(c2v + b);
  // row r's lanes sit r * stride bytes on
  const uint64_t in_stride = (uint64_t)batch * sizeof(T);
  const uint64_t out_stride = (uint64_t)batch * sizeof(O);

  // the check's named rows, compacted in slot order (per warp)
  const int32_t* rows = cn_rows + ((int64_t)c0 + blockIdx.y) * dc_max;
  const int32_t ra = lane < dc_max ? rows[lane] : -1;
  const int32_t rb = lane + 32 < dc_max ? rows[lane + 32] : -1;
  const unsigned va = __ballot_sync(kFull, ra >= 0);
  const unsigned vb = __ballot_sync(kFull, rb >= 0);
  const int na = __popc(va);
  const int deg = na + __popc(vb);
  int32_t* list = staged[threadIdx.x >> 5];
  const unsigned below = (1u << lane) - 1u;
  if (ra >= 0) list[__popc(va & below)] = ra;
  if (rb >= 0) list[na + __popc(vb & below)] = rb;
  __syncwarp();
  // batch % L == 0: a thread has all L lanes or none, and past the ballots
  // an idle one has no more work
  if (b >= batch) return;

  Scan<T, L> st;
  // N slots from k: N loads in flight, then the scan steps
  auto chunk = [&](auto n, auto h, int k) {
    constexpr int N = decltype(n)::value, H = decltype(h)::value;
    Lanes<T, L> v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint64_t at = (uint32_t)list[k + j] * in_stride;
      v[j] = load_lanes<T, L>(reinterpret_cast<const T*>(in + at));
    }
#pragma unroll
    for (int j = 0; j < N; ++j) st.template step<H>(v[j], k + j);
  };
  // slots [k, end) of mask word H: by fours, then a two, then a one
  auto scan = [&](auto h, int k, int end) {
    using Four = std::integral_constant<int, 4>;
    using Two = std::integral_constant<int, 2>;
    using One = std::integral_constant<int, 1>;
#pragma unroll 1
    for (; k + 4 <= end; k += 4) chunk(Four{}, h, k);
    if (k + 2 <= end) {
      chunk(Two{}, h, k);
      k += 2;
    }
    if (k < end) chunk(One{}, h, k);
  };
  scan(std::integral_constant<int, 0>{}, 0, deg < 32 ? deg : 32);
  if (deg > 32) scan(std::integral_constant<int, 1>{}, 32, deg);

  // per lane: the two post-op results and the sign mask of each slot's
  // output, the product of the other slots' signs: the mask XOR its parity
  uint32_t p1[L], p2[L], sm[L][2];
  int idx[L];
  auto finish = [&](auto var) {
    constexpr int VARIANT = decltype(var)::value;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float m1, m2;
      st.minima(l, m1, m2, idx[l]);
      bool s1, s2;
      p1[l] = post<T, VARIANT>(m1, alpha, delta, s1);
      p2[l] = post<T, VARIANT>(m2, alpha, delta, s2);
      const uint32_t parity =
          (__popc(st.neg[l][0]) + __popc(st.neg[l][1])) & 1 ? ~0u : 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sm[l][h] = st.neg[l][h] ^ parity;
        if constexpr (VARIANT == 2) {  // min1's slots keep s1, idx's s2
          const int t = idx[l] - 32 * h;
          const uint32_t at = t >= 0 && t < 32 ? 1u << t : 0u;
          sm[l][h] &= (s1 ? ~at : 0u) | (s2 ? at : 0u);
        }
      }
    }
  };
  if (variant == 1) {
    finish(std::integral_constant<int, 1>{});
  } else if (variant == 2) {
    finish(std::integral_constant<int, 2>{});
  } else {
    finish(std::integral_constant<int, 0>{});
  }

  auto emit = [&](auto h, int k, int end) {
    constexpr int H = decltype(h)::value;
#pragma unroll 1
    for (; k < end; ++k) {
      const uint64_t at = (uint32_t)list[k] * out_stride;
      const int shift = 31 - (k - 32 * H);
      uint32_t o[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        o[l] = (k == idx[l] ? p2[l] : p1[l]) ^ ((sm[l][H] << shift) & kSign);
      }
      store_lanes<O, L>(reinterpret_cast<O*>(out + at), o);
    }
  };
  emit(std::integral_constant<int, 0>{}, 0, deg < 32 ? deg : 32);
  emit(std::integral_constant<int, 1>{}, 32, deg);
}

template <typename T, int L, typename O>
cudaError_t launch_lanes(const T* v2c, const int32_t* cn_rows, int m,
                         int dc_max, int64_t batch, int variant, float alpha,
                         float delta, O* c2v, cudaStream_t stream) {
  const int64_t threads_needed = batch / L;
  const int threads = threads_needed >= kThreads
                          ? kThreads
                          : (int)((threads_needed + 31) / 32 * 32);
  const int64_t blocks = (threads_needed + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  for (int c0 = 0; c0 < m; c0 += 65535) {
    const int chunk = m - c0 < 65535 ? m - c0 : 65535;
    minsum_cn_lanes_kernel<T, L, O>
        <<<dim3((unsigned)blocks, chunk), threads, 0, stream>>>(
            v2c, cn_rows, c0, dc_max, batch, variant, alpha, delta, c2v);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The instance of `lanes` lanes per thread: kernels/minsum.py::lane_width
// picks it so that the batch is a multiple of it and both pointers keep its
// vector accesses aligned.
template <typename T, typename O>
cudaError_t launch(const T* v2c, const int32_t* cn_rows, int m, int dc_max,
                   int64_t batch, int lanes, int variant, float alpha,
                   float delta, O* c2v, cudaStream_t stream) {
  switch (lanes) {
    case 1:
      return launch_lanes<T, 1, O>(v2c, cn_rows, m, dc_max, batch, variant,
                                   alpha, delta, c2v, stream);
    case 2:
      return launch_lanes<T, 2, O>(v2c, cn_rows, m, dc_max, batch, variant,
                                   alpha, delta, c2v, stream);
    case 4:
      return launch_lanes<T, 4, O>(v2c, cn_rows, m, dc_max, batch, variant,
                                   alpha, delta, c2v, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// c2v is f32, or f16 when v2c is (c2v_is_f16: the storage-typed output).
extern "C" int ldpc_minsum_cn_scan(const void* v2c, int v2c_is_f16,
                                   const int32_t* cn_rows, int m, int dc_max,
                                   int64_t batch, int lanes, int variant,
                                   float alpha, float delta, void* c2v,
                                   int c2v_is_f16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || batch <= 0) return (int)cudaSuccess;
  if (variant < 0 || variant > 2 || dc_max > kMaxDc ||
      (c2v_is_f16 && !v2c_is_f16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (c2v_is_f16) {
    err = launch(static_cast<const __half*>(v2c), cn_rows, m, dc_max, batch,
                 lanes, variant, alpha, delta, static_cast<__half*>(c2v), s);
  } else if (v2c_is_f16) {
    err = launch(static_cast<const __half*>(v2c), cn_rows, m, dc_max, batch,
                 lanes, variant, alpha, delta, static_cast<float*>(c2v), s);
  } else {
    err = launch(static_cast<const float*>(v2c), cn_rows, m, dc_max, batch,
                 lanes, variant, alpha, delta, static_cast<float*>(c2v), s);
  }
  return (int)err;
}
