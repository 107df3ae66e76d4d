// Kernel B11: one layer of the row-layered min-sum decoder in one pass.
//
// Replaces no Pallas kernel: the JAX package leaves the layered step to XLA,
// which fuses ldpcsimulation_tpu/decoders/minsum_layered.py:96-175 (per
// layer the rolled posterior reads, the extrinsic, the two-min scan, the
// variant post-op, the posterior's update and the storage cast) into its
// own loops.  The port's plain form of one layer
// (kernels/layered.py::minsum_layer_step_plain, the twin) ran it as ~9
// kernels: the posterior's gather, the stored messages' widening, the
// extrinsic, B1 (csrc/minsum_cn_scan.cu) over an f32 buffer, the absent
// rows' fill, the posterior's add and scatter, the clamp and the f16 cast,
// each reading and writing whole [dc * z, B] f32 planes.  This kernel is a
// new design around B1's scan, not a call into B1, which stays the flooding
// decoders' kernel.
//
// The layer (one base row bi, its z checks, each meeting each of the dc
// single circulants' columns once) and the state: the posterior q [N, B]
// (f32, updated in place) and the layer's stored messages l_old [dc * z, B]
// (f16 or f32), row t * z + r for check r's edge in circulant t; the new
// messages go to a fresh l_new of the same shape and type.  slot_cols
// [z, dc] (LayerPlan.slot_cols) holds the column of check r's slot t, -1
// where the edge is absent.  Per check r and batch lane, bit for bit the
// twin's (each operation correctly rounded, in the twin's order; built
// without --use_fast_math and written with __fsub_rn/__fadd_rn/__fdiv_rn,
// so that nvcc contracts nothing):
//   * per named slot t: x_t = q[col] - l_old[t * z + r] (the message
//     widened exactly);
//   * the two smallest |x_t| with the `<=` tie-break toward min1 and its
//     slot, and the sign product with sgn(x) = +1 where x >= 0 (-0.0 counts
//     as +, NaN as -); a NaN's magnitude is never a minimum;
//   * out_t = the product of the other slots' signs times (min2 at the
//     argmin, else min1), then the post-op in f32: normalized
//     __fdiv_rn(out, alpha); offset |out| - delta, zero where that is not
//     above 0, else with out's sign (a zero out counts as +); plain none;
//   * q[col] = x_t + out_t, in place; l_new[t * z + r] = out_t, for f16
//     storage clamped to +-65504 first (torch.clamp: NaN passes) and
//     rounded to nearest;
//   * an absent slot reads nothing, writes +0.0 to its l_new row and leaves
//     its column alone.
// In place is safe: without a two-circulant pair every column of a layer
// is met by exactly one (check, slot), so each thread reads, then writes,
// lanes that no other thread touches.  (A pair layer, DVB-S2's tied
// blocks, meets a column twice and stays on the twin's body with B1:
// decoders/minsum_layered.py.)
//
// Bound on the H100: device memory.  A layer reads and writes each of its
// columns once in f32 and reads and writes each message once in the
// storage type: B * (cols * 2 * 4 + edges * 2 * 2) bytes at f16 storage,
// 255 MB a layer of wifi_1944_972 at B=32768 (0.076 ms at 3.35 TB/s), the
// count of gpubench's layer_step_roofline_pct.  The arithmetic is a few f32
// operations an edge-lane.  The design moves those bytes and no others:
//  * Every extrinsic stays in registers.  The slot cap CAP (8/16/32/64, the
//    smallest that holds the layer's degree) is a template parameter and
//    the slot loops unroll to it, so x_t for all slots lives in registers
//    between the scan and the stores, and each row is read once and written
//    once: no f32 buffer between the steps, no second read.
//  * Several lanes per thread, as in B1 and B8 (lanes.cuh).  A thread takes
//    L contiguous lanes of one check: one 16-byte f32 access of q and one
//    8-byte f16 access of the messages per slot at L = 4.  The cap bounds
//    L through the registers (x_t: CAP * L floats): L = 4 up to 8 slots,
//    2 up to 16, 1 beyond (kernels/bp.py::CAP_LANES, B8's budget);
//    kernels/layered.py::layer_instance takes the widest that the batch
//    and the three planes' alignment allow.
//  * All of a check's loads in flight before the first subtraction; the
//    post-op on the two minima only (division and subtraction are
//    symmetric in sign under round-to-nearest, as in B1), each output p1 or
//    p2 with its sign bit XORed in.
//  * Only the named slots.  Every thread of a block works on the same
//    check, so each warp loads the check's slot_cols row once and compacts
//    it past the -1 entries (ballot, prefix popcount, shared memory), in
//    slot order; the loops run to the check's degree.
//
// Blocks of up to 128 threads cover 128 * L lanes of one check; checks sit
// on grid y (one launch per 65535, still one call).  The posterior is read
// by ordinary loads, not lanes.cuh's read-only path: the launch writes it.
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
constexpr float kHalfMax = 65504.0f;

using ldpc::Lanes;
using ldpc::load_lanes;
using ldpc::store_lanes;

// L lanes of the posterior by an ordinary load (the launch writes q).
template <int L>
__device__ __forceinline__ Lanes<float, L> load_posterior(const float* p) {
  Lanes<float, L> v;
  if constexpr (L == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    v.w[0] = x.x;
    v.w[1] = x.y;
    v.w[2] = x.z;
    v.w[3] = x.w;
  } else if constexpr (L == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v.w[0] = x.x;
    v.w[1] = x.y;
  } else {
    v.w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  return v;
}

// torch.clamp(x, lo, hi) on the card: NaN passes, else min(max(x, lo), hi)
__device__ __forceinline__ float clamp_as_torch(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// The variant post-op on a magnitude v >= 0: the output's bits before its
// sign, and (offset only) whether the output takes the sign of the slot.
__device__ __forceinline__ uint32_t post(float v, int variant, float alpha,
                                         float delta, bool& signed_out) {
  signed_out = true;
  if (variant == 1) return __float_as_uint(__fdiv_rn(v, alpha));
  if (variant == 2) {
    const float m = __fsub_rn(v, delta);
    signed_out = m > 0.0f && v != 0.0f;
    return m > 0.0f ? __float_as_uint(m) : 0u;
  }
  return __float_as_uint(v);
}

// Checks r0 + blockIdx.y of the layer; L lanes per thread on grid x; at
// most CAP slots; S the storage type.
template <typename S, int CAP, int L>
__global__ void __launch_bounds__(kThreads)
    minsum_layer_step_kernel(float* __restrict__ q,
                             const S* __restrict__ l_old,
                             const int32_t* __restrict__ slot_cols, int z,
                             int r0, int dc, int64_t batch, int variant,
                             float alpha, float delta,
                             S* __restrict__ l_new) {
  using Mask = std::conditional_t<(CAP > 32), uint64_t, uint32_t>;
  __shared__ int32_t col_list[kWarps][CAP];
  __shared__ int32_t row_list[kWarps][CAP];
  const int lane = threadIdx.x & 31;
  const int r = r0 + blockIdx.y;
  const int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * L;
  // column c's and message row m's lanes sit c * q_stride and m * l_stride
  // bytes on
  const uint64_t q_stride = (uint64_t)batch * sizeof(float);
  const uint64_t l_stride = (uint64_t)batch * sizeof(S);
  char* qb = reinterpret_cast<char*>(q + b);
  const char* lo = reinterpret_cast<const char*>(l_old + b);
  char* ln = reinterpret_cast<char*>(l_new + b);

  // the check's named slots, compacted in slot order (per warp): column and
  // message row; `absent` the slots below dc that name no column
  const int32_t* cols = slot_cols + (int64_t)r * dc;
  const unsigned below = (1u << lane) - 1u;
  int32_t* my_cols = col_list[threadIdx.x >> 5];
  int32_t* my_rows = row_list[threadIdx.x >> 5];
  const int32_t ca = lane < dc ? cols[lane] : -1;
  const unsigned va = __ballot_sync(kFull, ca >= 0);
  if (ca >= 0) {
    my_cols[__popc(va & below)] = ca;
    my_rows[__popc(va & below)] = lane * z + r;
  }
  int deg = __popc(va);
  uint64_t named = va;
  if constexpr (CAP > 32) {
    const int32_t cb = lane + 32 < dc ? cols[lane + 32] : -1;
    const unsigned vb = __ballot_sync(kFull, cb >= 0);
    if (cb >= 0) {
      my_cols[deg + __popc(vb & below)] = cb;
      my_rows[deg + __popc(vb & below)] = (lane + 32) * z + r;
    }
    deg += __popc(vb);
    named |= (uint64_t)vb << 32;
  }
  const uint64_t slots = dc >= 64 ? ~0ull : (1ull << dc) - 1ull;
  uint64_t absent = slots & ~named;
  __syncwarp();
  // batch % L == 0: a thread has all L lanes or none, and past the ballots
  // an idle one has no more work
  if (b >= batch) return;

  // every named slot's posterior and message in flight, then the
  // extrinsics, the two least magnitudes, their slot and the sign bits
  Lanes<float, L> qv[CAP];
  Lanes<S, L> lv[CAP];
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k < deg) {
      qv[k] = load_posterior<L>(reinterpret_cast<const float*>(
          qb + (uint32_t)my_cols[k] * q_stride));
      lv[k] = load_lanes<S, L>(reinterpret_cast<const S*>(
          lo + (uint32_t)my_rows[k] * l_stride));
    }
  }
  float x[CAP][L];
  uint32_t mag1[L], mag2[L];
  int idx1[L];
  Mask neg[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    mag1[l] = mag2[l] = 0x7f800000u;  // +inf, the min2 of a degree-1 check
    idx1[l] = -1;
    neg[l] = 0;
  }
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k < deg) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        x[k][l] = __fsub_rn(qv[k].at(l), lv[k].at(l));
        // for finite values and +-inf integer order is float order; a
        // NaN's magnitude lies above +inf's, so it is never a minimum
        const uint32_t mag = __float_as_uint(x[k][l]) & 0x7fffffffu;
        const bool is_min = mag <= mag1[l];
        mag2[l] = min(mag2[l], max(mag1[l], mag));
        idx1[l] = is_min ? k : idx1[l];
        mag1[l] = min(mag1[l], mag);
        if (!(x[k][l] >= 0.0f)) neg[l] |= (Mask)1 << k;
      }
    }
  }

  // per lane the two post-op results and the parity of the sign bits
  uint32_t p1[L], p2[L], par[L];
  bool s1[L], s2[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    p1[l] = post(__uint_as_float(mag1[l]), variant, alpha, delta, s1[l]);
    p2[l] = post(__uint_as_float(mag2[l]), variant, alpha, delta, s2[l]);
    int odd;
    if constexpr (CAP > 32) {
      odd = __popcll(neg[l]) & 1;
    } else {
      odd = __popc(neg[l]) & 1;
    }
    par[l] = odd ? kSign : 0u;
  }

  // each slot's output: the posterior's update in place, the message
  // stored in S
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k < deg) {
      uint32_t qo[L], mo[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const bool at_min = k == idx1[l];
        const uint32_t own = (uint32_t)((neg[l] >> k) & 1) << 31;
        const uint32_t sign =
            (at_min ? s2[l] : s1[l]) ? (par[l] ^ own) : 0u;
        const float out = __uint_as_float((at_min ? p2[l] : p1[l]) ^ sign);
        qo[l] = __float_as_uint(__fadd_rn(x[k][l], out));
        mo[l] = __float_as_uint(std::is_same_v<S, __half>
                                    ? clamp_as_torch(out, -kHalfMax, kHalfMax)
                                    : out);
      }
      store_lanes<float, L>(
          reinterpret_cast<float*>(qb + (uint32_t)my_cols[k] * q_stride), qo);
      store_lanes<S, L>(
          reinterpret_cast<S*>(ln + (uint32_t)my_rows[k] * l_stride), mo);
    }
  }

  // absent slots: a +0.0 message, the column untouched
  uint32_t zero[L];
#pragma unroll
  for (int l = 0; l < L; ++l) zero[l] = 0u;
  while (absent) {
    const int t = __ffsll((long long)absent) - 1;
    absent &= absent - 1;
    store_lanes<S, L>(reinterpret_cast<S*>(
                          ln + (uint64_t)(t * z + r) * l_stride),
                      zero);
  }
}

template <typename S, int CAP, int L>
cudaError_t launch_lanes(float* q, const S* l_old, const int32_t* slot_cols,
                         int z, int dc, int64_t batch, int variant,
                         float alpha, float delta, S* l_new,
                         cudaStream_t stream) {
  const int64_t threads_needed = batch / L;
  const int threads = threads_needed >= kThreads
                          ? kThreads
                          : (int)((threads_needed + 31) / 32 * 32);
  const int64_t blocks = (threads_needed + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  for (int r0 = 0; r0 < z; r0 += 65535) {
    const int chunk = z - r0 < 65535 ? z - r0 : 65535;
    minsum_layer_step_kernel<S, CAP, L>
        <<<dim3((unsigned)blocks, chunk), threads, 0, stream>>>(
            q, l_old, slot_cols, z, r0, dc, batch, variant, alpha, delta,
            l_new);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The instance of slot cap `cap` and `lanes` lanes per thread:
// kernels/layered.py::layer_instance picks them, the cap from dc and the
// lanes from the cap's register budget, the batch and the three planes'
// alignment.
template <typename S>
cudaError_t launch(float* q, const S* l_old, const int32_t* slot_cols, int z,
                   int dc, int64_t batch, int cap, int lanes, int variant,
                   float alpha, float delta, S* l_new, cudaStream_t stream) {
  switch (cap * 8 + lanes) {
    case 8 * 8 + 4:
      return launch_lanes<S, 8, 4>(q, l_old, slot_cols, z, dc, batch,
                                   variant, alpha, delta, l_new, stream);
    case 8 * 8 + 2:
      return launch_lanes<S, 8, 2>(q, l_old, slot_cols, z, dc, batch,
                                   variant, alpha, delta, l_new, stream);
    case 8 * 8 + 1:
      return launch_lanes<S, 8, 1>(q, l_old, slot_cols, z, dc, batch,
                                   variant, alpha, delta, l_new, stream);
    case 16 * 8 + 2:
      return launch_lanes<S, 16, 2>(q, l_old, slot_cols, z, dc, batch,
                                    variant, alpha, delta, l_new, stream);
    case 16 * 8 + 1:
      return launch_lanes<S, 16, 1>(q, l_old, slot_cols, z, dc, batch,
                                    variant, alpha, delta, l_new, stream);
    case 32 * 8 + 1:
      return launch_lanes<S, 32, 1>(q, l_old, slot_cols, z, dc, batch,
                                    variant, alpha, delta, l_new, stream);
    case 64 * 8 + 1:
      return launch_lanes<S, 64, 1>(q, l_old, slot_cols, z, dc, batch,
                                    variant, alpha, delta, l_new, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q f32 [N, B] in place; l_old and l_new [dc * z, B] in f16 (l_is_f16) or
// f32; slot_cols [z, dc] int32.
extern "C" int ldpc_minsum_layer_step(void* q, const void* l_old,
                                      int l_is_f16, const int32_t* slot_cols,
                                      int z, int dc, int64_t batch, int cap,
                                      int lanes, int variant, float alpha,
                                      float delta, void* l_new, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (z <= 0 || batch <= 0) return (int)cudaSuccess;
  if (variant < 0 || variant > 2 || dc < 1 || dc > cap || cap > kMaxDc)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* qf = static_cast<float*>(q);
  if (l_is_f16) {
    err = launch(qf, static_cast<const __half*>(l_old), slot_cols, z, dc,
                 batch, cap, lanes, variant, alpha, delta,
                 static_cast<__half*>(l_new), s);
  } else {
    err = launch(qf, static_cast<const float*>(l_old), slot_cols, z, dc,
                 batch, cap, lanes, variant, alpha, delta,
                 static_cast<float*>(l_new), s);
  }
  return (int)err;
}
