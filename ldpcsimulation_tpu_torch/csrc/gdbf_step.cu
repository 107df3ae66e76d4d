// Kernel B7: the parallel GDBF step on the variable side, in place.
//
// No Pallas original: it replaces the XLA fusion of the JAX bit-flip step
// after its CN update (ldpcsimulation_tpu/decoders/gdbf.py: the neighbour
// sum and the flip metric :414-420, the parallel rule of flip_decisions
// :200, the flip :437, threshold adaptation :440-443, output smoothing
// :451-454).  In the port these were ~25 plain-torch passes over [N, B]:
// three gathers and adds for the sum, the metric, the flip, the threshold
// and the smoothing sum each as a where over the whole plane.
//
// The function (kernels/gdbf.py has the plain twin), per variable i and
// batch lane b:
//   * s = sum over the slots t of syn[vn_checks[i, t], b]; an entry outside
//     [0, M) (the sentinel M of an absent slot) contributes 0.  Integer
//     adds: exact in any order;
//   * e = (d*y + w*s) + pert, each operation rounded to f32 in that order
//     (the __fmul_rn/__fadd_rn intrinsics: the build contracts a*b + c into
//     an FMA otherwise).  w is a scalar or the per-VN weight w[i]; pert is
//     left out when there is none;
//   * on an active lane (act[b]): flip = e < theta; d <- -d where it flips;
//     with adaptation, theta <- theta * lam (f32) where it does not; inside
//     the smoothing window (a host flag of the step), dsum <- dsum + d (the
//     new d).  An inactive lane keeps d, theta and dsum.
// d and syn share a type: int8 or int32 (+-1).
//
// In place: a thread reads and writes only its own (i, b) elements of d,
// theta and dsum, and syn is another buffer.
//
// Bound on the H100: device memory.  One in-window SMNGDBF step reads syn
// once ([M, B]), d, y, theta, pert and dsum, and writes d, theta and dsum:
// with int8 decisions 0.5 + 17 + 9 bytes per (i, b) on qc_1008_504
// (0.26 ms at [1008 x 32768] over 3.35 TB/s).  The arithmetic is a handful
// of integer adds and three f32 operations per element.
//
// Design: grid x runs over the variables, grid y over chunks of lanes
// (L = 4 contiguous lanes a thread where the batch and every pointer allow
// vector accesses, else 1).  Blocks are issued x fastest, so the blocks in
// flight cover every variable of a few lane chunks and the syndrome rows
// that a variable's dv checks share with its neighbours come from L2.
// Every thread of a block reads the same table row (broadcast loads).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

template <typename T, int L>
struct alignas(sizeof(T) * L) Vec {
  T v[L];
};

template <typename T, int L>
__device__ __forceinline__ Vec<T, L> load(const T* p) {
  return *reinterpret_cast<const Vec<T, L>*>(p);
}

template <typename T, int L>
__device__ __forceinline__ void store(T* p, const Vec<T, L>& v) {
  *reinterpret_cast<Vec<T, L>*>(p) = v;
}

// D: d's and syn's type; L lanes a thread; kPert: a perturbation plane;
// kWv: the per-VN weight wv[i] (else the scalar w).
template <typename D, int L, bool kPert, bool kWv>
__global__ void __launch_bounds__(kThreads)
    gdbf_step_kernel(D* __restrict__ d, const float* __restrict__ y,
                     const D* __restrict__ syn,
                     const int64_t* __restrict__ vn_checks, int64_t m,
                     int dv, float* __restrict__ thetas,
                     int32_t* __restrict__ dsum,
                     const unsigned char* __restrict__ act, float w,
                     const float* __restrict__ wv,
                     const float* __restrict__ pert, float lam, int adapt,
                     int smooth, int64_t batch) {
  const int64_t b = ((int64_t)blockIdx.y * blockDim.x + threadIdx.x) * L;
  if (b >= batch) return;  // batch % L == 0: all L lanes or none
  const int64_t i = blockIdx.x;
  const int64_t at = i * batch + b;
  const int64_t* nb = vn_checks + i * dv;

  int s[L];
#pragma unroll
  for (int l = 0; l < L; ++l) s[l] = 0;
#pragma unroll 4
  for (int t = 0; t < dv; ++t) {
    const int64_t c = nb[t];
    if ((uint64_t)c >= (uint64_t)m) continue;  // an absent slot
    const Vec<D, L> v = load<D, L>(syn + c * batch + b);
#pragma unroll
    for (int l = 0; l < L; ++l) s[l] += v.v[l];
  }

  Vec<D, L> dv_ = load<D, L>(d + at);
  const Vec<float, L> yv = load<float, L>(y + at);
  Vec<float, L> th = load<float, L>(thetas + at);
  const Vec<unsigned char, L> av = load<unsigned char, L>(act + b);
  Vec<float, L> pv;
  if constexpr (kPert) pv = load<float, L>(pert + at);
  const float wi = kWv ? wv[i] : w;
  bool active[L], keep[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float e = __fadd_rn(__fmul_rn((float)dv_.v[l], yv.v[l]),
                        __fmul_rn(wi, (float)s[l]));
    if constexpr (kPert) e = __fadd_rn(e, pv.v[l]);
    const bool flip = e < th.v[l];
    active[l] = av.v[l] != 0;
    keep[l] = !flip;
    if (active[l] && flip) dv_.v[l] = -dv_.v[l];
  }
  store<D, L>(d + at, dv_);
  if (adapt) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (active[l] && keep[l]) th.v[l] = __fmul_rn(th.v[l], lam);
    }
    store<float, L>(thetas + at, th);
  }
  if (smooth) {
    Vec<int32_t, L> ds = load<int32_t, L>(dsum + at);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (active[l]) ds.v[l] += dv_.v[l];
    }
    store<int32_t, L>(dsum + at, ds);
  }
}

struct Args {
  void* d;
  const float* y;
  const void* syn;
  const int64_t* vn_checks;
  int64_t n, m;
  int dv;
  float* thetas;
  int32_t* dsum;
  const unsigned char* act;
  float w;
  const float* wv;
  const float* pert;
  float lam;
  int adapt, smooth;
  int64_t batch;
};

template <typename D, int L, bool kPert, bool kWv>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int64_t threads_needed = a.batch / L;
  const int threads = threads_needed >= kThreads
                          ? kThreads
                          : (int)((threads_needed + 31) / 32 * 32);
  const int64_t lane_blocks = (threads_needed + threads - 1) / threads;
  if (lane_blocks > 65535 || a.n > 0x7fffffff) return cudaErrorInvalidValue;
  gdbf_step_kernel<D, L, kPert, kWv>
      <<<dim3((unsigned)a.n, (unsigned)lane_blocks), threads, 0, stream>>>(
          static_cast<D*>(a.d), a.y, static_cast<const D*>(a.syn),
          a.vn_checks, a.m, a.dv, a.thetas, a.dsum, a.act, a.w, a.wv,
          a.pert, a.lam, a.adapt, a.smooth, a.batch);
  return cudaGetLastError();
}

template <typename D, int L>
cudaError_t launch_flags(const Args& a, cudaStream_t stream) {
  if (a.pert != nullptr) {
    return a.wv != nullptr ? launch<D, L, true, true>(a, stream)
                           : launch<D, L, true, false>(a, stream);
  }
  return a.wv != nullptr ? launch<D, L, false, true>(a, stream)
                         : launch<D, L, false, false>(a, stream);
}

template <typename D>
cudaError_t launch_lanes(const Args& a, int lanes, cudaStream_t stream) {
  switch (lanes) {
    case 1:
      return launch_flags<D, 1>(a, stream);
    case 4:
      return launch_flags<D, 4>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ldpc_gdbf_parallel_step(
    void* d, int d_is_int8, const float* y, const void* syn,
    const int64_t* vn_checks, int64_t n, int64_t m, int dv, float* thetas,
    int32_t* dsum, const void* act, float w, const float* wv,
    const float* pert, float lam, int adapt, int smooth, int64_t batch,
    int lanes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || batch <= 0) return (int)cudaSuccess;
  if (dv <= 0) return (int)cudaErrorInvalidValue;
  const Args a{d,      y,     syn,   vn_checks,
               n,      m,     dv,    thetas,
               dsum,   static_cast<const unsigned char*>(act),
               w,      wv,    pert,  lam,
               adapt,  smooth, batch};
  cudaStream_t s = (cudaStream_t)stream;
  err = d_is_int8 ? launch_lanes<int8_t>(a, lanes, s)
                  : launch_lanes<int32_t>(a, lanes, s);
  return (int)err;
}
