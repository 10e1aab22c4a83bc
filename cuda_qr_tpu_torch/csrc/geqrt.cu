// Column-by-column Householder factorization of one narrow panel (geqrt).
//
// Replaces the TPU kernel cuda_qr_tpu/ops/geqrt.py:_geqrt_kernel (called
// through _geqrt_pallas inside the recursive panel factorization), itself
// the successor of the reference's panelHouseholderKernel (qr.cu:60-333).
// For rows >= off of an m x w panel it writes the packed V/R panel, tau (w)
// and the compact-WY T (w x w, row-major, upper triangular) with the
// conventions of cuda_qr_tpu/ops/householder.py: scaled norm, sign/u/tau/
// beta with the zero-column guard, v[d] = 1 implicit, T column j =
// -tau_j T[:j, :j] (V^T v_j) with T[j][j] = tau_j.
//
// Input layout: the panel TRANSPOSED and contiguous (w x m), so that each
// panel column is a contiguous row and every per-column pass coalesces.
// The wrapper makes that copy (1 MB at 8192 x 32 float); it replaces the
// TPU kernel's lane-transposed layout.
//
// What bounds it on an H100: latency.  Per column the kernel runs two block
// reductions (max|x|, then the scaled sum of squares), one fused
// multi-reduction of the w dot products V^T v (for T) and A_c^T v (for the
// update), and a rank-1 update: w dependent steps of a few passes over the
// m - off live rows, all from one SM.  The panel (1 MB at 8192 x 32) stays
// in L2; there is no shared-memory residency requirement, so unlike the
// TPU's 16384-row VMEM limit there is no tall-panel fallback.
//
// Design: one CTA of 512 threads; each thread owns rows d + tid + k*512 of
// the current column; the w dot products of a column are accumulated in
// registers (32 at a time), reduced by warp shuffles and one shared-memory
// pass, so a column costs four barriers-separated reductions, not w.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;      // dot products accumulated per pass
constexpr int kMaxW = 128;

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  // NaN-propagating max, as jnp.max: a + b is NaN when either is.
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

template <typename T, bool kMax>
__device__ T block_reduce(T v, T* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? nan_max(v, u) : v + u;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : T(0);  // 0 is the identity of both
    for (int o = 16; o > 0; o >>= 1) {
      const T u = __shfl_xor_sync(0xffffffffu, v, o);
      v = kMax ? nan_max(v, u) : v + u;
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
geqrt_kernel(const T* __restrict__ PT, T* __restrict__ P, T* __restrict__ tau,
             T* __restrict__ Tm, int m, int w, int off) {
  __shared__ T red[33];
  __shared__ T part[kWarps][kChunk];
  __shared__ T dots[kMaxW];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t panel = static_cast<size_t>(w) * m;

  for (size_t e = tid; e < panel; e += kThreads) P[e] = PT[e];
  for (int e = tid; e < w * w; e += kThreads) Tm[e] = T(0);
  __syncthreads();

  for (int j = 0; j < w; ++j) {
    const int d = off + j;
    T* pj = P + static_cast<size_t>(j) * m;
    const T x0 = pj[d];   // read by all before the owner of row d rewrites it

    // 1. scaled norm of x = pj[d:]
    T a = T(0);
    for (int r = d + tid; r < m; r += kThreads) a = nan_max(a, T(fabs(pj[r])));
    a = block_reduce<T, true>(a, red);
    const T s = a > T(0) ? a : T(1);
    T q = T(0);
    for (int r = d + tid; r < m; r += kThreads) {
      const T xs = pj[r] / s;
      q += xs * xs;
    }
    q = block_reduce<T, false>(q, red);
    const T norm = sqrt(q) * s;

    // 2. sign / u / tau / beta with the zero-column guard
    const T sign = x0 < T(0) ? T(-1) : T(1);
    const T u = x0 + sign * norm;
    const bool degen = norm <= T(0);
    const T safe_u = degen ? T(1) : u;
    const T tj = degen ? T(0) : sign * u / norm;
    const T beta = degen ? x0 : -sign * norm;

    // 3. packed write-back of column j: beta at d, v's tail below
    for (int r = d + tid; r < m; r += kThreads)
      pj[r] = (r == d) ? beta : (degen ? T(0) : pj[r] / safe_u);

    // 4. dots[i] = P_i . v over rows >= d, for every panel column i
    //    (i < j: V^T v for T; i > j: A^T v for the update)
    for (int c0 = 0; c0 < w; c0 += kChunk) {
      T acc[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) acc[i] = T(0);
      for (int r = d + tid; r < m; r += kThreads) {
        const T v = (r == d) ? T(1) : pj[r];
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if (c0 + i < w) acc[i] += P[static_cast<size_t>(c0 + i) * m + r] * v;
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        for (int o = 16; o > 0; o >>= 1)
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) part[warp][i] = acc[i];
      }
      __syncthreads();
      if (tid < kChunk && c0 + tid < w) {
        T t = T(0);
        for (int p = 0; p < kWarps; ++p) t += part[p][tid];
        dots[c0 + tid] = t;
      }
      __syncthreads();
    }

    // 5. T column j: T[:j, j] = -tau_j T[:j, :j] dots[:j], T[j][j] = tau_j
    for (int i = tid; i < j; i += kThreads) {
      T t = T(0);
      for (int k = i; k < j; ++k) t += Tm[i * w + k] * dots[k];
      Tm[i * w + j] = -tj * t;
    }
    if (tid == 0) {
      Tm[j * w + j] = tj;
      tau[j] = tj;
    }

    // 6. rank-1 update of the later columns: A_c -= (tau_j dots[c]) v
    for (int r = d + tid; r < m; r += kThreads) {
      const T v = (r == d) ? T(1) : pj[r];
      for (int c = j + 1; c < w; ++c)
        P[static_cast<size_t>(c) * m + r] -= (tj * dots[c]) * v;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* PT, void* P, void* tau, void* Tm, int m, int w, int off,
           void* stream) {
  if (w < 1 || w > kMaxW || off < 0 || off + w > m)
    return static_cast<int>(cudaErrorInvalidValue);
  geqrt_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(PT), static_cast<T*>(P), static_cast<T*>(tau),
      static_cast<T*>(Tm), m, w, off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cqt_geqrt_f32(const void* PT, void* P, void* tau, void* Tm,
                             int m, int w, int off, void* stream) {
  return launch<float>(PT, P, tau, Tm, m, w, off, stream);
}

extern "C" int cqt_geqrt_f64(const void* PT, void* P, void* tau, void* Tm,
                             int m, int w, int off, void* stream) {
  return launch<double>(PT, P, tau, Tm, m, w, off, stream);
}
