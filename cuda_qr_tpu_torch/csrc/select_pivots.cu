// Greedy pivot selection of randomized QRCP on one sketch tile.
//
// Replaces the TPU kernel cuda_qr_tpu/ops/pallas_select.py:_select_kernel
// (called through select_pivots_pallas).  Given the l x cand sketch tile S
// (row-major) and the cand squared column norms (-1 = ineligible), it picks
// nb pivot columns by greedy Gram-Schmidt and writes ord[c] = the step at
// which column c was picked, or -1.  Each step i:
//   p       = the lowest index whose norm equals the maximum;
//   q       = S[:, p], nq2 = ||q||^2 recomputed, inv = nq2 > 0 ? 1/nq2 : 0;
//   proj    = q^T S, accumulated in float;
//   S      -= q (proj * inv);
//   norms   = max(norms - proj^2 inv, 0), then -1 at p and wherever a norm
//             was already negative;
//   ord[p]  = i.
// A NaN norm makes the maximum NaN, which no column equals, so the TPU
// kernel picks nothing at that step and at every later one (the NaN never
// leaves the norms); this kernel stops there, with the same ord.
//
// What bounds it on an H100: a chain of nb dependent steps, each one pass
// over the whole tile (two reads and one write of l x cand floats, 320 KB at
// the default l = 160, cand = 512), and the pass cannot start before the
// previous step's argmax is known.  The tile is larger than one SM's shared
// memory (227 KB) and register file, and the TPU kernel's design (the whole
// tile resident, the steps unrolled) does not carry over.
//
// Design: one CTA of 512 threads, one thread per column (looping when
// cand > 512), so every pass reads row-major S coalesced.  As many leading
// rows of the tile as fit stay in dynamic shared memory; the rest live in
// the scratch copy Sw in device memory, which stays L2-resident (the gate
// caps the tile at 4 MiB).  q is staged in shared memory each step; the
// argmax is a block reduction carrying (value, index) so ties go to the
// lowest index.  The caller's S is read once and never written.  A
// thread-block cluster holding the tile in distributed shared memory is the
// Hopper-native redesign (PERF.md, open questions).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kReserve = 1024;   // static shared memory of the kernel, rounded up

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

__device__ __forceinline__ bool wins(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// proj contribution of rows [r0, r1) of column c; base is row-major, width cand.
__device__ __forceinline__ float dot_rows(const float* __restrict__ q,
                                          const float* base, int r0, int r1,
                                          int cand, int c) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int r = r0;
  for (; r + 4 <= r1; r += 4) {
    a0 = fmaf(q[r], base[r * cand + c], a0);
    a1 = fmaf(q[r + 1], base[(r + 1) * cand + c], a1);
    a2 = fmaf(q[r + 2], base[(r + 2) * cand + c], a2);
    a3 = fmaf(q[r + 3], base[(r + 3) * cand + c], a3);
  }
  for (; r < r1; ++r) a0 = fmaf(q[r], base[r * cand + c], a0);
  return (a0 + a1) + (a2 + a3);
}

__device__ __forceinline__ void update_rows(const float* __restrict__ q,
                                            float* base, int r0, int r1,
                                            int cand, int c, float coef) {
#pragma unroll 4
  for (int r = r0; r < r1; ++r) base[r * cand + c] -= q[r] * coef;
}

__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ S, const float* __restrict__ norms,
              float* __restrict__ Sw, float* __restrict__ nw,
              int* __restrict__ ord, int l, int cand, int nb, int ls) {
  extern __shared__ float smem[];
  float* q = smem;            // l: the picked column
  float* Ssh = smem + l;      // ls x cand: the tile's leading rows
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int red_nan[kWarps];
  __shared__ float red_s[kWarps];
  __shared__ int s_p;
  __shared__ float s_nq2;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = ls * cand;
  const int total = l * cand;

  for (int e = tid; e < split; e += kThreads) Ssh[e] = S[e];
  for (int e = split + tid; e < total; e += kThreads) Sw[e] = S[e];
  for (int c = tid; c < cand; c += kThreads) {
    nw[c] = norms[c];
    ord[c] = -1;
  }
  __syncthreads();

  for (int i = 0; i < nb; ++i) {
    // ---- p: first argmax of the norms; any NaN -> no pick ----
    float bv = neg_inf();
    int bi = INT_MAX;
    int nan = 0;
    for (int c = tid; c < cand; c += kThreads) {
      const float x = nw[c];
      if (x != x) nan = 1;
      else if (wins(x, c, bv, bi)) { bv = x; bi = c; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (wins(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    nan = __any_sync(0xffffffffu, nan);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
      red_nan[warp] = nan;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : neg_inf();
      bi = lane < kWarps ? red_i[lane] : INT_MAX;
      nan = lane < kWarps ? red_nan[lane] : 0;
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (wins(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      nan = __any_sync(0xffffffffu, nan);
      if (lane == 0) s_p = (nan || bi >= cand) ? -1 : bi;
    }
    __syncthreads();
    const int p = s_p;
    if (p < 0) break;   // uniform: every thread read the same s_p

    // ---- q = S[:, p] into shared memory, nq2 = ||q||^2 ----
    float part = 0.f;
    for (int r = tid; r < l; r += kThreads) {
      const float v = r < ls ? Ssh[r * cand + p] : Sw[r * cand + p];
      q[r] = v;
      part = fmaf(v, v, part);
    }
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) red_s[warp] = part;
    __syncthreads();
    if (warp == 0) {
      part = lane < kWarps ? red_s[lane] : 0.f;
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) s_nq2 = part;
    }
    __syncthreads();
    const float nq2 = s_nq2;
    const float inv = nq2 > 0.f ? 1.f / nq2 : 0.f;

    // ---- per column: proj, rank-1 update, norm downdate ----
    for (int c = tid; c < cand; c += kThreads) {
      const float proj = dot_rows(q, Ssh, 0, ls, cand, c) + dot_rows(q, Sw, ls, l, cand, c);
      const float coef = proj * inv;
      update_rows(q, Ssh, 0, ls, cand, c, coef);
      update_rows(q, Sw, ls, l, cand, c, coef);
      const float x = nw[c];
      float nn = x - proj * proj * inv;
      nn = nn < 0.f ? 0.f : nn;   // max(., 0) that keeps a NaN, as jnp.maximum
      nw[c] = (c == p || x < 0.f) ? -1.f : nn;
      if (c == p) ord[c] = i;
    }
    __syncthreads();   // column p of the next step is read by every thread
  }
}

}  // namespace

extern "C" int cqt_select_pivots_f32(const void* S, const void* norms, void* Sw,
                                     void* nw, void* ord, int l, int cand, int nb,
                                     void* stream) {
  if (l < 1 || cand < 1 || nb < 0 || static_cast<long long>(l) * cand > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t qbytes = static_cast<size_t>(l) * sizeof(float);
  if (qbytes + kReserve > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t avail = static_cast<size_t>(optin) - kReserve - qbytes;
  const size_t rows = avail / (static_cast<size_t>(cand) * sizeof(float));
  const int ls = rows < static_cast<size_t>(l) ? static_cast<int>(rows) : l;
  const size_t bytes = qbytes + static_cast<size_t>(ls) * cand * sizeof(float);
  err = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<const float*>(norms),
      static_cast<float*>(Sw), static_cast<float*>(nw), static_cast<int*>(ord),
      l, cand, nb, ls);
  return static_cast<int>(cudaGetLastError());
}
