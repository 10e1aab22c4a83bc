// Fused Cholesky factor + inverse of small SPD matrices, one CTA per matrix,
// blocked by 32 columns (one warp wide).
//
// Replaces the TPU kernel cuda_qr_tpu/ops/pallas_chol.py:_chol_inv_kernel
// (called through chol_with_inv_pallas).  For each nb x nb SPD G of a batch
// it writes L (lower, G = L L^T, zeros above the diagonal) and L^{-1}.
//
// What bounds it on an H100: the dependent chain, not FLOPs or bytes.
// nb = 128 float is 1.4 MFLOP and 192 KB in and out: 0.06 us of HBM, far
// below one launch.  A stack of 4096 64 x 64 matrices is 201 MB: 60 us of
// HBM, and there the number of matrices an SM runs at once matters too.
//
// The first design (one column per step) lost its time to nb steps of two
// CTA barriers each, a rank-1 update with an integer divide per element and
// half the threads masked, and an L^{-1} of one thread per column: a serial
// chain of ~nb^2/2 dependent shared-memory FMAs on thread 0.
//
// This design, right-looking by 32-column blocks as the TPU kernel blocks
// by 16:
//   * the 32 x 32 diagonal block is factored by one warp in registers (lane
//     i holds row i; shuffles, no CTA barrier), with 1 / L[j][j] from rsqrt
//     so that no division sits on the chain;
//   * the panel below it by forward substitution against L_kk, one thread
//     per row, the row in registers and L_kk read as shared-memory
//     broadcasts;
//   * the trailing update of the lower blocks is an FP32 FFMA product (not
//     TF32: L^{-1}'s error scales with cond(G)), each warp a 32 x 8 slab
//     with the lane's row of the panel in registers;
//   * L^{-1}: the diagonal blocks' inverses all at once, a warp each, off
//     the factor's chain; then blocked forward substitution, one block row
//     at a time, all block columns in parallel: W = L_i,j:i X_j:i,j, then
//     X_ij = -X_ii W, with independent partial sums;
//   * three barriers per block step of the factor, two per block row of the
//     inverse: 18 at nb = 128, where the first design took 256 and a chain;
//   * S (the working copy, becomes L) and X (L^{-1}) live in shared memory
//     with a row stride of nb + 1 (column reads conflict-free) where they
//     fit (float: nb <= 160), else in the output buffers, L2-resident, with
//     the same algorithm;
//   * 128 threads per CTA for nb <= 64 so that an SM runs several of a
//     stack's matrices at once, 256 above;
//   * a non-PD pivot gives rsqrt(negative) = NaN (or 0 * Inf = NaN) and it
//     propagates, as in the reference: callers branch on finiteness.
// L is written directly; the reference's transposed-L output was a TPU
// lane-layout device.

#include <cuda_runtime.h>

namespace {

constexpr int kB = 32;          // block width: one warp
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// Factor the diagonal block at (k0, k0), bw <= 32 columns wide, by one
// warp in registers (lane i holds row i).  Writes L_kk into S and
// 1 / L[j][j] into rinv_s[k0 + j].
template <typename T>
__device__ void diag_factor(T* S, int lds, T* rinv_s, int k0, int bw) {
  const int lane = threadIdx.x & 31;
  T row[kB];
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    if (lane < bw && k <= lane)
      row[k] = S[(k0 + lane) * lds + k0 + k];
    else
      row[k] = k == lane ? T(1) : T(0);   // identity rows pad a narrow block
  }
  // 1 / L[j][j], the same in every lane: no division on the chain.  A
  // pivot <= 0 gives NaN (rsqrt of a negative, or 0 * Inf), which spreads.
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const T piv = __shfl_sync(0xffffffffu, row[j], j);
    const T rinv = rsqrt_t(piv);
    const T lij = lane == j ? piv * rinv : (lane > j ? row[j] * rinv : T(0));
    row[j] = lij;
    if (lane == j && j < bw) rinv_s[k0 + j] = rinv;
#pragma unroll
    for (int k = j + 1; k < kB; ++k) {
      const T lkj = __shfl_sync(0xffffffffu, lij, k);
      if (lane >= k) row[k] -= lij * lkj;
    }
  }
  if (lane < bw) {
#pragma unroll
    for (int k = 0; k < kB; ++k)
      if (k <= lane) S[(k0 + lane) * lds + k0 + k] = row[k];
  }
}

// inv(L_kk) of a factored diagonal block into X, by one warp: lane j builds
// column j, x[i] = (delta_ij - sum_{t<i} L[i][t] x[t]) / L[i][i].
template <typename T>
__device__ void diag_inverse(const T* S, int lds, T* X, int ldx, const T* rinv_s,
                             int k0, int bw) {
  const int lane = threadIdx.x & 31;
  T row[kB];
#pragma unroll
  for (int k = 0; k < kB; ++k)
    row[k] = lane < bw && k <= lane ? S[(k0 + lane) * lds + k0 + k] : T(0);
  T x[kB];
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    T s = lane == i ? T(1) : T(0);
#pragma unroll
    for (int t = 0; t < i; ++t) s -= __shfl_sync(0xffffffffu, row[t], i) * x[t];
    x[i] = i < bw ? s * rinv_s[k0 + i] : T(0);
  }
  if (lane < bw) {
#pragma unroll
    for (int i = 0; i < kB; ++i)
      if (i < bw) X[(k0 + i) * ldx + k0 + lane] = x[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
chol_inv_kernel(const T* __restrict__ G, T* __restrict__ L, T* __restrict__ Li,
                int nb, int mode) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const size_t mat = static_cast<size_t>(nb) * nb;
  const size_t b = blockIdx.x;
  G += b * mat;
  L += b * mat;
  Li += b * mat;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  // mode 2: S and X in shared memory; 1: S only; 0: both in the outputs.
  // The scratch (1 / L[j][j] of the factor, then W of the inverse) always is.
  const size_t padded = static_cast<size_t>(nb) * (nb + 1);
  T* scratch = smem;
  T* S = mode >= 1 ? smem + static_cast<size_t>(kB) * nb : L;
  T* X = mode == 2 ? S + padded : Li;
  const int lds = mode >= 1 ? nb + 1 : nb;
  const int ldx = mode == 2 ? nb + 1 : nb;
  T* rinv_s = scratch;                            // nb
  T* W = scratch;                                 // 32 x nb, stride nb

  for (int e = tid; e < nb * nb; e += nthreads) {
    const int i = e / nb;
    S[i * lds + e - i * nb] = G[e];
  }
  __syncthreads();

  const int nblk = (nb + kB - 1) / kB;
  // ---- Cholesky, right-looking by 32-column blocks ----
  for (int kb = 0; kb < nblk; ++kb) {
    const int k0 = kb * kB;
    const int bw = nb - k0 < kB ? nb - k0 : kB;
    if (warp == 0) diag_factor(S, lds, rinv_s, k0, bw);
    __syncthreads();
    if (kb == nblk - 1) break;
    // panel by forward substitution, a thread per row (row in registers):
    // L[i][k0 + j] = (S[i][k0 + j] - sum_{t<j} L[i][k0 + t] L_kk[j][t]) / L_kk[j][j]
    for (int i = k0 + kB + tid; i < nb; i += nthreads) {
      T* Si = S + i * lds + k0;
      T x[kB];
#pragma unroll
      for (int j = 0; j < kB; ++j) x[j] = Si[j];
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const T* Lj = S + (k0 + j) * lds + k0;
        T s0 = x[j], s1 = T(0);
#pragma unroll
        for (int t = 0; t < j; t += 2) {
          s0 -= x[t] * Lj[t];
          if (t + 1 < j) s1 -= x[t + 1] * Lj[t + 1];
        }
        x[j] = (s0 + s1) * rinv_s[k0 + j];
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) Si[j] = x[j];
    }
    __syncthreads();
    // trailing lower blocks: S[i][c] -= L[i][k0:k0+32] . L[c][k0:k0+32]
    const int nt = nblk - kb - 1;
    const int units = nt * (nt + 1) / 2 * 4;    // 32 x 8 slabs
    for (int u = warp; u < units; u += nwarps) {
      int blk = u >> 2, bi = 0;
      while (blk > bi) blk -= ++bi;             // blk -> (bi, bc = blk)
      const int c = k0 + kB * (1 + blk) + lane;
      const int i0 = k0 + kB * (1 + bi) + (u & 3) * 8;
      if (c >= nb) continue;
      T lrow[kB];
#pragma unroll
      for (int t = 0; t < kB; ++t) lrow[t] = S[static_cast<size_t>(c) * lds + k0 + t];
      for (int r = 0; r < 8 && i0 + r < nb; ++r) {
        const T* Si = S + static_cast<size_t>(i0 + r) * lds + k0;
        T acc = T(0);
#pragma unroll
        for (int t = 0; t < kB; ++t) acc += Si[t] * lrow[t];
        S[static_cast<size_t>(i0 + r) * lds + c] -= acc;
      }
    }
    __syncthreads();
  }

  // ---- L^{-1}: the diagonal blocks' inverses, a warp each, then by block
  // rows X_ij = -X_ii sum_{k=j}^{i-1} L_ik X_kj ----
  for (int kb = warp; kb < nblk; kb += nwarps)
    diag_inverse(S, lds, X, ldx, rinv_s, kb * kB, nb - kb * kB < kB ? nb - kb * kB : kB);
  __syncthreads();
  for (int ib = 1; ib < nblk; ++ib) {
    const int i0 = ib * kB;
    const int cols = i0;                        // block columns 0 .. ib-1
    for (int e = tid; e < kB * cols; e += nthreads) {
      const int r = e / cols, c = e % cols;
      if (i0 + r >= nb) break;                  // e grows with r
      const T* Sr = S + (i0 + r) * lds;
      const T* Xc = X + c;
      T w0 = T(0), w1 = T(0), w2 = T(0), w3 = T(0);
      for (int k = (c / kB) * kB; k < i0; k += 4) {   // i0 - k is a multiple of 32
        w0 += Sr[k] * Xc[k * ldx];
        w1 += Sr[k + 1] * Xc[(k + 1) * ldx];
        w2 += Sr[k + 2] * Xc[(k + 2) * ldx];
        w3 += Sr[k + 3] * Xc[(k + 3) * ldx];
      }
      W[r * nb + c] = (w0 + w1) + (w2 + w3);
    }
    __syncthreads();
    for (int e = tid; e < kB * cols; e += nthreads) {
      const int r = e / cols, c = e % cols;
      if (i0 + r >= nb) break;
      const T* Xr = X + (i0 + r) * ldx + i0;
      T v0 = T(0), v1 = T(0);
      int t = 0;
      for (; t + 1 <= r; t += 2) {
        v0 += Xr[t] * W[t * nb + c];
        v1 += Xr[t + 1] * W[(t + 1) * nb + c];
      }
      if (t == r) v0 += Xr[t] * W[t * nb + c];
      X[(i0 + r) * ldx + c] = -(v0 + v1);
    }
    __syncthreads();
  }

  // ---- write back: L and L^{-1} with zeros above the diagonal ----
  // Each thread reads and writes the same element, so S aliasing L (mode 0)
  // or X aliasing Li (modes 0, 1) needs no barrier here.
  for (int e = tid; e < nb * nb; e += nthreads) {
    const int i = e / nb;
    const int k = e - i * nb;
    const bool lower = k <= i;
    L[e] = lower ? S[i * lds + k] : T(0);
    Li[e] = lower ? X[i * ldx + k] : T(0);
  }
}

// Shared-memory plan: bytes for mode 2, 1 and 0 (scratch only).
template <typename T>
void plan(int nb, int optin, int* mode, size_t* bytes) {
  const size_t scratch = static_cast<size_t>(kB) * nb * sizeof(T);
  const size_t padded = static_cast<size_t>(nb) * (nb + 1) * sizeof(T);
  if (scratch + 2 * padded <= static_cast<size_t>(optin)) {
    *mode = 2;
    *bytes = scratch + 2 * padded;
  } else if (scratch + padded <= static_cast<size_t>(optin)) {
    *mode = 1;
    *bytes = scratch + padded;
  } else {
    *mode = 0;
    *bytes = scratch;
  }
}

template <typename T>
int launch(const void* G, void* L, void* Li, int nb, int batch, void* stream) {
  if (nb < 1 || nb > 512 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int mode;
  size_t bytes;
  plan<T>(nb, optin, &mode, &bytes);
  cudaFuncSetAttribute(chol_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  const int threads = nb <= 64 ? 128 : kMaxThreads;
  chol_inv_kernel<T><<<batch, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(G), static_cast<T*>(L), static_cast<T*>(Li), nb, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cqt_chol_inv_f32(const void* G, void* L, void* Li, int nb,
                                int batch, void* stream) {
  return launch<float>(G, L, Li, nb, batch, stream);
}

extern "C" int cqt_chol_inv_f64(const void* G, void* L, void* Li, int nb,
                                int batch, void* stream) {
  return launch<double>(G, L, Li, nb, batch, stream);
}


