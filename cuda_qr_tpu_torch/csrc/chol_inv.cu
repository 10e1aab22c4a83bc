// Fused Cholesky factor + inverse of small SPD matrices, one CTA per matrix.
//
// Replaces the TPU kernel cuda_qr_tpu/ops/pallas_chol.py:_chol_inv_kernel
// (called through chol_with_inv_pallas).  For each nb x nb SPD G of a batch
// it writes L (lower, G = L L^T, zeros above the diagonal) and L^{-1}.
//
// What bounds it on an H100: the length of the dependent chain.  nb = 128 is
// ~0.7 MFLOP and 64 KB of input, so neither the 67 TFLOP/s of the FP32 units
// nor the 3.35 TB/s of HBM matters; what costs is nb column steps, each a
// block-wide barrier, followed by forward substitutions nb steps long.
//
// Design:
//   * one CTA per matrix (batch in gridDim.x), 256 or 512 threads;
//   * the working copy S lives in dynamic shared memory where it fits
//     (nb = 128 float is 64 KB) and the inverse's workspace too where both
//     fit; otherwise they live in the output buffers in global memory, which
//     stay L2-resident (512^2 float is 1 MB);
//   * Cholesky is right-looking by columns: scale column j by 1/sqrt(pivot)
//     into a small shared vector, barrier, rank-1 update of the trailing
//     lower triangle, barrier.  The scaled column sits in its own vector so
//     the update reads it without shared-memory bank conflicts;
//   * L^{-1} by forward substitution, one thread per right-hand-side column
//     c; at step q every thread works on row c + q, so the inner trip count
//     is uniform across a warp and the shared-memory strides (nb + 1) are
//     conflict-free;
//   * a non-PD pivot gives sqrt(negative) = NaN (or 1/0 = Inf) and the
//     NaN/Inf propagates, as in the reference: callers branch on finiteness.
// L is written directly; the reference's transposed-L output was a TPU
// lane-layout device.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void chol_inv_kernel(const T* __restrict__ G, T* __restrict__ L,
                                T* __restrict__ Li, int nb, int mode) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const size_t mat = static_cast<size_t>(nb) * nb;
  const size_t b = blockIdx.x;
  G += b * mat;
  L += b * mat;
  Li += b * mat;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // mode 2: S and X in shared memory; 1: S only; 0: both in the outputs.
  T* col = smem;                                   // nb scaled column
  T* S = mode >= 1 ? smem + nb : L;                // working matrix
  T* X = mode == 2 ? smem + nb + mat : Li;         // L^{-1} workspace

  for (size_t e = tid; e < mat; e += nthreads) S[e] = G[e];
  __syncthreads();

  // ---- Cholesky, right-looking by columns ----
  for (int j = 0; j < nb; ++j) {
    const T ljj = sqrt(S[static_cast<size_t>(j) * nb + j]);
    for (int i = j + tid; i < nb; i += nthreads) {
      if (i == j) {
        col[j] = ljj;                              // S[j][j] is written below
      } else {
        const T v = S[static_cast<size_t>(i) * nb + j] / ljj;
        col[i] = v;
        S[static_cast<size_t>(i) * nb + j] = v;
      }
    }
    __syncthreads();
    if (tid == 0) S[static_cast<size_t>(j) * nb + j] = col[j];
    const int w = nb - j - 1;
    const int cnt = w * w;
    for (int idx = tid; idx < cnt; idx += nthreads) {
      const int i = j + 1 + idx / w;
      const int k = j + 1 + idx % w;
      if (k <= i) S[static_cast<size_t>(i) * nb + k] -= col[i] * col[k];
    }
    __syncthreads();
  }

  // ---- L^{-1}: solve L X = I, one thread per column c of X ----
  for (int c = tid; c < nb; c += nthreads) {
    for (int i = 0; i < c; ++i) X[static_cast<size_t>(i) * nb + c] = T(0);
    for (int i = c; i < nb; ++i) {
      const T* Lrow = S + static_cast<size_t>(i) * nb;
      T s = (i == c) ? T(1) : T(0);
      for (int t = c; t < i; ++t) s -= Lrow[t] * X[static_cast<size_t>(t) * nb + c];
      X[static_cast<size_t>(i) * nb + c] = s / Lrow[i];
    }
  }
  __syncthreads();

  // ---- write back: L with zeros above the diagonal, L^{-1} ----
  // Each thread reads and writes the same element, so S aliasing L (mode 0)
  // needs no barrier here.
  for (size_t e = tid; e < mat; e += nthreads) {
    const int i = static_cast<int>(e / nb);
    const int k = static_cast<int>(e % nb);
    L[e] = k <= i ? S[e] : T(0);
    if (mode == 2) Li[e] = X[e];
  }
}

template <typename T>
int launch(const void* G, void* L, void* Li, int nb, int batch, void* stream) {
  if (nb < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t mat = static_cast<size_t>(nb) * nb;
  const size_t full = (2 * mat + nb) * sizeof(T);
  const size_t half = (mat + nb) * sizeof(T);
  int mode;
  size_t bytes;
  if (full <= static_cast<size_t>(optin)) {
    mode = 2;
    bytes = full;
  } else if (half <= static_cast<size_t>(optin)) {
    mode = 1;
    bytes = half;
  } else {
    mode = 0;
    bytes = nb * sizeof(T);
  }
  cudaFuncSetAttribute(chol_inv_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  const int threads = nb <= 256 ? 256 : 512;
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
