// Newton-Schulz inverse of the basis-kernel panel's M and its a-posteriori
// certificate, in one launch.
//
// Stands beside cuda_qr_tpu/ops/smalllinalg.py:newton_inverse, which is jnp
// code (a lax.while_loop of two nb x nb products an iteration) and not a
// Pallas kernel, and beside the certificate that
// cuda_qr_tpu/ops/fast_panel.py computes after it.  The reference decides
// the loop on the device.  Eager PyTorch decided it on the host: one host
// sync an iteration and ~9 launches an iteration, about 92 launches and 9.5
// syncs a panel, half the launches of an 8192^2 qr.  This kernel runs the
// whole loop and the certificate, so the host launches once a panel and
// decides nothing before the certificate.
//
// It computes what smalllinalg.newton_certified computes, every product in
// float32 FFMA (the configuration's "highest"; no TF32):
//   E = I - M;  X0 = I + E if sqrt(||E||_1 ||E||_inf) < 1/2,
//               else M^T / max(||M||_1 ||M||_inf, FLT_MIN);
//   err = inf, k = 0;  while err > tol and k < max_iters:
//               P = M X;  err = max|I - P|;  X = X (2I - P);  k += 1;
//   N = X;  cert = max|N|^2 max|I - M N|.
// A NaN err ends the loop, as bool(NaN > tol) is False there; err belongs
// to the iterate before the returned one.  Sums and dot products run in
// another order than torch's reductions and cuBLAS's, so N agrees with the
// plain chain to rounding, not bit for bit.
//
// What bounds it on an H100: the chain, not operations or bytes.  An
// iteration is 4 nb^3 FLOPs (8.4 MFLOP at nb = 128: 0.13 us at the card's
// FP32 peak) on a 64 KB matrix, but every iteration needs all of the
// previous iterate, and the loop goes on or ends on a max over all of it.
// One CTA at FFMA peak would take ~18 us an iteration; the design spreads
// an iteration over a thread block cluster so that each link of the chain
// is short.
//
// The design: a cluster of 8 CTAs (the portable size) of 256 threads on
// neighbouring SMs; rank r owns the 16 columns [16 r, 16 r + 16) of X, P and
// W = 2I - P (at nb < 128 the ranks past nb/16 own none and only meet the
// cluster's two barriers).  A column block needs no other:
//   P[:, c] = M X[:, c],  X'[:, c] = X (2I - P[:, c]),
// so of the two products only the second needs another CTA's data, all of
// X.  Every CTA holds all of M and two buffers of all of X in shared memory
// (row stride nb + 4, so that the 8 rows a warp reads at one k fall on
// distinct bank quads; 206 KiB at nb = 128).  X0 is computed whole in every
// CTA from all of M (the same norms, in the same order, so the same start).
// An iteration:
//   (a) P = M X[:, c], from this CTA's own columns: a thread computes 2 rows
//       x 4 columns, FFMA in k order; its part of max|I - P|, and W's
//       columns into shared memory; the CTA's max goes with st.async into
//       its slot in every CTA, counted by the receiver's mbarrier;
//   (b) once the other CTAs' columns of X have landed (mbarrier), X'[:, c]
//       = X W[:, c]; the slots land meanwhile, and every CTA reduces them
//       alike: the same err and the same decision everywhere, with no
//       cluster barrier and no host;
//   (c) X'[:, c] goes into this CTA's other buffer and, unless the loop
//       ends, with st.async into every other CTA's.
// So an iteration has one exchange of X and one of 8 slots, and the
// exchange of X is hidden behind the next iteration's first product.  The
// certificate is one more (a), on N's own columns, whose slots carry max|N|
// too.  Slots, their mbarriers and the mbarriers of X are doubled by the
// iteration's parity: a CTA pushes iteration k + 1's slot or X only after it
// received every CTA's slot of iteration k, which each CTA pushed after it
// had read, and waited for, what the push of k + 1 overwrites or counts on.
//
// The sides are the multiples of 16 from 16 to 128; the entry point rejects
// any other.  The shared-memory limit and the check that the card can place
// a cluster (cudaOccupancyMaxActiveClusters) are done once per side and
// device; a cluster that cannot be placed is an error, never a fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cfloat>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;           // CTAs in the cluster
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;             // columns an active CTA owns
constexpr int kTR = 2;                // rows a thread computes, nb/2 apart
constexpr int kNbStep = kCols;
constexpr int kMaxNb = kCols * kCluster;
constexpr int kMaxDevices = 64;

template <int NB>
struct Shape {
  static constexpr int A = NB / kCols;           // active CTAs: ranks [0, A)
  static constexpr int RG = NB / kTR;            // row groups: a thread's rows are rg + i RG
  static constexpr int NT = 4 * RG;              // threads that compute: 4 groups of 4 columns
  static constexpr int LD = NB + 4;              // row stride of M and X in shared memory
  static constexpr size_t kSmem = sizeof(float) * (3 * NB * LD + NB * kCols);   // M, X x 2, W
  static constexpr uint32_t kGather = 4u * NB * kCols * (A - 1);  // the other CTAs' columns
  static constexpr uint32_t kSlots = 16u * A;
  static_assert(NB % kNbStep == 0 && NB >= kNbStep && NB <= kMaxNb && NT <= kThreads,
                "side out of range");
};

// max that keeps a NaN from either side, as torch's max does.
__device__ __forceinline__ float nanmax(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float warp_nanmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float& at(float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same shared-memory address in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes into a CTA's shared memory; its mbarrier bar counts them when
// they land (no fence, no cluster barrier).
__device__ __forceinline__ void push16(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
         "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar) : "memory");
}

__device__ __forceinline__ void arrive_expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of the given parity of bar has completed.  The loop
// is in C++, so the asm has no label to repeat where it is inlined.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// c[i] = sum_k A[row[i]][k] B[k][0..3], k in order, one FFMA a term; A has
// the row stride of M and X, B (already at the thread's 4 columns) LDB.
template <int NB, int LDB>
__device__ __forceinline__ void product(const float* A, const float* B, const int (&row)[kTR],
                                        float4 (&c)[kTR]) {
  constexpr int LD = Shape<NB>::LD;
#pragma unroll
  for (int i = 0; i < kTR; ++i) c[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int k0 = 0; k0 < NB; k0 += 4) {
    float4 a[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i) a[i] = *reinterpret_cast<const float4*>(A + row[i] * LD + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(B + (k0 + kk) * LDB);
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const float av = at(a[i], kk);
        c[i].x = fmaf(av, b.x, c[i].x);
        c[i].y = fmaf(av, b.y, c[i].y);
        c[i].z = fmaf(av, b.z, c[i].z);
        c[i].w = fmaf(av, b.w, c[i].w);
      }
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
newton_cluster_kernel(const float* __restrict__ Mg, float* __restrict__ Ng,
                      float* __restrict__ err_out, float* __restrict__ cert_out,
                      int* __restrict__ iters_out, float tol, int max_iters) {
  using S = Shape<NB>;
  constexpr int LD = S::LD;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  if (rank >= S::A) {   // owns no column: nobody addresses it
    cluster.sync();
    cluster.sync();
    return;
  }

  extern __shared__ float4 smem4[];
  float* Ms = reinterpret_cast<float*>(smem4);   // NB x LD: M
  float* Xb = Ms + NB * LD;                      // 2 x NB x LD: X, by the iteration's parity
  float* Ws = Xb + 2 * NB * LD;                  // NB x kCols: this CTA's columns of 2I - P
  // slots[s][k]: rank k's (max|I - P|, max|N|, -, -) of a pass of parity s
  __shared__ float4 slots[2][kCluster];
  // xbar[s]: the other CTAs' columns of an X of parity s landed; sbar[s]: the slots
  __shared__ __align__(8) unsigned long long xbar[2], sbar[2];
  __shared__ float red[4][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool active = tid < S::NT;
  const int col = rank * kCols + 4 * (tid & 3);   // the thread's first column
  int row[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) row[i] = (tid >> 2) + i * S::RG;

  for (int e = tid; e < NB * NB; e += kThreads) Ms[(e / NB) * LD + e % NB] = Mg[e];
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&xbar[b])));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&sbar[b])));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // ---- the start: ||M||_1, ||M||_inf, ||E||_1, ||E||_inf, the same in every CTA ----
  float nrm[4] = {0.f, 0.f, 0.f, 0.f};   // column and row sums of |M|, then of |E|
  if (tid < NB) {
    float part[4][4] = {};                // four partial sums each, for the latency
    for (int i = 0; i < NB; i += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float m = Ms[(i + q) * LD + tid];
        part[0][q] += fabsf(m);
        part[2][q] += fabsf((i + q == tid ? 1.f : 0.f) - m);
        // row tid from column tid on, so that a warp's lanes read distinct banks
        int k = tid + i + q;
        k = k < NB ? k : k - NB;
        const float mr = Ms[tid * LD + k];
        part[1][q] += fabsf(mr);
        part[3][q] += fabsf((k == tid ? 1.f : 0.f) - mr);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) nrm[j] = (part[j][0] + part[j][1]) + (part[j][2] + part[j][3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = warp_nanmax(nrm[j]);
    if (lane == 0) red[j][warp] = v;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    nrm[j] = red[j][0];
    for (int w = 1; w < kWarps; ++w) nrm[j] = nanmax(nrm[j], red[j][w]);
  }
  const float ab = nrm[0] * nrm[1];
  const float denom = ab < FLT_MIN ? FLT_MIN : ab;   // clamp(min=tiny): a NaN stays NaN
  const bool near = sqrtf(nrm[2] * nrm[3]) < 0.5f;
  for (int e = tid; e < NB * NB; e += kThreads) {
    const int r = e / NB, c = e % NB;
    const float d = r == c ? 1.f : 0.f;
    Xb[r * LD + c] = near ? d + (d - Ms[r * LD + c]) : Ms[c * LD + r] / denom;
  }
  __syncthreads();
  // Every CTA of the cluster runs, its barriers initialised, before any
  // distributed-shared-memory access.
  cluster.sync();

  uint32_t xpar = 0u, spar = 0u;   // bit s: the parity of the next phase of xbar[s], sbar[s]
  float err = __int_as_float(0x7f800000);   // +inf
  float cert = 0.f;
  int it = 0;
  int cur = 0;                              // X of iteration it is in Xb[cur]
  bool done = !(err > tol) || it >= max_iters;   // done: this pass is the certificate's
  for (;;) {
    const float* Xc = Xb + cur * NB * LD;
    const int s = it & 1;
    const uint32_t sb = smem_addr(&sbar[s]);
    // ---- (a) P = M X[:, c]; max|I - P| (and max|N|); W's columns ----
    float e_loc = 0.f, n_loc = 0.f;
    if (active) {
      float4 p[kTR];
      product<NB, LD>(Ms, Xc + col, row, p);
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = row[i], c = col + q;
          const float pv = at(p[i], q);
          e_loc = nanmax(e_loc, fabsf((r == c ? 1.f : 0.f) - pv));
          if (done) n_loc = nanmax(n_loc, fabsf(Xc[r * LD + c]));
          else at(p[i], q) = (r == c ? 2.f : 0.f) - pv;
        }
        if (!done) *reinterpret_cast<float4*>(Ws + row[i] * kCols + (col & (kCols - 1))) = p[i];
      }
    }
    e_loc = warp_nanmax(e_loc);
    n_loc = warp_nanmax(n_loc);
    if (lane == 0) {
      red[0][warp] = e_loc;
      red[1][warp] = n_loc;
    }
    if (tid == 0) arrive_expect_bytes(sb, S::kSlots);
    __syncthreads();   // W and the warps' maxima are written
    if (warp == 0 && lane < S::A) {
      float e = red[0][0], n = red[1][0];
      for (int w = 1; w < kWarps; ++w) {
        e = nanmax(e, red[0][w]);
        n = nanmax(n, red[1][w]);
      }
      push16(at_rank(smem_addr(&slots[s][rank]), lane), make_float4(e, n, 0.f, 0.f),
             at_rank(sb, lane));
    }
    if (done) {
      wait_phase(sb, (spar >> s) & 1u);
      float e_all = slots[s][0].x, n_all = slots[s][0].y;
      for (int k = 1; k < S::A; ++k) {
        e_all = nanmax(e_all, slots[s][k].x);
        n_all = nanmax(n_all, slots[s][k].y);
      }
      cert = n_all * n_all * e_all;
      break;
    }
    // ---- (b) X'[:, c] = X W[:, c], once the other CTAs' columns of X have landed ----
    if (it > 0) {
      wait_phase(smem_addr(&xbar[cur]), (xpar >> cur) & 1u);
      xpar ^= 1u << cur;
    }
    float4 xn[kTR];
    if (active) product<NB, kCols>(Xc, Ws + (col & (kCols - 1)), row, xn);
    wait_phase(sb, (spar >> s) & 1u);
    spar ^= 1u << s;
    float e_all = slots[s][0].x;
    for (int k = 1; k < S::A; ++k) e_all = nanmax(e_all, slots[s][k].x);
    err = e_all;
    ++it;
    done = !(err > tol) || it >= max_iters;
    // ---- (c) X'[:, c] into this CTA's other buffer and, unless the loop ends, every CTA's ----
    const int nxt = cur ^ 1;
    float* Xn = Xb + nxt * NB * LD;
    const uint32_t xb = smem_addr(&xbar[nxt]);
    if (tid == 0 && !done) arrive_expect_bytes(xb, S::kGather);
    if (active) {
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        float* dst = Xn + row[i] * LD + col;
        *reinterpret_cast<float4*>(dst) = xn[i];
        if (!done)
          for (int k = 0; k < S::A; ++k)
            if (k != rank) push16(at_rank(smem_addr(dst), k), xn[i], at_rank(xb, k));
      }
    }
    __syncthreads();   // this CTA's columns of X' are written, W is read
    cur = nxt;
  }

  const float* Xc = Xb + cur * NB * LD;
  for (int e = tid; e < NB * kCols; e += kThreads) {
    const int r = e / kCols, c = rank * kCols + e % kCols;
    Ng[r * NB + c] = Xc[r * LD + c];
  }
  if (rank == 0 && tid == 0) {
    *err_out = err;
    *cert_out = cert;
    *iters_out = it;
  }
  // No CTA exits while another may still address its shared memory.
  cluster.sync();
}

cudaLaunchConfig_t cluster_config(size_t bytes, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once per side and device: raise the kernel's shared-memory limit and check
// that the card can place one cluster of it.  Only success is kept, so a
// failure raises on every call.
template <int NB>
cudaError_t prepare(int dev) {
  static std::atomic<bool> ready[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  auto kernel = newton_cluster_kernel<NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Shape<NB>::kSmem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(Shape<NB>::kSmem, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  ready[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

template <int NB>
int launch(const void* M, void* N, void* err_out, void* cert, void* iters, float tol,
           int max_iters, int dev, cudaStream_t stream) {
  cudaError_t err = prepare<NB>(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(Shape<NB>::kSmem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, newton_cluster_kernel<NB>, static_cast<const float*>(M),
                           static_cast<float*>(N), static_cast<float*>(err_out),
                           static_cast<float*>(cert), static_cast<int*>(iters), tol, max_iters);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// M (nb x nb, row-major, float32) in; N (nb x nb), err, cert (float32) and
// iters (int32) out, all on the device.
extern "C" int cqt_newton_inv_f32(const void* M, void* N, void* err, void* cert, void* iters,
                                  int nb, float tol, int max_iters, void* stream) {
  if (nb < kNbStep || nb > kMaxNb || nb % kNbStep != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nb / kNbStep) {
    case 1: return launch<16>(M, N, err, cert, iters, tol, max_iters, dev, st);
    case 2: return launch<32>(M, N, err, cert, iters, tol, max_iters, dev, st);
    case 3: return launch<48>(M, N, err, cert, iters, tol, max_iters, dev, st);
    case 4: return launch<64>(M, N, err, cert, iters, tol, max_iters, dev, st);
    case 5: return launch<80>(M, N, err, cert, iters, tol, max_iters, dev, st);
    case 6: return launch<96>(M, N, err, cert, iters, tol, max_iters, dev, st);
    case 7: return launch<112>(M, N, err, cert, iters, tol, max_iters, dev, st);
    default: return launch<128>(M, N, err, cert, iters, tol, max_iters, dev, st);
  }
}
