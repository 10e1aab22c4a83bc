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
// What bounds it on an H100: neither operations nor bytes (4 l cand nb
// FLOPs and one read of the tile take well under a microsecond), but the
// chain of nb dependent steps: no step can start before the previous one's
// argmax over all cand columns is known.  So the time is nb times the
// latency of one step, and the design shortens that latency.
//
// The tiles: l <= 288 rows and cand <= 1024 columns, a multiple of 64, which
// holds every tile QRCP makes (l = nb + 32, cand = 4 nb, nb <= 256); the
// entry point rejects any other.  A thread block cluster of 8 CTAs (the
// portable size) on neighbouring SMs, 256 threads each.  Rank r owns the
// cand/8 consecutive columns [r w, (r + 1) w) and keeps that column slice in
// its shared memory for the whole chain: column-major, zero-padded to 8 R
// rows, where each column is one group of 8 lanes and a lane holds R = 4,
// 12, 20, 28 or 36 consecutive rows.  R = 4 (mod 8) puts a group's 16-byte
// loads on 8 distinct bank quads.  Shared memory rather than registers: the
// slice is 40 KB at 160 x 512 and 147 KB at 288 x 1024, more than 256
// threads can hold; a lane keeps its rows of q and of one column in
// registers within a step.  One step:
//   (a) after the previous step's update every CTA knows the argmax of its
//       own norms (lowest index on ties, NaN flagged); its threads push
//       that candidate column, and one warp its slot (value, global index,
//       nan), into the inbox of every CTA of the cluster with st.async,
//       each push counted by the receiver's mbarrier for this step's parity;
//   (b) every thread waits on its own CTA's mbarrier until all 8 columns
//       and slots have landed: no cluster-wide barrier, and no fence (the
//       cluster barrier cost a GPU-scope MEMBAR and an L1 invalidation a
//       step);
//   (c) every warp reduces the 8 slots alike (lane k reads slot k) to the
//       same p and the same stop decision; q is the owner's column in the
//       local inbox;
//   (d) every group sums ||q||^2 over the same rows in the same order, so
//       nq2 and inv are bit-identical in every CTA; then per column a
//       shuffle reduction over the group gives proj, then the rank-1 update,
//       the norm downdate, ord (kept in shared memory until the end) and
//       the group's part of the next step's argmax.
// Inbox, slots and the reduction scratch are double-buffered by step
// parity: a CTA reads step i's before it passes the CTA barrier of step
// i + 1, and no CTA can push step i + 2 before every CTA has pushed step
// i + 1.  A final cluster barrier comes before any CTA exits.
//
// The caller's S is read once and never written.  The shared-memory limit
// and the check that the card can place a cluster
// (cudaOccupancyMaxActiveClusters) are done once per R and device; a cluster
// that cannot be placed is an error, never a fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                        // CTAs in the cluster
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                          // lanes per column
constexpr int kCols = kThreads / kGroup;           // columns in flight
constexpr int kMaxRows = kGroup * 36;              // 288 = nb + 32 at nb 256
constexpr int kMaxCand = 1024;                     // 4 nb at nb 256
constexpr int kCandStep = kCluster * kGroup;       // cand / 8 a multiple of 8
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

__device__ __forceinline__ bool wins(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Butterfly argmax over the lanes of a warp: every lane ends with the same
// (value, index); ties go to the lower index.
__device__ __forceinline__ void warp_argmax(float& bv, int& bi, int& nan) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (wins(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
  nan = __any_sync(0xffffffffu, nan);
}

// Rows a lane holds for an l-row tile (l <= kMaxRows): the least of 4, 12,
// 20, 28, 36 with 8 R >= l.
int lane_rows(int l) {
  int r = 4;
  while (kGroup * r < l) r += 8;
  return r;
}

// Dynamic shared memory of one CTA: the inbox (a candidate column from
// every rank, by parity), the slice's norms and order, and the slice.
template <int R>
constexpr size_t smem_bytes(int w) {
  return sizeof(float) * (2 * kGroup * R * kCluster + 2 * static_cast<size_t>(w) +
                          static_cast<size_t>(w) * kGroup * R);
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

// 16 bytes into another CTA's shared memory; its mbarrier bar counts them
// when they land (no fence, no cluster barrier).
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

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}" :: "r"(bar), "r"(parity) : "memory");
}

// One column's projection on q (this lane's rows in qv) and its rank-1
// update, R rows a lane from 16-byte loads.
template <int R>
__device__ __forceinline__ float project_update(float4* col4, const float4 (&qv)[R / 4],
                                                float inv) {
  float4 sv[R / 4];
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int k = 0; k < R / 4; ++k) {
    sv[k] = col4[k];
    a0 = fmaf(qv[k].x, sv[k].x, a0);
    a1 = fmaf(qv[k].y, sv[k].y, a1);
    a2 = fmaf(qv[k].z, sv[k].z, a2);
    a3 = fmaf(qv[k].w, sv[k].w, a3);
  }
  float proj = (a0 + a1) + (a2 + a3);
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) proj += __shfl_xor_sync(0xffffffffu, proj, o);
  const float coef = proj * inv;
#pragma unroll
  for (int k = 0; k < R / 4; ++k) {
    float4 v = sv[k];
    v.x -= qv[k].x * coef;
    v.y -= qv[k].y * coef;
    v.z -= qv[k].z * coef;
    v.w -= qv[k].w * coef;
    col4[k] = v;
  }
  return proj;
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
select_cluster_kernel(const float* __restrict__ S, const float* __restrict__ norms,
                      int* __restrict__ ord, int l, int cand, int nb) {
  constexpr int lp = kGroup * R;        // rows of the slice, zero past l
  constexpr int n16 = lp / 4;           // 16-byte pieces of a column
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int w = cand / kCluster;        // columns of this CTA
  const int c0 = rank * w;              // its first global column

  extern __shared__ float4 smem4[];
  float* inbox = reinterpret_cast<float*>(smem4);   // [2][kCluster][lp]: candidates by parity, rank
  float* nw = inbox + 2 * kCluster * lp;            // w: the slice's norms
  int* os = reinterpret_cast<int*>(nw + w);         // w: the slice's ord
  float* Ssl = nw + 2 * w;                          // w x lp: the slice, column-major
  // slot[parity][rank]: (value, global index, nan, -) of rank's candidate
  __shared__ float4 slots[2][kCluster];
  // full[parity]: one local arrival and the bytes of every rank's slot and column
  __shared__ __align__(8) unsigned long long full[2];
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];
  __shared__ int red_nan[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < lp * w; e += kThreads) {
    const int r = e / w, j = e - r * w;
    Ssl[j * lp + r] = r < l ? S[static_cast<size_t>(r) * cand + c0 + j] : 0.f;
  }
  float bv = neg_inf();
  int bi = INT_MAX;
  int nan = 0;
  for (int j = tid; j < w; j += kThreads) {
    const float x = norms[c0 + j];
    nw[j] = x;
    os[j] = -1;
    if (x != x) nan = 1;
    else if (wins(x, j, bv, bi)) { bv = x; bi = j; }
  }
  if (tid == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&full[b])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every CTA of the cluster runs, its barriers initialised, before any
  // distributed-shared-memory access.
  cluster.sync();

  const int sub = tid & (kGroup - 1);   // lane within the column's group: rows sub R + [0, R)
  constexpr uint32_t step_bytes = kCluster * (16u * n16 + 16u);

  for (int i = 0; i < nb; ++i) {
    const int par = i & 1;
    const uint32_t bar = smem_addr(&full[par]);
    // ---- (a) local argmax; its column and slot pushed to every rank ----
    if (tid == 0) arrive_expect_bytes(bar, step_bytes);
    warp_argmax(bv, bi, nan);
    if (lane == 0) {
      red_v[par][warp] = bv;
      red_i[par][warp] = bi;
      red_nan[par][warp] = nan;
    }
    __syncthreads();   // also: every column of the last update is written
    bv = lane < kWarps ? red_v[par][lane] : neg_inf();   // every warp: the CTA's candidate
    bi = lane < kWarps ? red_i[par][lane] : INT_MAX;
    nan = lane < kWarps ? red_nan[par][lane] : 0;
    warp_argmax(bv, bi, nan);
    {
      // A CTA without a candidate (every norm NaN) still sends its bytes.
      const float4* col = reinterpret_cast<const float4*>(Ssl + (bi == INT_MAX ? 0 : bi) * lp);
      const uint32_t mine = smem_addr(inbox + (par * kCluster + rank) * lp);
      for (int e = tid; e < kCluster * n16; e += kThreads) {
        const int k = e / n16, r = e - k * n16;
        push16(at_rank(mine + 16u * r, k), col[r], at_rank(bar, k));
      }
      if (warp == 0 && lane < kCluster)
        push16(at_rank(smem_addr(&slots[par][rank]), lane),
               make_float4(bv, __int_as_float(bi == INT_MAX ? INT_MAX : c0 + bi),
                           __int_as_float(nan), 0.f),
               at_rank(bar, lane));
    }

    // ---- (b) wait for every rank's slot and column ----
    wait_phase(bar, (i >> 1) & 1);

    // ---- (c) the same p and stop decision in every CTA ----
    float pv = neg_inf();   // lane k reads rank k's slot; every warp reduces them alike
    int p = INT_MAX;
    int stop = 0;
    if (lane < kCluster) {
      const float4 s = slots[par][lane];
      pv = s.x;
      p = __float_as_int(s.y);
      stop = __float_as_int(s.z);
    }
    warp_argmax(pv, p, stop);
    if (stop || p >= cand) break;   // uniform across the cluster
    const float4* q4 = reinterpret_cast<const float4*>(inbox + (par * kCluster + p / w) * lp) +
                       sub * R / 4;

    // ---- (d) nq2, then per column: proj, rank-1 update, downdate, next argmax ----
    // Every group of every CTA sums ||q||^2 over the same rows in the same
    // order, so nq2 and inv are bit-identical across the cluster.
    float4 qv[R / 4];
    float n0 = 0.f, n1 = 0.f, n2 = 0.f, n3 = 0.f;
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {
      qv[k] = q4[k];
      n0 = fmaf(qv[k].x, qv[k].x, n0);
      n1 = fmaf(qv[k].y, qv[k].y, n1);
      n2 = fmaf(qv[k].z, qv[k].z, n2);
      n3 = fmaf(qv[k].w, qv[k].w, n3);
    }
    float nq2 = (n0 + n1) + (n2 + n3);
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) nq2 += __shfl_xor_sync(0xffffffffu, nq2, o);
    const float inv = nq2 > 0.f ? 1.f / nq2 : 0.f;
    bv = neg_inf();
    bi = INT_MAX;
    nan = 0;
    // w is a multiple of 8 and a warp holds 4 columns, so every lane of a
    // warp runs the same number of passes (the shuffles inside).
    for (int j = tid / kGroup; j < w; j += kCols) {
      float4* col4 = reinterpret_cast<float4*>(Ssl + j * lp) + sub * R / 4;
      const float proj = project_update<R>(col4, qv, inv);
      if (sub == 0) {
        const int c = c0 + j;
        const float x = nw[j];
        float nn = x - proj * proj * inv;
        nn = nn < 0.f ? 0.f : nn;   // max(., 0) that keeps a NaN, as jnp.maximum
        nn = (c == p || x < 0.f) ? -1.f : nn;
        nw[j] = nn;
        if (c == p) os[j] = i;
        if (nn != nn) nan = 1;
        else if (wins(nn, j, bv, bi)) { bv = nn; bi = j; }
      }
    }
  }
  // Every push has landed (each CTA waited for its last step); no CTA
  // exits while another may still address its shared memory.
  cluster.sync();
  for (int j = tid; j < w; j += kThreads) ord[c0 + j] = os[j];
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

// Once per R and device: raise the kernel's shared-memory limit to what the
// largest tile of this R takes, and check that the card can place one
// cluster of it.  Only success is kept, so a failure raises on every call.
template <int R>
cudaError_t prepare(int dev) {
  static std::atomic<bool> ready[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  auto kernel = select_cluster_kernel<R>;
  const size_t bytes = smem_bytes<R>(kMaxCand / kCluster);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(bytes, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  ready[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

template <int R>
int launch(const void* S, const void* norms, void* ord, int l, int cand, int nb, int dev,
           cudaStream_t stream) {
  cudaError_t err = prepare<R>(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(smem_bytes<R>(cand / kCluster), stream, attr);
  err = cudaLaunchKernelEx(&cfg, select_cluster_kernel<R>, static_cast<const float*>(S),
                           static_cast<const float*>(norms), static_cast<int*>(ord), l, cand,
                           nb);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S (l x cand, row-major), norms (cand), ord (cand, int32 out); float32.
extern "C" int cqt_select_pivots_f32(const void* S, const void* norms, void* ord, int l,
                                     int cand, int nb, void* stream) {
  if (l < 1 || l > kMaxRows || cand < kCandStep || cand > kMaxCand || cand % kCandStep != 0 ||
      nb < 0 || nb > cand)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lane_rows(l)) {
    case 4: return launch<4>(S, norms, ord, l, cand, nb, dev, st);
    case 12: return launch<12>(S, norms, ord, l, cand, nb, dev, st);
    case 20: return launch<20>(S, norms, ord, l, cand, nb, dev, st);
    case 28: return launch<28>(S, norms, ord, l, cand, nb, dev, st);
    default: return launch<36>(S, norms, ord, l, cand, nb, dev, st);
  }
}
