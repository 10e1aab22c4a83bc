// Householder factorization of narrow panels (geqrt): one CTA per panel.
//
// Replaces the TPU kernel cuda_qr_tpu/ops/geqrt.py:_geqrt_kernel (called
// through _geqrt_pallas inside the recursive panel factorization), itself
// the successor of the reference's panelHouseholderKernel (qr.cu:60-333).
// For rows >= off of an m x w panel (w <= 128) it writes the packed V/R
// panel, tau (w) and the compact-WY T (w x w, row-major, upper triangular)
// with the conventions of cuda_qr_tpu/ops/householder.py: scaled norm with
// a NaN-propagating max, sign/u/tau/beta with the zero-column guard,
// v[d] = 1 implicit, T column j = -tau_j T[:j, :j] (V^T v_j) with
// T[j][j] = tau_j; rows above off are copied unchanged.
//
// Layout: the panel as it is, row-major (rows of w values; the input's row
// stride lda may exceed w, so a column slice of a wider matrix is read in
// place).  The output is contiguous m x w.  Batch grid (cqt_geqrt_batched_*):
// blockIdx.x selects one of `batch` panels stored back to back; it carries
// the TSQR leaves and each tree level (cuda_qr_tpu/models/tsqr.py:30-40).
//
// What bounds it on an H100: at the TSQR leaf stack (1024 panels of
// 1024 x 128 float) 49 GFLOP and 1.1 GB, 0.74 ms of FP32 FMA; one 256 x 128
// node alone is far below a launch and bound by its 128 dependent column
// steps on one SM.  The first design (PR 1 / PR 3) kept every column step
// in L2/HBM: per column two block reductions, four 32-wide chunks of dot
// products (~700 shuffles, 8 barriers) and a rank-1 update, each re-reading
// the whole trailing panel.  A 512 KB leaf fits no SM, and 132 of them in
// flight overflow the 50 MB L2, so every leaf streamed ~64 MB from HBM.
// It also read a transposed copy that the wrapper made.
//
// This design (the "sub-panel body"; wrapper: ops/geqrt.py, whose `plan`
// picks kb, residency and row slices from the shape alone):
//   * kb <= 32 columns at a time (a sub-panel) are factored in shared
//     memory, rows >= off + c0, row stride kb + 1; where the whole panel
//     fits (a 256 x 128 float tree node: 132 KB) it stays there, row stride
//     w + 1, and only the result goes back;
//   * column steps with the rows spread over the 512 threads: per column,
//     ONE block reduction (two barriers) yields the scale, the norm, tau,
//     beta, every dot product of the update and a column of the Gram
//     V_s^T V_s; each thread then updates its own rows.  The first design
//     took ~700 shuffles and 8 barriers per column;
//   * T_s from that Gram by one warp in registers (lane i owns row i of the
//     recurrence, so no barrier);
//   * one pass over the panel's other columns computes both V_s^T A_trail
//     (for the block update A_trail -= V_s T_s^T V_s^T A_trail) and
//     V_s^T V_prev (for joining T as _geqrt_recursive joins halves:
//     T[:c0, c0:] = -T[:c0, :c0] V_prev^T V_s T_s); so the trailing panel is
//     read and written once per kb columns, not once per column; a thread
//     keeps 8 rows of loads in flight, and tall panels split the rows into
//     slices whose partial products are summed afterwards.
// Panels too tall for a 4-column sub-panel (float: m - off > ~11k rows)
// take the first design's streaming body (kb = 0), reading the row-major
// panel in L2.
//
// What bounds a TSQR tree node, and the triangle-pair body.  A node
// stacks two upper triangles, [R_i; R_j] (2w x w, off = 0).  On the
// resident body above a 256 x 128 float node takes ~225 KB, one CTA per
// SM, and its 128 column steps run one after another at ~4.5 us each over
// a panel three quarters zeros: 0.58 ms a node, while the work is ~3 MFLOP.
// The 1M x 128 tree's 10 levels (512, 256, ..., 1 nodes) then take 14 waves
// of 132 SMs, ~8 ms.  A node is latency-bound, so the pair body cuts the
// latency of a step and the footprint of a node, not its operations:
//   * at column j the reflector is 1 at top row j and lives on bottom rows
//     0..j; the update touches top row j and bottom rows 0..j of the later
//     columns.  Every other entry stays an exact zero (as in the dense
//     body: 0 / u = 0, x - f 0 = x), so only the two triangles are held:
//     the bottom one in registers (warp g owns columns g + 16k, lane l rows
//     l + 32q; only the 20 (k, q) that reach the triangle exist, so 64
//     registers hold it without spills), the top one packed in shared
//     memory, read row j at step j and overwritten by R's row j; 101 KB at
//     256 x 128 float, 2 CTAs per SM (the tree's 14 waves become 11);
//   * one block barrier a step: each warp takes its 8 columns' dots with
//     v_j over 4 rows a lane, sums them across the lanes in 9 shuffles (a
//     reduce-scatter: lanes 4s..4s+3 end with column slot s) and broadcasts
//     the 8 coefficients back; the warp that owns column j + 1 updates it,
//     then at once takes its reflector (look-ahead: the scale and the sum of
//     squares in one pass, a second, scaled pass only outside [2^-50, 2^50])
//     and publishes v_{j+1} and tau_{j+1} before the barrier.  The same dots
//     with the finished columns are the Gram V^T v_j that T needs;
//   * T by the sub-panel body's rules: each 32-column diagonal block by one
//     warp in registers, then T[:c, J] = -T[:c, :c] (Y[:c, J] T_JJ) for the
//     later blocks J.  R, V and T keep the dense body's conventions, with
//     exact zeros below R's and V's diagonals and T's.
// What bounds it now (H100 80GB HBM3, 700 W): ~2,200 cycles a step, 0.16 ms
// a node.  A step is the owner warp's chain (dots, the reduce-scatter, the
// coefficients, the reflector), with every warp's 17 shuffles queued on the
// pipe that also serves shared loads.  Layouts where a lane holds a run of
// one column's rows need 2 shuffles, but read all of v_j from shared memory
// once per column, and were 2-4x slower.
// Only the caller that stacks the pair can ask for it (geqrt_batched's
// pair=True): a shape cannot tell a stacked pair from a dense panel.
//
// What bounds a TSQR leaf, and the blocked leaf body.  A 1,024 x 128 float
// leaf (512 KB) fits no SM, so the sub-panel body holds 32 columns of it
// (132 KB), one CTA an SM: the 1,024 leaves of a 1M x 128 call take 8
// waves.  A clock64 probe of one leaf on it (H100 80GB HBM3, 700 W) reads
// 2.44 M cycles: 43 % column steps (level-2 work over the whole 32-wide
// sub-panel, two barriers and a 64-long chain of two shared loads an FMA
// each), 21 % the other-column products and 9 % the update (a shared word
// per 2 FMAs).  The blocked body (float32, off = 0, at most 1,024 rows; the
// plan routes by shape) is geqrf's blocking inside one CTA:
//   * the sub-panel is held column-major, row stride = 4 (mod 32), so
//     float4 loads of 4 neighbouring columns hit distinct banks; it comes in
//     by word cp.async, every copy in flight at once;
//   * it is factored in inner blocks of 8 columns, their column steps in
//     registers (thread t holds rows t and t + 512), one barrier a step:
//     each warp sums 8 slots (the pivot's sum of squares and its dots with
//     the block's other 7 columns: the update's coefficients for the later
//     ones, the Gram for the earlier ones) in slot_sums' reduce-scatter,
//     then every warp adds the 16 warps' sums and takes the reflector
//     itself.  The sums of squares are unscaled; a column whose largest |x|
//     lies outside [2^-50, 2^50] (or is 0 or NaN) sends the whole block
//     again through steps that scale it, as pair_reflector does: kept out of
//     the common steps, that branch and its divisions cost them ~40 %;
//   * after each inner block: its T (one warp: T_s's diagonal block), then
//     C = V_ib^T (the sub-panel's other columns) over the rows (warp = a row
//     slice, lane = a quarter of it x 4 columns, 8 x 4 accumulators), which
//     is the Gram with the earlier blocks and W for the later ones, then
//     A_rest -= V_ib (T_ib^T W);
//   * T_s above its diagonal blocks by block joins, T[:b, B] = -T[:b, :b]
//     (Y[:b, B] T_BB); the products with the other columns register-tiled:
//     Z = V_s^T A_other with a lane 8 reflectors x 4 columns (a float4 of V
//     feeds 16 FMAs, one of the stage 32), each warp streaming its rows of
//     the other columns through its own 4-stage cp.async ring; the update
//     A_trail -= V_s Z_trail in 16 x 32 warp tiles (a lane 4 x 4), the next
//     tile arriving in the warp's ring while this one's FMAs run, each read
//     and written once; the T join reads T from shared memory;
//   * every operation is an FP32 FFMA, with the dense body's conventions.
// What bounds it now (same card): 1.05 M cycles a leaf, the Z pass 25 %
// (its warps issue a float4 shared load per 10.7 FMAs), the column steps
// 23 % (~1,850 cycles a step: the cross-warp sums and the reflector, taken
// in every thread, after the barrier), the inner blocks' products 18 %, the
// update 15 %.  Holding the steps' rows in fewer warps (4 or 8) spills or
// lengthens each thread's part, and was slower.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;      // streaming body: dot products per pass
constexpr int kMaxW = 128;

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  // NaN-propagating max, as jnp.max: a + b is NaN when either is.
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------------------
// Sub-panel body
// ------------------------------------------------------------------------

constexpr int kKb = 32;         // widest sub-panel: one warp's lanes
constexpr int kLd = kKb + 1;    // row stride of the small kb x kb buffers
constexpr int kRedWords = 600;  // RowRed (the column steps' scratch), in words of T
constexpr int kBatch = 8;       // rows of loads a thread keeps in flight

// Smallest normal number: at or above it, 1 / s is finite and a multiply
// replaces a division by s.
template <typename T> __device__ __forceinline__ T min_normal();
template <> __device__ __forceinline__ float min_normal<float>() { return 1.17549435e-38f; }
template <> __device__ __forceinline__ double min_normal<double>() {
  return 2.2250738585072014e-308;
}

// Sign, u, tau and beta of a column with leading entry x0, scaled maximum s
// and scaled sum of squares ssq; v = x / safe_u below the diagonal.
template <typename T>
struct Refl {
  T tau, beta, safe_u;
  bool degen;
  __device__ Refl(T x0, T s, T ssq) {
    const T norm = sqrt(ssq) * s;
    const T sign = x0 < T(0) ? T(-1) : T(1);
    const T u = x0 + sign * norm;
    degen = norm <= T(0);
    safe_u = degen ? T(1) : u;
    tau = degen ? T(0) : sign * u / norm;
    beta = degen ? x0 : -sign * norm;
  }
};

// Shared scratch of the column steps: per-warp partials and the step's
// coefficients.
template <typename T>
struct RowRed {
  T w[kWarps][kKb];      // per warp: w_c = sum of x_r a_rc over its rows r > j
  T mx[kWarps], ssq[kWarps];
  T f[kKb];              // f_c = tau_j (v_j . a_c), the update coefficients
  T beta, safe_u;
  int degen, rcp;
};

static_assert(sizeof(RowRed<double>) <= kRedWords * sizeof(double), "kRedWords");
static_assert(sizeof(RowRed<float>) <= kRedWords * sizeof(float), "kRedWords");

// The column steps of a sub-panel (rows x kbs in V, row stride ldp), rows
// spread over the threads: thread t owns local rows t, t + 512, ...  Per
// step j, each thread takes max |x| and the sum of squares scaled by it on
// its rows of the pivot column j; lane c of each warp takes, over the warp's
// rows, the partial dot of column c > j with column j (for the update) or
// of column c < j - 1 with v_{j-1} (the Gram entry Y[c][j-1] for T).  One
// block reduction (two barriers) gives the scale, the norm (per-thread
// scales combined as LAPACK's nrm2 does), tau, beta, every update
// coefficient and a column of the Gram; then each thread writes its rows of
// v_j and updates its rows of the later columns.  Step kbs only finishes
// the Gram.
template <typename T>
__device__ void column_steps(T* V, int ldp, int rows, int kbs, T* tau_s, T* Ys,
                             RowRed<T>* red) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = 0; j <= kbs; ++j) {
    __syncwarp();                                      // the last step's row writes
    const bool pivot = j < kbs;
    const int r0 = j + ((tid - j) & (kThreads - 1));   // first own row >= j
    T mx = T(0), ssq = T(0);
    if (pivot) {
      for (int r = r0; r < rows; r += kThreads) mx = nan_max(mx, T(fabs(V[r * ldp + j])));
      const bool fast = mx >= min_normal<T>();         // 1 / mx is finite
      const T rmx = fast ? T(1) / mx : T(0);
      for (int r = r0; r < rows; r += kThreads) {
        const T x = V[r * ldp + j];
        T xs;
        if (fast)
          xs = x * rmx;
        else
          xs = mx > T(0) ? x / mx : x * T(0);           // x * 0: NaN stays NaN
        ssq += xs * xs;
      }
    }
    const T wmx = warp_max(mx);
    const T wssq = warp_sum(mx > T(0) ? ssq * (mx / wmx) * (mx / wmx) : T(0));
    // lane c: c > j dots with column j over rows > j; c < j - 1 dots with
    // column j - 1 over rows > j - 1
    const bool upd = pivot && lane > j && lane < kbs, gram = lane + 1 < j;
    T acc0 = T(0), acc1 = T(0);
    if (upd || gram) {
      const int piv = upd ? j : j - 1;
      const T* Vp = V + piv;
      const T* Vc = V + lane;
      for (int base = warp * 32; base < rows; base += kThreads) {
        const int hi = base + 32 < rows ? base + 32 : rows;
        int r = base > piv ? base : piv + 1;
        for (; r + 1 < hi; r += 2) {
          acc0 += Vp[r * ldp] * Vc[r * ldp];
          acc1 += Vp[(r + 1) * ldp] * Vc[(r + 1) * ldp];
        }
        if (r < hi) acc0 += Vp[r * ldp] * Vc[r * ldp];
      }
    }
    red->w[warp][lane] = acc0 + acc1;
    if (lane == 0) {
      red->mx[warp] = wmx;
      red->ssq[warp] = wssq;
    }
    __syncthreads();
    if (warp == 0) {
      T part = T(0);
      for (int k = 0; k < kWarps; ++k) part += red->w[k][lane];
      if (gram) Ys[lane * kLd + j - 1] = V[(j - 1) * ldp + lane] + part;   // v_{j-1}[j-1] = 1
      if (pivot) {
        // the warps' scales and scaled sums, combined across lanes
        const T m = lane < kWarps ? red->mx[lane] : T(0);
        const T sm = warp_max(m);
        T q = m > T(0) ? red->ssq[lane] * (m / sm) * (m / sm) : T(0);
        q = warp_sum(q);
        if (!(sm == sm)) q = sm;                       // NaN spreads
        const T sc = sm > T(0) ? sm : T(1);
        const Refl<T> h(V[j * ldp + j], sc, q);
        if (upd) red->f[lane] = h.tau * (V[j * ldp + lane] + (h.degen ? T(0) : part / h.safe_u));
        if (lane == 0) {
          tau_s[j] = h.tau;
          red->beta = h.beta;
          red->safe_u = h.safe_u;
          red->degen = h.degen;
          red->rcp = sc >= min_normal<T>();
        }
      }
    }
    __syncthreads();
    if (!pivot) break;
    const T safe_u = red->safe_u;
    const T ru = T(1) / safe_u;
    const bool degen = red->degen, rcp = red->rcp;
    const T* __restrict__ f = red->f;
    for (int r = r0; r < rows; r += kThreads) {
      T* __restrict__ Vr = V + r * ldp;
      T v;
      if (r == j) {
        v = T(1);
        Vr[j] = red->beta;
      } else {
        const T x = Vr[j];
        v = degen ? T(0) : (rcp ? x * ru : x / safe_u);
        Vr[j] = v;
      }
#pragma unroll 4
      for (int c = j + 1; c < kbs; ++c) Vr[c] -= f[c] * v;
    }
  }
}

// ------------------------------------------------------------------------
// Triangle-pair body: a TSQR tree node [R_i; R_j] (see the note at the top)
// ------------------------------------------------------------------------

constexpr int kSlots = kMaxW / kWarps;   // columns a warp owns: warp + 16 k
constexpr int kLaneRows = kMaxW / 32;    // bottom rows a lane owns: lane + 32 q

// Whether slot k's columns reach row slot q at all (r <= c): the registers
// hold only the triangle, 20 of the 32 (k, q).
__host__ __device__ constexpr bool held(int k, int q) {
  return 32 * q <= kWarps * k + kWarps - 1;
}

// Shared memory of the pair body, in elements of T: v twice, tau, beta, the
// bottom block's square (w x (w | 1): the bottom triangle in, then the Gram
// Y below the diagonal and T above it) and the top block's packed triangle
// (R_i in, R out; then V_2 out; then T's products).
__host__ __device__ constexpr int pair_words(int w) {
  return 4 * kMaxW + w * (w | 1) + w * (w + 1) / 2;
}

// Packed upper triangle of a w x w block: row r holds columns r .. w - 1.
__device__ __forceinline__ int tri_at(int r, int c, int w) {
  return r * w - r * (r - 1) / 2 + c - r;
}

// max over the warp of a >= 0 (an |x|) or NaN: non-negative floats order as
// their bits, and a NaN from fabs lies above them all
__device__ __forceinline__ float warp_max_abs(float a) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(a)));
}
__device__ __forceinline__ double warp_max_abs(double a) { return warp_max(a); }

// Within [1 / big, big] the squares of a column's entries neither overflow
// nor lose what the norm needs: the unscaled sum of squares is taken there.
template <typename T> __device__ __forceinline__ T big();
template <> __device__ __forceinline__ float big<float>() { return 1.1258999e15f; }   // 2^50
template <> __device__ __forceinline__ double big<double>() {
  return 2.5822498780869086e120;                          // 2^400
}

// Column j, held by one warp: x0 on top row j, col[q] on bottom row
// lane + 32 q (live up to row j, zeros below).  Its reflector as Refl has
// it: the scale is the largest |x| (NaN-propagating), taken beside the sum
// of squares; a scale outside [1 / big, big] (or zero, or NaN) takes the
// sum again scaled.  col becomes v (bottom rows), also written to vb; tau_j
// and beta_j go to tau_s / beta_s.
template <typename T>
__device__ __forceinline__ void pair_reflector(T (&col)[kLaneRows], T x0, int j, T* vb,
                                               T* tau_s, T* beta_s) {
  const int lane = threadIdx.x & 31;
  T mx = lane == 0 ? T(fabs(x0)) : T(0);
  T ssq = lane == 0 ? x0 * x0 : T(0);
#pragma unroll
  for (int q = 0; q < kLaneRows; ++q) {
    mx = nan_max(mx, T(fabs(col[q])));
    ssq += col[q] * col[q];
  }
  mx = warp_max_abs(mx);
  ssq = warp_sum(ssq);
  T sc = T(1);
  if (!(mx >= T(1) / big<T>() && mx <= big<T>())) {     // the same in every lane
    const bool fast = mx >= min_normal<T>();              // 1 / mx is finite
    const T rmx = fast ? T(1) / mx : T(0);
    auto sq = [&](T x) {
      const T xs = fast ? x * rmx : (mx > T(0) ? x / mx : x * T(0));   // x * 0: NaN stays NaN
      return xs * xs;
    };
    ssq = lane == 0 ? sq(x0) : T(0);
#pragma unroll
    for (int q = 0; q < kLaneRows; ++q) ssq += sq(col[q]);
    ssq = warp_sum(ssq);
    if (!(mx == mx)) ssq = mx;                            // NaN spreads
    sc = mx > T(0) ? mx : T(1);
  }
  const Refl<T> h(x0, sc, ssq);
  if (h.degen || sc >= min_normal<T>()) {                 // 1 / safe_u is finite
    const T ru = h.degen ? T(0) : T(1) / h.safe_u;
#pragma unroll
    for (int q = 0; q < kLaneRows; ++q) col[q] = lane + 32 * q > j ? T(0) : col[q] * ru;
  } else {
#pragma unroll
    for (int q = 0; q < kLaneRows; ++q) col[q] = lane + 32 * q > j ? T(0) : col[q] / h.safe_u;
  }
#pragma unroll
  for (int q = 0; q < kLaneRows; ++q) vb[lane + 32 * q] = col[q];
  if (lane == 0) {
    tau_s[j] = h.tau;
    beta_s[j] = h.beta;
  }
}

// Sum each of a lane's kSlots partial dots over the warp: a reduce-scatter
// (xor 16, 8, 4 halve the slots) then xor 2, 1; lanes 4s .. 4s + 3 end with
// slot s's sum.
template <typename T>
__device__ __forceinline__ T slot_sums(const T (&a)[kSlots], int lane) {
  static_assert(kSlots == 8, "three halvings");
  T b[4], c[2];
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = (h4 ? a[i + 4] : a[i]) + __shfl_xor_sync(0xffffffffu, h4 ? a[i] : a[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (h3 ? b[i + 2] : b[i]) + __shfl_xor_sync(0xffffffffu, h3 ? b[i] : b[i + 2], 8);
  T d = (h2 ? c[1] : c[0]) + __shfl_xor_sync(0xffffffffu, h2 ? c[0] : c[1], 4);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  return d + __shfl_xor_sync(0xffffffffu, d, 1);
}

template <typename T>
__device__ void pair_body(const T* __restrict__ A, int lda, T* P, T* __restrict__ tau,
                          T* __restrict__ Tm, int w, T* sm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = w | 1;                                 // odd: lanes' rows in distinct banks
  const int nn = w * w;
  T* vbuf = sm;                                         // v_j at vbuf + (j & 1) * kMaxW
  T* tau_s = vbuf + 2 * kMaxW;
  T* beta_s = tau_s + kMaxW;
  T* S = beta_s + kMaxW;                                // w x ld
  T* top = S + w * ld;

  // the two triangles in, rstep rows at a time (thread (r0, c0): column c0)
  const int rstep = kThreads / w, r0 = tid / w, c0 = tid - r0 * w;
  if (r0 < rstep) {
#pragma unroll 8
    for (int r = r0; r < w; r += rstep) {
      if (r <= c0) {
        top[tri_at(r, c0, w)] = A[static_cast<size_t>(r) * lda + c0];
        S[r * ld + c0] = A[static_cast<size_t>(w + r) * lda + c0];
      }
    }
  }
  __syncthreads();
  T x[kSlots][kLaneRows];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int c = warp + kWarps * k;
#pragma unroll
    for (int q = 0; q < kLaneRows; ++q) {
      const int r = lane + 32 * q;
      x[k][q] = held(k, q) && c < w && r <= c ? S[r * ld + c] : T(0);
    }
  }

  // column steps, one barrier each (j = -1: column 0's reflector only)
  const int slot = lane >> 2;                           // the slot this lane sums
  const int cs = warp + kWarps * slot;
  for (int j = -1; j < w; ++j) {
    __syncthreads();                                    // v_j, tau_j; the last step's writes
    if (j >= 0) {
      const T* vj = vbuf + (j & 1) * kMaxW;
      T v[kLaneRows];
#pragma unroll
      for (int q = 0; q < kLaneRows; ++q) v[q] = 32 * q <= j ? vj[lane + 32 * q] : T(0);
      const bool live = cs > j && cs < w;
      const T t = live ? top[tri_at(j, cs, w)] : T(0);
      const T tj = tau_s[j];
      // every owned column's dot with v_j: the update's for c > j, the
      // Gram's Y[c][j] for c < j
      T a[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        a[k] = T(0);
#pragma unroll
        for (int q = 0; q < kLaneRows; ++q)
          if (held(k, q) && 32 * q <= j) a[k] += v[q] * x[k][q];
      }
      const T d = slot_sums(a, lane);
      const T f = live ? tj * (t + d) : T(0);
      if ((lane & 3) == 0) {
        if (live) top[tri_at(j, cs, w)] = t - f;         // R[j][cs]
        else if (cs < j) S[j * ld + cs] = d;             // Y[cs][j], below the diagonal
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const T fk = __shfl_sync(0xffffffffu, f, 4 * k);
#pragma unroll
        for (int q = 0; q < kLaneRows; ++q)
          if (held(k, q) && 32 * q <= j) x[k][q] -= fk * v[q];
      }
    }
    // look-ahead: the owner of column j + 1 takes its reflector now, on the
    // column picked out of its slots by selects (one copy of the code)
    const int jn = j + 1;
    if (jn < w && warp == jn % kWarps) {
      const int kn = jn / kWarps;
      T col[kLaneRows];
#pragma unroll
      for (int q = 0; q < kLaneRows; ++q) {
        col[q] = T(0);
#pragma unroll
        for (int k = 0; k < kSlots; ++k)
          if (held(k, q)) col[q] = k == kn ? x[k][q] : col[q];
      }
      pair_reflector(col, top[tri_at(jn, jn, w)], jn, vbuf + (jn & 1) * kMaxW, tau_s, beta_s);
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
#pragma unroll
        for (int q = 0; q < kLaneRows; ++q)
          if (held(k, q)) x[k][q] = k == kn ? col[q] : x[k][q];
    }
  }
  __syncthreads();

  // the top block (R above the diagonal, beta on it, zeros below) and tau
  if (r0 < rstep) {
#pragma unroll 4
    for (int r = r0; r < w; r += rstep)
      P[r * w + c0] = c0 > r ? top[tri_at(r, c0, w)] : (c0 == r ? beta_s[r] : T(0));
  }
  if (tid < w) tau[tid] = tau_s[tid];
  __syncthreads();
  // V_2, the bottom block, through the packed triangle (zeros below)
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int c = warp + kWarps * k;
#pragma unroll
    for (int q = 0; q < kLaneRows; ++q) {
      const int r = lane + 32 * q;
      if (held(k, q) && c < w && r <= c) top[tri_at(r, c, w)] = x[k][q];
    }
  }
  __syncthreads();
  if (r0 < rstep) {
#pragma unroll 4
    for (int r = r0; r < w; r += rstep)
      P[nn + r * w + c0] = c0 >= r ? top[tri_at(r, c0, w)] : T(0);
  }

  // T's diagonal blocks, warp b the block of columns 32b .., lane i its row
  // (as the sub-panel body's T_s): T[i][j] = -tau_j sum_k T[i][k] Y[k][j],
  // Y[k][j] at S[j * ld + k]; T goes above S's diagonal
  const int nblk = (w + kKb - 1) / kKb;
  if (warp < nblk) {
    const int b0 = warp * kKb;
    const int kbs = w - b0 < kKb ? w - b0 : kKb;
    T trow[kKb];
#pragma unroll
    for (int k = 0; k < kKb; ++k) trow[k] = k == lane && k < kbs ? tau_s[b0 + k] : T(0);
#pragma unroll
    for (int jj = 1; jj < kKb; ++jj) {
      if (jj >= kbs) break;
      T s = T(0);
#pragma unroll
      for (int k = 0; k < jj; ++k) s += trow[k] * S[(b0 + jj) * ld + b0 + k];
      if (jj > lane) trow[jj] = -tau_s[b0 + jj] * s;
    }
#pragma unroll
    for (int k = 0; k < kKb; ++k)
      if (lane < kbs && k >= lane && k < kbs) S[(b0 + lane) * ld + b0 + k] = trow[k];
  }
  __syncthreads();
  // the later blocks: T[:b0, J] = -T[:b0, :b0] Wk with Wk = Y[:b0, J] T_JJ
  // (Wk in top), each thread a 2 x 4 tile of the product
  T* Wk = top;
  for (int blk = 1; blk < nblk; ++blk) {
    const int b0 = blk * kKb;
    const int kbs = w - b0 < kKb ? w - b0 : kKb;
    const int tj = (kbs + 3) / 4;
    const int tiles = b0 / 2 * tj;                      // 2 x 4 tiles
    const int p0 = tid / tj * 2, j0 = tid % tj * 4;
    if (tid < tiles) {
      T a[2][4] = {};
      const int qe = j0 + 3 < kbs - 1 ? j0 + 3 : kbs - 1;
#pragma unroll 4
      for (int q = 0; q <= qe; ++q) {
        const T* col = S + (b0 + q) * ld;                 // Y[:, b0 + q] and T_JJ's row q
        T y[2], tq[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) y[r] = col[p0 + r];
#pragma unroll
        for (int u = 0; u < 4; ++u) tq[u] = q <= j0 + u && j0 + u < kbs ? col[b0 + j0 + u] : T(0);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) a[r][u] += y[r] * tq[u];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j0 + u < kbs) Wk[(p0 + r) * kbs + j0 + u] = a[r][u];
    }
    __syncthreads();
    if (tid < tiles) {
      T a[2][4] = {};
#pragma unroll 4
      for (int q = p0; q < b0; ++q) {
        T tp[2], wq[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) tp[r] = q >= p0 + r ? S[(p0 + r) * ld + q] : T(0);
#pragma unroll
        for (int u = 0; u < 4; ++u) wq[u] = j0 + u < kbs ? Wk[q * kbs + j0 + u] : T(0);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) a[r][u] += tp[r] * wq[u];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j0 + u < kbs) S[(p0 + r) * ld + b0 + j0 + u] = -a[r][u];
    }
    __syncthreads();
  }
  if (r0 < rstep) {
#pragma unroll 4
    for (int r = r0; r < w; r += rstep) Tm[r * w + c0] = c0 >= r ? S[r * ld + c0] : T(0);
  }
}


// resident: the whole panel (rows >= off, all w columns) stays in shared
// memory, row stride w + 1, and the sub-panel is a window of it; otherwise
// only the sub-panel is held (row stride kb + 1) and the other columns are
// read and written in global memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
geqrt_subpanel_kernel(const T* __restrict__ A, int lda, T* P, T* __restrict__ tau,
                      T* __restrict__ Tm, int m, int w, int off, int kb, int resident,
                      int nslices) {
  // P is read back after it is written: no __restrict__ on it.
  extern __shared__ unsigned char smem_raw[];
  const size_t b = blockIdx.x;
  A += b * static_cast<size_t>(m) * lda;
  P += b * static_cast<size_t>(m) * w;
  tau += b * w;
  Tm += b * w * w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int prows = m - off;
  const int ldp = resident ? w + 1 : kb + 1;
  T* Ps = reinterpret_cast<T*>(smem_raw);              // prows x ldp
  T* Ys = Ps + static_cast<size_t>(prows) * ldp;       // kKb x kLd, Y[c][j] = v_c . v_j
  T* Ts = Ys + kKb * kLd;                              // kKb x kLd, T_s (zeros below)
  T* Z = Ts + kKb * kLd;                               // nslices x kb x w
  T* tau_s = Z + nslices * kb * w;                     // kKb
  auto* red = reinterpret_cast<RowRed<T>*>(tau_s + kKb); // kRedWords

  for (int e = tid; e < off * w; e += kThreads) P[e] = A[(e / w) * lda + e % w];
  for (int e = tid; e < w * w; e += kThreads) Tm[e] = T(0);
  if (resident)
    for (int e = tid; e < prows * w; e += kThreads)
      Ps[(e / w) * ldp + e % w] = A[static_cast<size_t>(off + e / w) * lda + e % w];

  for (int c0 = 0; c0 < w; c0 += kb) {
    const int kbs = w - c0 < kb ? w - c0 : kb;
    const int r0 = off + c0;                           // global row of local row 0
    const int rows = m - r0;
    // the other columns as they stand: rows r0 .. m, stride ld_o
    const int ld_o = resident ? ldp : (c0 == 0 ? lda : w);
    const T* src = resident ? Ps + static_cast<size_t>(c0) * ldp
                            : (c0 == 0 ? A : P) + static_cast<size_t>(r0) * ld_o;
    T* dst = resident ? Ps + static_cast<size_t>(c0) * ldp : P + static_cast<size_t>(r0) * w;
    const int ld_d = resident ? ldp : w;
    T* V = resident ? Ps + static_cast<size_t>(c0) * ldp + c0 : Ps;
    __syncthreads();                                   // writes of the last step
    if (!resident) {
      for (int e = tid; e < rows * kbs; e += kThreads)
        V[(e / kbs) * ldp + e % kbs] = src[static_cast<size_t>(e / kbs) * ld_o + c0 + e % kbs];
      __syncthreads();
    }

    // ---- column steps ----
    column_steps(V, ldp, rows, kbs, tau_s, Ys, red);
    __syncthreads();

    // ---- packed write-back, then V made explicit in place (unit diagonal,
    // zeros above); resident panels write only the R triangle now ----
    for (int e = tid; e < rows * kbs; e += kThreads) {
      const int r = e / kbs, i = e % kbs;
      T* x = V + r * ldp + i;
      const bool tri = r <= i;
      if (!resident || tri) P[static_cast<size_t>(r0 + r) * w + c0 + i] = *x;
      if (tri) *x = r == i ? T(1) : T(0);
    }
    if (tid < kbs) tau[c0 + tid] = tau_s[tid];
    // T_s by warp 0, lane i its row: T[i][j] = -tau_j sum_{k<j} T[i][k] Y[k][j]
    if (warp == 0) {
      T trow[kKb];
#pragma unroll
      for (int k = 0; k < kKb; ++k) trow[k] = k == lane && k < kbs ? tau_s[k] : T(0);
#pragma unroll
      for (int j = 1; j < kKb; ++j) {
        if (j >= kbs) break;
        T t = T(0);
#pragma unroll
        for (int k = 0; k < j; ++k) t += trow[k] * Ys[k * kLd + j];
        if (j > lane) trow[j] = -tau_s[j] * t;
      }
#pragma unroll
      for (int k = 0; k < kKb; ++k) {
        Ts[lane * kLd + k] = trow[k];
        if (lane < kbs && k >= lane && k < kbs) Tm[(c0 + lane) * w + c0 + k] = trow[k];
      }
    }
    __syncthreads();
    if (kbs == w) break;

    // ---- one pass over the other columns o: Z[i][o] = v_i . A[:, o].  A
    // thread takes 8 reflectors and two columns (o, o + half), so each V
    // load feeds two FMAs, and keeps kBatch rows of loads in flight; rows
    // are split into `slices` partial sums (added in the next phase) ----
    const int others = w - kbs;
    const int groups = (kbs + 7) / 8;
    const int half = (others + 1) / 2;
    int slices = kThreads / (half * groups);
    slices = slices < 1 ? 1 : (slices > nslices ? nslices : slices);
    const int span = (rows + slices - 1) / slices;
    for (int t = tid; t < half * groups * slices; t += kThreads) {
      const int oi = t % half, i0 = (t / half) % groups * 8, sl = t / (half * groups);
      const bool two = oi + half < others;
      const int o0 = oi < c0 ? oi : oi + kbs;
      const int o1 = oi + half < c0 ? oi + half : oi + half + kbs;
      const int r_lo = sl * span > i0 ? sl * span : i0;
      const int r_hi = (sl + 1) * span < rows ? (sl + 1) * span : rows;
      T acc0[8], acc1[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) acc0[q] = acc1[q] = T(0);
      for (int rb = r_lo; rb < r_hi; rb += kBatch) {
        T a0[kBatch], a1[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const bool in = rb + u < r_hi;
          const size_t at = static_cast<size_t>(rb + u) * ld_o;
          a0[u] = in ? src[at + o0] : T(0);
          a1[u] = in && two ? src[at + o1] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const T* vr = V + (rb + u < r_hi ? rb + u : r_lo) * ldp + i0;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (i0 + q < kbs) {
              const T v = vr[q];
              acc0[q] += v * a0[u];
              acc1[q] += v * a1[u];
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (i0 + q < kbs) {
          Z[(sl * kb + i0 + q) * w + o0] = acc0[q];
          if (two) Z[(sl * kb + i0 + q) * w + o1] = acc1[q];
        }
      }
    }
    __syncthreads();
    // Z[:, o] <- T_s^T Z[:, o]: for o < c0 that is (V_prev^T V_s T_s)^T
    if (tid < others) {
      const int o = tid < c0 ? tid : tid + kbs;
      T z[kKb];
#pragma unroll
      for (int i = 0; i < kKb; ++i) {
        z[i] = T(0);
        for (int sl = 0; sl < slices; ++sl) z[i] += i < kbs ? Z[(sl * kb + i) * w + o] : T(0);
      }
#pragma unroll
      for (int j = kKb - 1; j >= 0; --j) {
        T t = T(0);
#pragma unroll
        for (int i = 0; i <= j; ++i) t += Ts[i * kLd + j] * z[i];
        z[j] = t;                                      // z[i < j] still the inputs
      }
#pragma unroll
      for (int i = 0; i < kKb; ++i)
        if (i < kbs) Z[i * w + o] = z[i];
    }
    __syncthreads();
    // T[:c0, c0:c0+kbs] = -T[:c0, :c0] K with K[q][j] = Z[j][q]
    for (int e = tid; e < c0 * kbs; e += kThreads) {
      const int p = e / kbs, j = e % kbs;
      T t = T(0);
      for (int q = p; q < c0; ++q) t += Tm[p * w + q] * Z[j * w + q];
      Tm[p * w + c0 + j] = -t;
    }
    // trailing update A_t -= V_s Z_t, columns c0 + kbs .. w, two columns a
    // thread (c, c + half) so that each V load feeds two FMAs
    const int wt = w - c0 - kbs;
    if (wt > 0) {
      const int half = (wt + 1) / 2;
      const int rsl = kThreads / half;                 // row slices of the update
      if (tid < rsl * half) {
        const int c = c0 + kbs + tid % half, c2 = c + half;
        const bool two = c2 < w;
        T z0[kKb], z1[kKb];
#pragma unroll
        for (int i = 0; i < kKb; ++i) {
          z0[i] = i < kbs ? Z[i * w + c] : T(0);
          z1[i] = i < kbs && two ? Z[i * w + c2] : T(0);
        }
        // rows tid / half + k * rsl, kUpd of them loaded before any store
        // (src and dst may be the same buffer)
        constexpr int kUpd = kBatch / 2;
        for (int rb = tid / half; rb < rows; rb += kUpd * rsl) {
          T a0[kUpd], a1[kUpd];
#pragma unroll
          for (int u = 0; u < kUpd; ++u) {
            const int r = rb + u * rsl;
            a0[u] = r < rows ? src[static_cast<size_t>(r) * ld_o + c] : T(0);
            a1[u] = r < rows && two ? src[static_cast<size_t>(r) * ld_o + c2] : T(0);
          }
#pragma unroll
          for (int u = 0; u < kUpd; ++u) {
            const int r = rb + u * rsl;
            if (r >= rows) break;
            const T* vr = V + r * ldp;
#pragma unroll
            for (int i = 0; i < kKb; ++i) {
              if (kbs == kKb || i < kbs) {
                const T v = vr[i];
                a0[u] -= v * z0[i];
                a1[u] -= v * z1[i];
              }
            }
            dst[static_cast<size_t>(r) * ld_d + c] = a0[u];
            if (two) dst[static_cast<size_t>(r) * ld_d + c2] = a1[u];
          }
        }
      }
    }
  }
  if (resident) {
    // the whole panel, but for the R triangles written above
    __syncthreads();
    for (int e = tid; e < prows * w; e += kThreads) {
      const int r = e / w, c = e % w;
      const int cs = (c / kb) * kb;
      if (cs <= r && r <= c) continue;
      P[static_cast<size_t>(off + r) * w + c] = Ps[r * ldp + c];
    }
  }
}

// The triangle-pair body's kernel (m = 2w, off = 0): a kernel of its own,
// with launch bounds for 2 CTAs an SM in float32; its name holds the dense
// kernel's, so a trace finds B2's device time by the one name.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
geqrt_subpanel_kernel_pair(const T* __restrict__ A, int lda, T* P, T* __restrict__ tau,
                           T* __restrict__ Tm, int w) {
  extern __shared__ unsigned char smem_raw[];
  const size_t b = blockIdx.x, m = 2 * w;
  pair_body(A + b * m * lda, lda, P + b * m * w, tau + b * w, Tm + b * w * w, w,
            reinterpret_cast<T*>(smem_raw));
}

// ------------------------------------------------------------------------
// Blocked leaf body: geqrf's blocking inside one CTA (see the note at the top)
// ------------------------------------------------------------------------

constexpr int kIb = 8;                   // inner block: the columns of one run of steps
constexpr int kLeafRows = 2 * kThreads;  // rows it holds: two a thread in the steps
constexpr int kZld = 100;                // row stride of Z (at most 96 other columns)
constexpr int kStage = 4;                // rows of one stage of a warp's ring (4 x 32)
constexpr int kDepth = 4;                // stages in a warp's ring
constexpr int kRing = kDepth * kStage * 32;   // a warp's ring; one update tile (16 x 32)
constexpr int kRedLd = 160;              // one buffer of the steps' warp sums

static_assert(kIb == kSlots, "a step's sums are slot_sums' eight slots");

// Row stride of the column-major sub-panel: = 4 (mod 32), so that float4
// loads of the same rows of 4 neighbouring columns fall in distinct banks.
__host__ __device__ constexpr int blocked_ldr(int m) { return ((m + 31) & ~31) + 4; }

// The blocked body's shared memory at m x w, in floats (the layout below).
__host__ __device__ constexpr int blocked_words(int m, int w) {
  return kKb * blocked_ldr(m) + 3 * kKb * kLd + kKb + 2 * kRedLd + 2 * kWarps + 2 * kIb
         + kWarps + kIb * kKb + kKb * kZld + kWarps * kRing + w * (w + 1) / 2;
}

__device__ __forceinline__ int tri(int q) { return q * (q + 1) / 2; }

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// T of the n <= 32 columns b0 .. b0 + n of a sub-panel, from its Gram
// (Y[k][j] = v_k . v_j at Ys[k * kLd + j], k < j) and tau, by one warp: lane i
// takes row i, T[i][j] = -tau_j sum_{i<=k<j} T[i][k] Y[k][j], left to right,
// reading its own row back from Ts (zeros below the diagonal).  The sums are
// the sub-panel body's T_s rows, less the zeros it adds first.
__device__ __forceinline__ void t_rows(const float* Ys, const float* tau_s, float* Ts, int b0,
                                       int n, int lane) {
  if (lane >= n) return;
  float* row = Ts + (b0 + lane) * kLd + b0;
  for (int k = 0; k < lane; ++k) row[k] = 0.f;
  row[lane] = tau_s[b0 + lane];
  for (int j = lane + 1; j < n; ++j) {
    float t = 0.f;
    for (int k = lane; k < j; ++k) t += row[k] * Ys[(b0 + k) * kLd + b0 + j];
    row[j] = -tau_s[b0 + j] * t;
  }
}

// The column steps of an inner block (columns b0 .. b0 + nib of the
// sub-panel), its rows in x (thread t: rows t and t + 512), one barrier a
// step (see the note at the top).  kScaled = false takes each sum of squares
// unscaled and returns false at the first step whose largest |x| lies
// outside [2^-50, 2^50] (or is 0 or NaN), the same step in every thread,
// leaving x and the scratch to be discarded; kScaled = true takes such a
// step's sum again, scaled by the max, as pair_reflector does.
template <bool kScaled>
__device__ __forceinline__ bool inner_steps(float (&x)[2][kIb], int b0, int nib, int rows,
                                            float* red, float* red_mx, float* rowbuf,
                                            float* red_s, float* tau_s, float* Ys) {
  using T = float;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < kIb; ++j) {
    if (j >= nib) break;
    const int p = b0 + j;                              // the pivot row
    T* rb = red + (j & 1) * kRedLd;
    T* mb = red_mx + (j & 1) * kWarps;
    T* pr = rowbuf + (j & 1) * kIb;
    // own rows: the pivot column's max and sum of squares (rows >= p), its
    // dots with the other columns (rows > p): slot c for column c, slot j
    // for the sum of squares
    T mx = T(0), a[kIb];
#pragma unroll
    for (int c = 0; c < kIb; ++c) a[c] = T(0);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = tid + q * kThreads;
      const T xj = x[q][j];
      if (r >= p) {
        mx = nan_max(mx, T(fabs(xj)));
        a[j] += xj * xj;
      }
      if (r > p) {
#pragma unroll
        for (int c = 0; c < kIb; ++c)
          if (c != j && c < nib) a[c] += xj * x[q][c];
      }
    }
    if (tid == p) {
#pragma unroll
      for (int c = 0; c < kIb; ++c) pr[c] = x[0][c];
    }
    const T sw = slot_sums(a, lane);
    const T mw = warp_max_abs(mx);
    // warp w' at 8 (w' + w' / 4): the reads below hit 32 distinct banks
    if ((lane & 3) == 0) rb[8 * (warp + (warp >> 2)) + (lane >> 2)] = sw;
    if (lane == 0) mb[warp] = mw;
    __syncthreads();
    // the block's sums, the same in every warp: lanes 4s .. 4s + 3 add
    // slot s of four warps each, then of all sixteen
    const int slot = lane >> 2, part = lane & 3;
    T s = T(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) s += rb[8 * (5 * part + k) + slot];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const T bm = warp_max_abs(lane < kWarps ? mb[lane] : T(0));
    T tot[kIb];
#pragma unroll
    for (int c = 0; c < kIb; ++c) tot[c] = __shfl_sync(0xffffffffu, s, 4 * c);
    const T x0 = pr[j];
    T ssq = tot[j], sc = T(1);
    if (!(bm >= T(1) / big<T>() && bm <= big<T>())) {   // the same in every thread
      if (!kScaled) return false;
      const bool fast = bm >= min_normal<T>();         // 1 / bm is finite
      const T rmx = fast ? T(1) / bm : T(0);
      T q2 = T(0);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = tid + q * kThreads;
        if (r >= p) {
          const T xq = x[q][j];
          const T xs = fast ? xq * rmx : (bm > T(0) ? xq / bm : xq * T(0));   // NaN stays
          q2 += xs * xs;
        }
      }
      q2 = warp_sum(q2);
      if (lane == 0) red_s[warp] = q2;
      __syncthreads();
      ssq = T(0);
#pragma unroll
      for (int k = 0; k < kWarps; ++k) ssq += red_s[k];
      if (!(bm == bm)) ssq = bm;                       // NaN spreads
      sc = bm > T(0) ? bm : T(1);
    }
    const Refl<T> h(x0, sc, ssq);
    // 1 / safe_u is finite (always unscaled: then |u| >= 2^-50)
    const bool rcp = !kScaled || h.degen || sc >= min_normal<T>();
    const T ru = h.degen ? T(0) : T(1) / h.safe_u;
    // (x . a) / u, as v = x / u below the pivot
    auto over_u = [&](T d) { return h.degen ? T(0) : (rcp ? d * ru : d / h.safe_u); };
    T f[kIb];
#pragma unroll
    for (int c = 0; c < kIb; ++c)
      f[c] = c > j && c < nib ? h.tau * (pr[c] + over_u(tot[c])) : T(0);
    // tau, and the Gram within the block: v_c . v_j = v_c[p] + (x_j . v_c)
    // / u, by the last warp's lanes 4c (which hold slot c's sum)
    if (warp == kWarps - 1 && (lane & 3) == 0) {
      if (lane == 0) tau_s[p] = h.tau;
      if (slot < j) Ys[(b0 + slot) * kLd + p] = pr[slot] + over_u(s);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = tid + q * kThreads;
      if (r < p || r >= rows) continue;
      const T v = r == p ? T(1) : (rcp ? x[q][j] * ru : x[q][j] / h.safe_u);
      x[q][j] = r == p ? h.beta : v;
#pragma unroll
      for (int c = 0; c < kIb; ++c)
        if (c > j && c < nib) x[q][c] -= f[c] * v;
    }
  }
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
geqrt_subpanel_kernel_blocked(const T* __restrict__ A, int lda, T* P, T* __restrict__ tau,
                              T* __restrict__ Tm, int m, int w, int vec) {
  static_assert(sizeof(T) == 4, "float32 only");
  // P is read back after it is written: no __restrict__ on it.
  extern __shared__ unsigned char smem_raw[];
  const size_t bid = blockIdx.x;
  A += bid * static_cast<size_t>(m) * lda;
  P += bid * static_cast<size_t>(m) * w;
  tau += bid * w;
  Tm += bid * static_cast<size_t>(w) * w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ldr = blocked_ldr(m);
  T* Vt = reinterpret_cast<T*>(smem_raw);   // kKb x ldr: the sub-panel, column-major
  T* Rs = Vt + kKb * ldr;                   // kKb x kLd: R on the inner blocks' triangles
  T* Ys = Rs + kKb * kLd;                   // the sub-panel's Gram, above the diagonal
  T* Ts = Ys + kKb * kLd;                   // T_s
  T* tau_s = Ts + kKb * kLd;                // kKb
  T* red = tau_s + kKb;                     // 2 x kRedLd: the steps' warp sums
  T* red_mx = red + 2 * kRedLd;             // 2 x kWarps: the steps' warp maxima
  T* rowbuf = red_mx + 2 * kWarps;          // 2 x kIb: the pivot row
  T* red_s = rowbuf + 2 * kIb;              // kWarps: a scaled sum of squares
  T* Cb = red_s + kWarps;                   // kIb x kKb: an inner block's products
  T* Z = Cb + kIb * kKb;                    // kKb x kZld: V_s^T A_other, then T_s^T that
  T* ring = Z + kKb * kZld;                 // kWarps x kRing; also the partial sums
  T* Tt = ring + kWarps * kRing;            // T, packed by columns: T[p][q] at tri(q) + p

  for (int c0 = 0; c0 < w; c0 += kKb) {
    const int kbs = w - c0 < kKb ? w - c0 : kKb;
    const int rows = m - c0;
    const int lds = c0 == 0 ? lda : w;
    const T* srow = (c0 == 0 ? A : P) + static_cast<size_t>(c0) * lds;   // local row 0
    T* prow = P + static_cast<size_t>(c0) * w;
    __syncthreads();                                   // the last sub-panel's products
    // ---- the sub-panel in, column-major, zeros below its rows and right of
    // kbs, by word copies all in flight at once; a warp moves 4 rows x 8
    // columns (32-byte runs of the rows, distinct banks at the row stride) ----
    for (int e = tid; e < ldr / 4 * 128; e += kThreads) {
      const int i = (e & 7) + 8 * ((e >> 5) & 3), r = 4 * (e >> 7) + ((e >> 3) & 3);
      const bool ok = r < rows && i < kbs;
      cp_async4(Vt + i * ldr + r, srow + (ok ? static_cast<size_t>(r) * lds + c0 + i : 0), ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int b0 = 0; b0 < kbs; b0 += kIb) {
      const int nib = kbs - b0 < kIb ? kbs - b0 : kIb;
      // ---- column steps on the inner block, in registers: thread t holds
      // rows t and t + 512 of its columns; unscaled sums of squares, and
      // only if a column needs it the block again with scaled ones ----
      T x[2][kIb];
      auto load_x = [&]() {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int r = tid + q * kThreads;
#pragma unroll
          for (int c = 0; c < kIb; ++c) x[q][c] = r < rows ? Vt[(b0 + c) * ldr + r] : T(0);
        }
      };
      load_x();
      if (!inner_steps<false>(x, b0, nib, rows, red, red_mx, rowbuf, red_s, tau_s, Ys)) {
        __syncthreads();                               // the scratch, read by every warp
        load_x();                                      // Vt is written only after the steps
        inner_steps<true>(x, b0, nib, rows, red, red_mx, rowbuf, red_s, tau_s, Ys);
      }
      // the block back: R of its triangle to Rs, V explicit (1 on its
      // diagonal, 0 above) to Vt
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = tid + q * kThreads;
        if (r < b0 || r >= rows) continue;
#pragma unroll
        for (int c = 0; c < kIb; ++c) {
          if (c >= nib) break;
          const int col = b0 + c;
          T val = x[q][c];
          if (r <= col) {
            Rs[r * kLd + col] = val;
            val = r == col ? T(1) : T(0);
          }
          Vt[col * ldr + r] = val;
        }
      }
      __syncthreads();
      if (warp == 0) t_rows(Ys, tau_s, Ts, b0, nib, lane);   // T_s's diagonal block
      if (nib == kbs) break;                           // no other column in the sub-panel
      const int nrest = kbs - b0 - nib;
      // ---- C[k][o] = v_{b0+k} . Vt[:, o] over rows >= b0, for every other
      // column o of the sub-panel: the Gram with the earlier blocks (o < b0)
      // and V_ib^T A_rest (o >= b0 + nib).  Warp = a slice of the rows; lane
      // = a quarter of its rows (rows 4 rq + 16 t) and the columns og + 8u, so
      // a float4 of V_ib feeds 16 FMAs and 8 lanes read 8 banks' columns ----
      {
        const int og = lane & 7, rq = lane >> 3;
        const int len = (rows - b0 + 3) & ~3;
        const int span = ((len + kWarps - 1) / kWarps + 3) & ~3;
        const int r_lo = b0 + warp * span;
        const int r_hi = r_lo + span < b0 + len ? r_lo + span : b0 + len;
        bool live[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int o = og + 8 * u;
          live[u] = o < kbs && (o < b0 || o >= b0 + kIb);
        }
        T acc[kIb][4];
#pragma unroll
        for (int k = 0; k < kIb; ++k)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[k][u] = T(0);
        for (int r = r_lo + 4 * rq; r < r_hi; r += 16) {
          float4 vo[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            vo[u] = live[u] ? *reinterpret_cast<const float4*>(Vt + (og + 8 * u) * ldr + r)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < kIb; ++k) {
            const float4 vk = *reinterpret_cast<const float4*>(Vt + (b0 + k) * ldr + r);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[k][u] = fmaf(vk.x, vo[u].x, acc[k][u]);
              acc[k][u] = fmaf(vk.y, vo[u].y, acc[k][u]);
              acc[k][u] = fmaf(vk.z, vo[u].z, acc[k][u]);
              acc[k][u] = fmaf(vk.w, vo[u].w, acc[k][u]);
            }
          }
        }
        // the quarters' sums, then the warp's partial sums to the ring
#pragma unroll
        for (int k = 0; k < kIb; ++k)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[k][u] += __shfl_xor_sync(0xffffffffu, acc[k][u], 8);
            acc[k][u] += __shfl_xor_sync(0xffffffffu, acc[k][u], 16);
          }
        if (rq == 0) {
#pragma unroll
          for (int k = 0; k < kIb; ++k)
#pragma unroll
            for (int u = 0; u < 4; ++u) ring[(warp * kIb + k) * kKb + og + 8 * u] = acc[k][u];
        }
      }
      __syncthreads();
      if (tid < kIb * kKb) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < kWarps; ++k) s += ring[k * kIb * kKb + tid];
        Cb[tid] = s;                                   // C[k][o] at k * kKb + o
      }
      __syncthreads();
      for (int e = tid; e < b0 * nib; e += kThreads) {
        const int o = e / nib, k = e - o * nib;
        Ys[o * kLd + b0 + k] = Cb[k * kKb + o];
      }
      if (nrest == 0) continue;                        // the sub-panel's last block
      // W = T_ib^T C on the later columns, a thread a column
      if (tid >= b0 + nib && tid < kbs) {
        T c[kIb];
#pragma unroll
        for (int k = 0; k < kIb; ++k) c[k] = k < nib ? Cb[k * kKb + tid] : T(0);
#pragma unroll
        for (int j = kIb - 1; j >= 0; --j) {
          if (j >= nib) continue;
          T t = T(0);
#pragma unroll
          for (int k = 0; k <= j; ++k) t += Ts[(b0 + k) * kLd + b0 + j] * c[k];
          c[j] = t;                                    // c[k < j] still the inputs
        }
#pragma unroll
        for (int k = 0; k < kIb; ++k)
          if (k < nib) Cb[k * kKb + tid] = c[k];
      }
      __syncthreads();
      // A_rest -= V_ib W over rows >= b0: thread t rows b0 + 4 (t % 256) ..,
      // every other later column
      {
        const int r = b0 + 4 * (tid & 255);
        if (r < rows) {
          float4 vk[kIb];
#pragma unroll
          for (int k = 0; k < kIb; ++k)
            vk[k] = k < nib ? *reinterpret_cast<const float4*>(Vt + (b0 + k) * ldr + r)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
          for (int o = b0 + nib + (tid >> 8); o < kbs; o += 2) {
            float4 a = *reinterpret_cast<const float4*>(Vt + o * ldr + r);
#pragma unroll
            for (int k = 0; k < kIb; ++k) {
              if (k >= nib) break;
              const T wk = Cb[k * kKb + o];
              a.x = fmaf(-vk[k].x, wk, a.x);
              a.y = fmaf(-vk[k].y, wk, a.y);
              a.z = fmaf(-vk[k].z, wk, a.z);
              a.w = fmaf(-vk[k].w, wk, a.w);
            }
            T* d = Vt + o * ldr + r;
            if (r + 4 <= rows) {
              *reinterpret_cast<float4*>(d) = a;
            } else {                                   // rows past the panel stay zero
              d[0] = a.x;
              if (r + 1 < rows) d[1] = a.y;
              if (r + 2 < rows) d[2] = a.z;
            }
          }
        }
      }
      __syncthreads();
    }
    __syncthreads();                                   // the last block's Gram entries

    // ---- T_s above its diagonal blocks, a block column at a time:
    // T[:b, B] = -T[:b, :b] (Y[:b, B] T_BB), M = Y[:b, B] T_BB in Cb ----
    for (int b = kIb; b < kbs; b += kIb) {
      const int nb = kbs - b < kIb ? kbs - b : kIb;
      for (int e = tid; e < b * nb; e += kThreads) {
        const int jj = e / b, q = e - jj * b;
        T t = T(0);
        for (int k = 0; k <= jj; ++k) t += Ys[q * kLd + b + k] * Ts[(b + k) * kLd + b + jj];
        Cb[jj * kKb + q] = t;
      }
      __syncthreads();
      for (int e = tid; e < b * nb; e += kThreads) {
        const int jj = e / b, pp = e - jj * b;
        T t = T(0);
        for (int q = pp; q < b; ++q) t += Ts[pp * kLd + q] * Cb[jj * kKb + q];
        Ts[pp * kLd + b + jj] = -t;
      }
      __syncthreads();
    }
    // ---- the packed sub-panel out (R above the diagonal, from Rs on the
    // inner blocks' triangles; V below), then V explicit in Vt ----
    if (tid < kbs) tau[c0 + tid] = tau_s[tid];
    for (int e = tid; e < (rows + 3) / 4 * 128; e += kThreads) {
      const int i = (e & 7) + 8 * ((e >> 5) & 3), r = 4 * (e >> 7) + ((e >> 3) & 3);
      if (r >= rows || i >= kbs) continue;
      const int blk = i & ~(kIb - 1);
      T val = Vt[i * ldr + r];
      if (r >= blk && r <= i) val = Rs[r * kLd + i];
      prow[static_cast<size_t>(r) * w + c0 + i] = val;
      if (r < blk) Vt[i * ldr + r] = T(0);
    }
    __syncthreads();
    for (int e = tid; e < kbs * kbs; e += kThreads) {
      const int i = e / kbs, j = e - i * kbs;
      if (i <= j) Tt[tri(c0 + j) + c0 + i] = Ts[i * kLd + j];
    }
    const int others = w - kbs;
    if (others == 0) continue;                         // one sub-panel (w <= 32)

    // ---- Z = V_s^T A_other over the sub-panel's rows, the other columns
    // (compact: o < c0 the earlier ones, o >= c0 column o + kbs) through each
    // warp's cp.async ring of four stages of 4 rows x 32 columns, three in
    // flight.  Warp = (o-tile of 32, row slice); lane = 8 reflectors
    // (g + 4q) x 4 columns (4 og ..), so a float4 of V feeds 16 FMAs and one
    // of the stage 32 ----
    {
      const int nt = (others + 31) / 32;
      const int ns = kWarps / nt;                      // row slices
      const int ot = warp % nt, sl = warp / nt;
      const int span = ((rows + ns - 1) / ns + kStage - 1) & ~(kStage - 1);
      const int r_lo = sl * span;
      const int r_hi = r_lo + span < rows ? r_lo + span : rows;
      const int nst = sl < ns && r_hi > r_lo ? (r_hi - r_lo + kStage - 1) / kStage : 0;
      T* wring = ring + warp * kRing;
      const int g = lane & 3, og = lane >> 2;
      T acc[8][4];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int o = 0; o < 4; ++o) acc[q][o] = T(0);
      auto stage = [&](int k) {
        T* st = wring + (k % kDepth) * (kStage * 32);
        const int rb = r_lo + k * kStage;
        if (vec) {
          const int rr = lane >> 3, oo = (lane & 7) * 4, oi = 32 * ot + oo;
          const int r = rb + rr;
          const bool ok = r < rows && oi < others;
          const int col = oi < c0 ? oi : oi + kbs;
          cp_async16(st + rr * 32 + oo, srow + (ok ? static_cast<size_t>(r) * lds + col : 0), ok);
        } else {
#pragma unroll
          for (int rr = 0; rr < kStage; ++rr) {
            const int oi = 32 * ot + lane, r = rb + rr;
            const bool ok = r < rows && oi < others;
            const int col = oi < c0 ? oi : oi + kbs;
            cp_async4(st + rr * 32 + lane, srow + (ok ? static_cast<size_t>(r) * lds + col : 0),
                      ok);
          }
        }
      };
      // a group per stage, empty past the last, so that "all but the newest
      // kDepth - 1 groups" is always stage k
#pragma unroll
      for (int k = 0; k < kDepth - 1; ++k) {
        if (k < nst) stage(k);
        cp_async_commit();
      }
      for (int k = 0; k < nst; ++k) {
        if (k + kDepth - 1 < nst) stage(k + kDepth - 1);
        cp_async_commit();
        cp_async_wait<kDepth - 1>();
        __syncwarp();
        const T* st = wring + (k % kDepth) * (kStage * 32);
        const int rb = r_lo + k * kStage;
        {
          float4 bb[4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            bb[rr] = *reinterpret_cast<const float4*>(st + rr * 32 + 4 * og);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(Vt + (g + 4 * q) * ldr + rb);
            const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
              acc[q][0] = fmaf(vr[rr], bb[rr].x, acc[q][0]);
              acc[q][1] = fmaf(vr[rr], bb[rr].y, acc[q][1]);
              acc[q][2] = fmaf(vr[rr], bb[rr].z, acc[q][2]);
              acc[q][3] = fmaf(vr[rr], bb[rr].w, acc[q][3]);
            }
          }
        }
        __syncwarp();                                  // read before it is refilled
      }
      // the slices' partial sums into Z, one slice after another
      for (int round = 0; round < ns; ++round) {
        if (sl == round) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int i = g + 4 * q;
#pragma unroll
            for (int o = 0; o < 4; ++o) {
              const int oi = 32 * ot + 4 * og + o;
              if (oi < others && i < kbs) {
                T* z = Z + i * kZld + oi;
                *z = round == 0 ? acc[q][o] : *z + acc[q][o];
              }
            }
          }
        }
        __syncthreads();
      }
    }
    // Z[:, o] <- T_s^T Z[:, o]: for o < c0 that is (V_prev^T V_s T_s)^T
    if (tid < others) {
      T z[kKb];
#pragma unroll
      for (int i = 0; i < kKb; ++i) z[i] = i < kbs ? Z[i * kZld + tid] : T(0);
#pragma unroll
      for (int j = kKb - 1; j >= 0; --j) {
        if (j >= kbs) continue;
        T t = T(0);
#pragma unroll
        for (int i = 0; i <= j; ++i) t += Ts[i * kLd + j] * z[i];
        z[j] = t;                                      // z[i < j] still the inputs
      }
#pragma unroll
      for (int i = 0; i < kKb; ++i)
        if (i < kbs) Z[i * kZld + tid] = z[i];
    }
    __syncthreads();
    // T[:c0, c0 + j] = -T[:c0, :c0] K with K[q][j] = Z[j][q], T read in shared
    // memory: a thread row p and 4 columns; a warp's rows p0 .. p0 + 31 (c0 is a
    // multiple of 32) run q from p0 together, so T's column q is one run
    for (int e = tid; e < c0 * ((kbs + 3) / 4); e += kThreads) {
      const int j0 = e / c0 * 4, p = e - e / c0 * c0;
      T t[4] = {T(0), T(0), T(0), T(0)};
      for (int q = p & ~31; q < c0; ++q) {
        const T tq = q >= p ? Tt[tri(q) + p] : T(0);
#pragma unroll
        for (int u = 0; u < 4; ++u) t[u] = fmaf(tq, Z[(j0 + u) * kZld + q], t[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + u < kbs) Tt[tri(c0 + j0 + u) + p] = -t[u];
    }

    // ---- A_trail -= V_s Z_trail, warp tiles of 16 rows x 32 columns (lane:
    // rows 4 (lane / 8) .., columns 4 (lane % 8) ..): the next tile comes into
    // the warp's ring by cp.async while this one's FMAs run on registers, and
    // each tile is written back once ----
    const int ntr = others - c0;                       // trailing columns
    if (ntr > 0) {
      const int nrt = (rows + 15) / 16, ntiles = nrt * ((ntr + 31) / 32);
      const int rg = lane >> 3, tg = lane & 7;
      T* wring = ring + warp * kRing;
      auto fetch = [&](int tile) {
        const int r0 = 16 * (tile % nrt), t0 = 32 * (tile / nrt);
        if (vec) {
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int id = lane + 32 * h, rr = id >> 3, cc = (id & 7) * 4;
            const int r = r0 + rr, t = t0 + cc;
            const bool ok = r < rows && t < ntr;
            cp_async16(wring + rr * 32 + cc,
                       srow + (ok ? static_cast<size_t>(r) * lds + c0 + kbs + t : 0), ok);
          }
        } else {
#pragma unroll 4
          for (int rr = 0; rr < 16; ++rr) {
            const int r = r0 + rr, t = t0 + lane;
            const bool ok = r < rows && t < ntr;
            cp_async4(wring + rr * 32 + lane,
                      srow + (ok ? static_cast<size_t>(r) * lds + c0 + kbs + t : 0), ok);
          }
        }
        cp_async_commit();
      };
      if (warp < ntiles) fetch(warp);
      for (int tile = warp; tile < ntiles; tile += kWarps) {
        cp_async_wait<0>();
        __syncwarp();
        T cur[4][4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const float4 a = *reinterpret_cast<const float4*>(wring + (4 * rg + rr) * 32 + 4 * tg);
          cur[rr][0] = a.x;
          cur[rr][1] = a.y;
          cur[rr][2] = a.z;
          cur[rr][3] = a.w;
        }
        __syncwarp();                                  // read before it is refilled
        if (tile + kWarps < ntiles) fetch(tile + kWarps);
        const int r0 = 16 * (tile % nrt) + 4 * rg, t0 = 32 * (tile / nrt) + 4 * tg;
        if (t0 >= ntr) continue;
#pragma unroll 4
        for (int i = 0; i < kbs; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(Vt + i * ldr + r0);
          const float4 z = *reinterpret_cast<const float4*>(Z + i * kZld + c0 + t0);
          const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            cur[rr][0] = fmaf(-vr[rr], z.x, cur[rr][0]);
            cur[rr][1] = fmaf(-vr[rr], z.y, cur[rr][1]);
            cur[rr][2] = fmaf(-vr[rr], z.z, cur[rr][2]);
            cur[rr][3] = fmaf(-vr[rr], z.w, cur[rr][3]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int r = r0 + rr;
          if (r >= rows) break;
          T* d = prow + static_cast<size_t>(r) * w + c0 + kbs + t0;
          if (vec) {
            *reinterpret_cast<float4*>(d) = make_float4(cur[rr][0], cur[rr][1], cur[rr][2],
                                                        cur[rr][3]);
          } else {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              if (t0 + cc < ntr) d[cc] = cur[rr][cc];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < w * w; e += kThreads) {
    const int r = e / w, c = e - r * w;
    Tm[e] = r <= c ? Tt[tri(c) + r] : T(0);
  }
}

// ------------------------------------------------------------------------
// Streaming body (kb = 0): the panel stays in L2, column steps read it there
// ------------------------------------------------------------------------

template <typename T, bool kMax>
__device__ T block_reduce(T v, T* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kWarps ? red[threadIdx.x] : T(0);  // 0: identity of both
    v = kMax ? warp_max(v) : warp_sum(v);
    if (threadIdx.x == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
geqrt_stream_kernel(const T* __restrict__ A, int lda, T* __restrict__ P,
                    T* __restrict__ tau, T* __restrict__ Tm, int m, int w, int off) {
  __shared__ T red[33];
  __shared__ T part[kWarps][kChunk];
  __shared__ T dots[kMaxW];
  const size_t b = blockIdx.x;
  A += b * static_cast<size_t>(m) * lda;
  P += b * static_cast<size_t>(m) * w;
  tau += b * w;
  Tm += b * w * w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (size_t e = tid; e < static_cast<size_t>(m) * w; e += kThreads)
    P[e] = A[(e / w) * lda + e % w];
  for (int e = tid; e < w * w; e += kThreads) Tm[e] = T(0);
  __syncthreads();

  for (int j = 0; j < w; ++j) {
    const int d = off + j;
    T* pj = P + j;                                   // column j, stride w
    const T x0 = pj[static_cast<size_t>(d) * w];

    T a = T(0);
    for (int r = d + tid; r < m; r += kThreads)
      a = nan_max(a, T(fabs(pj[static_cast<size_t>(r) * w])));
    a = block_reduce<T, true>(a, red);
    const T s = a > T(0) ? a : T(1);
    T q = T(0);
    for (int r = d + tid; r < m; r += kThreads) {
      const T xs = pj[static_cast<size_t>(r) * w] / s;
      q += xs * xs;
    }
    q = block_reduce<T, false>(q, red);
    const T norm = sqrt(q) * s;

    const T sign = x0 < T(0) ? T(-1) : T(1);
    const T u = x0 + sign * norm;
    const bool degen = norm <= T(0);
    const T safe_u = degen ? T(1) : u;
    const T tj = degen ? T(0) : sign * u / norm;
    const T beta = degen ? x0 : -sign * norm;

    for (int r = d + tid; r < m; r += kThreads) {
      T& x = pj[static_cast<size_t>(r) * w];
      x = (r == d) ? beta : (degen ? T(0) : x / safe_u);
    }

    // dots[i] = P_i . v over rows >= d, for every column i
    for (int c0 = 0; c0 < w; c0 += kChunk) {
      T acc[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) acc[i] = T(0);
      for (int r = d + tid; r < m; r += kThreads) {
        const T* row = P + static_cast<size_t>(r) * w;
        const T v = (r == d) ? T(1) : row[j];
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if (c0 + i < w) acc[i] += row[c0 + i] * v;
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) acc[i] = warp_sum(acc[i]);
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

    for (int i = tid; i < j; i += kThreads) {
      T t = T(0);
      for (int k = i; k < j; ++k) t += Tm[i * w + k] * dots[k];
      Tm[i * w + j] = -tj * t;
    }
    if (tid == 0) {
      Tm[j * w + j] = tj;
      tau[j] = tj;
    }

    for (int r = d + tid; r < m; r += kThreads) {
      T* row = P + static_cast<size_t>(r) * w;
      const T v = (r == d) ? T(1) : row[j];
      for (int c = j + 1; c < w; ++c) row[c] -= (tj * dots[c]) * v;
    }
    __syncthreads();
  }
}

// The pair body's dynamic shared memory, opted in: its bytes, or 0 where
// they pass the card's limit.
template <typename T>
size_t pair_setup(int w) {
  const size_t bytes = sizeof(T) * pair_words(w);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > static_cast<size_t>(optin)) return 0;
  cudaFuncSetAttribute(geqrt_subpanel_kernel_pair<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  // the most shared memory an SM has: two float CTAs need 2 x 101 KB
  cudaFuncSetAttribute(geqrt_subpanel_kernel_pair<T>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  return bytes;
}

template <typename T>
int launch(const void* A, int lda, void* P, void* tau, void* Tm, int batch, int m, int w,
           int off, int kb, int resident, int nslices, void* stream) {
  if (batch < 1 || w < 1 || w > kMaxW || off < 0 || off + w > m || lda < w || kb < 0
      || kb > kKb || kb > w || (kb > 0 && nslices < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (kb == 0) {
    geqrt_stream_kernel<T><<<batch, kThreads, 0, st>>>(
        static_cast<const T*>(A), lda, static_cast<T*>(P), static_cast<T*>(tau),
        static_cast<T*>(Tm), m, w, off);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t ldp = resident ? w + 1 : kb + 1;
  const size_t bytes = sizeof(T) * ((m - off) * ldp + 2 * kKb * kLd
                                    + static_cast<size_t>(nslices) * kb * w + kKb + kRedWords);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(geqrt_subpanel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  geqrt_subpanel_kernel<T><<<batch, kThreads, bytes, st>>>(
      static_cast<const T*>(A), lda, static_cast<T*>(P), static_cast<T*>(tau),
      static_cast<T*>(Tm), m, w, off, kb, resident, nslices);
  return static_cast<int>(cudaGetLastError());
}

// L leaves of m x w (m <= 1024, row stride lda, panel stride m lda) on the
// blocked body; vec: 16-byte copies (A and P 16-byte aligned, lda and w
// multiples of 4).
template <typename T>
int launch_blocked(const void* A, int lda, void* P, void* tau, void* Tm, int batch, int m, int w,
                   void* stream) {
  if (batch < 1 || w < 1 || w > kMaxW || m < w || m > kLeafRows || lda < w)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(T) * blocked_words(m, w);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(geqrt_subpanel_kernel_blocked<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  const int vec = lda % 4 == 0 && w % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0
                  && reinterpret_cast<uintptr_t>(P) % 16 == 0;
  geqrt_subpanel_kernel_blocked<T><<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), lda, static_cast<T*>(P), static_cast<T*>(tau),
      static_cast<T*>(Tm), m, w, vec);
  return static_cast<int>(cudaGetLastError());
}

// L triangle pairs of 2w x w (row stride lda, panel stride 2w lda).
template <typename T>
int launch_pair(const void* A, int lda, void* P, void* tau, void* Tm, int batch, int w,
                void* stream) {
  if (batch < 1 || w < 1 || w > kMaxW || lda < w) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = pair_setup<T>(w);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  geqrt_subpanel_kernel_pair<T><<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), lda, static_cast<T*>(P), static_cast<T*>(tau),
      static_cast<T*>(Tm), w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cqt_geqrt_batched_f32(const void* A, int lda, void* P, void* tau, void* Tm,
                                     int batch, int m, int w, int off, int kb, int resident,
                                     int nslices, void* stream) {
  return launch<float>(A, lda, P, tau, Tm, batch, m, w, off, kb, resident, nslices, stream);
}

extern "C" int cqt_geqrt_batched_f64(const void* A, int lda, void* P, void* tau, void* Tm,
                                     int batch, int m, int w, int off, int kb, int resident,
                                     int nslices, void* stream) {
  return launch<double>(A, lda, P, tau, Tm, batch, m, w, off, kb, resident, nslices, stream);
}

extern "C" int cqt_geqrt_blocked_f32(const void* A, int lda, void* P, void* tau, void* Tm,
                                     int batch, int m, int w, void* stream) {
  return launch_blocked<float>(A, lda, P, tau, Tm, batch, m, w, stream);
}

extern "C" int cqt_geqrt_pair_f32(const void* A, int lda, void* P, void* tau, void* Tm,
                                  int batch, int w, void* stream) {
  return launch_pair<float>(A, lda, P, tau, Tm, batch, w, stream);
}

extern "C" int cqt_geqrt_pair_f64(const void* A, int lda, void* P, void* tau, void* Tm,
                                  int batch, int w, void* stream) {
  return launch_pair<double>(A, lda, P, tau, Tm, batch, w, stream);
}

// CTAs of the pair body one SM holds at once at width w (the runtime's
// occupancy: threads, registers and shared memory); -1 on an error.
extern "C" int cqt_geqrt_pair_ctas_per_sm(int w, int f64) {
  if (w < 1 || w > kMaxW) return -1;
  int n = 0;
  const size_t bytes = f64 ? pair_setup<double>(w) : pair_setup<float>(w);
  const cudaError_t rc =
      bytes == 0 ? cudaErrorInvalidValue
      : f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &n, geqrt_subpanel_kernel_pair<double>, kThreads, bytes)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &n, geqrt_subpanel_kernel_pair<float>, kThreads, bytes);
  return rc == cudaSuccess ? n : -1;
}
