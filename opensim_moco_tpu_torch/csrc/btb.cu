// K1: batched factor and solve of the bordered block-tridiagonal ("btb")
// KKT matrix, float64, for sm_90a.
//
// Replaces: opensim_moco_tpu/solver/structured.py btb_factor, _t_solve and
// btb_solve (a lax.scan over the N time blocks that XLA compiled; it was
// not a Pallas kernel). The plain PyTorch versions of the same functions
// are in opensim_moco_tpu_torch/solver/structured.py.
//
// What it computes, per lane (one thread block per lane):
//   factor: S_0 = D_0, S_i = D_i - L_{i-1} S_{i-1}^{-1} L_{i-1}^T, each S_i
//           LU-factored with partial pivoting (LAPACK getrf: first index of
//           the largest |entry|, whole-row swaps, 1-based pivots, a zero
//           pivot left unscaled); then T^{-1} B by a forward and a back
//           sweep, the border Schur complement C - sum_i B_i^T (T^{-1} B)_i
//           (k x k) and its LU.
//   solve:  x = T^{-1} rhs_T by a forward sweep (y_i = rhs_i - L_{i-1}
//           S_{i-1}^{-1} y_{i-1}) and a back sweep (x_i = S_i^{-1} (y_i -
//           L_i^T x_{i+1})) with the stored factors, then the border: w =
//           Sb^{-1} (rhs_C - sum_i B_i^T x_i) and x -= (T^{-1} B) w; r
//           right-hand sides (the IPM solves one at a time).
// A singular or indefinite trial yields inf/NaN, never a fix-up: the IPM's
// regularization loop reads a non-finite step as "raise delta".
//
// What bounds the factor: the recursion over N is sequential within a
// lane, and one thread block works on a lane. At the bench's shapes (B=32,
// N=25, nb=34, k=1) it is bound by latency: its 1,038 barrier phases are
// about 2 us apart, and the dependent chain of each LU panel's columns
// (pivot search, then update) is the longest within them. At gait widths
// (nb of a few hundred, B=8) the FP64 block products on the 8 busy SMs
// weigh more.
// What the factor's design does about it:
//   - every block product (the Schur update S_i = D_i - L_{i-1} X, the
//     LU's trailing updates, the off-diagonal blocks of the triangular
//     solves) goes through one tiled routine, gemm(): 64 x 64 output
//     tiles, a 4 x 4 register micro-tile per thread, k-slices of 16 loaded
//     into registers while the previous one is multiplied and stored into
//     two alternating shared-memory buffers with padded rows (one barrier
//     a slice); operands by pointer and leading dimension;
//   - each S_i is LU-factored right-looking, blocked by 32 columns: a
//     panel's rows stay in place while it is factored (positions tracked
//     per row, the next pivot's search riding on each column's update),
//     by one warp without block barriers up to 64 rows and by the whole
//     block above that; then the row swaps, the block row U12 and the
//     trailing update by gemm();
//   - the triangular solves are blocked by 32 rows: a diagonal triangle is
//     solved with lanes over its rows and warps over the right-hand-side
//     columns, each step a shuffle (no barrier); the rest is gemm();
//   - T^{-1} B's forward sweep is folded into the recursion: step i solves
//     S_{i-1}^{-1} [L_{i-1}^T | y_{i-1}] and one product gives both S_i and
//     y_i = B_i - L_{i-1} S_{i-1}^{-1} y_{i-1}, stored in Tinv_B, where the
//     back sweep (the only sweep left after the recursion) reads it;
//   - no division or remainder by a runtime value in any inner loop (2-D
//     thread indexing, constant shifts, reciprocals);
//   - the memory mode is a template parameter, so that the compiler knows
//     which pointers are shared memory. The Schur block and the
//     right-hand sides X stay in shared memory while both fit (nb up to
//     about 110), rows padded to an odd number of doubles; otherwise S
//     lives in its slot of S_lu and X in a per-lane scratch in device
//     memory (the lane's working set, about 1.6 MB at nb = 200, stays in
//     L2), and panels, triangles and blocks of X are staged through shared
//     memory. That staging (a panel of nb x 33 doubles) bounds the width:
//     nb up to 738 for k up to 23 (btb_factor_smem_bytes against the 227
//     KB a block may have); ops/btb.py raises above it.
// What bounds the solve: the same sequential recursion with far less work
// a block (one right-hand side on the IPM's path: matrix-vector products),
// so latency: the first design took a block-wide barrier per elimination
// row, 3,434 barrier phases per solve at the bench shape (B=32, N=25,
// nb=34, k=1, r=1; 1.19 ms on an H100). Measured per phase with clock64
// (an instrumented build, not kept), the cost is not the barriers: it is
// each phase's dependent device-memory reads and its instruction count.
// What the solve's design does about it: two kernels, chosen by shape.
//   - wide (any r, any nb): per diagonal block the factor's lu_solve (32-row
//     triangles staged in shared memory and solved by shuffles, the rest by
//     gemm()); the sweep products by gemm(), the back sweep's L_i^T x_{i+1}
//     as x_{i+1}^T L_i so that L_i is read coalesced; each y_i goes to x_i
//     in the forward product's epilogue and waits there for the back sweep.
//   - narrow (r <= 8 and nb, k <= 64, the IPM's case): each step first
//     stages S_i's LU, its pivots, the L block and the next right-hand
//     sides into shared memory with all of a thread's loads issued before
//     its stores (one wait for device memory a step); then one warp per
//     column solves the block in registers (swaps and substitutions by
//     shuffles, no block barrier); then the product with L, a group of
//     lanes per output row. Three barrier phases a step, 149 per solve at
//     the bench shape, 0.29 ms.
//   - both: the border's k x k solve by the same block solve; no division
//     or remainder by a runtime value in an inner loop.
// Left for later: FP64 tensor cores (mma.sync m8n8k4, 67 TFLOP/s against
// 34 on the CUDA cores) in gemm(); more than one thread block per lane
// when B is small and nb large; a shorter per-column chain in the panels;
// in the solve, the next step's blocks staged while this one is solved
// (cp.async), and the narrow kernel's staging for nb above 64.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 64;               // gemm output tile edge
constexpr int kSlice = 16;              // gemm k-slice
constexpr int kTilePad = kTile + 1;     // padded tile row (doubles)
constexpr int kTileDoubles = 4 * kSlice * kTilePad;  // gemm's 2 x (A, B)
constexpr int kTri = 32;                // triangle edge of the blocked solves

// Doubles of the device-memory mode's panel buffer: the LU's panels (m x
// 33), a 32-row block of the triangle solves' right-hand sides (32 x (nb +
// k)), the back sweep's block (nb x k).
__host__ __device__ constexpr size_t panel_doubles(int nb, int k) {
  const size_t mx = nb > k ? nb : k;
  const size_t a = mx * (kTri + 1), b = (size_t)kTri * (nb + k),
               c = (size_t)nb * k;
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;  // complete in lane 0
}

// ---- the factor's building blocks

// out(r, c) = acc: C -= A B into a matrix of leading dimension ldc.
struct SubEpi {
  double* C;
  int ldc;
  __device__ void operator()(int r, int c, double acc) const {
    C[(size_t)r * ldc + c] -= acc;
  }
};

// The Schur step's product L_{i-1} [X | Z]: columns below nb give
// S_i = D_i - L X, the k columns above give y_i = B_i - L Z.
struct SchurEpi {
  double* S;
  int lds;
  const double* D;
  double* Y;
  const double* Bi;
  int nb, k;
  __device__ void operator()(int r, int c, double acc) const {
    if (c < nb)
      S[(size_t)r * lds + c] = D[(size_t)r * nb + c] - acc;
    else
      Y[(size_t)r * k + c - nb] = Bi[(size_t)r * k + c - nb] - acc;
  }
};

// epi(r, c, (A B)[r][c]) for every element of the m x n product (kk >= 1),
// A (m x kk) at A[r * lda + j], B (kk x n) at B[j * ldb + c]. Each 64 x 64
// output tile takes the whole block: thread (ty, tx) = (tid / 16, tid %
// 16) keeps the 4 x 4 micro-tile of rows ty + 16 i and columns tx + 16 j in
// registers. The k-slices of 16 of both operands go through registers (the
// next slice is loaded while the current one is multiplied) into two
// alternating shared-memory buffers (`tiles`, kTileDoubles), so each slice
// costs one barrier; ragged edges read as zeros. The output must not
// overlap the operands. Every thread calls it; it ends with a barrier.
template <class Epi>
__device__ __forceinline__ void gemm(int m, int n, int kk, const double* A,
                                     int lda, const double* B, int ldb,
                                     double* tiles, const Epi& epi) {
  constexpr int kLoads = kTile * kSlice / kThreads;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  double ra[kLoads], rb[kLoads];
  auto load = [&](int r0, int c0, int j0) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = tid + q * kThreads;
      // both coalesced: A along j, B along c
      const int gr = r0 + (e >> 4), gj = j0 + (e & (kSlice - 1));
      ra[q] = (gr < m && gj < kk) ? A[(size_t)gr * lda + gj] : 0.0;
      const int gc = c0 + (e & (kTile - 1)), gb = j0 + (e >> 6);
      rb[q] = (gc < n && gb < kk) ? B[(size_t)gb * ldb + gc] : 0.0;
    }
  };
  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[i][l] = 0.0;
  int r0 = 0, c0 = 0, j0 = 0, buf = 0;
  load(r0, c0, j0);
  while (r0 < m) {
    double* As = tiles + buf * 2 * kSlice * kTilePad;  // As[j][r]
    double* Bs = As + kSlice * kTilePad;               // Bs[j][c]
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = tid + q * kThreads;
      As[(e & (kSlice - 1)) * kTilePad + (e >> 4)] = ra[q];
      Bs[(e >> 6) * kTilePad + (e & (kTile - 1))] = rb[q];
    }
    __syncthreads();
    // the next (tile, slice), loaded while this one is multiplied
    int nr0 = r0, nc0 = c0, nj0 = j0 + kSlice;
    const bool tile_done = nj0 >= kk;
    if (tile_done) {
      nj0 = 0;
      nc0 += kTile;
      if (nc0 >= n) {
        nc0 = 0;
        nr0 += kTile;
      }
    }
    if (nr0 < m) load(nr0, nc0, nj0);
#pragma unroll
    for (int j = 0; j < kSlice; ++j) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[j * kTilePad + ty + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = Bs[j * kTilePad + tx + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[i][l] = fma(a[i], b[l], acc[i][l]);
    }
    if (tile_done) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty + 16 * i;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int c = c0 + tx + 16 * l;
          if (r < m && c < n) epi(r, c, acc[i][l]);
          acc[i][l] = 0.0;
        }
      }
    }
    r0 = nr0;
    c0 = nc0;
    j0 = nj0;
    buf ^= 1;
  }
  __syncthreads();
}

// dst (rows x cols, leading dimension ldd) <- src (leading dimension lds):
// warps over rows, lanes over columns.
__device__ __forceinline__ void copy_block(double* dst, int ldd,
                                           const double* src, int lds, int rows,
                                           int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps)
    for (int c = lane; c < cols; c += 32)
      dst[(size_t)r * ldd + c] = src[(size_t)r * lds + c];
}

// X (jw x w, leading dimension ldx) <- T^{-1} X for the jw x jw (jw <=
// 32) diagonal triangle T (leading dimension ldt) of an LU: unit lower, or
// upper with its diagonal (each lane holds the reciprocal of its row's).
// Lane r of a warp holds row r of kCols columns at a time (columns warp +
// 8 q); each elimination step broadcasts the finished row by a shuffle, so
// the triangle takes no barrier. With kStageT (kStageX), T (X) lies in
// device memory and is first copied to `t_stage` (32 x 33 doubles of
// shared memory; `x_stage`, 32 x w doubles), and X is copied back. The
// caller ends the phase with a barrier.
template <bool Upper, bool kStageT, bool kStageX>
__device__ __forceinline__ void trsm_diag(const double* T, int ldt, int jw,
                                          double* X, int ldx, int w,
                                          double* t_stage, double* x_stage) {
  constexpr int kCols = 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* Xg = X;
  const int ldg = ldx;
  if (kStageT) {
    copy_block(t_stage, kTri + 1, T, ldt, jw, jw);
    T = t_stage;
    ldt = kTri + 1;
  }
  if (kStageX) {
    copy_block(x_stage, w, X, ldx, jw, w);
    X = x_stage;
    ldx = w;
  }
  if (kStageT || kStageX) __syncthreads();
  const bool row_in = lane < jw;
  const double rdiag =
      Upper && row_in ? 1.0 / T[(size_t)lane * ldt + lane] : 0.0;
  for (int c0 = warp; c0 < w; c0 += kCols * kWarps) {
    double x[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int c = c0 + q * kWarps;
      x[q] = row_in && c < w ? X[(size_t)lane * ldx + c] : 0.0;
    }
    if (Upper) {
#pragma unroll 4
      for (int j = jw - 1; j >= 0; --j) {
        const double t = lane < j ? T[(size_t)lane * ldt + j] : 0.0;
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          if (c0 + q * kWarps >= w) break;  // warp-uniform
          if (lane == j) x[q] *= rdiag;
          const double xj = __shfl_sync(kFull, x[q], j);
          if (lane < j) x[q] -= t * xj;
        }
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < jw; ++j) {
        const double t = lane > j && row_in ? T[(size_t)lane * ldt + j] : 0.0;
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          if (c0 + q * kWarps >= w) break;  // warp-uniform
          const double xj = __shfl_sync(kFull, x[q], j);
          if (lane > j) x[q] -= t * xj;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int c = c0 + q * kWarps;
      if (row_in && c < w) X[(size_t)lane * ldx + c] = x[q];
    }
  }
  if (kStageX) {
    __syncthreads();
    copy_block(Xg, ldg, x_stage, w, jw, w);
  }
}

// X (n x w, leading dimension ldx) <- A^{-1} X for A = P L U as lu_factor
// stores it (leading dimension lda, 1-based pivots piv, copied to piv_s, n
// ints of shared memory): the row swaps (one thread per column), then
// forward and back substitution blocked by 32 rows, diagonal triangles by
// trsm_diag (kStageT, kStageX, t_stage and x_stage as there) and the rest
// by gemm. Every thread calls it; it ends with a barrier.
template <bool kStageT, bool kStageX>
__device__ __forceinline__ void lu_solve(const double* LU, int lda,
                                         const int* piv, int n, double* X,
                                         int ldx, int w, double* tiles,
                                         double* t_stage, double* x_stage,
                                         int* piv_s) {
  for (int j = threadIdx.x; j < n; j += kThreads) piv_s[j] = piv[j] - 1;
  __syncthreads();
  for (int c = threadIdx.x; c < w; c += kThreads) {
    for (int j = 0; j < n; ++j) {
      const int p = piv_s[j];
      if (p != j) {
        const double t = X[(size_t)j * ldx + c];
        X[(size_t)j * ldx + c] = X[(size_t)p * ldx + c];
        X[(size_t)p * ldx + c] = t;
      }
    }
  }
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += kTri) {
    const int jw = min(kTri, n - j0);
    trsm_diag<false, kStageT, kStageX>(LU + (size_t)j0 * lda + j0, lda, jw,
                     X + (size_t)j0 * ldx, ldx, w, t_stage, x_stage);
    __syncthreads();
    if (j0 + jw < n)
      gemm(n - j0 - jw, w, jw, LU + (size_t)(j0 + jw) * lda + j0, lda,
           X + (size_t)j0 * ldx, ldx, tiles,
           SubEpi{X + (size_t)(j0 + jw) * ldx, ldx});
  }
  for (int j0 = (n - 1) / kTri * kTri; j0 >= 0; j0 -= kTri) {
    const int jw = min(kTri, n - j0);
    trsm_diag<true, kStageT, kStageX>(LU + (size_t)j0 * lda + j0, lda, jw,
                    X + (size_t)j0 * ldx, ldx, w, t_stage, x_stage);
    __syncthreads();
    if (j0 > 0)
      gemm(j0, w, jw, LU + j0, lda, X + (size_t)j0 * ldx, ldx, tiles,
           SubEpi{X, ldx});
  }
}

// The largest |entry| first, the smallest position on a tie; NaN ranks
// below every number, so an all-NaN column keeps the row at its position.
struct Pivot {
  double v;
  int pos, row;
  __device__ void offer(double x, int p, int r) {
    double a = fabs(x);
    if (a != a) a = -0.5;
    if (a > v || (a == v && p < pos)) {
      v = a;
      pos = p;
      row = r;
    }
  }
  __device__ void offer(const Pivot& o) {
    if (o.v > v || (o.v == v && o.pos < pos)) *this = o;
  }
  __device__ void warp_reduce() {  // the warp's best, in every lane
    for (int o = 16; o > 0; o >>= 1) {
      Pivot other;
      other.v = __shfl_xor_sync(kFull, v, o);
      other.pos = __shfl_xor_sync(kFull, pos, o);
      other.row = __shfl_xor_sync(kFull, row, o);
      offer(other);
    }
  }
};

__device__ __forceinline__ Pivot no_pivot() { return Pivot{-1.0, 1 << 30, -1}; }

// Partial-pivoting LU of the m x pw panel P (leading dimension ldp, pw <=
// 32) whose first row and column are at position p0 of the whole matrix;
// piv[j] gets the 1-based pivot position of column j, piv_s[j] (shared
// memory) the 0-based one. The rows stay where they are: each row's
// position is kept in pos[r] by the thread that owns the row, each
// column's pivot row is read in place (into registers: read through P,
// it would wait for every store to the updated rows), and the other
// unpivoted rows are scaled and updated by their owners. The search for
// the next column's pivot rides on that update. The caller applies the
// swaps. Two layouts, by the panel's height (both measured on the card):
// up to 64 rows one warp owns them (rows lane + 32 q) and a column costs
// a warp reduction and no block barrier; above that every thread owns
// rows tid + 256 q and a column costs a warp reduction, one candidate per
// warp in shared memory and one barrier. Every thread calls it; it ends
// with a barrier.
__device__ __forceinline__ void lu_panel(double* P, int ldp, int m, int pw,
                                         int p0, int* piv, int* piv_s,
                                         int* pos) {
  __shared__ Pivot s_cand[2][kWarps];
  const bool one_warp = m <= 64;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = one_warp ? 32 : kThreads;
  if (one_warp && warp > 0) {
    __syncthreads();
    return;
  }
  Pivot cand = no_pivot();
  for (int r = tid; r < m; r += nthreads) {
    pos[r] = r;
    cand.offer(P[(size_t)r * ldp], r, r);
  }
  cand.warp_reduce();
  if (!one_warp) {
    if (lane == 0) s_cand[0][warp] = cand;
    __syncthreads();
  }
  for (int j = 0; j < pw; ++j) {
    const int cur = j & 1;
    Pivot pv = cand;
    if (!one_warp) {
      Pivot c[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c[w] = s_cand[cur][w];
      pv = c[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) pv.offer(c[w]);
    }
    if (tid == 0) {
      piv[j] = p0 + pv.pos + 1;
      piv_s[j] = p0 + pv.pos;
    }
    if (one_warp) __syncwarp();  // the pivot row's last update is seen
    // the multipliers as LAPACK getf2 forms them, a * (1 / akk); since
    // |a| <= |akk|, a subnormal pivot and its column are first scaled by
    // 2^64, which keeps the reciprocal finite and needs no division
    const double* u = P + (size_t)pv.row * ldp;
    const double akk = u[j];
    const double scale =
        fabs(akk) < 2.2250738585072014e-308 ? 18446744073709551616.0 : 1.0;
    const double rinv = __drcp_rn(akk * scale);
    double ur[kTri];
#pragma unroll
    for (int c = 0; c < kTri; ++c) ur[c] = c > j && c < pw ? u[c] : 0.0;
    cand = no_pivot();
    for (int r = tid; r < m; r += nthreads) {
      const int pr = pos[r];
      if (r == pv.row) {
        pos[r] = j;
        continue;
      }
      if (pr < j) continue;  // pivoted in an earlier column
      const int np = pr == j ? pv.pos : pr;  // the row at position j moves
      pos[r] = np;
      double* row = P + (size_t)r * ldp;
      double l = row[j];
      if (akk != 0.0) l = l * scale * rinv;
      row[j] = l;
#pragma unroll
      for (int c = 1; c < kTri; ++c)
        if (c > j && c < pw) row[c] -= l * ur[c];
      if (j + 1 < pw) cand.offer(row[j + 1], np, r);
    }
    cand.warp_reduce();
    if (!one_warp) {
      if (lane == 0) s_cand[cur ^ 1][warp] = cand;
      __syncthreads();
    }
  }
  if (one_warp) __syncthreads();
}

// In-place LU with partial pivoting (LAPACK getrf) of the n x n matrix A
// (leading dimension lda), right-looking and blocked by 32 columns: each
// panel by lu_panel, its row swaps applied across the whole rows (one
// thread per column), the block row U12 by trsm_diag and the trailing
// update A22 -= L21 U12 by gemm. With kStage (A in device memory) each
// panel is staged through `panel` (33 doubles a row), which then also
// stages U12, and the triangle goes through `tiles`. piv gets 1-based
// pivot rows; pos holds n + 32 ints (row positions, then the panel's
// pivots). Every thread calls it; it ends with a barrier.
template <bool kStage>
__device__ __forceinline__ void lu_factor(double* A, int lda, int n, int* piv,
                                          int* pos, double* panel,
                                          double* tiles) {
  for (int p0 = 0; p0 < n; p0 += kTri) {
    const int pw = min(kTri, n - p0), m = n - p0;
    double* A11 = A + (size_t)p0 * lda + p0;
    if (kStage) {
      copy_block(panel, kTri + 1, A11, lda, m, pw);
      __syncthreads();
      lu_panel(panel, kTri + 1, m, pw, p0, piv + p0, pos + n, pos);
      copy_block(A11, lda, panel, kTri + 1, m, pw);
      __syncthreads();
    } else {
      lu_panel(A11, lda, m, pw, p0, piv + p0, pos + n, pos);
    }
    // the panel's rows are still where they were: swap whole rows in order
    for (int c = threadIdx.x; c < n; c += kThreads) {
      for (int j = p0; j < p0 + pw; ++j) {
        const int p = pos[n + j - p0];
        if (p != j) {
          const double t = A[(size_t)j * lda + c];
          A[(size_t)j * lda + c] = A[(size_t)p * lda + c];
          A[(size_t)p * lda + c] = t;
        }
      }
    }
    __syncthreads();
    if (pw < m) {
      trsm_diag<false, kStage, kStage>(A11, lda, pw, A11 + pw, lda, m - pw,
                                       tiles, panel);
      __syncthreads();
      gemm(m - pw, m - pw, pw, A11 + (size_t)pw * lda, lda, A11 + pw, lda,
           tiles, SubEpi{A11 + (size_t)pw * lda + pw, lda});
    }
  }
}

// X[:, :n] (leading dimension ldx) <- L^T for the n x n row-major L. Into
// shared memory directly (reads coalesced, odd ldx keeps the column writes
// free of bank conflicts); into device memory through a 32 x 33 tile in
// `tiles`, so that both sides are coalesced.
template <bool kShared>
__device__ __forceinline__ void transpose_in(double* X, int ldx,
                                             const double* L, int n,
                                             double* tiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (kShared) {
    for (int c = warp; c < n; c += kWarps)
      for (int r = lane; r < n; r += 32)
        X[(size_t)r * ldx + c] = L[(size_t)c * n + r];
    return;
  }
  for (int c0 = 0; c0 < n; c0 += 32) {
    for (int r0 = 0; r0 < n; r0 += 32) {
      for (int c = warp; c < 32; c += kWarps)
        if (c0 + c < n && r0 + lane < n)
          tiles[c * 33 + lane] = L[(size_t)(c0 + c) * n + r0 + lane];
      __syncthreads();
      for (int r = warp; r < 32; r += kWarps)
        if (r0 + r < n && c0 + lane < n)
          X[(size_t)(r0 + r) * ldx + c0 + lane] = tiles[lane * 33 + r];
      __syncthreads();
    }
  }
}

// kSmem: the shared-memory mode (a template parameter, so that the
// compiler knows each pointer's memory and emits shared-memory loads).
// (__launch_bounds__'s 1: at most one block per SM, so that ptxas does not
// cap the registers at 128 to fit two, which spills.)
template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
btb_factor_kernel(const double* __restrict__ D, const double* __restrict__ L,
                  const double* __restrict__ Bm, const double* __restrict__ C,
                  double* S_lu, int* S_piv, double* Tinv_B, double* Sb_lu,
                  int* Sb_piv, double* scratch, int N, int nb, int k) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  const size_t bsz = (size_t)nb * nb;
  const int w = nb + k;  // columns of [L^T | y]
  D += b * N * bsz;
  L += b * (N - 1) * bsz;
  Bm += b * N * nb * k;
  C += b * k * k;
  S_lu += b * N * bsz;
  S_piv += b * N * nb;
  Tinv_B += b * N * nb * k;
  Sb_lu += b * k * k;
  Sb_piv += b * k;

  // shared memory (btb_factor_smem_bytes): gemm's tiles; then either Sw,
  // the Schur block being formed and factored, and X, S_{i-1}^{-1}
  // [L_{i-1}^T | y_{i-1}], with odd leading dimensions (shared-memory mode)
  // or `panel` (device-memory mode: S in S_lu, X in scratch), the LU's
  // panel buffer, which also stages the triangle solves' blocks of X; then
  // the LU's row positions. xs holds the back sweep's block of T^{-1} B.
  double* tiles = smem;
  const int lds = kSmem ? (nb | 1) : nb;
  const int ldx = kSmem ? (w | 1) : w;
  double* Sw = smem + kTileDoubles;
  double* X = kSmem ? Sw + (size_t)nb * lds : scratch + b * nb * w;
  double* panel = Sw;  // device-memory mode only
  int* pos = reinterpret_cast<int*>(
      kSmem ? X + (size_t)nb * ldx : panel + panel_doubles(nb, k));
  double* xs = kSmem ? X : panel;

  for (int i = 0; i < N; ++i) {
    double* Sg = S_lu + i * bsz;
    double* S = kSmem ? Sw : Sg;
    const double* Di = D + i * bsz;
    double* Yi = Tinv_B + (size_t)i * nb * k;
    if (i == 0) {
      copy_block(S, lds, Di, nb, nb, nb);
      copy_block(Yi, k, Bm, k, nb, k);
      __syncthreads();
    } else {
      const double* Lp = L + (i - 1) * bsz;
      const double* P = kSmem ? Sw : S_lu + (i - 1) * bsz;
      transpose_in<kSmem>(X, ldx, Lp, nb, tiles);
      copy_block(X + nb, ldx, Yi - (size_t)nb * k, k, nb, k);
      __syncthreads();
      lu_solve<!kSmem, !kSmem>(P, lds, S_piv + (size_t)(i - 1) * nb, nb, X,
                               ldx, w, tiles, tiles, panel, pos);
      // in shared-memory mode S overwrites P, which lu_solve has finished
      gemm(nb, w, nb, Lp, nb, X, ldx, tiles,
           SchurEpi{S, lds, Di, Yi, Bm + (size_t)i * nb * k, nb, k});
    }
    lu_factor<!kSmem>(S, lds, nb, S_piv + (size_t)i * nb, pos, panel, tiles);
    if (kSmem) {
      copy_block(Sg, nb, S, lds, nb, nb);
      __syncthreads();
    }
  }
  if (k == 0) return;

  // back sweep: x_i = S_i^{-1} (y_i - L_i^T x_{i+1}), in xs, then to Tinv_B;
  // L_i^T x_{i+1} (k columns) one output row per thread, L read coalesced
  for (int i = N - 1; i >= 0; --i) {
    double* xi = Tinv_B + (size_t)i * nb * k;
    const double* Li = L + i * bsz;
    const double* xn = xi + (size_t)nb * k;
    for (int r = tid; r < nb; r += kThreads) {
      for (int q = 0; q < k; ++q) {
        double acc = 0.0;
        if (i + 1 < N)
          for (int j = 0; j < nb; ++j)
            acc = fma(Li[(size_t)j * nb + r], xn[(size_t)j * k + q], acc);
        xs[(size_t)r * k + q] = xi[(size_t)r * k + q] - acc;
      }
    }
    __syncthreads();
    lu_solve<true, false>(S_lu + i * bsz, nb, S_piv + (size_t)i * nb, nb, xs,
                          k, k, tiles, tiles, nullptr, pos);
    copy_block(xi, k, xs, k, nb, k);
    __syncthreads();
  }
  for (int p = warp; p < k; p += kWarps) {  // C - sum_i B_i^T (T^-1 B)_i
    for (int q = 0; q < k; ++q) {
      double s = 0.0;
      for (int t = lane; t < N * nb; t += 32)
        s += Bm[(size_t)t * k + p] * Tinv_B[(size_t)t * k + q];
      s = warp_sum(s);
      if (lane == 0) Sb_lu[p * k + q] = C[p * k + q] - s;
    }
  }
  __syncthreads();
  lu_factor<false>(Sb_lu, k, k, Sb_piv, pos, nullptr, tiles);  // in place
}

// ---- the solve kernel: blocked substitutions from the factor's routines

// The forward sweep's product L_{i-1} (S_{i-1}^{-1} y_{i-1}): y_i = rhs_i -
// acc, into the next buffer of right-hand sides (shared memory) and into
// x_i, where the back sweep reads it.
struct FwdEpi {
  double* Yn;
  double* Xi;
  const double* Ri;
  int r;
  __device__ void operator()(int row, int c, double acc) const {
    const size_t e = (size_t)row * r + c;
    const double y = Ri[e] - acc;
    Yn[e] = y;
    Xi[e] = y;
  }
};

// The back sweep's product x_{i+1}^T L_i (r x nb), transposed on the way
// out: Y[c][q] = y_i[c][q] - (L_i^T x_{i+1})[c][q].
struct BackEpi {
  double* Y;
  const double* Yi;
  int r;
  __device__ void operator()(int q, int c, double acc) const {
    const size_t e = (size_t)c * r + q;
    Y[e] = Yi[e] - acc;
  }
};

// The border's right-hand side ws = rhs_C - sum_i B_i^T x_i (k x r) from
// x (rows = N nb rows of r columns, stored and behind a barrier): warps
// over ws's rows, lanes over x's rows. No barrier.
__device__ __forceinline__ void border_rhs(const double* Bm,
                                           const double* rhs_C,
                                           const double* x, double* ws,
                                           int rows, int k, int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < k; p += kWarps) {
    for (int c = 0; c < r; ++c) {
      double s = 0.0;
      for (int t = lane; t < rows; t += 32)
        s = fma(Bm[(size_t)t * k + p], x[(size_t)t * r + c], s);
      s = warp_sum(s);
      if (lane == 0) ws[p * r + c] = rhs_C[p * r + c] - s;
    }
  }
}

// After the border's solve (ws = w, behind a barrier): w out, and x -=
// (T^{-1} B) w, one row of x per thread. No barrier.
__device__ __forceinline__ void border_update(const double* Tinv_B,
                                              const double* ws, double* x,
                                              double* w, int rows, int k,
                                              int r) {
  const int tid = threadIdx.x;
  for (int e = tid; e < k * r; e += kThreads) w[e] = ws[e];
  for (int t = tid; t < rows; t += kThreads) {
    for (int c = 0; c < r; ++c) {
      double acc = 0.0;
      for (int q = 0; q < k; ++q)
        acc = fma(Tinv_B[(size_t)t * k + q], ws[q * r + c], acc);
      x[(size_t)t * r + c] -= acc;
    }
  }
}

// (__launch_bounds__'s 1 as for the factor: gemm()'s register tile.)
__global__ void __launch_bounds__(kThreads, 1)
btb_solve_kernel(const double* __restrict__ S_lu, const int* __restrict__ S_piv,
                 const double* __restrict__ L, const double* __restrict__ Bm,
                 const double* __restrict__ Tinv_B,
                 const double* __restrict__ Sb_lu,
                 const int* __restrict__ Sb_piv,
                 const double* __restrict__ rhs_T,
                 const double* __restrict__ rhs_C, double* x, double* w,
                 int N, int nb, int k, int r) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const size_t bsz = (size_t)nb * nb;
  S_lu += b * N * bsz;
  S_piv += b * N * nb;
  L += b * (N - 1) * bsz;
  Bm += b * N * nb * k;
  Tinv_B += b * N * nb * k;
  Sb_lu += b * k * k;
  Sb_piv += b * k;
  rhs_T += b * N * nb * r;
  rhs_C += b * k * r;
  x += b * N * nb * r;
  w += b * k * r;

  // shared memory (btb_solve_smem_bytes): gemm's tiles; two nb x r buffers
  // of right-hand sides, Ya the block under solution and Yb the next one
  // (forward) or x_{i+1}^T (back); the border's k x r block; the pivots
  const int nr = nb * r;
  double* tiles = smem;
  double* Ya = smem + kTileDoubles;
  double* Yb = Ya + nr;
  double* ws = Yb + nr;
  int* piv_s = reinterpret_cast<int*>(ws + (size_t)k * r);

  // forward sweep: y_0 = rhs_0, y_i = rhs_i - L_{i-1} S_{i-1}^{-1} y_{i-1};
  // each y_i also goes to x_i. (lu_solve's first barrier comes before it
  // reads Ya.)
  for (int e = tid; e < nr; e += kThreads) {
    const double v = rhs_T[e];
    Ya[e] = v;
    x[e] = v;
  }
  for (int i = 1; i < N; ++i) {
    lu_solve<true, false>(S_lu + (i - 1) * bsz, nb,
                          S_piv + (size_t)(i - 1) * nb, nb, Ya, r, r, tiles,
                          tiles, nullptr, piv_s);
    gemm(nb, r, nb, L + (i - 1) * bsz, nb, Ya, r, tiles,
         FwdEpi{Yb, x + (size_t)i * nr, rhs_T + (size_t)i * nr, r});
    double* t = Ya;
    Ya = Yb;
    Yb = t;
  }
  // back sweep: x_i = S_i^{-1} (y_i - L_i^T x_{i+1}), Ya holding y_{N-1};
  // the product reads x_{i+1}^T from Yb and L_i coalesced
  for (int i = N - 1; i >= 0; --i) {
    double* xi = x + (size_t)i * nr;
    if (i + 1 < N)
      gemm(r, nb, nb, Yb, nb, L + i * bsz, nb, tiles, BackEpi{Ya, xi, r});
    lu_solve<true, false>(S_lu + i * bsz, nb, S_piv + (size_t)i * nb, nb,
                          Ya, r, r, tiles, tiles, nullptr, piv_s);
    for (int e = tid; e < nr; e += kThreads) xi[e] = Ya[e];
    if (i > 0)
      for (int q = 0; q < r; ++q)
        for (int j = tid; j < nb; j += kThreads)
          Yb[(size_t)q * nb + j] = Ya[(size_t)j * r + q];
    __syncthreads();
  }
  if (k == 0) return;
  border_rhs(Bm, rhs_C, x, ws, N * nb, k, r);
  lu_solve<false, false>(Sb_lu, k, Sb_piv, k, ws, r, r, tiles, nullptr,
                         nullptr, piv_s);  // its first barrier: ws is whole
  border_update(Tinv_B, ws, x, w, N * nb, k, r);
}

// ---- the solve's narrow kernel: few right-hand sides, narrow blocks

constexpr int kNarrow = 8;       // the most right-hand sides it takes
constexpr int kNarrowRows = 64;  // the widest block (and border) it takes
// a block's right-hand sides, nb x r, as elements a thread
constexpr int kRhsPerThread = kNarrowRows * kNarrow / kThreads;

// What a thread of the narrow solve stages: the elements tid + 256 t of
// an nb x nb block, their row and column advancing by the constant steps
// (256 / nb, 256 % nb), divided out once per launch.
struct StageMap {
  int row0, col0, q, rm;
  __device__ StageMap(int nb)
      : row0(threadIdx.x / nb), col0(threadIdx.x % nb), q(kThreads / nb),
        rm(kThreads % nb) {}
};

// d1 <- s1 and, when s2 is not null, d2 <- s2: contiguous nb x nb blocks
// in device memory into shared memory with leading dimension ldd. Eight
// elements of each block at a time, all their loads issued before their
// stores, so that a step waits for device memory about once. No barrier.
__device__ __forceinline__ void stage_blocks(double* d1,
                                             const double* __restrict__ s1,
                                             double* d2,
                                             const double* __restrict__ s2,
                                             int nb, int ldd,
                                             const StageMap& sm) {
  constexpr int kChunk = 8;
  const int total = nb * nb;
  int row = sm.row0, col = sm.col0;
  for (int e0 = threadIdx.x; e0 < total; e0 += kChunk * kThreads) {
    double a[kChunk], b[kChunk];
    int at[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const int e = e0 + t * kThreads;
      const bool in = e < total;
      at[t] = in ? row * ldd + col : -1;
      a[t] = in ? s1[e] : 0.0;
      b[t] = in && s2 != nullptr ? s2[e] : 0.0;
      col += sm.rm;
      row += sm.q;
      if (col >= nb) {
        col -= nb;
        ++row;
      }
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (at[t] >= 0) {
        d1[at[t]] = a[t];
        if (s2 != nullptr) d2[at[t]] = b[t];
      }
    }
  }
}

// epi(row, c, (A X)[row][c]) for row < m and c < n <= kNarrow, A[row][j] at
// A[row * rs + j * cs] ((rs, cs) = (lda, 1) for A, (1, lda) for A^T), X
// (kk x n, leading dimension ldx), both in shared memory. A group of g
// lanes (a power of two up to 32: the most that still gives every row its
// group in one pass of the block) shares an output row: each lane sums
// every g-th term and the group adds its sums by shuffles, so the
// dependent chain is kk / g fma's and log2 g shuffles. No barrier.
template <class Epi>
__device__ __forceinline__ void gemm_rows(int m, int n, int kk,
                                          const double* A, int rs, int cs,
                                          const double* X, int ldx,
                                          const Epi& epi) {
  int lg = 5;  // log2 g
  while (lg > 0 && (kThreads >> lg) < m) --lg;
  const int g = 1 << lg;
  const int sub = threadIdx.x & (g - 1);
  for (int base = 0; base < m; base += kThreads >> lg) {  // block-uniform
    const int row = base + (threadIdx.x >> lg);
    const double* a = A + (size_t)row * rs;
    double acc[kNarrow];
#pragma unroll
    for (int c = 0; c < kNarrow; ++c) acc[c] = 0.0;
    if (row < m) {
#pragma unroll 4
      for (int j = sub; j < kk; j += g) {
        const double v = a[(size_t)j * cs];
        const double* xj = X + (size_t)j * ldx;
#pragma unroll
        for (int c = 0; c < kNarrow; ++c)
          if (c < n) acc[c] = fma(v, xj[c], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kNarrow; ++c) {
      if (c < n) {  // uniform: every lane takes part in the shuffles
        for (int o = g >> 1; o > 0; o >>= 1)
          acc[c] += __shfl_xor_sync(kFull, acc[c], o);
        if (row < m && sub == 0) epi(row, c, acc[c]);
      }
    }
  }
}

// X (n x w, n <= kNarrowRows, w <= kNarrow, leading dimension w) <- A^{-1}
// X for A = P L U as lu_factor stores it (leading dimension lda; in shared
// memory, or in device memory for the border's block), with the 0-based
// pivots piv_s that the caller put in shared memory before a barrier. One
// warp per column and no block barrier: lane l holds rows l and l + 32 in
// registers; each swap is two shuffles, each substitution step one
// shuffle and two fma's, with no branch (a row that the step does not
// change subtracts 0 x_j); the upper triangle is first made unit (each
// lane scales its rows by the reciprocals of their diagonal entries). The
// caller ends the phase with a barrier.
__device__ __forceinline__ void lu_solve_warp(const double* LU, int lda,
                                              const int* piv_s, int n,
                                              double* X, int w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= w) return;  // warp-uniform
  const int r1 = lane + 32;
  const bool in0 = lane < n, in1 = r1 < n;
  double x0 = in0 ? X[(size_t)lane * w + warp] : 0.0;
  double x1 = in1 ? X[(size_t)r1 * w + warp] : 0.0;
  auto row = [&](int j) {  // row j's value, in every lane (j uniform)
    return __shfl_sync(kFull, j < 32 ? x0 : x1, j & 31);
  };
  for (int j = 0; j < n; ++j) {
    const int p = piv_s[j];
    if (p != j) {  // uniform
      const double vj = row(j), vp = row(p);
      if (lane == (j & 31)) {
        if (j < 32) x0 = vp; else x1 = vp;
      }
      if (lane == (p & 31)) {
        if (p < 32) x0 = vj; else x1 = vj;
      }
    }
  }
  const double* t0 = LU + (size_t)lane * lda;
  const double* t1 = LU + (size_t)r1 * lda;
#pragma unroll 4
  for (int j = 0; j + 1 < n; ++j) {  // unit lower
    const double a0 = lane > j && in0 ? t0[j] : 0.0;
    const double a1 = r1 > j && in1 ? t1[j] : 0.0;
    const double xj = row(j);
    x0 = fma(-a0, xj, x0);
    x1 = fma(-a1, xj, x1);
  }
  const double rd0 = in0 ? 1.0 / t0[lane] : 0.0;
  const double rd1 = in1 ? 1.0 / t1[r1] : 0.0;
  x0 *= rd0;
  x1 *= rd1;
#pragma unroll 4
  for (int j = n - 1; j > 0; --j) {  // upper, made unit
    const double a0 = lane < j ? t0[j] * rd0 : 0.0;
    const double a1 = r1 < j ? t1[j] * rd1 : 0.0;
    const double xj = row(j);
    x0 = fma(-a0, xj, x0);
    x1 = fma(-a1, xj, x1);
  }
  if (in0) X[(size_t)lane * w + warp] = x0;
  if (in1) X[(size_t)r1 * w + warp] = x1;
}

// The solve for r <= kNarrow right-hand sides and nb, k <= kNarrowRows.
// Each step first stages what it reads (S_i's LU and pivots, the L block,
// the next right-hand sides) in one phase, so that a step waits for device
// memory once; then one warp per column solves the block (lu_solve_warp),
// and the product with L takes every thread. Three barrier phases a step.
__global__ void __launch_bounds__(kThreads, 1)
btb_solve_narrow_kernel(const double* __restrict__ S_lu,
                        const int* __restrict__ S_piv,
                        const double* __restrict__ L,
                        const double* __restrict__ Bm,
                        const double* __restrict__ Tinv_B,
                        const double* __restrict__ Sb_lu,
                        const int* __restrict__ Sb_piv,
                        const double* __restrict__ rhs_T,
                        const double* __restrict__ rhs_C, double* x,
                        double* w, int N, int nb, int k, int r) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const size_t bsz = (size_t)nb * nb;
  S_lu += b * N * bsz;
  S_piv += b * N * nb;
  L += b * (N - 1) * bsz;
  Bm += b * N * nb * k;
  Tinv_B += b * N * nb * k;
  Sb_lu += b * k * k;
  Sb_piv += b * k;
  rhs_T += b * N * nb * r;
  rhs_C += b * k * r;
  x += b * N * nb * r;
  w += b * k * r;

  // shared memory (btb_solve_smem_bytes): S_i's LU and the L block with
  // odd leading dimensions; two nb x r buffers of right-hand sides, Ya the
  // block under solution, Yb the next one; the border's k x r block; the
  // pivots
  const int lds = nb | 1;
  const int nr = nb * r;
  double* Ss = smem;
  double* Ls = Ss + (size_t)nb * lds;
  double* Ya = Ls + (size_t)nb * lds;
  double* Yb = Ya + nr;
  double* ws = Yb + nr;
  int* piv_s = reinterpret_cast<int*>(ws + (size_t)k * r);
  const StageMap sm(nb);

  // forward sweep: y_0 = rhs_0, y_i = rhs_i - L_{i-1} S_{i-1}^{-1} y_{i-1},
  // each y_i also to x_i
  for (int e = tid; e < nr; e += kThreads) {
    const double v = rhs_T[e];
    Ya[e] = v;
    x[e] = v;
  }
  for (int i = 1; i < N; ++i) {
    // S_{i-1}, its pivots, L_{i-1} and rhs_i in: the small loads first,
    // their stores after the blocks' loads
    const int pv = tid < nb ? S_piv[(size_t)(i - 1) * nb + tid] - 1 : 0;
    double yv[kRhsPerThread];
#pragma unroll
    for (int t = 0; t < kRhsPerThread; ++t) {
      const int e = tid + t * kThreads;
      yv[t] = e < nr ? rhs_T[(size_t)i * nr + e] : 0.0;
    }
    stage_blocks(Ss, S_lu + (i - 1) * bsz, Ls, L + (i - 1) * bsz, nb, lds,
                 sm);
    if (tid < nb) piv_s[tid] = pv;
#pragma unroll
    for (int t = 0; t < kRhsPerThread; ++t)
      if (tid + t * kThreads < nr) Yb[tid + t * kThreads] = yv[t];
    __syncthreads();
    lu_solve_warp(Ss, lds, piv_s, nb, Ya, r);
    __syncthreads();
    gemm_rows(nb, r, nb, Ls, lds, 1, Ya, r,
              FwdEpi{Yb, x + (size_t)i * nr, Yb, r});
    __syncthreads();
    double* t = Ya;
    Ya = Yb;
    Yb = t;
  }
  // back sweep: x_i = S_i^{-1} (y_i - L_i^T x_{i+1}), Ya holding y_{N-1},
  // then x_{i+1}, which goes to device memory while S_i, L_i and y_i come
  // in
  for (int i = N - 1; i >= 0; --i) {
    const bool last = i + 1 == N;
    const int pv = tid < nb ? S_piv[(size_t)i * nb + tid] - 1 : 0;
    double yv[kRhsPerThread];
#pragma unroll
    for (int t = 0; t < kRhsPerThread; ++t) {
      const int e = tid + t * kThreads;
      yv[t] = !last && e < nr ? x[(size_t)i * nr + e] : 0.0;
    }
    stage_blocks(Ss, S_lu + i * bsz, Ls, last ? nullptr : L + i * bsz, nb,
                 lds, sm);
    if (tid < nb) piv_s[tid] = pv;
    if (!last) {
#pragma unroll
      for (int t = 0; t < kRhsPerThread; ++t) {
        const int e = tid + t * kThreads;
        if (e < nr) {
          Yb[e] = yv[t];
          x[(size_t)(i + 1) * nr + e] = Ya[e];
        }
      }
    }
    __syncthreads();
    if (!last) {
      gemm_rows(nb, r, nb, Ls, 1, lds, Ya, r, SubEpi{Yb, r});
      __syncthreads();
      double* t = Ya;
      Ya = Yb;
      Yb = t;
    }
    lu_solve_warp(Ss, lds, piv_s, nb, Ya, r);
    __syncthreads();
  }
  for (int e = tid; e < nr; e += kThreads) x[e] = Ya[e];
  __syncthreads();
  if (k == 0) return;
  border_rhs(Bm, rhs_C, x, ws, N * nb, k, r);
  for (int j = tid; j < k; j += kThreads) piv_s[j] = Sb_piv[j] - 1;
  __syncthreads();
  lu_solve_warp(Sb_lu, k, piv_s, k, ws, r);
  __syncthreads();
  border_update(Tinv_B, ws, x, w, N * nb, k, r);
}

}  // namespace

extern "C" {

// Shared memory (bytes) the factor asks for: gemm's tiles; the Schur
// block and the right-hand sides X with odd leading dimensions when
// use_smem, else the panel buffer; the LU's row positions and pivots.
size_t btb_factor_smem_bytes(int nb, int k, int use_smem) {
  const size_t mx = nb > k ? nb : k;
  const size_t blocks = use_smem
      ? (size_t)nb * (nb | 1) + (size_t)nb * ((nb + k) | 1)
      : panel_doubles(nb, k);
  return sizeof(double) * (kTileDoubles + blocks) + sizeof(int) * (mx + kTri);
}

// Both entry points launch on `stream` and return the cudaError_t of the
// launch (0 on success); they neither allocate nor synchronise. scratch
// holds batch * nb * (nb + k) doubles when use_smem is 0.
int btb_factor_f64(const double* D, const double* L, const double* Bm,
                   const double* C, double* S_lu, int* S_piv, double* Tinv_B,
                   double* Sb_lu, int* Sb_piv, double* scratch, int batch,
                   int N, int nb, int k, int use_smem, void* stream) {
  const size_t smem = btb_factor_smem_bytes(nb, k, use_smem);
  auto kernel = use_smem ? btb_factor_kernel<true> : btb_factor_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      D, L, Bm, C, S_lu, S_piv, Tinv_B, Sb_lu, Sb_piv, scratch, N, nb, k);
  return (int)cudaGetLastError();
}

// Shared memory (bytes) of the wide solve (any r): gemm's tiles, two nb x
// r blocks of right-hand sides, the border's k x r block, the pivots.
static size_t wide_solve_smem_bytes(int nb, int k, int r) {
  const size_t mx = nb > k ? nb : k;
  return sizeof(double) * (kTileDoubles + (size_t)(2 * nb + k) * r) +
         sizeof(int) * mx;
}

// ... of the narrow solve (r <= kNarrow): two nb x nb blocks with odd
// leading dimensions, then as the wide one without gemm's tiles.
static size_t narrow_solve_smem_bytes(int nb, int k, int r) {
  const size_t mx = nb > k ? nb : k;
  return sizeof(double) *
             (2 * (size_t)nb * (nb | 1) + (size_t)(2 * nb + k) * r) +
         sizeof(int) * mx;
}

// Whether btb_solve_f64 takes the narrow kernel: at most kNarrow
// right-hand sides, blocks and border at most kNarrowRows wide (its
// shared memory, under 80 KB, then always fits).
int btb_solve_narrow(int nb, int k, int r) {
  return r <= kNarrow && nb <= kNarrowRows && k <= kNarrowRows;
}

// Shared memory (bytes) the solve asks for at these shapes.
size_t btb_solve_smem_bytes(int nb, int k, int r) {
  return btb_solve_narrow(nb, k, r) ? narrow_solve_smem_bytes(nb, k, r)
                                    : wide_solve_smem_bytes(nb, k, r);
}

int btb_solve_f64(const double* S_lu, const int* S_piv, const double* L,
                  const double* Bm, const double* Tinv_B, const double* Sb_lu,
                  const int* Sb_piv, const double* rhs_T, const double* rhs_C,
                  double* x, double* w, int batch, int N, int nb, int k, int r,
                  void* stream) {
  const size_t smem = btb_solve_smem_bytes(nb, k, r);
  auto kernel = btb_solve_narrow(nb, k, r) ? btb_solve_narrow_kernel
                                           : btb_solve_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      S_lu, S_piv, L, Bm, Tinv_B, Sb_lu, Sb_piv, rhs_T, rhs_C, x, w, N, nb, k,
      r);
  return (int)cudaGetLastError();
}

const char* btb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
