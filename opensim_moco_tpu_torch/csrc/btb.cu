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
//           LU-factored with partial pivoting (LAPACK getf2: first index of
//           the largest |entry|, whole-row swaps, 1-based pivots, a zero
//           pivot left unscaled); then T^{-1} B by a forward and a back
//           sweep, the border Schur complement C - sum_i B_i^T (T^{-1} B)_i
//           (k x k) and its LU.
//   solve:  multi-right-hand-side forward and back sweeps with the stored
//           factors, then the border correction.
// A singular or indefinite trial yields inf/NaN, never a fix-up: the IPM's
// regularization loop reads a non-finite step as "raise delta".
//
// What bounds it: the recursion over N is sequential within a lane and
// every step is a chain of small dependent triangular solves, so at the
// bench's shapes (B=32, N=25, nb=34, k=1) it is latency-bound, far from
// both the float64 FLOP bound and the byte bound.
// What the design does about it: one launch per factor and one per solve
// instead of about 5 N (factor) and 6 N (solve) small launches from
// Python; the Schur block being formed and factored stays in shared memory
// when two nb x nb blocks fit (nb up to about 115), otherwise the kernel
// works in device memory (nb of a few hundred, gait2d), where the lane's
// blocks stay in L2. Each elimination step of the LU and of the triangular
// solves is one pass of the whole thread block over the trailing rows and
// columns, ended by one barrier; the LU's pivot search is one warp's
// shuffle reduction. wgmma/TMA tiling is later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;  // complete in lane 0
}

// In-place LU with partial pivoting of the n x n row-major A; piv gets
// 1-based pivot rows. Every thread of the block calls it.
__device__ void lu_factor_block(double* A, int n, int* piv) {
  __shared__ int s_pivot;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int k = 0; k < n; ++k) {
    if (tid < 32) {
      double best = -1.0;
      int bi = n;
      for (int r = k + lane; r < n; r += 32) {
        const double v = fabs(A[(size_t)r * n + k]);
        if (v > best) {
          best = v;
          bi = r;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const double ov = __shfl_down_sync(kFull, best, o);
        const int oi = __shfl_down_sync(kFull, bi, o);
        if (ov > best || (ov == best && oi < bi)) {
          best = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        const int p = bi < n ? bi : k;  // an all-NaN column keeps row k
        s_pivot = p;
        piv[k] = p + 1;
      }
    }
    __syncthreads();
    const int p = s_pivot;
    if (p != k) {
      for (int c = tid; c < n; c += kThreads) {
        const double t = A[(size_t)k * n + c];
        A[(size_t)k * n + c] = A[(size_t)p * n + c];
        A[(size_t)p * n + c] = t;
      }
    }
    __syncthreads();
    const double akk = A[(size_t)k * n + k];
    if (akk != 0.0) {
      for (int r = k + 1 + tid; r < n; r += kThreads) A[(size_t)r * n + k] /= akk;
    }
    __syncthreads();
    const int m = n - k - 1;
    for (int e = tid; e < m * m; e += kThreads) {
      const int r = k + 1 + e / m;
      const int c = k + 1 + e % m;
      A[(size_t)r * n + c] -= A[(size_t)r * n + k] * A[(size_t)k * n + c];
    }
    __syncthreads();
  }
}

// X (n x r, row-major, leading dimension r) <- A^{-1} X for A = P L U
// stored by lu_factor_block: the row swaps (one thread per column), then
// column-oriented substitutions (as reference LAPACK's trsm), each step
// one axpy over the remaining rows and all r columns by the whole block.
// Every thread calls it.
__device__ void lu_solve_block(const double* LU, const int* piv, int n,
                               double* X, int r) {
  const int tid = threadIdx.x;
  for (int c = tid; c < r; c += kThreads) {
    for (int k = 0; k < n; ++k) {
      const int p = piv[k] - 1;
      if (p != k) {
        const double t = X[(size_t)k * r + c];
        X[(size_t)k * r + c] = X[(size_t)p * r + c];
        X[(size_t)p * r + c] = t;
      }
    }
  }
  __syncthreads();
  for (int k = 0; k + 1 < n; ++k) {  // unit lower triangle
    const int m = (n - k - 1) * r;
    for (int e = tid; e < m; e += kThreads) {
      const int row = k + 1 + e / r, c = e % r;
      X[(size_t)row * r + c] -= LU[(size_t)row * n + k] * X[(size_t)k * r + c];
    }
    __syncthreads();
  }
  for (int k = n - 1; k > 0; --k) {  // upper triangle; row k is final here
    const double ukk = LU[(size_t)k * n + k];
    for (int e = tid; e < k * r; e += kThreads) {
      const int row = e / r, c = e % r;
      X[(size_t)row * r + c] -= LU[(size_t)row * n + k] * (X[(size_t)k * r + c] / ukk);
    }
    __syncthreads();
  }
  for (int e = tid; e < n * r; e += kThreads) {
    const int row = e / r;
    X[e] /= LU[(size_t)row * n + row];
  }
  __syncthreads();
}

// X (N, nb, r) <- T^{-1} X with the stored block factors. tmp (nb*r,
// shared memory) holds the block under solution, so the triangular solves
// work in shared memory whatever mode the caller is in.
__device__ void t_solve(const double* S_lu, const int* S_piv, const double* L,
                        int N, int nb, double* X, int r, double* tmp) {
  const int tid = threadIdx.x;
  const size_t bsz = (size_t)nb * nb;
  const int nr = nb * r;
  for (int i = 1; i < N; ++i) {  // y_i = r_i - L_{i-1} S_{i-1}^{-1} y_{i-1}
    const double* yp = X + (size_t)(i - 1) * nr;
    for (int e = tid; e < nr; e += kThreads) tmp[e] = yp[e];
    __syncthreads();
    lu_solve_block(S_lu + (i - 1) * bsz, S_piv + (size_t)(i - 1) * nb, nb,
                   tmp, r);
    const double* Li = L + (i - 1) * bsz;
    double* yi = X + (size_t)i * nr;
    for (int e = tid; e < nr; e += kThreads) {
      const int row = e / r, c = e % r;
      double acc = 0.0;
      for (int j = 0; j < nb; ++j)
        acc += Li[(size_t)row * nb + j] * tmp[(size_t)j * r + c];
      yi[e] -= acc;
    }
    __syncthreads();
  }
  for (int i = N - 1; i >= 0; --i) {  // x_i = S_i^{-1} (y_i - L_i^T x_{i+1})
    double* xi = X + (size_t)i * nr;
    for (int e = tid; e < nr; e += kThreads) {
      const int row = e / r, c = e % r;
      double acc = 0.0;
      if (i + 1 < N) {
        const double* Li = L + i * bsz;
        const double* xn = X + (size_t)(i + 1) * nr;
        for (int j = 0; j < nb; ++j)
          acc += Li[(size_t)j * nb + row] * xn[(size_t)j * r + c];
      }
      tmp[e] = xi[e] - acc;
    }
    __syncthreads();
    lu_solve_block(S_lu + i * bsz, S_piv + (size_t)i * nb, nb, tmp, r);
    for (int e = tid; e < nr; e += kThreads) xi[e] = tmp[e];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
btb_factor_kernel(const double* __restrict__ D, const double* __restrict__ L,
                  const double* __restrict__ Bm, const double* __restrict__ C,
                  double* S_lu, int* S_piv, double* Tinv_B, double* Sb_lu,
                  int* Sb_piv, double* scratch, int N, int nb, int k,
                  int use_smem) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  const size_t bsz = (size_t)nb * nb;
  D += b * N * bsz;
  L += b * (N - 1) * bsz;
  Bm += b * N * nb * k;
  C += b * k * k;
  S_lu += b * N * bsz;
  S_piv += b * N * nb;
  Tinv_B += b * N * nb * k;
  Sb_lu += b * k * k;
  Sb_piv += b * k;

  // X: the nb x nb right-hand sides S_{i-1}^{-1} L_{i-1}^T; Sw: the Schur
  // block being formed and factored (shared-memory mode only)
  double* X = use_smem ? smem : scratch + b * bsz;
  double* Sw = use_smem ? smem + bsz : nullptr;
  double* tmp = use_smem ? smem + 2 * bsz : smem;

  for (int i = 0; i < N; ++i) {
    double* Sg = S_lu + i * bsz;
    double* S = use_smem ? Sw : Sg;
    const double* Di = D + i * bsz;
    if (i == 0) {
      for (size_t e = tid; e < bsz; e += kThreads) S[e] = Di[e];
    } else {
      const double* Lp = L + (i - 1) * bsz;
      const double* P = use_smem ? Sw : S_lu + (i - 1) * bsz;
      for (size_t e = tid; e < bsz; e += kThreads) X[e] = Lp[(e % nb) * nb + e / nb];
      __syncthreads();
      lu_solve_block(P, S_piv + (size_t)(i - 1) * nb, nb, X, nb);
      // S_i = D_i - L_{i-1} X; in shared-memory mode S overwrites P, which
      // lu_solve_block has finished reading
      for (size_t e = tid; e < bsz; e += kThreads) {
        const size_t row = e / nb, c = e % nb;
        double acc = 0.0;
        for (int j = 0; j < nb; ++j) acc += Lp[row * nb + j] * X[(size_t)j * nb + c];
        S[e] = Di[e] - acc;
      }
    }
    __syncthreads();
    lu_factor_block(S, nb, S_piv + (size_t)i * nb);
    if (use_smem) {
      for (size_t e = tid; e < bsz; e += kThreads) Sg[e] = S[e];
      __syncthreads();
    }
  }
  if (k == 0) return;

  const int nk = N * nb * k;
  for (int e = tid; e < nk; e += kThreads) Tinv_B[e] = Bm[e];
  __syncthreads();
  t_solve(S_lu, S_piv, L, N, nb, Tinv_B, k, tmp);
  for (int e = warp; e < k * k; e += kWarps) {  // C - sum_i B_i^T (T^-1 B)_i
    const int p = e / k, q = e % k;
    double s = 0.0;
    for (int t = lane; t < N * nb; t += 32) s += Bm[(size_t)t * k + p] * Tinv_B[(size_t)t * k + q];
    s = warp_sum(s);
    if (lane == 0) Sb_lu[e] = C[e] - s;
  }
  __syncthreads();
  lu_factor_block(Sb_lu, k, Sb_piv);
}

__global__ void __launch_bounds__(kThreads)
btb_solve_kernel(const double* __restrict__ S_lu, const int* __restrict__ S_piv,
                 const double* __restrict__ L, const double* __restrict__ Bm,
                 const double* __restrict__ Tinv_B,
                 const double* __restrict__ Sb_lu,
                 const int* __restrict__ Sb_piv,
                 const double* __restrict__ rhs_T,
                 const double* __restrict__ rhs_C, double* x, double* w,
                 int N, int nb, int k, int r) {
  extern __shared__ double tmp[];  // nb * r
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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

  const int nr = N * nb * r;
  for (int e = tid; e < nr; e += kThreads) x[e] = rhs_T[e];
  __syncthreads();
  t_solve(S_lu, S_piv, L, N, nb, x, r, tmp);
  if (k == 0) return;
  for (int e = warp; e < k * r; e += kWarps) {  // rhs_C - sum_i B_i^T x_i
    const int p = e / r, c = e % r;
    double s = 0.0;
    for (int t = lane; t < N * nb; t += 32) s += Bm[(size_t)t * k + p] * x[(size_t)t * r + c];
    s = warp_sum(s);
    if (lane == 0) w[e] = rhs_C[e] - s;
  }
  __syncthreads();
  lu_solve_block(Sb_lu, Sb_piv, k, w, r);
  for (int e = tid; e < nr; e += kThreads) {  // x -= (T^{-1} B) w
    const int t = e / r, c = e % r;
    double acc = 0.0;
    for (int q = 0; q < k; ++q) acc += Tinv_B[(size_t)t * k + q] * w[(size_t)q * r + c];
    x[e] -= acc;
  }
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` and return the cudaError_t of the
// launch (0 on success); they neither allocate nor synchronise.
int btb_factor_f64(const double* D, const double* L, const double* Bm,
                   const double* C, double* S_lu, int* S_piv, double* Tinv_B,
                   double* Sb_lu, int* Sb_piv, double* scratch, int batch,
                   int N, int nb, int k, int use_smem, void* stream) {
  const size_t bsz = (size_t)nb * nb;
  const size_t smem = sizeof(double) * ((use_smem ? 2 * bsz : 0) + (size_t)nb * k);
  cudaError_t err = cudaFuncSetAttribute(
      btb_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  btb_factor_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      D, L, Bm, C, S_lu, S_piv, Tinv_B, Sb_lu, Sb_piv, scratch, N, nb, k,
      use_smem);
  return (int)cudaGetLastError();
}

int btb_solve_f64(const double* S_lu, const int* S_piv, const double* L,
                  const double* Bm, const double* Tinv_B, const double* Sb_lu,
                  const int* Sb_piv, const double* rhs_T, const double* rhs_C,
                  double* x, double* w, int batch, int N, int nb, int k, int r,
                  void* stream) {
  const size_t smem = sizeof(double) * (size_t)nb * r;
  cudaError_t err = cudaFuncSetAttribute(
      btb_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  btb_solve_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      S_lu, S_piv, L, Bm, Tinv_B, Sb_lu, Sb_piv, rhs_T, rhs_C, x, w, N, nb, k,
      r);
  return (int)cudaGetLastError();
}

const char* btb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
