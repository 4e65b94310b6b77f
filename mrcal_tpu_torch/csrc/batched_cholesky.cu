// Batched Cholesky factor and triangular solves of small SPD blocks, for
// Hopper (sm_90a).
//
// Replaces mrcal_tpu/ops/batched_cholesky.py::batched_cholesky_solve_pallas
// (the Pallas TPU kernel _kernel_soa: factor each n x n block, then solve it
// against K right-hand-side columns, in one call; its unrolled XLA twin is
// unrolled_cholesky_factor + unrolled_cholesky_solve_factored).  The Schur
// step of the LM solver calls cholesky_factor_solve once per iteration on
// the frame blocks (n=6, K = Nc + 1: the camera coupling block and the
// gradient) and on the point blocks (n=3), keeps L, and calls
// cholesky_solve_factored once for the back-substitution (K=1).
// cholesky_factor is the factor alone.
//
// One warp-cooperative design serves every shape; the C entry points
// choose only the lanes per block, from n and K.  A group of G lanes (a
// power of two, 4-32, wide enough for K) takes one block, so several
// blocks share a warp, and 2-warp CTAs spread a few dozen blocks over tens
// of SMs.  The CTA's blocks are contiguous in memory and are staged into
// shared memory with coalesced loads, all in flight at once.  The factor
// is right-looking, one column per round: every lane holds one row; the
// pivot's lane takes the IEEE sqrt and its correctly rounded reciprocal,
// __shfl_sync broadcasts the reciprocal, and the lanes below scale by it
// and update their trailing entries.  The column they update from is
// shuffled before the pivot is ready, off the chain.  The chain is n
// rounds, not n(n+1)/2 dependent sqrt/div.  L and the reciprocal pivots go
// to shared memory (and L, coalesced, to device memory); then each lane
// solves columns c, c+G, ... of the right-hand side, reading rows of K
// contiguous values, so K = 285 is nine passes of 32 columns.  A lane's
// first column is loaded before the factor, and each pass loads the next
// column before it solves the current one.
//
// What bounds it:
// * At the Schur step's shapes (B = 40-84 frames): launch latency and the
//   dependent chain of one block; the bytes (~0.05 us at (84, 6, 15) f64
//   at 3.35 TB/s) do not matter.
// * At bundle adjustment's 1e5-1e6 blocks: bytes.  Every load and store is
//   coalesced, and the grid holds one CTA per 2-16 blocks, so the card's
//   memory stays busy.  With K < n/2 (the factor alone, a K = 1 solve) only
//   some lanes of a group have a column, and an entry-major tile staged
//   with cp.async, one thread per block, moved the same bytes faster on the
//   card.  The n=3 blocks come from discrete points in the state
//   (observations_point with variable points); triangulated points are not
//   state and add no blocks.  sfm_points drives them at scale: 14996
//   blocks solved against K = 2385 columns (the dense point-camera
//   coupling block) per iteration, at ~70 % of the byte bound on an H100,
//   and back-substituted at K = 1, where the launch dominates.
//
// The kernels compute what the plain version computes, in its order:
// each entry's products are subtracted in ascending k, with IEEE sqrt and
// no fast math, no clamp and no jitter.  The one change is that dividing
// by a pivot L_jj becomes multiplying by its correctly rounded reciprocal
// 1/L_jj, computed once per pivot (a difference of an ulp or so per
// entry).  A block that is not SPD gives NaN in that block alone, and the
// LM loop rejects the trial.
//
// Plain C interface for ctypes: each function launches on the given stream,
// does not synchronize, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum Mode { kFactor, kSolve, kFactorSolve };

template <typename T>
struct Args {
  const T* in;   // A (factor modes) or L (kSolve): (B, n, n)
  const T* rhs;  // (B, n, K), or null
  T* L;          // (B, n, n) out, or null
  T* X;          // (B, n, K) out, or null
  int64_t B;
  int K;
  int G;         // lanes per block
};

__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// IEEE reciprocal, rounded to nearest: the same value as 1 / x
__device__ __forceinline__ double recip(double x) { return __drcp_rn(x); }
__device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }

// One right-hand-side column: row i at p[i * stride].
template <typename T, int N>
__device__ __forceinline__ void load_column(T (&y)[N], const T* p,
                                            int stride) {
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = p[i * stride];
}

template <typename T, int N>
__device__ __forceinline__ void store_column(const T (&y)[N], T* p,
                                             int stride) {
#pragma unroll
  for (int i = 0; i < N; ++i) p[i * stride] = y[i];
}

// Forward and back solve of one column y, in place, against L (packed
// lower triangle) and the reciprocal pivots.
template <typename T, int N>
__device__ __forceinline__ void solve_column(const T (&l)[N * (N + 1) / 2],
                                             const T (&inv)[N], T (&y)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T s = y[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= l[tri(i, k)] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s -= l[tri(k, i)] * y[k];
    y[i] = s * inv[i];
  }
}

constexpr int kWarpCta = 64;  // threads per CTA: two warps

__host__ __device__ constexpr int min_group(int n) { return n <= 4 ? 4 : 8; }

// lanes per block: a power of two >= n that covers K columns, at most a warp
inline int group_size(int n, int K) {
  int g = min_group(n);
  while (g < K && g < 32) g *= 2;
  return g;
}

template <typename T, int N, Mode M>
__device__ __forceinline__ void warp_body(const Args<T>& a) {
  constexpr int NN = N * N;
  constexpr int kMaxBlocks = kWarpCta / min_group(N);
  __shared__ T s_l[kMaxBlocks * NN];  // the CTA's blocks: A in, L out
  __shared__ T s_r[kMaxBlocks * N];   // reciprocal pivots 1 / L_jj
  const int G = a.G;
  const int per_cta = kWarpCta / G;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * per_cta;
  const int nb = static_cast<int>(
      a.B - b0 < per_cta ? a.B - b0 : static_cast<int64_t>(per_cta));
  const int g = threadIdx.x / G;  // the block's slot in the CTA
  const int r = threadIdx.x % G;  // lane in the group

  // The lane's first column is loaded now, so that its latency overlaps
  // the staging and the factor; each later pass loads the next column
  // before it solves the current one.
  const int64_t off = (b0 + g) * N * static_cast<int64_t>(a.K);
  T y[N];
  if constexpr (M != kFactor) {
    if (g < nb && r < a.K) load_column<T, N>(y, a.rhs + off + r, a.K);
  }

  // every load of the staging in flight at once, then the stores
  constexpr int kPer = (kMaxBlocks * NN + kWarpCta - 1) / kWarpCta;
  const T* src = a.in + b0 * NN;
  T staged[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int f = threadIdx.x + i * kWarpCta;
    if (f < nb * NN) staged[i] = src[f];
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int f = threadIdx.x + i * kWarpCta;
    if (f < nb * NN) s_l[f] = staged[i];
  }
  __syncthreads();
  T* blk = s_l + g * NN;
  T* rcp = s_r + g * N;

  if constexpr (M == kSolve) {
    if (r < N && g < nb) rcp[r] = recip(blk[r * N + r]);
  } else {
    // Lane r < N holds row r; spare lanes shadow row N-1 and write
    // nothing.  Slots past nb hold stale data and are never written out.
    const int row = r < N ? r : N - 1;
    T v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = blk[row * N + k];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      // column j of the rows below, fetched while the pivot is computed;
      // l_kj = a_kj * (1 / L_jj) is then the product lane k forms itself
      T a_kj[N];
#pragma unroll
      for (int k = j + 1; k < N; ++k)
        a_kj[k] = __shfl_sync(0xffffffffu, v[j], k, G);
      // The pivot's lane takes its sqrt and reciprocal.  The other lanes,
      // and the idle slots of the last CTA, take them of 1: their v[j] may
      // be negative or stale, and would send them down the special-case
      // path of sqrt every round, which made each round several times
      // slower on the card.
      const T d = sqrt(r == j && g < nb ? v[j] : T(1));
      const T inv_j = __shfl_sync(0xffffffffu, recip(d), j, G);
      if (r == j) {
        v[j] = d;
        rcp[j] = inv_j;
      } else if (r > j) {
        v[j] *= inv_j;
      }
#pragma unroll
      for (int k = j + 1; k < N; ++k) {
        if (r >= k) v[k] -= v[j] * (a_kj[k] * inv_j);
      }
    }
    __syncwarp();
    if (r < N) {
#pragma unroll
      for (int k = 0; k < N; ++k) blk[r * N + k] = k <= r ? v[k] : T(0);
    }
  }
  __syncthreads();

  if constexpr (M != kSolve) {
    T* dst = a.L + b0 * NN;
    for (int f = threadIdx.x; f < nb * NN; f += kWarpCta) dst[f] = s_l[f];
  }
  if constexpr (M != kFactor) {
    if (g < nb) {
      T l[N * (N + 1) / 2], inv[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        inv[i] = rcp[i];
#pragma unroll
        for (int j = 0; j <= i; ++j) l[tri(i, j)] = blk[i * N + j];
      }
      for (int c = r; c < a.K; c += G) {
        const bool more = c + G < a.K;
        T next[N];
        if (more) load_column<T, N>(next, a.rhs + off + c + G, a.K);
        solve_column<T, N>(l, inv, y);
        store_column<T, N>(y, a.X + off + c, a.K);
        if (more) {
#pragma unroll
          for (int i = 0; i < N; ++i) y[i] = next[i];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// kernels: the <wrapper>_kernel names are what profiles are matched by
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kWarpCta)
    cholesky_factor_kernel(const Args<T> a) {
  warp_body<T, N, kFactor>(a);
}

template <typename T, int N>
__global__ void __launch_bounds__(kWarpCta)
    cholesky_solve_factored_kernel(const Args<T> a) {
  warp_body<T, N, kSolve>(a);
}

template <typename T, int N>
__global__ void __launch_bounds__(kWarpCta)
    cholesky_factor_solve_kernel(const Args<T> a) {
  warp_body<T, N, kFactorSolve>(a);
}

template <typename T, int N, Mode M>
constexpr auto kernel() {
  if constexpr (M == kFactor) {
    return cholesky_factor_kernel<T, N>;
  } else if constexpr (M == kSolve) {
    return cholesky_solve_factored_kernel<T, N>;
  } else {
    return cholesky_factor_solve_kernel<T, N>;
  }
}

template <typename T, int N, Mode M>
cudaError_t launch(Args<T> a, cudaStream_t s) {
  a.G = group_size(N, M == kFactor ? 0 : a.K);
  const int per_cta = kWarpCta / a.G;
  auto k = kernel<T, N, M>();
  k<<<static_cast<unsigned>((a.B + per_cta - 1) / per_cta), kWarpCta, 0,
      s>>>(a);
  return cudaGetLastError();
}

template <Mode M>
int run(const void* in, const void* rhs, void* L, void* X, int64_t B, int n,
        int K, int is_double, void* stream) {
  if (B <= 0 || (M == kSolve && K <= 0)) return cudaSuccess;
  if (K < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    const Args<double> a{static_cast<const double*>(in),
                         static_cast<const double*>(rhs),
                         static_cast<double*>(L), static_cast<double*>(X),
                         B, K, 0};
    if (n == 6) return launch<double, 6, M>(a, s);
    if (n == 3) return launch<double, 3, M>(a, s);
  } else {
    const Args<float> a{static_cast<const float*>(in),
                        static_cast<const float*>(rhs),
                        static_cast<float*>(L), static_cast<float*>(X),
                        B, K, 0};
    if (n == 6) return launch<float, 6, M>(a, s);
    if (n == 3) return launch<float, 3, M>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// is_double: 0 for float32, 1 for float64.  A, L: (B, n, n) row-major.
extern "C" int mrcal_cholesky_factor(const void* A, void* L, int64_t B, int n,
                                     int is_double, void* stream) {
  return run<kFactor>(A, nullptr, L, nullptr, B, n, 0, is_double, stream);
}

// L: (B, n, n) lower-triangular factor; rhs, x: (B, n, K) row-major.
extern "C" int mrcal_cholesky_solve_factored(const void* L, const void* rhs,
                                             void* x, int64_t B, int n, int K,
                                             int is_double, void* stream) {
  return run<kSolve>(L, rhs, nullptr, x, B, n, K, is_double, stream);
}

// A, L: (B, n, n); rhs, x: (B, n, K).  Writes both the factor and the
// solution, in one launch.
extern "C" int mrcal_cholesky_factor_solve(const void* A, const void* rhs,
                                           void* L, void* x, int64_t B, int n,
                                           int K, int is_double,
                                           void* stream) {
  return run<kFactorSolve>(A, rhs, L, x, B, n, K, is_double, stream);
}
