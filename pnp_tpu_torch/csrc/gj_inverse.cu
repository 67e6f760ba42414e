// Batched explicit f32 inverse by Gauss-Jordan elimination with partial
// pivoting over the whole remaining column.
//
// Replaces: pnp_tpu/operators/pallas_kernels.py:batched_inverse_pallas
// (blocked Gauss-Jordan, pivoting only inside each 128-wide diagonal block).
// This kernel computes the same inverse but not the TPU's block schedule:
// the pivot is searched over the whole remaining column, which is what the
// reference path gets from XLA's inverse and what the advective species
// stage matrices need (in-block pivoting has a documented cross-block
// pivot-growth failure on them, pnp_tpu/solvers/direct.py:40-62).
//
// Algorithm, for k = 0 .. N-1 on each matrix M of the batch (in place):
//   p      = lowest row index i >= k with the largest |M[i,k]|
//   swap rows k and p, record perm[k] = p
//   r      = M[k,:] / M[k,k], with r[k] = 1 / M[k,k]      (new pivot row)
//   c      = M[:,k] with c[k] = 0                           (multipliers)
//   M[i,j] = (j == k ? 0 : M[i,j]) - c[i] * r[j]            for i != k
// after which M holds inv(P A); the recorded row swaps are undone as one
// column gather out[:, j] = M[:, g[j]].
//
// Launches: per column k, one pivot kernel (one block per matrix: argmax
// reduction, row swap, row scaling, multiplier copy) and one rank-1 update
// kernel over all (row, column) tiles with the batch as grid.z; then one
// permutation kernel and one gather kernel.
//
// Bound on the H100: the rank-1 updates are bandwidth-bound. Every step
// reads and writes the whole (S, N, N) f32 working set, 8 S N^2 bytes, for
// 2 S N^2 flops: at (2, 4801) that is 369 MB per step and N steps per
// inverse, far below the FMA rate. What the design does about it: each
// update is a single coalesced streaming pass (threads of a warp walk
// neighbouring columns, the pivot-row value is held in a register, the
// multiplier is one broadcast load per row), and the batch rides in the
// same launch. A blocked (rank-B) panel update that cuts the traffic by B
// is the next step once this simple form is measured.
//
// Arithmetic is plain IEEE f32 on the FMA pipe, no tensor cores and no
// TF32 (the refinement loop needs a true-f32 inverse). Products and
// differences are rounded separately (__fmul_rn, __fsub_rn, __fdiv_rn),
// so the kernel reproduces the plain PyTorch version
// (pnp_tpu_torch/operators/kernels.py:_gj_core_plain) bit for bit.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kPivotThreads = 1024;
constexpr int kTileCols = 32;
constexpr int kTileRowsThreads = 8;
constexpr int kTileRows = 64;

__global__ void gj_pivot_kernel(float* __restrict__ A,
                                float* __restrict__ col,
                                int* __restrict__ perm, int N, int k) {
  float* M = A + (size_t)blockIdx.x * N * N;
  float* c = col + (size_t)blockIdx.x * N;
  const int tid = threadIdx.x;
  __shared__ float s_val[kPivotThreads];
  __shared__ int s_idx[kPivotThreads];

  // argmax |M[i,k]| over i >= k; rows are visited in increasing order, so
  // a strict comparison keeps the lowest index within a thread
  float best = -1.0f;
  int bi = N;
  for (int i = k + tid; i < N; i += blockDim.x) {
    const float v = fabsf(M[(size_t)i * N + k]);
    if (v > best) {
      best = v;
      bi = i;
    }
  }
  s_val[tid] = best;
  s_idx[tid] = bi;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      const float v2 = s_val[tid + s];
      const int i2 = s_idx[tid + s];
      if (v2 > s_val[tid] || (v2 == s_val[tid] && i2 < s_idx[tid])) {
        s_val[tid] = v2;
        s_idx[tid] = i2;
      }
    }
    __syncthreads();
  }
  int p = s_idx[0];
  if (p >= N) p = k;  // whole column NaN: keep the diagonal
  if (tid == 0) perm[(size_t)blockIdx.x * N + k] = p;

  if (p != k) {
    for (int j = tid; j < N; j += blockDim.x) {
      const float a = M[(size_t)k * N + j];
      M[(size_t)k * N + j] = M[(size_t)p * N + j];
      M[(size_t)p * N + j] = a;
    }
  }
  __syncthreads();
  const float piv = M[(size_t)k * N + k];
  __syncthreads();  // every thread has read the pivot before row k changes
  for (int j = tid; j < N; j += blockDim.x) {
    M[(size_t)k * N + j] =
        (j == k) ? __fdiv_rn(1.0f, piv) : __fdiv_rn(M[(size_t)k * N + j], piv);
  }
  // multipliers: column k of the other rows (row k is not touched above
  // outside itself, and c[k] = 0 leaves it out of the update)
  for (int i = tid; i < N; i += blockDim.x) {
    c[i] = (i == k) ? 0.0f : M[(size_t)i * N + k];
  }
}

__global__ void gj_update_kernel(float* __restrict__ A,
                                 const float* __restrict__ col, int N, int k) {
  const int j = blockIdx.x * kTileCols + threadIdx.x;
  if (j >= N) return;
  float* M = A + (size_t)blockIdx.z * N * N;
  const float* c = col + (size_t)blockIdx.z * N;
  const float rj = M[(size_t)k * N + j];
  const int i_end = min(N, (int)(blockIdx.y + 1) * kTileRows);
  for (int i = blockIdx.y * kTileRows + threadIdx.y; i < i_end;
       i += kTileRowsThreads) {
    if (i == k) continue;
    const size_t at = (size_t)i * N + j;
    const float a = (j == k) ? 0.0f : M[at];
    M[at] = __fsub_rn(a, __fmul_rn(c[i], rj));
  }
}

// g = the column order that undoes the row swaps: apply the recorded
// transpositions in reverse to the identity (sequential, one thread per
// matrix; N steps against O(N^3) for the elimination)
__global__ void gj_perm_kernel(const int* __restrict__ perm,
                               int* __restrict__ g, int N) {
  if (threadIdx.x != 0) return;
  const int* pm = perm + (size_t)blockIdx.x * N;
  int* gm = g + (size_t)blockIdx.x * N;
  for (int j = 0; j < N; ++j) gm[j] = j;
  for (int r = N - 1; r >= 0; --r) {
    const int p = pm[r];
    const int t = gm[r];
    gm[r] = gm[p];
    gm[p] = t;
  }
}

__global__ void gj_gather_kernel(const float* __restrict__ W,
                                 float* __restrict__ out,
                                 const int* __restrict__ g, int N) {
  const int j = blockIdx.x * kTileCols + threadIdx.x;
  if (j >= N) return;
  const size_t base = (size_t)blockIdx.z * N * N;
  const int gj = g[(size_t)blockIdx.z * N + j];
  const int i_end = min(N, (int)(blockIdx.y + 1) * kTileRows);
  for (int i = blockIdx.y * kTileRows + threadIdx.y; i < i_end;
       i += kTileRowsThreads) {
    out[base + (size_t)i * N + j] = W[base + (size_t)i * N + gj];
  }
}

}  // namespace

// work: (S, N, N) input, overwritten with inv(P A); out: (S, N, N) inverse;
// col, perm, g: (S, N) scratch. Returns the first CUDA error, 0 on success.
extern "C" int gj_inverse_f32(float* work, float* out, float* col, int* perm,
                              int* g, int S, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || N <= 0 || S > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(kTileCols, kTileRowsThreads);
  const dim3 grid((N + kTileCols - 1) / kTileCols,
                  (N + kTileRows - 1) / kTileRows, S);
  for (int k = 0; k < N; ++k) {
    gj_pivot_kernel<<<S, kPivotThreads, 0, st>>>(work, col, perm, N, k);
    gj_update_kernel<<<grid, block, 0, st>>>(work, col, N, k);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  gj_perm_kernel<<<S, 32, 0, st>>>(perm, g, N);
  gj_gather_kernel<<<grid, block, 0, st>>>(work, out, g, N);
  return (int)cudaGetLastError();
}
