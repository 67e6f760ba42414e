// Batched explicit f32 inverse by panel-blocked Gauss-Jordan elimination
// with partial pivoting over the whole remaining column.
//
// Replaces: pnp_tpu/operators/pallas_kernels.py:batched_inverse_pallas
// (blocked Gauss-Jordan, pivoting only inside each 128-wide diagonal block).
// This kernel computes the same inverse but not the TPU's block schedule:
// the pivot is searched over the whole remaining column, which is what the
// reference path gets from XLA's inverse and what the advective species
// stage matrices need (in-block pivoting has a documented cross-block
// pivot-growth failure on them, pnp_tpu/solvers/direct.py:40-62).
//
// Algebra. One in-place Gauss-Jordan step on column k is
//   T_k x = x + (g_k - e_k) x_k,
// where g_k is what the step leaves in column k (-c_i / piv, and 1 / piv on
// the pivot row). For a panel K of nb consecutive pivot columns the product
// T = T_{k0+nb-1} ... T_{k0} is the identity on any x with x_K = 0, so
//   T = I + (G - E_K) E_K^T,
// with G (N x nb) exactly what the nb in-place steps leave in the panel's
// columns. A row swap made inside the panel commutes past the earlier steps
// of the panel when it is applied to the whole panel row (finished columns
// included), so all swaps of a panel can be applied to the other columns
// first and T after them. Per panel, on each matrix M of the batch:
//   1. panel step, on the N x nb column panel only: for each column the
//      pivot search (lowest row i >= k with the largest |M[i,k]|), the row
//      swap and the in-place step. The panel is up to date (the update is
//      right-looking), so in exact arithmetic the pivots are those of a
//      column-by-column elimination.
//   2. the panel's row swaps applied to all other columns (finished inverse
//      columns to the left included), perm[k] recorded; the pivot rows
//      R = M[K, :] copied aside.
//   3. rank-nb update of all other columns J:
//        M[i,J] <- M[i,J] + G[i,:] R[:,J]   (i not in K)
//        M[K,J] <-          G[K,:] R[:,J]
//      and the panel's own columns <- G.
//   4. after the last panel M = inv(P A); the swaps are undone as one column
//      gather out[:, j] = M[:, g[j]].
//
// Bound on the H100: 2 N^3 f32 flop per matrix on the FMA pipe (67 TFLOP/s)
// against 8 S N^2 bytes in and out (3.35 TB/s): operations set the bound
// for every N above ~80. A column-by-column (rank-1) elimination makes N
// passes over the working set at 0.25 flop per byte and is held to the
// memory rate instead; the panel form makes N / nb passes at nb / 4 flop
// per byte (nb = 64: 16).
//
// Two variants, chosen from N by the caller (kernels.py):
//
// * gj_small_kernel (N <= 512): one block of 512 threads per matrix walks
//   all panels (width <= 32) inside one launch. The panel and the pivot rows
//   live in shared memory (column-major, so a panel step walks rows with
//   unit stride); the rank-nb update runs 128 x 128 tiles with an 8 x 4
//   register block per thread, the M tile fetched before the product and
//   written after it. A batch of 96 matrices fills 96 of the 132 SMs; the
//   whole inverse is 3 launches.
//
// * the panel path (any N): the panel lives in a column-major scratch
//   buffer (nb x Np) in device memory, small enough to stay in L2. One
//   launch per column does the step on the panel alone, over all 32-row
//   blocks at once (a block per matrix would be held to one SM's share of
//   the L2 rate): each warp reduces the per-block pivot candidates the
//   previous launch left, reads the pivot row's entries it needs, updates
//   its rows from the source buffer into the other buffer of a pair (so no
//   block reads a row another block is writing; the row swap is folded
//   into the reads), and the warp that wrote the next column leaves the
//   block's candidate for it. No block-wide barrier; a thread's own loads
//   are in flight before the pivot is known. Then one launch swaps rows
//   and copies R aside, and one launch does the rank-nb update: 128 x 128
//   output tiles, 256 threads with an 8 x 8 register block each, G and R
//   tiles brought into shared memory by cp.async in 16-deep stages that
//   are waited for one by one, so later stages land while the first are
//   multiplied; the M tile is prefetched to L2 meanwhile, and two blocks
//   share an SM so one tile's epilogue overlaps another's product. The
//   working matrix has a row pitch that is a multiple of 4 floats, so
//   every M access of the update is a 16-byte one for any N.
//   N + 3 ceil(N / nb) + 2 launches per inverse.
//
// Measured on an H100 (80GB HBM3, 700 W; tools/gj_sweep.py): panels of 64
// beat 32 and 48 on the panel path ((2, 4801, 4801): 46.9 / 52.7 / 48.4 ms;
// (1, 12097, 12097): 208.9 ms against 265.0 at 32), and 32 beats 16 in the
// one-block kernel ((96, 369, 369): 1.78 against 1.93 ms). The update runs
// at 28-29 TFLOP/s while moving M at ~1.8 TB/s: neither pipe is full, the
// two phases of a tile overlap only across the two blocks of an SM. The
// per-column launches (4.7-5.6 us each) are half the time at N = 4801 and
// a third at N = 12097. Look-ahead was tried and taken out again: with the
// next panel's steps on a second, high-priority stream beside the rest of
// this panel's update (the update capped at 112 registers so a step block
// fits beside two of its blocks) the inverse gained 1 % at N = 4801 and
// 4 % at N = 12097: both kernels slow down when they share the SMs (a
// step launch 5.6 -> 9.3 us, an update 636 -> 760 us).
//
// Arithmetic is IEEE f32 on the FMA pipe (fused multiply-add), no tensor
// cores and no TF32: the refinement loop needs a true-f32 inverse. The
// rank-nb form sums nb products before it meets M, so the result equals
// the plain PyTorch version (kernels.py:_gj_core_plain) to rounding, not
// bit for bit.
//
// GJ_HOST_EMULATION: compiled as plain C++ against a small header that
// runs blocks and threads on the host (csrc/emulation/), so the CPU tests
// can run this file's index arithmetic and synchronisation; launches go
// through GJ_LAUNCH and dynamic shared memory through GJ_DYN_SMEM for
// that reason.

#include <cuda_runtime.h>
#include <cstddef>

#ifdef GJ_HOST_EMULATION
#define GJ_LAUNCH(kernel, grid, block, smem, stream, ...) \
  emulation::launch(grid, block, smem, [&] { kernel(__VA_ARGS__); })
#define GJ_DYN_SMEM(name) float4* name = emulation::dynamic_smem()
#else
#define GJ_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#define GJ_DYN_SMEM(name) extern __shared__ float4 name[]
#endif

namespace {

constexpr int kMaxPanel = 64;     // widest panel of the panel path
constexpr int kStage = 16;        // panel columns per cp.async stage
constexpr int kMaxStages = kMaxPanel / kStage;
constexpr int kTile = 128;        // update tile edge
constexpr int kThreads = 256;
constexpr int kStepRows = 32;     // rows per panel-step block: one lane each
constexpr int kStepGroups = kThreads / kStepRows;   // warps, striding columns
constexpr int kStepPerThread = kMaxPanel / kStepGroups;
constexpr int kSmallPanel = 32;   // widest panel of the one-block variant
constexpr int kSmallThreads = 512;
constexpr int kSmallMaxN = 512;
constexpr int kGatherCols = 32;
constexpr int kGatherRowThreads = 8;
constexpr int kGatherRows = 64;

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// ---- asynchronous copies ---------------------------------------------------

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
#ifdef GJ_HOST_EMULATION
  for (int c = 0; c < 4; ++c) smem[c] = gmem[c];
#else
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(gmem)
               : "memory");
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifndef GJ_HOST_EMULATION
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most `pending` of this thread's committed groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
#ifndef GJ_HOST_EMULATION
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
#endif
}

__device__ __forceinline__ void prefetch_l2(const void* gmem) {
#ifndef GJ_HOST_EMULATION
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(gmem));
#endif
}

// ---- pivot search -----------------------------------------------------------

// the better of two pivot candidates: larger |value|, then lower row
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// |x| as a pivot candidate; a NaN never wins (it compares false)
__device__ __forceinline__ float candidate(float x) {
  const float a = fabsf(x);
  return a > -1.0f ? a : -1.0f;
}

// Warp-wide best candidate, left in every lane (all 32 lanes call it).
__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    better(v, i, v2, i2);
  }
}

// Block-wide best candidate's row, returned to every thread. s_val/s_idx hold
// one slot per warp; blockDim.x is a multiple of 32.
__device__ int block_best(float v, int i, float* s_val, int* s_idx) {
  warp_best(v, i);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the slots' last readers are done
  if (lane == 0) {
    s_val[warp] = v;
    s_idx[warp] = i;
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = lane < nwarps ? s_val[lane] : -1.0f;
  i = lane < nwarps ? s_idx[lane] : 0x7fffffff;
  warp_best(v, i);
  return i;
}

// ---- the one-block variant (N <= kSmallMaxN) ---------------------------------

// dynamic shared memory, in floats: panel sP[B][pitch], pivot rows
// sR[B][pitch], multipliers sc[pitch], then the small arrays; reads past a
// row's end (a ragged last tile) stay inside the allocation
__host__ __device__ inline int small_pitch(int N) { return round_up(N, 4) + 4; }
__host__ __device__ inline size_t small_smem_bytes(int N) {
  return sizeof(float) *
         ((size_t)(2 * kSmallPanel + 1) * small_pitch(N) + 4 * kSmallPanel +
          2 * 32 + kTile);
}

__global__ void __launch_bounds__(kSmallThreads, 1)
    gj_small_kernel(float* __restrict__ work, int* __restrict__ perm, int N,
                    int ld, int B) {
  GJ_DYN_SMEM(smem4);
  const int pitch = small_pitch(N);
  float* sP = reinterpret_cast<float*>(smem4);
  float* sR = sP + (size_t)kSmallPanel * pitch;
  float* sc = sR + (size_t)kSmallPanel * pitch;
  float* s_r = sc + pitch;                 // scaled pivot row, [B]
  float* s_rowk = s_r + kSmallPanel;       // row k before the swap, [B]
  int* s_perm = reinterpret_cast<int*>(s_rowk + kSmallPanel);  // [B]
  float* s_val = reinterpret_cast<float*>(s_perm + kSmallPanel);  // [32]
  int* s_idx = reinterpret_cast<int*>(s_val + 32);                // [32]

  float* M = work + (size_t)blockIdx.x * N * ld;
  int* pm = perm + (size_t)blockIdx.x * N;
  const int tid = threadIdx.x;
  const int ti = tid & (kTile - 1), tj = tid >> 7;   // panel step: 128 x 4
  const int tx = tid & 31, ty = tid >> 5;            // update: 32 x 16

  for (int k0 = 0; k0 < N; k0 += B) {
    const int nb = min(B, N - k0);

    // 1. the panel into shared memory, column-major
    for (int e = tid; e < N * nb; e += kSmallThreads) {
      const int i = e / nb, j = e - i * nb;
      sP[j * pitch + i] = M[(size_t)i * ld + k0 + j];
    }
    __syncthreads();

    // 2. nb in-place steps on the panel
    for (int kk = 0; kk < nb; ++kk) {
      const int k = k0 + kk;
      float best = -1.0f;
      int bi = N;
      for (int i = k + tid; i < N; i += kSmallThreads)
        better(best, bi, candidate(sP[kk * pitch + i]), i);
      if (best < 0.0f) bi = N;
      int p = block_best(best, bi, s_val, s_idx);
      if (p >= N) p = k;  // whole column NaN: keep the diagonal
      if (tid < nb) {
        const float piv = sP[kk * pitch + p];
        s_r[tid] = (tid == kk) ? __fdiv_rn(1.0f, piv)
                               : __fdiv_rn(sP[tid * pitch + p], piv);
        s_rowk[tid] = sP[tid * pitch + k];
      }
      if (tid == 0) {
        s_perm[kk] = p;
        pm[k] = p;
      }
      for (int i = tid; i < N; i += kSmallThreads) sc[i] = sP[kk * pitch + i];
      __syncthreads();
      // rows k and p trade places as they are read: row k becomes the
      // scaled pivot row, row p is updated from what row k held
      for (int i = ti; i < N; i += kTile) {
        const bool is_k = (i == k), is_p = (i == p);
        const float c = is_p ? s_rowk[kk] : sc[i];
        for (int j = tj; j < nb; j += kSmallThreads / kTile) {
          float v;
          if (is_k) {
            v = s_r[j];
          } else {
            const float a =
                (j == kk) ? 0.0f : (is_p ? s_rowk[j] : sP[j * pitch + i]);
            v = fmaf(-c, s_r[j], a);
          }
          sP[j * pitch + i] = v;
        }
      }
      __syncthreads();
    }

    // 3. the panel's swaps on the other columns; pivot rows to shared memory
    for (int j = tid; j < N; j += kSmallThreads) {
      if (j >= k0 && j < k0 + nb) continue;
      for (int kk = 0; kk < nb; ++kk) {
        const int k = k0 + kk, p = s_perm[kk];
        if (p != k) {
          const float a = M[(size_t)k * ld + j];
          M[(size_t)k * ld + j] = M[(size_t)p * ld + j];
          M[(size_t)p * ld + j] = a;
        }
      }
      for (int kk = 0; kk < nb; ++kk)
        sR[kk * pitch + j] = M[(size_t)(k0 + kk) * ld + j];
    }
    __syncthreads();

    // 4. rank-nb update of the other columns, 128 x 128 tiles
    for (int it = 0; it < N; it += kTile) {
      for (int jt = 0; jt < N; jt += kTile) {
        const int ib = it + ty * 8, jb = jt + tx;
        float m[8][4], acc[8][4];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int i = ib + a;
          const bool piv_row = (i >= k0 && i < k0 + nb);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = jb + 32 * b;
            const bool live = i < N && j < N && !(j >= k0 && j < k0 + nb);
            m[a][b] = (live && !piv_row) ? M[(size_t)i * ld + j] : 0.0f;
            acc[a][b] = 0.0f;
          }
        }
#pragma unroll 4
        for (int kq = 0; kq < nb; ++kq) {
          const float4 a_lo =
              *reinterpret_cast<const float4*>(&sP[kq * pitch + ib]);
          const float4 a_hi =
              *reinterpret_cast<const float4*>(&sP[kq * pitch + ib + 4]);
          const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                               a_hi.x, a_hi.y, a_hi.z, a_hi.w};
          float bv[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) bv[b] = sR[kq * pitch + jb + 32 * b];
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int i = ib + a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = jb + 32 * b;
            if (i < N && j < N && !(j >= k0 && j < k0 + nb))
              M[(size_t)i * ld + j] = m[a][b] + acc[a][b];
          }
        }
      }
    }

    // 5. the panel's columns <- G
    for (int e = tid; e < N * nb; e += kSmallThreads) {
      const int i = e / nb, j = e - i * nb;
      M[(size_t)i * ld + k0 + j] = sP[j * pitch + i];
    }
    __syncthreads();
  }
}

// ---- the panel path (any N) ---------------------------------------------------

// Copy the panel M[:, k0:k0+nb] into the column-major buffer P (nb x Np) and
// leave each 32-row block's pivot candidate for column k0.
__global__ void __launch_bounds__(kThreads)
    gj_panel_load_kernel(const float* __restrict__ work, float* __restrict__ P,
                         float* __restrict__ cand_val,
                         int* __restrict__ cand_idx, int N, int ld, int Np,
                         int B, int k0, int nb) {
  __shared__ float tile[kStepRows][kMaxPanel + 1];
  const float* M = work + (size_t)blockIdx.y * N * ld;
  float* Pm = P + (size_t)blockIdx.y * B * Np;
  const int tid = threadIdx.x, i0 = blockIdx.x * kStepRows;
  for (int e = tid; e < kStepRows * nb; e += kThreads) {
    const int r = e / nb, j = e - r * nb;
    tile[r][j] = (i0 + r < N) ? M[(size_t)(i0 + r) * ld + k0 + j] : 0.0f;
  }
  __syncthreads();
  for (int e = tid; e < kStepRows * nb; e += kThreads) {
    const int j = e / kStepRows, r = e - j * kStepRows;
    if (i0 + r < N) Pm[(size_t)j * Np + i0 + r] = tile[r][j];
  }
  if (tid < 32) {
    const int i = i0 + tid;
    float v = (i < N && i >= k0) ? candidate(tile[tid][0]) : -1.0f;
    int bi = v >= 0.0f ? i : N;
    warp_best(v, bi);
    if (tid == 0) {
      const size_t slot = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
      cand_val[slot] = v;
      cand_idx[slot] = bi;
    }
  }
}

// One in-place step, column k = k0 + kk, on the panel alone: src -> dst
// (both nb x Np, column-major). A block owns 32 rows, one per lane; its 8
// warps stride over the panel's columns and never wait for each other:
// each warp reduces the candidates the previous launch left (so all agree
// on the pivot row p) and reads the pivot row's entries it needs itself.
// A thread's own values are requested before the pivot is known.
__global__ void __launch_bounds__(kThreads)
    gj_panel_step_kernel(const float* __restrict__ src, float* __restrict__ dst,
                         const float* __restrict__ cand_val_in,
                         const int* __restrict__ cand_idx_in,
                         float* __restrict__ cand_val_out,
                         int* __restrict__ cand_idx_out,
                         int* __restrict__ perm, int N, int Np, int B, int k,
                         int kk, int nb) {
  const float* S = src + (size_t)blockIdx.y * B * Np;
  float* D = dst + (size_t)blockIdx.y * B * Np;
  const int lane = threadIdx.x & 31, jg = threadIdx.x >> 5;
  const int nsb = gridDim.x;
  const int i = blockIdx.x * kStepRows + lane;
  const bool live = i < N;

  float own[kStepPerThread], row_k[kStepPerThread];
#pragma unroll
  for (int q = 0; q < kStepPerThread; ++q) {
    const int j = jg + kStepGroups * q;
    own[q] = (live && j < nb) ? S[(size_t)j * Np + i] : 0.0f;
    row_k[q] = (j < nb) ? S[(size_t)j * Np + k] : 0.0f;
  }
  float c = live ? S[(size_t)kk * Np + i] : 0.0f;
  const float row_k_kk = S[(size_t)kk * Np + k];

  float best = -1.0f;
  int p = N;
  for (int b = lane; b < nsb; b += 32)
    better(best, p, cand_val_in[(size_t)blockIdx.y * nsb + b],
           cand_idx_in[(size_t)blockIdx.y * nsb + b]);
  warp_best(best, p);
  if (p >= N) p = k;  // whole column NaN: keep the diagonal
  if (blockIdx.x == 0 && threadIdx.x == 0)
    perm[(size_t)blockIdx.y * N + k] = p;

  // rows k and p trade places as they are read: row k becomes the scaled
  // pivot row, row p is updated from what row k held
  const float piv = S[(size_t)kk * Np + p];
  float row_p[kStepPerThread];
#pragma unroll
  for (int q = 0; q < kStepPerThread; ++q) {
    const int j = jg + kStepGroups * q;
    row_p[q] = (j < nb) ? S[(size_t)j * Np + p] : 0.0f;
  }
  const bool is_k = (i == k), is_p = (i == p);
  if (is_p) c = row_k_kk;
  float v_next = -1.0f;
#pragma unroll
  for (int q = 0; q < kStepPerThread; ++q) {
    const int j = jg + kStepGroups * q;
    if (j < nb && live) {
      const float r = (j == kk) ? __fdiv_rn(1.0f, piv)
                                : __fdiv_rn(row_p[q], piv);
      const float a = (j == kk) ? 0.0f : (is_p ? row_k[q] : own[q]);
      const float v = is_k ? r : fmaf(-c, r, a);
      D[(size_t)j * Np + i] = v;
      if (j == kk + 1 && i > k) v_next = candidate(v);
    }
  }
  // the warp that wrote column k + 1 holds the block's 32 candidates
  if (kk + 1 < nb && jg == ((kk + 1) & (kStepGroups - 1))) {
    int i_next = v_next >= 0.0f ? i : N;
    warp_best(v_next, i_next);
    if (lane == 0) {
      cand_val_out[(size_t)blockIdx.y * nsb + blockIdx.x] = v_next;
      cand_idx_out[(size_t)blockIdx.y * nsb + blockIdx.x] = i_next;
    }
  }
}

// The panel's row swaps on the other columns of M, one thread per column,
// then the pivot rows copied aside: R[kk, j] = M[k0 + kk, j].
__global__ void __launch_bounds__(kThreads)
    gj_swap_extract_kernel(float* __restrict__ work, float* __restrict__ Rbuf,
                           const int* __restrict__ perm, int N, int ld, int Np,
                           int B, int k0, int nb) {
  __shared__ int s_perm[kMaxPanel];
  float* M = work + (size_t)blockIdx.y * N * ld;
  float* R = Rbuf + (size_t)blockIdx.y * B * Np;
  if (threadIdx.x < nb)
    s_perm[threadIdx.x] = perm[(size_t)blockIdx.y * N + k0 + threadIdx.x];
  __syncthreads();
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= ld) return;
  if (!(j >= k0 && j < k0 + nb)) {
    for (int kk = 0; kk < nb; ++kk) {
      const int k = k0 + kk, p = s_perm[kk];
      if (p != k) {
        const float a = M[(size_t)k * ld + j];
        M[(size_t)k * ld + j] = M[(size_t)p * ld + j];
        M[(size_t)p * ld + j] = a;
      }
    }
  }
  for (int kk = 0; kk < nb; ++kk)
    R[(size_t)kk * Np + j] = M[(size_t)(k0 + kk) * ld + j];
}

// One depth step of a thread's 8 x 8 block: rows ty*4.. and 64+ty*4.., columns
// tx*4.. and 64+tx*4.. of the tile (16-byte shared-memory reads, conflict-free)
__device__ __forceinline__ void rank_step(const float* As, const float* Bs,
                                          int kq, int tx, int ty,
                                          float (&acc)[8][8]) {
  const float4 a_lo = *reinterpret_cast<const float4*>(&As[kq * kTile + ty * 4]);
  const float4 a_hi =
      *reinterpret_cast<const float4*>(&As[kq * kTile + 64 + ty * 4]);
  const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[kq * kTile + tx * 4]);
  const float4 b_hi =
      *reinterpret_cast<const float4*>(&Bs[kq * kTile + 64 + tx * 4]);
  const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                       a_hi.x, a_hi.y, a_hi.z, a_hi.w};
  const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                       b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
}

// Rank-nb update of one 128 x 128 tile of M from G (nb x Np, column-major:
// G[kq, i]) and R (nb x Np: R[kq, j]); the panel's own columns <- G.
__global__ void __launch_bounds__(kThreads, 2)
    gj_rank_update_kernel(float* __restrict__ work, const float* __restrict__ Gbuf,
                          const float* __restrict__ Rbuf, int N, int ld, int Np,
                          int B, int k0, int nb) {
  GJ_DYN_SMEM(smem4);
  float* sm = reinterpret_cast<float*>(smem4);
  float* M = work + (size_t)blockIdx.z * N * ld;
  const float* G = Gbuf + (size_t)blockIdx.z * B * Np;
  const float* R = Rbuf + (size_t)blockIdx.z * B * Np;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int j0 = blockIdx.x * kTile, i0 = blockIdx.y * kTile;
  const int stages = (nb + kStage - 1) / kStage;

  // every stage requested at once: stage t holds G[t*16 .. t*16+15, i0..+127]
  // and the same rows of R at j0. Np is a multiple of 128, so no copy leaves
  // its row
  for (int t = 0; t < stages; ++t) {
    float* As = sm + (size_t)t * 2 * kStage * kTile;
    float* Bs = As + kStage * kTile;
    for (int e = tid; e < kStage * kTile / 4; e += kThreads) {
      const int row = e >> 5, c4 = (e & 31) * 4, kq = t * kStage + row;
      if (kq < nb) {
        cp_async16(&As[row * kTile + c4], &G[(size_t)kq * Np + i0 + c4]);
        cp_async16(&Bs[row * kTile + c4], &R[(size_t)kq * Np + j0 + c4]);
      }
    }
    cp_async_commit();
  }
  // the M tile on its way to L2 while the product runs
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? ty * 4 + a : 64 + ty * 4 + a - 4);
    // 8 threads share 128 bytes of a row, which may straddle two lines
    if (i < N && (tx & 3) == 0) {
      const int j = j0 + (tx & 8 ? 64 : 0) + (tx & 4 ? 28 : 0);
      prefetch_l2(&M[(size_t)i * ld + min(j, ld - 4)]);
      prefetch_l2(&M[(size_t)i * ld + min(j + 32, ld - 4)]);
    }
  }

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;

  for (int t = 0; t < stages; ++t) {
    cp_async_wait(stages - 1 - t);
    __syncthreads();
    const float* As = sm + (size_t)t * 2 * kStage * kTile;
    const float* Bs = As + kStage * kTile;
    const int depth = min(kStage, nb - t * kStage);
    if (depth == kStage) {
#pragma unroll
      for (int kq = 0; kq < kStage; ++kq) rank_step(As, Bs, kq, tx, ty, acc);
    } else {
      for (int kq = 0; kq < depth; ++kq) rank_step(As, Bs, kq, tx, ty, acc);
    }
  }

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? ty * 4 + a : 64 + ty * 4 + a - 4);
    if (i >= N) continue;
    const bool piv_row = (i >= k0 && i < k0 + nb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * 64 + tx * 4;
      if (j >= ld) continue;
      float4* at = reinterpret_cast<float4*>(&M[(size_t)i * ld + j]);
      float4 out;
      if (j >= k0 && j < k0 + nb) {
        // k0 is a multiple of 4, so a group of 4 columns lies in the panel
        // or outside it; past its ragged end the columns are padding
        const int jj = j - k0;
        out.x = G[(size_t)jj * Np + i];
        out.y = (jj + 1 < nb) ? G[(size_t)(jj + 1) * Np + i] : 0.0f;
        out.z = (jj + 2 < nb) ? G[(size_t)(jj + 2) * Np + i] : 0.0f;
        out.w = (jj + 3 < nb) ? G[(size_t)(jj + 3) * Np + i] : 0.0f;
      } else {
        out = piv_row ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : *at;
        out.x += acc[a][h * 4 + 0];
        out.y += acc[a][h * 4 + 1];
        out.z += acc[a][h * 4 + 2];
        out.w += acc[a][h * 4 + 3];
      }
      *at = out;
    }
  }
}

// ---- undoing the swaps ----------------------------------------------------------

// g = the column order that undoes the row swaps: the recorded
// transpositions applied in reverse to the identity. Sequential, one thread
// per matrix, in shared memory where 2 N ints fit (else in device memory).
__global__ void gj_perm_kernel(const int* __restrict__ perm,
                               int* __restrict__ g, int N, int in_smem) {
  GJ_DYN_SMEM(smem4);
  const int* pm = perm + (size_t)blockIdx.x * N;
  int* gm = g + (size_t)blockIdx.x * N;
  int* s_g = in_smem ? reinterpret_cast<int*>(smem4) : gm;
  const int* s_p = pm;
  if (in_smem) {
    int* s_pw = s_g + N;
    for (int j = threadIdx.x; j < N; j += blockDim.x) s_pw[j] = pm[j];
    s_p = s_pw;
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x) s_g[j] = j;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int r = N - 1; r >= 0; --r) {
      const int p = s_p[r];
      const int t = s_g[r];
      s_g[r] = s_g[p];
      s_g[p] = t;
    }
  }
  __syncthreads();
  if (in_smem)
    for (int j = threadIdx.x; j < N; j += blockDim.x) gm[j] = s_g[j];
}

__global__ void gj_gather_kernel(const float* __restrict__ W,
                                 float* __restrict__ out,
                                 const int* __restrict__ g, int N, int ld) {
  const int j = blockIdx.x * kGatherCols + threadIdx.x;
  if (j >= N) return;
  const float* Wm = W + (size_t)blockIdx.z * N * ld;
  float* om = out + (size_t)blockIdx.z * N * N;
  const int gj = g[(size_t)blockIdx.z * N + j];
  const int i_end = min(N, (int)(blockIdx.y + 1) * kGatherRows);
  for (int i = blockIdx.y * kGatherRows + threadIdx.y; i < i_end;
       i += kGatherRowThreads) {
    om[(size_t)i * N + j] = Wm[(size_t)i * ld + gj];
  }
}

struct Plan {
  bool small;
  int B, ld, Np, nrb, nsb;   // nrb update row tiles, nsb panel-step blocks
};

Plan make_plan(int N, int panel, int variant) {
  Plan pl;
  pl.small = variant == 0;
  pl.B = panel;
  pl.ld = round_up(N, 4);
  pl.Np = round_up(N, kTile);
  pl.nrb = pl.Np / kTile;
  pl.nsb = (N + kStepRows - 1) / kStepRows;
  return pl;
}

bool plan_ok(const Plan& pl, int S, int N, int variant) {
  if (S <= 0 || N <= 0 || S > 65535 || pl.nsb > 65535) return false;
  if (variant != 0 && variant != 1) return false;
  if (pl.small) return N <= kSmallMaxN && pl.B >= 1 && pl.B <= kSmallPanel;
  // panels start on multiples of 4 (16-byte groups of the update's epilogue)
  return pl.B >= 4 && pl.B <= kMaxPanel && pl.B % 4 == 0;
}

}  // namespace

// Row pitch, in floats, of the working matrix for order N.
extern "C" int gj_work_pitch(int N) { return round_up(N, 4); }

// Scratch the caller allocates for an (S, N, N) batch: floats (panel buffer
// pair, pivot rows, pivot candidates) and ints (candidates' rows, perm, g).
// variant: 0 the one-block kernel (N <= 512, panel <= 32), 1 the panel path
// (panel a multiple of 4, <= 64). 0 where there is no such kernel.
extern "C" long long gj_scratch_floats(int S, int N, int panel, int variant) {
  const Plan pl = make_plan(N, panel, variant);
  if (!plan_ok(pl, S, N, variant)) return 0;
  if (pl.small) return 4;
  return (long long)S * (3LL * pl.B * pl.Np + 2LL * pl.nsb);
}

extern "C" long long gj_scratch_ints(int S, int N, int panel, int variant) {
  const Plan pl = make_plan(N, panel, variant);
  if (!plan_ok(pl, S, N, variant)) return 0;
  return (long long)S * (2LL * N + (pl.small ? 0 : 2LL * pl.nsb));
}

// work: (S, N, ld) input with ld = gj_work_pitch(N), overwritten with
// inv(P A); out: (S, N, N) inverse; fscratch, iscratch: as sized above, for
// the same panel and variant. Returns the first CUDA error, 0 on success.
extern "C" int gj_inverse_f32(float* work, float* out, float* fscratch,
                              int* iscratch, int S, int N, int panel,
                              int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl = make_plan(N, panel, variant);
  if (!plan_ok(pl, S, N, variant)) return (int)cudaErrorInvalidValue;
  const int B = pl.B, ld = pl.ld, Np = pl.Np, nrb = pl.nrb, nsb = pl.nsb;
  int* perm = iscratch;
  int* g = perm + (size_t)S * N;
  cudaError_t e;

  if (pl.small) {
    const size_t bytes = small_smem_bytes(N);
    e = cudaFuncSetAttribute(gj_small_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    GJ_LAUNCH(gj_small_kernel, dim3(S), dim3(kSmallThreads), bytes, st, work,
              perm, N, ld, B);
  } else {
    float* P[2] = {fscratch, fscratch + (size_t)S * B * Np};
    float* Rbuf = fscratch + 2 * (size_t)S * B * Np;
    float* cval[2] = {Rbuf + (size_t)S * B * Np,
                      Rbuf + (size_t)S * B * Np + (size_t)S * nsb};
    int* cidx[2] = {g + (size_t)S * N, g + (size_t)S * N + (size_t)S * nsb};
    const size_t stage_bytes = sizeof(float) * 2 * kStage * kTile;
    e = cudaFuncSetAttribute(gj_rank_update_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(kMaxStages * stage_bytes));
    if (e != cudaSuccess) return (int)e;
    const dim3 rows(nsb, S);
    for (int k0 = 0; k0 < N; k0 += B) {
      const int nb = min(B, N - k0);
      GJ_LAUNCH(gj_panel_load_kernel, rows, dim3(kThreads), 0, st, work, P[0],
                cval[0], cidx[0], N, ld, Np, B, k0, nb);
      for (int kk = 0; kk < nb; ++kk) {
        const int a = kk & 1, b = a ^ 1;
        GJ_LAUNCH(gj_panel_step_kernel, rows, dim3(kThreads), 0, st, P[a], P[b],
                  cval[a], cidx[a], cval[b], cidx[b], perm, N, Np, B, k0 + kk,
                  kk, nb);
      }
      GJ_LAUNCH(gj_swap_extract_kernel, dim3((ld + kThreads - 1) / kThreads, S),
                dim3(kThreads), 0, st, work, Rbuf, perm, N, ld, Np, B, k0, nb);
      const int stages = (nb + kStage - 1) / kStage;
      GJ_LAUNCH(gj_rank_update_kernel, dim3((ld + kTile - 1) / kTile, nrb, S),
                dim3(kThreads), stages * stage_bytes, st, work, P[nb & 1], Rbuf,
                N, ld, Np, B, k0, nb);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t perm_bytes = 2 * sizeof(int) * (size_t)N;
  const int in_smem = perm_bytes <= 200 * 1024;
  if (in_smem) {
    e = cudaFuncSetAttribute(gj_perm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)perm_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  GJ_LAUNCH(gj_perm_kernel, dim3(S), dim3(kThreads), in_smem ? perm_bytes : 0,
            st, perm, g, N, in_smem);
  GJ_LAUNCH(gj_gather_kernel,
            dim3((N + kGatherCols - 1) / kGatherCols,
                 (N + kGatherRows - 1) / kGatherRows, S),
            dim3(kGatherCols, kGatherRowThreads), 0, st, work, out, g, N, ld);
  return (int)cudaGetLastError();
}
