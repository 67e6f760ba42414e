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
// Three variants, chosen from N by the caller (kernels.py:gj_variant):
//
// * gj_small_kernel (variant 0, N <= 512): one block of 512 threads per
//   matrix walks all panels (width <= 32) inside one launch. The panel and
//   the pivot rows live in shared memory (column-major, so a panel step
//   walks rows with unit stride); the rank-nb update runs 128 x 128 tiles
//   with an 8 x 4 register block per thread, the M tile fetched before the
//   product and written after it. A batch of 96 matrices fills 96 of the
//   132 SMs; the whole inverse is 3 launches.
//
// * the panel path (variants 1 and 2): the panel's steps leave G in a
//   column-major scratch buffer (nb x Np) in device memory; then one launch
//   swaps rows and copies R aside, and one launch does the rank-nb update:
//   128 x 128 output tiles, 256 threads with an 8 x 8 register block each,
//   G and R tiles brought into shared memory by cp.async in 16-deep stages
//   that are waited for one by one, so later stages land while the first
//   are multiplied; the M tile is prefetched to L2 meanwhile, and two
//   blocks share an SM so one tile's epilogue overlaps another's product.
//   The working matrix has a row pitch that is a multiple of 4 floats, so
//   every M access of the update is a 16-byte one for any N. The steps:
//
//   - variant 2, the cluster panel (N up to 16 x 608 = 9,728): one launch
//     a panel. A thread block cluster a matrix of C blocks (about 192 rows
//     a block, at most 16 blocks: a non-portable size above 8) holds the
//     panel in its threads' registers, a row a thread, and steps all its
//     columns; blocks exchange each column's candidates and rows by
//     asynchronous stores into each other's shared memory, counted on
//     mbarriers, so no launch and no cluster barrier separates two columns
//     (gj_cluster_panel_kernel). 3 ceil(N / nb) + 2 launches per inverse.
//
//   - variant 1, a launch a column (any N): the panel lives in the scratch
//     buffer, small enough to stay in L2. One launch per column does the
//     step on the panel alone, over all 32-row blocks at once (a block per
//     matrix would be held to one SM's share of the L2 rate): each warp
//     reduces the per-block pivot candidates the previous launch left,
//     reads the pivot row's entries it needs, updates its rows from the
//     source buffer into the other buffer of a pair (so no block reads a
//     row another block is writing; the row swap is folded into the reads),
//     and the warp that wrote the next column leaves the block's candidate
//     for it. No block-wide barrier; a thread's own loads are in flight
//     before the pivot is known. N + 3 ceil(N / nb) + 2 launches per
//     inverse.
//
//   Both variants do the same operations on the same values (the divisions
//   by the pivot, the fused multiply-adds, the candidates' order), so their
//   inverses and pivot rows are equal bit for bit.
//
// Measured on an H100 (80GB HBM3, 700 W; tools/gj_sweep.py): panels of 64
// beat 32 and 48 on the panel path ((2, 4801, 4801): 46.9 / 52.7 / 48.4 ms;
// (1, 12097, 12097): 208.9 ms against 265.0 at 32), and 32 beats 16 in the
// one-block kernel ((96, 369, 369): 1.78 against 1.93 ms). The update runs
// at 28-29 TFLOP/s while moving M at ~1.8 TB/s: neither pipe is full, the
// two phases of a tile overlap only across the two blocks of an SM. A
// launch a column costs 4.4-5.6 us of device time; the cluster panel steps
// a column in 1.5 us at (2, 3105, 3105) (the panel phase 13.6 -> 4.8 ms,
// the inverse's device time 20.7 -> 11.9 ms), 1.7 us at (2, 4801, 4801)
// (23.2 -> 8.1 ms, 43.1 -> 28.3 ms) and 1.4 us at (8, 1685, 1685) (9.2 ->
// 2.4 ms). Of those 1.5 us the update itself (64 fused multiply-adds a
// thread) is a small part: the column's chain of dependent steps (the
// block's candidate, the stores across the cluster, the wait, the
// reductions, the division) sets it; more blocks shorten it until ~192
// rows a block. A cluster barrier a column instead of the mbarriers cost
// 0.7 us of it (2.5 us a column). Look-ahead was tried on variant 1 and
// taken out again: with the next panel's steps on a second,
// high-priority stream beside the rest of this panel's update (the update
// capped at 112 registers so a step block fits beside two of its blocks)
// the inverse gained 1 % at N = 4801 and 4 % at N = 12097: both kernels
// slow down when they share the SMs (a step launch 5.6 -> 9.3 us, an
// update 636 -> 760 us).
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
// through GJ_LAUNCH (GJ_LAUNCH_CLUSTER: the blocks of a cluster at once)
// and dynamic shared memory through GJ_DYN_SMEM for that reason.

#include <cuda_runtime.h>
#include <cstddef>

#ifdef GJ_HOST_EMULATION
#define GJ_LAUNCH(kernel, grid, block, smem, stream, ...) \
  emulation::launch(grid, block, smem, [&] { kernel(__VA_ARGS__); })
#define GJ_LAUNCH_CLUSTER(kernel, size, grid, block, smem, stream, ...)   \
  (emulation::launch_cluster(size, grid, block, smem,                    \
                             [&] { kernel(__VA_ARGS__); }),              \
   cudaSuccess)
#define GJ_DYN_SMEM(name) float4* name = emulation::dynamic_smem()
#else
#define GJ_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#define GJ_LAUNCH_CLUSTER(kernel, size, grid, block, smem, stream, ...) \
  launch_cluster(kernel, size, grid, block, smem, stream, __VA_ARGS__)
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
constexpr int kClusterRows = 608;   // most rows of a cluster block
constexpr int kMaxCluster = 16;     // largest cluster (above 8: non-portable)
constexpr int kPlanRows = 192;      // rows a cluster block the plan aims at
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

// ---- thread block clusters -------------------------------------------------

#ifdef GJ_HOST_EMULATION
inline void cluster_sync() { emulation::cluster_sync(); }
inline void mbar_init(unsigned long long* m) { emulation::mbar_init(m, 1); }
inline void mbar_init_fence() {}
inline void mbar_expect(unsigned long long* m, int bytes) {
  emulation::mbar_update(m, 1, bytes);
}
inline void mbar_wait(unsigned long long* m, unsigned parity) {
  emulation::mbar_wait(m, parity);
}
inline void push16(float* dst, unsigned long long* bar, int rank, float4 v) {
  *emulation::cluster_map(reinterpret_cast<float4*>(dst), rank) = v;
  emulation::mbar_update(emulation::cluster_map(bar, rank), 0, -16);
}
#else
// every thread of every block of the cluster arrives (release), then waits
// (acquire): shared-memory writes before it are seen by the cluster's reads
// after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive;\n"
      "barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// an mbarrier of one arrival a phase, the arrival carrying the bytes the
// phase waits for
__device__ __forceinline__ void mbar_init(unsigned long long* m) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(m))
               : "memory");
}
// the barriers' initialisation, seen by the cluster (before its barrier)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* m, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(m)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` completes; what the cluster stored
// with it is then seen
__device__ __forceinline__ void mbar_wait(unsigned long long* m,
                                          unsigned parity) {
  const unsigned a = smem_u32(m);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
// 16 bytes to block `rank`'s copy of dst, counted on its copy of bar
__device__ __forceinline__ void push16(float* dst, unsigned long long* bar,
                                       int rank, float4 v) {
  unsigned d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(b)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(d),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(b)
      : "memory");
}
template <class... Params, class... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int size, dim3 grid,
                           dim3 block, size_t smem, cudaStream_t st,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}
#endif

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

// Warp-wide best candidate, left in every lane (all 32 lanes call it): the
// largest |value| as a key (its bits plus one, 0 for none) in one warp
// reduction, then the lowest row of that key in another; the same choice
// as `better` over the lanes.
__device__ __forceinline__ void warp_best(float& v, int& i) {
  const unsigned key = v >= 0.0f ? __float_as_uint(v) + 1u : 0u;
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  i = (int)__reduce_min_sync(0xffffffffu,
                             key == top ? (unsigned)i : 0xffffffffu);
  v = top == 0u ? -1.0f : __uint_as_float(top - 1u);
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

// ---- the cluster panel (variant 2) ------------------------------------------

// floats a block receives from each block of the cluster a column: its
// candidate's value and row, two floats of padding, the candidate's 64
// panel entries
constexpr int kRecv = 4 + kMaxPanel;

// dynamic shared memory of a cluster block of C blocks and W warps, in
// floats, all but s_r by column parity: what it receives a column,
// s_recv[2][C][kRecv] and row k s_recvk[2][64]; each warp's candidate row
// s_wrows[2][W][64] and row k s_rowk[2][64]; each warp's copy of the
// column's scaled pivot row s_r[W][64]; the two mbarriers; each warp's
// candidate (value, row) s_wcand[2][W][2]
__host__ __device__ inline int cluster_smem_floats(int W, int C) {
  return 2 * C * kRecv + (3 * W + 4) * kMaxPanel + 4 + 4 * W;
}

// a thread's panel row to shared memory, 16 bytes at a time
__device__ __forceinline__ void store_row(float* dst,
                                          const float (&x)[kMaxPanel]) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < kMaxPanel / 4; ++q)
    d[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// The warp's best candidate for column k (x[0] of rows i >= k): its value
// and row, and the winning lane's whole panel row; the thread of row k
// leaves its row in s_rowk.
__device__ __forceinline__ void publish_candidate(
    const float (&x)[kMaxPanel], int i, int k, bool live, int N, int warp,
    int lane, float* s_wrows, float* s_rowk, float* s_wcand) {
  float v = (live && i >= k) ? candidate(x[0]) : -1.0f;
  int bi = v >= 0.0f ? i : N;
  warp_best(v, bi);
  if (i == bi) store_row(s_wrows + warp * kMaxPanel, x);
  if (i == k) store_row(s_rowk, x);
  if (lane == 0) {
    s_wcand[2 * warp] = v;
    s_wcand[2 * warp + 1] = __int_as_float(bi);
  }
}

// Every warp of the block: the block's best candidate for column k (the
// best of its warps'), with its row, and row k where this block owns it,
// stored into every block of the cluster, a 16-byte store a thread.
__device__ __forceinline__ void push_candidate(
    int k, int par, int N, int R, int W, int C, int rank, int lane,
    const float* s_wcand, const float* s_wrows, const float* s_rowk,
    float* s_recv, float* s_recvk, unsigned long long* mbar) {
  constexpr int chunks = kRecv / 4, row_chunks = kMaxPanel / 4;
  float v = lane < W ? s_wcand[2 * lane] : -1.0f;
  int bi = lane < W ? __float_as_int(s_wcand[2 * lane + 1]) : N;
  warp_best(v, bi);
  const float4* row = reinterpret_cast<const float4*>(
      s_wrows + (bi < N ? (bi - rank * R) >> 5 : 0) * kMaxPanel);
  const float4* rk = reinterpret_cast<const float4*>(s_rowk);
  float* mine = s_recv + (par * C + rank) * kRecv;
  const int n_cand = C * chunks;
  const int total = n_cand + (k / R == rank ? C * row_chunks : 0);
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    if (e < n_cand) {
      const int peer = e / chunks, c = e - peer * chunks;
      push16(mine + 4 * c, &mbar[par], peer,
             c == 0 ? make_float4(v, __int_as_float(bi), 0.0f, 0.0f)
                    : row[c - 1]);
    } else {
      const int peer = (e - n_cand) / row_chunks;
      const int c = e - n_cand - peer * row_chunks;
      push16(s_recvk + par * kMaxPanel + 4 * c, &mbar[par], peer, rk[c]);
    }
  }
}

// The panel step of a whole panel in one launch: one cluster of C =
// gridDim.x blocks a matrix (blockIdx.y). Block r owns rows [r R, r R + R),
// R = blockDim.x, one a thread, the row's panel entries in the thread's
// registers, kept rotated so that every index is known to the compiler: at
// column kk, x[q] holds M[i, k0 + (kk + q) % 64], so the column's entry is
// x[0] and the step writes column kk + 1 + q to x[q]. Per column: each warp
// leaves its pivot candidate (the lowest row >= k with the largest
// |M[i, k]|, as the column path reduces them) with that row, and row k's
// thread leaves row k; after a block barrier the warps store the block's
// best, with its row (and row k, from its owner), into every block of the
// cluster by asynchronous stores that count their bytes on the receiver's
// mbarrier. No cluster barrier: each warp waits for its block's mbarrier,
// agrees with the others on p (whole column NaN: k), scales the pivot row
// into its own copy, and steps its rows, the swap folded in as in the
// column path, with the same operations on the same values, so G and the
// pivot rows equal that path's bit for bit. A block stores column kk + 2
// into a peer only after that peer's column kk + 1, so two receive buffers
// and two mbarriers, by column parity, suffice. At the end G goes to Gbuf
// (nb x Np, column-major).
__global__ void __launch_bounds__(kClusterRows, 1)
    gj_cluster_panel_kernel(const float* __restrict__ work,
                            float* __restrict__ Gbuf, int* __restrict__ perm,
                            int N, int ld, int Np, int B, int k0, int nb) {
  GJ_DYN_SMEM(smem4);
  const int R = blockDim.x, W = R >> 5;
  const int C = gridDim.x, rank = blockIdx.x;
  float* s_recv = reinterpret_cast<float*>(smem4);
  float* s_recvk = s_recv + 2 * C * kRecv;
  float* s_wrows = s_recvk + 2 * kMaxPanel;
  float* s_rowk = s_wrows + 2 * W * kMaxPanel;
  float* s_r = s_rowk + 2 * kMaxPanel;
  unsigned long long* mbar =
      reinterpret_cast<unsigned long long*>(s_r + W * kMaxPanel);
  float* s_wcand = s_r + W * kMaxPanel + 4;
  // the warps' candidates of parity par: s_wcand + 2 W par, s_wrows +
  // 64 W par, s_rowk + 64 par
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* s_rw = s_r + warp * kMaxPanel;   // this warp's scaled pivot row

  const float* M = work + (size_t)blockIdx.y * N * ld;
  float* G = Gbuf + (size_t)blockIdx.y * B * Np;
  const int i = rank * R + tid;
  const bool live = i < N;
  float x[kMaxPanel];
#pragma unroll
  for (int q = 0; q < kMaxPanel / 4; ++q) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // k0 and ld are multiples of 4: a group that starts in the panel ends
    // inside the row
    if (live && 4 * q < nb)
      v = *reinterpret_cast<const float4*>(&M[(size_t)i * ld + k0 + 4 * q]);
    x[4 * q] = v.x;
    x[4 * q + 1] = 4 * q + 1 < nb ? v.y : 0.0f;
    x[4 * q + 2] = 4 * q + 2 < nb ? v.z : 0.0f;
    x[4 * q + 3] = 4 * q + 3 < nb ? v.w : 0.0f;
  }
  publish_candidate(x, i, k0, live, N, warp, lane, s_wrows, s_rowk,
                    s_wcand);
  if (tid == 0) {
    mbar_init(&mbar[0]);
    mbar_init(&mbar[1]);
    mbar_init_fence();
  }
  cluster_sync();   // the barriers exist; the first candidates are written

  for (int kk = 0; kk < nb; ++kk) {
    const int k = k0 + kk, par = kk & 1;
    if (tid == 0)
      mbar_expect(&mbar[par], 16 * (C * kRecv / 4 + kMaxPanel / 4));
    push_candidate(k, par, N, R, W, C, rank, lane, s_wcand + 2 * W * par,
                   s_wrows + W * kMaxPanel * par, s_rowk + kMaxPanel * par,
                   s_recv, s_recvk, mbar);
    mbar_wait(&mbar[par], (kk >> 1) & 1);

    // the cluster's best: p; this warp's copy of the scaled pivot row,
    // s_rw[q] = its column kk + 1 + q (1 / piv at q = 63)
    const float* got = s_recv + par * C * kRecv;
    float best = lane < C ? got[lane * kRecv] : -1.0f;
    int p = lane < C ? __float_as_int(got[lane * kRecv + 1]) : N;
    warp_best(best, p);
    if (p >= N) p = k;  // whole column NaN: keep the diagonal
    const float* row_k = s_recvk + par * kMaxPanel;
    const float* row_p = p == k ? row_k : got + (p / R) * kRecv + 4;
    const float piv = row_p[0];
    const float a = row_p[lane + 1];
    const float b = lane < 31 ? row_p[lane + 33] : 1.0f;
    s_rw[lane] = __fdiv_rn(a, piv);
    s_rw[lane + 32] = __fdiv_rn(b, piv);
    if (tid == 0 && rank == 0) perm[(size_t)blockIdx.y * N + k] = p;
    __syncwarp();

    // s_rw is read 16 bytes at a time, next to the products that use it
    const float4* r4 = reinterpret_cast<const float4*>(s_rw);
    if (i == k) {
      // row k becomes the scaled pivot row
#pragma unroll
      for (int q = 0; q < kMaxPanel / 4; ++q) {
        const float4 r = r4[q];
        x[4 * q] = r.x;
        x[4 * q + 1] = r.y;
        x[4 * q + 2] = r.z;
        x[4 * q + 3] = r.w;
      }
    } else if (i == p) {
      // row p is stepped from what row k held
      const float c = row_k[0];
#pragma unroll
      for (int q = 0; q < kMaxPanel / 4; ++q) {
        const float4 r = r4[q];
        const float rq[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int j = 4 * q + h;
          x[j] = fmaf(-c, rq[h], j < kMaxPanel - 1 ? row_k[j + 1] : 0.0f);
        }
      }
    } else {
      // x[j + 1] is read before it is written: in place
      const float c = x[0];
#pragma unroll
      for (int q = 0; q < kMaxPanel / 4; ++q) {
        const float4 r = r4[q];
        const float rq[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int j = 4 * q + h;
          x[j] = fmaf(-c, rq[h], j < kMaxPanel - 1 ? x[j + 1] : 0.0f);
        }
      }
    }
    if (kk + 1 < nb) {
      // the other parity's slots: a slower warp may still be storing this
      // column's from its own; they are free again after this barrier
      const int q = par ^ 1;
      publish_candidate(x, i, k + 1, live, N, warp, lane,
                        s_wrows + W * kMaxPanel * q, s_rowk + kMaxPanel * q,
                        s_wcand + 2 * W * q);
      __syncthreads();
    }
  }
  // no block leaves while a store to it may be on its way
  cluster_sync();

  // x[q] holds column (nb + q) % 64
  if (live) {
#pragma unroll
    for (int q = 0; q < kMaxPanel; ++q) {
      const int j = (nb + q) & (kMaxPanel - 1);
      if (j < nb) G[(size_t)j * Np + i] = x[q];
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
  int variant;
  int B, ld, Np, nrb, nsb;   // nrb update row tiles, nsb panel-step blocks
  int C, R;                  // variant 2: blocks a cluster, rows a block
};

// rows a block of a cluster of C blocks owns: whole warps
__host__ __device__ inline int cluster_rows(int N, int C) {
  return round_up((N + C - 1) / C, 32);
}

// The cluster the plan takes for order N: about kPlanRows rows a block, at
// most kMaxCluster blocks; 0 where those blocks cannot hold their rows.
int cluster_size(int N) {
  const int C = min(kMaxCluster, (N + kPlanRows - 1) / kPlanRows);
  return cluster_rows(N, C) <= kClusterRows ? C : 0;
}

Plan make_plan(int N, int panel, int variant, int cluster) {
  Plan pl;
  pl.variant = variant;
  pl.B = panel;
  pl.ld = round_up(N, 4);
  pl.Np = round_up(N, kTile);
  pl.nrb = pl.Np / kTile;
  pl.nsb = (N + kStepRows - 1) / kStepRows;
  pl.C = variant == 2 ? (cluster > 0 ? cluster : cluster_size(N)) : 0;
  pl.R = pl.C > 0 ? cluster_rows(N, pl.C) : 0;
  return pl;
}

bool plan_ok(const Plan& pl, int S, int N) {
  if (S <= 0 || N <= 0 || S > 65535 || pl.nsb > 65535) return false;
  if (pl.variant == 0)
    return N <= kSmallMaxN && pl.B >= 1 && pl.B <= kSmallPanel;
  if (pl.variant == 2 &&
      !(pl.C >= 1 && pl.C <= kMaxCluster && pl.R <= kClusterRows))
    return false;
  // panels start on multiples of 4 (16-byte groups of the update's epilogue)
  return (pl.variant == 1 || pl.variant == 2) && pl.B >= 4 &&
         pl.B <= kMaxPanel && pl.B % 4 == 0;
}

}  // namespace

// Row pitch, in floats, of the working matrix for order N.
extern "C" int gj_work_pitch(int N) { return round_up(N, 4); }

// Blocks a cluster that variant 2's plan takes for order N; 0 for none.
extern "C" int gj_plan_cluster(int N) { return cluster_size(N); }

// Scratch the caller allocates for an (S, N, N) batch: floats (the panel,
// twice for variant 1, the pivot rows, variant 1's pivot candidates) and
// ints (perm, g, variant 1's candidates' rows). variant: 0 the one-block
// kernel (N <= 512, panel <= 32), 1 the panel path, a launch a column, 2 the
// panel path, a cluster launch a panel (both: panel a multiple of 4,
// <= 64). cluster: variant 2's blocks a cluster, 0 for the plan's own. 0
// where there is no such kernel.
extern "C" long long gj_scratch_floats(int S, int N, int panel, int variant,
                                       int cluster) {
  const Plan pl = make_plan(N, panel, variant, cluster);
  if (!plan_ok(pl, S, N)) return 0;
  if (pl.variant == 0) return 4;
  if (pl.variant == 2) return (long long)S * 2LL * pl.B * pl.Np;
  return (long long)S * (3LL * pl.B * pl.Np + 2LL * pl.nsb);
}

extern "C" long long gj_scratch_ints(int S, int N, int panel, int variant,
                                     int cluster) {
  const Plan pl = make_plan(N, panel, variant, cluster);
  if (!plan_ok(pl, S, N)) return 0;
  return (long long)S * (2LL * N + (pl.variant == 1 ? 2LL * pl.nsb : 0));
}

// work: (S, N, ld) input with ld = gj_work_pitch(N), overwritten with
// inv(P A); out: (S, N, N) inverse; fscratch, iscratch: as sized above, for
// the same panel, variant and cluster. Returns the first CUDA error, 0 on
// success.
extern "C" int gj_inverse_f32(float* work, float* out, float* fscratch,
                              int* iscratch, int S, int N, int panel,
                              int variant, int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl = make_plan(N, panel, variant, cluster);
  if (!plan_ok(pl, S, N)) return (int)cudaErrorInvalidValue;
  const int B = pl.B, ld = pl.ld, Np = pl.Np, nrb = pl.nrb, nsb = pl.nsb;
  int* perm = iscratch;
  int* g = perm + (size_t)S * N;
  cudaError_t e;

  if (pl.variant == 0) {
    const size_t bytes = small_smem_bytes(N);
    e = cudaFuncSetAttribute(gj_small_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    GJ_LAUNCH(gj_small_kernel, dim3(S), dim3(kSmallThreads), bytes, st, work,
              perm, N, ld, B);
  } else {
    // variant 1: the panel buffer pair P[0], P[1], the pivot rows and the
    // candidates; variant 2: G in P[0], the pivot rows
    const size_t panel_floats = (size_t)S * B * Np;
    float* P[2] = {fscratch, fscratch + panel_floats};
    float* Rbuf = pl.variant == 2 ? P[1] : fscratch + 2 * panel_floats;
    const size_t stage_bytes = sizeof(float) * 2 * kStage * kTile;
    e = cudaFuncSetAttribute(gj_rank_update_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(kMaxStages * stage_bytes));
    if (e != cudaSuccess) return (int)e;
    if (pl.C > 8) {
      e = cudaFuncSetAttribute(gj_cluster_panel_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
      if (e != cudaSuccess) return (int)e;
    }
    const size_t cluster_bytes =
        sizeof(float) * cluster_smem_floats(pl.R / 32, pl.C);
    const dim3 rows(nsb, S);
    for (int k0 = 0; k0 < N; k0 += B) {
      const int nb = min(B, N - k0);
      if (pl.variant == 2) {
        e = GJ_LAUNCH_CLUSTER(gj_cluster_panel_kernel, pl.C, dim3(pl.C, S),
                              dim3(pl.R), cluster_bytes, st, work, P[0], perm,
                              N, ld, Np, B, k0, nb);
        if (e != cudaSuccess) return (int)e;
      } else {
        float* cval[2] = {Rbuf + panel_floats,
                          Rbuf + panel_floats + (size_t)S * nsb};
        int* cidx[2] = {g + (size_t)S * N, g + (size_t)S * N + (size_t)S * nsb};
        GJ_LAUNCH(gj_panel_load_kernel, rows, dim3(kThreads), 0, st, work,
                  P[0], cval[0], cidx[0], N, ld, Np, B, k0, nb);
        for (int kk = 0; kk < nb; ++kk) {
          const int a = kk & 1, b = a ^ 1;
          GJ_LAUNCH(gj_panel_step_kernel, rows, dim3(kThreads), 0, st, P[a],
                    P[b], cval[a], cidx[a], cval[b], cidx[b], perm, N, Np, B,
                    k0 + kk, kk, nb);
        }
      }
      GJ_LAUNCH(gj_swap_extract_kernel, dim3((ld + kThreads - 1) / kThreads, S),
                dim3(kThreads), 0, st, work, Rbuf, perm, N, ld, Np, B, k0, nb);
      const int stages = (nb + kStage - 1) / kStage;
      GJ_LAUNCH(gj_rank_update_kernel, dim3((ld + kTile - 1) / kTile, nrb, S),
                dim3(kThreads), stages * stage_bytes, st, work,
                P[pl.variant == 2 ? 0 : nb & 1], Rbuf, N, ld, Np, B, k0, nb);
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
