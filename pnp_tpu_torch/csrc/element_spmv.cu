// Constrained matrix-free SpMV from per-element dense blocks, in one launch.
//
// Replaces no TPU kernel: the reference leaves this product to XLA as a
// gather, a batched matvec and a scatter-add (pnp_tpu/fem/assembly.py:
// spmv, make_constrained_operator). On the card that chain was a where, the
// gather x[dofmap], cuBLAS's batched gemv over the 3 x 3 blocks, a copy, a
// zero fill, an index_add_ with atomics and another where: seven launches an
// apply; on an H100 the gemv alone was half of the device time of a
// 189,697-node step, and the chain 0.34 ms an apply.
// For each system s and dof i, with m = free (all true without a mask):
//
//   y[s,i] = m[s,i] ? sum_{(e,l): dof(e,l) = i} sum_j A[s,e,l,j] x~[s,dof(e,j)]
//                   : x[s,i],          x~[s,k] = m[s,k] ? x[s,k] : 0.
//
// Bound on the H100: bytes. Per apply the kernel reads each block once
// (8 n^2 E bytes in f64: 27.1 MB at E = 376,832, P1), the incidence table
// (4 (n E + ndof + 1) bytes), the int32 dof map (4 n E), x, the mask, and
// writes y: about 40 MB at that size, 12 us at 3.35 TB/s, for 2 n^2 E flop.
// What the design does:
//
// * gather by row, not scatter by element: one thread owns one (s, i) row,
//   walks the row's incidences (e, l) in the incidence table (CSR by dof,
//   each row's entries sorted by element), reads the block row A[s,e,l,:]
//   and x~ at the element's dofs, and writes y[s,i] once. No atomics, no
//   zero fill, no intermediate (E, n) vector in device memory; the sum order
//   is fixed, so two applies give the same bits;
// * an entry is the flat index e n + l, which is also where the block row
//   starts in units of n values: A + (e n + l) n;
// * a constrained row copies x and reads no block; a constrained column
//   reads as 0 (the mask, a byte a dof, stays in L1/L2);
// * n is a template parameter for P1-P3 (3, 6, 10), so the inner loops
//   unroll and e = entry / n is a multiply; any other n (the monolithic
//   Newton's composite blocks, 3 n) takes the same kernel with n at run
//   time;
// * systems: grid.y; x, the mask and y hold a row of ndof a system, the
//   blocks a system stride, 0 where one set serves every system (the
//   shared mass matrix).
//
// The incidence table is built once per dof map by the wrapper
// (operators/kernels.py) and kept with it.
//
// Measured on an H100 (tools/spmv_sweep.py, E = 376,832, P1, f64, one
// system): 24 us back to back, 29 us with L2 flushed before each apply,
// 41-50 % of the bound. Tried besides on the same card, and not kept:
// 16-byte loads of the block rows with the dof map padded to four ints,
// 2 to 8 lanes a row (over incidences, or over (incidence, column) pairs,
// shuffle-reduced), x masked beforehand, evict-first loads of the blocks,
// and an element pass then a row pass: each between 3 % faster and 25 %
// slower. The scattered block rows set the pace: the elements of one row
// lie apart in memory.
//
// SPMV_HOST_EMULATION: compiled as plain C++ against csrc/emulation/ (see
// gj_inverse.cu); launches go through SPMV_LAUNCH for that reason.

#include <cuda_runtime.h>
#include <cstddef>

#ifdef SPMV_HOST_EMULATION
#define SPMV_LAUNCH(kernel, grid, block, smem, stream, ...) \
  emulation::launch(grid, block, smem, [&] { kernel(__VA_ARGS__); })
#else
#define SPMV_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kSpmvThreads = 128;
constexpr int kMaxSystems = 65535;   // grid.y

struct SpmvArgs {
  const void* A;
  long long a_stride;                // values between systems' blocks
  const void* x;                     // (S, ndof)
  const unsigned char* free;         // (S, ndof); null: every dof free
  void* y;                           // (S, ndof)
  const int* dofmap;                 // (E, n)
  const int* offsets;                // (ndof + 1)
  const int* entries;                // (E n): e n + l, by dof, then by e
  int S, ndof, n;
  cudaStream_t stream;
};

template <typename T, int N>
__global__ void __launch_bounds__(kSpmvThreads)
element_spmv_kernel(const T* __restrict__ A, long long a_stride,
                    const T* __restrict__ x,
                    const unsigned char* __restrict__ free,
                    T* __restrict__ y,
                    const int* __restrict__ dofmap,
                    const int* __restrict__ offsets,
                    const int* __restrict__ entries, int ndof, int n_rt) {
  const int n = N > 0 ? N : n_rt;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ndof) return;
  const long long s = blockIdx.y;
  const T* xs = x + s * ndof;
  const unsigned char* fs = free ? free + s * ndof : nullptr;
  T* ys = y + s * ndof;
  if (fs && !fs[i]) {
    ys[i] = xs[i];
    return;
  }
  const T* As = A + s * a_stride;
  const int lo = offsets[i], hi = offsets[i + 1];
  T acc = T(0);
#pragma unroll 2
  for (int k = lo; k < hi; ++k) {
    const int el = entries[k];
    const int e = el / n;
    const T* row = As + (long long)el * n;
    const int* cols = dofmap + (long long)e * n;
    T t = T(0);
#pragma unroll
    for (int j = 0; j < (N > 0 ? N : n); ++j) {
      const int c = cols[j];
      const T xv = (!fs || fs[c]) ? xs[c] : T(0);
      t += row[j] * xv;
    }
    acc += t;
  }
  ys[i] = acc;
}

template <typename T, int N>
int launch_n(const SpmvArgs& a) {
  const dim3 grid((a.ndof + kSpmvThreads - 1) / kSpmvThreads, a.S);
  auto kernel = element_spmv_kernel<T, N>;
  SPMV_LAUNCH(kernel, grid, dim3(kSpmvThreads), 0,
              a.stream, static_cast<const T*>(a.A), a.a_stride,
              static_cast<const T*>(a.x), a.free, static_cast<T*>(a.y),
              a.dofmap, a.offsets, a.entries, a.ndof, a.n);
  return (int)cudaGetLastError();
}

template <typename T>
int spmv_launch(const SpmvArgs& a, int device) {
  if (a.n <= 0 || a.S <= 0 || a.S > kMaxSystems || a.ndof < 0)
    return (int)cudaErrorInvalidValue;
  if (a.ndof == 0) return (int)cudaSuccess;
  int before = device;
  cudaError_t e = cudaGetDevice(&before);
  if (e != cudaSuccess) return (int)e;
  if (before != device && (e = cudaSetDevice(device)) != cudaSuccess)
    return (int)e;
  int err;
  switch (a.n) {
    case 3: err = launch_n<T, 3>(a); break;
    case 6: err = launch_n<T, 6>(a); break;
    case 10: err = launch_n<T, 10>(a); break;
    default: err = launch_n<T, 0>(a);
  }
  if (before != device) cudaSetDevice(before);
  return err;
}

}  // namespace

// A: blocks (E, n, n) a system, a_stride values apart (0: shared); x:
// (S, ndof); free: (S, ndof), a byte a dof, or null (unconstrained); y:
// (S, ndof), written whole. dofmap (E, n), offsets (ndof + 1) and entries
// (E n) int32: the incidence table. Launches on `stream` of CUDA device
// `device`. Returns the first CUDA error, 0 on success.
extern "C" int element_spmv_f64(const double* A, long long a_stride,
                                const double* x, const unsigned char* free,
                                double* y, const int* dofmap,
                                const int* offsets, const int* entries, int S,
                                int ndof, int n, int device, void* stream) {
  const SpmvArgs a{A, a_stride, x, free, y, dofmap, offsets, entries, S,
                   ndof, n, static_cast<cudaStream_t>(stream)};
  return spmv_launch<double>(a, device);
}

extern "C" int element_spmv_f32(const float* A, long long a_stride,
                                const float* x, const unsigned char* free,
                                float* y, const int* dofmap,
                                const int* offsets, const int* entries, int S,
                                int ndof, int n, int device, void* stream) {
  const SpmvArgs a{A, a_stride, x, free, y, dofmap, offsets, entries, S,
                   ndof, n, static_cast<cudaStream_t>(stream)};
  return spmv_launch<float>(a, device);
}
