// The conjugate-gradient iteration's vector updates and convergence test,
// each in one launch.
//
// Replaces no TPU kernel: the reference leaves these to XLA inside its
// lax.while_loop, which fuses them. In the port each CG iteration
// (solvers/krylov.py, cg) ran them as torch operations, one launch each:
//
//   alpha = rz / nz(pAp)                 eq, fill, where, div
//   x += alpha p;  r -= alpha Ap         mul, add, mul, add
//   beta = rz_new / nz(rz)               eq, fill, where, div
//   p = p beta + z                       mul, add
//   flag = any(sqrt(|r|^2) > tol)        sqrt, gt, any
//
// seventeen launches of 1-3 us each on an H100 at 189,697 dofs, of the
// ~50 (~200 us) that one iteration of CG under the two-level AMG takes;
// inside the iteration's CUDA graph each still costs its own dispatch.
// Here they are three: cg_update (alpha and both vector updates),
// cg_direction (beta and the new direction) and krylov_unconverged (the
// flag from the squared norms, which stay torch's sums). nz(v) is v, or 1
// where v is 0.
//
// Bound: bytes. cg_update reads x, r, p, Ap and writes x, r (48 bytes a
// dof in f64), cg_direction reads p, z and writes p (24): 9.1 and 4.6 MB,
// 2.7 and 1.4 us at 3.35 TB/s at 189,697 dofs. Measured there on an H100
// (profiler, back to back, so the vectors stay in the 50 MB L2): 2.6, 1.9
// and 1.3 us (krylov_unconverged) for one system, 4.1, 2.7 and 1.3 us for
// two, against 12.6, 8.8 and 3.7 us (14.8, 9.9, 4.6) for the eight, six
// and three torch kernels they replace.
//
// Bits: every value is rounded as the torch operations round it, in the
// same order (the product, then the sum; no fused multiply-add, so the
// products are rounded by __dmul_rn and the sums by __dadd_rn /
// __dsub_rn), so the solver's iterates, counts and residuals are the
// torch operations' own. f64 only: the port's Krylov vectors are f64.
//
// CG_HOST_EMULATION: compiled as plain C++ against csrc/emulation/ (see
// gj_inverse.cu); launches go through CG_LAUNCH for that reason.

#include <cuda_runtime.h>

#ifdef CG_HOST_EMULATION
#define CG_LAUNCH(kernel, grid, block, stream, ...) \
  emulation::launch(grid, block, 0, [&] { kernel(__VA_ARGS__); })
inline double mul_rn(double a, double b) { return a * b; }
inline double add_rn(double a, double b) { return a + b; }
inline double sub_rn(double a, double b) { return a - b; }
#else
#define CG_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
#endif

#include <cmath>

namespace {

constexpr int kCgThreads = 256;
constexpr int kMaxRows = 65535;     // grid.y

__device__ __forceinline__ double nz(double v) {
  return v == 0.0 ? 1.0 : v;
}

// rows systems of n values each, row-major; one scalar a row
__global__ void __launch_bounds__(kCgThreads)
cg_update_kernel(double* __restrict__ x, double* __restrict__ r,
                 const double* __restrict__ p, const double* __restrict__ Ap,
                 const double* __restrict__ pAp,
                 const double* __restrict__ rz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = blockIdx.y;
  const double alpha = rz[s] / nz(pAp[s]);
  const long long k = s * n + i;
  x[k] = add_rn(x[k], mul_rn(alpha, p[k]));
  r[k] = sub_rn(r[k], mul_rn(alpha, Ap[k]));
}

__global__ void __launch_bounds__(kCgThreads)
cg_direction_kernel(double* __restrict__ p, const double* __restrict__ z,
                    const double* __restrict__ rz_new,
                    const double* __restrict__ rz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = blockIdx.y;
  const double beta = rz_new[s] / nz(rz[s]);
  const long long k = s * n + i;
  p[k] = add_rn(mul_rn(p[k], beta), z[k]);
}

// flag = some row's norm, sqrt(ss), is above its tolerance
__global__ void krylov_unconverged_kernel(const double* __restrict__ ss,
                                          const double* __restrict__ tol,
                                          bool* __restrict__ flag, int rows) {
  bool more = false;
  for (int s = 0; s < rows; ++s) more = more || (sqrt(ss[s]) > tol[s]);
  *flag = more;
}

// Runs `launch` on CUDA device `device`, restoring the current one after.
template <typename F>
int on_device(int device, F launch) {
  int before = device;
  cudaError_t e = cudaGetDevice(&before);
  if (e != cudaSuccess) return (int)e;
  if (before != device && (e = cudaSetDevice(device)) != cudaSuccess)
    return (int)e;
  launch();
  e = cudaGetLastError();
  if (before != device) cudaSetDevice(before);
  return (int)e;
}

dim3 grid_of(int rows, long long n) {
  return dim3((unsigned)((n + kCgThreads - 1) / kCgThreads), rows);
}

}  // namespace

// x, r, p, Ap: (rows, n) contiguous; pAp, rz: one value a row. x += alpha
// p and r -= alpha Ap in place, alpha = rz / nz(pAp) a row. Launches on
// `stream` of CUDA device `device`; returns the first CUDA error, 0 on
// success.
extern "C" int cg_update_f64(double* x, double* r, const double* p,
                             const double* Ap, const double* pAp,
                             const double* rz, int rows, long long n,
                             int device, void* stream) {
  if (rows <= 0 || rows > kMaxRows || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    CG_LAUNCH(cg_update_kernel, grid_of(rows, n), dim3(kCgThreads),
              static_cast<cudaStream_t>(stream), x, r, p, Ap, pAp, rz, n);
  });
}

// p = p beta + z in place, beta = rz_new / nz(rz) a row.
extern "C" int cg_direction_f64(double* p, const double* z,
                                const double* rz_new, const double* rz,
                                int rows, long long n, int device,
                                void* stream) {
  if (rows <= 0 || rows > kMaxRows || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    CG_LAUNCH(cg_direction_kernel, grid_of(rows, n), dim3(kCgThreads),
              static_cast<cudaStream_t>(stream), p, z, rz_new, rz, n);
  });
}

// ss: the rows' squared norms; tol: their tolerances; *flag (one bool on
// the device) = some row's norm above its tolerance.
extern "C" int krylov_unconverged_f64(const double* ss, const double* tol,
                                      bool* flag, int rows, int device,
                                      void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    CG_LAUNCH(krylov_unconverged_kernel, dim3(1), dim3(1),
              static_cast<cudaStream_t>(stream), ss, tol, flag, rows);
  });
}
