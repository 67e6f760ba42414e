// Fused Poisson-Boltzmann element residual and Jacobian, one thread per
// element.
//
// Replaces: pnp_tpu/operators/pallas_kernels.py:pb_residual_jacobian_pallas
// (body _make_pb_kernel). For every element e, with f = w_q (times
// 2 pi y_q when cylindrical) and c = 8 pi l_b c0:
//   r_i  = sum_q f (grad u . grad phi_i + c sinh(u) phi_i)
//   A_ij = sum_q f (grad phi_i . grad phi_j + c cosh(u) phi_i phi_j)
// Natural (E, ...) layouts: ue (E, n), shape (q, n), gradphi (E, q, n, 2),
// qw/qy (E, q) -> r (E, n), A (E, n, n). No padding of E: the tail thread
// block is masked. Templated on the dtype (f64 on the port's path, f32 as
// the TPU kernel ran) and on n = 3, 6, 10 (P1-P3), so the per-element
// accumulators live in registers. sinh/cosh are the native functions.
//
// Bound on the H100: the gradphi read. Per element the kernel reads
// q n 2 gradient values plus n + 2q others and writes n + n^2 values, for
// O(q n^2) flops — about 0.5 flop per byte at P1 in f64, well under the
// card's f64 rate per byte of bandwidth. What the design does about it:
// each element's gradients are read from device memory exactly once and
// serve the residual and the Jacobian both (the fusion the Pallas kernel
// was written for), with every intermediate in registers; the small shared
// shape table comes through the read-only cache.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kThreads = 128;

template <typename T, int N>
__global__ void pb_element_kernel(const T* __restrict__ ue,
                                  const T* __restrict__ shape,
                                  const T* __restrict__ gradphi,
                                  const T* __restrict__ qw,
                                  const T* __restrict__ qy,
                                  T* __restrict__ r, T* __restrict__ A,
                                  int E, int Q, T coef, int cyl, T two_pi) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  T u_e[N];
#pragma unroll
  for (int i = 0; i < N; ++i) u_e[i] = ue[(size_t)e * N + i];
  T r_acc[N];
  T A_acc[N * N];
#pragma unroll
  for (int i = 0; i < N; ++i) r_acc[i] = T(0);
#pragma unroll
  for (int i = 0; i < N * N; ++i) A_acc[i] = T(0);

  for (int q = 0; q < Q; ++q) {
    T f = qw[(size_t)e * Q + q];
    if (cyl) f = f * qy[(size_t)e * Q + q] * two_pi;
    const T* gp = gradphi + ((size_t)e * Q + q) * N * 2;
    const T* sh = shape + (size_t)q * N;
    T gx[N], gy[N], s[N];
    T u = T(0), gux = T(0), guy = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      gx[i] = gp[2 * i];
      gy[i] = gp[2 * i + 1];
      s[i] = __ldg(sh + i);
      u += u_e[i] * s[i];
      gux += u_e[i] * gx[i];
      guy += u_e[i] * gy[i];
    }
    const T fsh = coef * sinh(u) * f;
    const T fch = f * coef * cosh(u);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      r_acc[i] += (gux * gx[i] + guy * gy[i]) * f + fsh * s[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        A_acc[i * N + j] +=
            f * (gx[i] * gx[j] + gy[i] * gy[j]) + fch * s[i] * s[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) r[(size_t)e * N + i] = r_acc[i];
#pragma unroll
  for (int i = 0; i < N * N; ++i) A[(size_t)e * N * N + i] = A_acc[i];
}

template <typename T>
int launch(const T* ue, const T* shape, const T* gradphi, const T* qw,
           const T* qy, T* r, T* A, int E, int Q, int n, double coef, int cyl,
           double two_pi, void* stream) {
  if (E <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (E + kThreads - 1) / kThreads;
  const T c = static_cast<T>(coef);
  const T tp = static_cast<T>(two_pi);
  switch (n) {
    case 3:
      pb_element_kernel<T, 3><<<blocks, kThreads, 0, st>>>(
          ue, shape, gradphi, qw, qy, r, A, E, Q, c, cyl, tp);
      break;
    case 6:
      pb_element_kernel<T, 6><<<blocks, kThreads, 0, st>>>(
          ue, shape, gradphi, qw, qy, r, A, E, Q, c, cyl, tp);
      break;
    case 10:
      pb_element_kernel<T, 10><<<blocks, kThreads, 0, st>>>(
          ue, shape, gradphi, qw, qy, r, A, E, Q, c, cyl, tp);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the first CUDA error, 0 on success.
extern "C" int pb_element_f64(const double* ue, const double* shape,
                              const double* gradphi, const double* qw,
                              const double* qy, double* r, double* A, int E,
                              int Q, int n, double coef, int cyl,
                              double two_pi, void* stream) {
  return launch<double>(ue, shape, gradphi, qw, qy, r, A, E, Q, n, coef, cyl,
                        two_pi, stream);
}

extern "C" int pb_element_f32(const float* ue, const float* shape,
                              const float* gradphi, const float* qw,
                              const float* qy, float* r, float* A, int E,
                              int Q, int n, double coef, int cyl,
                              double two_pi, void* stream) {
  return launch<float>(ue, shape, gradphi, qw, qy, r, A, E, Q, n, coef, cyl,
                       two_pi, stream);
}
