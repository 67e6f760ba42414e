// Fused Poisson-Boltzmann element residual and Jacobian.
//
// Replaces: pnp_tpu/operators/pallas_kernels.py:pb_residual_jacobian_pallas
// (body _make_pb_kernel). For every element e, with f = w_q (times
// 2 pi y_q when cylindrical) and c = 8 pi l_b c0:
//   r_i  = sum_q f (grad u . grad phi_i + c sinh(u) phi_i)
//   A_ij = sum_q f (grad phi_i . grad phi_j + c cosh(u) phi_i phi_j)
// Natural (E, ...) layouts: ue (E, n), shape (q, n), gradphi (E, q, n, 2),
// qw/qy (E, q) -> r (E, n), A (E, n, n). Any E: the tail block is masked.
// Templated on the dtype (f64 on the port's path, f32 as the TPU kernel
// ran), on n = 3, 6, 10 (P1-P3) and on what is wanted: the residual, the
// Jacobian or both. A caller that wants one output pays for no store, no
// accumulator and no buffer of the other.
//
// Bound on the H100: bytes. Per element the kernel reads q n 2 gradient
// values plus n + 2q others and writes n + n^2 values for O(q n^2) flop,
// about 0.5 flop a byte at P1 in f64. At the path's sizes (9,200 and
// 23,552 elements: 3.4 and 8.8 MB) the bytes take 1-3 us, so what the
// kernel can reach is set by latency: the launch (an empty kernel of the
// same grid takes 0.8-0.9 us on the device), one round trip to device
// memory, and the serial chain of each thread. What the design does:
//
// * threads an element (TPE, 1 or 4): with 4, a thread takes every fourth
//   quadrature point, so the chain is a quarter as long (one expm1 instead
//   of four at P1) and four times as many threads hide the loads; the
//   partial sums meet in a shuffle butterfly over the element's lanes;
// * one expm1 serves sinh and cosh: with m = expm1(|u|) and e = m + 1,
//   sinh|u| = m (m + 2) / (2 e) and cosh u = 1 + m^2 / (2 e), with no
//   cancellation near 0 ((e - 1/e) / 2 loses every digit there);
// * A is symmetric: n (n + 1) / 2 accumulators (55 of 100 at P3, which
//   keeps the P3 instances in registers), mirrored at the store;
// * staging (STAGED): a block's elements are one contiguous chunk of each
//   table, so the chunk is read with 16-byte loads, neighbouring threads on
//   neighbouring addresses, into shared memory rows of an odd pitch (odd:
//   no bank conflict for f64 or f32; which is why the copy goes through
//   registers, a 16-byte cp.async cannot land on an odd pitch), and r and A
//   go back through shared memory as 16-byte stores. Without it each thread
//   reads its own rows, 48 to 192 bytes apart, and L1 does the coalescing.
//
// tools/pb_sweep.py times the designs on the card; the wrapper
// (operators/kernels.py) launches the one that won. Every design is
// compiled only with -DPB_ALL_DESIGNS (the sweep and the host emulation
// test do); the package's build holds the settled one, kTpe x kStaged.
//
// PB_HOST_EMULATION: compiled as plain C++ against csrc/emulation/ (see
// gj_inverse.cu); launches go through PB_LAUNCH for that reason.

#include <cuda_runtime.h>
#include <cstddef>

#ifdef PB_HOST_EMULATION
#define PB_LAUNCH(kernel, grid, block, smem, stream, ...) \
  emulation::launch(grid, block, smem, [&] { kernel(__VA_ARGS__); })
#define PB_DYN_SMEM(name) float4* name = emulation::dynamic_smem()
#define PB_LDG(p) (*(p))
#else
#define PB_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#define PB_DYN_SMEM(name) extern __shared__ float4 name[]
#define PB_LDG(p) __ldg(p)
#endif

namespace {

constexpr int kOutResidual = 1, kOutJacobian = 2;
// the settled design (tools/pb_sweep.py on an H100)
constexpr int kTpe = 4;
constexpr bool kStaged = false;
constexpr int kMaxThreads = 256;
constexpr size_t kSmemDefault = 48 * 1024, kSmemMax = 227 * 1024;

template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

__device__ __forceinline__ float expm1_abs(float u) { return expm1f(fabsf(u)); }
__device__ __forceinline__ double expm1_abs(double u) { return expm1(fabs(u)); }
__device__ __forceinline__ float with_sign(float a, float u) {
  return copysignf(a, u);
}
__device__ __forceinline__ double with_sign(double a, double u) {
  return copysign(a, u);
}

// sinh(u) and cosh(u) from one expm1 (see the header note)
template <typename T>
__device__ __forceinline__ void sinh_cosh(T u, T& sh, T& ch) {
  const T m = expm1_abs(u);
  const T h = T(0.5) / (m + T(1));
  sh = with_sign(m * ((m + T(2)) * h), u);
  ch = T(1) + m * (m * h);
}

__host__ __device__ constexpr int odd_pitch(int n) { return n | 1; }
__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Copies `count` rows of `per_row` values, contiguous at `src` (16-byte
// aligned), into shared rows `pitch` apart: 16-byte loads, neighbouring
// threads on neighbouring addresses; a ragged end goes value by value.
template <typename T>
__device__ __forceinline__ void stage_in(T* dst, const T* src, int count,
                                         int per_row, int pitch) {
  constexpr int V = 16 / sizeof(T);
  const int total = count * per_row;
  const int step = blockDim.x * V;
  const int step_row = step / per_row, step_col = step % per_row;
  int i = threadIdx.x * V;
  int row = i / per_row, col = i % per_row;
  for (; i < total; i += step) {
    Vec16<T> x;
    if (i + V <= total) {
      x = *reinterpret_cast<const Vec16<T>*>(src + i);
    } else {
      for (int k = 0; k < V; ++k) x.v[k] = i + k < total ? src[i + k] : T(0);
    }
    int rr = row, c = col;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (i + k < total) dst[rr * pitch + c] = x.v[k];
      if (++c == per_row) {
        c = 0;
        ++rr;
      }
    }
    row += step_row;
    col += step_col;
    if (col >= per_row) {
      col -= per_row;
      ++row;
    }
  }
}

// Copies `total` contiguous values from shared memory (16-byte aligned) to
// `dst` (16-byte aligned) with 16-byte stores; a ragged end value by value.
template <typename T>
__device__ __forceinline__ void stage_out(T* dst, const T* src, int total) {
  constexpr int V = 16 / sizeof(T);
  for (int i = threadIdx.x * V; i < total; i += blockDim.x * V) {
    if (i + V <= total) {
      *reinterpret_cast<Vec16<T>*>(dst + i) =
          *reinterpret_cast<const Vec16<T>*>(src + i);
    } else {
      for (int k = i; k < total; ++k) dst[k] = src[k];
    }
  }
}

// Values of shared memory a block of `eb` elements stages: the inputs'
// rows, then (after a barrier, over the same bytes) r and A.
__host__ __device__ inline int staged_values(int eb, int n, int Q, int out,
                                             int vec) {
  const int in = eb * (odd_pitch(2 * n * Q) + 2 * odd_pitch(Q) + odd_pitch(n));
  const int r_vals = (out & kOutResidual) ? round_up(eb * n, vec) : 0;
  const int a_vals = (out & kOutJacobian) ? eb * n * n : 0;
  return in > r_vals + a_vals ? in : r_vals + a_vals;
}

// blockDim.x = TPE threads for each of blockDim.x / TPE elements; thread t
// of an element takes quadrature points t, t + TPE, ...
template <typename T, int N, int OUT, int TPE, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads)
    pb_element_kernel(const T* __restrict__ ue, const T* __restrict__ shape,
                      const T* __restrict__ gradphi, const T* __restrict__ qw,
                      const T* __restrict__ qy, T* __restrict__ r,
                      T* __restrict__ A, int E, int Q, T coef, int cyl,
                      T two_pi) {
  constexpr int NT = N * (N + 1) / 2;
  constexpr int G = 2 * N;              // gradient values a quadrature point
  constexpr int V = 16 / sizeof(T);
  const int eb = blockDim.x / TPE;
  const int e0 = blockIdx.x * eb;
  const int cnt = min(eb, E - e0);      // elements of this block
  const int le = threadIdx.x / TPE, t = threadIdx.x % TPE;
  // a tail thread recomputes the block's last element (every lane takes
  // part in the shuffles) and stores nothing
  const int el = min(le, cnt - 1);
  const bool live = le < cnt;

  PB_DYN_SMEM(raw);
  T* sm = reinterpret_cast<T*>(raw);
  const T *u_p, *g_p, *w_p, *y_p;
  if (STAGED) {
    const int pg = odd_pitch(G * Q), pq = odd_pitch(Q), pu = odd_pitch(N);
    T* sg = sm;
    T* sw = sg + eb * pg;
    T* sy = sw + eb * pq;
    T* su = sy + eb * pq;
    stage_in(sg, gradphi + (size_t)e0 * Q * G, cnt, G * Q, pg);
    stage_in(sw, qw + (size_t)e0 * Q, cnt, Q, pq);
    if (cyl) stage_in(sy, qy + (size_t)e0 * Q, cnt, Q, pq);
    stage_in(su, ue + (size_t)e0 * N, cnt, N, pu);
    __syncthreads();
    g_p = sg + el * pg;
    w_p = sw + el * pq;
    y_p = sy + el * pq;
    u_p = su + el * pu;
  } else {
    const size_t e = (size_t)(e0 + el);
    g_p = gradphi + e * Q * G;
    w_p = qw + e * Q;
    y_p = qy + e * Q;
    u_p = ue + e * N;
  }

  T u_e[N];
#pragma unroll
  for (int i = 0; i < N; ++i) u_e[i] = u_p[i];
  T r_acc[N];
  T A_acc[NT];
#pragma unroll
  for (int i = 0; i < N; ++i) r_acc[i] = T(0);
#pragma unroll
  for (int i = 0; i < NT; ++i) A_acc[i] = T(0);

  for (int q = t; q < Q; q += TPE) {
    T f = w_p[q];
    if (cyl) f = f * y_p[q] * two_pi;
    const T* gp = g_p + q * G;
    const T* sh = shape + (size_t)q * N;
    T gx[N], gy[N], s[N];
    T u = T(0), gux = T(0), guy = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      gx[i] = gp[2 * i];
      gy[i] = gp[2 * i + 1];
      s[i] = PB_LDG(sh + i);
      u += u_e[i] * s[i];
      gux += u_e[i] * gx[i];
      guy += u_e[i] * gy[i];
    }
    T sinh_u, cosh_u;
    sinh_cosh(u, sinh_u, cosh_u);
    if (OUT & kOutResidual) {
      const T fsh = coef * sinh_u * f;
#pragma unroll
      for (int i = 0; i < N; ++i)
        r_acc[i] += (gux * gx[i] + guy * gy[i]) * f + fsh * s[i];
    }
    if (OUT & kOutJacobian) {
      const T fch = f * coef * cosh_u;
      int k = 0;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const T fsi = fch * s[i];
#pragma unroll
        for (int j = i; j < N; ++j, ++k)
          A_acc[k] += f * (gx[i] * gx[j] + gy[i] * gy[j]) + fsi * s[j];
      }
    }
  }

  // the element's TPE partial sums meet; every lane ends with the total
#pragma unroll
  for (int off = TPE / 2; off > 0; off /= 2) {
    if (OUT & kOutResidual) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        r_acc[i] += __shfl_xor_sync(0xffffffffu, r_acc[i], off);
    }
    if (OUT & kOutJacobian) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
        A_acc[i] += __shfl_xor_sync(0xffffffffu, A_acc[i], off);
    }
  }

  // stores, dealt over the element's lanes: to r and A directly, or to
  // shared memory (over the staged inputs, once every thread has read its
  // own) and from there in 16-byte rows
  T* r_to = r + (size_t)e0 * N;
  T* A_to = A + (size_t)e0 * N * N;
  T* sr = sm;
  T* sa = sm + ((OUT & kOutResidual) ? round_up(eb * N, V) : 0);
  if (STAGED) {
    __syncthreads();
    r_to = sr;
    A_to = sa;
  }
  if (live) {
    if (OUT & kOutResidual) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i % TPE == t) r_to[le * N + i] = r_acc[i];
    }
    if (OUT & kOutJacobian) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          // (a, b) = (min, max) of (i, j): entry a N - a (a - 1) / 2 + b - a
          // of the upper triangle stored by rows
          const int a = i < j ? i : j, b = i < j ? j : i;
          if ((i * N + j) % TPE == t)
            A_to[le * N * N + i * N + j] =
                A_acc[a * N - a * (a - 1) / 2 + b - a];
        }
      }
    }
  }
  if (STAGED) {
    __syncthreads();
    if (OUT & kOutResidual) stage_out(r + (size_t)e0 * N, sr, cnt * N);
    if (OUT & kOutJacobian)
      stage_out(A + (size_t)e0 * N * N, sa, cnt * N * N);
  }
}

__global__ void pb_empty_kernel() {}

struct Args {
  const void *ue, *shape, *gradphi, *qw, *qy;
  void *r, *A;
  int E, Q;
  double coef;
  int cyl;
  double two_pi;
  int threads;
  cudaStream_t stream;
};

template <typename T, int N, int OUT, int TPE, bool STAGED>
int launch_kernel(const Args& a) {
  const int eb = a.threads / TPE;
  const int blocks = (a.E + eb - 1) / eb;
  size_t smem = 0;
  auto kernel = pb_element_kernel<T, N, OUT, TPE, STAGED>;
  if (STAGED) {
    // a block's chunk of each table starts on a 16-byte boundary
    if (eb % (16 / (int)sizeof(T)) != 0) return (int)cudaErrorInvalidValue;
    smem = sizeof(T) * (size_t)staged_values(eb, N, a.Q, OUT, 16 / sizeof(T));
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    if (smem > kSmemDefault) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  PB_LAUNCH(kernel, dim3(blocks), dim3(a.threads), smem, a.stream,
            static_cast<const T*>(a.ue), static_cast<const T*>(a.shape),
            static_cast<const T*>(a.gradphi), static_cast<const T*>(a.qw),
            static_cast<const T*>(a.qy), static_cast<T*>(a.r),
            static_cast<T*>(a.A), a.E, a.Q, static_cast<T>(a.coef), a.cyl,
            static_cast<T>(a.two_pi));
  return (int)cudaGetLastError();
}

template <typename T, int N, int TPE, bool STAGED>
int launch_outputs(const Args& a, int outputs) {
  switch (outputs) {
    case kOutResidual:
      return launch_kernel<T, N, kOutResidual, TPE, STAGED>(a);
    case kOutJacobian:
      return launch_kernel<T, N, kOutJacobian, TPE, STAGED>(a);
    case kOutResidual | kOutJacobian:
      return launch_kernel<T, N, kOutResidual | kOutJacobian, TPE, STAGED>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int N>
int launch_design(const Args& a, int outputs, int tpe, int staged) {
  if (tpe == kTpe && (staged != 0) == kStaged)
    return launch_outputs<T, N, kTpe, kStaged>(a, outputs);
#ifdef PB_ALL_DESIGNS
  if (tpe == 1 && !staged) return launch_outputs<T, N, 1, false>(a, outputs);
  if (tpe == 1 && staged) return launch_outputs<T, N, 1, true>(a, outputs);
  if (tpe == 4 && !staged) return launch_outputs<T, N, 4, false>(a, outputs);
  if (tpe == 4 && staged) return launch_outputs<T, N, 4, true>(a, outputs);
#endif
  return (int)cudaErrorInvalidValue;
}

// Runs `body` with `device` current, and puts the caller's device back.
template <typename F>
int on_device(int device, F&& body) {
  int before = device;
  cudaError_t e = cudaGetDevice(&before);
  if (e != cudaSuccess) return (int)e;
  if (before != device && (e = cudaSetDevice(device)) != cudaSuccess)
    return (int)e;
  const int err = body();
  if (before != device) cudaSetDevice(before);
  return err;
}

template <typename T>
int launch(const Args& a, int n, int outputs, int tpe, int staged,
           int device) {
  if (a.E <= 0) return (int)cudaSuccess;
  if (a.threads < 32 || a.threads > kMaxThreads || a.threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    switch (n) {
      case 3: return launch_design<T, 3>(a, outputs, tpe, staged);
      case 6: return launch_design<T, 6>(a, outputs, tpe, staged);
      case 10: return launch_design<T, 10>(a, outputs, tpe, staged);
    }
    return (int)cudaErrorInvalidValue;
  });
}

}  // namespace

// outputs: 1 the residual (A is not touched), 2 the Jacobian (r is not
// touched), 3 both. tpe (threads an element, 1 or 4), staged (0 or 1) and
// threads (a block's, a multiple of 32 up to 256) name the design; the
// build holds tpe = 4, staged = 0 unless it was compiled with
// -DPB_ALL_DESIGNS. The launch goes to `stream` of CUDA device `device`.
// Returns the first CUDA error, 0 on success.
extern "C" int pb_element_f64(const double* ue, const double* shape,
                              const double* gradphi, const double* qw,
                              const double* qy, double* r, double* A, int E,
                              int Q, int n, double coef, int cyl,
                              double two_pi, int outputs, int tpe, int staged,
                              int threads, int device, void* stream) {
  const Args a{ue, shape, gradphi, qw, qy, r, A, E, Q, coef, cyl, two_pi,
               threads, static_cast<cudaStream_t>(stream)};
  return launch<double>(a, n, outputs, tpe, staged, device);
}

extern "C" int pb_element_f32(const float* ue, const float* shape,
                              const float* gradphi, const float* qw,
                              const float* qy, float* r, float* A, int E,
                              int Q, int n, double coef, int cyl,
                              double two_pi, int outputs, int tpe, int staged,
                              int threads, int device, void* stream) {
  const Args a{ue, shape, gradphi, qw, qy, r, A, E, Q, coef, cyl, two_pi,
               threads, static_cast<cudaStream_t>(stream)};
  return launch<float>(a, n, outputs, tpe, staged, device);
}

// An empty kernel on the same grid, launched the same way: the floor under
// any design's time (tools/pb_sweep.py, chip_smoke.py).
extern "C" int pb_empty_launch(int blocks, int threads, int device,
                               void* stream) {
  return on_device(device, [&] {
    PB_LAUNCH(pb_empty_kernel, dim3(blocks), dim3(threads), 0,
              static_cast<cudaStream_t>(stream));
    return (int)cudaGetLastError();
  });
}
