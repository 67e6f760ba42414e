// A stand-in for <cuda_runtime.h> that runs CUDA C++ kernels on the host, for
// testing a kernel's index arithmetic and synchronisation where there is no
// GPU and no nvcc:
//
//   g++ -std=c++20 -O1 -pthread -shared -fPIC -x c++ -DGJ_HOST_EMULATION \
//       -I pnp_tpu_torch/csrc/emulation pnp_tpu_torch/csrc/gj_inverse.cu
//
// (pb_element.cu: -DPB_HOST_EMULATION.)
//
// One std::thread per CUDA thread of a block; the blocks of a launch run one
// after another; __syncthreads and the warp shuffles are barriers; __shared__
// is a function-local static (blocks never overlap). It says nothing about
// speed, coalescing, alignment faults or what nvcc accepts. Only what the
// kernels of this package use is provided.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __fdiv_rn(a, b) ((a) / (b))

namespace emulation {

struct BlockState {
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<std::uint64_t> lanes;
  std::vector<float4> smem;
  explicit BlockState(int threads, std::size_t smem_bytes)
      : all(threads), lanes(threads), smem(smem_bytes / 16 + 1) {
    for (int w = 0; w < (threads + 31) / 32; ++w)
      warps.push_back(std::make_unique<std::barrier<>>(
          std::min(32, threads - 32 * w)));
  }
};

inline BlockState* state = nullptr;
inline dim3 block_dim, grid_dim;
inline thread_local dim3 thread_idx, block_idx;
inline thread_local int linear_tid = 0;

inline float4* dynamic_smem() { return state->smem.data(); }

template <class F>
void launch(dim3 grid, dim3 block, std::size_t smem_bytes, F&& body) {
  const int threads = block.x * block.y * block.z;
  BlockState st(threads, smem_bytes);
  state = &st;
  block_dim = block;
  grid_dim = grid;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&, t] {
      linear_tid = t;
      thread_idx = dim3(t % block.x, t / block.x % block.y,
                        t / (block.x * block.y));
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            block_idx = dim3(x, y, z);
            body();
            st.all.arrive_and_wait();
          }
    });
  }
  for (auto& th : pool) th.join();
  state = nullptr;
}

}  // namespace emulation

#define threadIdx emulation::thread_idx
#define blockIdx emulation::block_idx
#define blockDim emulation::block_dim
#define gridDim emulation::grid_dim

inline void __syncthreads() { emulation::state->all.arrive_and_wait(); }

// every lane of the warp must call it (full mask, converged)
template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8);
  auto& st = *emulation::state;
  const int t = emulation::linear_tid;
  std::memcpy(&st.lanes[t], &v, sizeof(T));
  st.warps[t / 32]->arrive_and_wait();
  T r;
  std::memcpy(&r, &st.lanes[t ^ lane_mask], sizeof(T));
  st.warps[t / 32]->arrive_and_wait();
  return r;
}

using std::max;
using std::min;
