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
// is a function-local static (blocks never overlap). A cluster launch
// (launch_cluster) runs the blocks of one cluster at once, each with its own
// dynamic shared memory, and the clusters one after another: cluster_sync is
// a barrier over all their threads and cluster_map returns a peer block's
// copy of a dynamic shared-memory address (a kernel launched so uses no
// static __shared__, which is one object here); an mbarrier is 8 bytes of
// shared memory updated atomically, and an asynchronous store to a peer
// block (push16) a plain store followed by its mbarrier's byte count. It
// says nothing about
// speed, coalescing, alignment faults or what nvcc accepts. Only what the
// kernels of this package use is provided.
#pragma once

#include <algorithm>
#include <atomic>
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
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 11
};
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

inline unsigned __float_as_uint(float x) {
  unsigned r;
  std::memcpy(&r, &x, sizeof r);
  return r;
}
inline float __uint_as_float(unsigned x) {
  float r;
  std::memcpy(&r, &x, sizeof r);
  return r;
}
inline int __float_as_int(float x) {
  int r;
  std::memcpy(&r, &x, sizeof r);
  return r;
}
inline float __int_as_float(int x) {
  float r;
  std::memcpy(&r, &x, sizeof r);
  return r;
}

namespace emulation {

struct BlockState {
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<unsigned long long> lanes;
  std::vector<float4> smem;
  explicit BlockState(int threads, std::size_t smem_bytes)
      : all(threads), lanes(threads), smem(smem_bytes / 16 + 1) {
    for (int w = 0; w < (threads + 31) / 32; ++w)
      warps.push_back(std::make_unique<std::barrier<>>(
          std::min(32, threads - 32 * w)));
  }
};

struct ClusterState {
  std::barrier<> all;
  std::vector<std::unique_ptr<BlockState>> blocks;
  ClusterState(int blocks_, int threads, std::size_t smem_bytes)
      : all(blocks_ * threads) {
    for (int b = 0; b < blocks_; ++b)
      blocks.push_back(std::make_unique<BlockState>(threads, smem_bytes));
  }
};

inline thread_local BlockState* state = nullptr;
inline thread_local ClusterState* cluster = nullptr;
inline dim3 block_dim, grid_dim;
inline thread_local dim3 thread_idx, block_idx;
inline thread_local int linear_tid = 0;

inline float4* dynamic_smem() { return state->smem.data(); }

inline void cluster_sync() { cluster->all.arrive_and_wait(); }

// the address in block `rank` of the cluster that `p` has in this block's
// dynamic shared memory
template <class T>
T* cluster_map(T* p, int rank) {
  const char* base = reinterpret_cast<const char*>(state->smem.data());
  char* peer = reinterpret_cast<char*>(cluster->blocks[rank]->smem.data());
  return reinterpret_cast<T*>(peer + (reinterpret_cast<const char*>(p) - base));
}

template <class F>
void launch(dim3 grid, dim3 block, std::size_t smem_bytes, F&& body) {
  const int threads = block.x * block.y * block.z;
  BlockState st(threads, smem_bytes);
  block_dim = block;
  grid_dim = grid;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&, t] {
      state = &st;
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
}

// An mbarrier: the phase (bit 63), the arrivals a phase expects (bits
// 48-62) and those still pending (bits 32-47), the transaction bytes still
// pending (bits 0-31, signed: bytes may land before they are expected).
// A phase completes when no arrival and no byte is pending.
inline void mbar_init(unsigned long long* m, int count) {
  const unsigned long long c = count;
  std::atomic_ref<unsigned long long>(*m).store((c << 48) | (c << 32));
}
inline void mbar_update(unsigned long long* m, int arrivals, int bytes) {
  std::atomic_ref<unsigned long long> a(*m);
  unsigned long long old = a.load(), next;
  do {
    const unsigned long long phase = old >> 63;
    const unsigned long long expected = (old >> 48) & 0x7fff;
    const unsigned long long pending = ((old >> 32) & 0xffff) - arrivals;
    const int tx = (int)(unsigned)old + bytes;
    next = pending == 0 && tx == 0
               ? ((phase ^ 1) << 63) | (expected << 48) | (expected << 32)
               : (phase << 63) | (expected << 48) | (pending << 32) |
                     (unsigned)tx;
  } while (!a.compare_exchange_weak(old, next));
  if ((next ^ old) >> 63) a.notify_all();   // the phase completed
}
// until the phase of parity `parity` has completed (waiters sleep)
inline void mbar_wait(unsigned long long* m, unsigned parity) {
  std::atomic_ref<unsigned long long> a(*m);
  for (unsigned long long v = a.load(); (v >> 63) == parity; v = a.load())
    a.wait(v);
}

// A launch in clusters of `size` blocks along x (grid.x a multiple of it)
template <class F>
void launch_cluster(int size, dim3 grid, dim3 block, std::size_t smem_bytes,
                    F&& body) {
  const int threads = block.x * block.y * block.z;
  ClusterState cs(size, threads, smem_bytes);
  block_dim = block;
  grid_dim = grid;
  std::vector<std::thread> pool;
  for (int b = 0; b < size; ++b)
    for (int t = 0; t < threads; ++t) {
      pool.emplace_back([&, b, t] {
        state = cs.blocks[b].get();
        cluster = &cs;
        linear_tid = t;
        thread_idx = dim3(t % block.x, t / block.x % block.y,
                          t / (block.x * block.y));
        for (unsigned z = 0; z < grid.z; ++z)
          for (unsigned y = 0; y < grid.y; ++y)
            for (unsigned x = b; x < grid.x; x += size) {
              block_idx = dim3(x, y, z);
              body();
              cs.all.arrive_and_wait();
            }
      });
    }
  for (auto& th : pool) th.join();
}

}  // namespace emulation

#define threadIdx emulation::thread_idx
#define blockIdx emulation::block_idx
#define blockDim emulation::block_dim
#define gridDim emulation::grid_dim

inline void __syncthreads() { emulation::state->all.arrive_and_wait(); }
inline void __syncwarp() {
  emulation::state->warps[emulation::linear_tid / 32]->arrive_and_wait();
}

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

// warp-wide reductions (redux.sync); every lane of the warp calls them
template <class F>
unsigned warp_reduce(unsigned v, F op) {
  auto& st = *emulation::state;
  const int t = emulation::linear_tid, w0 = t & ~31;
  st.lanes[t] = v;
  st.warps[t / 32]->arrive_and_wait();
  unsigned r = (unsigned)st.lanes[w0];
  for (int l = 1; l < 32; ++l) r = op(r, (unsigned)st.lanes[w0 + l]);
  st.warps[t / 32]->arrive_and_wait();
  return r;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return warp_reduce(v, [](unsigned a, unsigned b) { return a > b ? a : b; });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return warp_reduce(v, [](unsigned a, unsigned b) { return a < b ? a : b; });
}

using std::max;
using std::min;
