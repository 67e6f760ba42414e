// A captured Krylov iteration run as a device-side while loop.
//
// Replaces no TPU kernel: the reference runs each Krylov solve as one
// lax.while_loop, whose test stays on the TPU. The port's solvers
// (solvers/krylov.py) capture one iteration as a CUDA graph. Replayed once
// an iteration, each replay waited for the host to read the iteration's
// "not converged" flag and to launch the next: on an H100, 16.6 us an
// iteration for a three-kernel iteration against 7.4 us in this loop, and
// in CG under the two-level AMG at 189,697 nodes ~20 us of each ~220 us
// iteration.
//
// Here the captured graph becomes the body of a conditional WHILE node
// (CUDA 12.4 and later) in a wrapper graph, instantiated once a capture
// (0.5-1.3 ms on the host there):
//
//   while (c) {                     c: the node's handle, 1 at each launch
//     <the captured iteration>      a child graph node (a clone)
//     krylov_loop_test              one thread, after the iteration:
//   }                                 left = ctl[0] - 1; ctl[0] = left;
//                                     ctl[1] = *flag;
//                                     c = *flag && left > 0
//
// The host writes the segment's limit n into ctl[0] before each launch and
// reads ctl (the iterations left and the last flag) once after it, so a
// launch runs the iteration until its flag reads false or n times: the
// same kernels on the same buffers in the same order as n replays, and the
// same bits. Bound: the iteration's own device time; the test kernel and
// the body's re-launch add ~4 us an iteration (a Poisson solve of 532 loop
// iterations: 106.9 ms, 200.9 us an iteration, against 196.7 us of the
// body's kernels). Memcpy and memset nodes of the body run as kernels.

#include <cuda_runtime.h>

namespace {

__global__ void krylov_loop_test(cudaGraphConditionalHandle handle,
                                 const bool* flag, int* ctl) {
  const int left = ctl[0] - 1;
  const bool more = *flag;
  ctl[0] = left;
  ctl[1] = more ? 1 : 0;
  cudaGraphSetConditional(handle, (more && left > 0) ? 1u : 0u);
}

struct Loop {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
};

int wrap(cudaGraph_t* out, cudaGraph_t iteration, const bool* flag, int* ctl) {
  cudaError_t e = cudaGraphCreate(out, 0);
  if (e != cudaSuccess) return (int)e;
  cudaGraph_t graph = *out;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 1,
                                       cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, nullptr, 0, &params);
  if (e != cudaSuccess) return (int)e;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  cudaGraphNode_t step;
  e = cudaGraphAddChildGraphNode(&step, body, nullptr, 0, iteration);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&handle, &flag, &ctl};
  cudaKernelNodeParams test = {};
  test.func = reinterpret_cast<void*>(krylov_loop_test);
  test.gridDim = dim3(1);
  test.blockDim = dim3(1);
  test.kernelParams = args;
  cudaGraphNode_t test_node;
  return (int)cudaGraphAddKernelNode(&test_node, body, &step, 1, &test);
}

int build(Loop* loop, cudaGraph_t iteration, const bool* flag, int* ctl) {
  int err = wrap(&loop->graph, iteration, flag, ctl);
  if (err != 0) return err;
  return (int)cudaGraphInstantiate(&loop->exec, loop->graph, 0);
}

void release(Loop* loop) {
  if (loop->exec) cudaGraphExecDestroy(loop->exec);
  if (loop->graph) cudaGraphDestroy(loop->graph);
  delete loop;
}

}  // namespace

// iteration: the captured cudaGraph_t (cloned; the caller keeps it and the
// memory it names); flag: the bool the iteration writes, true while the
// solve is unconverged; ctl: two ints on the same device. On success *out
// holds the loop for krylov_loop_launch and krylov_loop_destroy. Returns
// the first CUDA error, 0 on success.
extern "C" int krylov_loop_create(void* iteration, const void* flag,
                                  void* ctl, int device, void** out) {
  *out = nullptr;
  int before = device;
  cudaError_t e = cudaGetDevice(&before);
  if (e != cudaSuccess) return (int)e;
  if (before != device && (e = cudaSetDevice(device)) != cudaSuccess)
    return (int)e;
  Loop* loop = new Loop{nullptr, nullptr};
  const int err = build(loop, static_cast<cudaGraph_t>(iteration),
                        static_cast<const bool*>(flag),
                        static_cast<int*>(ctl));
  if (before != device) cudaSetDevice(before);
  if (err != 0) {
    release(loop);
    return err;
  }
  *out = loop;
  return 0;
}

// One launch of the loop on `stream`; it runs the iteration ctl[0] times
// at most (ctl[0] >= 1, written before the launch on the same stream).
extern "C" int krylov_loop_launch(void* loop, void* stream) {
  return (int)cudaGraphLaunch(static_cast<Loop*>(loop)->exec,
                              static_cast<cudaStream_t>(stream));
}

// Frees the loop's graphs (a launch in flight completes first).
extern "C" void krylov_loop_destroy(void* loop) {
  release(static_cast<Loop*>(loop));
}
