// The device loop of a captured CUDA graph: a conditional WHILE node, the
// counterpart of the JAX package's lax.while_loop inside its jitted program
// (the boundary CG of devicekmc_tpu/ops/cg.py:112 inside jit(superstep_impl),
// devicekmc_tpu/engine.py:156).
//
// dkmc_while_begin is called while PyTorch captures `stream` (torch.cuda.graph).
// It adds to the graph under capture:
//
//   * a kernel that copies the predicate cond[0] (an int32 in device memory,
//     written by the captured work before it) into the node's condition, so a
//     loop whose predicate is false on entry runs no iteration (its launches
//     counted on the card when `count` is not null: once at every entry);
//   * the WHILE node after it, and makes the node the stream's only
//     dependency, so the work captured next runs after the loop;
//
// and begins capturing `side` into the node's body graph.  The caller then
// launches the body's kernels on `side` (hand-written kernels on buffers
// allocated before the capture: nothing allocates inside the body) with the
// returned handle; the body's last kernel sets the condition with
// cudaGraphSetConditional.  dkmc_while_end ends the body's capture.
//
// A loop inside a loop: `stream` may itself be a stream that captures the
// body of another WHILE node (the caller passes it and a second side
// stream).  The handle is then made on that body graph, the node is added to
// it, and the inner body is captured from `side`.
//
// The handles are the driver's: this library links the CUDA runtime
// statically, and a stream, a graph and a node made through PyTorch's runtime
// are the same objects here.  Needs CUDA 12.4 (conditional nodes added during
// a capture, and nested in a body) and a Hopper card; a body holds kernel
// nodes and WHILE nodes only, joined by edges.

#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

__global__ void while_cond_kernel(cudaGraphConditionalHandle handle, const int* cond,
                                  unsigned long long* count) {
  count_launch(count);
  cudaGraphSetConditional(handle, cond[0] != 0);
}

// The capture's graph and current dependencies of `stream`.
cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
#if CUDART_VERSION >= 13000
  const cudaGraphEdgeData* edges;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps, &edges, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" int dkmc_while_begin(void* stream, void* side, const void* cond, void* count,
                                unsigned long long* handle_out) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(st, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  while_cond_kernel<<<1, 1, 0, st>>>(handle, static_cast<const int*>(cond),
                                     static_cast<unsigned long long*>(count));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = capture_info(st, &graph, &deps, &n_deps);  // now the kernel above
  if (err != cudaSuccess) return (int)err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(st, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(st, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(side),
                                      params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                      cudaStreamCaptureModeRelaxed);
  if (err != cudaSuccess) return (int)err;
  *handle_out = handle;
  return 0;
}

extern "C" int dkmc_while_end(void* side) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(side), &body);
}
