// A `while` loop inside a captured CUDA graph: a conditional WHILE node whose
// condition a kernel sets on the device, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package runs a While inside
// Executor.run(steps=K) as one lax.while_loop (paddle_tpu/ops/
// control_ops.py:249-300), whose predicate XLA evaluates on the device. The
// port's eager rule reads the condition on the host once an iteration, and a
// host read cannot be captured. Here the loop becomes a graph node instead
// (CUDA 12.3+): the node's body graph runs while its conditional handle
// holds a nonzero value, and `set_while_condition` writes that value from a
// bool in device memory, once upstream of the node (the entry test) and once
// at the end of the body (the test before the next iteration).
//
// The capture sequence (ptt_graph_while_begin / ptt_graph_while_end), on the
// stream that is capturing the step:
//   1. the capture's graph and its current dependencies
//      (cudaStreamGetCaptureInfo);
//   2. a conditional handle on that graph, reset to 0 at every launch;
//   3. set_while_condition(handle, cond) captured on that stream;
//   4. the WHILE node added at the stream's dependencies (cudaGraphAddNode),
//      and the stream's dependencies set to the node
//      (cudaStreamUpdateCaptureDependencies): what the step captures next
//      runs after the loop;
//   5. the body stream begins capturing into the node's body graph
//      (cudaStreamBeginCaptureToGraph). The caller captures the body there,
//      ending with set_while_condition on the body's new condition, then
//      ends that capture.
//
// What bounds it: launch latency. set_while_condition reads one byte and
// does no arithmetic; what the node saves is the host round trip of each
// iteration's condition read (a device-to-host copy and a stream sync).
#include <cuda_runtime.h>

namespace {

__global__ void set_while_condition_kernel(cudaGraphConditionalHandle handle,
                                           const bool* cond) {
  cudaGraphSetConditional(handle, *cond ? 1u : 0u);
}

}  // namespace

// The text of a cudaError_t (the wrappers name the cause when they raise).
extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch set_while_condition on `stream`: the handle takes 1 if *cond else 0.
extern "C" int ptt_set_while_condition(unsigned long long handle,
                                       const void* cond, void* stream) {
  set_while_condition_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const bool*>(cond));
  return static_cast<int>(cudaGetLastError());
}

// Steps 1-5 above. `stream` is capturing; `body_stream` is not. `cond` is
// the loop's entry condition (a bool on the device). Writes the node's
// handle to *handle_out. Returns a cudaError_t (0 on success).
extern "C" int ptt_graph_while_begin(void* stream, void* body_stream,
                                     const void* cond,
                                     unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_while_condition_kernel<<<1, 1, 0, s>>>(handle,
                                             static_cast<const bool*>(cond));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = static_cast<unsigned long long>(handle);
  return 0;
}

// End the body's capture on `body_stream` (the node owns the body graph).
extern "C" int ptt_graph_while_end(void* body_stream) {
  cudaGraph_t body = nullptr;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}
