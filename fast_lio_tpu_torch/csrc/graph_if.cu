// CUDA-graph conditional (IF) nodes recorded into a stream capture, for the
// port's gated step (fast_lio_tpu_torch/control_flow.py, the counterpart of
// the JAX step's lax.cond and lax.while_loop).  Built by
// fast_lio_tpu_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface, called through ctypes by
// fast_lio_tpu_torch/kernels/graph_if.py.
//
// graph_if_begin, on a stream that is capturing a graph (the step's capture,
// or the body of an enclosing IF node):
//   1. creates a conditional handle in the captured graph, reset to 0 at
//      every launch of the graph;
//   2. launches set_condition_kernel (one thread) on the stream, which the
//      capture records: at each replay it reads the predicate, a bool on the
//      device, and sets the handle (cudaGraphSetConditional);
//   3. adds an IF node on the handle after the capture's current nodes, and
//      makes it the capture's only dependency, so the work captured after it
//      runs after the node;
//   4. starts capturing the node's body graph on body_stream.
// The caller then issues the body's work on body_stream and calls
// graph_if_end(body_stream), which ends the body's capture.  A replay runs
// the body only where the predicate held when the kernel of step 2 ran.
//
// Needs CUDA 12.4 or later (the CUDA runtime and the CUDA driver).  This
// is no kernel of the TPU package: it replaces no pallas_call, only XLA's
// own control flow.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The graph a stream is capturing and its current dependencies.
cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                             nullptr, n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                             n);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  return err;
}

}  // namespace

extern "C" {

// Records an IF node on *pred (a bool on the device) into the capture of
// `stream` and starts capturing its body on `body_stream`; returns a
// cudaError_t (0 = ok).  Both streams are on the current device.
int graph_if_begin(const bool* pred, void* stream, void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err) return err;
  set_condition_kernel<<<1, 1, 0, s>>>(handle, pred);
  err = cudaGetLastError();
  if (err) return err;
  err = capture_info(s, &graph, &deps, &n);  // now: the kernel's node
  if (err) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
  if (err) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err) return err;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeGlobal);
}

// Ends the capture of an IF node's body begun by graph_if_begin.
int graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

// A non-blocking stream for IF bodies (the caller keeps it for the process).
int graph_if_stream_create(void** out) {
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = err ? nullptr : static_cast<void*>(s);
  return err;
}

const char* graph_if_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
