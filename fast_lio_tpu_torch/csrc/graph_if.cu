// CUDA-graph conditional nodes recorded into a stream capture, for the
// port's gated step (fast_lio_tpu_torch/control_flow.py): IF nodes, the
// counterpart of the JAX step's lax.cond, and WHILE nodes, of its
// lax.while_loop.  Built by
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
// graph_while_begin does the same with a WHILE node, whose condition is
// JAX's `~done & (i < max_iter)` over L lanes (L = 1 outside a batch; a
// batched loop runs while any lane is active): while_condition_kernel, one
// warp, reads every lane's done flag and loop index, sets the handle, and
// where asked writes each lane's condition (`active`, the mask by which a
// batched body keeps a lane's pass, JAX's batching rule for while).
// It runs once on the outer stream before the node, which sets the handle
// at every replay (so nothing rests on the handle's default value, also
// where the loop sits in the body of another conditional node), and
// graph_while_end launches it again on the body stream as the body's last
// node, before it ends the body's capture: the node runs its body again
// while the condition holds after a pass.  The loop index bounds the
// loop: a body whose done flag never turns true still ends once every
// lane's i reaches max_iter.  The launch inside the body adds one to a
// device counter (the passes run); the one before the node counts none.
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

// One warp: active[l] := !done[l] && i[l] < max_iter (where `active` is
// given), the handle := any lane's; `passes` (or null) gains one.
__global__ void while_condition_kernel(cudaGraphConditionalHandle handle,
                                       const bool* done, const int* i,
                                       int lanes, int max_iter, bool* active,
                                       unsigned long long* passes) {
  bool any = false;
  for (int l = threadIdx.x; l < lanes; l += 32) {
    bool a = !done[l] && i[l] < max_iter;
    if (active) active[l] = a;
    any |= a;
  }
  any = __any_sync(0xffffffffu, any);
  if (threadIdx.x == 0) {
    cudaGraphSetConditional(handle, any ? 1u : 0u);
    if (passes) *passes += 1;
  }
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

// Adds a conditional node of `type` on `handle` after the capture's current
// nodes of `s`, makes it the capture's only dependency, and starts
// capturing its body on `body_stream`.
cudaError_t add_node_and_capture_body(cudaStream_t s, cudaStream_t body_stream,
                                      cudaGraphConditionalHandle handle,
                                      cudaGraphConditionalNodeType type) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
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
  return cudaStreamBeginCaptureToGraph(body_stream,
                                       params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeGlobal);
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
  return add_node_and_capture_body(s, static_cast<cudaStream_t>(body_stream),
                                   handle, cudaGraphCondTypeIf);
}

// Records a WHILE node into the capture of `stream`, its condition
// `~done[l] & (i[l] < max_iter)` for some lane l < lanes (done: bool, i:
// int32, both on the device; each lane's into active[l] unless `active` is
// null), and starts capturing its body on `body_stream`; *handle_out is
// the node's handle, for graph_while_end.  Returns a cudaError_t (0 = ok).
int graph_while_begin(const bool* done, const int* i, int lanes,
                      int max_iter, bool* active, void* stream,
                      void* body_stream, unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err) return err;
  while_condition_kernel<<<1, 32, 0, s>>>(handle, done, i, lanes, max_iter,
                                          active, nullptr);
  err = cudaGetLastError();
  if (err) return err;
  *handle_out = handle;
  return add_node_and_capture_body(s, static_cast<cudaStream_t>(body_stream),
                                   handle, cudaGraphCondTypeWhile);
}

// Ends the body of the WHILE node begun by graph_while_begin: the
// condition kernel again, as the body's last node (each run of it adds
// one to *passes, a device counter), then the end of the body's capture.
int graph_while_end(unsigned long long handle, const bool* done, const int* i,
                    int lanes, int max_iter, bool* active,
                    unsigned long long* passes, void* body_stream) {
  cudaStream_t b = static_cast<cudaStream_t>(body_stream);
  while_condition_kernel<<<1, 32, 0, b>>>(handle, done, i, lanes, max_iter,
                                          active, passes);
  cudaError_t launched = cudaGetLastError();
  cudaGraph_t body;
  cudaError_t ended = cudaStreamEndCapture(b, &body);
  return launched ? launched : ended;
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
