// Conditional (If) nodes in a CUDA stream capture: the on-device branch that
// `utils/graph_cond.py` opens around a block of a captured graph.
//
// Counterpart of the predicates of the JAX package's `lax.cond`,
// `lax.while_loop` and `lax.fori_loop` under `jax.jit`
// (`intensity_slam_tpu/ops/solver.py:177`, `pipeline/slam.py:126`,
// `pipeline/mapping.py:355`, `:360`, `pipeline/fused.py:193`, `:208`,
// `pipeline/loop.py:330`, `:608`, `:640`, `pipeline/posegraph.py:725`),
// which XLA evaluates on the device; there is no Pallas source.  The design is that of torch's own
// `CUDAGraph::begin_capture_to_if_node`: `isl_cond_open` creates the node's
// handle in the graph the stream is capturing, launches `set_handle_kernel`
// (one thread: reads the 0-d bool predicate, sets the handle), adds the node
// after the stream's current dependencies, makes it the stream's only
// dependency and begins capturing a second stream straight into the node's
// body graph; `isl_cond_close` ends that capture.  Nodes nest: a body stream
// that is capturing opens a node in the body graph.
//
// Bound: one byte read and one handle write, so its time is the launch's and
// the node's evaluation, not its work; nothing to design beyond one thread.

#include <cuda_runtime.h>

namespace {

__global__ void set_handle_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// Opens an If node on the device bool `*pred` in the graph that `stream` is
// capturing and begins capturing `body_stream` into the node's body in
// `mode` (a cudaStreamCaptureMode).  Returns a cudaError_t.
int isl_cond_open(const void* pred, void* stream, void* body_stream, int mode) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_handle_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the launch moved the stream's dependencies on to the kernel's node
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                       params.conditional.phGraph_out[0], nullptr, nullptr,
                                       0, static_cast<cudaStreamCaptureMode>(mode));
}

// Ends the capture of a node's body on `body_stream`.  Returns a cudaError_t.
int isl_cond_close(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

const char* isl_cond_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
