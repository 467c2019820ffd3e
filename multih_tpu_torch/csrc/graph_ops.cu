// The device ops captured so far into the CUDA graph a stream is
// capturing: its kernel, copy and set nodes, the ops that each replay of
// the graph runs on the card (utils/aot.CapturedFit reads the count at
// every stage boundary of a capture, utils/tracing.StageTable).
//
// No kernel: host calls of the runtime only. A capture records each
// stream operation as one node, so the count grows by one for every
// kernel launch, copy and set made on the stream. Other node kinds
// (events, empty joins, child graphs) run nothing a profile sees as an
// op and are left out.
//
// A stage boundary reads the count again, so each read resumes where the
// last one stopped: the runtime lists a graph's nodes in the order they
// were added, and the nodes already classified are skipped when the node
// the last read ended on still stands at its place in the list (same
// graph, same capture). Otherwise the whole list is classified again. A
// boundary then costs one copy of the node list and a type query of each
// new node, not of every node: the whole walk at each of the ~60
// boundaries of a motion fit's capture (~53k nodes) took 0.6-0.8 s.

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace {

struct Seen {
  cudaGraph_t graph = nullptr;
  unsigned long long capture = 0;
  size_t nodes = 0;
  cudaGraphNode_t last = nullptr;
  long long ops = 0;
};

std::mutex seen_mutex;
Seen seen;

}  // namespace

extern "C" int multih_graph_ops(void* stream, long long* out) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long capture = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &capture, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) {
    return static_cast<int>(cudaErrorIllegalState);
  }
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) {
    err = cudaGraphGetNodes(graph, nodes.data(), &n);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  std::lock_guard<std::mutex> lock(seen_mutex);
  size_t from = 0;
  long long ops = 0;
  if (seen.graph == graph && seen.capture == capture && seen.nodes > 0 &&
      seen.nodes <= n && nodes[seen.nodes - 1] == seen.last) {
    from = seen.nodes;
    ops = seen.ops;
  }
  for (size_t i = from; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    ops += type == cudaGraphNodeTypeKernel ||
           type == cudaGraphNodeTypeMemcpy ||
           type == cudaGraphNodeTypeMemset;
  }
  seen = Seen{graph, capture, n, n > 0 ? nodes[n - 1] : nullptr, ops};
  *out = ops;
  return static_cast<int>(cudaSuccess);
}
