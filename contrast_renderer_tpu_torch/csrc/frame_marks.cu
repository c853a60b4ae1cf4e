// frame_marks: the device marks of the port's frame record
// (utils/profiling.py, FrameRecord).
//
// Replaces no TPU kernel.  The reference's backend, WebGPU, times the
// passes of a frame with timestamp queries written by the device between
// them; the JAX package has nothing of the kind.  make_prepare (ops/
// coverage.py) calls a mark at each boundary of its five stages, so a mark
// is captured into the CUDA graph that a frame replays and costs the host
// nothing on a replay.
//
// A mark is one thread: it reads the device's global timer (%globaltimer,
// nanoseconds) and writes it into the current frame's row of a ring of
// `frames` rows of 1 + `marks` int64 (the frame's number, then its marks).
// The frame's number is a device counter that the last mark advances, so
// a replayed graph writes each frame into a row of its own.  Bound by
// launch latency alone: a node of a graph, about a microsecond.
//
// frame_mark_capture_nodes gives the node count of the graph that a stream
// is capturing into (cudaStreamGetCaptureInfo), which the record reads at
// each mark of a capture to count binning's nodes per stage.

#include <cuda_runtime.h>

namespace {

__global__ void frame_mark_kernel(long long* ring, long long* counter, int mark,
                                  int marks, int frames, int last) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long frame = *counter;
  long long* row = ring + (frame % frames) * (1 + marks);
  if (mark == 0) row[0] = frame;
  row[1 + mark] = static_cast<long long>(now);
  if (last) *counter = frame + 1;
}

}  // namespace

extern "C" int frame_mark_launch(void* ring, void* counter, int mark, int marks,
                                 int frames, int last, void* stream) {
  if (ring == nullptr || counter == nullptr || mark < 0 || mark >= marks ||
      frames < 1)
    return (int)cudaErrorInvalidValue;
  frame_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(counter), mark,
      marks, frames, last);
  return (int)cudaGetLastError();
}

extern "C" long long frame_mark_capture_nodes(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  size_t nodes = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                               nullptr, &graph) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive || graph == nullptr ||
      cudaGraphGetNodes(graph, nullptr, &nodes) != cudaSuccess) {
    // Clear the error, so that the next launch's check does not report it.
    cudaGetLastError();
    return -1;
  }
  return static_cast<long long>(nodes);
}
