// K1: recency window select over edge-id ring buffers.
//
// Replaces the Pallas TPU kernels recency_window_select_eid and
// recency_window_select_eid_lanes (tgm_tpu/ops/pallas/recency_select.py,
// bodies _kernel_eid and _kernel_eid_lanes). The two differ only in which
// axis holds the seeds on the TPU's 128 lanes; one CUDA kernel serves both.
//
// Contract (same as the Pallas kernels): for each seed s, given its
// pre-gathered B-slot ring row (ids, times, eids), its write position wp[s]
// and its query time qt[s], return the K most recent valid slots (valid:
// time < qt and id != PAD), oldest to newest, right-aligned in K columns,
// the rest filled with PAD / 0 / -1. Slot j has age (wp - 1 - j) mod B,
// age 0 being the newest. Integers only; exact.
//
// What bounds it on an H100: memory and launch. At the eval shape (S = 4,400
// seeds, B = K = 10) the kernel reads 3*S*B + 2*S int32 and writes 3*S*K
// int32, about 1.1 MB: 0.3 us at 3.35 TB/s, far below the few microseconds
// a launch costs. So it is launch-bound.
//
// Design: one thread per seed. The thread walks ages 0..B-1 (newest first),
// counts valid slots r and writes the r-th valid slot straight to column
// K-1-r, stopping after K. No rank matrix, no one-hot reduce: those were the
// TPU's way to vectorise a gather-free select, and a scalar walk per thread
// is cheaper here. wp grows without bound and CUDA's % truncates toward zero,
// so the slot index uses ((x % B) + B) % B, the floor modulo of the JAX code.

#include <cuda_runtime.h>

namespace {

constexpr int kPad = -1;

__global__ void recency_select_eid_kernel(
    const int* __restrict__ ids, const int* __restrict__ times,
    const int* __restrict__ eids, const int* __restrict__ write_pos,
    const int* __restrict__ query_times, int* __restrict__ out_ids,
    int* __restrict__ out_times, int* __restrict__ out_eids, int S, int B,
    int K) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const long row = static_cast<long>(s) * B;
  const long out = static_cast<long>(s) * K;
  const int wp = write_pos[s];
  const int qt = query_times[s];
  int r = 0;
  for (int a = 0; a < B && r < K; ++a) {
    const int j = (((wp - 1 - a) % B) + B) % B;
    const int id = ids[row + j];
    const int t = times[row + j];
    if (t < qt && id != kPad) {
      const int c = K - 1 - r;
      out_ids[out + c] = id;
      out_times[out + c] = t;
      out_eids[out + c] = eids[row + j];
      ++r;
    }
  }
  for (int c = 0; c < K - r; ++c) {
    out_ids[out + c] = kPad;
    out_times[out + c] = 0;
    out_eids[out + c] = -1;
  }
}

}  // namespace

extern "C" int recency_window_select_eid(
    const void* ids, const void* times, const void* eids,
    const void* write_pos, const void* query_times, void* out_ids,
    void* out_times, void* out_eids, int S, int B, int K, void* stream) {
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  recency_select_eid_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const int*>(times),
      static_cast<const int*>(eids), static_cast<const int*>(write_pos),
      static_cast<const int*>(query_times), static_cast<int*>(out_ids),
      static_cast<int*>(out_times), static_cast<int*>(out_eids), S, B, K);
  return static_cast<int>(cudaGetLastError());
}
