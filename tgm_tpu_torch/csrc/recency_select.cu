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
// int32, about 1.1 MB: 0.3 us at the H100 SXM's published 3.35 TB/s (700 W
// power limit), far below the few microseconds a launch costs. So it is
// launch-bound.
//
// Design: one thread per seed. The thread walks ages 0..B-1 (newest first),
// counts valid slots r and writes the r-th valid slot straight to column
// K-1-r, stopping after K. No rank matrix, no one-hot reduce: those were the
// TPU's way to vectorise a gather-free select, and a scalar walk per thread
// is cheaper here. wp grows without bound and CUDA's % truncates toward zero,
// so the slot index uses ((x % B) + B) % B, the floor modulo of the JAX code.
//
// K4: the same select with an fp32 feature payload.
//
// Replaces the Pallas TPU kernel recency_window_select
// (tgm_tpu/ops/pallas/recency_select.py, body _kernel). Contract: the same
// (id, time) select as K1, filled with PAD / 0, plus each selected slot's
// D-float feature row copied bit for bit into the same column, the columns
// nobody writes zero-filled. The TPU kernel copies with a masked one-hot
// reduce per output column, since a matmul would round through bf16.
//
// What bounds it on an H100: memory. At the DyGFormer eval shape (S = 4,400
// seeds, B = K = 20, D = 172) it writes an (S, K, D) fp32 block of 60.5 MB
// and reads the selected feature rows, up to another 60.5 MB: about 37 us at
// the H100 SXM's published 3.35 TB/s (700 W power limit) when every slot is
// selected.
//
// Design: one warp per seed. Lane l looks at the slots of age l and l + 32
// (B <= 64), so a warp ballot over ages gives a bit mask of the valid
// slots in age order, and a slot's rank is the popcount of the valid bits
// below its age. Each selected lane writes its id and time to column
// K-1-rank and its slot index to a per-warp table in shared memory. The
// warp then streams the selected feature rows and the zero fill over its
// output block, float4 per lane when D % 4 == 0 and the rows are 16-byte
// aligned, else one float per lane. Nothing is multiplied: it is a copy.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPad = -1;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxSlots = 64;

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

__device__ __forceinline__ int floor_mod(int x, int b) { return ((x % b) + b) % b; }

__global__ void recency_select_feats_kernel(
    const int* __restrict__ ids, const int* __restrict__ times,
    const float* __restrict__ feats, const int* __restrict__ write_pos,
    const int* __restrict__ query_times, int* __restrict__ out_ids,
    int* __restrict__ out_times, float* __restrict__ out_feats, int S, int B,
    int K, int D) {
  __shared__ int src_slot[kWarpsPerBlock][kMaxSlots];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + warp;
  if (s >= S) return;  // warp-uniform: the whole warp leaves together
  const long row = static_cast<long>(s) * B;
  const long out = static_cast<long>(s) * K;
  const int wp = write_pos[s];
  const int qt = query_times[s];

  // Ages a0 = lane and a1 = lane + 32; the slot of age a is (wp - 1 - a) mod B.
  bool valid0 = false, valid1 = false;
  int j0 = 0, j1 = 0, id0 = 0, id1 = 0, t0 = 0, t1 = 0;
  if (lane < B) {
    j0 = floor_mod(wp - 1 - lane, B);
    id0 = ids[row + j0];
    t0 = times[row + j0];
    valid0 = t0 < qt && id0 != kPad;
  }
  if (lane + 32 < B) {
    j1 = floor_mod(wp - 1 - (lane + 32), B);
    id1 = ids[row + j1];
    t1 = times[row + j1];
    valid1 = t1 < qt && id1 != kPad;
  }
  const unsigned lo = __ballot_sync(0xffffffffu, valid0);
  const unsigned hi = __ballot_sync(0xffffffffu, valid1);
  const unsigned below = (1u << lane) - 1u;  // lane < 32, so the shift is defined
  const int rank0 = __popc(lo & below);
  const int rank1 = __popc(lo) + __popc(hi & below);
  const int n_valid = __popc(lo) + __popc(hi);
  const int n_sel = n_valid < K ? n_valid : K;
  const int n_fill = K - n_sel;  // columns [0, n_fill) stay empty

  if (valid0 && rank0 < K) {
    const int c = K - 1 - rank0;
    out_ids[out + c] = id0;
    out_times[out + c] = t0;
    src_slot[warp][c] = j0;
  }
  if (valid1 && rank1 < K) {
    const int c = K - 1 - rank1;
    out_ids[out + c] = id1;
    out_times[out + c] = t1;
    src_slot[warp][c] = j1;
  }
  for (int c = lane; c < n_fill; c += 32) {
    out_ids[out + c] = kPad;
    out_times[out + c] = 0;
  }
  __syncwarp();

  const float* in_row = feats + row * D;
  float* out_row = out_feats + out * D;
  const bool vec = (D % 4 == 0) &&
                   (reinterpret_cast<std::uintptr_t>(feats) % 16 == 0) &&
                   (reinterpret_cast<std::uintptr_t>(out_feats) % 16 == 0);
  if (vec) {
    const int D4 = D / 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4* o4 = reinterpret_cast<float4*>(out_row);
    for (int i = lane; i < n_fill * D4; i += 32) o4[i] = zero;
    for (int i = lane; i < n_sel * D4; i += 32) {
      const int c = n_fill + i / D4;
      const int q = i % D4;
      const float4* src =
          reinterpret_cast<const float4*>(in_row + static_cast<long>(src_slot[warp][c]) * D);
      o4[static_cast<long>(c) * D4 + q] = src[q];
    }
  } else {
    for (int i = lane; i < n_fill * D; i += 32) out_row[i] = 0.f;
    for (int i = lane; i < n_sel * D; i += 32) {
      const int c = n_fill + i / D;
      const int q = i % D;
      out_row[static_cast<long>(c) * D + q] =
          in_row[static_cast<long>(src_slot[warp][c]) * D + q];
    }
  }
}

}  // namespace

extern "C" int recency_window_select(
    const void* ids, const void* times, const void* feats,
    const void* write_pos, const void* query_times, void* out_ids,
    void* out_times, void* out_feats, int S, int B, int K, int D,
    void* stream) {
  if (B > kMaxSlots || K > B || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  recency_select_feats_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const int*>(times),
      static_cast<const float*>(feats), static_cast<const int*>(write_pos),
      static_cast<const int*>(query_times), static_cast<int*>(out_ids),
      static_cast<int*>(out_times), static_cast<float*>(out_feats), S, B, K, D);
  return static_cast<int>(cudaGetLastError());
}

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
