// K1: recency window select over edge-id ring buffers.
//
// Replaces the Pallas TPU kernels recency_window_select_eid and
// recency_window_select_eid_lanes (tgm_tpu/ops/pallas/recency_select.py,
// bodies _kernel_eid and _kernel_eid_lanes). The two differ only in which
// axis holds the seeds on the TPU's 128 lanes; one CUDA kernel serves both.
//
// Contract (same as the Pallas kernels): for each seed s, given its B-slot
// ring row (ids, times, eids), its write position wp and its query time
// qt[s], return the K most recent valid slots (valid: time < qt and id !=
// PAD), oldest to newest, right-aligned in K columns, the rest filled with
// PAD / 0 / -1. Slot j has age (wp - 1 - j) mod B, age 0 being the newest.
// Integers only; exact.
//
// Beyond the Pallas contract, which takes rows the caller gathered per seed,
// the kernel reads the ring state in place and fuses the feature gather that
// follows the select in the hook (gather_edge_feats):
// - given the seeds, it reads row seed of the (N1, B) state, an invalid seed
//   (< 0 or >= N1 - 1) reading the dump row N1 - 1; without them row s of
//   the pre-gathered (S, B) rows (the Pallas entry);
// - given a static (E_all, D) fp32 edge table, it writes an (S, K, D)
//   output: column c holds edge_x[min(eid, E_all - 1)] for the edge id eid
//   of column c, or zeros where eid < 0, bit for bit what gather_edge_feats
//   gives.
//
// What bounds it on an H100: memory. At the TGN eval shape (S = 4,400 seeds,
// B = K = 10, D = 172) it writes an (S, K, D) fp32 block of 30.3 MB and
// reads up to as many bytes of selected edge rows: about 18 us at the H100
// SXM's published 3.35 TB/s (700 W power limit). Without features (the
// Pallas entry) it moves about 1.1 MB and is launch-bound.
//
// Design: K4's (below), one warp per seed. Lane l looks at the slots of ages
// l and l + 32 (B <= 64); a warp ballot gives the valid slots in age order,
// a popcount each slot's rank. Selected lanes write id, time and edge id to
// column K-1-rank and the edge id to a per-warp table in shared memory; the
// warp then streams the K output rows, four float4 (or float) loads in
// flight per lane before their stores. wp grows without bound and CUDA's %
// truncates toward zero, so the slot index uses a floor modulo, as the JAX
// code does.
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
constexpr int kCopyUnroll = 4;  // K1's loads in flight per lane

__device__ __forceinline__ int floor_mod(int x, int b) { return ((x % b) + b) % b; }

// The rank rule over one seed's B-slot ring row (starting at `row`), for a
// whole warp: lane l holds the slots of ages l and l + 32 (h = 0 and 1); a
// ballot gives the valid slots in age order, a popcount each one's rank.
struct WarpSlots {
  bool valid[2];
  int slot[2], id[2], time[2], rank[2];
  int n_valid;
};

__device__ __forceinline__ WarpSlots rank_slots(const int* __restrict__ ids,
                                                const int* __restrict__ times, long long row,
                                                int wp, int qt, int B, int lane) {
  WarpSlots w;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int age = lane + 32 * h;
    w.valid[h] = false;
    w.slot[h] = w.id[h] = w.time[h] = 0;
    if (age < B) {
      w.slot[h] = floor_mod(wp - 1 - age, B);
      w.id[h] = ids[row + w.slot[h]];
      w.time[h] = times[row + w.slot[h]];
      w.valid[h] = w.time[h] < qt && w.id[h] != kPad;
    }
  }
  const unsigned lo = __ballot_sync(0xffffffffu, w.valid[0]);
  const unsigned hi = __ballot_sync(0xffffffffu, w.valid[1]);
  const unsigned below = (1u << lane) - 1u;  // lane < 32, so the shift is defined
  w.rank[0] = __popc(lo & below);
  w.rank[1] = __popc(lo) + __popc(hi & below);
  w.n_valid = __popc(lo) + __popc(hi);
  return w;
}

// Copies the (K, W) output block of one seed, W = D (T = float) or D / 4
// (T = float4): row c is edge_x[min(eid[c], E_all - 1)], or zeros where
// eid[c] < 0.
template <typename T>
__device__ __forceinline__ void copy_edge_rows(const T* __restrict__ edge_x, T* __restrict__ out,
                                               const int* eid, int K, int W, int E_all,
                                               int lane) {
  const int total = K * W;
  for (int i0 = lane; i0 < total; i0 += 32 * kCopyUnroll) {
    T v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int i = i0 + 32 * u;
      v[u] = T{};
      if (i < total) {
        const int c = i / W;
        const int e = eid[c];
        if (e >= 0) v[u] = edge_x[static_cast<long long>(min(e, E_all - 1)) * W + (i - c * W)];
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int i = i0 + 32 * u;
      if (i < total) out[i] = v[u];
    }
  }
}

__global__ void recency_select_eid_kernel(
    const int* __restrict__ ids, const int* __restrict__ times,
    const int* __restrict__ eids, const int* __restrict__ write_pos,
    const int* __restrict__ seeds, const int* __restrict__ query_times,
    const float* __restrict__ edge_x, int* __restrict__ out_ids,
    int* __restrict__ out_times, int* __restrict__ out_eids,
    float* __restrict__ out_feats, int S, int N1, int B, int K, int E_all,
    int D, bool vec) {
  __shared__ int sel_eid[kWarpsPerBlock][kMaxSlots];  // edge id of each output column
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + warp;
  if (s >= S) return;  // warp-uniform: the whole warp leaves together
  int node = s;
  if (seeds != nullptr) {
    const int seed = seeds[s];
    node = (seed >= 0 && seed < N1 - 1) ? seed : N1 - 1;  // invalid seeds read the dump row
  }
  const long long row = static_cast<long long>(node) * B;
  const long long out = static_cast<long long>(s) * K;
  const WarpSlots w = rank_slots(ids, times, row, write_pos[node], query_times[s], B, lane);
  const int n_fill = K - min(w.n_valid, K);  // columns [0, n_fill) stay empty

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (w.valid[h] && w.rank[h] < K) {
      const int c = K - 1 - w.rank[h];
      const int e = eids[row + w.slot[h]];
      out_ids[out + c] = w.id[h];
      out_times[out + c] = w.time[h];
      out_eids[out + c] = e;
      sel_eid[warp][c] = e;
    }
  }
  for (int c = lane; c < n_fill; c += 32) {
    out_ids[out + c] = kPad;
    out_times[out + c] = 0;
    out_eids[out + c] = -1;
    sel_eid[warp][c] = -1;
  }
  if (out_feats == nullptr) return;
  __syncwarp();
  if (vec) {
    copy_edge_rows(reinterpret_cast<const float4*>(edge_x),
                   reinterpret_cast<float4*>(out_feats + out * D), sel_eid[warp], K, D / 4,
                   E_all, lane);
  } else {
    copy_edge_rows(edge_x, out_feats + out * D, sel_eid[warp], K, D, E_all, lane);
  }
}

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
  const WarpSlots w = rank_slots(ids, times, row, write_pos[s], query_times[s], B, lane);
  const int n_sel = min(w.n_valid, K);
  const int n_fill = K - n_sel;  // columns [0, n_fill) stay empty

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (w.valid[h] && w.rank[h] < K) {
      const int c = K - 1 - w.rank[h];
      out_ids[out + c] = w.id[h];
      out_times[out + c] = w.time[h];
      src_slot[warp][c] = w.slot[h];
    }
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

// seeds null: the state is S pre-gathered rows, row s for seed s. edge_x and
// out_feats both null: no features.
extern "C" int recency_eid_select(
    const void* ids, const void* times, const void* eids,
    const void* write_pos, const void* seeds, const void* query_times,
    const void* edge_x, void* out_ids, void* out_times, void* out_eids,
    void* out_feats, int S, int N1, int B, int K, int E_all, int D,
    void* stream) {
  if (B > kMaxSlots || K > B || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((edge_x == nullptr) != (out_feats == nullptr) || (edge_x != nullptr && E_all < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (D % 4 == 0) && (reinterpret_cast<std::uintptr_t>(edge_x) % 16 == 0) &&
                   (reinterpret_cast<std::uintptr_t>(out_feats) % 16 == 0);
  const int blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  recency_select_eid_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const int*>(times),
      static_cast<const int*>(eids), static_cast<const int*>(write_pos),
      static_cast<const int*>(seeds), static_cast<const int*>(query_times),
      static_cast<const float*>(edge_x), static_cast<int*>(out_ids),
      static_cast<int*>(out_times), static_cast<int*>(out_eids),
      static_cast<float*>(out_feats), S, N1, B, K, E_all, D, vec);
  return static_cast<int>(cudaGetLastError());
}
