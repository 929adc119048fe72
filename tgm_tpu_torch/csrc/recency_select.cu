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
// - given a static (E_all, D) edge table of fp32 or bf16 values, it writes an
//   (S, K, D) output of the same type: column c holds edge_x[min(eid, E_all
//   - 1)] for the edge id eid of column c, or zeros where eid < 0, bit for
//   bit what gather_edge_feats gives. The copy moves bytes: a row is RB = D
//   x (4 or 2) bytes, copied in the widest unit of 16, 8, 4 or 2 bytes that
//   divides RB and both base addresses (fp32 D = 172: 16; bf16 D = 172 and
//   100, 344 and 200 bytes: 8; bf16 D = 173, TGAT's side-augmented rows of
//   346 bytes: 2).
//
// What bounds it on an H100: memory. At the TGN eval shape (S = 4,400 seeds,
// B = K = 10, D = 172) it writes an (S, K, D) fp32 block of 30.3 MB and
// reads up to as many bytes of selected edge rows: about 18 us at the H100
// SXM's published 3.35 TB/s (700 W power limit); half that from a bf16
// table. Without features (the Pallas entry) it moves about 1.1 MB and is
// launch-bound.
//
// Design: one warp per seed. Lane l looks at the slots of ages l and l + 32
// (B <= 64; the row is loaded by slot beside the write position and shuffled
// to the ages' lanes); a warp ballot gives the valid slots in age order,
// a popcount each slot's rank. Selected lanes write id, time and edge id to
// column K-1-rank and the edge id to a per-warp table in shared memory; the
// warp then streams the K output rows, four units (16 to 2 bytes) in flight
// per lane before their stores. wp grows without bound and CUDA's %
// truncates toward zero, so the slot index uses a floor modulo, as the JAX
// code does.
//
// K4: the same select with an fp32 feature payload, on the ring state in
// place.
//
// Replaces the Pallas TPU kernel recency_window_select
// (tgm_tpu/ops/pallas/recency_select.py:259, body _kernel at :35). Contract:
// the same (id, time) select as K1, filled with PAD / 0, plus each selected
// slot's D-float feature row copied bit for bit into the same column, the
// columns nobody writes zero-filled. The TPU kernel takes rows the caller
// gathered per seed and copies with a masked one-hot reduce per output
// column, since a matmul would round through bf16. Like K1, this kernel reads
// the feature layout's (N1, B) ids and times, (N1,) write positions and
// (N1, B, D) feature buffer in place at row seed (the dump row N1 - 1 for an
// invalid seed), or row s of pre-gathered (S, B) rows without seeds (the
// Pallas entry); only the selected slots' feature rows are read.
//
// What bounds it on an H100: memory. At the DyGFormer eval shape (S = 4,400
// seeds, B = K = 20, D = 172) it writes an (S, K, D) fp32 block of 60.5 MB
// and reads the selected feature rows, up to another 60.5 MB: about 36 us at
// the H100 SXM's published 3.35 TB/s (700 W power limit) when every slot is
// selected. At the train shape (S = 600) the same copy is 8.3 MB each way.
//
// Design: the select is K1's (rank_slots: a ballot and a popcount per
// warp, the row loaded beside the write position). The copy is what costs,
// and it needs bytes in flight:
// - Each warp writes the ring slot of each output column to a table in
//   shared memory and copies column by column from it, float4 (D % 4 == 0
//   and 16-byte aligned rows) or float per lane, with four loads in flight
//   per lane; a lane steps its (column, element) pair by constants, so no
//   element pays a / or %. The same copy serves rows in any time order
//   (fault 1 of ROADMAP).
// - The zero columns [0, K - n_sel) get plain vector stores meanwhile.
// - Parallelism: one warp per (seed, part). The launcher splits each seed's K
//   output columns into `parts` ranges until about 2,048 warps run (132 SMs
//   x 16), so S = 600 runs 2,400 warps (4 parts of 5 columns) and S = 4,400
//   one warp a seed; each part re-runs the cheap select over the 2B ints of
//   its row.
// - Bulk copies of a chronological ring's selected run (consecutive ring
//   slots) through shared memory, cp.async.bulk on an mbarrier, were tried
//   and dropped: exact, but ahead of this copy only at the largest seed
//   counts, by a few percent, for a second copy path.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kPad = -1;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxSlots = 64;
constexpr int kCopyUnroll = 4;  // loads in flight per lane in K1's and K4's column copies
constexpr int kFeatWarps = 4;   // K4: warps a block
constexpr int kTargetWarps = 2048;  // K4: split seeds' columns until about this many warps run

__device__ __forceinline__ int floor_mod(int x, int b) { return ((x % b) + b) % b; }

// The rank rule over one seed's B-slot ring row (starting at `row`), for a
// whole warp: lane l holds the slots of ages l and l + 32 (h = 0 and 1); a
// ballot gives the valid slots in age order, a popcount each one's rank.
// Lane l loads slots l and l + 32 and takes each of its ages' slots from the
// lane holding it (shuffles), so the row's loads do not wait for wp.
struct WarpSlots {
  bool valid[2];
  int slot[2], id[2], time[2], rank[2];
  int n_valid;
};

__device__ __forceinline__ WarpSlots rank_slots(const int* __restrict__ ids,
                                                const int* __restrict__ times, long long row,
                                                int wp, int qt, int B, int lane) {
  int slot_id[2], slot_time[2];  // slots lane and lane + 32 of the row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    slot_id[h] = j < B ? ids[row + j] : kPad;
    slot_time[h] = j < B ? times[row + j] : 0;
  }
  WarpSlots w;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int age = lane + 32 * h;
    w.slot[h] = age < B ? floor_mod(wp - 1 - age, B) : 0;
    const int src = w.slot[h] & 31;
    const int id_lo = __shfl_sync(0xffffffffu, slot_id[0], src);
    const int id_hi = __shfl_sync(0xffffffffu, slot_id[1], src);
    const int t_lo = __shfl_sync(0xffffffffu, slot_time[0], src);
    const int t_hi = __shfl_sync(0xffffffffu, slot_time[1], src);
    w.id[h] = w.slot[h] < 32 ? id_lo : id_hi;
    w.time[h] = w.slot[h] < 32 ? t_lo : t_hi;
    w.valid[h] = age < B && w.time[h] < qt && w.id[h] != kPad;
  }
  const unsigned lo = __ballot_sync(0xffffffffu, w.valid[0]);
  const unsigned hi = __ballot_sync(0xffffffffu, w.valid[1]);
  const unsigned below = (1u << lane) - 1u;  // lane < 32, so the shift is defined
  w.rank[0] = __popc(lo & below);
  w.rank[1] = __popc(lo) + __popc(hi & below);
  w.n_valid = __popc(lo) + __popc(hi);
  return w;
}

// Copies the (K, W) output block of one seed in units of T, W = RB /
// sizeof(T): row c is edge_x[min(eid[c], E_all - 1)], or zeros where eid[c]
// < 0.
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
    const unsigned char* __restrict__ edge_x, int* __restrict__ out_ids,
    int* __restrict__ out_times, int* __restrict__ out_eids,
    unsigned char* __restrict__ out_feats, int S, int N1, int B, int K, int E_all,
    int RB, int unit) {
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
  unsigned char* dst = out_feats + out * RB;
  const int* sel = sel_eid[warp];
  switch (unit) {  // warp-uniform
    case 16:
      copy_edge_rows(reinterpret_cast<const uint4*>(edge_x), reinterpret_cast<uint4*>(dst), sel,
                     K, RB / 16, E_all, lane);
      break;
    case 8:
      copy_edge_rows(reinterpret_cast<const uint2*>(edge_x), reinterpret_cast<uint2*>(dst), sel,
                     K, RB / 8, E_all, lane);
      break;
    case 4:
      copy_edge_rows(reinterpret_cast<const unsigned*>(edge_x), reinterpret_cast<unsigned*>(dst),
                     sel, K, RB / 4, E_all, lane);
      break;
    default:
      copy_edge_rows(reinterpret_cast<const unsigned short*>(edge_x),
                     reinterpret_cast<unsigned short*>(dst), sel, K, RB / 2, E_all, lane);
  }
}

// The widest of 16, 8, 4 and 2 bytes that divides the row's bytes and both
// base addresses.
int copy_unit(int RB, const void* a, const void* b) {
  const std::uintptr_t m = static_cast<std::uintptr_t>(RB) |
                           reinterpret_cast<std::uintptr_t>(a) |
                           reinterpret_cast<std::uintptr_t>(b);
  int u = 16;
  while (u > 2 && m % u != 0) u /= 2;
  return u;
}

template <typename T>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, int n, int lane) {
  for (int i = lane; i < n; i += 32) out[i] = T{};
}

// Output rows [c_lo, c_hi) of one seed's (K, W) block from rows slot[c] of
// its node's (B, W) block, W = D (T = float) or D / 4 (T = float4). A lane
// steps its (row, element) pair by 32 elements with constants: one / and %
// a lane, none an element.
template <typename T>
__device__ __forceinline__ void copy_slot_rows(const T* __restrict__ src, T* __restrict__ out,
                                               const int* slot, int c_lo, int c_hi, int W,
                                               int lane) {
  const int total = (c_hi - c_lo) * W;
  const int dc = 32 / W, dq = 32 % W;
  int c = c_lo + lane / W, q = lane % W;
  for (int i0 = lane; i0 < total; i0 += 32 * kCopyUnroll) {
    T v[kCopyUnroll];
    int at[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      at[u] = -1;
      if (i0 + 32 * u < total) {
        v[u] = src[slot[c] * W + q];
        at[u] = c * W + q;
      }
      c += dc;
      q += dq;
      if (q >= W) {
        q -= W;
        ++c;
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u)
      if (at[u] >= 0) out[at[u]] = v[u];
  }
}

// One warp per (seed, part): part p of `parts` owns output columns
// [p K / parts, (p + 1) K / parts).
__global__ void recency_feats_kernel(
    const int* __restrict__ ids, const int* __restrict__ times, const float* __restrict__ feats,
    const int* __restrict__ write_pos, const int* __restrict__ seeds,
    const int* __restrict__ query_times, int* __restrict__ out_ids, int* __restrict__ out_times,
    float* __restrict__ out_feats, int S, int N1, int B, int K, int D, int parts, bool vec) {
  __shared__ int src_slot[kFeatWarps][kMaxSlots];  // ring slot of each output column
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long task = static_cast<long long>(blockIdx.x) * kFeatWarps + warp;
  if (task >= static_cast<long long>(S) * parts) return;  // warp-uniform
  const int s = static_cast<int>(task / parts);
  const int part = static_cast<int>(task % parts);
  int node = s;
  if (seeds != nullptr) {
    const int seed = seeds[s];
    node = (seed >= 0 && seed < N1 - 1) ? seed : N1 - 1;  // invalid seeds read the dump row
  }
  const long long row = static_cast<long long>(node) * B;
  const long long out = static_cast<long long>(s) * K;
  const int wp = write_pos[node];
  const WarpSlots w = rank_slots(ids, times, row, wp, query_times[s], B, lane);
  const int n_sel = min(w.n_valid, K);
  const int n_fill = K - n_sel;  // columns [0, n_fill) stay empty
  const int c0 = static_cast<int>(static_cast<long long>(part) * K / parts);
  const int c1 = static_cast<int>(static_cast<long long>(part + 1) * K / parts);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (w.valid[h] && w.rank[h] < K) {
      const int c = K - 1 - w.rank[h];
      src_slot[warp][c] = w.slot[h];
      if (c >= c0 && c < c1) {
        out_ids[out + c] = w.id[h];
        out_times[out + c] = w.time[h];
      }
    }
  }
  const int f1 = min(max(n_fill, c0), c1);  // this warp zero-fills [c0, f1), copies [f1, c1)
  for (int c = c0 + lane; c < f1; c += 32) {
    out_ids[out + c] = kPad;
    out_times[out + c] = 0;
  }
  if (D == 0) return;
  __syncwarp();
  const float* in_block = feats + row * D;  // the node's (B, D) rows
  float* out_block = out_feats + out * D;   // the seed's (K, D) rows
  if (vec) {
    const int W = D / 4;
    zero_rows(reinterpret_cast<float4*>(out_block) + static_cast<long long>(c0) * W,
              (f1 - c0) * W, lane);
    copy_slot_rows(reinterpret_cast<const float4*>(in_block), reinterpret_cast<float4*>(out_block),
                   src_slot[warp], f1, c1, W, lane);
  } else {
    zero_rows(out_block + static_cast<long long>(c0) * D, (f1 - c0) * D, lane);
    copy_slot_rows(in_block, out_block, src_slot[warp], f1, c1, D, lane);
  }
}

}  // namespace

// seeds null: the state is S pre-gathered rows, row s for seed s (the
// Pallas entry).
extern "C" int recency_feats_select(
    const void* ids, const void* times, const void* feats, const void* write_pos,
    const void* seeds, const void* query_times, void* out_ids, void* out_times, void* out_feats,
    int S, int N1, int B, int K, int D, void* stream) {
  if (B > kMaxSlots || K > B || K < 1 || S < 1 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (D % 4 == 0) && (reinterpret_cast<std::uintptr_t>(feats) % 16 == 0) &&
                   (reinterpret_cast<std::uintptr_t>(out_feats) % 16 == 0);
  // Split each seed's columns until about kTargetWarps warps run; no split
  // without features.
  const int parts = D == 0 ? 1 : std::max(1, std::min(K, (kTargetWarps + S - 1) / S));
  const long long tasks = static_cast<long long>(S) * parts;
  const long long blocks = (tasks + kFeatWarps - 1) / kFeatWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  recency_feats_kernel<<<static_cast<unsigned>(blocks), kFeatWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const int*>(times),
      static_cast<const float*>(feats), static_cast<const int*>(write_pos),
      static_cast<const int*>(seeds), static_cast<const int*>(query_times),
      static_cast<int*>(out_ids), static_cast<int*>(out_times), static_cast<float*>(out_feats),
      S, N1, B, K, D, parts, vec);
  return static_cast<int>(cudaGetLastError());
}

// seeds null: the state is S pre-gathered rows, row s for seed s. edge_x and
// out_feats both null: no features. RB: the bytes of one table row (D values
// of 4 or 2 bytes), even.
extern "C" int recency_eid_select(
    const void* ids, const void* times, const void* eids,
    const void* write_pos, const void* seeds, const void* query_times,
    const void* edge_x, void* out_ids, void* out_times, void* out_eids,
    void* out_feats, int S, int N1, int B, int K, int E_all, int RB,
    void* stream) {
  if (B > kMaxSlots || K > B || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((edge_x == nullptr) != (out_feats == nullptr) || (edge_x != nullptr && E_all < 1) ||
      RB < 0 || RB % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int unit = copy_unit(RB, edge_x, out_feats);
  const int blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  recency_select_eid_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const int*>(times),
      static_cast<const int*>(eids), static_cast<const int*>(write_pos),
      static_cast<const int*>(seeds), static_cast<const int*>(query_times),
      static_cast<const unsigned char*>(edge_x), static_cast<int*>(out_ids),
      static_cast<int*>(out_times), static_cast<int*>(out_eids),
      static_cast<unsigned char*>(out_feats), S, N1, B, K, E_all, RB, unit);
  return static_cast<int>(cudaGetLastError());
}
