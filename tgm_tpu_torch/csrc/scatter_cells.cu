// K2 and K3: in-place int32 scatters of the serving path's state writes.
//
// K2 replaces the Pallas TPU kernel scatter_cells
// (tgm_tpu/ops/pallas/scatter_cells.py, body _kernel): in place on an
// (N1, B) int32 ring buffer, buf[rows[i], cols[i]] = vals[i], skipping
// targets with rows > N1 - 2 (the dump row and beyond). The recency push
// plan writes each live (row, col) at most once, so writes never race.
//
// K3 replaces the Pallas TPU kernel tgn_store_scatter_1d (same file, body
// _store1d_kernel): one launch does x[rows] = vals on the four 1-D int32
// TGN message stores, s_other/s_t at rows_s and d_other/d_t at rows_d,
// skipping rows > last_live_row. The LastAggregator plan keeps one winner
// per live row, so writes never race either.
//
// What bounds them on an H100: launch latency. At the serving shapes (K2:
// E = 400 cells into a (9228, 10) buffer; K3: E = 200 rows per role into
// four (9228,) stores) each moves a few kilobytes, well under a microsecond
// at the H100 SXM's published 3.35 TB/s (700 W power limit), while a launch
// costs microseconds.
//
// Design: one thread per write. The TPU kernels round-trip the whole buffer
// through VMEM because Mosaic has no scalar store; here each thread stores
// its own cells and the rest of the buffer is never touched. Negative or
// out-of-range targets are skipped too, so no index can leave the buffer.
//
// recency_push: the whole ring-buffer push of a batch of events, planned and
// written on the card. On the TPU the push is XLA's dense plan
// (tgm_tpu/hooks/neighbors.py, _push_plan_dense, an (E2, E2)
// compare-and-sum) followed by one scatter_cells call per int32 plane; K2
// alone took that tail, and the ~30 plan ops, the write_pos update and the
// feature-plane scatter stayed in PyTorch, each a launch of its own. Here two
// launches do everything, in place, for both state layouts (int32 edge-id
// payload or (N1, B, D) fp32 features):
//
//   1. plan_write: one warp per event e of the E2 = E (directed) or 2E
//      (undirected: event E + i is (dst, src) of edge i) events. The CTA
//      stages (node, time) of the events through shared memory in tiles; the
//      warp's lanes compare e against them and two warp reductions give
//        r       = same-node events strictly later in (time, position) order,
//        earlier = same-node events not later, e excluded,
//      the formulas of _push_plan_dense integer for integer. Invalid events
//      go to node N1 - 1. A kept (r < B), live (node < N1 - 1) event writes
//      its neighbour, time and payload into column
//      (wp_old + kept_offset) mod B; a feature row is copied by the warp,
//      float4 per lane when D % 4 == 0 and the rows are 16-byte aligned. Each
//      node's final event (r == 0) stashes its row and new position
//      wp_old + min(cnt, B) in scratch.
//   2. store_wp: one thread per event stores the stashed positions.
//
// Every write_pos this push reads is read in launch 1 and every write_pos
// it writes is written in launch 2, so stream order, not scheduling,
// separates them. The plan gives each live cell and each write_pos row one
// writer (kept events of a node have distinct offsets; a node has one final
// event), so there are no atomics and the result is deterministic. Rows
// N1 - 1 and beyond are never written: the dump row needs no reset.
//
// What bounds it on an H100: launches. At the TGN serving shape (200
// undirected events, E2 = 400) the plan is 160,000 compares and the writes
// a few kilobytes; the DyGFormer push adds 400 feature rows of 688 bytes,
// 0.28 MB. Both are far under a microsecond of the card's published rates.
//
// tgn_store_commit: the whole TGN LastAggregator message store of a batch
// (tgm_tpu/nn/encoder/tgn.py, tgn_store_messages), planned and written on
// the card in one launch. On the TPU the winners are planned by XLA (two
// segment_max per role) and K3 writes only the four int32 stores; the fp32
// raw rows and the valid flags stay XLA scatters. Here one warp per (event,
// role), 2E warps: the CTA stages (owner, time) of the role's events through
// shared memory in tiles, as the push does, and the warp's lanes test
// whether any event of the same owner beats it: a later time, or the same
// time at an earlier batch position (the JAX plan's max time, then earliest
// position, integer for integer). A warp whose event is beaten stops
// comparing after the tile that showed it. The winner of each live owner
// writes `other` (dst for the src role, src for the dst role), `t`, the valid
// flag and its raw row, copied float4 per lane when R % 4 == 0 and the rows
// are 16-byte aligned. Invalid events, owners outside [0, N1 - 2] and times
// below -1 (the JAX plan's segment_max floor) never win. The plan reads
// only the batch and each live (row, role) has one writer, so one launch
// has no race, no atomics and a deterministic result; the dump row and rows
// without a winner are never written.
//
// What bounds it on an H100: the launch. At the TGN serving shape (E =
// 200, R = 172) it reads 2.6 KB of ids, times and flags plus the winners'
// raw rows and writes at most 400 store rows of 697 bytes, 0.3 MB: about
// 0.1 µs at 3.35 TB/s. The plan is 2E * E = 80,000 compares. At large E the
// plan's pair tests, one shared-memory load each, take over (1.3e8 at E =
// 8,192); CTAs of the push's 8 warps keep the serving shape's launch small.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void scatter_cells_kernel(int* __restrict__ buf,
                                     const int* __restrict__ rows,
                                     const int* __restrict__ cols,
                                     const int* __restrict__ vals, int E,
                                     int N1, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const int r = rows[i];
  const int c = cols[i];
  if (r < 0 || r > N1 - 2 || c < 0 || c >= B) return;
  buf[static_cast<long>(r) * B + c] = vals[i];
}

__global__ void store_scatter_1d_kernel(
    int* __restrict__ s_other, int* __restrict__ s_t,
    int* __restrict__ d_other, int* __restrict__ d_t,
    const int* __restrict__ rows_s, const int* __restrict__ vals_s_other,
    const int* __restrict__ vals_s_t, const int* __restrict__ rows_d,
    const int* __restrict__ vals_d_other, const int* __restrict__ vals_d_t,
    int E, int last_live_row) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const int rs = rows_s[i];
  if (rs >= 0 && rs <= last_live_row) {
    s_other[rs] = vals_s_other[i];
    s_t[rs] = vals_s_t[i];
  }
  const int rd = rows_d[i];
  if (rd >= 0 && rd <= last_live_row) {
    d_other[rd] = vals_d_other[i];
    d_t[rd] = vals_d_t[i];
  }
}

constexpr int kThreads = 256;
constexpr int kPushWarps = 8;    // events (one a warp) per CTA of plan_write and store_commit
constexpr int kPushTile = 1024;  // events staged in shared memory per pass

// The E2 events of a push: event j < E is (src[j], dst[j]); for an
// undirected push event E + i is (dst[i], src[i]) with edge i's time and
// payload. Invalid events belong to node `dump`.
struct PushEvents {
  const int* src;
  const int* dst;
  const int* time;
  const bool* valid;  // null: every event is valid
  int E;
  int dump;

  __device__ int edge(int j) const { return j < E ? j : j - E; }
  __device__ int node(int j) const {
    const int i = edge(j);
    if (valid != nullptr && !valid[i]) return dump;
    return j < E ? src[i] : dst[i];
  }
  __device__ int nbr(int j) const { return j < E ? dst[edge(j)] : src[edge(j)]; }
};

template <bool kFeats>
__global__ void __launch_bounds__(kPushWarps * 32) recency_push_plan_write_kernel(
    int* __restrict__ ids, int* __restrict__ times, int* __restrict__ buf_eids,
    float* __restrict__ buf_feats, const int* __restrict__ write_pos, PushEvents ev,
    const int* __restrict__ pay_eids, const float* __restrict__ pay_feats,
    int* __restrict__ stash, int E2, int N1, int B, int D, bool vec) {
  __shared__ int2 tile[kPushTile];  // (node, time) of events [base, base + kPushTile)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int e = blockIdx.x * kPushWarps + warp;
  const bool active = e < E2;  // warp-uniform; idle warps still stage tiles
  const int node = active ? ev.node(e) : 0;
  const int t = active ? ev.time[ev.edge(e)] : 0;

  int r = 0;   // same-node events later than e
  int le = 0;  // same-node events not later than e, e included
  for (int base = 0; base < E2; base += kPushTile) {
    const int n = min(kPushTile, E2 - base);
    __syncthreads();  // every warp is done with the previous tile
    for (int jj = threadIdx.x; jj < n; jj += blockDim.x) {
      const int j = base + jj;
      tile[jj] = make_int2(ev.node(j), ev.time[ev.edge(j)]);
    }
    __syncthreads();
    if (active) {
      for (int jj = lane; jj < n; jj += 32) {
        const int2 o = tile[jj];
        if (o.x == node) {
          const bool later = o.y > t || (o.y == t && base + jj > e);
          r += later;
          le += !later;
        }
      }
    }
  }
  if (!active) return;
  r = __reduce_add_sync(0xffffffffu, r);
  le = __reduce_add_sync(0xffffffffu, le);
  const int earlier = le - 1;
  const int cnt = le + r;
  const bool live = node >= 0 && node < N1 - 1;
  const int wp = live ? write_pos[node] : 0;
  if (lane == 0) {
    stash[2 * e] = (r == 0 && live) ? node : -1;
    // Unsigned, so a position past 2^31 wraps as PyTorch's int32 cast does.
    stash[2 * e + 1] = static_cast<int>(static_cast<unsigned>(wp) + min(cnt, B));
  }
  if (!live || r >= B) return;
  const int kept_offset = max(earlier - max(cnt - B, 0), 0);
  long long col = (static_cast<long long>(wp) + kept_offset) % B;
  if (col < 0) col += B;  // floor modulo, as torch.remainder
  const long long cell = static_cast<long long>(node) * B + col;
  const int i = ev.edge(e);
  if (lane == 0) ids[cell] = ev.nbr(e);
  if (lane == 1) times[cell] = t;
  if constexpr (!kFeats) {
    if (lane == 2) buf_eids[cell] = pay_eids[i];
  } else {
    float* out = buf_feats + cell * D;
    const float* in = pay_feats + static_cast<long long>(i) * D;
    if (vec) {
      for (int q = lane; q < D / 4; q += 32)
        reinterpret_cast<float4*>(out)[q] = reinterpret_cast<const float4*>(in)[q];
    } else {
      for (int q = lane; q < D; q += 32) out[q] = in[q];
    }
  }
}

__global__ void recency_push_store_wp_kernel(int* __restrict__ write_pos,
                                             const int* __restrict__ stash, int E2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E2) return;
  const int row = stash[2 * e];
  if (row >= 0) write_pos[row] = stash[2 * e + 1];
}

// One role's message store: (N1,) int32 other and t, (N1, R) fp32 raw rows,
// (N1,) bool valid.
struct StoreRole {
  int* other;
  int* t;
  float* raw;
  bool* valid;
};

// Grid (ceil(E / kPushWarps), 2): blockIdx.y is the role, 0 for the src-role
// store and 1 for the dst-role store. In PushEvents numbering the role's
// event i is role * E + i, so node() is its owner and nbr() its `other`.
__global__ void __launch_bounds__(kPushWarps * 32) tgn_store_commit_kernel(
    StoreRole src_store, StoreRole dst_store, PushEvents ev,
    const float* __restrict__ raw_msg, int R, bool vec) {
  __shared__ int2 tile[kPushTile];  // (owner, time) of the role's events [base, base + kPushTile)
  const int role = blockIdx.y;
  const int E = ev.E;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kPushWarps + warp;
  const int e = role * E + i;
  const int owner = i < E ? ev.node(e) : ev.dump;  // invalid events own the dump row
  const int t = i < E ? ev.time[i] : 0;
  // Warp-uniform; idle warps still stage tiles. ev.dump is N1 - 1.
  const bool live = owner >= 0 && owner < ev.dump && t >= -1;

  bool beaten = false;  // warp-uniform: some event of this owner wins over i
  for (int base = 0; base < E; base += kPushTile) {
    const int n = min(kPushTile, E - base);
    __syncthreads();  // every warp is done with the previous tile
    for (int jj = threadIdx.x; jj < n; jj += blockDim.x) {
      const int j = base + jj;
      tile[jj] = make_int2(ev.node(role * E + j), ev.time[j]);
    }
    __syncthreads();
    if (live && !beaten) {
      bool b = false;
      for (int jj = lane; jj < n; jj += 32) {
        const int2 o = tile[jj];
        b |= o.x == owner && (o.y > t || (o.y == t && base + jj < i));
      }
      beaten = __any_sync(0xffffffffu, b);
    }
  }
  if (!live || beaten) return;
  const StoreRole s = role ? dst_store : src_store;
  if (lane == 0) s.other[owner] = ev.nbr(e);
  if (lane == 1) s.t[owner] = t;
  if (lane == 2) s.valid[owner] = true;
  float* out = s.raw + static_cast<long long>(owner) * R;
  const float* in = raw_msg + static_cast<long long>(i) * R;
  if (vec) {
    for (int q = lane; q < R / 4; q += 32)
      reinterpret_cast<float4*>(out)[q] = reinterpret_cast<const float4*>(in)[q];
  } else {
    for (int q = lane; q < R; q += 32) out[q] = in[q];
  }
}

}  // namespace

extern "C" int scatter_cells(void* buf, const void* rows, const void* cols,
                             const void* vals, int E, int N1, int B,
                             void* stream) {
  const int blocks = (E + kThreads - 1) / kThreads;
  scatter_cells_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(buf), static_cast<const int*>(rows),
      static_cast<const int*>(cols), static_cast<const int*>(vals), E, N1, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tgn_store_scatter_1d(void* s_other, void* s_t, void* d_other,
                                    void* d_t, const void* rows_s,
                                    const void* vals_s_other,
                                    const void* vals_s_t, const void* rows_d,
                                    const void* vals_d_other,
                                    const void* vals_d_t, int E,
                                    int last_live_row, void* stream) {
  const int blocks = (E + kThreads - 1) / kThreads;
  store_scatter_1d_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(s_other), static_cast<int*>(s_t),
      static_cast<int*>(d_other), static_cast<int*>(d_t),
      static_cast<const int*>(rows_s), static_cast<const int*>(vals_s_other),
      static_cast<const int*>(vals_s_t), static_cast<const int*>(rows_d),
      static_cast<const int*>(vals_d_other),
      static_cast<const int*>(vals_d_t), E, last_live_row);
  return static_cast<int>(cudaGetLastError());
}

// payload_buf and payload are int32 (feats == 0) or fp32 (feats != 0, row
// width D); valid may be null; stash is 2 * E2 ints of scratch.
extern "C" int recency_push(void* ids, void* times, void* payload_buf, void* write_pos,
                            const void* src, const void* dst, const void* time,
                            const void* valid, const void* payload, void* stash, int E,
                            int directed, int N1, int B, int feats, int D,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E2 = directed ? E : 2 * E;
  const PushEvents ev{static_cast<const int*>(src), static_cast<const int*>(dst),
                      static_cast<const int*>(time), static_cast<const bool*>(valid), E,
                      N1 - 1};
  const int blocks = (E2 + kPushWarps - 1) / kPushWarps;
  int* const ids_p = static_cast<int*>(ids);
  int* const times_p = static_cast<int*>(times);
  const int* const wp_p = static_cast<const int*>(write_pos);
  int* const stash_p = static_cast<int*>(stash);
  if (feats) {
    const bool vec = D % 4 == 0 && reinterpret_cast<std::uintptr_t>(payload_buf) % 16 == 0 &&
                     reinterpret_cast<std::uintptr_t>(payload) % 16 == 0;
    recency_push_plan_write_kernel<true><<<blocks, kPushWarps * 32, 0, s>>>(
        ids_p, times_p, nullptr, static_cast<float*>(payload_buf), wp_p, ev, nullptr,
        static_cast<const float*>(payload), stash_p, E2, N1, B, D, vec);
  } else {
    recency_push_plan_write_kernel<false><<<blocks, kPushWarps * 32, 0, s>>>(
        ids_p, times_p, static_cast<int*>(payload_buf), nullptr, wp_p, ev,
        static_cast<const int*>(payload), nullptr, stash_p, E2, N1, B, 0, false);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  recency_push_store_wp_kernel<<<(E2 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<int*>(write_pos), stash_p, E2);
  return static_cast<int>(cudaGetLastError());
}

// The eight store tensors are written in place; raw rows are R fp32 wide
// (R may be 0); valid stores and the batch's valid are bool (one byte).
extern "C" int tgn_store_commit(void* s_other, void* s_t, void* s_raw, void* s_valid,
                                void* d_other, void* d_t, void* d_raw, void* d_valid,
                                const void* src, const void* dst, const void* time,
                                const void* raw_msg, const void* valid, int E, int N1, int R,
                                void* stream) {
  const PushEvents ev{static_cast<const int*>(src), static_cast<const int*>(dst),
                      static_cast<const int*>(time), static_cast<const bool*>(valid), E,
                      N1 - 1};
  const StoreRole src_store{static_cast<int*>(s_other), static_cast<int*>(s_t),
                            static_cast<float*>(s_raw), static_cast<bool*>(s_valid)};
  const StoreRole dst_store{static_cast<int*>(d_other), static_cast<int*>(d_t),
                            static_cast<float*>(d_raw), static_cast<bool*>(d_valid)};
  const bool vec = R % 4 == 0 && reinterpret_cast<std::uintptr_t>(s_raw) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(d_raw) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(raw_msg) % 16 == 0;
  const dim3 grid((E + kPushWarps - 1) / kPushWarps, 2);
  tgn_store_commit_kernel<<<grid, kPushWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      src_store, dst_store, ev, static_cast<const float*>(raw_msg), R, vec);
  return static_cast<int>(cudaGetLastError());
}
