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

#include <cuda_runtime.h>

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
