// K5: DyGFormer transformer-stack forward (eval), as a token-tiled pipeline.
//
// Replaces the Pallas TPU kernel transformer_stack_fwd
// (tgm_tpu/ops/pallas/dyg_transformer.py, body _kernel). For each of R
// sequences of S rows and width D, num_layers times:
//   hn = bf16(LN1(h));  qkv = bf16(hn @ Wqkv + bqkv)          (fp32 accumulate)
//   per head: logits = q @ k^T * scale;  a = bf16(softmax(logits));  o_head = a @ v
//   h += bf16(concat(o_head)) @ Wo + bo
//   hn = bf16(LN2(h));  g = bf16(gelu(hn @ W1 + b1));  h += g @ W2 + b2
// with bf16 matmul operands, fp32 accumulation, fp32 LayerNorm (biased
// variance, eps 1e-5) and fp32 softmax, rounding to bf16 at exactly the
// places the Pallas kernel does. Exact gelu uses erff (the TPU kernel's
// Abramowitz-Stegun polynomial only worked around Mosaic's missing erf).
//
// What bounds it on an H100. At the DyGFormer eval shape (R = 4,200
// sequences of (64, 200), 2 layers, 2 heads, FFN 800) the products are
// about 544 GFLOP: 0.55 ms at the H100 SXM's published 989 TFLOP/s of bf16
// (700 W limit). This design keeps the residual stream h and three
// intermediates in device memory between its kernels (qkv, the head concat
// o and the gelu output U, each stored in the bf16 the stack rounds it to),
// about 6.2 GB of traffic a call at that shape: about 1.9 ms at 3.35 TB/s.
// So this design is bound by memory, not by the tensor cores.
//
// Design. The four linear products are GEMMs over all T = R * S tokens
// against weights that every token shares; only attention is per
// sequence. Each layer launches, on the caller's stream:
//   1. ln_gemm   LN1 -> Wqkv, bias, bf16 store into qkv (T, QKVW);
//   2. attention one CTA per (sequence, head) -> o (T, AW), bf16;
//   3. gemm      h += o @ Wo + bo (fp32 residual, in place; layer 0 reads
//                the stack's input x for LN1 and this residual and writes h,
//                so h needs no copy of x);
//   4. ln_gemm   LN2 -> W1, bias, gelu, bf16 store into U (T, F);
//   5. gemm      h += U @ W2 + b2.
// One GEMM mainloop serves 1, 3, 4 and 5: 128-row tiles (two sequences),
// 8 warps as 4 x 2, each warp 32 rows by BN / 2 columns with its fp32
// accumulators in registers; bf16 mma.sync m16n8k16 fed by ldmatrix from
// shared memory; weight K-slices of 32 rows staged by cp.async through a
// 4-stage ring. Weight reuse: a weight tile in shared memory serves 128
// token rows (the old kernel's fragments served 64 and came from L2 each
// time). ln_gemm computes bf16(LN(h)) of its 128 rows into shared memory
// once and walks every column tile of the weight over it, so the LN runs
// once per row; gemm stages its A tiles through the same ring. Shared
// memory stays at or under 100 KB a CTA and registers at 128 a thread (2
// CTAs, 16 warps an SM); the attention kernel holds one head's q, k and v
// (about 46 KB at S = 64, dh 100 padded to 112), so 4 CTAs share an SM.
// Epilogues work on the accumulator registers directly: bias, gelu and the
// residual add happen in fp32, and the rows past T (the ragged last tile)
// are masked. No atomics: each CTA owns its output tile, so the result is
// the same from run to run. What this leaves on the table: within an SM the
// LN prologue, the MMA mainloop and the epilogue of a CTA run one after
// another, and its two CTAs tend to run the same phase at once, so the
// phases hardly overlap; a warp-specialised wgmma + TMA mainloop is the
// next step, inside the same templates.
//
// D = 200 and dh = 100 are not multiples of 16: the wrapper pads the weights
// with zeros (D -> DP, each head dh -> DHP, the FFN width to a multiple of
// 16), and cp.async fills K and N tiles past the padded extents with zeros,
// so the padding changes no sum. Shared-memory rows are padded by 16 bytes
// against bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 16;
constexpr int kMaxSharedBytes = 232448;  // an H100 block's opt-in maximum
constexpr float kLnEps = 1e-5f;
constexpr int kPad = 8;  // bf16 elements (16 bytes) of padding per shared row

// GEMM tiling: BM rows, BK-deep weight slices, kStages-deep cp.async ring.
constexpr int kBM = 128;
constexpr int kBK = 32;
constexpr int kStages = 4;
constexpr int kGemmThreads = 256;  // 8 warps, 4 along rows x 2 along columns
constexpr int kAttnThreads = 128;  // 4 warps, one 16-row query tile each

// Column tiles, in 8-column MMA tiles per warp: BN = 16 * NT8.
constexpr int kQkvNT8 = 7;   // BN 112: QKVW = 672 is six tiles
constexpr int kFfnNT8 = 10;  // BN 160: F = 800 is five tiles
constexpr int kResNT8 = 7;   // BN 112: the width 208 of Wo and W2 is two tiles
constexpr int kLayerStages = 5;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Dimensions and packed-parameter offsets of one call.
struct Dims {
  int S, D, H, F, dh;
  int DP, DHP, QKVW, AW;      // padded widths: D, one head, fused QKV, head concat
  long w_qkv, w_o, w_1, w_layer;  // bf16 weights of a layer: Wqkv | Wo | W1 | W2
  long p_layer;                   // fp32 params: ln1 s,b | bqkv | bo | ln2 s,b | b1 | b2
  float scale;
};

Dims make_dims(int S, int D, int H, int F) {
  Dims L;
  L.S = S; L.D = D; L.H = H; L.F = F; L.dh = D / H;
  L.DP = round_up(D, kTile);
  L.DHP = round_up(L.dh, kTile);
  L.QKVW = 3 * H * L.DHP;
  L.AW = H * L.DHP;
  L.w_qkv = static_cast<long>(L.DP) * L.QKVW;
  L.w_o = static_cast<long>(L.AW) * L.DP;
  L.w_1 = static_cast<long>(L.DP) * F;
  L.w_layer = L.w_qkv + L.w_o + 2 * L.w_1;
  L.p_layer = 6L * L.DP + L.QKVW + F;
  L.scale = 1.0f / sqrtf(static_cast<float>(L.dh));
  return L;
}

int ln_gemm_smem(int nt8, int K) {
  return 2 * (kBM * (round_up(K, kBK) + kPad) + kStages * kBK * (16 * nt8 + kPad));
}
int gemm_smem(int nt8) { return 2 * kStages * (kBM * (kBK + kPad) + kBK * (16 * nt8 + kPad)); }
int attention_smem(int S, int DHP) { return 2 * 3 * S * (DHP + kPad); }

// ---- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with pred false it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) @ b (16x8 bf16, col).
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- epilogues ------------------------------------------------------------------
//
// An epilogue takes one 16-row block of a warp's accumulators: with g =
// lane / 4 and t = lane % 4, the thread's sums a[j][0..1] belong to row r0 +
// g, columns col0 + 8 j + 2 t and + 1, and a[j][2..3] to row r0 + g + 8 (the
// mma.sync m16n8 accumulator layout); rows from T on are not stored.

// The bias of a thread's columns c0 + 8 j + {0, 1} below n, loaded before the
// epilogue's first store: a load after a store that might alias it would
// wait for the store.
template <int NT8>
__device__ __forceinline__ void load_bias(float (&b)[NT8][2], const float* bias, int c0, int n) {
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    const int c = c0 + 8 * j;
    b[j][0] = c < n ? bias[c] : 0.f;
    b[j][1] = c + 1 < n ? bias[c + 1] : 0.f;
  }
}

// Stores a row's bf16 pairs p[j] (columns col0 + 8 j + 2 t, + 1, as the
// accumulator layout spreads them over a quad of lanes) as 16-byte chunks:
// the quad transposes so that lane t writes the 8 columns of chunk 4 q + t.
// Every lane of the warp takes part in the shuffles; store says whether this
// lane's row is written.
template <int NT8>
__device__ __forceinline__ void store_row_bf16(bf16* row, int col0, int ld, const unsigned (&p)[NT8],
                                               bool store, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int q = 0; q < (NT8 + 3) / 4; ++q) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int to = (t - k) & 3;  // the lane of the quad that this value goes to
      unsigned v = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (4 * q + jj < NT8 && jj == to) v = p[4 * q + jj];
      }
      const unsigned got = k == 0 ? v : __shfl_sync(0xffffffffu, v, (lane & ~3) | ((t + k) & 3));
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s == ((t + k) & 3)) w[s] = got;
      }
    }
    const int c = col0 + 8 * (4 * q + t);
    if (store && 4 * q + t < NT8 && c < ld) {
      *reinterpret_cast<uint4*>(row + c) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// out[r, c] = bf16(acc + bias[c]), optionally through the exact gelu. The
// plain store (bias only) is bound by its stores and writes 16-byte chunks;
// the gelu store is bound by its erff arithmetic, where the transposing
// shuffles cost more than the wider stores save, and writes each lane's
// pairs as they lie.
template <bool kGelu>
struct StoreBf16 {
  bf16* out;
  int ld;  // columns of out (a multiple of 8); columns past it are not stored
  const float* bias;
  template <int NT8>
  __device__ __forceinline__ void operator()(long r0, long T, int col0, int lane,
                                             const float (&a)[NT8][4]) const {
    const int c0 = col0 + 2 * (lane & 3);
    float b[NT8][2];
    load_bias(b, bias, c0, ld);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long r = r0 + (lane >> 2) + 8 * half;
      if constexpr (kGelu) {
#pragma unroll
        for (int j = 0; j < NT8; ++j) {
          const int c = c0 + 8 * j;
          if (r >= T || c >= ld) continue;
          const float u0 = a[j][2 * half] + b[j][0];
          const float u1 = a[j][2 * half + 1] + b[j][1];
          *reinterpret_cast<unsigned*>(out + r * ld + c) =
              pack_bf16(0.5f * u0 * (1.0f + erff(u0 * 0.70710678118654752f)),
                        0.5f * u1 * (1.0f + erff(u1 * 0.70710678118654752f)));
        }
      } else {
        unsigned p[NT8];
#pragma unroll
        for (int j = 0; j < NT8; ++j) {
          p[j] = pack_bf16(a[j][2 * half] + b[j][0], a[j][2 * half + 1] + b[j][1]);
        }
        store_row_bf16<NT8>(out + (r < T ? r : 0) * ld, col0, ld, p, r < T, lane);
      }
    }
  }
};

// h[r, c] = res[r, c] + acc + bias[c] over the D real columns of the fp32
// residual stream; res is h itself (in place) except in layer 0's Wo, where
// it is the stack's input. All of the block's old values are loaded before
// the first store, so their reads overlap.
struct AddResidual {
  const float* res;
  float* h;
  int D;
  const float* bias;
  template <int NT8>
  __device__ __forceinline__ void operator()(long r0, long T, int col0, int lane,
                                             const float (&a)[NT8][4]) const {
    r0 += lane >> 2;
    const int c0 = col0 + 2 * (lane & 3);
    float b[NT8][2];
    load_bias(b, bias, c0, D);
    float old[2][NT8][2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long r = r0 + 8 * half;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int c = c0 + 8 * j;
        const float* p = res + r * D + c;
        old[half][j][0] = old[half][j][1] = 0.f;
        if (r >= T || c >= D) continue;
        if ((D & 1) == 0) {
          const float2 v = *reinterpret_cast<const float2*>(p);
          old[half][j][0] = v.x;
          old[half][j][1] = v.y;
        } else {
          old[half][j][0] = p[0];
          if (c + 1 < D) old[half][j][1] = p[1];
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long r = r0 + 8 * half;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int c = c0 + 8 * j;
        if (r >= T || c >= D) continue;
        float* p = h + r * D + c;
        const float y0 = old[half][j][0] + (a[j][2 * half] + b[j][0]);
        const float y1 = old[half][j][1] + (a[j][2 * half + 1] + b[j][1]);
        if ((D & 1) == 0) {
          *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
        } else {
          p[0] = y0;
          if (c + 1 < D) p[1] = y1;
        }
      }
    }
  }
};

// ---- the GEMM mainloop --------------------------------------------------------

// One BK-deep slice of a warp's 32 x 8*NT8 tile: As holds the warp's 32 rows
// (row-major, k contiguous), Bs the slice's BK rows of the warp's columns.
template <int NT8>
__device__ __forceinline__ void warp_mma_slice(float (&acc)[2][NT8][4], const bf16* As, int lda,
                                               const bf16* Bs, int ldb, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    unsigned a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      ldsm_x4(a[mi], As + (mi * 16 + (lane & 15)) * lda + kk + (lane >> 4) * 8);
    }
    const bf16* brow = Bs + (kk + (lane & 15)) * ldb + (lane >> 4) * 8;
#pragma unroll
    for (int p = 0; p < NT8 / 2; ++p) {
      unsigned b[4];
      ldsm_x4_t(b, brow + p * 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma16816(acc[mi][2 * p], a[mi], b[0], b[1]);
        mma16816(acc[mi][2 * p + 1], a[mi], b[2], b[3]);
      }
    }
    if constexpr (NT8 % 2 == 1) {
      unsigned b[2];
      ldsm_x2_t(b, Bs + (kk + (lane & 15)) * ldb + (NT8 - 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma16816(acc[mi][NT8 - 1], a[mi], b[0], b[1]);
    }
  }
}

// Hands a warp's finished tile to the epilogue and clears it. row0, col0:
// the warp's first output row and column.
template <int NT8, class Epi>
__device__ __forceinline__ void warp_epilogue(float (&acc)[2][NT8][4], long row0, int col0,
                                              long T, int lane, const Epi& epi) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    epi(row0 + mi * 16, T, col0, lane, acc[mi]);
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    }
  }
}

// Stage the BK x BN weight slice (k-slice kt, column tile nt) of W (K x N,
// row-major bf16, N a multiple of 8); past K or N it is zero-filled.
template <int NT8>
__device__ __forceinline__ void load_b_slice(bf16* dst, const bf16* __restrict__ W, int K, int N,
                                             int kt, int nt) {
  constexpr int kChunks = 2 * NT8;  // 16-byte chunks per slice row
  constexpr int ldb = 16 * NT8 + kPad;
  for (int c = threadIdx.x; c < kBK * kChunks; c += kGemmThreads) {
    const int r = c / kChunks, cc = (c % kChunks) * 8;
    const int k = kt * kBK + r, n = nt * 16 * NT8 + cc;
    const bool ok = k < K && n < N;
    cp_async16(dst + r * ldb + cc, ok ? W + static_cast<long>(k) * N + n : W, ok);
  }
}

constexpr int kLnRows = 4;     // rows a warp normalises at once
constexpr int kLnPerLane = 8;  // values of a row a lane holds: D <= 256 in registers

// bf16(LN(x)) of kLnRows consecutive rows of h (T x D fp32) from row0 into
// shared rows a (stride lda, KA columns, zero past D); rows past T are zero.
// The loads of all kLnRows rows are issued before the first reduction.
__device__ __forceinline__ void layer_norm_rows(const float* __restrict__ h, long T, int D,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta, long row0,
                                                bf16* a, int lda, int KA, int lane) {
  if (D <= 32 * kLnPerLane) {
    float g[kLnPerLane], b[kLnPerLane];  // the lane's columns are the same in every row
#pragma unroll
    for (int e = 0; e < kLnPerLane; ++e) {
      const int c = lane + 32 * e;
      g[e] = c < D ? gamma[c] : 0.f;
      b[e] = c < D ? beta[c] : 0.f;
    }
    float v[kLnRows][kLnPerLane];
#pragma unroll
    for (int i = 0; i < kLnRows; ++i) {
#pragma unroll
      for (int e = 0; e < kLnPerLane; ++e) {
        const int c = lane + 32 * e;
        v[i][e] = row0 + i < T && c < D ? h[(row0 + i) * D + c] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kLnRows; ++i) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kLnPerLane; ++e) s += v[i][e];
      const float mu = warp_sum(s) / D;
      float q = 0.f;
#pragma unroll
      for (int e = 0; e < kLnPerLane; ++e) {
        const float d = lane + 32 * e < D ? v[i][e] - mu : 0.f;
        q += d * d;
      }
      const float rstd = 1.0f / sqrtf(warp_sum(q) / D + kLnEps);
      const bool live = row0 + i < T;
#pragma unroll
      for (int e = 0; e < kLnPerLane; ++e) {  // KA <= 256 here
        const int c = lane + 32 * e;
        if (c >= KA) break;
        const float y = live && c < D ? (v[i][e] - mu) * rstd * g[e] + b[e] : 0.f;
        a[i * lda + c] = __float2bfloat16(y);
      }
    }
    return;
  }
  for (int i = 0; i < kLnRows; ++i) {
    bf16* arow = a + i * lda;
    if (row0 + i >= T) {
      for (int c = lane; c < KA; c += 32) arow[c] = __float2bfloat16(0.f);
      continue;
    }
    const float* x = h + (row0 + i) * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += x[c];
    const float mu = warp_sum(s) / D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = x[c] - mu;
      q += d * d;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(q) / D + kLnEps);
    for (int c = lane; c < KA; c += 32) {
      const float y = c < D ? (x[c] - mu) * rstd * gamma[c] + beta[c] : 0.f;
      arow[c] = __float2bfloat16(y);
    }
  }
}

// Steps 1 and 4: out = epi(bf16(LN(h rows)) @ W). A CTA normalises its kBM
// rows of h (T x D fp32) into shared memory once, then walks every column
// tile of W (K x N bf16, K = DP) over them, the weight slices streamed
// through the ring as one sequence across column tiles.
template <int NT8, class Epi>
__global__ void __launch_bounds__(kGemmThreads, 2)
    ln_gemm_kernel(const float* __restrict__ h, long T, int D, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ W, int K, int N,
                   Epi epi) {
  constexpr int BN = 16 * NT8;
  constexpr int ldb = BN + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  const int KA = round_up(K, kBK);
  const int lda = KA + kPad;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kBM * lda;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long m0 = static_cast<long>(blockIdx.x) * kBM;
  const int KT = KA / kBK;
  const int total = KT * ((N + BN - 1) / BN);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_b_slice<NT8>(Bs + s * kBK * ldb, W, K, N, s % KT, s / KT);
    cp_async_commit();
  }

  // bf16(LN(row)) over the D real columns; columns D..KA and rows past T are zero.
  for (int r = warp * kLnRows; r < kBM; r += kGemmThreads / 32 * kLnRows) {
    layer_norm_rows(h, T, D, gamma, beta, m0 + r, As + r * lda, lda, KA, lane);
  }

  float acc[2][NT8][4] = {};
  const int wm = warp >> 1, wn = warp & 1;
  const bf16* Aw = As + wm * 32 * lda;
  for (int i = 0; i < total; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice i landed; every warp is done with slice i - 1's slot
    const int nxt = i + kStages - 1;
    if (nxt < total) load_b_slice<NT8>(Bs + (nxt % kStages) * kBK * ldb, W, K, N, nxt % KT, nxt / KT);
    cp_async_commit();
    const int kt = i % KT;
    warp_mma_slice<NT8>(acc, Aw + kt * kBK, lda, Bs + (i % kStages) * kBK * ldb + wn * (BN / 2),
                        ldb, lane);
    if (kt == KT - 1) {
      warp_epilogue<NT8>(acc, m0 + wm * 32, (i / KT) * BN + wn * (BN / 2), T, lane, epi);
    }
  }
}

// Steps 3 and 5: epi(A @ W) for A (T x K bf16, K a multiple of 8) and W
// (K x N bf16). One CTA per (row tile, column tile), column tiles of a row
// tile adjacent in launch order so that its second read of A hits L2; A and
// W slices share the ring.
template <int NT8, class Epi>
__global__ void __launch_bounds__(kGemmThreads, 2)
    gemm_kernel(const bf16* __restrict__ A, long T, int K, const bf16* __restrict__ W, int N,
                Epi epi) {
  constexpr int BN = 16 * NT8;
  constexpr int lda = kBK + kPad;
  constexpr int ldb = BN + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kStages * kBM * lda;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = (N + BN - 1) / BN;
  const int nt = blockIdx.x % ntiles;
  const long m0 = static_cast<long>(blockIdx.x / ntiles) * kBM;
  const int KT = (K + kBK - 1) / kBK;

  auto load = [&](int kt) {
    bf16* as = As + (kt % kStages) * kBM * lda;
    for (int c = threadIdx.x; c < kBM * (kBK / 8); c += kGemmThreads) {
      const int r = c / (kBK / 8), cc = (c % (kBK / 8)) * 8;
      const long row = m0 + r;
      const int k = kt * kBK + cc;
      const bool ok = row < T && k < K;
      cp_async16(as + r * lda + cc, ok ? A + row * K + k : A, ok);
    }
    load_b_slice<NT8>(Bs + (kt % kStages) * kBK * ldb, W, K, N, kt, nt);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s);
    cp_async_commit();
  }
  float acc[2][NT8][4] = {};
  const int wm = warp >> 1, wn = warp & 1;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < KT) load(kt + kStages - 1);
    cp_async_commit();
    warp_mma_slice<NT8>(acc, As + (kt % kStages) * kBM * lda + wm * 32 * lda, lda,
                        Bs + (kt % kStages) * kBK * ldb + wn * (BN / 2), ldb, lane);
  }
  warp_epilogue<NT8>(acc, m0 + wm * 32, nt * BN + wn * (BN / 2), T, lane, epi);
}

// Step 2: one CTA per (sequence, head). q, k and v of the head (S x DHP bf16
// each, columns (3 head + {0, 1, 2}) DHP of qkv) go to shared memory; each
// warp takes a 16-row query tile: logits in registers, fp32 softmax, P
// rounded to bf16 and reused from registers as the A operand of P @ v, the
// result stored as bf16 into columns head * DHP of o.
template <int MT>  // S = 16 * MT
__global__ void __launch_bounds__(kAttnThreads)
    attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o, int H, int DHP, int QKVW,
                     int AW, float scale) {
  constexpr int S = 16 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = DHP + kPad;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + S * ld;
  bf16* vs = ks + S * ld;
  const long row0 = static_cast<long>(blockIdx.x / H) * S;
  const int head = blockIdx.x % H;
  const bf16* src = qkv + row0 * QKVW + head * 3 * DHP;
  const int cpr = DHP / 8;  // 16-byte chunks per row of one of q, k, v
  for (int c = threadIdx.x; c < 3 * S * cpr; c += kAttnThreads) {
    const int which = c / (S * cpr), rem = c % (S * cpr);
    const int r = rem / cpr, cc = (rem % cpr) * 8;
    cp_async16(qs + (which * S + r) * ld + cc, src + static_cast<long>(r) * QKVW + which * DHP + cc,
               true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int qt = warp; qt < MT; qt += kAttnThreads / 32) {
    float s[2 * MT][4] = {};
    for (int k0 = 0; k0 < DHP; k0 += 16) {
      unsigned a[4];
      ldsm_x4(a, qs + (qt * 16 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < MT; ++p) {
        unsigned b[4];  // k rows are the columns of k^T: a plain (col-major) B load
        ldsm_x4(b, ks + (p * 16 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * p], a, b[0], b[1]);
        mma16816(s[2 * p + 1], a, b[2], b[3]);
      }
    }
    // Rows g (elements 0, 1) and g + 8 (elements 2, 3); a row's 4 threads
    // are lanes 4g .. 4g + 3.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    // The 16x8 accumulator tiles 2c and 2c + 1 are, rounded, the A operand
    // of keys 16c .. 16c + 15.
    unsigned pa[MT][4];
#pragma unroll
    for (int c = 0; c < MT; ++c) {
      pa[c][0] = pack_bf16(s[2 * c][0] / sum0, s[2 * c][1] / sum0);
      pa[c][1] = pack_bf16(s[2 * c][2] / sum1, s[2 * c][3] / sum1);
      pa[c][2] = pack_bf16(s[2 * c + 1][0] / sum0, s[2 * c + 1][1] / sum0);
      pa[c][3] = pack_bf16(s[2 * c + 1][2] / sum1, s[2 * c + 1][3] / sum1);
    }
    bf16* orow = o + (row0 + qt * 16 + g) * AW + head * DHP + 2 * t;
    for (int d0 = 0; d0 < DHP; d0 += 16) {
      float acc[2][4] = {};
#pragma unroll
      for (int c = 0; c < MT; ++c) {
        unsigned b[4];
        ldsm_x4_t(b, vs + (c * 16 + (lane & 15)) * ld + d0 + (lane >> 4) * 8);
        mma16816(acc[0], pa[c], b[0], b[1]);
        mma16816(acc[1], pa[c], b[2], b[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<unsigned*>(orow + d0 + 8 * j) = pack_bf16(acc[j][0], acc[j][1]);
        *reinterpret_cast<unsigned*>(orow + 8L * AW + d0 + 8 * j) = pack_bf16(acc[j][2], acc[j][3]);
      }
    }
  }
}

// ---- host side -------------------------------------------------------------------

using QkvGemm = StoreBf16<false>;
using FfnGemm = StoreBf16<true>;

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

struct Smem {
  int qkv, attn, res, ffn;
};

Smem smem_of(const Dims& L) {
  return {ln_gemm_smem(kQkvNT8, L.DP), attention_smem(L.S, L.DHP), gemm_smem(kResNT8),
          ln_gemm_smem(kFfnNT8, L.DP)};
}

// Sets each kernel's shared-memory limit for this shape.
template <int MT>
cudaError_t configure(const Smem& sm) {
  cudaError_t err;
  if ((err = allow_smem(ln_gemm_kernel<kQkvNT8, QkvGemm>, sm.qkv)) != cudaSuccess) return err;
  if ((err = allow_smem(attention_kernel<MT>, sm.attn)) != cudaSuccess) return err;
  if ((err = allow_smem(gemm_kernel<kResNT8, AddResidual>, sm.res)) != cudaSuccess) return err;
  return allow_smem(ln_gemm_kernel<kFfnNT8, FfnGemm>, sm.ffn);
}

// The stack's num_layers x 5 stages on one stream; with ev non-null, event
// ev[5 layer + stage + 1] is recorded after each stage (ev[0] before).
template <int MT>
int run(const float* x, float* h, const bf16* w, const float* p, bf16* qkv, bf16* o, bf16* u,
        int R, int num_layers, const Dims& L, cudaStream_t st, cudaEvent_t* ev) {
  const Smem sm = smem_of(L);
  cudaError_t err = configure<MT>(sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long T = static_cast<long>(R) * L.S;
  const unsigned row_tiles = static_cast<unsigned>((T + kBM - 1) / kBM);
  const unsigned res_tiles = row_tiles * ((L.DP + 16 * kResNT8 - 1) / (16 * kResNT8));
  if (ev) cudaEventRecord(ev[0], st);
  for (int layer = 0; layer < num_layers; ++layer) {
    const bf16* w_qkv = w + layer * L.w_layer;
    const bf16* w_o = w_qkv + L.w_qkv;
    const bf16* w_1 = w_o + L.w_o;
    const bf16* w_2 = w_1 + L.w_1;
    const float* ln1_s = p + layer * L.p_layer;
    const float* ln1_b = ln1_s + L.DP;
    const float* b_qkv = ln1_b + L.DP;
    const float* b_o = b_qkv + L.QKVW;
    const float* ln2_s = b_o + L.DP;
    const float* ln2_b = ln2_s + L.DP;
    const float* b_1 = ln2_b + L.DP;
    const float* b_2 = b_1 + L.F;
    cudaEvent_t* after = ev ? ev + kLayerStages * layer + 1 : nullptr;
    const float* h_in = layer == 0 ? x : h;  // layer 0 reads the input, so h needs no copy of it

    ln_gemm_kernel<kQkvNT8, QkvGemm><<<row_tiles, kGemmThreads, sm.qkv, st>>>(
        h_in, T, L.D, ln1_s, ln1_b, w_qkv, L.DP, L.QKVW, QkvGemm{qkv, L.QKVW, b_qkv});
    if (after) cudaEventRecord(after[0], st);
    attention_kernel<MT><<<static_cast<unsigned>(R) * L.H, kAttnThreads, sm.attn, st>>>(
        qkv, o, L.H, L.DHP, L.QKVW, L.AW, L.scale);
    if (after) cudaEventRecord(after[1], st);
    gemm_kernel<kResNT8, AddResidual><<<res_tiles, kGemmThreads, sm.res, st>>>(
        o, T, L.AW, w_o, L.DP, AddResidual{h_in, h, L.D, b_o});
    if (after) cudaEventRecord(after[2], st);
    ln_gemm_kernel<kFfnNT8, FfnGemm><<<row_tiles, kGemmThreads, sm.ffn, st>>>(
        h, T, L.D, ln2_s, ln2_b, w_1, L.DP, L.F, FfnGemm{u, L.F, b_1});
    if (after) cudaEventRecord(after[3], st);
    gemm_kernel<kResNT8, AddResidual><<<res_tiles, kGemmThreads, sm.res, st>>>(
        u, T, L.F, w_2, L.DP, AddResidual{h, h, L.D, b_2});
    if (after) cudaEventRecord(after[4], st);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

bool valid(int S, int D, int H, int F) {
  return S >= kTile && S <= 4 * kTile && S % kTile == 0 && H >= 1 && D >= 1 && D % H == 0 &&
         F >= kTile && F % kTile == 0;
}

int max_smem(const Dims& L) {
  const Smem sm = smem_of(L);
  int m = sm.qkv > sm.attn ? sm.qkv : sm.attn;
  m = m > sm.res ? m : sm.res;
  return m > sm.ffn ? m : sm.ffn;
}

}  // namespace

// The most dynamic shared memory one CTA of the stack's kernels needs, in
// bytes (the wrapper checks it before a launch).
extern "C" int dyg_transformer_smem_bytes(int S, int D, int H, int F) {
  return max_smem(make_dims(S, D, H, F));
}

// CTAs of each kernel that fit on one SM at this shape, as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them: out[0..3] =
// LN1 -> QKV, attention, the residual GEMM (Wo, W2), LN2 -> W1.
extern "C" int dyg_transformer_occupancy(int S, int D, int H, int F, int* out) {
  if (!valid(S, D, H, F)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims L = make_dims(S, D, H, F);
  const Smem sm = smem_of(L);
  auto query = [&](auto kernel, int threads, int bytes, int* n) {
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, threads, bytes);
  };
  cudaError_t err;
  switch (S / kTile) {
    case 1: err = query(attention_kernel<1>, kAttnThreads, sm.attn, out + 1); break;
    case 2: err = query(attention_kernel<2>, kAttnThreads, sm.attn, out + 1); break;
    case 3: err = query(attention_kernel<3>, kAttnThreads, sm.attn, out + 1); break;
    default: err = query(attention_kernel<4>, kAttnThreads, sm.attn, out + 1); break;
  }
  if (err == cudaSuccess) err = query(ln_gemm_kernel<kQkvNT8, QkvGemm>, kGemmThreads, sm.qkv, out);
  if (err == cudaSuccess) {
    err = query(gemm_kernel<kResNT8, AddResidual>, kGemmThreads, sm.res, out + 2);
  }
  if (err == cudaSuccess) err = query(ln_gemm_kernel<kFfnNT8, FfnGemm>, kGemmThreads, sm.ffn, out + 3);
  return static_cast<int>(err);
}

// x: (R, S, D) fp32, the stack's input, only read. h: (R, S, D) fp32, not
// overlapping x, receives the output (layer 0 reads x, so h needs no copy of
// it beforehand). w:
// num_layers packed bf16 weight blocks, p: num_layers packed fp32 parameter
// blocks, both laid out as ``make_dims`` says (the wrapper builds them). F:
// padded FFN width, a multiple of 16. qkv (R*S, QKVW), o (R*S, AW), u (R*S,
// F): bf16 scratch. stage_ms: null, or num_layers * 5 floats that receive
// each stage's device milliseconds (the call then waits for the stream).
extern "C" int dyg_transformer_stack_fwd(const void* x, void* h, const void* w, const void* p,
                                         void* qkv, void* o, void* u, void* stage_ms, int R, int S,
                                         int D, int H, int F, int num_layers, void* stream) {
  if (!valid(S, D, H, F) || R < 0 || num_layers < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Dims L = make_dims(S, D, H, F);
  if (max_smem(L) > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (R == 0) return 0;
  if (num_layers == 0) {
    return static_cast<int>(cudaMemcpyAsync(h, x, sizeof(float) * R * S * D,
                                            cudaMemcpyDeviceToDevice, st));
  }
  const auto* xs = static_cast<const float*>(x);
  auto* hs = static_cast<float*>(h);
  const auto* ws = static_cast<const bf16*>(w);
  const auto* ps = static_cast<const float*>(p);
  auto* qs = static_cast<bf16*>(qkv);
  auto* os = static_cast<bf16*>(o);
  auto* us = static_cast<bf16*>(u);
  const int n_ev = kLayerStages * num_layers + 1;
  cudaEvent_t* ev = nullptr;
  if (stage_ms) {
    ev = new cudaEvent_t[n_ev];
    for (int i = 0; i < n_ev; ++i) cudaEventCreate(&ev[i]);
  }
  int err;
  switch (S / kTile) {
    case 1: err = run<1>(xs, hs, ws, ps, qs, os, us, R, num_layers, L, st, ev); break;
    case 2: err = run<2>(xs, hs, ws, ps, qs, os, us, R, num_layers, L, st, ev); break;
    case 3: err = run<3>(xs, hs, ws, ps, qs, os, us, R, num_layers, L, st, ev); break;
    default: err = run<4>(xs, hs, ws, ps, qs, os, us, R, num_layers, L, st, ev); break;
  }
  if (ev) {
    if (err == 0) err = static_cast<int>(cudaEventSynchronize(ev[n_ev - 1]));
    for (int i = 0; err == 0 && i + 1 < n_ev; ++i) {
      err = static_cast<int>(
          cudaEventElapsedTime(static_cast<float*>(stage_ms) + i, ev[i], ev[i + 1]));
    }
    for (int i = 0; i < n_ev; ++i) cudaEventDestroy(ev[i]);
    delete[] ev;
  }
  return err;
}
