// K5: fused DyGFormer transformer-stack forward (eval).
//
// Replaces the Pallas TPU kernel transformer_stack_fwd
// (tgm_tpu/ops/pallas/dyg_transformer.py, body _kernel). For each of R
// sequences of S rows and width D, num_layers times:
//   hn = bf16(LN1(h));  qkv = hn @ Wqkv + bqkv          (fp32 accumulate)
//   per head: logits = bf16(q) @ bf16(k)^T * scale;  a = bf16(softmax(logits))
//             o_head = a @ bf16(v)
//   h += bf16(concat(o_head)) @ Wo + bo
//   hn = bf16(LN2(h));  g = bf16(gelu(hn @ W1 + b1));  h += g @ W2 + b2
// with bf16 matmul operands, fp32 accumulation, fp32 LayerNorm (biased
// variance, eps 1e-5) and fp32 softmax, rounding to bf16 at exactly the
// places the Pallas kernel does. Exact gelu uses erff (the TPU kernel's
// Abramowitz-Stegun polynomial only worked around Mosaic's missing erf).
//
// What bounds it on an H100: the tensor cores. At the DyGFormer eval shape
// (R = 4,200 sequences of (64, 200), 2 layers, 2 heads, FFN 800) it does
// about 544 GFLOP of bf16 products: 0.55 ms at the H100 SXM's published 989
// TFLOP/s, against 0.13 ms for its 430 MB of fp32 input and output at 3.35
// TB/s (published peaks at the 700 W power limit).
//
// Design (simple and right first; wgmma, TMA and a persistent schedule are
// later work): one CTA of 8 warps per sequence. The residual stream h (S x D
// fp32) stays in shared memory through every layer, with the LayerNorm
// output, one head's q/k/v, the logits, the probabilities and the
// concatenated head outputs beside it; the FFN runs in column chunks of FC
// hidden units, so the (S, 4D) intermediate never sits in shared memory
// whole, and its output accumulates in an fp32 shared buffer. Products are
// WMMA bf16 16x16x16 fragments with fp32 accumulators. Each warp owns whole
// column strips of an output (all S rows at once), so a weight fragment is
// read from global memory (L2: about 1 MB of bf16 weights per layer) once
// per CTA. D = 200 and dh = 100 are not multiples of 16: the wrapper pads
// the weights with zeros (D -> DP, each head dh -> DHP, FFN width to a
// multiple of FC), and the kernel keeps the pad columns of h, the LayerNorm
// output and q/k/v zero, so the padding changes no sum. Shared-memory rows
// are padded by 16 bytes against bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;
constexpr int kMaxSharedBytes = 232448;  // an H100 block's opt-in maximum
constexpr float kLnEps = 1e-5f;

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Dimensions, shared-memory plan and packed-parameter offsets of one call.
struct Layout {
  int S, D, H, F, FC, dh;   // F is the padded FFN width, a multiple of FC
  int DP, DHP, QKVW, AW;    // padded widths: D, one head, fused QKV, head concat
  int ld_h, ld_n, ld_q, ld_s, ld_p, ld_a, ld_u, ld_o;  // shared strides, elements
  int off_h, off_n, off_w, off_q, off_k, off_v, off_s, off_p, off_a, off_u, off_o;
  int smem_bytes;
  long w_qkv, w_o, w_1, w_layer;  // bf16 weights of a layer: Wqkv | Wo | W1 | W2
  long p_layer;                   // fp32 params: ln1 s,b | bqkv | bo | ln2 s,b | b1 | b2
  float scale;
};

Layout make_layout(int S, int D, int H, int F, int FC) {
  Layout L;
  L.S = S; L.D = D; L.H = H; L.F = F; L.FC = FC; L.dh = D / H;
  L.DP = round_up(D, kTile);
  L.DHP = round_up(L.dh, kTile);
  L.QKVW = 3 * H * L.DHP;
  L.AW = H * L.DHP;
  L.ld_h = L.DP;
  L.ld_n = L.DP + 8;
  L.ld_q = L.DHP + 8;
  L.ld_s = S + 4;
  L.ld_p = S + 8;
  L.ld_a = L.AW + 8;
  L.ld_u = FC + 8;
  L.ld_o = L.DP;
  int off = 0;
  auto take = [&off](int bytes) {
    const int at = off;
    off = round_up(off + bytes, 128);
    return at;
  };
  L.off_h = take(S * L.ld_h * 4);
  L.off_n = take(S * L.ld_n * 2);
  L.off_w = take(kWarps * kTile * kTile * 4);  // one fp32 tile of scratch per warp
  const int shared_from = off;  // attention and FFN buffers share what follows
  L.off_q = take(S * L.ld_q * 2);
  L.off_k = take(S * L.ld_q * 2);
  L.off_v = take(S * L.ld_q * 2);
  L.off_s = take(S * L.ld_s * 4);
  L.off_p = take(S * L.ld_p * 2);
  L.off_a = take(S * L.ld_a * 2);
  const int attn_end = off;
  off = shared_from;
  L.off_u = take(S * L.ld_u * 2);
  L.off_o = take(S * L.ld_o * 4);
  L.smem_bytes = attn_end > off ? attn_end : off;
  L.w_qkv = static_cast<long>(L.DP) * L.QKVW;
  L.w_o = static_cast<long>(L.AW) * L.DP;
  L.w_1 = static_cast<long>(L.DP) * F;
  L.w_layer = L.w_qkv + L.w_o + 2 * L.w_1;
  L.p_layer = 6L * L.DP + L.QKVW + F;
  L.scale = 1.0f / sqrtf(static_cast<float>(L.dh));
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[M x N] = A[M x K] @ B[K x N]: A bf16 row-major in shared memory, B bf16
// in global or shared memory (row-major, or col-major to read a transpose).
// Work units are one 16-column strip of RG row tiles; warps take units in
// turn. Each finished 16x16 fp32 tile goes through the warp's scratch tile to
// epi(row0, col0, scratch), which every lane of the warp calls.
template <int RG, typename BLayout, typename Epi>
__device__ __forceinline__ void warp_gemm(const bf16* A, int lda, const bf16* B, int ldb,
                                          int M, int N, int K, float* scratch, Epi epi) {
  const int warp = threadIdx.x / 32;
  const int col_tiles = N / kTile;
  const int units = (M / (kTile * RG)) * col_tiles;
  for (int u = warp; u < units; u += kWarps) {
    const int j = u % col_tiles;
    const int r0 = (u / col_tiles) * RG;
    wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> acc[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) wmma::fill_fragment(acc[r], 0.0f);
    for (int k = 0; k < K; k += kTile) {
      wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, bf16, BLayout> b;
      if constexpr (std::is_same<BLayout, wmma::row_major>::value) {
        wmma::load_matrix_sync(b, B + static_cast<long>(k) * ldb + j * kTile, ldb);
      } else {
        wmma::load_matrix_sync(b, B + static_cast<long>(j) * kTile * ldb + k, ldb);
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + (r0 + r) * kTile * lda + k, lda);
        wmma::mma_sync(acc[r], a, b, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      wmma::store_matrix_sync(scratch, acc[r], kTile, wmma::mem_row_major);
      __syncwarp();
      epi((r0 + r) * kTile, j * kTile, scratch);
      __syncwarp();
    }
  }
}

// acc[M x N] (+)= A[M x K] @ B[K x N] with acc fp32 row-major in shared
// memory; first = true starts from zero.
template <int RG>
__device__ __forceinline__ void warp_gemm_acc(const bf16* A, int lda, const bf16* B, int ldb,
                                              int M, int N, int K, float* acc_mem, int ldc,
                                              bool first) {
  const int warp = threadIdx.x / 32;
  const int col_tiles = N / kTile;
  const int units = (M / (kTile * RG)) * col_tiles;
  for (int u = warp; u < units; u += kWarps) {
    const int j = u % col_tiles;
    const int r0 = (u / col_tiles) * RG;
    wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> acc[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      if (first) {
        wmma::fill_fragment(acc[r], 0.0f);
      } else {
        wmma::load_matrix_sync(acc[r], acc_mem + (r0 + r) * kTile * ldc + j * kTile, ldc,
                               wmma::mem_row_major);
      }
    }
    for (int k = 0; k < K; k += kTile) {
      wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, B + static_cast<long>(k) * ldb + j * kTile, ldb);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + (r0 + r) * kTile * lda + k, lda);
        wmma::mma_sync(acc[r], a, b, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      wmma::store_matrix_sync(acc_mem + (r0 + r) * kTile * ldc + j * kTile, acc[r], ldc,
                              wmma::mem_row_major);
    }
  }
}

// hn = bf16(LN(h)) over the D real columns; pad columns of hn are zero.
__device__ __forceinline__ void layer_norm(const Layout& L, const float* h, bf16* hn,
                                           const float* gamma, const float* beta) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < L.S; r += kWarps) {
    const float* row = h + r * L.ld_h;
    float s = 0.f;
    for (int c = lane; c < L.D; c += 32) s += row[c];
    const float mu = warp_sum(s) / L.D;
    float v = 0.f;
    for (int c = lane; c < L.D; c += 32) {
      const float d = row[c] - mu;
      v += d * d;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(v) / L.D + kLnEps);
    for (int c = lane; c < L.DP; c += 32) {
      const float y = c < L.D ? (row[c] - mu) * rstd * gamma[c] + beta[c] : 0.f;
      hn[r * L.ld_n + c] = __float2bfloat16(y);
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
    dyg_stack_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const bf16* __restrict__ weights, const float* __restrict__ params,
                     int num_layers, const Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* h = reinterpret_cast<float*>(smem + L.off_h);
  bf16* hn = reinterpret_cast<bf16*>(smem + L.off_n);
  float* scratch = reinterpret_cast<float*>(smem + L.off_w) + (threadIdx.x / 32) * kTile * kTile;
  bf16* qb = reinterpret_cast<bf16*>(smem + L.off_q);
  bf16* kb = reinterpret_cast<bf16*>(smem + L.off_k);
  bf16* vb = reinterpret_cast<bf16*>(smem + L.off_v);
  float* sc = reinterpret_cast<float*>(smem + L.off_s);
  bf16* pb = reinterpret_cast<bf16*>(smem + L.off_p);
  bf16* ab = reinterpret_cast<bf16*>(smem + L.off_a);
  bf16* ub = reinterpret_cast<bf16*>(smem + L.off_u);
  float* ob = reinterpret_cast<float*>(smem + L.off_o);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int S = L.S, D = L.D, DP = L.DP, DHP = L.DHP;
  const long base = static_cast<long>(blockIdx.x) * S * D;

  for (int i = threadIdx.x; i < S * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    h[r * L.ld_h + c] = c < D ? x[base + r * D + c] : 0.f;
  }
  __syncthreads();

  for (int layer = 0; layer < num_layers; ++layer) {
    const bf16* w_qkv = weights + layer * L.w_layer;
    const bf16* w_o = w_qkv + L.w_qkv;
    const bf16* w_1 = w_o + L.w_o;
    const bf16* w_2 = w_1 + L.w_1;
    const float* ln1_s = params + layer * L.p_layer;
    const float* ln1_b = ln1_s + DP;
    const float* b_qkv = ln1_b + DP;
    const float* b_o = b_qkv + L.QKVW;
    const float* ln2_s = b_o + DP;
    const float* ln2_b = ln2_s + DP;
    const float* b_1 = ln2_b + DP;
    const float* b_2 = b_1 + L.F;

    // ---- attention block ------------------------------------------------
    layer_norm(L, h, hn, ln1_s, ln1_b);
    __syncthreads();
    for (int hd = 0; hd < L.H; ++hd) {
      // q | k | v of head hd: columns [hd*3*DHP, (hd+1)*3*DHP) of the padded Wqkv.
      const int col0 = hd * 3 * DHP;
      warp_gemm<MT, wmma::row_major>(
          hn, L.ld_n, w_qkv + col0, L.QKVW, S, 3 * DHP, DP, scratch,
          [&](int r0, int c0, const float* t) {
            for (int e = lane; e < kTile * kTile; e += 32) {
              const int r = r0 + e / kTile, c = c0 + e % kTile;
              const int which = c / DHP, cc = c - which * DHP;
              bf16* dst = which == 0 ? qb : (which == 1 ? kb : vb);
              dst[r * L.ld_q + cc] = __float2bfloat16(t[e] + b_qkv[col0 + c]);
            }
          });
      __syncthreads();
      warp_gemm<1, wmma::col_major>(
          qb, L.ld_q, kb, L.ld_q, S, S, DHP, scratch, [&](int r0, int c0, const float* t) {
            for (int e = lane; e < kTile * kTile; e += 32) {
              sc[(r0 + e / kTile) * L.ld_s + c0 + e % kTile] = t[e] * L.scale;
            }
          });
      __syncthreads();
      for (int r = warp; r < S; r += kWarps) {
        float* row = sc + r * L.ld_s;
        float m = -INFINITY;
        for (int c = lane; c < S; c += 32) m = fmaxf(m, row[c]);
        m = warp_max(m);
        float sum = 0.f;
        for (int c = lane; c < S; c += 32) {
          const float e = expf(row[c] - m);
          row[c] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int c = lane; c < S; c += 32) pb[r * L.ld_p + c] = __float2bfloat16(row[c] / sum);
      }
      __syncthreads();
      warp_gemm<1, wmma::row_major>(
          pb, L.ld_p, vb, L.ld_q, S, DHP, S, scratch, [&](int r0, int c0, const float* t) {
            for (int e = lane; e < kTile * kTile; e += 32) {
              ab[(r0 + e / kTile) * L.ld_a + hd * DHP + c0 + e % kTile] = __float2bfloat16(t[e]);
            }
          });
      __syncthreads();
    }
    warp_gemm<MT, wmma::row_major>(
        ab, L.ld_a, w_o, DP, S, DP, L.AW, scratch, [&](int r0, int c0, const float* t) {
          for (int e = lane; e < kTile * kTile; e += 32) {
            const int r = r0 + e / kTile, c = c0 + e % kTile;
            h[r * L.ld_h + c] += t[e] + b_o[c];
          }
        });
    __syncthreads();

    // ---- FFN block, in chunks of FC hidden columns --------------------------
    layer_norm(L, h, hn, ln2_s, ln2_b);
    __syncthreads();
    for (int f0 = 0; f0 < L.F; f0 += L.FC) {
      warp_gemm<MT, wmma::row_major>(
          hn, L.ld_n, w_1 + f0, L.F, S, L.FC, DP, scratch, [&](int r0, int c0, const float* t) {
            for (int e = lane; e < kTile * kTile; e += 32) {
              const int r = r0 + e / kTile, c = c0 + e % kTile;
              const float u = t[e] + b_1[f0 + c];
              const float g = 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
              ub[r * L.ld_u + c] = __float2bfloat16(g);
            }
          });
      __syncthreads();
      warp_gemm_acc<MT>(ub, L.ld_u, w_2 + static_cast<long>(f0) * DP, DP, S, DP, L.FC, ob,
                        L.ld_o, f0 == 0);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < S * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      h[r * L.ld_h + c] += ob[r * L.ld_o + c] + b_2[c];
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < S * D; i += kThreads) {
    const int r = i / D, c = i % D;
    out[base + i] = h[r * L.ld_h + c];
  }
}

template <int MT>
int launch(const float* x, float* out, const bf16* w, const float* p, int R, int num_layers,
           const Layout& L, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dyg_stack_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dyg_stack_kernel<MT><<<R, kThreads, L.smem_bytes, stream>>>(x, out, w, p, num_layers, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one CTA needs, in bytes (the wrapper checks it before a launch).
extern "C" int dyg_transformer_smem_bytes(int S, int D, int H, int F, int FC) {
  return make_layout(S, D, H, F, FC).smem_bytes;
}

// x, out: (R, S, D) fp32. w: num_layers packed bf16 weight blocks, p:
// num_layers packed fp32 parameter blocks, both laid out as ``make_layout``
// says (the wrapper builds them). F: padded FFN width, a multiple of FC.
extern "C" int dyg_transformer_stack_fwd(const void* x, void* out, const void* w,
                                         const void* p, int R, int S, int D, int H, int F,
                                         int FC, int num_layers, void* stream) {
  if (S < kTile || S > 4 * kTile || S % kTile != 0 || H < 1 || D % H != 0 || FC < kTile ||
      FC % kTile != 0 || F % FC != 0 || num_layers < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L = make_layout(S, D, H, F, FC);
  if (L.smem_bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xs = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  const auto* ws = static_cast<const bf16*>(w);
  const auto* ps = static_cast<const float*>(p);
  auto st = static_cast<cudaStream_t>(stream);
  switch (S / kTile) {
    case 1: return launch<1>(xs, o, ws, ps, R, num_layers, L, st);
    case 2: return launch<2>(xs, o, ws, ps, R, num_layers, L, st);
    case 3: return launch<3>(xs, o, ws, ps, R, num_layers, L, st);
    default: return launch<4>(xs, o, ws, ps, R, num_layers, L, st);
  }
}
