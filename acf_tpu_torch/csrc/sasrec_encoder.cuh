// Shared by K2a (sasrec_encoder_fwd.cu) and K2b (sasrec_encoder_bwd.cu): the
// structs the wrappers pass by value, the small helpers, and the device steps
// both kernels take on [rows][ld] f32 buffers in shared memory (rows padded
// to an odd number of 16-byte units): a d x d product whose weight streams
// through two shared-memory slots with cp.async, one k-slice ahead and across
// products (Pipe, stage_slice, product). Each kernel keeps its own LayerNorm
// and attention and the steps only it takes.
//
// Widths: a staged row holds pad4(d) columns (d rounded up to 4) at the
// stride row_ld(pad4(d)), and its tail columns [d, pad4(d)) are exact zeros
// through every phase, so every product and dot adds exact zeros there. The
// ALIGNED path (d % 4 == 0 and 16-byte aligned tensors) copies rows 16 bytes
// at a time; the other path copies 4 bytes at a time, zero-fills the tail and
// writes only the d real columns back to device memory.
//
// Compute dtypes: a unit built with ACF_ENCODER_BF16 defined to 1
// (csrc/sasrec_encoder_fwd_bf16.cu, csrc/sasrec_encoder_bwd_bf16.cu) holds
// the kernels' bfloat16 form, the JAX kernel's `_dot` with cd = bfloat16
// (acf_tpu/ops/sasrec_fused.py:81-86) and its vjp: every product reads its
// operands rounded to bfloat16 (to nearest even; `operand`), and so do the
// attention's from T = kMxuAttnT on (`attn_operand`). The product of two
// bfloat16 values is exact in float32, so the float32 FMA chains sum
// bfloat16 products in float32. In the backward each product's result (an
// input gradient dY Wᵀ, the attention's dP, dV, dQ, dK, and a weight
// gradient summed over the whole batch) is rounded once more, the cotangent
// it multiplies is not. LayerNorm, softmax, dropout, biases, the residuals
// and every buffer stay float32. Its C entries carry the suffix _bf16
// (ENCODER_ENTRY). In the float32 form every rounding is `if constexpr`'d
// away, so its code is what it was.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"

#ifndef ACF_ENCODER_BF16
#define ACF_ENCODER_BF16 0
#endif
#if ACF_ENCODER_BF16
#define ENCODER_ENTRY(name) name##_bf16
// A step kept out of line in the bfloat16 form: inlined, its conversions
// tip a 128-register kernel into spilling
#define BF16_NOINLINE __noinline__
#else
#define ENCODER_ENTRY(name) name
#define BF16_NOINLINE
#endif

constexpr int kMaxBlocks = 8;  // ENCODER_MAX_BLOCKS in ops/_build.py
constexpr bool kBf16 = ACF_ENCODER_BF16 != 0;
constexpr int kMxuAttnT = 32;  // MXU_ATTN_T in ops/sasrec_fused.py (the JAX kernel's _MXU_ATTN_T)

// The weights, one pointer per param leaf (EncoderWeights in ops/_build.py).
struct DenseW { const float* w; const float* b; };
struct LayerNormW { const float* gamma; const float* beta; };
struct BlockW {
  LayerNormW ln1;
  DenseW wq, wk, wv;
  LayerNormW ln2;
  DenseW conv1, conv2;
  LayerNormW ln3;
};
struct EncoderW {
  const float* pos;  // pos_emb[-T:], [T, d]
  LayerNormW ln_f;
  BlockW blocks[kMaxBlocks];
  int num_blocks;
};

// Dropout masks in the JAX layout (bool tensors read as uint8, DropoutMasks
// in ops/_build.py): emb [B, T, d]; per block p [B, T, T] (one head), f1 and
// f2 [B, T, d]. All null at inference. A kept value is divided by `keep`.
struct DropoutMasks {
  const unsigned char* emb;
  const unsigned char* p[kMaxBlocks];
  const unsigned char* f1[kMaxBlocks];
  const unsigned char* f2[kMaxBlocks];
  float keep;
};

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxColsPerLane = 4;  // d <= 128 over 32 lanes
constexpr int kSliceFloats = 4096;  // SLICE_FLOATS in ops/sasrec_fused.py: a weight slice's floats at most
constexpr float kEps = 1e-8f;

// The width a row is staged at: d rounded up to 4.
__host__ __device__ constexpr inline int pad4(int d) { return (d + 3) & ~3; }

inline bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// Whether every weight leaf of `w` can be copied 16 bytes at a time at width
// d (the ALIGNED path of the products and LayerNorms).
inline bool weights_aligned(const EncoderW& w, int d) {
  if (d % 4 != 0 || !aligned16(w.pos) || !aligned16(w.ln_f.gamma) || !aligned16(w.ln_f.beta))
    return false;
  for (int i = 0; i < w.num_blocks; ++i) {
    const BlockW& b = w.blocks[i];
    const void* leaves[] = {b.ln1.gamma, b.ln1.beta, b.wq.w, b.wq.b, b.wk.w, b.wk.b,
                            b.wv.w, b.wv.b, b.ln2.gamma, b.ln2.beta, b.conv1.w, b.conv1.b,
                            b.conv2.w, b.conv2.b, b.ln3.gamma, b.ln3.beta};
    for (const void* leaf : leaves)
      if (!aligned16(leaf)) return false;
  }
  return true;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// v rounded to bfloat16 (to nearest, ties to even), as a float.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A product's operand, or a backward product's result, in this unit's form:
// v itself in the float32 form, v rounded to bfloat16 in the bfloat16 form.
__device__ __forceinline__ float operand(float v) {
  if constexpr (kBf16) return bf16_round(v);
  return v;
}

__device__ __forceinline__ float4 operand4(float4 v) {
  if constexpr (kBf16) {
    const float2 lo = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
    const float2 hi = __bfloat1622float2(__floats2bfloat162_rn(v.z, v.w));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return v;
}

// The attention's operands and results in windows of T: rounded as
// `operand` from T = kMxuAttnT on, float32 below it in both forms.
__device__ __forceinline__ float attn_operand(float v, int T) {
  if constexpr (kBf16) return T >= kMxuAttnT ? bf16_round(v) : v;
  return v;
}

__device__ __forceinline__ float4 attn_operand4(float4 v, int T) {
  if constexpr (kBf16) return T >= kMxuAttnT ? operand4(v) : v;
  return v;
}

// where(m, v / keep, 0): the JAX package's inverted dropout (a division).
__device__ __forceinline__ float drop(float v, unsigned char m, float keep) {
  return m ? v / keep : 0.f;
}

// What a d x d product does to its sum, in this order: add `bias`; relu;
// dropout with `mask` (rows [R][d] in device memory, read before the
// product); zero where `gate` ([R][ld], may alias the output) is <= 0
// (relu's backward); add `res` ([R][ld], may alias the output). Each
// pointer may be null.
struct Epilogue {
  const float* bias;
  bool relu;
  const unsigned char* mask;
  float keep;
  const float* gate;
  const float* res;
};

__device__ __forceinline__ Epilogue epi(const float* bias = nullptr, bool relu = false,
                                        const unsigned char* mask = nullptr,
                                        float keep = 1.f, const float* gate = nullptr,
                                        const float* res = nullptr) {
  return Epilogue{bias, relu, mask, keep, gate, res};
}

__device__ __forceinline__ void fma4(float4& o, float a, float4 w) {
  o.x = fmaf(a, w.x, o.x); o.y = fmaf(a, w.y, o.y);
  o.z = fmaf(a, w.z, o.z); o.w = fmaf(a, w.w, o.w);
}

// ---- the weight stream ------------------------------------------------------

// The `floats` floats of a weight slot at p (a multiple of 4, 16-byte
// aligned) through `operand4`, every thread taking part.
__device__ __forceinline__ void round_slot(float* p, int floats) {
  for (int i = 4 * threadIdx.x; i < floats; i += 4 * blockDim.x)
    *reinterpret_cast<float4*>(p + i) = operand4(*reinterpret_cast<const float4*>(p + i));
}

// A d x d weight as a product reads it: W (x W) or Wᵀ (dY Wᵀ); w null: none.
struct WRef { const float* w; bool trans; };

// Two slots of shared memory through which the weights' k-slices stream,
// one ahead of the slice being multiplied. `cur` is the slot of the next
// slice to multiply; `pending` says whether it is already in flight.
struct Pipe {
  float* base;   // slot 0; slot 1 follows at base + slot
  int slot, cur;
  bool pending;
  int ks, ldk;  // rows a slice, the row stride of a Wᵀ slice
  __device__ float* at(int k) const { return base + k * slot; }
};

// stage_slice's copies at any width: 4 bytes at a time, a row of the slice
// a warp, what lies past d zero-filled (rows k0 + kk and columns c up to
// pad4(d)).
__device__ void stage_slice_any(float* dst, WRef W, int k0, const Pipe& pp, int d, int ld) {
  const int dp = pad4(d), kn = min(pp.ks, dp - k0);
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  if (!W.trans) {  // dst[kk][c] = W[k0 + kk][c]
    for (int kk = threadIdx.x >> 5; kk < kn; kk += warps)
      for (int c = lane; c < dp; c += 32) {
        const bool valid = c < d && k0 + kk < d;
        cp_async_n<4>(dst + kk * ld + c, W.w + (valid ? (k0 + kk) * d + c : 0), valid ? 4 : 0);
      }
  } else {  // dst[c][kk] = W[c][k0 + kk]
    for (int c = threadIdx.x >> 5; c < dp; c += warps)
      for (int kk = lane; kk < kn; kk += 32) {
        const bool valid = c < d && k0 + kk < d;
        cp_async_n<4>(dst + c * pp.ldk + kk, W.w + (valid ? c * d + k0 + kk : 0), valid ? 4 : 0);
      }
  }
}

// Issue the copy of k-slice [k0, k0 + ks) of W into `dst`: rows W[k0 + kk]
// as dst[kk][0, d) with stride ld (x W), or columns as dst[c][kk] with
// stride ldk (dY Wᵀ). Every thread takes part; one cp.async group. Without
// ALIGNED, stage_slice_any's 4-byte copies.
template <bool ALIGNED>
__device__ void stage_slice(float* dst, WRef W, int k0, const Pipe& pp, int d, int ld) {
  if (!ALIGNED) {
    stage_slice_any(dst, W, k0, pp, d, ld);
    cp_async_commit();
    return;
  }
  const int kn = min(pp.ks, d - k0);
  if (!W.trans) {
    const int units = d / 4;
    for (int i = threadIdx.x; i < kn * units; i += blockDim.x) {
      const int kk = i / units, c = (i % units) * 4;
      cp_async16(dst + kk * ld + c, W.w + static_cast<size_t>(k0 + kk) * d + c);
    }
  } else {
    const int units = kn / 4;
    for (int i = threadIdx.x; i < d * units; i += blockDim.x) {
      const int c = i / units, kk = (i % units) * 4;
      cp_async16(dst + c * pp.ldk + kk, W.w + static_cast<size_t>(c) * d + k0 + kk);
    }
  }
  cp_async_commit();
}

// out = epilogue(in[0] W[0]) (TRANS: in[0] W[0]ᵀ) for rows r < R, all
// [R][ld] in shared memory (or, in K2b's wide form, device memory), with the
// header's epilogue (bias, relu, mask, gate, res); then each further product
// is added onto out in turn (((res + p0) + p1) + p2), each thread updating
// its own elements. `next` is the weight of the product after this one,
// whose first slice is staged during this one's last. A thread owns ROWS
// rows (rg + i * row_groups) x 4 columns and sums k in order with FMAs; R <=
// ROWS * row_groups (the C entry checks it). The columns run to pad4(d): the
// tail's sums are exact zeros, and its bias and mask are not read. Each
// staged slice of W passes through `operand` once it lands (round_slot),
// and x through it as it is read in x W; a TRANS product (dY Wᵀ, an input
// gradient of the backward) reads the cotangent dY as it is and passes its
// sum through `operand` before the epilogue.
template <int ROWS, bool TRANS, int NP, bool ALIGNED>
__device__ __forceinline__ void product(Pipe& pp, const float* const (&in)[NP],
                                        const float* const (&W)[NP], WRef next, float* out,
                                        const Epilogue& e, int R, int d, int ld) {
  const int dp = ALIGNED ? d : pad4(d);
  const int groups = dp / 4;
  const int row_groups = blockDim.x / groups;
  const int cg = threadIdx.x % groups, rg = threadIdx.x / groups;
  const bool active = rg < row_groups;  // idle when groups does not divide the block
  const int nsl = (dp + pp.ks - 1) / pp.ks;
  // this thread's output columns: 4cg..4cg+3 (x W), or cg + groups * j (dY Wᵀ)
  auto col = [&](int j) { return TRANS ? cg + groups * j : 4 * cg + j; };
  unsigned mk[ROWS];  // the dropout mask's 4 bytes a row, read before the products
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = rg + i * row_groups;
    mk[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (active && r < R && e.mask != nullptr && (ALIGNED || col(j) < d))
        mk[i] |= static_cast<unsigned>(e.mask[static_cast<size_t>(r) * d + col(j)]) << (8 * j);
  }
  if (!pp.pending) stage_slice<ALIGNED>(pp.at(pp.cur), WRef{W[0], TRANS}, 0, pp, d, ld);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float4 acc[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nsl; ++s) {
      cp_async_wait<0>();
      __syncthreads();  // slice s has landed; every thread is done with the other slot
      const WRef following = s + 1 < nsl ? WRef{W[p], TRANS}
                             : p + 1 < NP ? WRef{W[p + 1 < NP ? p + 1 : p], TRANS}
                                          : next;
      if (following.w != nullptr)
        stage_slice<ALIGNED>(pp.at(pp.cur ^ 1), following, s + 1 < nsl ? (s + 1) * pp.ks : 0, pp,
                             d, ld);
      const float* sw = pp.at(pp.cur);
      if constexpr (kBf16) {  // the landed slice's operands rounded once, in place
        round_slot(pp.at(pp.cur), pp.slot);
        __syncthreads();
      }
      pp.cur ^= 1;
      if (!active) continue;
      const int k0 = s * pp.ks, kn = min(pp.ks, dp - k0);
      // unrolled twice (once for tiles of more than 4 rows, and in the
      // bfloat16 form, whose conversions take the registers of the second
      // step): more would spend registers that a 512-thread block lacks
#pragma unroll(kBf16 || ROWS > 4 ? 1 : 2)
      for (int kk = 0; kk < kn; kk += 4) {
        float4 w[4];  // x W: W[k0 + kk + j][4cg..]; dY Wᵀ: W[cg + groups j][k0 + kk..]
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = *reinterpret_cast<const float4*>(
              TRANS ? sw + (cg + groups * j) * pp.ldk + kk : sw + (kk + j) * ld + 4 * cg);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int r = rg + i * row_groups;
          float4 a = r < R ? *reinterpret_cast<const float4*>(in[p] + r * ld + k0 + kk)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
          if (!TRANS) a = operand4(a);  // dY, a cotangent, stays as it is
          float4& o = acc[i];
          if (TRANS) {
            o.x = fmaf(a.x, w[0].x, o.x); o.x = fmaf(a.y, w[0].y, o.x);
            o.x = fmaf(a.z, w[0].z, o.x); o.x = fmaf(a.w, w[0].w, o.x);
            o.y = fmaf(a.x, w[1].x, o.y); o.y = fmaf(a.y, w[1].y, o.y);
            o.y = fmaf(a.z, w[1].z, o.y); o.y = fmaf(a.w, w[1].w, o.y);
            o.z = fmaf(a.x, w[2].x, o.z); o.z = fmaf(a.y, w[2].y, o.z);
            o.z = fmaf(a.z, w[2].z, o.z); o.z = fmaf(a.w, w[2].w, o.z);
            o.w = fmaf(a.x, w[3].x, o.w); o.w = fmaf(a.y, w[3].y, o.w);
            o.w = fmaf(a.z, w[3].z, o.w); o.w = fmaf(a.w, w[3].w, o.w);
          } else {
            fma4(o, a.x, w[0]);
            fma4(o, a.y, w[1]);
            fma4(o, a.z, w[2]);
            fma4(o, a.w, w[3]);
          }
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = rg + i * row_groups;
      if (r >= R) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col(j);
        const float a = TRANS ? operand((&acc[i].x)[j]) : (&acc[i].x)[j];
        float o;
        if (p > 0) {
          o = a + out[r * ld + c];
        } else {
          o = a + (e.bias != nullptr && (ALIGNED || c < d) ? __ldg(e.bias + c) : 0.f);
          if (e.relu) o = fmaxf(o, 0.f);
          if (e.mask != nullptr) o = drop(o, (mk[i] >> (8 * j)) & 0xffu, e.keep);
          if (e.gate != nullptr) o = e.gate[r * ld + c] > 0.f ? o : 0.f;
          if (e.res != nullptr) o += e.res[r * ld + c];
        }
        out[r * ld + c] = o;
      }
    }
  }
  pp.pending = next.w != nullptr;
}

}  // namespace
