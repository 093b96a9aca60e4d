// Shared by K2a (sasrec_encoder_fwd.cu) and K2b (sasrec_encoder_bwd.cu): the
// structs the wrappers pass by value, the small helpers, the products'
// epilogue, and K2a's per-block device steps of the SASRec encoder
// (LayerNorm rows, register-tiled d x d products, causal attention rows;
// K2b has copies of its own). Every step works on [rows][ld] f32 buffers in
// shared memory, rows padded to an odd number of 16-byte units. The Wᵀ
// products (TRANS), `attention_rows`' P and `block_forward`'s `keep_all`
// served the earlier K2b and are unused now.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

constexpr int kMaxBlocks = 8;  // ENCODER_MAX_BLOCKS in ops/_build.py

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
constexpr float kEps = 1e-8f;

inline int row_ld(int d) { return 4 * ((d / 4) | 1); }  // odd number of 16-byte units
inline int score_ld(int T) { return (T + 3) / 4 * 4; }   // 16-byte aligned score rows

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

// where(m, v / keep, 0): the JAX package's inverted dropout (a division).
__device__ __forceinline__ float drop(float v, unsigned char m, float keep) {
  return m ? v / keep : 0.f;
}

// dst[r] = LN(src[r]) (* M[r] when M is given) for rows r < R; one warp per
// row. dst may alias src, or be device memory with row stride dld.
__device__ void layer_norm_rows(const float* src, float* dst, int dld, LayerNormW p,
                                const float* M, int R, int d, int ld) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
    float v[kMaxColsPerLane];
    float s = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxColsPerLane; ++m) {
      const int c = lane + 32 * m;
      v[m] = c < d ? src[r * ld + c] : 0.f;
      s += v[m];
    }
    const float mean = warp_sum(s) / d;
    float q = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxColsPerLane; ++m) {
      const float dv = v[m] - mean;
      if (lane + 32 * m < d) q = fmaf(dv, dv, q);
    }
    const float denom = sqrtf(warp_sum(q) / d + kEps);
    const float keep = M == nullptr ? 1.f : M[r];
#pragma unroll
    for (int m = 0; m < kMaxColsPerLane; ++m) {
      const int c = lane + 32 * m;
      if (c < d)
        dst[r * dld + c] = (__ldg(p.gamma + c) * (v[m] - mean) / denom + __ldg(p.beta + c)) * keep;
    }
  }
}

// What a d x d product does to its sum, in this order: add `bias`; relu;
// dropout with `mask` (rows [R][d] in device memory); zero where `gate`
// ([R][ld], may alias the output) is <= 0 (relu's backward); add `res`
// ([R][ld], may alias the output). Each pointer may be null.
struct Epilogue {
  const float* bias;
  bool relu;
  const unsigned char* mask;
  float keep;
  const float* gate;
  const float* res;
};

__device__ __forceinline__ void fma4(float4& o, float a, float4 w) {
  o.x = fmaf(a, w.x, o.x); o.y = fmaf(a, w.y, o.y);
  o.z = fmaf(a, w.z, o.z); o.w = fmaf(a, w.w, o.w);
}

// out[r] = epilogue(in[r] W) for rows r < R, all [R][ld] in shared memory;
// W is [d, d] row-major in device memory, read as W (TRANS false) or Wᵀ
// (TRANS true: the backward's dY Wᵀ). Each thread owns ROWS rows
// (r0 + i * row_groups) x 4 columns and sums k in order with fp32 FMAs.
template <int ROWS, bool TRANS>
__device__ void dense_tiles(const float* in, float* out, const float* W, Epilogue e,
                            int R, int d, int ld) {
  const int groups = d / 4;  // 4-column groups
  const int row_groups = blockDim.x / groups;
  const int cg = threadIdx.x % groups;
  const int rg = threadIdx.x / groups;
  if (rg >= row_groups) return;  // idle when groups does not divide the block
  const int c0 = 4 * cg;
  const float4 bias = e.bias != nullptr ? ldg4(e.bias + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = rg; r0 < R; r0 += ROWS * row_groups) {
    float4 acc[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < d; k += 4) {
      float4 w0, w1, w2, w3;  // W[k + i][c0..c0+3], i = 0..3
      if (TRANS) {             // from Wᵀ: rows c0..c0+3 of W, columns k..k+3
        const float4 a = ldg4(W + (c0 + 0) * d + k);
        const float4 b = ldg4(W + (c0 + 1) * d + k);
        const float4 c = ldg4(W + (c0 + 2) * d + k);
        const float4 f = ldg4(W + (c0 + 3) * d + k);
        w0 = make_float4(a.x, b.x, c.x, f.x);
        w1 = make_float4(a.y, b.y, c.y, f.y);
        w2 = make_float4(a.z, b.z, c.z, f.z);
        w3 = make_float4(a.w, b.w, c.w, f.w);
      } else {
        w0 = ldg4(W + (k + 0) * d + c0);
        w1 = ldg4(W + (k + 1) * d + c0);
        w2 = ldg4(W + (k + 2) * d + c0);
        w3 = ldg4(W + (k + 3) * d + c0);
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = r0 + i * row_groups;
        const float4 a = r < R ? *reinterpret_cast<const float4*>(in + r * ld + k)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        fma4(acc[i], a.x, w0);
        fma4(acc[i], a.y, w1);
        fma4(acc[i], a.z, w2);
        fma4(acc[i], a.w, w3);
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = r0 + i * row_groups;
      if (r >= R) break;
      float4 o = make_float4(acc[i].x + bias.x, acc[i].y + bias.y,
                             acc[i].z + bias.z, acc[i].w + bias.w);
      if (e.relu) {
        o.x = fmaxf(o.x, 0.f); o.y = fmaxf(o.y, 0.f);
        o.z = fmaxf(o.z, 0.f); o.w = fmaxf(o.w, 0.f);
      }
      if (e.mask != nullptr) {
        const uchar4 m = *reinterpret_cast<const uchar4*>(e.mask + static_cast<size_t>(r) * d + c0);
        o.x = drop(o.x, m.x, e.keep); o.y = drop(o.y, m.y, e.keep);
        o.z = drop(o.z, m.z, e.keep); o.w = drop(o.w, m.w, e.keep);
      }
      if (e.gate != nullptr) {
        const float4 gt = *reinterpret_cast<const float4*>(e.gate + r * ld + c0);
        o.x = gt.x > 0.f ? o.x : 0.f; o.y = gt.y > 0.f ? o.y : 0.f;
        o.z = gt.z > 0.f ? o.z : 0.f; o.w = gt.w > 0.f ? o.w : 0.f;
      }
      if (e.res != nullptr) {
        const float4 s = *reinterpret_cast<const float4*>(e.res + r * ld + c0);
        o.x += s.x; o.y += s.y; o.z += s.z; o.w += s.w;
      }
      *reinterpret_cast<float4*>(out + r * ld + c0) = o;
    }
  }
}

// The register tile with the fewest rows that still covers R in one pass
// (up to 4 rows; more rows take more passes).
template <bool TRANS = false>
__device__ void dense_rows(const float* in, float* out, const float* W, Epilogue e,
                           int R, int d, int ld) {
  const int row_groups = blockDim.x / (d / 4);
  if (R <= row_groups)
    dense_tiles<1, TRANS>(in, out, W, e, R, d, ld);
  else if (R <= 2 * row_groups)
    dense_tiles<2, TRANS>(in, out, W, e, R, d, ld);
  else
    dense_tiles<4, TRANS>(in, out, W, e, R, d, ld);
}

__device__ __forceinline__ Epilogue epi(const float* bias = nullptr, bool relu = false,
                                        const unsigned char* mask = nullptr,
                                        float keep = 1.f, const float* gate = nullptr,
                                        const float* res = nullptr) {
  return Epilogue{bias, relu, mask, keep, gate, res};
}

// x[r] += Σ_j p_rj v_j over the keys j <= r of row r's user whose mask M is
// set, p_r = softmax_j(q_r·k_j / √d), dropped with `pm` (the block's [R][T]
// prob-mask rows in device memory, or null) after the query masking; x holds
// q_in (the residual). One warp per row; `scores` holds one row of Ts floats
// per warp. With `P` ([R][Ts]), row r's probabilities before the dropout
// (0 for masked keys) are kept there too, for the backward.
__device__ void attention_rows(const float* q, const float* k, const float* v, float* x,
                               float* scores, const float* M, int R, int T, int Ts, int d,
                               int ld, const unsigned char* pm, float keep, float* P) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float scale = sqrtf(static_cast<float>(d));
  float* s = scores + warp * Ts;
  for (int r = warp; r < R; r += blockDim.x >> 5) {
    if (M[r] == 0.f) continue;  // masked query: probabilities are exact zeros
    const int i = r % T;        // position in the window
    const int u0 = r - i;       // the user's first row
    const float* qr = q + r * ld;
    float m = -INFINITY;
    for (int j = lane; j <= i; j += 32) {
      float dot = -INFINITY;  // a masked key: weight exactly 0, as -2^32+1 gives
      if (M[u0 + j] != 0.f) {
        const float* kr = k + (u0 + j) * ld;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // four independent chains
        for (int c = 0; c < d; c += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + c);
          const float4 b = *reinterpret_cast<const float4*>(kr + c);
          a0 = fmaf(a.x, b.x, a0);
          a1 = fmaf(a.y, b.y, a1);
          a2 = fmaf(a.z, b.z, a2);
          a3 = fmaf(a.w, b.w, a3);
        }
        dot = ((a0 + a1) + (a2 + a3)) / scale;
      }
      s[j] = dot;
      m = fmaxf(m, dot);
    }
    m = warp_max(m);  // finite: key i is unmasked because query i is
    float sum = 0.f;
    for (int j = lane; j <= i; j += 32) {
      const float e = expf(s[j] - m);
      s[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j <= i; j += 32) {
      float p = s[j] / sum;
      if (P != nullptr) P[r * Ts + j] = p;
      if (pm != nullptr) p = drop(p, pm[r * T + j], keep);
      s[j] = p;
    }
    __syncwarp();
    float acc[kMaxColsPerLane];
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) acc[c] = 0.f;
    int j = 0;
    for (; j + 4 <= i + 1; j += 4) {  // four keys a step: their loads overlap
      const float4 p4 = *reinterpret_cast<const float4*>(s + j);
      if (p4.x == 0.f && p4.y == 0.f && p4.z == 0.f && p4.w == 0.f) continue;  // padding
      const float* vr = v + (u0 + j) * ld + lane;
#pragma unroll
      for (int c = 0; c < kMaxColsPerLane; ++c) {
        if (lane + 32 * c >= d) continue;
        float t = acc[c];
        t = fmaf(p4.x, vr[32 * c], t);
        t = fmaf(p4.y, vr[ld + 32 * c], t);
        t = fmaf(p4.z, vr[2 * ld + 32 * c], t);
        t = fmaf(p4.w, vr[3 * ld + 32 * c], t);
        acc[c] = t;
      }
    }
    for (; j <= i; ++j) {
      const float pj = s[j];
      const float* vr = v + (u0 + j) * ld + lane;
#pragma unroll
      for (int c = 0; c < kMaxColsPerLane; ++c)
        if (lane + 32 * c < d) acc[c] = fmaf(pj, vr[32 * c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c)
      if (lane + 32 * c < d) x[r * ld + lane + 32 * c] += acc[c];
    __syncwarp();  // this warp's next row rewrites s
  }
}

// One encoder block forward on the rows of shared buffer X (its input, kept),
// through Q, K, V, into X (the output). With `keep_all` nothing is overwritten: QIN holds
// q_in, A the attention output, X2 the LN2 output, F1 the FFN hidden after
// its dropout, F the FFN sum before LN3, and P the softmax rows; X is then
// left as the block's input. Without it (K2a) QIN = A = X2 = X, F1 = Q and
// F = K, and X ends as the block's output (LN3(F) * M).
struct BlockBufs {
  float *X, *QIN, *Q, *K, *V, *A, *X2, *F1, *F, *P, *S;
  const float* M;
};

__device__ void block_forward(const BlockW& p, const BlockBufs& b, const unsigned char* pm,
                              const unsigned char* f1m, const unsigned char* f2m, float keep,
                              bool keep_all, int R, int T, int Ts, int d, int ld) {
  layer_norm_rows(b.X, b.QIN, ld, p.ln1, nullptr, R, d, ld);
  __syncthreads();
  dense_rows(b.QIN, b.Q, p.wq.w, epi(p.wq.b), R, d, ld);
  dense_rows(b.QIN, b.K, p.wk.w, epi(p.wk.b), R, d, ld);
  dense_rows(b.QIN, b.V, p.wv.w, epi(p.wv.b), R, d, ld);
  if (keep_all)  // A starts as q_in, the attention's residual
    for (int idx = threadIdx.x; idx < R * ld; idx += blockDim.x) b.A[idx] = b.QIN[idx];
  __syncthreads();
  attention_rows(b.Q, b.K, b.V, b.A, b.S, b.M, R, T, Ts, d, ld, pm, keep, b.P);
  __syncthreads();
  layer_norm_rows(b.A, b.X2, ld, p.ln2, nullptr, R, d, ld);
  __syncthreads();
  dense_rows(b.X2, b.F1, p.conv1.w, epi(p.conv1.b, true, f1m, keep), R, d, ld);
  __syncthreads();
  dense_rows(b.F1, b.F, p.conv2.w, epi(p.conv2.b, false, f2m, keep, nullptr, b.X2), R, d, ld);
  __syncthreads();
  if (!keep_all) {
    layer_norm_rows(b.F, b.X, ld, p.ln3, b.M, R, d, ld);
    __syncthreads();
  }
}

}  // namespace
