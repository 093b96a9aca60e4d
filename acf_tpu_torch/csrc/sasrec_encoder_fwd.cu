// K2a — SASRec encoder forward for Hopper (sm_90a), at inference and in its
// training form.
//
// Replaces the TPU kernel `fwd_kernel` in acf_tpu/ops/sasrec_fused.py:225
// (entry `fused_encoder`): single head, with or without dropout, in compute
// dtype float32 or, built by csrc/sasrec_encoder_fwd_bf16.cu, bfloat16
// (the header's compute dtypes; C entry acf_sasrec_encoder_fwd_bf16).
// It computes exactly `encoder_math` of acf_tpu_torch/ops/sasrec_fused.py
// (the reference SASRecLayers.py:15-319 encoder): for each user window
// x [T, d] (√d-scaled item embeddings) and its ids mask,
//
//   x = (x + pos_emb[-T:]) * mask
//   per block:  q_in = LN1(x)
//               x    = q_in + causal key/query-masked softmax(q kᵀ/√d) v,
//                      q, k, v = q_in Wq + bq, q_in Wk + bk, q_in Wv + bv
//               x2   = LN2(x)
//               x    = LN3(relu(x2 W1 + b1) W2 + b2 + x2) * mask
//   out = LN_f(x)
//
// with LN(x) = gamma * (x - mean) / sqrt(var + 1e-8) + beta.
//
// Training form (acf_tpu/models/sasrec.py:299-318): with dropout masks
// (bool, drawn outside, in the JAX layout) a kept value is divided by keep
// and a dropped one is 0 after `+ pos_emb`, on the attention probabilities
// after the query masking, after the ReLU and after conv2 (before `+ x2`).
// With a `saved` workspace it also writes each block's input and LN_f's
// input, [num_blocks + 1, B, T, d], for K2b (sasrec_encoder_bwd.cu), which
// rematerialises one block at a time from them. At inference both are null
// and the launch does exactly what it did without them.
//
// Bound on an H100: operations. Per window row and block the five d x d
// products take 10 d² FLOP and the causal attention 2 (T+1) d on average
// (each query dots only keys j <= i), all float32 FMAs outside the tensor
// cores (67 TFLOP/s). At B=512, T=50, d=64, 2 blocks that is 2.43 GFLOP,
// 0.036 ms, while the bytes (x in, out, mask, 164 KB of weights: 13 MB) take
// 0.004 ms at 3.35 TB/s. TF32 would move rank positions, so the tensor cores
// are not used. The dropout form reads 3 nb + 1 byte masks of [T, d] and nb
// of [T, T] per user (10.8 MB at T=50) and the training form writes
// (nb + 1) B T d floats more (19.7 MB): 0.013 ms at 3.35 TB/s, still below
// the operations.
//
// Design (plain fp32 FMAs, no TF32, no fast math). A block is a chain of
// some fifteen short phases between barriers, each bound by latency more
// than by FMAs or bytes, so the design keeps device memory out of the
// phases, gives each warp two rows' independent work where a phase is a row
// a warp, and gives each launch the registers its occupancy allows
// (tools/k2a_ablation.py times each choice against the kernel before it):
//   * One block per user, or per group of users holding ~16 rows when the
//     window is short (two at T=8, so B=512 gives 256 blocks and every SM
//     work). 256 threads, 512 from 128 rows on or where 256 would leave a
//     thread more than 4 rows of a product. 128 registers a thread: two
//     256-thread blocks an SM, or one of 512 (three at 80 registers spilled
//     and were slower). Blocks share nothing: no atomics, and two calls give
//     the same bits.
//   * Shared memory: four [rows][ld] f32 buffers (x, q, k, v), two weight
//     slots and the ids mask as bytes. Every d x d product streams its
//     weight through the slots with cp.async (the header's product, shared
//     with K2b): the whole weight at d <= 64 (32 rows at d = 128) where the
//     slots fit beside the buffers at the block's occupancy, narrower
//     k-slices at the widest windows (24 rows at T=200, d=64; 4 at T=108,
//     d=128), one slice ahead and across products. So the next product's
//     weight flies during this one, W1's during the attention and LN2, the
//     next block's Wq during LN3, and the first block's Wq during the input
//     load. Each k-step reads 16-byte units of shared memory. A thread owns
//     1, 2, 4 or 8 rows (the fewest that cover the block in one pass; the
//     kernel is built for each, so its five products are inlined with their
//     tile) x 4 columns and sums k in order; the dropout mask's 4 bytes of
//     each of its rows are read in one word before the k loop.
//   * Attention: one warp per pair of a user's rows; one read of each key
//     row serves both rows' dots (four independent FMA chains a row; the
//     dots for j > i are never computed; masked keys get a score of -inf and
//     no dot), and lane l holds the scores of keys l, l + 32, ... (T <= 224)
//     in registers, so no score row takes shared memory. The weights (the
//     probability's dropout byte applied where the weight is formed) then go
//     through the pair's q rows, spent by then, up to 64 keys at a time, and
//     multiply v four keys a step, one read of each value row for both rows.
//     A masked query is skipped: the reference's masked probabilities are
//     exact zeros, so its output is q_in.
//   * LayerNorm: two rows a warp, a half-warp a row, 16-byte units, the
//     moments by half-warp sums (ln_pairs). The saved block inputs are
//     written by the LayerNorm that already reads them (LN1, and LN_f for
//     its own input) as 16-byte units; LN3 applies the ids mask.
//   * Any width d <= 128 (the header's widths): d % 4 == 0 with 16-byte
//     aligned x, out, saved and weights, and a 4-byte aligned embedding mask,
//     takes the ALIGNED build, as above; any other width or alignment takes
//     a build that stages rows of pad4(d) floats with 4-byte copies, zero
//     tails, and LayerNorm moments over the d real columns (the C entry
//     chooses, from the pointers). The attention's dots run over pad4(d)
//     columns as they are, adding the tails' zeros.
// Requires d <= 128 and T <= 224. Later work: q, k and v in one pass over
// q_in, a layout of several users a 512-thread block at T=50, skipping
// masked rows, multi-head windows.

#include "sasrec_encoder.cuh"

namespace {

constexpr int kMaxKeysPerLane = 7;  // an attention row's scores a lane holds: T <= 224
constexpr int kUnitsPerLane = 2;    // a LayerNorm row's 16-byte units a lane holds: d <= 128

__device__ __forceinline__ float half_sum(float v) {  // over the lanes of a half-warp
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// FWD_MAX_ROWS in ops/sasrec_fused.py: the rows of a product's register tile
// at most, and FWD_BLOCKS_AN_SM: the blocks an SM that the registers of a
// thread allow (128 a thread: two 256-thread blocks, or one of 512).
constexpr int fwd_max_rows(int threads) { return threads == 256 ? 4 : 8; }
constexpr int fwd_blocks_an_sm(int threads) { return threads == 256 ? 2 : 1; }

// K2a's shared memory for a block of `rows` rows with weight slices of `ks`
// rows: four [rows][ld] buffers, two [ks][ld] slots, the ids mask as bytes
// (`_fwd_bytes` in ops/sasrec_fused.py).
size_t fwd_smem_bytes(int rows, int d, int ks) {
  return (4 * static_cast<size_t>(rows) + 2 * static_cast<size_t>(ks)) * row_ld(pad4(d)) *
             sizeof(float) +
         (static_cast<size_t>(rows) + 3) / 4 * 4;
}

// The slice rows ks (a multiple of 4, 4 <= ks <= pad4(d)) for which `smem_bytes`
// is fwd_smem_bytes(rows, d, ks), or 0 if there is none. The wrapper's
// layout chooses ks (`_fwd_slice`); the bytes carry it.
int fwd_slice_of(int smem_bytes, int rows, int d) {
  const size_t base = fwd_smem_bytes(rows, d, 0);
  const size_t four = fwd_smem_bytes(rows, d, 4) - base;  // both slots' bytes a 4 rows
  if (smem_bytes <= 0 || static_cast<size_t>(smem_bytes) < base + four) return 0;
  const size_t extra = static_cast<size_t>(smem_bytes) - base;
  const size_t ks = extra / four * 4;
  return extra % four == 0 && ks <= static_cast<size_t>(pad4(d)) ? static_cast<int>(ks) : 0;
}

// The rows of a product's register tile that a launch needs: the fewest of
// 1, 2, 4, 8 (up to fwd_max_rows) whose tiles cover `rows` in one pass (0:
// none does).
int fwd_tile_rows(int rows, int d, int threads) {
  const int row_groups = threads / (pad4(d) / 4);
  for (int r = 1; r <= fwd_max_rows(threads); r *= 2)
    if (rows <= r * row_groups) return r;
  return 0;
}

// The columns c0 + j < d of v to dst[c0 + j] (4-byte stores): a unit of a
// row of width d % 4 != 0, or of an unaligned row.
__device__ __forceinline__ void store_cols(float* dst, int c0, float4 v, int d) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c0 + j < d) dst[c0 + j] = (&v.x)[j];
}

// The columns c0 + j < d of src (4-byte loads), zero past d.
__device__ __forceinline__ float4 load_cols(const float* src, int c0, int d) {
  float4 v;
#pragma unroll
  for (int j = 0; j < 4; ++j) (&v.x)[j] = c0 + j < d ? __ldg(src + c0 + j) : 0.f;
  return v;
}

// dst[r] = LN(src[r]) for rows r < R, times M[r] where M is given (0/1
// bytes): src rows [R][ld] in shared memory, dst rows of stride dld in
// shared memory (may alias src) or device memory; with `copy`, src[r] is
// also copied to rows of stride cld in device memory. Two rows a warp, one a
// half-warp: a lane holds up to kUnitsPerLane 16-byte units of its row, and
// the moments are sums over the half-warp. Without ALIGNED the units run to
// pad4(d), the moments leave the tail out, and only the d real columns are
// written (a shared dst's tail keeps its zeros).
template <bool ALIGNED>
__device__ void ln_pairs(const float* src, float* copy, int cld, float* dst, int dld,
                         LayerNormW p, const unsigned char* M, int R, int d, int ld) {
  const int hl = threadIdx.x & 15;           // lane in the half-warp
  const int h = (threadIdx.x >> 4) & 1;      // the warp's half
  const int units = (ALIGNED ? d : pad4(d)) / 4;
  const int warps = blockDim.x >> 5;
  for (int r0 = 2 * (threadIdx.x >> 5); r0 < R; r0 += 2 * warps) {
    const int r = r0 + h;
    const bool live = r < R;  // both halves take part in the sums
    float4 v[kUnitsPerLane];
    float s = 0.f;
#pragma unroll
    for (int m = 0; m < kUnitsPerLane; ++m) {
      const int u = hl + 16 * m;
      v[m] = live && u < units ? *reinterpret_cast<const float4*>(src + r * ld + 4 * u)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      s += (v[m].x + v[m].y) + (v[m].z + v[m].w);
      if (copy != nullptr && live && u < units) {
        if (ALIGNED)
          *reinterpret_cast<float4*>(copy + r * cld + 4 * u) = v[m];
        else
          store_cols(copy + r * cld, 4 * u, v[m], d);
      }
    }
    const float mean = half_sum(s) / d;
    float q = 0.f;
#pragma unroll
    for (int m = 0; m < kUnitsPerLane; ++m) {
      if (hl + 16 * m >= units) continue;
      float4 c = make_float4(v[m].x - mean, v[m].y - mean, v[m].z - mean, v[m].w - mean);
      if (!ALIGNED) c = make_float4(c.x, 4 * (hl + 16 * m) + 1 < d ? c.y : 0.f,
                                    4 * (hl + 16 * m) + 2 < d ? c.z : 0.f,
                                    4 * (hl + 16 * m) + 3 < d ? c.w : 0.f);  // the tail: no moment
      q = fmaf(c.x, c.x, q); q = fmaf(c.y, c.y, q); q = fmaf(c.z, c.z, q); q = fmaf(c.w, c.w, q);
    }
    const float denom = sqrtf(half_sum(q) / d + kEps);
    if (!live) continue;
    const float keep = M == nullptr ? 1.f : static_cast<float>(M[r]);
#pragma unroll
    for (int m = 0; m < kUnitsPerLane; ++m) {
      const int u = hl + 16 * m;
      if (u >= units) continue;
      const float4 g = ALIGNED ? ldg4(p.gamma + 4 * u) : load_cols(p.gamma, 4 * u, d);
      const float4 b = ALIGNED ? ldg4(p.beta + 4 * u) : load_cols(p.beta, 4 * u, d);
      const float4 y = make_float4((g.x * (v[m].x - mean) / denom + b.x) * keep,
                                   (g.y * (v[m].y - mean) / denom + b.y) * keep,
                                   (g.z * (v[m].z - mean) / denom + b.z) * keep,
                                   (g.w * (v[m].w - mean) / denom + b.w) * keep);
      if (ALIGNED)
        *reinterpret_cast<float4*>(dst + r * dld + 4 * u) = y;
      else
        store_cols(dst + r * dld, 4 * u, y, d);
    }
  }
}

// x[r] += Σ_j drop_p(p_rj) v_j over the keys j <= r of row r's user whose
// mask M is set, p_r = softmax_j(q_r·k_j / √d), dropped with `pm` (the
// block's [R][T] prob-mask rows in device memory, or null) after the query
// masking; x holds q_in (the residual). One warp per pair of a user's rows
// (ia, ia + 1; the second absent when T is odd), so one read of each key
// row serves both rows' dots and one read of each value row both sums. Lane
// l holds the scores of keys l + 32 m of both rows in registers; the weights
// then go through the rows of q, spent once the scores are formed, up to 64
// keys at a time. KEYS: the keys a lane holds a row (T <= 32 KEYS), so the
// loops over them are unrolled only as far as the window needs. q, k, v and
// the weights are read through `attn_operand` (the bfloat16 form's rounding
// from T = kMxuAttnT on).
template <int KEYS>
__device__ void attention_rows(float* q, const float* k, const float* v, float* x,
                               const unsigned char* M, int R, int T, int d, int ld,
                               const unsigned char* pm, float keep) {
  const int lane = threadIdx.x & 31;
  const float scale = sqrtf(static_cast<float>(d));
  const int chunk = ld < 64 ? ld : 64;  // keys whose weights a row of q holds at once
  const int half = (T + 1) / 2;          // row pairs of a user
  const int pairs = R / T * half;
  for (int pr = threadIdx.x >> 5; pr < pairs; pr += blockDim.x >> 5) {
    const int u0 = pr / half * T;        // the user's first row
    const int ia = pr % half * 2, ib = ia + 1;
    const int ra = u0 + ia, rb = u0 + ib;
    const bool la = M[ra] != 0, lb = ib < T && M[rb] != 0;  // the rows that attend
    if (!la && !lb) continue;  // masked queries: probabilities are exact zeros
    const int i = lb ? ib : ia;  // the last key either row takes
    float* qa = q + (la ? ra : rb) * ld;  // q rows; a row that does not attend
    float* qb = q + (lb ? rb : ra) * ld;  // takes the other's (rb may be past R)
    float sa[KEYS], sb[KEYS];
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int m = 0; m < KEYS; ++m) {
      sa[m] = sb[m] = -INFINITY;  // a masked key: weight exactly 0, as -2^32+1 gives
      const int j = lane + 32 * m;
      if (32 * m > i) continue;  // no key of this lane's m-th set is causal
      if (j <= i && M[u0 + j] != 0) {
        const float* kr = k + (u0 + j) * ld;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // four independent chains a row
        float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll 2
        for (int c = 0; c < d; c += 4) {
          const float4 y = attn_operand4(*reinterpret_cast<const float4*>(kr + c), T);
          const float4 xa = attn_operand4(*reinterpret_cast<const float4*>(qa + c), T);
          const float4 xb = attn_operand4(*reinterpret_cast<const float4*>(qb + c), T);
          a0 = fmaf(xa.x, y.x, a0); a1 = fmaf(xa.y, y.y, a1);
          a2 = fmaf(xa.z, y.z, a2); a3 = fmaf(xa.w, y.w, a3);
          b0 = fmaf(xb.x, y.x, b0); b1 = fmaf(xb.y, y.y, b1);
          b2 = fmaf(xb.z, y.z, b2); b3 = fmaf(xb.w, y.w, b3);
        }
        if (la && j <= ia) sa[m] = ((a0 + a1) + (a2 + a3)) / scale;
        if (lb) sb[m] = ((b0 + b1) + (b2 + b3)) / scale;
      }
      mxa = fmaxf(mxa, sa[m]);
      mxb = fmaxf(mxb, sb[m]);
    }
    mxa = warp_max(mxa);  // finite for an attending row: its own key is unmasked
    mxb = warp_max(mxb);
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int m = 0; m < KEYS; ++m) {
      if (32 * m > i) continue;
      sa[m] = la ? expf(sa[m] - mxa) : 0.f;  // 0 past the diagonal and for masked keys
      sb[m] = lb ? expf(sb[m] - mxb) : 0.f;
      suma += sa[m];
      sumb += sb[m];
    }
    suma = warp_sum(suma);  // every lane is done with both rows of q
    sumb = warp_sum(sumb);
#pragma unroll
    for (int m = 0; m < KEYS; ++m) {
      if (32 * m > i) continue;
      if (la) sa[m] /= suma;
      if (lb) sb[m] /= sumb;
      if (pm != nullptr) {
        const int j = lane + 32 * m;
        sa[m] = drop(sa[m], la && j <= ia ? pm[static_cast<size_t>(ra) * T + j] : 0, keep);
        sb[m] = drop(sb[m], lb && j <= ib ? pm[static_cast<size_t>(rb) * T + j] : 0, keep);
      }
    }
    float acca[kMaxColsPerLane], accb[kMaxColsPerLane];  // keys 4s, 4s + 2, then the tail
    float odda[kMaxColsPerLane], oddb[kMaxColsPerLane];  // keys 4s + 1, 4s + 3
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) acca[c] = accb[c] = odda[c] = oddb[c] = 0.f;
    for (int c0 = 0; c0 <= i; c0 += chunk) {
#pragma unroll
      for (int m = 0; m < KEYS; ++m) {
        const int j = lane + 32 * m;
        if (j >= c0 && j < c0 + chunk && j <= i) {  // a row that does not attend
          if (la) qa[j - c0] = attn_operand(sa[m], T);  // shares the other's q row
          if (lb) qb[j - c0] = attn_operand(sb[m], T);  // and sums weights it never adds
        }
      }
      __syncwarp();
      const int n = min(chunk, i + 1 - c0);  // causal keys of this chunk
      const float* vr = v + (u0 + c0) * ld + lane;
      int j = 0;
#pragma unroll 2
      for (; j + 4 <= n; j += 4) {  // four keys a step: their loads overlap
        const float4 pa = *reinterpret_cast<const float4*>(qa + j);
        const float4 pb = *reinterpret_cast<const float4*>(qb + j);
        if (pa.x == 0.f && pa.y == 0.f && pa.z == 0.f && pa.w == 0.f && pb.x == 0.f &&
            pb.y == 0.f && pb.z == 0.f && pb.w == 0.f)
          continue;  // padding
        const float* vj = vr + j * ld;
#pragma unroll
        for (int c = 0; c < kMaxColsPerLane; ++c) {
          if (lane + 32 * c >= d) continue;
          const float v0 = attn_operand(vj[32 * c], T), v1 = attn_operand(vj[ld + 32 * c], T);
          const float v2 = attn_operand(vj[2 * ld + 32 * c], T);
          const float v3 = attn_operand(vj[3 * ld + 32 * c], T);
          acca[c] = fmaf(pa.z, v2, fmaf(pa.x, v0, acca[c]));
          odda[c] = fmaf(pa.w, v3, fmaf(pa.y, v1, odda[c]));
          accb[c] = fmaf(pb.z, v2, fmaf(pb.x, v0, accb[c]));
          oddb[c] = fmaf(pb.w, v3, fmaf(pb.y, v1, oddb[c]));
        }
      }
      for (; j < n; ++j) {
        const float pa = qa[j], pb = qb[j];
        const float* vj = vr + j * ld;
#pragma unroll
        for (int c = 0; c < kMaxColsPerLane; ++c) {
          if (lane + 32 * c >= d) continue;
          const float vv = attn_operand(vj[32 * c], T);
          acca[c] = fmaf(pa, vv, acca[c]);
          accb[c] = fmaf(pb, vv, accb[c]);
        }
      }
      __syncwarp();  // the next chunk rewrites both rows of q
    }
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) {
      if (lane + 32 * c >= d) continue;
      if (la) x[ra * ld + lane + 32 * c] += acca[c] + odda[c];
      if (lb) x[rb * ld + lane + 32 * c] += accb[c] + oddb[c];
    }
  }
}

// X[r] = drop_emb(x[r] + pos[r % T]) * mask[r] for the block's rows r < R
// (x, pos and the embedding mask `emb` at the block's first row, or null),
// [R][ld] in shared memory. Without ALIGNED, 4-byte loads and a zero tail
// up to pad4(d). Out of line: inlined, its registers tip the 8-row tile's
// build into spilling.
template <bool ALIGNED>
__device__ __noinline__ void load_input(float* X, const float* x, const float* pos,
                                        const unsigned char* emb, const unsigned char* mask,
                                        float keep_p, int R, int T, int d, int ld) {
  if (!ALIGNED) {
    const int dp = pad4(d);
    for (int idx = threadIdx.x; idx < R * dp; idx += blockDim.x) {
      const int r = idx / dp, c = idx % dp;
      float v = 0.f;
      if (c < d && mask[r]) {
        v = __ldg(x + r * d + c) + __ldg(pos + (r % T) * d + c);
        if (emb != nullptr) v = drop(v, emb[r * d + c], keep_p);
      }
      X[r * ld + c] = v;
    }
    return;
  }
  const int groups = d / 4;
  for (int idx = threadIdx.x; idx < R * groups; idx += blockDim.x) {
    const int r = idx / groups, c = (idx % groups) * 4;
    const float4 a = ldg4(x + r * d + c);
    const float4 e = ldg4(pos + (r % T) * d + c);
    float4 v = make_float4(a.x + e.x, a.y + e.y, a.z + e.z, a.w + e.w);
    if (emb != nullptr) {
      const uchar4 m = *reinterpret_cast<const uchar4*>(emb + r * d + c);
      v = make_float4(drop(v.x, m.x, keep_p), drop(v.y, m.y, keep_p),
                      drop(v.z, m.z, keep_p), drop(v.w, m.w, keep_p));
    }
    const float keep = mask[r] ? 1.f : 0.f;
    *reinterpret_cast<float4*>(X + r * ld + c) =
        make_float4(v.x * keep, v.y * keep, v.z * keep, v.w * keep);
  }
}

// ROWS rows in a thread's product tile (fwd_tile_rows), THREADS threads a
// block and the registers that fwd_blocks_an_sm(THREADS) blocks an SM allow;
// ALIGNED: the header's width paths.
template <int ROWS, int THREADS, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, fwd_blocks_an_sm(THREADS))
sasrec_encoder_fwd_kernel(const EncoderW w, const DropoutMasks dm, const float* __restrict__ x,
                          const unsigned char* __restrict__ ids_mask,
                          float* __restrict__ out, float* __restrict__ saved, int B, int T,
                          int d, int users_per_block, int ld, int ks) {
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * users_per_block;
  const int R = min(users_per_block, B - b0) * T;  // this block's rows
  const int rows = users_per_block * T;            // rows each buffer holds
  float* X = smem;              // x; q_in; the attention output; x2; the block output
  float* Q = X + rows * ld;     // q; the FFN hidden
  float* K = Q + rows * ld;     // k; the FFN sum before LN3
  float* V = K + rows * ld;     // v
  float* SW = V + rows * ld;    // two [ks][ld] weight slots
  unsigned char* M = reinterpret_cast<unsigned char*>(SW + 2 * ks * ld);  // [rows] ids mask
  const size_t row0 = static_cast<size_t>(b0) * T;  // first global row
  const size_t plane = static_cast<size_t>(B) * T;  // rows of one [B, T, d] of `saved`
  const int nb = w.num_blocks;
  Pipe pp{SW, ks * ld, 0, false, ks, 0};
  if (nb > 0) {  // the first product's weight flies during the input load
    stage_slice<ALIGNED>(pp.at(0), WRef{w.blocks[0].wq.w, false}, 0, pp, d, ld);
    pp.pending = true;
  }

  const unsigned char* mask = ids_mask + row0;
  for (int r = threadIdx.x; r < R; r += blockDim.x) M[r] = mask[r] != 0;
  load_input<ALIGNED>(X, x + row0 * d, w.pos, dm.emb == nullptr ? nullptr : dm.emb + row0 * d,
                      mask, dm.keep, R, T, d, ld);
  __syncthreads();

  for (int blk = 0; blk < nb; ++blk) {
    const BlockW& p = w.blocks[blk];
    const size_t mrow = row0 * d;  // the block's first element of a [B, T, d] mask
    // q_in, in place; the block's input also goes to `saved` for K2b
    ln_pairs<ALIGNED>(X, saved == nullptr ? nullptr : saved + (blk * plane + row0) * d, d, X, ld,
                      p.ln1, nullptr, R, d, ld);
    // q, k, v; each product's weight slices stream in behind the one before
    product<ROWS, false, 1, ALIGNED>(pp, {X}, {p.wq.w}, WRef{p.wk.w, false}, Q, epi(p.wq.b), R,
                                     d, ld);
    product<ROWS, false, 1, ALIGNED>(pp, {X}, {p.wk.w}, WRef{p.wv.w, false}, K, epi(p.wk.b), R,
                                     d, ld);
    product<ROWS, false, 1, ALIGNED>(pp, {X}, {p.wv.w}, WRef{p.conv1.w, false}, V, epi(p.wv.b),
                                     R, d, ld);
    __syncthreads();
    const unsigned char* pm = dm.p[blk] == nullptr ? nullptr : dm.p[blk] + row0 * T;
    if (T <= 64)
      attention_rows<2>(Q, K, V, X, M, R, T, d, ld, pm, dm.keep);
    else
      attention_rows<kMaxKeysPerLane>(Q, K, V, X, M, R, T, d, ld, pm, dm.keep);
    __syncthreads();
    ln_pairs<ALIGNED>(X, nullptr, 0, X, ld, p.ln2, nullptr, R, d, ld);  // x2, in place
    product<ROWS, false, 1, ALIGNED>(
        pp, {X}, {p.conv1.w}, WRef{p.conv2.w, false}, Q,
        epi(p.conv1.b, true, dm.f1[blk] == nullptr ? nullptr : dm.f1[blk] + mrow, dm.keep), R, d,
        ld);  // the FFN hidden
    product<ROWS, false, 1, ALIGNED>(
        pp, {Q}, {p.conv2.w}, WRef{blk + 1 < nb ? w.blocks[blk + 1].wq.w : nullptr, false}, K,
        epi(p.conv2.b, false, dm.f2[blk] == nullptr ? nullptr : dm.f2[blk] + mrow, dm.keep,
            nullptr, X),
        R, d, ld);  // the FFN sum, + x2
    __syncthreads();
    ln_pairs<ALIGNED>(K, nullptr, 0, X, ld, p.ln3, M, R, d, ld);  // the block's output
    __syncthreads();
  }
  // out = LN_f(x); LN_f's input also goes to `saved`
  ln_pairs<ALIGNED>(X, saved == nullptr ? nullptr : saved + (nb * plane + row0) * d, d,
                    out + row0 * d, d, w.ln_f, nullptr, R, d, ld);
}

using Kernel = decltype(&sasrec_encoder_fwd_kernel<1, 256, true>);

// The build of the kernel for a launch's threads and tile rows.
template <bool ALIGNED>
Kernel fwd_kernel(int threads, int tile) {
  if (threads == 256)
    return tile == 1   ? &sasrec_encoder_fwd_kernel<1, 256, ALIGNED>
           : tile == 2 ? &sasrec_encoder_fwd_kernel<2, 256, ALIGNED>
                       : &sasrec_encoder_fwd_kernel<4, 256, ALIGNED>;
  return tile == 1   ? &sasrec_encoder_fwd_kernel<1, kMaxThreads, ALIGNED>
         : tile == 2 ? &sasrec_encoder_fwd_kernel<2, kMaxThreads, ALIGNED>
         : tile == 4 ? &sasrec_encoder_fwd_kernel<4, kMaxThreads, ALIGNED>
                     : &sasrec_encoder_fwd_kernel<8, kMaxThreads, ALIGNED>;
}

}  // namespace

// Writes out [B, T, d] (and, when `saved` is not null, the block inputs
// [num_blocks + 1, B, T, d]) on `stream`. `users_per_block`, `threads` and
// `smem_bytes` come from the wrapper's layout (ops/sasrec_fused.py
// `_layout`); a launch whose bytes are not this file's formula for any
// slice, whose rows a product's register tile cannot cover, or that exceeds
// the device's limit, is refused. Returns the cudaError_t of the launch.
extern "C" int ENCODER_ENTRY(acf_sasrec_encoder_fwd)(EncoderW w, DropoutMasks dm, const float* x,
                                                     const unsigned char* ids_mask, float* out,
                                                     float* saved, int B, int T, int d,
                                                     int users_per_block, int threads,
                                                     int smem_bytes, void* stream) {
  if (B <= 0 || T <= 0 || T > 32 * kMaxKeysPerLane || d <= 0 ||
      d > 32 * kMaxColsPerLane || users_per_block <= 0 ||
      (threads != 256 && threads != kMaxThreads) || w.num_blocks < 0 ||
      w.num_blocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  const int rows = users_per_block * T;
  const int tile = fwd_tile_rows(rows, d, threads);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const int ks = fwd_slice_of(smem_bytes, rows, d);
  if (ks == 0) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem_bytes > optin) return (int)cudaErrorInvalidValue;
  const bool aligned = weights_aligned(w, d) && aligned16(x) && aligned16(out) &&
                       (saved == nullptr || aligned16(saved)) &&
                       reinterpret_cast<size_t>(dm.emb) % 4 == 0;
  const Kernel kernel =
      aligned ? fwd_kernel<true>(threads, tile) : fwd_kernel<false>(threads, tile);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + users_per_block - 1) / users_per_block;
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      w, dm, x, ids_mask, out, saved, B, T, d, users_per_block, row_ld(pad4(d)), ks);
  return (int)cudaGetLastError();
}
