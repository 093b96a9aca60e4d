// K2b — SASRec encoder backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `bwd_kernel` in acf_tpu/ops/sasrec_fused.py:236
// (the custom VJP of `fused_encoder`, :279-328): single head, with or
// without dropout masks, in compute dtype float32 or, built by
// csrc/sasrec_encoder_bwd_bf16.cu, bfloat16 (the header's compute dtypes:
// the vjp of products with bfloat16 operands; C entries with the suffix
// _bf16). For one cotangent g [B, T, d] of the encoder's
// output it computes dx [B, T, d] and the gradients of pos_emb[-T:] and of
// every block leaf and ln_f, summed over users: exactly `encoder_bwd_math`
// of acf_tpu_torch/ops/sasrec_fused.py, whose docstrings derive each step
// (the TPU kernel took its backward from `jax.vjp` inside the kernel; here
// it is written out by hand). Per block, from the last:
//
//   dF   = LN3ᵀ(G * mask)               G: gradient of the block's output
//   dF2  = drop_f2(dF);  dW2 += F1ᵀ dF2  F1: the FFN hidden after dropout
//   dZ1  = [F1 > 0] drop_f1(dF2 W2ᵀ);  dW1 += X2ᵀ dZ1
//   dA   = LN2ᵀ(dF + dZ1 W1ᵀ)           the FFN residual onto x2
//   dV   = P'ᵀ dA;  dP = drop_p(dA Vᵀ)    P' the dropped probabilities
//   dS   = P ∘ (dP - rowsum(dP ∘ P))      softmax backward
//   dQ   = dS K / √d;  dK = dSᵀ Q / √d;  dWq += QINᵀ dQ (and K, V)
//   G    = LN1ᵀ(dA + dQ Wqᵀ + dK Wkᵀ + dV Wvᵀ)   the residual onto q_in
//
// then dx = drop_emb(G * mask) and dpos = Σ_users dx. LNᵀ(dy) is
// (dx̂ - mean(dx̂) - x̂ mean(dx̂ x̂)) / σ with dx̂ = γ dy, and it adds dy x̂ and
// dy to dγ and dβ. Masked queries and keys get exactly zero gradient (the
// reference's -2³²+1 underflows to a probability of exactly 0).
//
// Bound on an H100: operations. The backward's own work per row and block
// is ten d x d products (five dY Wᵀ, five Xᵀ dY: 20 d² FLOP) and the
// attention backward over the causal pairs (dP, dV, dQ, dK: 4 (T+1) d on
// average), all float32 FMAs outside the tensor cores (67 TFLOP/s):
// B T nb (20 d² + 4 (T+1) d) FLOP, 4.863 GFLOP = 0.0726 ms at B=512, T=50,
// d=64, nb=2, and 0.690 GFLOP = 0.0103 ms at T=8. The rematerialised
// forward is not counted. Its bytes (g, dx, the saved block inputs, the
// masks, the weights and gradients: about 50 MB at T=50) take 0.015 ms at
// 3.35 TB/s.
//
// Design (plain fp32 FMAs, no TF32, no fast math). A block's work is a
// chain of short phases between barriers, each bound by latency, so the
// design keeps 16 warps on every SM and takes device memory out of the
// phases (tools/k2b_ablation.py times each choice against the alternative):
//   * Memory: K2a's training form saves each block's input (and LN_f's) to
//     a [nb + 1, B, T, d] workspace. K2b rematerialises one block at a time
//     from its saved input in shared memory and backpropagates through it.
//     A 512-thread block takes ~32 rows (one user at T >= 17, four at T=8),
//     one block an SM (two 256-thread blocks of two users were 13 % slower
//     at T=8). Seven [rows][ld] buffers: the rematerialisation needs six
//     (q_in, then x2, then the FFN sum; q, k, v; the attention output; the
//     FFN hidden) beside the running gradient G. The block input is read
//     from `saved` into LN1 and read again before LN1ᵀ, and x2 is recomputed
//     from the attention output where the backward needs it again. Beside
//     them the [rows][Ts] probabilities (then dS), the probabilities'
//     dropout mask as bytes, one score row per warp, the ids mask, a
//     [warps][2d] scratch, two weight slots and the user group's scalars:
//     154,684 bytes at T=50, d=64 (check_supported has the widest windows).
//   * Registers: 512 threads leave 128 a thread, and the products need
//     most of them, so nothing that is not in use waits in a register: the
//     group's scalars (struct Group) sit in shared memory and are read
//     where they are used, a leaf's offset in the partial slice and a
//     block's mask pointers are formed at their use, LayerNorm parameter
//     sums accumulate in shared memory, the products' k loops and the
//     weight gradients' row loops are unrolled twice. 0 bytes of spill.
//   * Weights in shared memory: every d x d product streams its weight
//     through the two slots with cp.async, one k-slice ahead (the whole
//     weight at d <= 64, 32 rows at d = 128), across products: the next
//     product's first slice flies while this one multiplies. A slot holds
//     rows of W for x W and columns of W (rows of Wᵀ) for dY Wᵀ, so each
//     k-step reads 16-byte units of shared memory. A thread owns up to 3
//     rows x 4 columns: for x W columns 4c..4c+3, for dY Wᵀ columns c,
//     c + d/4, c + d/2, c + 3d/4 (so a quarter-warp reads eight different
//     banks). dq_in's three products run as one pass, added in order
//     (G + dQ Wqᵀ, then + dK Wkᵀ, then + dV Wvᵀ).
//   * Weight gradients without atomics: a persistent grid of as many
//     blocks as fit the card at once. Block c walks the user groups c,
//     c + grid, ... and adds each group's gradients into a partial slice
//     of device memory that it alone owns (the first group stores). Every
//     thread holds 4 x 2 tiles of Xᵀ dY (and the tiles of row 0 the bias
//     sum), rows in order, the slice's earlier values loaded before the
//     rows; q, k and v share one pass over q_in, in 4 x 1 tiles. A masked
//     row's dY is exactly 0, so it adds exact zeros and is not skipped. A
//     second kernel sums the slices in block order, many threads an output
//     (the design of apl_gen.cu's sum_combine). Two calls give
//     bit-identical gradients.
//   * LayerNorm: one warp per row; each warp sums its rows' dy x̂ and dy,
//     then the warps' sums are added in warp order. LN3ᵀ also writes
//     drop_f2 of its result (dF2) for the FFN's backward.
//   * Attention: one warp per row. The probability rows are
//     zero past the diagonal and for masked queries, so the backward's
//     loops take no branch per step; the dropout mask is read from shared
//     memory. dQ and dK (a query row's and a key row's) share one phase.
//   * dx only (the inner FGSM gradient of ASASRec: only x needs a
//     gradient): no partial slices, no weight-gradient work, no second
//     kernel; one block per user group.
//   * The wide form (`sasrec_encoder_bwd_kernel_cluster`: every shape the
//     tile form does not take, up to K2a's widest window, max_window(d)):
//     one user's window a thread-block cluster of c = 1, 2 or 4 CTAs of 512
//     threads, one CTA an SM, c chosen by the wrapper's layout from (T, d).
//     The CTA of rank s owns pieces s and 2c-1-s of the window cut into 2c
//     (zig-zag: every rank's queries meet about as many causal keys) and
//     keeps everything of its rows in its own shared memory: the seven
//     buffers, the probability rows, the ids mask and the staged dropout
//     masks, beside one [T][ld] buffer F for the whole window. The row-wise
//     phases (LayerNorms, products, weight gradients) are the tile form's
//     code on the own rows; a product's register tile covers them in one
//     pass (the layout shrinks the weight slices before it grows the
//     cluster). The attention reads the window's k or v in F, gathered from
//     the other ranks' buffers through distributed shared memory before each
//     phase that needs them (scores, PV, dS, dQ); dV and dK, sums over
//     queries, are summed per rank over its own queries into F and added in
//     rank order by the key's owner. Four cluster barriers a block. 4-byte
//     copies from device memory (any width and alignment). The dV and dK
//     sums and the weight gradients (a partial slice a CTA) group the rows
//     by rank, so their rounding differs from the tile form's order; two
//     calls give the same bits. The grid is persistent in both modes: as
//     many whole clusters as the card runs at once walk the users.
//   * Any width d <= 128 (the header's widths): the tile form copies rows
//     16 bytes at a time and takes d % 4 == 0 with g, saved and the weights
//     16-byte aligned (its C entry refuses anything else); the wide form
//     copies 4 bytes at a time and takes any width and alignment, so the
//     wrapper gives it every launch the tile form does not take. The
//     LayerNorms' moments and every write to device memory take the d real
//     columns; products, dots and the weight gradients' tiles run over
//     pad4(d), whose tail adds exact zeros.
// Requires d <= 128 (checked by the wrapper).

#include <cooperative_groups.h>

#include "sasrec_encoder.cuh"

namespace cg = cooperative_groups;

// A phase boundary of the wide form; tools/k2b_wide_ablation.py's `stamps`
// variant defines it to sum clock64() between boundaries.
#ifndef ACF_STAMP
#define ACF_STAMP(k)
#endif

namespace {

constexpr int kBuffers = 7;          // BWD_BUFFERS in ops/sasrec_fused.py
constexpr int kMaxRowsPerThread = 3; // rows of a product's register tile
// The wide form's CTA: 512 threads (128 registers a thread) and register
// tiles of up to two rows in the float32 form; 384 threads (168 registers:
// an SM allots registers to warps in fours) and up to three rows in the
// bfloat16 form, whose conversions need more
constexpr int kWideThreads = kBf16 ? 384 : kMaxThreads;  // BWD_WIDE_THREADS
constexpr int kWideRowsPerThread = kBf16 ? 3 : 2;         // BWD_WIDE_ROWS_PER_THREAD
constexpr int kClusterMax = 4;       // the wide form's largest cluster (BWD_CLUSTERS)
constexpr int kMaxKeysPerLane = 7;   // keys a lane holds in dS's registers: T <= 224
constexpr int kGroupFloats = 12;     // BWD_GROUP_FLOATS: the group's scalars (struct Group)
constexpr int kWideHeadFloats = 16;  // BWD_WIDE_HEAD_FLOATS: the wide form's (struct WideHead)
constexpr int kReduceOuts = 32;      // the reduction: outputs a block,
constexpr int kReduceSlices = 8;     // contiguous slices of the parts a block,
constexpr int kReduceUnroll = 16;    // loads a thread issues before it adds them

inline int score_ld(int T) { return (T + 3) / 4 * 4; }  // 16-byte aligned score rows

// Rows of W (or of Wᵀ) in one staged slice, and the floats of one slot, at
// the staged width d (a multiple of 4).
inline int slice_rows(int d) {
  const int k = kSliceFloats / d / 4 * 4;
  return k < d ? k : d;
}
inline int slot_floats(int d, int ks) {
  const int a = ks * row_ld(d), b = d * row_ld(ks);
  return a > b ? a : b;
}

// The leaves of one encoder block in the flat gradient (grad_size and
// _grad_tree in ops/sasrec_fused.py): ln1, wq, wk, wv, ln2, conv1, conv2,
// ln3, each LayerNorm as gamma then beta and each dense as w then b.
enum Leaf { kLn1, kWq, kBq, kWk, kBk, kWv, kBv, kLn2, kW1, kB1, kW2, kB2, kLn3 };

// Where leaf k of encoder block `blk` lies in a partial slice: the block's
// 5 d² + 11 d floats, then a d + b d² into them. Computed where it is used,
// so no offset waits in a register through the phases.
__device__ __forceinline__ float* leaf(float* part, int blk, Leaf k, int d) {
  int a = 0, b = 0;
  switch (k) {
    case kLn1: a = 0; b = 0; break;
    case kWq: a = 2; b = 0; break;
    case kBq: a = 2; b = 1; break;
    case kWk: a = 3; b = 1; break;
    case kBk: a = 3; b = 2; break;
    case kWv: a = 4; b = 2; break;
    case kBv: a = 4; b = 3; break;
    case kLn2: a = 5; b = 3; break;
    case kW1: a = 7; b = 3; break;
    case kB1: a = 7; b = 4; break;
    case kW2: a = 8; b = 4; break;
    case kB2: a = 8; b = 5; break;
    case kLn3: a = 9; b = 5; break;
  }
  return part + blk * (5 * d * d + 11 * d) + a * d + b * d * d;
}

// A block's [B, T, d] dropout mask at the group's first row, or null.
__device__ __forceinline__ const unsigned char* mask_rows(const unsigned char* m, size_t row0,
                                                         int d) {
  return m == nullptr ? nullptr : m + row0 * d;
}

__device__ __forceinline__ void add_to(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

// The register tile with the fewest rows that covers R in one pass: 1, 2
// or 3 rows (at most MAXR; the C entries check R <= MAXR row_groups).
template <bool TRANS, int NP, bool ALIGNED, int MAXR = kMaxRowsPerThread>
__device__ void dense(Pipe& pp, const float* const (&in)[NP], const float* const (&W)[NP],
                      WRef next, float* out, const Epilogue& e, int R, int d, int ld) {
  const int row_groups = blockDim.x / ((ALIGNED ? d : pad4(d)) / 4);
  if (R <= row_groups) {
    product<1, TRANS, NP, ALIGNED>(pp, in, W, next, out, e, R, d, ld);
  } else if (MAXR < 3 || R <= 2 * row_groups) {
    product<2, TRANS, NP, ALIGNED>(pp, in, W, next, out, e, R, d, ld);
  } else if constexpr (MAXR >= 3) {
    product<3, TRANS, NP, ALIGNED>(pp, in, W, next, out, e, R, d, ld);
  }
}

// ---- weight gradients ---------------------------------------------------------

// For each p < NP: wp[p][k][c] (+)= Σ_r X[r][k] dY[p][r][c] and bp[p][c]
// (+)= Σ_r dY[p][r][c] over the rows (a masked row's dY is exactly 0 and
// its X finite, so it adds exact zeros); X is read through `operand`. Each
// thread owns 4 x CW tiles
// (k0..k0+3, c0..c0+CW-1) and sums the rows in order; the tiles of k0 = 0
// also sum the bias. The partial's earlier values are loaded before the
// rows. The tiles cover pad4(d); without ALIGNED, the entries past d are
// neither read nor written.
template <int NP, int CW, bool ALIGNED>
__device__ void wgrad(const float* X, const float* const (&dY)[NP], float* const (&wp)[NP],
                      float* const (&bp)[NP], bool first, int R, int d, int ld) {
  const int dp = ALIGNED ? d : pad4(d);
  const int nc = dp / CW;
  for (int tile = threadIdx.x; tile < dp / 4 * nc; tile += blockDim.x) {
    const int k0 = 4 * (tile / nc), c0 = CW * (tile % nc);
    const bool bias = k0 == 0;
    auto inside = [&](int i, int j) { return ALIGNED || (k0 + i < d && c0 + j < d); };
    float acc[NP][4][CW], prev[NP][4][CW], bsum[NP][CW], bprev[NP][CW];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        bsum[p][j] = 0.f;
        bprev[p][j] = bias && !first && inside(0, j) ? bp[p][c0 + j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[p][i][j] = 0.f;
          prev[p][i][j] = first || !inside(i, j) ? 0.f : wp[p][(k0 + i) * d + c0 + j];
        }
      }
#pragma unroll 2
    for (int r = 0; r < R; ++r) {
      const float4 a = operand4(*reinterpret_cast<const float4*>(X + r * ld + k0));
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float gv[CW];  // dY[p][r][c0, c0 + CW), one load
        if constexpr (CW == 2) {
          const float2 v = *reinterpret_cast<const float2*>(dY[p] + r * ld + c0);
          gv[0] = v.x;
          gv[1] = v.y;
        } else {
          gv[0] = dY[p][r * ld + c0];
        }
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const float g = gv[j];
          acc[p][0][j] = fmaf(a.x, g, acc[p][0][j]);
          acc[p][1][j] = fmaf(a.y, g, acc[p][1][j]);
          acc[p][2][j] = fmaf(a.z, g, acc[p][2][j]);
          acc[p][3][j] = fmaf(a.w, g, acc[p][3][j]);
          if (bias) bsum[p][j] += g;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < CW; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (inside(i, j))
            wp[p][(k0 + i) * d + c0 + j] = first ? acc[p][i][j] : prev[p][i][j] + acc[p][i][j];
        if (bias && inside(0, j)) bp[p][c0 + j] = first ? bsum[p][j] : bprev[p][j] + bsum[p][j];
      }
  }
}

// ---- LayerNorm ------------------------------------------------------------------

// dst[r] = LN(src[r]) for rows r < R from rows of stride sld (device memory
// or shared), also copied to `copy` ([R][ld]) when it is not null; one warp
// per row, the forward's formula (K2a's ln_pairs sums the moments in
// another order). Without ALIGNED the columns [d, pad4(d)) of dst and copy
// are set to 0.
template <bool ALIGNED>
__device__ void ln_rows(const float* src, int sld, float* copy, float* dst, LayerNormW p, int R,
                        int d, int ld) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
    float v[kMaxColsPerLane];
    float s = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxColsPerLane; ++m) {
      const int c = lane + 32 * m;
      v[m] = c < d ? src[static_cast<size_t>(r) * sld + c] : 0.f;
      s += v[m];
      if (copy != nullptr && c < d) copy[r * ld + c] = v[m];
    }
    const float mean = warp_sum(s) / d;
    float q = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxColsPerLane; ++m) {
      const float dv = v[m] - mean;
      if (lane + 32 * m < d) q = fmaf(dv, dv, q);
    }
    const float denom = sqrtf(warp_sum(q) / d + kEps);
#pragma unroll
    for (int m = 0; m < kMaxColsPerLane; ++m) {
      const int c = lane + 32 * m;
      if (c < d) {
        dst[r * ld + c] = __ldg(p.gamma + c) * (v[m] - mean) / denom + __ldg(p.beta + c);
      } else if (!ALIGNED && c < pad4(d)) {  // the zero tail
        dst[r * ld + c] = 0.f;
        if (copy != nullptr) copy[r * ld + c] = 0.f;
      }
    }
  }
}

// G[r] <- LNᵀ(G[r] (* M[r] when M is given)) for the LayerNorm whose input
// rows are X (its moments recomputed as the forward computes them); one
// warp per row. With `dropped`, also dropped[r] = drop(G[r]) with `mask`
// ([R][d] in device memory, or null: a copy); it may alias X. Each warp
// sums its rows' dy x̂ and dy, in row order, into scratch[warp][0, d) and
// [d, 2d) (in shared memory, not in registers).
__device__ void ln_bwd_rows(const float* X, float* G, LayerNormW p, const float* M,
                            float* scratch, int R, int d, int ld, float* dropped = nullptr,
                            const unsigned char* mask = nullptr, float keep = 1.f) {
  const int lane = threadIdx.x & 31;
  float* sg = scratch + (threadIdx.x >> 5) * 2 * d;  // this warp's Σ dy x̂, then Σ dy
  for (int c = lane; c < 2 * d; c += 32) sg[c] = 0.f;
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
    float v[kMaxColsPerLane];
    float s = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxColsPerLane; ++m) {
      const int c = lane + 32 * m;
      v[m] = c < d ? X[r * ld + c] : 0.f;
      s += v[m];
    }
    const float mean = warp_sum(s) / d;
    float q = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxColsPerLane; ++m) {
      const float dv = v[m] - mean;
      if (lane + 32 * m < d) q = fmaf(dv, dv, q);
    }
    const float sigma = sqrtf(warp_sum(q) / d + kEps);
    const float mr = M == nullptr ? 1.f : M[r];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxColsPerLane; ++m) {
      const int c = lane + 32 * m;
      if (c < d) {
        const float xh = (v[m] - mean) / sigma;
        const float dy = G[r * ld + c] * mr;
        sg[c] = fmaf(dy, xh, sg[c]);
        sg[d + c] += dy;
        v[m] = dy * __ldg(p.gamma + c);  // dx̂
        s1 += v[m];
        s2 = fmaf(v[m], xh, s2);
      }
    }
    const float m1 = warp_sum(s1) / d;
    const float m2 = warp_sum(s2) / d;
#pragma unroll
    for (int m = 0; m < kMaxColsPerLane; ++m) {
      const int c = lane + 32 * m;
      if (c >= d) continue;
      const float g = (v[m] - m1 - (X[r * ld + c] - mean) / sigma * m2) / sigma;  // x̂ again
      G[r * ld + c] = g;
      if (dropped != nullptr)
        dropped[r * ld + c] = mask == nullptr ? g : drop(g, mask[r * d + c], keep);
    }
  }
}

// part[0, 2d) (+)= the warps' LayerNorm sums in warp order (gamma, beta).
__device__ void ln_grad_flush(const float* scratch, float* part, bool first, int d) {
  const int warps = blockDim.x >> 5;
  for (int c = threadIdx.x; c < 2 * d; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += scratch[w * 2 * d + c];
    add_to(part + c, s, first);
  }
}

// ---- attention ------------------------------------------------------------------

// A[r] = QIN[r] + Σ_j drop_p(p_rj) V[j] over the keys j <= r of row r's
// user whose mask is set, p_r = softmax_j(q_r·k_j / √d); P[r] keeps p_r
// before the dropout, 0 for masked keys, past the diagonal and for a
// masked query (whose A is QIN). `pm` is the block's [R][T] dropout mask
// in shared memory, or null. One warp per row; `scores` holds one row of
// Ts floats per warp. The arithmetic is K2a's (attention_rows), q, k, v
// and the dropped probabilities read through `attn_operand`.
__device__ BF16_NOINLINE void attention_fwd(const float* q, const float* k, const float* v,
                                            const float* qin, float* a, float* scores, float* P,
                                            const unsigned char* pm, float keep, const float* M,
                                            int R, int T, int Ts, int d, int ld) {
  const int lane = threadIdx.x & 31;
  const float scale = sqrtf(static_cast<float>(d));
  float* s = scores + (threadIdx.x >> 5) * Ts;
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
    float* pr = P + r * Ts;
    if (M[r] == 0.f) {  // a masked query: no attention, zero probabilities
      for (int c = lane; c < d; c += 32) a[r * ld + c] = qin[r * ld + c];
      for (int j = lane; j < Ts; j += 32) pr[j] = 0.f;
      continue;
    }
    const int i = r % T;  // position in the window
    const int u0 = r - i; // the user's first row
    const float* qr = q + r * ld;
    float m = -INFINITY;
    for (int j = lane; j <= i; j += 32) {
      float dot = -INFINITY;  // a masked key: weight exactly 0, as -2^32+1 gives
      if (M[u0 + j] != 0.f) {
        const float* kr = k + (u0 + j) * ld;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // four independent chains
        for (int c = 0; c < d; c += 4) {
          const float4 x = attn_operand4(*reinterpret_cast<const float4*>(qr + c), T);
          const float4 y = attn_operand4(*reinterpret_cast<const float4*>(kr + c), T);
          a0 = fmaf(x.x, y.x, a0);
          a1 = fmaf(x.y, y.y, a1);
          a2 = fmaf(x.z, y.z, a2);
          a3 = fmaf(x.w, y.w, a3);
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
    for (int j = lane; j < Ts; j += 32) {
      float p = j <= i ? s[j] / sum : 0.f;
      pr[j] = p;
      if (pm != nullptr && j <= i) p = drop(p, pm[r * T + j], keep);
      s[j] = attn_operand(p, T);
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
        t = fmaf(p4.x, attn_operand(vr[32 * c], T), t);
        t = fmaf(p4.y, attn_operand(vr[ld + 32 * c], T), t);
        t = fmaf(p4.z, attn_operand(vr[2 * ld + 32 * c], T), t);
        t = fmaf(p4.w, attn_operand(vr[3 * ld + 32 * c], T), t);
        acc[c] = t;
      }
    }
    for (; j <= i; ++j) {
      const float pj = s[j];
      const float* vr = v + (u0 + j) * ld + lane;
#pragma unroll
      for (int c = 0; c < kMaxColsPerLane; ++c)
        if (lane + 32 * c < d) acc[c] = fmaf(pj, attn_operand(vr[32 * c], T), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c)
      if (lane + 32 * c < d) a[r * ld + lane + 32 * c] = qin[r * ld + lane + 32 * c] + acc[c];
    __syncwarp();  // this warp's next row rewrites s
  }
}

// dV[j] = Σ_{i >= j} p'_ij dA[i] over the queries i of key j's user
// (p' = drop_p(P), 0 for a masked query); 0 for a masked key. One warp per
// key row; p' and dV through `attn_operand`.
__device__ void attn_bwd_dv(const float* P, const unsigned char* pm, float keep, const float* dA,
                            float* dV, const float* M, int R, int T, int Ts, int d, int ld) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < R; j += blockDim.x >> 5) {
    float acc[kMaxColsPerLane];
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) acc[c] = 0.f;
    if (M[j] != 0.f) {
      const int jj = j % T, u0 = j - jj;
#pragma unroll 4
      for (int i = j; i < u0 + T; ++i) {
        float p = P[i * Ts + jj];
        if (pm != nullptr) p = drop(p, pm[i * T + jj], keep);
        p = attn_operand(p, T);
        const float* ar = dA + i * ld + lane;
#pragma unroll
        for (int c = 0; c < kMaxColsPerLane; ++c)
          if (lane + 32 * c < d) acc[c] = fmaf(p, ar[32 * c], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c)
      if (lane + 32 * c < d) dV[j * ld + lane + 32 * c] = attn_operand(acc[c], T);
  }
}

// P[r] <- dS[r] = P[r] ∘ (dP[r] - Σ_j dP_rj P_rj), dP_rj = drop_p(dA[r]·V[j]),
// over the keys j <= r of an unmasked query row r (a masked query's row
// stays 0). One warp per row; `scores` holds one row of dP per warp. V and
// dA·V (before the dropout) through `attn_operand`.
__device__ void attn_bwd_ds(float* P, float* scores, const unsigned char* pm, float keep,
                            const float* dA, const float* V, const float* M, int R, int T,
                            int Ts, int d, int ld) {
  const int lane = threadIdx.x & 31;
  float* s = scores + (threadIdx.x >> 5) * Ts;
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
    if (M[r] == 0.f) continue;  // a masked query: dP = 0, so dS = 0
    const int i = r % T, u0 = r - i;
    const float* ar = dA + r * ld;
    float rho = 0.f;
    for (int j = lane; j <= i; j += 32) {
      float dp = 0.f;
      if (M[u0 + j] != 0.f) {  // a masked key has P = 0: its dS is 0 whatever dP is
        const float* vr = V + (u0 + j) * ld;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int c = 0; c < d; c += 4) {
          const float4 a = *reinterpret_cast<const float4*>(ar + c);
          const float4 b = attn_operand4(*reinterpret_cast<const float4*>(vr + c), T);
          a0 = fmaf(a.x, b.x, a0);
          a1 = fmaf(a.y, b.y, a1);
          a2 = fmaf(a.z, b.z, a2);
          a3 = fmaf(a.w, b.w, a3);
        }
        dp = attn_operand((a0 + a1) + (a2 + a3), T);
      }
      if (pm != nullptr) dp = drop(dp, pm[r * T + j], keep);
      s[j] = dp;
      rho = fmaf(dp, P[r * Ts + j], rho);
    }
    rho = warp_sum(rho);
    for (int j = lane; j <= i; j += 32) P[r * Ts + j] = P[r * Ts + j] * (s[j] - rho);
    __syncwarp();
  }
}

// Row r's dQ[r] = Σ_{j <= r} dS_rj K[j] / √d and then, as key, dK[r] =
// Σ_{i >= r} dS_ir Q[i] / √d (dS is 0 for masked queries and keys); 0 for
// a masked row. One warp per row; K, Q, dQ and dK through `attn_operand`.
__device__ void attn_bwd_dqk(const float* dS, const float* K, const float* Q, float* dQ,
                             float* dK, const float* M, int R, int T, int Ts, int d, int ld) {
  const int lane = threadIdx.x & 31;
  const float scale = sqrtf(static_cast<float>(d));
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
    const bool live = M[r] != 0.f;
    const int i = r % T, u0 = r - i;
    float acc[kMaxColsPerLane];
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) acc[c] = 0.f;
    if (live) {
#pragma unroll 4
      for (int j = 0; j <= i; ++j) {
        const float ds = dS[r * Ts + j];
        const float* kr = K + (u0 + j) * ld + lane;
#pragma unroll
        for (int c = 0; c < kMaxColsPerLane; ++c)
          if (lane + 32 * c < d) acc[c] = fmaf(ds, attn_operand(kr[32 * c], T), acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) {
      if (lane + 32 * c < d) dQ[r * ld + lane + 32 * c] = attn_operand(acc[c] / scale, T);
      acc[c] = 0.f;
    }
    if (live) {
#pragma unroll 4
      for (int q = r; q < u0 + T; ++q) {
        const float ds = dS[q * Ts + i];
        const float* qr = Q + q * ld + lane;
#pragma unroll
        for (int c = 0; c < kMaxColsPerLane; ++c)
          if (lane + 32 * c < d) acc[c] = fmaf(ds, attn_operand(qr[32 * c], T), acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c)
      if (lane + 32 * c < d) dK[r * ld + lane + 32 * c] = attn_operand(acc[c] / scale, T);
  }
}

// dst[r] = src rows [R, d] of device memory into [R][ld] rows; without
// ALIGNED 4-byte loads, and the columns [d, pad4(d)) set to 0.
template <bool ALIGNED>
__device__ void load_rows(const float* src, float* dst, int R, int d, int ld) {
  if (!ALIGNED) {
    const int dp = pad4(d);
    for (int idx = threadIdx.x; idx < R * dp; idx += blockDim.x) {
      const int r = idx / dp, c = idx % dp;
      dst[r * ld + c] = c < d ? src[r * d + c] : 0.f;
    }
    return;
  }
  const int groups = d / 4;
  for (int idx = threadIdx.x; idx < R * groups; idx += blockDim.x) {
    const int r = idx / groups, c = (idx % groups) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + c) = ldg4(src + r * d + c);
  }
}

// The user group's scalars, in shared memory: each phase reads them where
// it uses them, so no register holds them through the phases (at 512
// threads a thread has 128 registers, and the products need most of them).
struct Group {
  float* part;            // this block's partial slice, or null (dx only)
  size_t row0;            // the group's first row of [B, T]
  const float* next_wq;   // the last block's Wq for this block's next group, or null
  int R, users;
  bool first;             // this block's first group: it stores, later ones add
};
static_assert(sizeof(Group) <= kGroupFloats * sizeof(float), "Group outgrows its floats");

// The tile form: a block of ~32 rows (users_per_block windows) in shared
// memory, 16-byte copies.
__global__ void __launch_bounds__(kMaxThreads, 1)
sasrec_encoder_bwd_kernel(const EncoderW w, const DropoutMasks dm,
                          const unsigned char* __restrict__ ids_mask,
                          const float* __restrict__ g, const float* __restrict__ saved,
                          float* __restrict__ dx, float* __restrict__ partial, int B, int T,
                          int d, int users_per_block, int ld, int Ts, int ks, int ldk, int slot,
                          int n_grad, int groups) {
  constexpr bool ALIGNED = true;  // the header's 16-byte width path
  extern __shared__ __align__(16) float smem[];
  const int rows = users_per_block * T;
  const int warps = blockDim.x >> 5;
  Group* gs = reinterpret_cast<Group*>(smem);
  // seven [rows][ld] buffers; their contents through one encoder block:
  float* X0 = smem + kGroupFloats;  // LN_f's input; the attention output A; dV
  float* X1 = X0 + rows * ld;    // q_in; x2; the FFN sum F; dF2; x2 again; dQ
  float* X2 = X1 + rows * ld;    // q; the block input H
  float* X3 = X2 + rows * ld;    // k; q_in again
  float* X4 = X3 + rows * ld;    // v
  float* X5 = X4 + rows * ld;    // the FFN hidden F1; dZ1; dK
  float* G = X5 + rows * ld;     // the running gradient
  float* P = G + rows * ld;      // [rows][Ts] probabilities, then dS
  float* SW = P + rows * Ts;     // two weight slots
  float* S = SW + 2 * slot;      // [warps][Ts] score rows
  float* M = S + warps * Ts;     // [rows] ids mask as 0/1
  float* LS = M + rows;          // [warps][2d] LayerNorm gradient sums
  // the probabilities' dropout mask, [rows][T]: staged here
  unsigned char* PMs = reinterpret_cast<unsigned char*>(LS + warps * 2 * d);
  const int nb = w.num_blocks;
  const size_t plane = static_cast<size_t>(B) * T;  // rows of one [B, T, d] of `saved`
  Pipe pp{SW, slot, 0, false, ks, ldk};

  for (int group = blockIdx.x; group < groups; group += gridDim.x) {
    __syncthreads();  // the previous group is done with every buffer and with gs
    if (threadIdx.x == 0) {
      const int users = min(users_per_block, B - group * users_per_block);
      const bool last = group + static_cast<int>(gridDim.x) >= groups;
      *gs = Group{partial == nullptr ? nullptr : partial + static_cast<size_t>(blockIdx.x) * n_grad,
                  static_cast<size_t>(group) * users_per_block * T,
                  last ? nullptr : w.blocks[nb - 1].wq.w, users * T, users,
                  group == static_cast<int>(blockIdx.x)};
    }
    __syncthreads();
    for (int r = threadIdx.x; r < gs->R; r += blockDim.x)
      M[r] = ids_mask[gs->row0 + r] ? 1.f : 0.f;
    load_rows<ALIGNED>(g + gs->row0 * d, G, gs->R, d, ld);
    load_rows<ALIGNED>(saved + (nb * plane + gs->row0) * d, X0, gs->R, d, ld);
    __syncthreads();
    ln_bwd_rows(X0, G, w.ln_f, nullptr, LS, gs->R, d, ld);  // every row feeds dβ_f
    __syncthreads();
    if (gs->part != nullptr) ln_grad_flush(LS, gs->part + nb * (5 * d * d + 11 * d), gs->first, d);

    for (int blk = nb - 1; blk >= 0; --blk) {
      const BlockW& p = w.blocks[blk];
      // per-block pointers are formed where they are used: the block input
      // saved[blk], the dropout masks (the probabilities' staged in PMs)

      // the rematerialised forward
      const unsigned char* PM = PMs;
      if (dm.p[blk] != nullptr) {
        for (int idx = threadIdx.x; idx < gs->R * T; idx += blockDim.x)
          PMs[idx] = dm.p[blk][gs->row0 * T + idx];
      }
      ln_rows<ALIGNED>(saved + (blk * plane + gs->row0) * d, d, nullptr, X1, p.ln1, gs->R, d,
                       ld);  // q_in
      dense<false, 1, ALIGNED>(pp, {X1}, {p.wq.w}, WRef{p.wk.w, false}, X2, epi(p.wq.b),
                               gs->R, d, ld);
      dense<false, 1, ALIGNED>(pp, {X1}, {p.wk.w}, WRef{p.wv.w, false}, X3, epi(p.wk.b),
                               gs->R, d, ld);
      dense<false, 1, ALIGNED>(pp, {X1}, {p.wv.w}, WRef{p.conv1.w, false}, X4, epi(p.wv.b),
                               gs->R, d, ld);
      __syncthreads();
      attention_fwd(X2, X3, X4, X1, X0, S, P, dm.p[blk] == nullptr ? nullptr : PM, dm.keep, M,
                    gs->R, T, Ts, d, ld);
      __syncthreads();
      ln_rows<ALIGNED>(X0, ld, nullptr, X1, p.ln2, gs->R, d, ld);  // x2
      dense<false, 1, ALIGNED>(
          pp, {X1}, {p.conv1.w}, WRef{p.conv2.w, false}, X5,
          epi(p.conv1.b, true, mask_rows(dm.f1[blk], gs->row0, d), dm.keep), gs->R, d, ld);  // F1
      dense<false, 1, ALIGNED>(
          pp, {X5}, {p.conv2.w}, WRef{p.conv2.w, true}, X1,
          epi(p.conv2.b, false, mask_rows(dm.f2[blk], gs->row0, d), dm.keep, nullptr, X1), gs->R,
          d, ld);  // F
      __syncthreads();

      // LN3 (its output was masked by the ids mask), then the FFN
      ln_bwd_rows(X1, G, p.ln3, M, LS, gs->R, d, ld, X1, mask_rows(dm.f2[blk], gs->row0, d),
                  dm.keep);  // G = dF, X1 = dF2 = drop_f2(dF)
      __syncthreads();
      if (gs->part != nullptr) ln_grad_flush(LS, leaf(gs->part, blk, kLn3, d), gs->first, d);
      if (gs->part != nullptr)
        wgrad<1, 2, ALIGNED>(X5, {X1}, {leaf(gs->part, blk, kW2, d)},
                             {leaf(gs->part, blk, kB2, d)}, gs->first, gs->R, d, ld);
      dense<true, 1, ALIGNED>(
          pp, {X1}, {p.conv2.w}, WRef{p.conv1.w, true}, X5,
          epi(nullptr, false, mask_rows(dm.f1[blk], gs->row0, d), dm.keep, X5), gs->R, d,
          ld);  // dZ1
      __syncthreads();
      ln_rows<ALIGNED>(X0, ld, nullptr, X1, p.ln2, gs->R, d, ld);  // x2 again
      __syncthreads();
      if (gs->part != nullptr)
        wgrad<1, 2, ALIGNED>(X1, {X5}, {leaf(gs->part, blk, kW1, d)},
                             {leaf(gs->part, blk, kB1, d)}, gs->first, gs->R, d, ld);
      // dX2 = dF + dZ1 W1ᵀ
      dense<true, 1, ALIGNED>(pp, {X5}, {p.conv1.w}, WRef{p.wq.w, true}, G,
                              epi(nullptr, false, nullptr, 1.f, nullptr, G), gs->R, d, ld);
      __syncthreads();
      ln_bwd_rows(X0, G, p.ln2, nullptr, LS, gs->R, d, ld);  // G = dA
      __syncthreads();

      // attention: dV into X0, dS over P, dQ into X1, dK into X5
      if (gs->part != nullptr) ln_grad_flush(LS, leaf(gs->part, blk, kLn2, d), gs->first, d);
      attn_bwd_dv(P, dm.p[blk] == nullptr ? nullptr : PM, dm.keep, G, X0, M, gs->R, T, Ts, d, ld);
      __syncthreads();
      attn_bwd_ds(P, S, dm.p[blk] == nullptr ? nullptr : PM, dm.keep, G, X4, M, gs->R, T, Ts, d,
                  ld);
      __syncthreads();
      attn_bwd_dqk(P, X3, X2, X1, X5, M, gs->R, T, Ts, d, ld);
      __syncthreads();
      ln_rows<ALIGNED>(saved + (blk * plane + gs->row0) * d, d, X2, X3, p.ln1, gs->R, d,
                       ld);  // H, q_in
      __syncthreads();
      if (gs->part != nullptr)
        wgrad<3, 1, ALIGNED>(X3, {X1, X5, X0},
                             {leaf(gs->part, blk, kWq, d), leaf(gs->part, blk, kWk, d),
                              leaf(gs->part, blk, kWv, d)},
                             {leaf(gs->part, blk, kBq, d), leaf(gs->part, blk, kBk, d),
                              leaf(gs->part, blk, kBv, d)},
                             gs->first, gs->R, d, ld);
      // dq_in = dA + dQ Wqᵀ + dK Wkᵀ + dV Wvᵀ, added in that order; the
      // next block's (or group's) first weight flies behind them
      const WRef next{blk > 0 ? w.blocks[blk - 1].wq.w : gs->next_wq, false};
      dense<true, 3, ALIGNED>(pp, {X1, X5, X0}, {p.wq.w, p.wk.w, p.wv.w}, next, G,
                              epi(nullptr, false, nullptr, 1.f, nullptr, G), gs->R, d, ld);
      __syncthreads();
      ln_bwd_rows(X2, G, p.ln1, nullptr, LS, gs->R, d, ld);  // G = the block input's gradient
      __syncthreads();
      if (gs->part != nullptr) ln_grad_flush(LS, leaf(gs->part, blk, kLn1, d), gs->first, d);
    }

    // the input: x0 = drop_emb(x + pos) * mask
    const unsigned char* emb = mask_rows(dm.emb, gs->row0, d);
    for (int idx = threadIdx.x; idx < gs->R * d; idx += blockDim.x) {
      const int r = idx / d, c = idx % d;
      float v = G[r * ld + c] * M[r];
      if (emb != nullptr) v = drop(v, emb[idx], dm.keep);
      dx[gs->row0 * d + idx] = v;
      G[r * ld + c] = v;
    }
    __syncthreads();
    if (gs->part != nullptr) {
      float* pos = gs->part + nb * (5 * d * d + 11 * d) + 2 * d;  // after ln_f's
      for (int idx = threadIdx.x; idx < T * d; idx += blockDim.x) {
        const int t = idx / d, c = idx % d;
        float s = 0.f;
        for (int u = 0; u < gs->users; ++u) s += G[(u * T + t) * ld + c];
        add_to(pos + idx, s, gs->first);
      }
    }
  }
}

// ---- the wide form: one user's window across a thread-block cluster ----------

// The rows of the window that the CTA of rank s in a cluster of c owns:
// pieces s and 2c - 1 - s of the window cut into 2c pieces (zig-zag), so
// that every CTA's queries meet about as many causal keys. Own row l is
// position `at(l)`: piece a's rows, then piece b's, each ascending.
struct Rows {
  int a0, na, b0, nb;
  __host__ __device__ int count() const { return na + nb; }
  __host__ __device__ int at(int l) const { return l < na ? a0 + l : b0 + l - na; }
  __device__ int row(int t) const {  // the own row at position t, or -1
    return t >= a0 && t < a0 + na ? t - a0 : (t >= b0 && t < b0 + nb ? na + t - b0 : -1);
  }
};

__host__ __device__ inline int piece_start(int k, int T, int c) { return k * T / (2 * c); }

__host__ __device__ inline Rows rows_of(int s, int T, int c) {
  const int a0 = piece_start(s, T, c), b0 = piece_start(2 * c - 1 - s, T, c);
  return Rows{a0, piece_start(s + 1, T, c) - a0, b0, piece_start(2 * c - s, T, c) - b0};
}

// The most rows a CTA of the cluster owns (_cluster_rows in
// ops/sasrec_fused.py): every own buffer has this many.
inline int cluster_rows(int T, int c) {
  int most = 0;
  for (int s = 0; s < c; ++s) {
    const int n = rows_of(s, T, c).count();
    most = n > most ? n : most;
  }
  return most;
}

// Where the wide form's buffers lie in shared memory, in floats (the masks
// in bytes) from its start, set by the C entry and read from the kernel's
// parameters where they are used, so that no pointer waits in a register.
struct WideLayout {
  int x[kBuffers];  // seven own [R][ld] buffers
  int f, p, sw, mf, mo, ls;
  int pm, f1, f2;   // bytes
};

// What a CTA of the wide form keeps at the start of its shared memory.
struct WideHead {
  Group g;
  Rows rw;  // this rank's rows
};
static_assert(sizeof(WideHead) <= kWideHeadFloats * sizeof(float), "WideHead outgrows its floats");

// F[t] = row t of the window for every t < T, read from the own buffer X of
// the rank that owns it (distributed shared memory; the own rank's too),
// pad4(d) columns 16 bytes at a time, their zero tails included; each
// thread issues four loads before it stores them. Out of line, as the rank
// sums (cl_combine) are: in line they push the kernel past its registers.
__device__ __noinline__ void gather(float* F, float* X, int T, int c, int d, int ld) {
  const int units = pad4(d) / 4;
  for (int s = 0; s < c; ++s) {
    const Rows rs = rows_of(s, T, c);
    const float* src = cg::this_cluster().map_shared_rank(X, s);
    const int total = rs.count() * units;
    for (int base = threadIdx.x; base < total; base += 4 * blockDim.x) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * blockDim.x;
        if (idx < total)
          v[u] = *reinterpret_cast<const float4*>(src + (idx / units) * ld + 4 * (idx % units));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * blockDim.x;
        if (idx < total)
          *reinterpret_cast<float4*>(F + rs.at(idx / units) * ld + 4 * (idx % units)) = v[u];
      }
    }
  }
}

// out[l] = attn_operand(Σ_s F_s[t] (/ √d with `scaled`)) for each own row l
// at position t: the ranks' partial sums (cl_partials) added in rank order,
// read from each rank's F (distributed shared memory).
__device__ __noinline__ void cl_combine(float* F, float* out, bool scaled, Rows rw, int T,
                                        int c, int d, int ld) {
  const float scale = sqrtf(static_cast<float>(d));
  for (int idx = threadIdx.x; idx < rw.count() * d; idx += blockDim.x) {
    const int l = idx / d, col = idx % d, at = rw.at(l) * ld + col;
    float s = cg::this_cluster().map_shared_rank(F, 0)[at];
    for (int r = 1; r < c; ++r) s += cg::this_cluster().map_shared_rank(F, r)[at];
    out[l * ld + col] = attn_operand(scaled ? s / scale : s, T);
  }
}

// P[l] = the probabilities of own query row l (attention_fwd's arithmetic,
// K the window's keys; its scores, then their exponentials, held in P's row
// on the way), 0 past the diagonal and for a masked query. Two neighbouring
// rows a warp, the costliest pair first (as cl_rows), each loaded key serving
// both; lane k takes keys k, k + 32, ... of each.
__device__ void cl_softmax(const float* q, const float* K, float* P, const float* MO,
                           const float* MF, Rows rw, int T, int Ts, int d, int ld) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5, pairs = (rw.count() + 1) / 2;
  const float scale = sqrtf(static_cast<float>(d));
  for (int k = threadIdx.x >> 5; k < pairs; k += warps) {
    const int l0 = 2 * (pairs - 1 - k), l1 = l0 + 1;
    const bool two = l1 < rw.count();
    // the last key of each row, -1 for a masked query (no attention)
    const int i0 = MO[l0] != 0.f ? rw.at(l0) : -1;
    const int i1 = two && MO[l1] != 0.f ? rw.at(l1) : -1;
    float* p0 = P + l0 * Ts;
    float* p1 = P + (two ? l1 : l0) * Ts;
    const float* q0 = q + l0 * ld;
    const float* q1 = q + (two ? l1 : l0) * ld;
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int j = lane; j <= (i0 > i1 ? i0 : i1); j += 32) {
      float dot0 = -INFINITY, dot1 = -INFINITY;  // a masked key: weight exactly 0
      if (MF[j] != 0.f) {
        const float* kr = K + j * ld;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // four independent chains a row
        float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
        for (int c = 0; c < d; c += 4) {
          const float4 y = attn_operand4(*reinterpret_cast<const float4*>(kr + c), T);
          const float4 x = attn_operand4(*reinterpret_cast<const float4*>(q0 + c), T);
          const float4 z = attn_operand4(*reinterpret_cast<const float4*>(q1 + c), T);
          a0 = fmaf(x.x, y.x, a0);
          a1 = fmaf(x.y, y.y, a1);
          a2 = fmaf(x.z, y.z, a2);
          a3 = fmaf(x.w, y.w, a3);
          b0 = fmaf(z.x, y.x, b0);
          b1 = fmaf(z.y, y.y, b1);
          b2 = fmaf(z.z, y.z, b2);
          b3 = fmaf(z.w, y.w, b3);
        }
        dot0 = ((a0 + a1) + (a2 + a3)) / scale;
        dot1 = ((b0 + b1) + (b2 + b3)) / scale;
      }
      if (j <= i0) {
        p0[j] = dot0;
        m0 = fmaxf(m0, dot0);
      }
      if (j <= i1) {
        p1[j] = dot1;
        m1 = fmaxf(m1, dot1);
      }
    }
    m0 = warp_max(m0);  // finite for a live row: key i is unmasked because query i is
    m1 = warp_max(m1);
    float sum0 = 0.f, sum1 = 0.f;
    for (int j = lane; j <= i0; j += 32) {
      const float e = expf(p0[j] - m0);
      p0[j] = e;
      sum0 += e;
    }
    for (int j = lane; j <= i1; j += 32) {
      const float e = expf(p1[j] - m1);
      p1[j] = e;
      sum1 += e;
    }
    sum0 = warp_sum(sum0);
    sum1 = warp_sum(sum1);
    for (int j = lane; j < Ts; j += 32) p0[j] = j <= i0 ? p0[j] / sum0 : 0.f;
    if (two)
      for (int j = lane; j < Ts; j += 32) p1[j] = j <= i1 ? p1[j] / sum1 : 0.f;
  }
}

// The row-side products of the attention, two neighbouring own rows a warp,
// each loaded row of Y serving both: out[l] = Σ_{j <= i}
// coef(l, j) Y[j] over the window's rows j, j ascending (attention_fwd's
// sum of PV). PV (`pv`): coef = attn_operand(drop_p(P)), Y the window's
// values, out = QIN + the sum (a masked query's out is QIN). dQ: coef = dS
// (in P), Y the window's keys, out = attn_operand(sum / √d). A row's
// coefficients past its diagonal are 0 (its P row is), so the second row's
// extra keys and the keys that padding drops add exact zeros to a sum that
// starts at +0. Lane k forms key j0 + k's coefficients, the warp takes them
// in order by shuffles, eight keys a step; CPL columns a lane (d <= 32 CPL).
template <int CPL>
__device__ void cl_rows(bool pv, const float* P, const unsigned char* pm, float keep,
                        const float* Y, const float* qin, float* out, const float* MO, Rows rw,
                        int T, int Ts, int d, int ld) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5, pairs = (rw.count() + 1) / 2;
  const float scale = sqrtf(static_cast<float>(d));
  // pairs of neighbouring rows, the costliest (the latest positions: both
  // pieces ascend, piece b after piece a) first, one a warp in turn
  for (int k = threadIdx.x >> 5; k < pairs; k += warps) {
    const int l0 = 2 * (pairs - 1 - k), l1 = l0 + 1;  // the warp's second row, if any
    const bool two = l1 < rw.count();
    const int i0 = rw.at(l0), i1 = two ? rw.at(l1) : -1, last = i0 > i1 ? i0 : i1;
    auto coef = [&](int l, int j) {
      float p = P[l * Ts + j];
      if (pv) {
        if (pm != nullptr) p = drop(p, pm[l * T + j], keep);
        p = attn_operand(p, T);
      }
      return p;
    };
    float acc0[CPL], acc1[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc0[c] = acc1[c] = 0.f;
    for (int j0 = 0; j0 <= last; j0 += 32) {
      const int j = j0 + lane;
      const float mine0 = j <= i0 ? coef(l0, j) : 0.f, mine1 = j <= i1 ? coef(l1, j) : 0.f;
      const int n = min(32, last + 1 - j0);
      int k = 0;
      for (; k + 8 <= n; k += 8) {  // eight keys a step: their loads overlap
        float p[8], q[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          p[u] = __shfl_sync(0xffffffffu, mine0, k + u);
          q[u] = __shfl_sync(0xffffffffu, mine1, k + u);
        }
        const float* yr = Y + (j0 + k) * ld + lane;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          if (lane + 32 * c >= d) continue;
          float y[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) y[u] = attn_operand(yr[u * ld + 32 * c], T);
          float t = acc0[c], v = acc1[c];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            t = fmaf(p[u], y[u], t);
            v = fmaf(q[u], y[u], v);
          }
          acc0[c] = t;
          acc1[c] = v;
        }
      }
      for (; k < n; ++k) {
        const float p = __shfl_sync(0xffffffffu, mine0, k);
        const float q = __shfl_sync(0xffffffffu, mine1, k);
        const float* yr = Y + (j0 + k) * ld + lane;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          if (lane + 32 * c >= d) continue;
          const float y = attn_operand(yr[32 * c], T);
          acc0[c] = fmaf(p, y, acc0[c]);
          acc1[c] = fmaf(q, y, acc1[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = lane + 32 * c;
      if (col >= d) continue;
      if (pv) {
        out[l0 * ld + col] = MO[l0] == 0.f ? qin[l0 * ld + col] : qin[l0 * ld + col] + acc0[c];
        if (two)
          out[l1 * ld + col] = MO[l1] == 0.f ? qin[l1 * ld + col] : qin[l1 * ld + col] + acc1[c];
      } else {
        out[l0 * ld + col] = attn_operand(acc0[c] / scale, T);
        if (two) out[l1 * ld + col] = attn_operand(acc1[c] / scale, T);
      }
    }
  }
}

// This rank's share of a key-side gradient: F[j] = Σ over the own query
// rows l at positions i >= j, ascending, of coef(l, j) Y[l], for every key
// j < T (0 for a masked key). dV (`dv`): coef = attn_operand(drop_p(P)),
// Y = dA. dK: coef = dS (in P), Y = attn_operand(Q). Two keys a warp (j
// and j + warps), each loaded row of Y serving both: the rows from the
// first key's on, a coefficient past its row's diagonal 0. Lane k forms row
// l0 + k's coefficients, the warp takes them in row order by shuffles; CPL
// columns a lane (d <= 32 CPL). The owner of j adds the ranks' shares
// (cl_combine).
template <int CPL>
__device__ void cl_partials(bool dv, const float* P, const unsigned char* pm, float keep,
                            const float* Y, float* F, const float* MF, Rows rw, int T, int Ts,
                            int d, int ld) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int j = threadIdx.x >> 5; j < T; j += 2 * warps) {
    const int j1 = j + warps;  // the warp's second key, if any
    const bool two = j1 < T;
    auto coef = [&](int l, int key) {
      float p = P[l * Ts + key];
      if (dv) {
        if (pm != nullptr) p = drop(p, pm[l * T + key], keep);
        p = attn_operand(p, T);
      }
      return p;
    };
    float acc0[CPL], acc1[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc0[c] = acc1[c] = 0.f;
    for (int half = 0; half < 2; ++half) {  // piece a's rows, then piece b's
      const int start = half == 0 ? rw.a0 : rw.b0, n = half == 0 ? rw.na : rw.nb;
      const int base = half == 0 ? 0 : rw.na, end = base + n;
      for (int l0 = base + max(0, j - start); l0 < end; l0 += 32) {
        const int l = l0 + lane;
        const float mine0 = l < end ? coef(l, j) : 0.f;
        const float mine1 = two && l < end ? coef(l, j1) : 0.f;
        const int m = min(32, end - l0);
#pragma unroll 4
        for (int k = 0; k < m; ++k) {
          const float p = __shfl_sync(0xffffffffu, mine0, k);
          const float q = __shfl_sync(0xffffffffu, mine1, k);
          const float* yr = Y + (l0 + k) * ld + lane;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            if (lane + 32 * c >= d) continue;
            const float y = dv ? yr[32 * c] : attn_operand(yr[32 * c], T);
            acc0[c] = fmaf(p, y, acc0[c]);
            acc1[c] = fmaf(q, y, acc1[c]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = lane + 32 * c;
      if (col >= d) continue;
      F[j * ld + col] = MF[j] != 0.f ? acc0[c] : 0.f;
      if (two) F[j1 * ld + col] = MF[j1] != 0.f ? acc1[c] : 0.f;
    }
  }
}

// P[l] <- dS[l] = P[l] ∘ (dP[l] - Σ_j dP_lj P_lj) for each unmasked own query
// row (attn_bwd_ds's arithmetic, V the window's values, each lane's dP in
// registers: at most kMaxKeysPerLane keys a lane). Two neighbouring rows a
// warp, the costliest pair first (as cl_rows), each loaded value row serving
// both. Out of line in the bfloat16 form (in line it spills there).
__device__ BF16_NOINLINE void cl_ds(float* P, const unsigned char* pm, float keep, const float* dA,
                                    const float* V, const float* MO, const float* MF, Rows rw,
                                    int T, int Ts, int d, int ld) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5, pairs = (rw.count() + 1) / 2;
  for (int k = threadIdx.x >> 5; k < pairs; k += warps) {
    const int l0 = 2 * (pairs - 1 - k), l1 = l0 + 1;
    const bool two = l1 < rw.count();
    // the last key of each row, -1 for a masked query (dP = 0, so dS = 0)
    const int i0 = MO[l0] != 0.f ? rw.at(l0) : -1;
    const int i1 = two && MO[l1] != 0.f ? rw.at(l1) : -1;
    const int m1 = two ? l1 : l0;
    const float* ar0 = dA + l0 * ld;
    const float* ar1 = dA + m1 * ld;
    float dps0[kMaxKeysPerLane], dps1[kMaxKeysPerLane];
    float rho0 = 0.f, rho1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxKeysPerLane; ++kk) {
      const int j = lane + 32 * kk;
      float dp0 = 0.f, dp1 = 0.f;
      if (j <= (i0 > i1 ? i0 : i1) && MF[j] != 0.f) {  // a masked key's dS is 0
        const float* vr = V + j * ld;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
        for (int c = 0; c < d; c += 4) {
          const float4 v = attn_operand4(*reinterpret_cast<const float4*>(vr + c), T);
          const float4 x = *reinterpret_cast<const float4*>(ar0 + c);
          const float4 y = *reinterpret_cast<const float4*>(ar1 + c);
          a0 = fmaf(x.x, v.x, a0);
          a1 = fmaf(x.y, v.y, a1);
          a2 = fmaf(x.z, v.z, a2);
          a3 = fmaf(x.w, v.w, a3);
          b0 = fmaf(y.x, v.x, b0);
          b1 = fmaf(y.y, v.y, b1);
          b2 = fmaf(y.z, v.z, b2);
          b3 = fmaf(y.w, v.w, b3);
        }
        dp0 = attn_operand((a0 + a1) + (a2 + a3), T);
        dp1 = attn_operand((b0 + b1) + (b2 + b3), T);
      }
      if (j <= i0) {
        if (pm != nullptr) dp0 = drop(dp0, pm[l0 * T + j], keep);
        rho0 = fmaf(dp0, P[l0 * Ts + j], rho0);
      }
      if (j <= i1) {
        if (pm != nullptr) dp1 = drop(dp1, pm[l1 * T + j], keep);
        rho1 = fmaf(dp1, P[l1 * Ts + j], rho1);
      }
      dps0[kk] = dp0;
      dps1[kk] = dp1;
    }
    rho0 = warp_sum(rho0);
    rho1 = warp_sum(rho1);
#pragma unroll
    for (int kk = 0; kk < kMaxKeysPerLane; ++kk) {
      const int j = lane + 32 * kk;
      if (j <= i0) P[l0 * Ts + j] = P[l0 * Ts + j] * (dps0[kk] - rho0);
      if (j <= i1) P[l1 * Ts + j] = P[l1 * Ts + j] * (dps1[kk] - rho1);
    }
  }
}

// dst[l][0, n) = row (row0 + position of own row l) of an [.., n] byte mask:
// 4 bytes at a time where n % 4 == 0 and src and dst are 4-byte aligned,
// else bytes; each thread issues eight loads before it stores them.
__device__ void stage_bytes(const unsigned char* src, size_t row0, unsigned char* dst, Rows rw,
                            int n) {
  constexpr int kBatch = 8;
  const bool words = n % 4 == 0 && reinterpret_cast<size_t>(src) % 4 == 0 &&
                     reinterpret_cast<size_t>(dst) % 4 == 0;
  const int unit = words ? 4 : 1, per = n / unit, total = rw.count() * per;
  for (int base = threadIdx.x; base < total; base += kBatch * blockDim.x) {
    unsigned v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx >= total) break;
      const unsigned char* at = src + (row0 + rw.at(idx / per)) * n + unit * (idx % per);
      v[u] = words ? *reinterpret_cast<const unsigned*>(at) : *at;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx >= total) break;
      if (words)
        reinterpret_cast<unsigned*>(dst)[idx] = v[u];
      else
        dst[idx] = static_cast<unsigned char>(v[u]);
    }
  }
}

// The wide form: one user's window a cluster of `c` CTAs of kWideThreads
// threads, each owning the rows `rows_of(rank)`, everything of its rows in
// its own shared memory (`L` says where); the clusters walk the users.
__global__ void __launch_bounds__(kWideThreads, 1)
sasrec_encoder_bwd_kernel_cluster(const EncoderW w, const DropoutMasks dm, const WideLayout L,
                                  const unsigned char* __restrict__ ids_mask,
                                  const float* __restrict__ g, const float* __restrict__ saved,
                                  float* __restrict__ dx, float* __restrict__ partial, int B,
                                  int T, int d, int c, int ld, int Ts, int ks, int ldk, int slot,
                                  int n_grad) {
  constexpr bool ALIGNED = false;  // the header's 4-byte width path: any d and alignment
  extern __shared__ __align__(16) float smem[];
  WideHead* hs = reinterpret_cast<WideHead*>(smem);
  Group* gs = &hs->g;
  // the own buffers, by their offsets in L; their contents through a block:
  float* const X0 = smem + L.x[0];  // LN_f's input; the attention output A; dV
  float* const X1 = smem + L.x[1];  // q_in; x2; the FFN sum F; dF2; x2 again; dQ
  float* const X2 = smem + L.x[2];  // q; the block input H
  float* const X3 = smem + L.x[3];  // k (the other ranks gather it); q_in again
  float* const X4 = smem + L.x[4];  // v (the other ranks gather it)
  float* const X5 = smem + L.x[5];  // the FFN hidden F1; dZ1; dK
  float* const G = smem + L.x[6];   // the running gradient
  float* const F = smem + L.f;      // [T][ld]: the window's k or v; a rank's dV or dK shares
  float* const P = smem + L.p;      // [R][Ts] probabilities, then dS
  float* const MF = smem + L.mf;    // [T] the window's ids mask as 0/1
  float* const MO = smem + L.mo;    // [R] the own rows'
  float* const LS = smem + L.ls;    // [warps][2d] LayerNorm gradient sums
  // the own rows' dropout masks, staged: the probabilities' [R][T], f1's and
  // f2's [R][d]
  unsigned char* const PMs = reinterpret_cast<unsigned char*>(smem) + L.pm;
  unsigned char* const F1s = reinterpret_cast<unsigned char*>(smem) + L.f1;
  unsigned char* const F2s = reinterpret_cast<unsigned char*>(smem) + L.f2;
  const int nb = w.num_blocks;
  const size_t plane = static_cast<size_t>(B) * T;  // rows of one [B, T, d] of `saved`
  Pipe pp{smem + L.sw, slot, 0, false, ks, ldk};
  if (threadIdx.x == 0) hs->rw = rows_of(static_cast<int>(cg::this_cluster().block_rank()), T, c);
  // rows of a [B, T, d] tensor (LayerNorm's input) into an own buffer, piece
  // by piece
  auto load_own = [&](const float* src, float* dst) {
    load_rows<ALIGNED>(src + (gs->row0 + hs->rw.a0) * d, dst, hs->rw.na, d, ld);
    load_rows<ALIGNED>(src + (gs->row0 + hs->rw.b0) * d, dst + hs->rw.na * ld, hs->rw.nb, d, ld);
  };
  auto ln_own = [&](const float* src, float* copy, float* dst, LayerNormW p) {
    ln_rows<ALIGNED>(src + (gs->row0 + hs->rw.a0) * d, d, copy, dst, p, hs->rw.na, d, ld);
    ln_rows<ALIGNED>(src + (gs->row0 + hs->rw.b0) * d, d,
                     copy == nullptr ? nullptr : copy + hs->rw.na * ld, dst + hs->rw.na * ld, p,
                     hs->rw.nb, d, ld);
  };

  for (int user = blockIdx.x / c; user < B; user += gridDim.x / c) {
    __syncthreads();  // the previous user is done with every buffer and with gs
    ACF_STAMP(0);
    if (threadIdx.x == 0)
      *gs = Group{partial == nullptr ? nullptr : partial + static_cast<size_t>(blockIdx.x) * n_grad,
                  static_cast<size_t>(user) * T,
                  user + static_cast<int>(gridDim.x) / c >= B ? nullptr : w.blocks[nb - 1].wq.w,
                  hs->rw.count(), 1, user == static_cast<int>(blockIdx.x) / c};
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x) MF[t] = ids_mask[gs->row0 + t] ? 1.f : 0.f;
    for (int l = threadIdx.x; l < gs->R; l += blockDim.x)
      MO[l] = ids_mask[gs->row0 + hs->rw.at(l)] ? 1.f : 0.f;
    load_own(g, G);
    load_own(saved + nb * plane * d, X0);
    __syncthreads();
    ln_bwd_rows(X0, G, w.ln_f, nullptr, LS, gs->R, d, ld);  // every row feeds dβ_f
    __syncthreads();
    if (gs->part != nullptr) ln_grad_flush(LS, gs->part + nb * (5 * d * d + 11 * d), gs->first, d);
    ACF_STAMP(24);

    for (int blk = nb - 1; blk >= 0; --blk) {
      const BlockW& p = w.blocks[blk];
      // the block's input saved[blk] and its masks' pointers are formed where
      // they are used
      if (dm.p[blk] != nullptr) stage_bytes(dm.p[blk], gs->row0, PMs, hs->rw, T);
      if (dm.f1[blk] != nullptr) stage_bytes(dm.f1[blk], gs->row0, F1s, hs->rw, d);
      if (dm.f2[blk] != nullptr) stage_bytes(dm.f2[blk], gs->row0, F2s, hs->rw, d);
      ACF_STAMP(1);

      // the rematerialised forward
      ln_own(saved + blk * plane * d, nullptr, X1, p.ln1);  // q_in
      dense<false, 1, ALIGNED, kWideRowsPerThread>(pp, {X1}, {p.wq.w}, WRef{p.wk.w, false}, X2,
                                                   epi(p.wq.b), gs->R, d, ld);
      dense<false, 1, ALIGNED, kWideRowsPerThread>(pp, {X1}, {p.wk.w}, WRef{p.wv.w, false}, X3,
                                                   epi(p.wk.b), gs->R, d, ld);
      dense<false, 1, ALIGNED, kWideRowsPerThread>(pp, {X1}, {p.wv.w}, WRef{p.conv1.w, false},
                                                   X4, epi(p.wv.b), gs->R, d, ld);
      __syncthreads();
      ACF_STAMP(2);
      cg::this_cluster().sync();  // every rank's k and v rows are in place
      ACF_STAMP(3);
      gather(F, X3, T, c, d, ld);  // the window's keys
      __syncthreads();
      ACF_STAMP(4);
      cl_softmax(X2, F, P, MO, MF, hs->rw, T, Ts, d, ld);
      __syncthreads();
      ACF_STAMP(5);
      gather(F, X4, T, c, d, ld);  // the window's values
      __syncthreads();
      ACF_STAMP(6);
      if (d <= 64)  // A
        cl_rows<2>(true, P, dm.p[blk] == nullptr ? nullptr : PMs, dm.keep, F, X1, X0, MO, hs->rw,
                   T, Ts, d, ld);
      else
        cl_rows<4>(true, P, dm.p[blk] == nullptr ? nullptr : PMs, dm.keep, F, X1, X0, MO, hs->rw,
                   T, Ts, d, ld);
      __syncthreads();
      ACF_STAMP(7);
      ln_rows<ALIGNED>(X0, ld, nullptr, X1, p.ln2, gs->R, d, ld);  // x2
      dense<false, 1, ALIGNED, kWideRowsPerThread>(
          pp, {X1}, {p.conv1.w}, WRef{p.conv2.w, false}, X5,
          epi(p.conv1.b, true, dm.f1[blk] == nullptr ? nullptr : F1s, dm.keep), gs->R, d,
          ld);  // F1
      dense<false, 1, ALIGNED, kWideRowsPerThread>(
          pp, {X5}, {p.conv2.w}, WRef{p.conv2.w, true}, X1,
          epi(p.conv2.b, false, dm.f2[blk] == nullptr ? nullptr : F2s, dm.keep, nullptr, X1),
          gs->R, d, ld);  // F
      __syncthreads();
      ACF_STAMP(8);

      // LN3 (its output was masked by the ids mask), then the FFN
      ln_bwd_rows(X1, G, p.ln3, MO, LS, gs->R, d, ld, X1,
                  dm.f2[blk] == nullptr ? nullptr : F2s, dm.keep);  // G = dF, X1 = dF2
      __syncthreads();
      if (gs->part != nullptr) ln_grad_flush(LS, leaf(gs->part, blk, kLn3, d), gs->first, d);
      if (gs->part != nullptr)
        wgrad<1, 2, ALIGNED>(X5, {X1}, {leaf(gs->part, blk, kW2, d)},
                             {leaf(gs->part, blk, kB2, d)}, gs->first, gs->R, d, ld);
      dense<true, 1, ALIGNED, kWideRowsPerThread>(
          pp, {X1}, {p.conv2.w}, WRef{p.conv1.w, true}, X5,
          epi(nullptr, false, dm.f1[blk] == nullptr ? nullptr : F1s, dm.keep, X5), gs->R, d,
          ld);  // dZ1
      __syncthreads();
      ln_rows<ALIGNED>(X0, ld, nullptr, X1, p.ln2, gs->R, d, ld);  // x2 again
      __syncthreads();
      if (gs->part != nullptr)
        wgrad<1, 2, ALIGNED>(X1, {X5}, {leaf(gs->part, blk, kW1, d)},
                             {leaf(gs->part, blk, kB1, d)}, gs->first, gs->R, d, ld);
      // dX2 = dF + dZ1 W1ᵀ
      dense<true, 1, ALIGNED, kWideRowsPerThread>(pp, {X5}, {p.conv1.w}, WRef{p.wq.w, true}, G,
                                                  epi(nullptr, false, nullptr, 1.f, nullptr, G),
                                                  gs->R, d, ld);
      __syncthreads();
      ln_bwd_rows(X0, G, p.ln2, nullptr, LS, gs->R, d, ld);  // G = dA
      __syncthreads();
      if (gs->part != nullptr) ln_grad_flush(LS, leaf(gs->part, blk, kLn2, d), gs->first, d);
      ACF_STAMP(9);

      // attention: dV into X0 (the ranks' shares of it in F), dS over P, dQ
      // into X1, dK into X5 (shares in F again)
      if (d <= 64)
        cl_partials<2>(true, P, dm.p[blk] == nullptr ? nullptr : PMs, dm.keep, G, F, MF, hs->rw,
                       T, Ts, d, ld);
      else
        cl_partials<4>(true, P, dm.p[blk] == nullptr ? nullptr : PMs, dm.keep, G, F, MF, hs->rw,
                       T, Ts, d, ld);
      __syncthreads();
      ACF_STAMP(10);
      cg::this_cluster().sync();  // every rank's shares are in its F
      ACF_STAMP(11);
      cl_combine(F, X0, false, hs->rw, T, c, d, ld);
      __syncthreads();
      ACF_STAMP(12);
      cg::this_cluster().sync();  // no rank reads another's F any more
      ACF_STAMP(13);
      gather(F, X4, T, c, d, ld);  // the window's values again
      __syncthreads();
      ACF_STAMP(14);
      cl_ds(P, dm.p[blk] == nullptr ? nullptr : PMs, dm.keep, G, F, MO, MF, hs->rw, T, Ts, d, ld);
      __syncthreads();
      ACF_STAMP(15);
      gather(F, X3, T, c, d, ld);  // the window's keys again
      __syncthreads();
      ACF_STAMP(16);
      if (d <= 64)  // dQ
        cl_rows<2>(false, P, nullptr, 0.f, F, nullptr, X1, MO, hs->rw, T, Ts, d, ld);
      else
        cl_rows<4>(false, P, nullptr, 0.f, F, nullptr, X1, MO, hs->rw, T, Ts, d, ld);
      __syncthreads();
      ACF_STAMP(17);
      if (d <= 64)
        cl_partials<2>(false, P, nullptr, 0.f, X2, F, MF, hs->rw, T, Ts, d, ld);
      else
        cl_partials<4>(false, P, nullptr, 0.f, X2, F, MF, hs->rw, T, Ts, d, ld);
      __syncthreads();
      ACF_STAMP(18);
      cg::this_cluster().sync();  // shares in place; every rank is done with X3 and X4
      ACF_STAMP(19);
      cl_combine(F, X5, true, hs->rw, T, c, d, ld);
      ACF_STAMP(20);
      ln_own(saved + blk * plane * d, X2, X3, p.ln1);  // H, q_in
      __syncthreads();
      if (gs->part != nullptr)
        wgrad<3, 1, ALIGNED>(X3, {X1, X5, X0},
                             {leaf(gs->part, blk, kWq, d), leaf(gs->part, blk, kWk, d),
                              leaf(gs->part, blk, kWv, d)},
                             {leaf(gs->part, blk, kBq, d), leaf(gs->part, blk, kBk, d),
                              leaf(gs->part, blk, kBv, d)},
                             gs->first, gs->R, d, ld);
      ACF_STAMP(21);
      // dq_in = dA + dQ Wqᵀ + dK Wkᵀ + dV Wvᵀ, added in that order; the
      // next block's (or user's) first weight flies behind them
      const WRef next{blk > 0 ? w.blocks[blk - 1].wq.w : gs->next_wq, false};
      dense<true, 3, ALIGNED, kWideRowsPerThread>(pp, {X1, X5, X0}, {p.wq.w, p.wk.w, p.wv.w},
                                                  next, G,
                                                  epi(nullptr, false, nullptr, 1.f, nullptr, G),
                                                  gs->R, d, ld);
      __syncthreads();
      ln_bwd_rows(X2, G, p.ln1, nullptr, LS, gs->R, d, ld);  // G = the block input's gradient
      __syncthreads();
      if (gs->part != nullptr) ln_grad_flush(LS, leaf(gs->part, blk, kLn1, d), gs->first, d);
      ACF_STAMP(22);
    }

    // the input: x0 = drop_emb(x + pos) * mask
    for (int idx = threadIdx.x; idx < gs->R * d; idx += blockDim.x) {
      const int l = idx / d, col = idx % d;
      const size_t at = (gs->row0 + hs->rw.at(l)) * d + col;
      float v = G[l * ld + col] * MO[l];
      if (dm.emb != nullptr) v = drop(v, dm.emb[at], dm.keep);
      dx[at] = v;
      G[l * ld + col] = v;
    }
    __syncthreads();
    if (gs->part != nullptr) {  // the own positions' dpos; the first user's zeros elsewhere
      float* pos = gs->part + nb * (5 * d * d + 11 * d) + 2 * d;  // after ln_f's
      for (int idx = threadIdx.x; idx < T * d; idx += blockDim.x) {
        const int l = hs->rw.row(idx / d);
        if (l >= 0)
          add_to(pos + idx, G[l * ld + idx % d], gs->first);
        else if (gs->first)
          pos[idx] = 0.f;
      }
    }
    ACF_STAMP(23);
  }
  cg::this_cluster().sync();  // no rank leaves while another may read its shared memory
}

// Whether entry k of the flat gradient (`grad_size`'s layout: per block
// 5 d² + 11 d floats, the leaves at `leaf`'s offsets) is in a dense kernel
// W of one of the nb blocks.
__device__ __forceinline__ bool weight_entry(int k, int nb, int d) {
  const int per = 5 * d * d + 11 * d;
  if (k >= nb * per) return false;
  const int o = k % per;
  const int starts[] = {2 * d, 3 * d + d * d, 4 * d + 2 * d * d, 7 * d + 3 * d * d,
                        8 * d + 4 * d * d};  // wq, wk, wv, conv1, conv2
  for (int w : starts)
    if (o >= w && o < w + d * d) return true;
  return false;
}

// grad[k] = Σ_c partial[c][k], the blocks' slices summed in block order: a
// block of 256 threads takes kReduceOuts outputs, lane k of every warp the
// output blockIdx.x * kReduceOuts + k (each load of a part is one 128-byte
// run), warp s the s-th of kReduceSlices contiguous slices of the parts.
// A thread issues kReduceUnroll loads before it adds them in part order;
// warp 0 then adds the slices in slice order. The order depends on the
// count of parts alone. A weight gradient's sum goes through `operand`: the
// bfloat16 form rounds it once, over the whole batch.
__global__ void __launch_bounds__(kReduceOuts * kReduceSlices)
sasrec_encoder_bwd_reduce(const float* __restrict__ partial, int ctas, int n,
                          float* __restrict__ grad, int nb, int d) {
  __shared__ float ss[kReduceSlices][kReduceOuts];
  const int lane = threadIdx.x % kReduceOuts, slice = threadIdx.x / kReduceOuts;
  const int idx = blockIdx.x * kReduceOuts + lane;
  const int per = (ctas + kReduceSlices - 1) / kReduceSlices;
  const int c0 = min(ctas, slice * per), c1 = min(ctas, c0 + per);
  float s = 0.f;
  for (int c = c0; idx < n && c < c1; c += kReduceUnroll) {
    float v[kReduceUnroll];
#pragma unroll
    for (int k = 0; k < kReduceUnroll; ++k)
      v[k] = c + k < c1 ? partial[static_cast<size_t>(c + k) * n + idx] : 0.f;
#pragma unroll
    for (int k = 0; k < kReduceUnroll; ++k)
      if (c + k < c1) s += v[k];
  }
  ss[slice][lane] = s;
  __syncthreads();
  if (slice != 0 || idx >= n) return;
#pragma unroll
  for (int k = 1; k < kReduceSlices; ++k) s += ss[k][lane];
  grad[idx] = weight_entry(idx, nb, d) ? operand(s) : s;
}

size_t bwd_smem_bytes(int users_per_block, int T, int d, int threads) {
  const size_t rows = static_cast<size_t>(users_per_block) * T;
  const size_t warps = threads / 32;
  const size_t Ts = score_ld(T);
  return (kGroupFloats + kBuffers * rows * row_ld(pad4(d)) + rows * Ts +
          2 * static_cast<size_t>(slot_floats(pad4(d), slice_rows(pad4(d)))) + warps * Ts + rows +
          warps * 2 * d +
          (rows * T + 3) / 4) *
         sizeof(float);
}

// The wide form's shared-memory layout at cluster size c and weight slices
// of ks rows (_bwd_wide_bytes in ops/sasrec_fused.py): its head, seven own
// [R][ld] buffers, the window's [T][ld] (F), the own [R][Ts] probabilities,
// two weight slots, the window's and the own ids masks, the [warps][2d]
// LayerNorm sums and the own rows' dropout masks as bytes. Returns the bytes.
size_t wide_layout(int T, int d, int c, int ks, WideLayout* L) {
  const int R = cluster_rows(T, c), ld = row_ld(pad4(d)), warps = kWideThreads / 32;
  int at = kWideHeadFloats;
  for (int k = 0; k < kBuffers; ++k, at += R * ld) L->x[k] = at;
  L->f = at;
  at += T * ld;
  L->p = at;
  at += R * score_ld(T);
  L->sw = at;
  at += 2 * slot_floats(pad4(d), ks);
  L->mf = at;
  at += T;
  L->mo = at;
  at += R;
  L->ls = at;
  at += warps * 2 * d;
  L->pm = 4 * at;
  L->f1 = L->pm + R * T;
  L->f2 = L->f1 + R * d;
  return 4 * static_cast<size_t>(at) + (static_cast<size_t>(R) * T + 2 * R * d + 3) / 4 * 4;
}

using BwdKernel = decltype(&sasrec_encoder_bwd_kernel);

// The number of blocks of `kernel` the current device runs at once with this
// launch geometry; 0 if none fits, a negative cudaError_t on an error.
int resident_blocks(BwdKernel kernel, int threads, int smem_bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// The reduction of the blocks' partial slices into `grad`, on `s`.
cudaError_t reduce_partials(const float* partial, int ctas, int n_grad, float* grad, int nb,
                            int d, cudaStream_t s) {
  const int blocks = (n_grad + kReduceOuts - 1) / kReduceOuts;
  sasrec_encoder_bwd_reduce<<<blocks, kReduceOuts * kReduceSlices, 0, s>>>(partial, ctas, n_grad,
                                                                        grad, nb, d);
  return cudaGetLastError();
}

// The wide form's launch at cluster size `cluster` with `smem_bytes` of
// shared memory a CTA.
cudaLaunchConfig_t wide_config(int ctas, int cluster, int smem_bytes, cudaStream_t s,
                               cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The number of K2b blocks (the tile form) the current device runs at once
// with this launch geometry (the persistent grid of the weight-gradient
// mode); 0 if none fits, a negative cudaError_t on an error.
extern "C" int ENCODER_ENTRY(acf_sasrec_encoder_bwd_ctas)(int threads, int smem_bytes) {
  return resident_blocks(&sasrec_encoder_bwd_kernel, threads, smem_bytes);
}

// The number of CTAs of the wide form (whole clusters of `cluster`) that the
// current device runs at once with `smem_bytes` a CTA: its persistent grid
// in both modes; 0 if none fits, a negative cudaError_t on an error.
extern "C" int ENCODER_ENTRY(acf_sasrec_encoder_bwd_wide_ctas)(int cluster, int smem_bytes) {
  if (cluster < 1 || cluster > kClusterMax) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(sasrec_encoder_bwd_kernel_cluster,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wide_config(cluster, cluster, smem_bytes, nullptr, &attr);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, sasrec_encoder_bwd_kernel_cluster, &cfg);
  return err == cudaSuccess ? clusters * cluster : -static_cast<int>(err);
}

// The tile form. Writes dx [B, T, d] and, when `partial` and `grad` are not
// null, the flat gradient `grad` (ops/sasrec_fused.py `grad_size` floats)
// through the [ctas, grad_size] `partial` workspace, on `stream`. `saved`
// holds the block inputs K2a's training form wrote. `users_per_block`,
// `threads` and `smem_bytes` come from the wrapper's layout (`_bwd_layout`);
// a launch whose bytes disagree with this file's formula, or whose rows a
// product's register tile cannot cover, is refused. Without gradients `ctas`
// must be the number of user groups; d % 4 != 0 or a g, saved or weight
// that is not 16-byte aligned is refused (the wide form takes them).
// Returns the cudaError_t of the launches.
extern "C" int ENCODER_ENTRY(acf_sasrec_encoder_bwd)(EncoderW w, DropoutMasks dm,
                                                     const unsigned char* ids_mask,
                                                     const float* g, const float* saved,
                                                     float* dx, float* partial, float* grad,
                                                     int B, int T, int d, int users_per_block,
                                                     int threads, int smem_bytes, int ctas,
                                                     void* stream) {
  if (B <= 0 || T <= 0 || d <= 0 || d > 32 * kMaxColsPerLane ||
      users_per_block <= 0 || (threads != 256 && threads != kMaxThreads) ||
      users_per_block * T > kMaxRowsPerThread * (threads / (pad4(d) / 4)) ||
      w.num_blocks < 0 || w.num_blocks > kMaxBlocks || (partial == nullptr) != (grad == nullptr))
    return (int)cudaErrorInvalidValue;
  const int groups = (B + users_per_block - 1) / users_per_block;
  if (ctas <= 0 || ctas > groups || (partial == nullptr && ctas != groups))
    return (int)cudaErrorInvalidValue;
  if (bwd_smem_bytes(users_per_block, T, d, threads) != static_cast<size_t>(smem_bytes))
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem_bytes > optin) return (int)cudaErrorInvalidValue;
  if (!weights_aligned(w, d) || !aligned16(g) || !aligned16(saved))
    return (int)cudaErrorInvalidValue;
  const BwdKernel kernel = &sasrec_encoder_bwd_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_grad = w.num_blocks * (5 * d * d + 11 * d) + 2 * d + T * d;
  const int ks = slice_rows(pad4(d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<ctas, threads, smem_bytes, s>>>(
      w, dm, ids_mask, g, saved, dx, partial, B, T, d, users_per_block,
      row_ld(pad4(d)), score_ld(T), ks, row_ld(ks), slot_floats(pad4(d), ks), n_grad, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  return (int)reduce_partials(partial, ctas, n_grad, grad, w.num_blocks, d, s);
}

// The wide form (one user's window a cluster of `cluster` CTAs), as
// acf_sasrec_encoder_bwd. `cluster`, `ks` and `smem_bytes` come from the
// wrapper's layout (`_bwd_wide_layout`), `ctas` (whole clusters, at most one
// a user, in both modes) from acf_sasrec_encoder_bwd_wide_ctas; a launch
// whose bytes disagree with this file's formula, whose rows a product's
// register tile cannot cover or whose window the dS registers cannot hold
// is refused, and so is a cluster size the card refuses (no fallback).
// Returns the cudaError_t of the launches.
extern "C" int ENCODER_ENTRY(acf_sasrec_encoder_bwd_wide)(EncoderW w, DropoutMasks dm,
                                                          const unsigned char* ids_mask,
                                                          const float* g, const float* saved,
                                                          float* dx, float* partial, float* grad,
                                                          int B, int T, int d, int cluster,
                                                          int ks, int smem_bytes, int ctas,
                                                          void* stream) {
  if (B <= 0 || T <= 0 || T > 32 * kMaxKeysPerLane || d <= 0 || d > 32 * kMaxColsPerLane ||
      w.num_blocks < 0 || w.num_blocks > kMaxBlocks ||
      (partial == nullptr) != (grad == nullptr) || cluster < 1 || cluster > kClusterMax ||
      (cluster & (cluster - 1)) != 0 || ctas <= 0 || ctas % cluster != 0 ||
      ctas / cluster > B || ks < 4 || ks % 4 != 0 || ks > slice_rows(pad4(d)) ||
      cluster_rows(T, cluster) > kWideRowsPerThread * (kWideThreads / (pad4(d) / 4)))
    return (int)cudaErrorInvalidValue;
  WideLayout L;
  if (wide_layout(T, d, cluster, ks, &L) != static_cast<size_t>(smem_bytes))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sasrec_encoder_bwd_kernel_cluster,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_grad = w.num_blocks * (5 * d * d + 11 * d) + 2 * d + T * d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wide_config(ctas, cluster, smem_bytes, s, &attr);
  err = cudaLaunchKernelEx(&cfg, sasrec_encoder_bwd_kernel_cluster, w, dm, L, ids_mask, g, saved,
                           dx, partial, B, T, d, cluster, row_ld(pad4(d)), score_ld(T), ks,
                           row_ld(ks), slot_floats(pad4(d), ks), n_grad);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  return (int)reduce_partials(partial, ctas, n_grad, grad, w.num_blocks, d, s);
}
