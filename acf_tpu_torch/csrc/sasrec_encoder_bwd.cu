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
//   * The wide form (WIDE: every window the seven shared buffers cannot
//     hold, up to K2a's widest, max_window(d)): the same phases and the
//     same code, one user a block, its seven [T][ld] buffers and its [T][Ts]
//     probabilities in the block's slice of a device workspace [grid, 7 T ld
//     + T Ts] (540,800 bytes at T=200, d=64: the grid's slices stay near the
//     50 MB L2), the probabilities' dropout mask read where it lies; shared
//     memory keeps the weight slots, the score rows, the ids mask, the
//     LayerNorm sums and the group's scalars. A product runs over the
//     window in chunks of the tile form's rows. 256 threads a block, so a
//     thread may keep 255 registers (the chunks' pointers beside the
//     products' tiles spill at 128). The grid is persistent in
//     both modes (the dx-only one too), so the workspace is as large as the
//     card runs at once. The weight gradients keep the partial slices and
//     the reduction: two calls give the same bits.
//   * Any width d <= 128 (the header's widths): the tile form copies rows
//     16 bytes at a time and takes d % 4 == 0 with g, saved and the weights
//     16-byte aligned (its C entry refuses anything else); the wide form
//     copies 4 bytes at a time and takes any width and alignment, so the
//     wrapper gives it every launch the tile form does not take (its
//     4-byte copies inside the products spill at 128 registers). The
//     LayerNorms' moments and every write to device memory take the d real
//     columns; products, dots and the weight gradients' tiles run over
//     pad4(d), whose tail adds exact zeros.
// Requires d <= 128 (checked by the wrapper).

#include "sasrec_encoder.cuh"

namespace {

constexpr int kBuffers = 7;          // BWD_BUFFERS in ops/sasrec_fused.py
constexpr int kMaxRowsPerThread = 3; // rows of a product's register tile
constexpr int kWideThreads = 256;    // BWD_WIDE_THREADS: the wide form's block, 255 registers
constexpr int kGroupFloats = 12;     // BWD_GROUP_FLOATS: the group's scalars (struct Group)
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
inline int slot_floats(int d) {
  const int ks = slice_rows(d);
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
// or 3 rows. The wide form's window (more rows than that) goes through in
// chunks of 3 row_groups rows, each streaming the whole weight, the next
// chunk's first slice staged during this one's last.
template <bool TRANS, int NP, bool WIDE, bool ALIGNED>
__device__ void dense(Pipe& pp, const float* const (&in)[NP], const float* const (&W)[NP],
                      WRef next, float* out, const Epilogue& e, int R, int d, int ld) {
  const int row_groups = blockDim.x / ((ALIGNED ? d : pad4(d)) / 4);
  if constexpr (WIDE) {
    const int chunk = kMaxRowsPerThread * row_groups;
    for (int r0 = 0; r0 < R; r0 += chunk) {
      const float* rows_in[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) rows_in[p] = in[p] + r0 * ld;
      const Epilogue rows_e{e.bias, e.relu, e.mask == nullptr ? nullptr : e.mask + r0 * d, e.keep,
                            e.gate == nullptr ? nullptr : e.gate + r0 * ld,
                            e.res == nullptr ? nullptr : e.res + r0 * ld};
      dense<TRANS, NP, false, ALIGNED>(pp, rows_in, W,
                                       r0 + chunk < R ? WRef{W[0], TRANS} : next,
                                       out + r0 * ld, rows_e, min(chunk, R - r0), d, ld);
    }
  } else if (R <= row_groups) {
    product<1, TRANS, NP, ALIGNED>(pp, in, W, next, out, e, R, d, ld);
  } else if (R <= 2 * row_groups) {
    product<2, TRANS, NP, ALIGNED>(pp, in, W, next, out, e, R, d, ld);
  } else {
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

// Floats of a block's slice of the wide form's workspace: seven [rows][ld]
// buffers and the [rows][Ts] probabilities (_bwd_wide_layout in
// ops/sasrec_fused.py).
__host__ __device__ inline size_t wide_work_floats(int rows, int ld, int Ts) {
  return static_cast<size_t>(rows) * (kBuffers * ld + Ts);
}

// WIDE: the wide form (one user a block, the buffers in `work`), else the
// tile form.
template <bool WIDE>
__global__ void __launch_bounds__(WIDE ? kWideThreads : kMaxThreads, 1)
sasrec_encoder_bwd_kernel(const EncoderW w, const DropoutMasks dm,
                          const unsigned char* __restrict__ ids_mask,
                          const float* __restrict__ g, const float* __restrict__ saved,
                          float* __restrict__ dx, float* __restrict__ partial, float* work,
                          int B, int T, int d, int users_per_block, int ld, int Ts, int ks,
                          int ldk, int slot, int n_grad, int groups) {
  // the header's width paths: the tile form copies 16 bytes at a time, the
  // wide form 4 bytes at a time
  constexpr bool ALIGNED = !WIDE;
  extern __shared__ __align__(16) float smem[];
  const int rows = users_per_block * T;
  const int warps = blockDim.x >> 5;
  Group* gs = reinterpret_cast<Group*>(smem);
  // seven [rows][ld] buffers (the wide form's in its slice of `work`); their
  // contents through one encoder block:
  float* X0 = WIDE ? work + blockIdx.x * wide_work_floats(rows, ld, Ts)
                   : smem + kGroupFloats;  // LN_f's input; the attention output A; dV
  float* X1 = X0 + rows * ld;    // q_in; x2; the FFN sum F; dF2; x2 again; dQ
  float* X2 = X1 + rows * ld;    // q; the block input H
  float* X3 = X2 + rows * ld;    // k; q_in again
  float* X4 = X3 + rows * ld;    // v
  float* X5 = X4 + rows * ld;    // the FFN hidden F1; dZ1; dK
  float* G = X5 + rows * ld;     // the running gradient
  float* P = G + rows * ld;      // [rows][Ts] probabilities, then dS
  float* SW = WIDE ? smem + kGroupFloats : P + rows * Ts;  // two weight slots
  float* S = SW + 2 * slot;      // [warps][Ts] score rows
  float* M = S + warps * Ts;     // [rows] ids mask as 0/1
  float* LS = M + rows;          // [warps][2d] LayerNorm gradient sums
  // the probabilities' dropout mask, [rows][T]: staged here (the tile form)
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
      // saved[blk], the dropout masks (the probabilities' staged in PMs, or
      // read where they lie)

      // the rematerialised forward
      const unsigned char* PM = PMs;
      if constexpr (WIDE) {  // read where it lies
        PM = dm.p[blk] == nullptr ? nullptr : dm.p[blk] + gs->row0 * T;
      } else if (dm.p[blk] != nullptr) {
        for (int idx = threadIdx.x; idx < gs->R * T; idx += blockDim.x)
          PMs[idx] = dm.p[blk][gs->row0 * T + idx];
      }
      ln_rows<ALIGNED>(saved + (blk * plane + gs->row0) * d, d, nullptr, X1, p.ln1, gs->R, d,
                       ld);  // q_in
      dense<false, 1, WIDE, ALIGNED>(pp, {X1}, {p.wq.w}, WRef{p.wk.w, false}, X2, epi(p.wq.b),
                                     gs->R, d, ld);
      dense<false, 1, WIDE, ALIGNED>(pp, {X1}, {p.wk.w}, WRef{p.wv.w, false}, X3, epi(p.wk.b),
                                     gs->R, d, ld);
      dense<false, 1, WIDE, ALIGNED>(pp, {X1}, {p.wv.w}, WRef{p.conv1.w, false}, X4, epi(p.wv.b),
                                     gs->R, d, ld);
      __syncthreads();
      attention_fwd(X2, X3, X4, X1, X0, S, P, dm.p[blk] == nullptr ? nullptr : PM, dm.keep, M,
                    gs->R, T, Ts, d, ld);
      __syncthreads();
      ln_rows<ALIGNED>(X0, ld, nullptr, X1, p.ln2, gs->R, d, ld);  // x2
      dense<false, 1, WIDE, ALIGNED>(
          pp, {X1}, {p.conv1.w}, WRef{p.conv2.w, false}, X5,
          epi(p.conv1.b, true, mask_rows(dm.f1[blk], gs->row0, d), dm.keep), gs->R, d, ld);  // F1
      dense<false, 1, WIDE, ALIGNED>(
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
      dense<true, 1, WIDE, ALIGNED>(
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
      dense<true, 1, WIDE, ALIGNED>(pp, {X5}, {p.conv1.w}, WRef{p.wq.w, true}, G,
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
      dense<true, 3, WIDE, ALIGNED>(pp, {X1, X5, X0}, {p.wq.w, p.wk.w, p.wv.w}, next, G,
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
          2 * static_cast<size_t>(slot_floats(pad4(d))) + warps * Ts + rows + warps * 2 * d +
          (rows * T + 3) / 4) *
         sizeof(float);
}

// The wide form's shared memory (_bwd_wide_layout in ops/sasrec_fused.py):
// the group's scalars, two weight slots, the score rows, the ids mask and
// the LayerNorm sums of one user's window.
size_t bwd_wide_smem_bytes(int T, int d, int threads) {
  const size_t warps = threads / 32;
  return (kGroupFloats + 2 * static_cast<size_t>(slot_floats(pad4(d))) + warps * score_ld(T) +
          T + warps * 2 * d) *
         sizeof(float);
}

using BwdKernel = decltype(&sasrec_encoder_bwd_kernel<false>);

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

}  // namespace

// The number of K2b blocks (the tile form) the current device runs at once
// with this launch geometry (the persistent grid of the weight-gradient
// mode); 0 if none fits, a negative cudaError_t on an error.
extern "C" int ENCODER_ENTRY(acf_sasrec_encoder_bwd_ctas)(int threads, int smem_bytes) {
  return resident_blocks(&sasrec_encoder_bwd_kernel<false>, threads, smem_bytes);
}

// The same for the wide form (its persistent grid in both modes).
extern "C" int ENCODER_ENTRY(acf_sasrec_encoder_bwd_wide_ctas)(int threads, int smem_bytes) {
  return resident_blocks(&sasrec_encoder_bwd_kernel<true>, threads, smem_bytes);
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
  const BwdKernel kernel = &sasrec_encoder_bwd_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_grad = w.num_blocks * (5 * d * d + 11 * d) + 2 * d + T * d;
  const int ks = slice_rows(pad4(d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<ctas, threads, smem_bytes, s>>>(
      w, dm, ids_mask, g, saved, dx, partial, nullptr, B, T, d, users_per_block,
      row_ld(pad4(d)), score_ld(T), ks, row_ld(ks), slot_floats(pad4(d)), n_grad, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  return (int)reduce_partials(partial, ctas, n_grad, grad, w.num_blocks, d, s);
}

// The wide form (one user a block), as acf_sasrec_encoder_bwd, its buffers in
// `work`: [ctas, 7 T ld + T Ts] floats (`_bwd_wide_layout`). `ctas` blocks
// walk the B users (1 <= ctas <= B, in both modes); `threads` and
// `smem_bytes` come from the wrapper's layout, and a launch whose bytes
// disagree with this file's formula is refused.
extern "C" int ENCODER_ENTRY(acf_sasrec_encoder_bwd_wide)(EncoderW w, DropoutMasks dm,
                                                          const unsigned char* ids_mask,
                                                          const float* g, const float* saved,
                                                          float* dx, float* partial, float* grad,
                                                          float* work, int B, int T, int d,
                                                          int threads, int smem_bytes, int ctas,
                                                          void* stream) {
  if (B <= 0 || T <= 0 || d <= 0 || d > 32 * kMaxColsPerLane || threads != kWideThreads ||
      w.num_blocks < 0 || w.num_blocks > kMaxBlocks ||
      (partial == nullptr) != (grad == nullptr) || work == nullptr || ctas <= 0 || ctas > B)
    return (int)cudaErrorInvalidValue;
  if (bwd_wide_smem_bytes(T, d, threads) != static_cast<size_t>(smem_bytes))
    return (int)cudaErrorInvalidValue;
  const BwdKernel kernel = &sasrec_encoder_bwd_kernel<true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_grad = w.num_blocks * (5 * d * d + 11 * d) + 2 * d + T * d;
  const int ks = slice_rows(pad4(d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<ctas, threads, smem_bytes, s>>>(
      w, dm, ids_mask, g, saved, dx, partial, work, B, T, d, 1, row_ld(pad4(d)), score_ld(T), ks,
      row_ld(ks), slot_floats(pad4(d)), n_grad, B);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  return (int)reduce_partials(partial, ctas, n_grad, grad, w.num_blocks, d, s);
}
