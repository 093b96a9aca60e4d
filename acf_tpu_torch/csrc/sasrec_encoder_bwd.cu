// K2b — SASRec encoder backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `bwd_kernel` in acf_tpu/ops/sasrec_fused.py:236
// (the custom VJP of `fused_encoder`, :279-328): single head, float32, with
// or without dropout masks. For one cotangent g [B, T, d] of the encoder's
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
// reference's -2³²+1 underflows to a probability of exactly 0), so they are
// skipped, which is exact.
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
// Design (simple first: plain fp32 FMAs, no TF32, no fast math):
//   * Memory: K2a's training form saves each block's input (and LN_f's) to
//     a [nb + 1, B, T, d] workspace. K2b rematerialises one block at a time
//     from its saved input, in shared memory, with the forward's own device
//     steps (sasrec_encoder.cuh), and backpropagates through it. Ten
//     [rows][ld] buffers (the block input, q_in, q, k, v, the attention
//     output, x2, the FFN hidden, the FFN sum, the running gradient), the
//     [rows][Ts] softmax probabilities (overwritten by dS), one score row
//     per warp, the ids mask and a [warps][2d] scratch: 152,360 bytes at
//     T=50, d=64, so windows up to T=74 at d=64 (check_supported).
//     Buffers are reused as soon as they are dead (dV, dQ, dK take the
//     attention output's, x2's and the hidden's places).
//   * Weight gradients without atomics: a persistent grid of as many
//     blocks as fit the card at once. Block c walks the user groups c,
//     c + grid, ... and adds each group's gradients into a partial slice
//     of device memory that it alone owns (the first group stores); a
//     second kernel sums the slices in block order. Every sum has a fixed
//     order, so two calls on the same inputs give bit-identical gradients.
//     The products Xᵀ dY are written out here (4 x 4 register tiles per
//     thread, rows in order, masked rows skipped).
//   * LayerNorm parameter gradients: each warp sums its rows' dy x̂ and dy
//     in registers, then the warps' sums are added in warp order.
//   * Attention backward: one warp per row, as in K2a: a query row's dP and
//     dS over its keys j <= i and its dQ; a key row's dV and dK over the
//     queries i >= j (reading the probability column).
//   * dx only (the inner FGSM gradient of ASASRec: only x needs a
//     gradient): no partial slices, no weight-gradient work, no second
//     kernel; one block per user group.
// Requires d % 4 == 0, d <= 128, 16-byte aligned tensors and 4-byte aligned
// [., d] masks (checked by the wrapper).

#include "sasrec_encoder.cuh"

namespace {

constexpr int kBuffers = 10;  // BWD_BUFFERS in ops/sasrec_fused.py

// Offsets of one block's leaves in the flat gradient (grad_size and
// _grad_tree in ops/sasrec_fused.py): ln1, wq, wk, wv, ln2, conv1, conv2,
// ln3, each LayerNorm as gamma then beta and each dense as w then b.
struct BlockGradOff { int ln1, wq, bq, wk, bk, wv, bv, ln2, w1, b1, w2, b2, ln3; };

__device__ BlockGradOff block_grad_off(int blk, int d) {
  const int o = blk * (5 * d * d + 11 * d), dd = d * d;
  return {o,                    o + 2 * d,            o + 2 * d + dd,
          o + 3 * d + dd,       o + 3 * d + 2 * dd,   o + 4 * d + 2 * dd,
          o + 4 * d + 3 * dd,   o + 5 * d + 3 * dd,   o + 7 * d + 3 * dd,
          o + 7 * d + 4 * dd,   o + 8 * d + 4 * dd,   o + 8 * d + 5 * dd,
          o + 9 * d + 5 * dd};
}

__device__ __forceinline__ void add_to(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

// part[k][c] (+)= Σ_r X[r][k] dY[r][c] over the unmasked rows (masked rows
// have dY = 0 exactly); each thread owns 4 x 4 tiles and sums rows in order.
__device__ void wgrad(const float* X, const float* dY, const float* M, float* part,
                      bool first, int R, int d, int ld) {
  const int n4 = d / 4;
  for (int tile = threadIdx.x; tile < n4 * n4; tile += blockDim.x) {
    const int k0 = 4 * (tile / n4), c0 = 4 * (tile % n4);
    float4 acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < R; ++r) {
      if (M[r] == 0.f) continue;
      const float4 a = *reinterpret_cast<const float4*>(X + r * ld + k0);
      const float4 g = *reinterpret_cast<const float4*>(dY + r * ld + c0);
      fma4(acc[0], a.x, g);
      fma4(acc[1], a.y, g);
      fma4(acc[2], a.z, g);
      fma4(acc[3], a.w, g);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* dst = reinterpret_cast<float4*>(part + (k0 + i) * d + c0);
      float4 o = acc[i];
      if (!first) {
        const float4 p = *dst;
        o = make_float4(p.x + o.x, p.y + o.y, p.z + o.z, p.w + o.w);
      }
      *dst = o;
    }
  }
}

// part[c] (+)= Σ_r dY[r][c] over the unmasked rows.
__device__ void bgrad(const float* dY, const float* M, float* part, bool first, int R,
                      int d, int ld) {
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < R; ++r)
      if (M[r] != 0.f) s += dY[r * ld + c];
    add_to(part + c, s, first);
  }
}

// G[r] <- LNᵀ(G[r] (* M[r] when M is given)) for the LayerNorm whose input
// rows are X (its moments recomputed as the forward computes them); one
// warp per row. Each warp's Σ dy x̂ and Σ dy go to scratch[warp][0, d) and
// [d, 2d).
__device__ void ln_bwd_rows(const float* X, float* G, LayerNormW p, const float* M,
                            float* scratch, int R, int d, int ld) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float pg[kMaxColsPerLane], pb[kMaxColsPerLane];
#pragma unroll
  for (int m = 0; m < kMaxColsPerLane; ++m) pg[m] = pb[m] = 0.f;
  for (int r = warp; r < R; r += blockDim.x >> 5) {
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
    const float keep = M == nullptr ? 1.f : M[r];
    float xh[kMaxColsPerLane], dxh[kMaxColsPerLane];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxColsPerLane; ++m) {
      const int c = lane + 32 * m;
      xh[m] = dxh[m] = 0.f;
      if (c < d) {
        xh[m] = (v[m] - mean) / sigma;
        const float dy = G[r * ld + c] * keep;
        pg[m] = fmaf(dy, xh[m], pg[m]);
        pb[m] += dy;
        dxh[m] = dy * __ldg(p.gamma + c);
        s1 += dxh[m];
        s2 = fmaf(dxh[m], xh[m], s2);
      }
    }
    const float m1 = warp_sum(s1) / d;
    const float m2 = warp_sum(s2) / d;
#pragma unroll
    for (int m = 0; m < kMaxColsPerLane; ++m) {
      const int c = lane + 32 * m;
      if (c < d) G[r * ld + c] = (dxh[m] - m1 - xh[m] * m2) / sigma;
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxColsPerLane; ++m) {
    const int c = lane + 32 * m;
    if (c < d) {
      scratch[warp * 2 * d + c] = pg[m];
      scratch[warp * 2 * d + d + c] = pb[m];
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

// dV[j] = Σ_{i >= j} p'_ij dA[i] over the unmasked queries i of key j's
// user (p' = drop_p(P)); 0 for a masked key. One warp per key row.
__device__ void attn_bwd_dv(const float* P, const unsigned char* pm, float keep,
                            const float* dA, float* dV, const float* M, int R, int T, int Ts,
                            int d, int ld) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < R; j += blockDim.x >> 5) {
    float acc[kMaxColsPerLane];
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) acc[c] = 0.f;
    if (M[j] != 0.f) {
      const int jj = j % T, u0 = j - jj;
      for (int i = j; i < u0 + T; ++i) {
        if (M[i] == 0.f) continue;
        float p = P[i * Ts + jj];
        if (pm != nullptr) p = drop(p, pm[i * T + jj], keep);
        const float* ar = dA + i * ld + lane;
#pragma unroll
        for (int c = 0; c < kMaxColsPerLane; ++c)
          if (lane + 32 * c < d) acc[c] = fmaf(p, ar[32 * c], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c)
      if (lane + 32 * c < d) dV[j * ld + lane + 32 * c] = acc[c];
  }
}

// P[r] <- dS[r] = P[r] ∘ (dP[r] - Σ_j dP_rj P_rj), dP_rj = drop_p(dA[r]·V[j]),
// over the keys j <= r of an unmasked query row r. One warp per row;
// `scores` holds one row of dP per warp.
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
          const float4 b = *reinterpret_cast<const float4*>(vr + c);
          a0 = fmaf(a.x, b.x, a0);
          a1 = fmaf(a.y, b.y, a1);
          a2 = fmaf(a.z, b.z, a2);
          a3 = fmaf(a.w, b.w, a3);
        }
        dp = (a0 + a1) + (a2 + a3);
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

// dQ[r] = Σ_{j <= r} dS_rj K[j] / √d for an unmasked query row r (else 0).
__device__ void attn_bwd_dq(const float* dS, const float* K, float* dQ, const float* M,
                            int R, int T, int Ts, int d, int ld) {
  const int lane = threadIdx.x & 31;
  const float scale = sqrtf(static_cast<float>(d));
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
    float acc[kMaxColsPerLane];
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) acc[c] = 0.f;
    if (M[r] != 0.f) {
      const int i = r % T, u0 = r - i;
      for (int j = 0; j <= i; ++j) {
        const float ds = dS[r * Ts + j];
        const float* kr = K + (u0 + j) * ld + lane;
#pragma unroll
        for (int c = 0; c < kMaxColsPerLane; ++c)
          if (lane + 32 * c < d) acc[c] = fmaf(ds, kr[32 * c], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c)
      if (lane + 32 * c < d) dQ[r * ld + lane + 32 * c] = acc[c] / scale;
  }
}

// dK[j] = Σ_{i >= j} dS_ij Q[i] / √d over the unmasked queries i (0 for a
// masked key).
__device__ void attn_bwd_dk(const float* dS, const float* Q, float* dK, const float* M,
                            int R, int T, int Ts, int d, int ld) {
  const int lane = threadIdx.x & 31;
  const float scale = sqrtf(static_cast<float>(d));
  for (int j = threadIdx.x >> 5; j < R; j += blockDim.x >> 5) {
    float acc[kMaxColsPerLane];
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) acc[c] = 0.f;
    if (M[j] != 0.f) {
      const int jj = j % T, u0 = j - jj;
      for (int i = j; i < u0 + T; ++i) {
        if (M[i] == 0.f) continue;
        const float ds = dS[i * Ts + jj];
        const float* qr = Q + i * ld + lane;
#pragma unroll
        for (int c = 0; c < kMaxColsPerLane; ++c)
          if (lane + 32 * c < d) acc[c] = fmaf(ds, qr[32 * c], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c)
      if (lane + 32 * c < d) dK[j * ld + lane + 32 * c] = acc[c] / scale;
  }
}

// dst[r] = src rows [R, d] of device memory into [R][ld] shared memory.
__device__ void load_rows(const float* src, float* dst, int R, int d, int ld) {
  const int groups = d / 4;
  for (int idx = threadIdx.x; idx < R * groups; idx += blockDim.x) {
    const int r = idx / groups, c = (idx % groups) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + c) = ldg4(src + r * d + c);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
sasrec_encoder_bwd_kernel(const EncoderW w, const DropoutMasks dm,
                          const unsigned char* __restrict__ ids_mask,
                          const float* __restrict__ g, const float* __restrict__ saved,
                          float* __restrict__ dx, float* __restrict__ partial, int B, int T,
                          int d, int users_per_block, int ld, int Ts, int n_grad, int groups) {
  extern __shared__ __align__(16) float smem[];
  const int rows = users_per_block * T;
  const int warps = blockDim.x >> 5;
  float* H = smem;                  // the block's input (LN1's)
  float* QIN = H + rows * ld;       // q_in
  float* Q = QIN + rows * ld;
  float* K = Q + rows * ld;
  float* V = K + rows * ld;
  float* A = V + rows * ld;         // attention output (LN2's input); then dV
  float* X2 = A + rows * ld;        // LN2's output; then dQ
  float* F1 = X2 + rows * ld;       // FFN hidden after dropout; then dZ1; then dK
  float* F = F1 + rows * ld;        // FFN sum (LN3's input); then dF2
  float* G = F + rows * ld;         // the running gradient
  float* P = G + rows * ld;         // [rows][Ts] probabilities, then dS
  float* S = P + rows * Ts;         // [warps][Ts] score rows
  float* M = S + warps * Ts;        // [rows] ids mask as 0/1
  float* LS = M + rows;             // [warps][2d] LayerNorm gradient sums
  const float keep = dm.keep;
  const BlockBufs bufs{H, QIN, Q, K, V, A, X2, F1, F, P, S, M};
  const size_t plane = static_cast<size_t>(B) * T * d;  // one [B, T, d] of `saved`
  const int nb = w.num_blocks;
  const int lnf_off = nb * (5 * d * d + 11 * d);
  const int pos_off = lnf_off + 2 * d;

  for (int group = blockIdx.x; group < groups; group += gridDim.x) {
    const bool first = group == static_cast<int>(blockIdx.x);
    const int b0 = group * users_per_block;
    const int users = min(users_per_block, B - b0);
    const int R = users * T;
    const size_t row0 = static_cast<size_t>(b0) * T;
    float* part = partial == nullptr ? nullptr : partial + static_cast<size_t>(blockIdx.x) * n_grad;
    __syncthreads();  // the previous group is done with every buffer
    for (int r = threadIdx.x; r < R; r += blockDim.x) M[r] = ids_mask[row0 + r] ? 1.f : 0.f;
    load_rows(g + row0 * d, G, R, d, ld);
    load_rows(saved + nb * plane + row0 * d, H, R, d, ld);
    __syncthreads();
    ln_bwd_rows(H, G, w.ln_f, nullptr, LS, R, d, ld);  // every row feeds dβ_f
    __syncthreads();
    if (part != nullptr) ln_grad_flush(LS, part + lnf_off, first, d);

    for (int blk = nb - 1; blk >= 0; --blk) {
      const BlockW& p = w.blocks[blk];
      const BlockGradOff off = block_grad_off(blk, d);
      const unsigned char* pm = dm.p[blk] == nullptr ? nullptr : dm.p[blk] + row0 * T;
      const unsigned char* f1m = dm.f1[blk] == nullptr ? nullptr : dm.f1[blk] + row0 * d;
      const unsigned char* f2m = dm.f2[blk] == nullptr ? nullptr : dm.f2[blk] + row0 * d;
      load_rows(saved + blk * plane + row0 * d, H, R, d, ld);
      __syncthreads();
      block_forward(p, bufs, pm, f1m, f2m, keep, true, R, T, Ts, d, ld);

      // LN3 (its output was masked by the ids mask), then the FFN
      ln_bwd_rows(F, G, p.ln3, M, LS, R, d, ld);  // G = dF (= dX2 so far)
      __syncthreads();
      if (part != nullptr) ln_grad_flush(LS, part + off.ln3, first, d);
      for (int idx = threadIdx.x; idx < R * d; idx += blockDim.x) {
        const int r = idx / d, c = idx % d;
        const float v = G[r * ld + c];
        F[r * ld + c] = f2m == nullptr ? v : drop(v, f2m[idx], keep);  // dF2
      }
      __syncthreads();
      if (part != nullptr) {
        wgrad(F1, F, M, part + off.w2, first, R, d, ld);
        bgrad(F, M, part + off.b2, first, R, d, ld);
      }
      __syncthreads();
      dense_rows<true>(F, F1, p.conv2.w, epi(nullptr, false, f1m, keep, F1), R, d, ld);  // dZ1
      __syncthreads();
      if (part != nullptr) {
        wgrad(X2, F1, M, part + off.w1, first, R, d, ld);
        bgrad(F1, M, part + off.b1, first, R, d, ld);
      }
      dense_rows<true>(F1, G, p.conv1.w, epi(nullptr, false, nullptr, 1.f, nullptr, G), R, d,
                       ld);  // dX2 = dF + dZ1 W1ᵀ
      __syncthreads();
      ln_bwd_rows(A, G, p.ln2, nullptr, LS, R, d, ld);  // G = dA
      __syncthreads();
      if (part != nullptr) ln_grad_flush(LS, part + off.ln2, first, d);

      // attention: dV into A, dS over P, dQ into X2, dK into F1
      attn_bwd_dv(P, pm, keep, G, A, M, R, T, Ts, d, ld);
      __syncthreads();
      attn_bwd_ds(P, S, pm, keep, G, V, M, R, T, Ts, d, ld);
      __syncthreads();
      attn_bwd_dq(P, K, X2, M, R, T, Ts, d, ld);
      attn_bwd_dk(P, Q, F1, M, R, T, Ts, d, ld);
      __syncthreads();
      if (part != nullptr) {
        wgrad(QIN, X2, M, part + off.wq, first, R, d, ld);
        bgrad(X2, M, part + off.bq, first, R, d, ld);
        wgrad(QIN, F1, M, part + off.wk, first, R, d, ld);
        bgrad(F1, M, part + off.bk, first, R, d, ld);
        wgrad(QIN, A, M, part + off.wv, first, R, d, ld);
        bgrad(A, M, part + off.bv, first, R, d, ld);
      }
      // dq_in = dA + dQ Wqᵀ + dK Wkᵀ + dV Wvᵀ, added in that order
      dense_rows<true>(X2, G, p.wq.w, epi(nullptr, false, nullptr, 1.f, nullptr, G), R, d, ld);
      __syncthreads();
      dense_rows<true>(F1, G, p.wk.w, epi(nullptr, false, nullptr, 1.f, nullptr, G), R, d, ld);
      __syncthreads();
      dense_rows<true>(A, G, p.wv.w, epi(nullptr, false, nullptr, 1.f, nullptr, G), R, d, ld);
      __syncthreads();
      ln_bwd_rows(H, G, p.ln1, nullptr, LS, R, d, ld);  // G = the block input's gradient
      __syncthreads();
      if (part != nullptr) ln_grad_flush(LS, part + off.ln1, first, d);
    }

    // the input: x0 = drop_emb(x + pos) * mask
    const unsigned char* emb = dm.emb == nullptr ? nullptr : dm.emb + row0 * d;
    for (int idx = threadIdx.x; idx < R * d; idx += blockDim.x) {
      const int r = idx / d, c = idx % d;
      float v = G[r * ld + c] * M[r];
      if (emb != nullptr) v = drop(v, emb[idx], keep);
      dx[row0 * d + idx] = v;
      G[r * ld + c] = v;
    }
    __syncthreads();
    if (part != nullptr)
      for (int idx = threadIdx.x; idx < T * d; idx += blockDim.x) {
        const int t = idx / d, c = idx % d;
        float s = 0.f;
        for (int u = 0; u < users; ++u) s += G[(u * T + t) * ld + c];
        add_to(part + pos_off + idx, s, first);
      }
  }
}

// grad[k] = Σ_c partial[c][k], the blocks' slices summed in block order.
__global__ void sasrec_encoder_bwd_reduce(const float* __restrict__ partial, int ctas, int n,
                                          float* __restrict__ grad) {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n; k += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < ctas; ++c) s += partial[static_cast<size_t>(c) * n + k];
    grad[k] = s;
  }
}

size_t bwd_smem_bytes(int users_per_block, int T, int d, int threads) {
  const size_t rows = static_cast<size_t>(users_per_block) * T;
  const size_t warps = threads / 32;
  const size_t Ts = score_ld(T);
  return (kBuffers * rows * row_ld(d) + rows * Ts + warps * Ts + rows + warps * 2 * d) *
         sizeof(float);
}

}  // namespace

// The number of K2b blocks the current device runs at once with this
// launch geometry (the persistent grid of the weight-gradient mode); 0 if
// none fits, a negative cudaError_t on an error.
extern "C" int acf_sasrec_encoder_bwd_ctas(int threads, int smem_bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sasrec_encoder_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sasrec_encoder_bwd_kernel,
                                                        threads, smem_bytes);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// Writes dx [B, T, d] and, when `partial` and `grad` are not null, the flat
// gradient `grad` (ops/sasrec_fused.py `grad_size` floats) through the
// [ctas, grad_size] `partial` workspace, on `stream`. `saved` holds the
// block inputs K2a's training form wrote. `users_per_block`, `threads` and
// `smem_bytes` come from the wrapper's layout (`_bwd_layout`); a launch
// whose bytes disagree with this file's formula is refused. Without
// gradients `ctas` must be the number of user groups. Returns the
// cudaError_t of the launches.
extern "C" int acf_sasrec_encoder_bwd(EncoderW w, DropoutMasks dm,
                                      const unsigned char* ids_mask, const float* g,
                                      const float* saved, float* dx, float* partial,
                                      float* grad, int B, int T, int d, int users_per_block,
                                      int threads, int smem_bytes, int ctas, void* stream) {
  if (B <= 0 || T <= 0 || d <= 0 || d % 4 != 0 || d > 32 * kMaxColsPerLane ||
      users_per_block <= 0 || (threads != 256 && threads != kMaxThreads) ||
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
  cudaError_t err = cudaFuncSetAttribute(
      sasrec_encoder_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_grad = w.num_blocks * (5 * d * d + 11 * d) + 2 * d + T * d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sasrec_encoder_bwd_kernel<<<ctas, threads, smem_bytes, s>>>(
      w, dm, ids_mask, g, saved, dx, partial, B, T, d, users_per_block, row_ld(d),
      score_ld(T), n_grad, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  const int blocks = (n_grad + 255) / 256;
  const int grid = blocks < 1024 ? blocks : 1024;
  sasrec_encoder_bwd_reduce<<<grid, 256, 0, s>>>(partial, ctas, n_grad, grad);
  return (int)cudaGetLastError();
}
