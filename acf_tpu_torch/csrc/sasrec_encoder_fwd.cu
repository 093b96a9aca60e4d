// K2a — SASRec encoder forward for Hopper (sm_90a), at inference and in its
// training form.
//
// Replaces the TPU kernel `fwd_kernel` in acf_tpu/ops/sasrec_fused.py:225
// (entry `fused_encoder`): single head, float32, with or without dropout.
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
// Design (simple first; the TPU's two attention forms, unrolled for T < 32
// and block-diagonal for T >= 32, were a layout choice of the TPU and are
// not carried over: one form covers every T). The work per block is small
// and mostly chains of dependent steps, so the design is about keeping
// enough warps and independent instructions in flight:
//   * One block per user, or per group of users holding ~32 rows when the
//     window is short (4 users at T=8, so B=512 fills 128 of the 132 SMs).
//     256 threads, 512 from 128 rows on. Blocks share nothing, so there are
//     no atomics and the result is deterministic.
//   * All activations of the block's rows stay in dynamic shared memory:
//     four [rows][ld] f32 buffers (x, q, k, v), one score row of T per warp
//     and the ids mask. Nothing between the input and the output touches
//     device memory. At d=64 this holds windows up to T=200 (231,200 bytes).
//     At most 64 registers a thread, so four 256-thread blocks fit an SM
//     at T=50.
//   * The d x d products are register-tiled: each thread owns 1, 2 or 4 rows
//     (the fewest that cover the block in one pass) x 4 columns, reads its
//     rows as float4 from shared memory and the weight rows as float4
//     through the read-only cache, and sums k in order with plain fp32 FMAs.
//     Rows are padded to an odd number of 16-byte units so neighbouring
//     rows fall in distinct banks.
//   * Attention: one warp per query row; lanes split the keys j <= i (the
//     dots for j > i are never computed; masked keys get a score of -inf
//     and no dot), each dot in four independent FMA chains; then the warp's
//     softmax weights multiply v four keys at a time, lanes split over
//     columns. A masked query is skipped: the reference's masked
//     probabilities are exact zeros, so its output is q_in.
//   * LayerNorm: one warp per row, warp-shuffle sums.
//   * The weights come as one struct of pointers passed by value; nothing is
//     packed or copied per call.
// Requires d % 4 == 0, d <= 128, 16-byte aligned x and weights (checked by
// the wrapper). Later work: staging the weights in shared memory where it
// has room, skipping padded rows, and multi-head windows.

#include "sasrec_encoder.cuh"

namespace {

__global__ void __launch_bounds__(kMaxThreads, 2)
sasrec_encoder_fwd_kernel(const EncoderW w, const DropoutMasks dm, const float* __restrict__ x,
                          const unsigned char* __restrict__ ids_mask,
                          float* __restrict__ out, float* __restrict__ saved, int B, int T,
                          int d, int users_per_block, int ld, int Ts) {
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * users_per_block;
  const int R = min(users_per_block, B - b0) * T;  // this block's rows
  const int rows = users_per_block * T;            // rows each buffer holds
  float* X = smem;
  float* Q = X + rows * ld;
  float* K = Q + rows * ld;
  float* V = K + rows * ld;
  float* S = V + rows * ld;                // [warps][Ts] softmax rows
  float* M = S + (blockDim.x >> 5) * Ts;   // [rows] ids mask as 0/1
  const size_t row0 = static_cast<size_t>(b0) * T;  // first global row
  const unsigned char* mask = ids_mask + row0;
  const float* xb = x + row0 * d;
  const unsigned char* emb = dm.emb == nullptr ? nullptr : dm.emb + row0 * d;

  for (int r = threadIdx.x; r < R; r += blockDim.x) M[r] = mask[r] ? 1.f : 0.f;
  const int groups = d / 4;
  for (int idx = threadIdx.x; idx < R * groups; idx += blockDim.x) {
    const int r = idx / groups, c = (idx % groups) * 4;
    const float4 a = ldg4(xb + r * d + c);
    const float4 e = ldg4(w.pos + (r % T) * d + c);
    float4 v = make_float4(a.x + e.x, a.y + e.y, a.z + e.z, a.w + e.w);
    if (emb != nullptr) {
      const uchar4 m = *reinterpret_cast<const uchar4*>(emb + r * d + c);
      v = make_float4(drop(v.x, m.x, dm.keep), drop(v.y, m.y, dm.keep),
                      drop(v.z, m.z, dm.keep), drop(v.w, m.w, dm.keep));
    }
    const float keep = mask[r] ? 1.f : 0.f;
    *reinterpret_cast<float4*>(X + r * ld + c) =
        make_float4(v.x * keep, v.y * keep, v.z * keep, v.w * keep);
  }
  __syncthreads();

  const BlockBufs bufs{X, X, Q, K, V, X, X, Q, K, nullptr, S, M};
  for (int blk = 0; blk < w.num_blocks; ++blk) {
    if (saved != nullptr) {  // the block's input, for K2b
      float* dst = saved + (static_cast<size_t>(blk) * B * T + row0) * d;
      for (int idx = threadIdx.x; idx < R * d; idx += blockDim.x)
        dst[idx] = X[(idx / d) * ld + idx % d];
    }
    const size_t mrow = row0 * d;
    block_forward(w.blocks[blk], bufs,
                  dm.p[blk] == nullptr ? nullptr : dm.p[blk] + row0 * T,
                  dm.f1[blk] == nullptr ? nullptr : dm.f1[blk] + mrow,
                  dm.f2[blk] == nullptr ? nullptr : dm.f2[blk] + mrow, dm.keep, false,
                  R, T, Ts, d, ld);
  }
  if (saved != nullptr) {  // LN_f's input
    float* dst = saved + (static_cast<size_t>(w.num_blocks) * B * T + row0) * d;
    for (int idx = threadIdx.x; idx < R * d; idx += blockDim.x)
      dst[idx] = X[(idx / d) * ld + idx % d];
  }
  layer_norm_rows(X, out + row0 * d, d, w.ln_f, nullptr, R, d, ld);
}

}  // namespace

// Writes out [B, T, d] (and, when `saved` is not null, the block inputs
// [num_blocks + 1, B, T, d]) on `stream`. `users_per_block`, `threads` and
// `smem_bytes` come from the wrapper's layout (ops/sasrec_fused.py
// `_layout`); a launch whose bytes disagree with this file's formula, or
// exceed the device's limit, is refused. Returns the cudaError_t of the
// launch.
extern "C" int acf_sasrec_encoder_fwd(EncoderW w, DropoutMasks dm, const float* x,
                                      const unsigned char* ids_mask, float* out, float* saved,
                                      int B, int T, int d, int users_per_block,
                                      int threads, int smem_bytes, void* stream) {
  if (B <= 0 || T <= 0 || d <= 0 || d % 4 != 0 || d > 32 * kMaxColsPerLane ||
      users_per_block <= 0 || (threads != 256 && threads != kMaxThreads) ||
      w.num_blocks < 0 || w.num_blocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  const int ld = row_ld(d);
  const int Ts = score_ld(T);
  const size_t rows = static_cast<size_t>(users_per_block) * T;
  const size_t need = (4 * rows * ld + static_cast<size_t>(threads / 32) * Ts + rows) * sizeof(float);
  if (need != static_cast<size_t>(smem_bytes)) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem_bytes > optin) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sasrec_encoder_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + users_per_block - 1) / users_per_block;
  sasrec_encoder_fwd_kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      w, dm, x, ids_mask, out, saved, B, T, d, users_per_block, ld, Ts);
  return (int)cudaGetLastError();
}
