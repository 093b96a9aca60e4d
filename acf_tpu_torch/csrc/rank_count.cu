// K1 — full-catalog rank counter for Hopper (sm_90a).
//
// Replaces the TPU kernel `_count_kernel` in acf_tpu/ops/ranking.py (entry
// `rank_positions_dot`). For every user b it counts the items j with
//
//     u_b . e_j + bias_j >= t_b,   j != 0, j != gt_b, j < I
//
// in true float32, without materialising the [B, I] score matrix.
//
// Bound on an H100: compute. The work is 2*B*I*d float32 operations done as
// FMAs outside the tensor cores (67 TFLOP/s non-tensor FP32 peak); at Video
// shape for all users, 2 * 31k * 23.7k * 64 ~= 9.4e10 FLOP ~= 1.4 ms, while
// the bytes (the tables plus per-user scalars, ~14 MB) take ~4 us at
// 3.35 TB/s. TF32 tensor-core products are not float32 and would move rank
// positions, so they are not used.
//
// Design (simple first): a 2-D grid of user tiles x item splits, because
// blocks run in parallel and nothing carries between them (the TPU kernel ran
// its item tiles in order into one resident accumulator).
//   * A block stages its 64-user tile in shared memory once and streams the
//     64-item tiles of its split (tiles split, split + splits, ...) through
//     two shared-memory buffers with cp.async, so the next tile's copy runs
//     while the current one is computed. Rows stay row-major, padded so that
//     16-byte reads of neighbouring rows fall in distinct bank groups.
//   * Each of the 256 threads keeps a 4-user x 4-item register tile (users
//     ty + 16i, items tx + 16j) of dot products, summed over k = 0..d-1 in
//     order with plain fp32 FMAs, reading 4 k at a time as float4.
//   * Item 0, each user's gt column and the ragged tail j >= I are masked
//     in-kernel (the copy zero-fills rows past I), so the table is never
//     padded or copied in device memory.
//   * Per-thread counts are reduced over the 16 threads that share a user
//     with warp shuffles, and one int32 atomicAdd per user and block merges
//     the splits. Integer atomics keep the result deterministic.
// Requires d % 4 == 0 and 16-byte aligned u and e (checked by the wrapper).
// Later work: wgmma/TMA pipelines and 3xTF32 error-compensated tensor-core
// products to approach the bound.

#include <cuda_runtime.h>

namespace {

constexpr int kBU = 64;                    // users per block
constexpr int kBI = 64;                    // items per tile
constexpr int kTile = 4;                   // users (and items) per thread
constexpr int kLanes = 16;                 // threads along items (and users)
constexpr int kThreads = kLanes * kLanes;  // 256
constexpr int kBlocksPerSm = 2;            // grid sizing target (one wave)

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_bytes = valid ? 16 : 0;  // 0: zero-fill the destination
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(saddr), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy `rows` rows of a row-major [n, d] table starting at row0 into a
// [rows][ld] shared tile; rows at or past n are zero-filled.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0,
                                           int n, int d, int ld, int rows) {
  const int chunks = d / 4;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c = (idx % chunks) * 4;
    const int row = row0 + r;
    const bool valid = row < n;
    cp_async16(dst + r * ld + c, src + (size_t)(valid ? row : 0) * d + c, valid);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
rank_count_kernel(const float* __restrict__ u, const float* __restrict__ e,
                  const float* __restrict__ bias,
                  const float* __restrict__ thresh,
                  const int* __restrict__ gt, int* __restrict__ out,
                  int B, int I, int d, int ld, int n_item_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* sU = smem;  // [kBU][ld] user tile; two [kBI][ld] item tiles follow

  const int tx = threadIdx.x % kLanes;  // items tx + 16j
  const int ty = threadIdx.x / kLanes;  // users ty + 16i
  const int u0 = blockIdx.x * kBU;

  int tile = blockIdx.y;
  stage_rows(sU, u, u0, B, d, ld, kBU);
  stage_rows(smem + kBU * ld, e, tile * kBI, I, d, ld, kBI);
  cp_async_commit();

  float t[kTile];
  int g[kTile];
  int cnt[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int row = u0 + ty + kLanes * i;
    t[i] = row < B ? thresh[row] : 0.f;
    g[i] = (gt != nullptr && row < B) ? gt[row] : 0;
    cnt[i] = 0;
  }

  for (int buf = 0; tile < n_item_tiles; tile += gridDim.y, buf ^= 1) {
    const int next = tile + gridDim.y;
    if (next < n_item_tiles)
      stage_rows(smem + (kBU + (buf ^ 1) * kBI) * ld, e, next * kBI, I, d, ld, kBI);
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait_all_but_newest();
    __syncthreads();  // this tile (and the user tile) visible to all threads

    const float* se = smem + (kBU + buf * kBI) * ld;
    float acc[kTile][kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;

#pragma unroll 2
    for (int k = 0; k < d; k += 4) {
      float4 a[kTile], b[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sU[(ty + kLanes * i) * ld + k]);
#pragma unroll
      for (int j = 0; j < kTile; ++j)
        b[j] = *reinterpret_cast<const float4*>(&se[(tx + kLanes * j) * ld + k]);
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          float s = acc[i][j];
          s = fmaf(a[i].x, b[j].x, s);
          s = fmaf(a[i].y, b[j].y, s);
          s = fmaf(a[i].z, b[j].z, s);
          s = fmaf(a[i].w, b[j].w, s);
          acc[i][j] = s;
        }
    }

    const int i0 = tile * kBI;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int item = i0 + tx + kLanes * j;
      if (item <= 0 || item >= I) continue;  // pad id 0 and the ragged tail
      const float bj = bias != nullptr ? bias[item] : 0.f;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const float s = bias != nullptr ? acc[i][j] + bj : acc[i][j];
        cnt[i] += (s >= t[i] && item != g[i]) ? 1 : 0;
      }
    }
    __syncthreads();  // all reads of this buffer done before it is refilled
  }

  // lanes 0-15 and 16-31 of a warp each hold one user group's 16 item groups
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    int c = cnt[i];
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, off);
    const int row = u0 + ty + kLanes * i;
    if (tx == 0 && row < B && c != 0) atomicAdd(&out[row], c);
  }
}

}  // namespace

// Adds the counts into `out` (int32 [B], zeroed by the caller) on `stream`.
// `bias` and `gt` may be null. Returns the cudaError_t of the launch.
extern "C" int acf_rank_count(const float* u, const float* e,
                              const float* bias, const float* thresh,
                              const int* gt, int* out, int B, int I, int d,
                              void* stream) {
  if (B <= 0 || I <= 0 || d <= 0 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  // row stride in 16-byte units odd: 8 neighbouring rows hit 8 bank groups
  const int ld = d + ((d / 4) % 2 == 0 ? 4 : 8);
  const size_t smem = (size_t)(kBU + 2 * kBI) * ld * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rank_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int user_tiles = (B + kBU - 1) / kBU;
  const int n_item_tiles = (I + kBI - 1) / kBI;
  int splits = (kBlocksPerSm * (sms > 0 ? sms : 1) + user_tiles - 1) / user_tiles;
  if (splits > n_item_tiles) splits = n_item_tiles;
  if (splits > 65535) splits = 65535;
  if (splits < 1) splits = 1;
  rank_count_kernel<<<dim3(user_tiles, splits), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      u, e, bias, thresh, gt, out, B, I, d, ld, n_item_tiles);
  return (int)cudaGetLastError();
}
