// K3a-K3e — APL's generator chain for Hopper (sm_90a).
//
// Replaces the five TPU kernels of acf_tpu/ops/apl_gen_fused.py (entries
// `apl_gen_forward` and `apl_gen_backward`):
//   K3a `_stats1_kernel` (:67)  m1, l1: row max and sum of exp of the logits
//                               P_g[u].Q_g^T, column 0 and columns >= I masked;
//   K3b `_z_kernel` (:83)       z = (log((1-w) probs + w member/nuniq + 1e-20)
//                               + gumbel) / T, written [B, I]; m2, l2 of z
//                               (column 0 stays live, only columns >= I drop);
//   K3c `_fake_kernel` (:111)   fake = sum_i softmax(z) . (P_c[u].Q_c^T);
//   K3d `_bigr_kernel` (:141)   R = <probs, r>, r = (1-w)/T s a (c - fake) /
//                               (mixed + 1e-20), through `_r_tile` (:125);
//   K3e `_grad_kernel` (:157)   dlogits = probs (r - R); dQ = dlogits^T P_g[u],
//                               dP = dlogits Q_g.
// Each pass recomputes the [B, d] x [d, I] products it needs (`_masked_logits`,
// :55) in true float32 (FMAs, no TF32, no tensor cores), as the reference
// computes them at HIGHEST precision.
//
// Bound on an H100 at APL's geometry (B = 512, d = 64, I = 23,701): one product
// is 2 B I d = 1.55 GFLOP, 0.023 ms at the 67 TFLOP/s float32 peak; one [B, I]
// float32 array is 48.5 MB, 0.0145 ms at 3.35 TB/s. K3a, K3c (1 product), K3d
// (2) and K3e (4) are bound by operations; K3b by its bytes (the noise read,
// z written, member read as uint8, 0.0345 ms) about as much as by its product
// (0.023 ms). K3b-K3e stage their [B, I] traffic (K3c reads z, 48.5 MB,
// 0.0145 ms; K3d and K3e read z and member, 60.6 MB, 0.018 ms) through shared
// memory so it overlaps their products. The design keeps every [B, I]
// intermediate but z in registers: probs, mixed, s, c, r and dlogits never
// reach device memory.
//
// Design (simple first; the TPU walked item tiles in order and carried m, l,
// fake, R and dP across grid steps, which blocks running in parallel cannot):
//   * A thread block of 256 threads computes 64-user x 64-item tiles of dot
//     products, each thread a 4 x 4 register tile (users ty + 16i, items
//     tx + 16j), summed over k in order with fmaf, reading float4s from
//     shared-memory rows padded to an odd number of 16-byte units. Item tiles
//     stream through two shared buffers with cp.async.
//   * K3a-K3d: a block owns (64 users) x (a chunk of kChunkTiles item tiles)
//     and writes one partial per user and chunk: (m, l) pairs merged by the
//     online-softmax rule, or sums. A second small kernel merges them.
//   * The merges (stat_combine, sum_combine; also K3e's dP partials) put a
//     block of 256 threads on 32 outputs: lanes along the outputs, so each
//     load of a part coalesces, and the 8 warps on 8 contiguous slices of
//     the parts. Each thread issues a slice's loads kMergeUnroll at a time
//     before it merges them in part order; warp 0 then merges the 8 slices
//     in slice order through shared memory. The order depends on the count
//     of parts alone.
//   * K3a walks its chunk in a loop of its own: the user tile and two
//     buffers of Q_g item tiles, tile t + 1 copied during tile t's product,
//     three blocks a SM. Its absorb (stat_absorb, shared with K3b) rescales
//     a row's sum only when the row's max grows, then takes one expf a
//     value; only the catalog's first and last tiles mask items.
//   * K3b walks its chunk in a loop of its own: the [B, I] noise and member
//     tiles of item tile t + 1 are copied into shared memory (cp.async, in
//     the same group as Q_g's tile t + 1) while tile t's product runs, and z
//     is stored from registers. Rows of odd I start only 4-byte (noise, z) or
//     1-byte (member) aligned and are not padded: each row's 64-item run
//     moves as the aligned 4-item units around it (16-byte copies of noise,
//     4-byte copies of member). Its arithmetic divides once a row, not once
//     an element.
//   * K3c walks its chunk in a loop of its own too, with K3b's double
//     buffers: z of tile t + 1, staged as K3b stages its noise, flies with
//     Q_c's tile t + 1 during tile t's product. Per element one expf and one
//     multiply, by a per-row 1/l2.
//   * K3d walks its chunk in a loop of its own too, with every buffer single
//     (two 8-warp blocks a SM at d = 64): z and member of tile t, staged as
//     K3b stages its noise and member, fly during tile t's two products; Q_g
//     and Q_c of tile t + 1 during tile t's epilogue. Its per-row scalars sit
//     in shared memory, not in registers (no spill), and it divides once an
//     element, by (mixed + 1e-20).
//   * K3e: a block owns one 64-item tile and loops over every user tile, so
//     each dQ row is written once, from registers; its dP partial for each
//     user tile goes to [item tiles, B, d], summed in tile order by a second
//     kernel. Its buffers are single, as K3d's: the next user tile's P_c,
//     z/member and P_g (with its row scalars) fly behind the epilogue, the dQ
//     loop and the dP loop; the scalars sit in shared memory (no spill), it
//     divides once an element, and its dQ and dP loops keep 4 x kC register
//     tiles (kC = 4 columns a thread up to d = 64, 8 up to d = 128).
//   * No float atomics anywhere and fixed reduction orders (warp butterflies
//     are symmetric), so two calls give bit-identical outputs.
//   * Nothing is padded: rows past B and items past I are zero-filled in
//     shared memory and masked in the epilogues, as in K1.
//   * Elementwise chains use __fmul_rn/__fadd_rn where the reference rounds
//     each step, so they are not contracted into FMAs.
// Widths and alignments: any d >= 1 and any float32 alignment, in one of
// three forms of every kernel (the C entries choose; each sums its products
// over k in the same order, so the forms agree bit for bit where two apply):
//   kAligned  d % 4 == 0, d <= kMaxWhole, the tables and user rows 16-byte
//             aligned and the [B, I] operands at the start of a unit: whole
//             rows staged by 16-byte copies, as described above;
//   kAny      d <= kMaxWhole otherwise: rows of pad4(d) floats (a zero tail)
//             staged by 4-byte copies, and each [B, I] operand's runs read
//             at their offset from its first aligned unit;
//   kSliced   d > kMaxWhole: every [64, ld] tile holds one k slice of kSlice
//             columns (16- or 4-byte copies), staged in turn for each
//             product, which carries its sums from slice to slice; K3e's dQ
//             and dP loops walk the columns in the same slices, dQ summed in
//             place in device memory (its rows belong to one block).
// The wrapper (acf_tpu_torch/ops/apl_gen_fused.py, check_supported) refuses
// only what no form takes. Later work: the product tile_dot shared by K3a-K3e
// (wgmma or 3xTF32, larger register tiles), which sets most of each pass's
// time; K3a folded into K3b's prologue and K3c into K3b; one pass for
// K3d-K3e; fewer dP partials (K3e's merge reads 48.5 MB of them).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "cp_async.cuh"

namespace {

constexpr int kTile = 64;                  // users and items per tile
constexpr int kSub = 4;                    // users (and items) per thread
constexpr int kLanes = 16;                 // threads along items (and users)
constexpr int kThreads = kLanes * kLanes;  // 256
constexpr int kChunkTiles = 4;             // item tiles per K3a-K3d block
constexpr int kMaxWhole = 128;             // whole-row forms: K3e's 8 register columns a thread
constexpr int kSlice = 64;                 // kSliced: columns of a k slice (and a K3e column slice)
constexpr int kLdD = kTile + 1;            // K3e: dlogits tile row stride
constexpr int kRunUnits = kTile / 4 + 1;   // K3b-K3e: 4-item units a 64-item run can touch
constexpr int kNoiseLd = kTile + 16;       // K3b-K3e: noise (z) tile row stride (floats;
                                           // a warp's two rows 16 banks apart)
constexpr int kMemLd = 4 * kRunUnits;      // K3b, K3d, K3e: member tile row stride (bytes)
constexpr float kEps = 1e-20f;

// The forms of every kernel (see the top of the file).
constexpr int kAligned = 0, kAny = 1, kSliced = 2;

__host__ __device__ constexpr inline int pad4(int d) { return (d + 3) & ~3; }

// The geometry all five kernels share.
struct Geo {
  int B, I, d, ld;   // ld: the row stride of a staged [kTile][ld] tile
  int n_tiles;       // item tiles of 64
  int n_chunks;      // item chunks of K3a-K3d
  int dp;            // columns a staged row holds: d rounded up to 4 (a zero tail)
  int n_slices;      // kSliced: k slices of kSlice columns
  int off_f, off_m;  // where the float [B, I] operand (noise or z) and member
                     // start within their first aligned unit (elements)
  bool rows16;       // d % 4 == 0 and the tables and user rows 16-byte aligned:
                     // kAligned, or kSliced's 16-byte copies
};

// Geo as one form's kernels see it: in kAligned the [B, I] operands start at
// a unit's start, known at compile time.
template <int kForm>
struct Shape : Geo {
  static constexpr int form = kForm;
  explicit Shape(const Geo& g) : Geo(g) {}
  __device__ int off(const float*) const { return kForm == kAligned ? 0 : off_f; }
  __device__ int off(const uint8_t*) const { return kForm == kAligned ? 0 : off_m; }
};

// kAligned: copy rows [row0, row0 + kTile) of a row-major [n, d] table into a
// [kTile][ld] shared tile; rows at or past n are zero-filled.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0, int n,
                                           int d, int ld) {
  const int chunks = d / 4;
  for (int idx = threadIdx.x; idx < kTile * chunks; idx += kThreads) {
    const int r = idx / chunks, c = (idx % chunks) * 4;
    const int row = row0 + r;
    const bool valid = row < n;
    cp_async16(dst + r * ld + c, src + (size_t)(valid ? row : 0) * d + c, valid);
  }
}

// Rows [row0, row0 + kTile) x columns [c0, c0 + w) of a row-major [n, d]
// table into a [kTile][ld] shared tile (w a multiple of 4, at most 4 <<
// kShift); rows at or past n and columns at or past d are zero-filled. A
// thread moves 4-column units, a row's units 1 << kShift slots, so a unit's
// row and column are a shift and a mask: by one 16-byte copy where k16 (d % 4
// == 0, 16-byte aligned rows), else by four 4-byte copies.
template <int kShift, bool k16>
__device__ __forceinline__ void stage_block(float* dst, const float* src, int row0, int n,
                                            int d, int c0, int w, int ld) {
  for (int e = threadIdx.x; e < (kTile << kShift); e += kThreads) {
    const int r = e >> kShift, c = (e & ((1 << kShift) - 1)) * 4;
    if (c >= w) continue;
    const int row = row0 + r;
    if constexpr (k16) {
      const bool valid = row < n;
      cp_async16(dst + r * ld + c, src + (size_t)(valid ? row : 0) * d + c0 + c, valid);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = c0 + c + q;
        const bool valid = row < n && col < d;
        cp_async_n<4>(dst + r * ld + c + q, valid ? src + (size_t)row * d + col : src,
                      valid ? 4 : 0);
      }
    }
  }
}

// Rows [row0, row0 + kTile) of a row-major [n, d] table, whole (kAligned,
// kAny), into a [kTile][g.ld] shared tile.
template <int kForm>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0, int n,
                                           const Shape<kForm>& g) {
  static_assert(kForm != kSliced, "kSliced stages k slices (stage_slice)");
  if constexpr (kForm == kAligned)
    stage_rows(dst, src, row0, n, g.d, g.ld);
  else if (g.dp <= 4 << 4)
    stage_block<4, false>(dst, src, row0, n, g.d, 0, g.dp, g.ld);
  else
    stage_block<5, false>(dst, src, row0, n, g.d, 0, g.dp, g.ld);
}

// kSliced: k slice s (columns [s kSlice, s kSlice + kSlice) of pad4(d)) of
// rows [row0, row0 + kTile) of a row-major [n, d] table into a [kTile][g.ld]
// shared tile.
__device__ __forceinline__ void stage_slice(float* dst, const float* src, int row0, int n,
                                            int s, const Geo& g) {
  const int c0 = s * kSlice, w = min(kSlice, g.dp - c0);
  if (g.rows16)
    stage_block<4, true>(dst, src, row0, n, g.d, c0, w, g.ld);
  else
    stage_block<4, false>(dst, src, row0, n, g.d, c0, w, g.ld);
}

// acc[i][j] += sum_k sU[ty + 16i][k] * sI[tx + 16j][k], k < d in order; the k
// loop unrolled kUnroll times.
template <int kUnroll = 2>
__device__ __forceinline__ void tile_dot_acc(const float* sU, const float* sI, int ld, int d,
                                             int ty, int tx, float acc[kSub][kSub]) {
#pragma unroll (kUnroll)
  for (int k = 0; k < d; k += 4) {
    float4 a[kSub], b[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
      a[i] = *reinterpret_cast<const float4*>(&sU[(ty + kLanes * i) * ld + k]);
#pragma unroll
    for (int j = 0; j < kSub; ++j)
      b[j] = *reinterpret_cast<const float4*>(&sI[(tx + kLanes * j) * ld + k]);
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][j] = sum_k sU[ty + 16i][k] * sI[tx + 16j][k], k in order; the k loop
// unrolled kUnroll times (K3a takes 1: 72 registers, three blocks a SM).
template <int kUnroll = 2>
__device__ __forceinline__ void tile_dot(const float* sU, const float* sI, int ld, int d,
                                         int ty, int tx, float acc[kSub][kSub]) {
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;
  tile_dot_acc<kUnroll>(sU, sI, ld, d, ty, tx, acc);
}

// kSliced: acc0 = the products of user rows [u0, u0 + kTile) of U0 ([B, d])
// with item rows [i0, i0 + kTile) of V0 ([I, d]), and where kPairs == 2 acc1
// those of U1 with V1, over d in k slices: each slice staged into the tiles
// sU0, sV0 (sU1, sV1), then its products added, k in order, so every sum
// takes the whole forms' order. The tiles are free again on return; every
// copy in flight before the call has landed.
template <int kPairs, int kUnroll>
__device__ __forceinline__ void sliced_dots(const Geo& g, int u0, int i0, int ty, int tx,
                                            float* sU0, const float* U0, float* sV0,
                                            const float* V0, float (&acc0)[kSub][kSub],
                                            float* sU1, const float* U1, float* sV1,
                                            const float* V1, float (&acc1)[kSub][kSub]) {
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc0[i][j] = acc1[i][j] = 0.f;
  for (int s = 0; s < g.n_slices; ++s) {
    stage_slice(sU0, U0, u0, g.B, s, g);
    stage_slice(sV0, V0, i0, g.I, s, g);
    if constexpr (kPairs == 2) {
      stage_slice(sU1, U1, u0, g.B, s, g);
      stage_slice(sV1, V1, i0, g.I, s, g);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int w = min(kSlice, g.dp - s * kSlice);
    tile_dot_acc<kUnroll>(sU0, sV0, g.ld, w, ty, tx, acc0);
    if constexpr (kPairs == 2) tile_dot_acc<kUnroll>(sU1, sV1, g.ld, w, ty, tx, acc1);
    __syncthreads();  // every read of the tiles done before they are refilled
  }
}

// One product (K3a-K3c) through sliced_dots.
template <int kUnroll = 2>
__device__ __forceinline__ void sliced_dot(const Geo& g, int u0, int i0, int ty, int tx,
                                           float* sU, const float* U, float* sV,
                                           const float* V, float (&acc)[kSub][kSub]) {
  float unused[kSub][kSub];
  sliced_dots<1, kUnroll>(g, u0, i0, ty, tx, sU, U, sV, V, acc, nullptr, nullptr, nullptr,
                          nullptr, unused);
}

// Online softmax statistics: (m, l) absorbs the values v[j] of one row, only
// those with live[j] where kMasked (otherwise every value, and `live` is not
// read). l is rescaled only when the row's max grows (a rescale by expf(0)
// would leave it as it is), then each value takes one expf, in j order.
template <bool kMasked>
__device__ __forceinline__ void stat_absorb(float& m, float& l, const float v[kSub],
                                            const bool* live = nullptr) {
  float tmax = -INFINITY;
#pragma unroll
  for (int j = 0; j < kSub; ++j)
    if (!kMasked || live[j]) tmax = fmaxf(tmax, v[j]);
  if (tmax > m) {
    l *= expf(m - tmax);  // m = -inf (nothing yet): l = 0 stays 0
    m = tmax;
  }
#pragma unroll
  for (int j = 0; j < kSub; ++j)
    if (!kMasked || live[j]) l += expf(v[j] - m);
}

// (m, l) merged with (mo, lo); symmetric in its two operands.
__device__ __forceinline__ void stat_merge(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;  // both empty
  l = l * expf(m - mn) + lo * expf(mo - mn);
  m = mn;
}

// Merge (m, l) over the 16 threads that share a user row (lanes 0-15 and
// 16-31 of a warp hold different rows).
__device__ __forceinline__ void stat_reduce_lanes(float& m, float& l) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    stat_merge(m, l, mo, lo);
  }
}

__device__ __forceinline__ float sum_lanes(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The per-row scalars a thread needs for its four users.
__device__ __forceinline__ void load_rows(const float* src, int u0, int ty, int B,
                                          float fill, float out[kSub]) {
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int row = u0 + ty + kLanes * i;
    out[i] = row < B ? src[row] : fill;
  }
}

// ---- K3a --------------------------------------------------------------------
// Block: the user tile blockIdx.y and the item tiles [t0, t1) of chunk
// blockIdx.x, one (m, l) partial per user and chunk. Shared memory holds the
// user tile and two buffers of Q_g item tiles (52,224 B at d = 64, so three
// blocks fit a SM); Q_g's tile t + 1 is copied (cp.async) during tile t's
// product, whose k loop is not unrolled: unrolled twice it needs 96
// registers, and held to three blocks' 80 it spills. The epilogue is
// stat_absorb, shared with K3b: per row a rescale only when the max grows,
// then one expf a value. Only the catalog's first tile (item 0, the pad) and
// last tile (the ragged tail) compute the `live` mask; every other tile
// absorbs its 4 x 4 values with no predicate. The sums keep their order
// (items in tile order, the 16 lanes' butterfly, the chunks in
// stat_combine's fixed order), so two calls give the same bits. kSliced
// stages a k slice of the user tile and of Q_g's tile t into the first two
// tiles, one slice after the other (sliced_dot), at two blocks a SM.
constexpr int kStatsBlocks = 3;  // K3a's blocks a SM (80 registers a thread at most)

// Shared memory: the user tile and two Q_g item tiles.
size_t stats_smem(const Geo& g) { return (size_t)3 * kTile * g.ld * sizeof(float); }

template <int kForm>
__global__ void __launch_bounds__(kThreads, kForm == kSliced ? 2 : kStatsBlocks)
stats1_kernel(const float* __restrict__ pu, const float* __restrict__ Qg,
              float* __restrict__ part_m, float* __restrict__ part_l, Shape<kForm> g) {
  extern __shared__ __align__(16) float smem[];
  const int tile_f = kTile * g.ld;
  float* sUa = smem;
  float* sQa = smem + tile_f;  // [buf] Q_g tiles
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int u0 = blockIdx.y * kTile;
  const int t0 = blockIdx.x * kChunkTiles;
  const int t1 = min(t0 + kChunkTiles, g.n_tiles);
  float m[kSub], l[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) { m[i] = -INFINITY; l[i] = 0.f; }

  if constexpr (kForm != kSliced) {
    stage_rows(sUa, pu, u0, g.B, g);
    stage_rows(sQa, Qg, t0 * kTile, g.I, g);
    cp_async_commit();
  }

  for (int t = t0, buf = 0; t < t1; ++t, buf ^= 1) {
    float acc[kSub][kSub];
    if constexpr (kForm == kSliced) {
      sliced_dot<1>(g, u0, t * kTile, ty, tx, sUa, pu, sQa, Qg, acc);
    } else {
      if (t + 1 < t1) stage_rows(sQa + (buf ^ 1) * tile_f, Qg, (t + 1) * kTile, g.I, g);
      cp_async_commit();  // possibly empty: keeps one group per iteration
      cp_async_wait<1>();
      __syncthreads();
      tile_dot<1>(sUa, sQa + buf * tile_f, g.ld, g.dp, ty, tx, acc);
    }
    if (t == 0 || t + 1 == g.n_tiles) {
      bool live[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int item = t * kTile + tx + kLanes * j;
        live[j] = item > 0 && item < g.I;  // the pad id and the ragged tail
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) stat_absorb<true>(m[i], l[i], acc[i], live);
    } else {
#pragma unroll
      for (int i = 0; i < kSub; ++i) stat_absorb<false>(m[i], l[i], acc[i]);
    }
    if constexpr (kForm != kSliced) __syncthreads();  // this buffer's reads done before its refill
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    stat_reduce_lanes(m[i], l[i]);
    const int row = u0 + ty + kLanes * i;
    if (tx == 0 && row < g.B) {
      part_m[(size_t)blockIdx.x * g.B + row] = m[i];
      part_l[(size_t)blockIdx.x * g.B + row] = l[i];
    }
  }
}

// ---- K3b --------------------------------------------------------------------
// K3b has a loop of its own: besides Q_g's item tiles it double-buffers the
// tile's [64 users x 64 items] noise and member operands in shared memory, so
// they are in flight during the product of the tile before. The [B, I] rows
// start only 4-byte (noise, z) or 1-byte (member) aligned when I is odd, and
// nothing is padded or copied to align them: each row's 64-item run moves as
// the aligned 4-item units around it (16-byte copies of noise, 4-byte copies
// of member) and is read back at its offset within its first unit. An
// operand that itself starts inside a unit (kAny, kSliced: a view of a
// larger buffer) moves by the units of that buffer, its offset added to each
// row's (the head of its first unit is read and never used).

// The offset of item i0 of `row` within its aligned 4-item unit (i0 is a
// multiple of 4), for an array that starts `off` elements into its first unit.
__device__ __forceinline__ int run_shift(int row, int I, int off) {
  return (off + (row & 3) * (I & 3)) & 3;
}

// Rows [u0, u0 + 64) x items [i0, i0 + 64) of a row-major [B, I] array into a
// shared tile with rows of `ld` elements: item i0 + c of row u0 + r lands at
// dst[r * ld + run_shift(u0 + r, I, g.off(src)) + c]. Rows past B, and units
// past the end of the array (the last one cut to the elements it has), are
// zero-filled; items past I belong to the next row and are masked by the
// reader.
template <typename T, int kForm>
__device__ __forceinline__ void stage_runs(T* dst, const T* src, int ld, int u0, int i0,
                                           const Shape<kForm>& g) {
  const int off = g.off(src);
  const T* base = src - off;  // the start of src's first unit
  const size_t n = (size_t)g.B * g.I + off;
  for (int idx = threadIdx.x; idx < kTile * kRunUnits; idx += kThreads) {
    const int r = idx / kRunUnits, k = idx % kRunUnits;
    const int row = u0 + r;
    const size_t at = ((off + (size_t)row * g.I + i0) & ~(size_t)3) + 4 * k;
    const int elems = row < g.B && at < n ? (n - at < 4 ? (int)(n - at) : 4) : 0;
    cp_async_n<4 * (int)sizeof(T)>(dst + r * ld + 4 * k, elems ? base + at : src,
                                   elems * (int)sizeof(T));
  }
}

// Shared memory: the user tile, two Q_g item tiles, two noise tiles, two
// member tiles.
size_t z_smem(const Geo& g) {
  return (size_t)3 * kTile * g.ld * sizeof(float) +
         (size_t)2 * kTile * kNoiseLd * sizeof(float) + (size_t)2 * kTile * kMemLd;
}

// Block: the user tile blockIdx.y and the item tiles of chunk blockIdx.x, as in
// K3a; the thread tile and the order of the statistics are K3a-K3d's, and its
// statistics take K3a's stat_absorb (a rescale only when the max grows), with
// the live mask on every tile: its rows past B and items past I hold no z.
// Per item tile: the copies of tile t + 1 (Q_g, noise, member) are issued, tile
// t's product runs, and each thread turns its 4 x 4 logits and staged operands
// into z, stored from registers (two 64-byte runs per warp store). Per element
// the arithmetic divides nothing: w member / nuniq is w / nuniq, one division
// a row, where member is 1 and 0 where it is 0 (as the division gives);
// probs multiplies by 1 / l1 and z by 1 / T, which moves them by an ulp from
// the plain version's divisions. kSliced stages only the noise and member
// tiles ahead; its product stages k slices of the user and Q_g tiles into the
// first two tiles (sliced_dot).
template <int kForm>
__global__ void __launch_bounds__(kThreads, 2)
z_kernel(const float* __restrict__ pu, const float* __restrict__ Qg,
         const uint8_t* __restrict__ member, const float* __restrict__ nuniq,
         const float* __restrict__ gn, const float* __restrict__ m1,
         const float* __restrict__ l1, float* __restrict__ z, float* __restrict__ part_m,
         float* __restrict__ part_l, Shape<kForm> g, float omw, float w, float T) {
  extern __shared__ __align__(16) float smem[];
  const int tile_f = kTile * g.ld, noise_f = kTile * kNoiseLd;
  float* sU = smem;
  float* sQ = smem + tile_f;                                      // [buf] Q_g tiles
  float* sN = smem + 3 * tile_f;                                  // [buf] noise tiles
  uint8_t* sM = reinterpret_cast<uint8_t*>(sN + 2 * noise_f);     // [buf] member tiles
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int u0 = blockIdx.y * kTile;
  const int t0 = blockIdx.x * kChunkTiles;
  const int t1 = min(t0 + kChunkTiles, g.n_tiles);
  float rm1[kSub], rl1[kSub], rnu[kSub], wnu[kSub], il1[kSub], m[kSub], l[kSub];
  const float inv_t = 1.f / T;
  int shift[kSub], mshift[kSub];  // the runs' offsets: noise, member
  load_rows(m1, u0, ty, g.B, 0.f, rm1);
  load_rows(l1, u0, ty, g.B, 1.f, rl1);
  load_rows(nuniq, u0, ty, g.B, 1.f, rnu);
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    wnu[i] = w / rnu[i];
    il1[i] = 1.f / rl1[i];
    shift[i] = run_shift(u0 + ty + kLanes * i, g.I, g.off(gn));
    mshift[i] = run_shift(u0 + ty + kLanes * i, g.I, g.off(member));
  }

  auto stage = [&](int t, int buf) {
    if constexpr (kForm != kSliced) stage_rows(sQ + buf * tile_f, Qg, t * kTile, g.I, g);
    stage_runs(sN + buf * noise_f, gn, kNoiseLd, u0, t * kTile, g);
    stage_runs(sM + buf * kTile * kMemLd, member, kMemLd, u0, t * kTile, g);
  };
  if constexpr (kForm != kSliced) stage_rows(sU, pu, u0, g.B, g);
  stage(t0, 0);
  cp_async_commit();

  for (int t = t0, buf = 0; t < t1; ++t, buf ^= 1) {
    if (t + 1 < t1) stage(t + 1, buf ^ 1);
    cp_async_commit();  // possibly empty: keeps one group per iteration
    float acc[kSub][kSub];
    if constexpr (kForm == kSliced) {
      sliced_dot(g, u0, t * kTile, ty, tx, sU, pu, sQ, Qg, acc);  // every copy landed
    } else {
      cp_async_wait<1>();
      __syncthreads();
      tile_dot(sU, sQ + buf * tile_f, g.ld, g.dp, ty, tx, acc);
    }
    const float* cn = sN + buf * noise_f;
    const uint8_t* cm = sM + buf * kTile * kMemLd;
    const int i0 = t * kTile;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = ty + kLanes * i;
      const int row = u0 + r;
      bool live[kSub];
      float v[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int c = tx + kLanes * j;
        const int item = i0 + c;
        live[j] = row < g.B && item < g.I;  // column 0 stays live
        v[j] = 0.f;
        if (live[j]) {
          const uint8_t mem = cm[r * kMemLd + mshift[i] + c];
          const float noise = cn[r * kNoiseLd + shift[i] + c];
          const float aux = mem == 0   ? 0.f
                            : mem == 1 ? wnu[i]
                                       : __fmul_rn(w, (float)mem) / rnu[i];
          const float probs = item > 0 ? __fmul_rn(expf(acc[i][j] - rm1[i]), il1[i]) : 0.f;
          const float mixed = __fadd_rn(__fmul_rn(omw, probs), aux);
          v[j] = __fmul_rn(__fadd_rn(logf(__fadd_rn(mixed, kEps)), noise), inv_t);
          z[(size_t)row * g.I + item] = v[j];
        }
      }
      stat_absorb<true>(m[i], l[i], v, live);
    }
    __syncthreads();  // all reads of this buffer done before it is refilled
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    stat_reduce_lanes(m[i], l[i]);
    const int row = u0 + ty + kLanes * i;
    if (tx == 0 && row < g.B) {
      part_m[(size_t)blockIdx.x * g.B + row] = m[i];
      part_l[(size_t)blockIdx.x * g.B + row] = l[i];
    }
  }
}

// ---- K3c --------------------------------------------------------------------
// K3c has a loop of its own, on K3b's pattern: its block is K3a's (the user
// tile blockIdx.y, the item tiles of chunk blockIdx.x, one partial per user
// and chunk), and besides Q_c's item tiles it double-buffers the tile's
// [64 users x 64 items] z operand in shared memory, so z of tile t + 1 is in
// flight (one cp.async group with Q_c's tile t + 1) during tile t's product.
// The [B, I] runs are staged and read back at their offsets as in K3b. Per
// element one expf and one multiply by the row's 1/l2, computed once a row:
// an ulp from the plain version's division. The sums keep their order (items
// in tile order, the 16 lanes' butterfly, chunks merged in order), so two
// calls give the same bits. kSliced stages only the z tiles ahead, as K3b
// its noise and member.

// Shared memory: the user tile, two Q_c item tiles, two z tiles.
size_t fake_smem(const Geo& g) {
  return (size_t)3 * kTile * g.ld * sizeof(float) + (size_t)2 * kTile * kNoiseLd * sizeof(float);
}

template <int kForm>
__global__ void __launch_bounds__(kThreads, 2)
fake_kernel(const float* __restrict__ pu_c, const float* __restrict__ Qc,
            const float* __restrict__ z, const float* __restrict__ m2,
            const float* __restrict__ l2, float* __restrict__ part, Shape<kForm> g) {
  extern __shared__ __align__(16) float smem[];
  const int tile_f = kTile * g.ld, zc_f = kTile * kNoiseLd;
  float* sU = smem;
  float* sQc = smem + tile_f;       // [buf] Q_c tiles
  float* sZc = smem + 3 * tile_f;   // [buf] z tiles
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int u0 = blockIdx.y * kTile;
  const int t0 = blockIdx.x * kChunkTiles;
  const int t1 = min(t0 + kChunkTiles, g.n_tiles);
  float rm2[kSub], il2[kSub], f[kSub];
  int shift[kSub];
  load_rows(m2, u0, ty, g.B, 0.f, rm2);
  load_rows(l2, u0, ty, g.B, 1.f, il2);
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    f[i] = 0.f;
    il2[i] = 1.f / il2[i];
    shift[i] = run_shift(u0 + ty + kLanes * i, g.I, g.off(z));
  }

  auto stage = [&](int t, int buf) {
    if constexpr (kForm != kSliced) stage_rows(sQc + buf * tile_f, Qc, t * kTile, g.I, g);
    stage_runs(sZc + buf * zc_f, z, kNoiseLd, u0, t * kTile, g);
  };
  if constexpr (kForm != kSliced) stage_rows(sU, pu_c, u0, g.B, g);
  stage(t0, 0);
  cp_async_commit();

  for (int t = t0, buf = 0; t < t1; ++t, buf ^= 1) {
    if (t + 1 < t1) stage(t + 1, buf ^ 1);
    cp_async_commit();  // possibly empty: keeps one group per iteration
    float acc[kSub][kSub];
    if constexpr (kForm == kSliced) {
      sliced_dot(g, u0, t * kTile, ty, tx, sU, pu_c, sQc, Qc, acc);  // every copy landed
    } else {
      cp_async_wait<1>();
      __syncthreads();
      tile_dot(sU, sQc + buf * tile_f, g.ld, g.dp, ty, tx, acc);
    }
    const float* cz = sZc + buf * zc_f;
    const int i0 = t * kTile;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = ty + kLanes * i;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int c = tx + kLanes * j;
        if (u0 + r < g.B && i0 + c < g.I) {
          const float zv = cz[r * kNoiseLd + shift[i] + c];
          const float s = __fmul_rn(expf(zv - rm2[i]), il2[i]);
          f[i] = fmaf(s, acc[i][j], f[i]);
        }
      }
    }
    __syncthreads();  // all reads of this buffer done before it is refilled
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const float v = sum_lanes(f[i]);
    const int row = u0 + ty + kLanes * i;
    if (tx == 0 && row < g.B) part[(size_t)blockIdx.x * g.B + row] = v;
  }
}

// ---- K3d --------------------------------------------------------------------
// K3d has a loop of its own, as K3b has. Its block is K3a's (64 users x a
// chunk of item tiles, one partial per user and chunk), but every buffer is
// single, so that two blocks fit on an SM at d = 64 and one fits at d = 128:
// the two user tiles, one Q_g/Q_c pair of item tiles, one z tile (rows of
// kNoiseLd floats), one member tile (rows of kMemLd bytes) and the block's
// per-row scalars. Each copy hides behind the phase that does not read it:
// z and member of tile t fly during tile t's two products, which read no z;
// Q_g and Q_c of tile t + 1 fly during tile t's epilogue, which reads no Q.
// The [B, I] runs are staged and read back at their offsets as in K3b.
//
// Per element: two expf and one division, by (mixed + 1e-20). probs and s
// multiply by per-row 1/l1 and 1/l2 (an ulp from the plain version's
// divisions); w member / nuniq is w / nuniq a row where member is 1 and 0
// where it is 0, as the division gives. kSliced stages the k slices of the
// four tiles for each item tile (sliced_dots), behind which z and member fly.

// probs and r of one [B, I] element (K3d's and K3e's epilogues) from its
// logit, its critic score c, its z and member and its row's scalars s1 = (m1,
// 1/l1, w/nuniq, nuniq) and s2 = (m2, 1/l2, a, fake): two expf and one
// division, by (mixed + 1e-20).
__device__ __forceinline__ void probs_r(float logit, float c, float zv, uint8_t mem, float4 s1,
                                        float4 s2, float omw, float w, float coef,
                                        float& probs, float& rv) {
  const float aux = mem == 0   ? 0.f
                    : mem == 1 ? s1.z
                               : __fmul_rn(w, (float)mem) / s1.w;
  probs = __fmul_rn(expf(logit - s1.x), s1.y);
  const float mixed = __fadd_rn(__fmul_rn(omw, probs), aux);
  const float sz = __fmul_rn(expf(zv - s2.x), s2.y);
  const float tt = __fmul_rn(s2.z, c - s2.w);
  rv = __fmul_rn(__fmul_rn(coef, sz), tt) / __fadd_rn(mixed, kEps);
}

// The per-row scalars of K3d, [kTile users][kRowScalars] in shared memory:
// two float4s a row, (m1, 1/l1, w/nuniq, nuniq) and (m2, 1/l2, a, fake).
constexpr int kRowScalars = 8;

// Shared memory: four [64, ld] tiles (P_g, P_c, Q_g, Q_c), the z tile, the
// row scalars and the member tile.
size_t bigr_smem(const Geo& g) {
  return (size_t)4 * kTile * g.ld * sizeof(float) + (size_t)kTile * kNoiseLd * sizeof(float) +
         (size_t)kTile * kRowScalars * sizeof(float) + (size_t)kTile * kMemLd;
}

template <int kForm>
__global__ void __launch_bounds__(kThreads, 2)
bigr_kernel(const float* __restrict__ pu_g, const float* __restrict__ Qg,
            const float* __restrict__ pu_c, const float* __restrict__ Qc,
            const uint8_t* __restrict__ member, const float* __restrict__ nuniq,
            const float* __restrict__ z, const float* __restrict__ m1,
            const float* __restrict__ l1, const float* __restrict__ m2,
            const float* __restrict__ l2, const float* __restrict__ a,
            const float* __restrict__ fake, float* __restrict__ part, Shape<kForm> g, float omw,
            float w, float coef) {
  extern __shared__ __align__(16) float smem[];
  const int tile_f = kTile * g.ld;
  float* sPg = smem;
  float* sPc = smem + tile_f;
  float* sQg = smem + 2 * tile_f;
  float* sQc = smem + 3 * tile_f;
  float* sZ = smem + 4 * tile_f;                                       // [kTile][kNoiseLd]
  float* sS = sZ + kTile * kNoiseLd;                                   // [kTile][kRowScalars]
  uint8_t* sM = reinterpret_cast<uint8_t*>(sS + kTile * kRowScalars);  // [kTile][kMemLd]
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int u0 = blockIdx.y * kTile;
  const int t0 = blockIdx.x * kChunkTiles;
  const int t1 = min(t0 + kChunkTiles, g.n_tiles);

  if constexpr (kForm != kSliced) {
    stage_rows(sPg, pu_g, u0, g.B, g);
    stage_rows(sPc, pu_c, u0, g.B, g);
    stage_rows(sQg, Qg, t0 * kTile, g.I, g);
    stage_rows(sQc, Qc, t0 * kTile, g.I, g);
  }
  cp_async_commit();
  if (threadIdx.x < kTile) {  // rows past B repeat row B - 1 and are masked
    const int row = min(u0 + (int)threadIdx.x, g.B - 1);
    float4* s = reinterpret_cast<float4*>(sS + threadIdx.x * kRowScalars);
    s[0] = make_float4(m1[row], 1.f / l1[row], w / nuniq[row], nuniq[row]);
    s[1] = make_float4(m2[row], 1.f / l2[row], a[row], fake[row]);
  }
  cp_async_wait<0>();
  __syncthreads();

  float acc_r[kSub] = {0.f, 0.f, 0.f, 0.f};
  for (int t = t0; t < t1; ++t) {
    const int i0 = t * kTile;
    stage_runs(sZ, z, kNoiseLd, u0, i0, g);
    stage_runs(sM, member, kMemLd, u0, i0, g);
    cp_async_commit();
    float lg[kSub][kSub], c[kSub][kSub];
    if constexpr (kForm == kSliced) {
      sliced_dots<2, 2>(g, u0, i0, ty, tx, sPg, pu_g, sQg, Qg, lg, sPc, pu_c, sQc, Qc, c);
    } else {
      tile_dot(sPg, sQg, g.ld, g.dp, ty, tx, lg);
      tile_dot(sPc, sQc, g.ld, g.dp, ty, tx, c);
      __syncthreads();  // every read of sQg, sQc done
      if (t + 1 < t1) {
        stage_rows(sQg, Qg, i0 + kTile, g.I, g);
        stage_rows(sQc, Qc, i0 + kTile, g.I, g);
      }
      cp_async_commit();  // possibly empty
      cp_async_wait<1>();  // this tile's z and member
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = ty + kLanes * i;
      const int row = u0 + r;
      const float4 s1 = *reinterpret_cast<const float4*>(sS + r * kRowScalars);
      const float4 s2 = *reinterpret_cast<const float4*>(sS + r * kRowScalars + 4);
      const int shift = run_shift(row, g.I, g.off(z));
      const int mshift = run_shift(row, g.I, g.off(member));
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int col = tx + kLanes * j;
        const int item = i0 + col;
        if (row < g.B && item > 0 && item < g.I) {  // the pad item has probs 0
          const uint8_t mem = sM[r * kMemLd + mshift + col];
          const float zv = sZ[r * kNoiseLd + shift + col];
          float probs, rv;
          probs_r(lg[i][j], c[i][j], zv, mem, s1, s2, omw, w, coef, probs, rv);
          acc_r[i] = fmaf(probs, rv, acc_r[i]);
        }
      }
    }
    cp_async_wait<0>();  // the next tile's Q_g, Q_c
    __syncthreads();      // ... seen by all, and every read of sZ, sM done
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const float v = sum_lanes(acc_r[i]);
    const int row = u0 + ty + kLanes * i;
    if (tx == 0 && row < g.B) part[(size_t)blockIdx.x * g.B + row] = v;
  }
}

// ---- K3e --------------------------------------------------------------------
// Block: item tile blockIdx.x, whose Q_g and Q_c rows stay in shared memory,
// and every user tile in order; dQ of the tile's items sums in registers and
// is written once, and the dP partial of each user tile goes to
// part_dP[item tile], summed in tile order by sum_combine. Every user-tile
// buffer is single, as in K3d: one P_g and one P_c tile, the [64 users][65]
// dlogits tile, one z tile (rows of kNoiseLd floats), one member tile (rows
// of kMemLd bytes) and the tile's per-row scalars, so that two blocks fit on
// an SM at d = 64 and one at d = 128. Each copy of user tile ut + 1 flies
// behind the phases of ut that do not read its buffer, and all of them are
// waited for at the top of ut + 1:
//   the products   read P_g, P_c, Q_g, Q_c;  then P_c of ut + 1 is issued;
//   the epilogue   reads z, member and the scalars, writes dlogits;
//                                            then z and member of ut + 1;
//   the dQ loop    reads dlogits and P_g;    then P_g and the scalars of ut + 1;
//   the dP loop    reads dlogits and Q_g.
// The [B, I] runs are staged and read back at their offsets as in K3b. Per
// element the arithmetic is K3d's (two expf, one division, by (mixed + 1e-20)),
// then dlogits = probs (r - R). Both loops keep a 4 x kC register tile
// (columns tx + 16j, kC = 4 up to d = 64, 8 up to d = 128) and sum in order:
// the dQ loop over the tile's users, the dP loop over its items, each step
// 4 dlogits and kC table values from shared memory for 4 kC FMAs. While the
// products run, the first four columns of dq wait in the dlogits tile, which
// is free until the epilogue: held in registers beside the products' operands
// they would push loop-invariant addresses into local memory (a spill).
// kSliced keeps no column in registers across user tiles: its products stage
// k slices of the four tiles (sliced_dots), then for each slice of kSlice
// columns P_g's and Q_g's slices are staged into their tiles, dQ's slice of
// the item tile is read back from dQ (its rows belong to this block alone;
// the first user tile starts from 0), summed on in registers in the same
// order (users in order) and written back, and dP's slice of the partial is
// summed and stored. z, member and the scalars of user tile ut + 1 fly
// behind the column slices.

// K3e's per-row scalars, [kTile users][kGradScalars] in shared memory, copied
// raw (m1, l1, nuniq, nuniq, m2, l2, a, fake, R) and turned in place into
// three float4s a row: (m1, 1/l1, w/nuniq, nuniq), (m2, 1/l2, a, fake), (R).
constexpr int kGradScalars = 12;

// Shared memory: four [64, ld] tiles (Q_g, Q_c, P_g, P_c), the dlogits tile,
// the z tile, the row scalars and the member tile.
size_t grad_smem(const Geo& g) {
  return (size_t)4 * kTile * g.ld * sizeof(float) + (size_t)kTile * kLdD * sizeof(float) +
         (size_t)kTile * kNoiseLd * sizeof(float) +
         (size_t)kTile * kGradScalars * sizeof(float) + (size_t)kTile * kMemLd;
}

// dq[i][j] += sum_u dlogits[u][item] P_g[u][col], items ty + 16i, columns
// tx + 16j < ncols of the [kTile][ld] tile sPg, u in order.
template <int kC>
__device__ __forceinline__ void grad_dq(const float* sD, const float* sPg, int ld, int ncols,
                                        int ty, int tx, float (&dq)[kSub][kC]) {
#pragma unroll (kC == 4 ? 4 : 2)  // the unrolling that spills nothing at either width
  for (int u = 0; u < kTile; ++u) {
    float dv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) dv[i] = sD[u * kLdD + ty + kLanes * i];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int col = tx + kLanes * j;
      if (col < ncols) {
        const float p = sPg[u * ld + col];
#pragma unroll
        for (int i = 0; i < kSub; ++i) dq[i][j] = fmaf(dv[i], p, dq[i][j]);
      }
    }
  }
}

// One user tile's dP partial, sum_it dlogits[user][it] Q_g[it][col] for
// users u0 + ty + 16i < B and columns tx + 16j < ncols of the [kTile][ld]
// tile sQg, it in order, into `part` (this item tile's [B, d] slice, rows
// `stride` floats apart).
template <int kC>
__device__ __forceinline__ void grad_dp(const float* sD, const float* sQg, int ld, int ncols,
                                        int ty, int tx, int u0, int B, float* part,
                                        int stride) {
  float dp[kSub][kC];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) dp[i][j] = 0.f;
#pragma unroll (kC == 4 ? 4 : 2)
  for (int it = 0; it < kTile; ++it) {
    float dv[kSub], q[kC];
#pragma unroll
    for (int i = 0; i < kSub; ++i) dv[i] = sD[(ty + kLanes * i) * kLdD + it];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int col = tx + kLanes * j;
      q[j] = col < ncols ? sQg[it * ld + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) dp[i][j] = fmaf(dv[i], q[j], dp[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int row = u0 + ty + kLanes * i;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int col = tx + kLanes * j;
      if (col < ncols) part[(size_t)row * stride + col] = dp[i][j];
    }
  }
}

template <int kC, int kForm>
__global__ void __launch_bounds__(kThreads, 2)
grad_kernel(const float* __restrict__ pu_g, const float* __restrict__ Qg,
            const float* __restrict__ pu_c, const float* __restrict__ Qc,
            const uint8_t* __restrict__ member, const float* __restrict__ nuniq,
            const float* __restrict__ z, const float* __restrict__ m1,
            const float* __restrict__ l1, const float* __restrict__ m2,
            const float* __restrict__ l2, const float* __restrict__ a,
            const float* __restrict__ fake, const float* __restrict__ R,
            float* __restrict__ dQ, float* __restrict__ part_dP, Shape<kForm> g, float omw,
            float w, float coef) {
  static_assert(kForm != kSliced || kC == 4, "kSliced: columns in slices of 64");
  extern __shared__ __align__(16) float smem[];
  const int tile_f = kTile * g.ld;
  float* sQg = smem;
  float* sQc = smem + tile_f;
  float* sPg = smem + 2 * tile_f;
  float* sPc = smem + 3 * tile_f;
  float* sD = smem + 4 * tile_f;                                          // [kTile][kLdD]
  float* sZe = sD + kTile * kLdD;                                         // [kTile][kNoiseLd]
  float* sSe = sZe + kTile * kNoiseLd;                                    // [kTile][kGradScalars]
  uint8_t* sMe = reinterpret_cast<uint8_t*>(sSe + kTile * kGradScalars);  // [kTile][kMemLd]
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int i0 = blockIdx.x * kTile;
  const int n_user_tiles = (g.B + kTile - 1) / kTile;
  float* part = part_dP + (size_t)blockIdx.x * g.B * g.d;

  auto stage_zm = [&](int u0) {
    stage_runs(sZe, z, kNoiseLd, u0, i0, g);
    stage_runs(sMe, member, kMemLd, u0, i0, g);
  };
  auto stage_scalars = [&](int u0) {  // rows past B repeat row B - 1 and are masked
    if (threadIdx.x < kTile) {
      const int row = min(u0 + (int)threadIdx.x, g.B - 1);
      float* s = sSe + threadIdx.x * kGradScalars;
      const float* src[9] = {m1, l1, nuniq, nuniq, m2, l2, a, fake, R};
#pragma unroll
      for (int k = 0; k < 9; ++k) cp_async_n<4>(s + k, src[k] + row, 4);
    }
  };

  if constexpr (kForm != kSliced) {
    stage_rows(sQg, Qg, i0, g.I, g);
    stage_rows(sQc, Qc, i0, g.I, g);
    stage_rows(sPg, pu_g, 0, g.B, g);
    stage_rows(sPc, pu_c, 0, g.B, g);
  }
  stage_scalars(0);
  stage_zm(0);
  cp_async_commit();

  float dq[kSub][kC];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) dq[i][j] = 0.f;

  for (int ut = 0; ut < n_user_tiles; ++ut) {
    const int u0 = ut * kTile;
    const bool next = ut + 1 < n_user_tiles;
    cp_async_wait<0>();  // every copy of this user tile
    if (threadIdx.x < kTile) {  // the row this thread copied the scalars of
      float* s = sSe + threadIdx.x * kGradScalars;
      s[1] = 1.f / s[1];
      s[2] = w / s[2];
      s[5] = 1.f / s[5];
    }
    __syncthreads();

    float lg[kSub][kSub], c[kSub][kSub];
    if constexpr (kForm == kSliced) {
      // k loop not unrolled: unrolled twice it spills at 128 registers
      sliced_dots<2, 1>(g, u0, i0, ty, tx, sPg, pu_g, sQg, Qg, lg, sPc, pu_c, sQc, Qc, c);
    } else {
      // The first four columns of dq wait in the dlogits tile, free until the
      // epilogue, while the two products hold their operands in registers.
      float4* park = reinterpret_cast<float4*>(sD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        park[j * kThreads + threadIdx.x] = make_float4(dq[0][j], dq[1][j], dq[2][j], dq[3][j]);
      tile_dot(sPg, sQg, g.ld, g.dp, ty, tx, lg);
      tile_dot(sPc, sQc, g.ld, g.dp, ty, tx, c);
      asm volatile("" ::: "memory");  // dq is read back, not kept in registers
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = park[j * kThreads + threadIdx.x];
        dq[0][j] = v.x;
        dq[1][j] = v.y;
        dq[2][j] = v.z;
        dq[3][j] = v.w;
      }
      __syncthreads();  // every read of sPc and of the parked dq done
      if (next) stage_rows(sPc, pu_c, u0 + kTile, g.B, g);
      cp_async_commit();
    }

#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = ty + kLanes * i;
      const int row = u0 + r;
      const float4 s1 = *reinterpret_cast<const float4*>(sSe + r * kGradScalars);
      const float4 s2 = *reinterpret_cast<const float4*>(sSe + r * kGradScalars + 4);
      const float rR = sSe[r * kGradScalars + 8];
      const int shift = run_shift(row, g.I, g.off(z));
      const int mshift = run_shift(row, g.I, g.off(member));
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int col = tx + kLanes * j;
        const int item = i0 + col;
        float dl = 0.f;  // rows past B, the pad item and items past I
        if (row < g.B && item > 0 && item < g.I) {
          const uint8_t mem = sMe[r * kMemLd + mshift + col];
          const float zv = sZe[r * kNoiseLd + shift + col];
          float probs, rv;
          probs_r(lg[i][j], c[i][j], zv, mem, s1, s2, omw, w, coef, probs, rv);
          dl = __fmul_rn(probs, rv - rR);
        }
        sD[r * kLdD + col] = dl;
      }
    }
    __syncthreads();  // sD complete; every read of sZe, sMe and sSe done
    if (next) stage_zm(u0 + kTile);
    if constexpr (kForm == kSliced) {
      if (next) stage_scalars(u0 + kTile);
    }
    cp_async_commit();

    if constexpr (kForm == kSliced) {
      for (int s = 0; s < g.n_slices; ++s) {
        stage_slice(sPg, pu_g, u0, g.B, s, g);
        stage_slice(sQg, Qg, i0, g.I, s, g);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const int c0 = s * kSlice, nc = min(kSlice, g.d - c0);
        float dqs[kSub][4];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int item = i0 + ty + kLanes * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = tx + kLanes * j;
            dqs[i][j] = ut > 0 && item < g.I && col < nc ? dQ[(size_t)item * g.d + c0 + col] : 0.f;
          }
        }
        grad_dq<4>(sD, sPg, g.ld, nc, ty, tx, dqs);
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int item = i0 + ty + kLanes * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = tx + kLanes * j;
            if (item < g.I && col < nc) dQ[(size_t)item * g.d + c0 + col] = dqs[i][j];
          }
        }
        grad_dp<4>(sD, sQg, g.ld, nc, ty, tx, u0, g.B, part + c0, g.d);
        __syncthreads();  // every read of sPg, sQg done before they are refilled
      }
    } else {
      grad_dq<kC>(sD, sPg, g.ld, g.d, ty, tx, dq);
      __syncthreads();  // every read of sPg done
      if (next) {
        stage_rows(sPg, pu_g, u0 + kTile, g.B, g);
        stage_scalars(u0 + kTile);
      }
      cp_async_commit();

      grad_dp<kC>(sD, sQg, g.ld, g.d, ty, tx, u0, g.B, part, g.d);
    }
  }

  if constexpr (kForm != kSliced) {  // (kSliced wrote dQ slice by slice)
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int item = i0 + ty + kLanes * i;
      if (item >= g.I) continue;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int col = tx + kLanes * j;
        if (col < g.d) dQ[(size_t)item * g.d + col] = dq[i][j];
      }
    }
  }
}

// ---- merges of the partials ------------------------------------------------
// Output idx (a user's statistic or sum, or an entry of K3e's dP) merges its
// n_parts partials part[c * n + idx], c in [0, n_parts). A block of kThreads
// threads takes kMergeOuts outputs: lane k of every warp the output
// blockIdx.x * kMergeOuts + k, so each load of a part is one coalesced
// 128-byte run, and warp s the s-th of kMergeSlices contiguous slices of the
// parts. A thread issues kMergeUnroll loads of its slice before it merges
// them, in part order; the slices' results meet in shared memory, where warp
// 0 merges them in slice order. The order depends on n_parts alone and there
// are no atomics, so two calls give the same bits. A slice with no part (at
// fewer than kMergeSlices parts) merges as (-inf, 0), or 0.
constexpr int kMergeOuts = 32;
constexpr int kMergeSlices = kThreads / kMergeOuts;  // 8
constexpr int kMergeUnroll = 16;

// The parts [c0, c1) of this thread's slice.
__device__ __forceinline__ void merge_slice(int n_parts, int& c0, int& c1) {
  const int per = (n_parts + kMergeSlices - 1) / kMergeSlices;
  c0 = min(n_parts, (int)(threadIdx.x / kMergeOuts) * per);
  c1 = min(n_parts, c0 + per);
}

__global__ void __launch_bounds__(kThreads)
stat_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
             float* __restrict__ m_out, float* __restrict__ l_out, int n, int n_parts) {
  __shared__ float sm[kMergeSlices][kMergeOuts], sl[kMergeSlices][kMergeOuts];
  const int lane = threadIdx.x % kMergeOuts, slice = threadIdx.x / kMergeOuts;
  const int idx = blockIdx.x * kMergeOuts + lane;
  int c0, c1;
  merge_slice(n_parts, c0, c1);
  float m = -INFINITY, l = 0.f;
  for (int c = c0; idx < n && c < c1; c += kMergeUnroll) {
    float pm[kMergeUnroll], pl[kMergeUnroll];
#pragma unroll
    for (int k = 0; k < kMergeUnroll; ++k) {
      const bool in = c + k < c1;
      pm[k] = in ? part_m[(size_t)(c + k) * n + idx] : -INFINITY;
      pl[k] = in ? part_l[(size_t)(c + k) * n + idx] : 0.f;
    }
    float pmax = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMergeUnroll; ++k) pmax = fmaxf(pmax, pm[k]);
    if (pmax == -INFINITY) continue;  // only empty parts
    if (pmax > m) {                   // rescale only when the max grows
      l *= expf(m - pmax);
      m = pmax;
    }
#pragma unroll
    for (int k = 0; k < kMergeUnroll; ++k)
      if (c + k < c1) l += pl[k] * expf(pm[k] - m);
  }
  sm[slice][lane] = m;
  sl[slice][lane] = l;
  __syncthreads();
  if (slice != 0 || idx >= n) return;
#pragma unroll
  for (int s = 1; s < kMergeSlices; ++s) stat_merge(m, l, sm[s][lane], sl[s][lane]);
  m_out[idx] = m;
  l_out[idx] = l;
}

__global__ void __launch_bounds__(kThreads)
sum_combine(const float* __restrict__ part, float* __restrict__ out, size_t n, int n_parts) {
  __shared__ float ss[kMergeSlices][kMergeOuts];
  const int lane = threadIdx.x % kMergeOuts, slice = threadIdx.x / kMergeOuts;
  const size_t idx = (size_t)blockIdx.x * kMergeOuts + lane;
  int c0, c1;
  merge_slice(n_parts, c0, c1);
  float s = 0.f;
  for (int c = c0; idx < n && c < c1; c += kMergeUnroll) {
    float p[kMergeUnroll];
#pragma unroll
    for (int k = 0; k < kMergeUnroll; ++k)
      p[k] = c + k < c1 ? part[(size_t)(c + k) * n + idx] : 0.f;
#pragma unroll
    for (int k = 0; k < kMergeUnroll; ++k)
      if (c + k < c1) s += p[k];
  }
  ss[slice][lane] = s;
  __syncthreads();
  if (slice != 0 || idx >= n) return;
#pragma unroll
  for (int k = 1; k < kMergeSlices; ++k) s += ss[k][lane];
  out[idx] = s;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Where an array starts within its first aligned 4-element unit.
int unit_off(const float* p) { return (int)(reinterpret_cast<uintptr_t>(p) / sizeof(float) % 4); }
int unit_off(const uint8_t* p) { return (int)(reinterpret_cast<uintptr_t>(p) % 4); }

// The geometry of one call: `rows` its [B, d] and [I, d] operands, `runs` the
// float [B, I] operand it reads (noise or z; none in K3a) and `member` (none
// in K3a and K3c).
Geo make_geo(int B, int I, int d, std::initializer_list<const float*> rows, const float* runs,
             const uint8_t* member) {
  Geo g;
  g.B = B;
  g.I = I;
  g.d = d;
  g.dp = pad4(d);
  g.ld = d > kMaxWhole ? row_ld(kSlice) : row_ld(g.dp);
  g.n_tiles = (I + kTile - 1) / kTile;
  g.n_chunks = (g.n_tiles + kChunkTiles - 1) / kChunkTiles;
  g.n_slices = (g.dp + kSlice - 1) / kSlice;
  g.rows16 = d % 4 == 0;
  for (const float* p : rows) g.rows16 = g.rows16 && aligned16(p);
  g.off_f = runs ? unit_off(runs) : 0;
  g.off_m = member ? unit_off(member) : 0;
  return g;
}

int form_of(const Geo& g) {
  if (g.d > kMaxWhole) return kSliced;
  return g.rows16 && g.off_f == 0 && g.off_m == 0 ? kAligned : kAny;
}

// launch(Shape<form>) for the form g takes; its error.
template <typename Launch>
cudaError_t with_form(const Geo& g, Launch launch) {
  switch (form_of(g)) {
    case kAligned: return launch(Shape<kAligned>(g));
    case kAny: return launch(Shape<kAny>(g));
    default: return launch(Shape<kSliced>(g));
  }
}

// No width is refused: every d >= 1 has a form.
bool bad_shape(int B, int I, int d) { return B <= 0 || I < 2 || d <= 0; }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

dim3 chunk_grid(const Geo& g) { return dim3(g.n_chunks, (g.B + kTile - 1) / kTile); }

cudaError_t combine_stats(const float* part, float* m, float* l, const Geo& g,
                          cudaStream_t st) {
  stat_combine<<<(g.B + kMergeOuts - 1) / kMergeOuts, kThreads, 0, st>>>(
      part, part + (size_t)g.n_chunks * g.B, m, l, g.B, g.n_chunks);
  return cudaGetLastError();
}

cudaError_t combine_sums(const float* part, float* out, size_t n, int n_parts,
                         cudaStream_t st) {
  sum_combine<<<(unsigned)((n + kMergeOuts - 1) / kMergeOuts), kThreads, 0, st>>>(part, out, n,
                                                                               n_parts);
  return cudaGetLastError();
}

}  // namespace

// Every entry takes the scratch `part` the wrapper allocates (its size in the
// comment), launches on `stream` and returns the cudaError_t of its launches.

// K3a: m1, l1 [B]; part [2, n_chunks, B].
extern "C" int acf_apl_stats1(const float* pu, const float* Qg, float* m1, float* l1,
                              float* part, int B, int I, int d, void* stream) {
  if (bad_shape(B, I, d)) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(B, I, d, {pu, Qg}, nullptr, nullptr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_form(g, [&](auto shape) {
    const auto kernel = stats1_kernel<decltype(shape)::form>;
    const size_t smem = stats_smem(shape);
    const cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<chunk_grid(shape), kThreads, smem, st>>>(pu, Qg, part,
                                                      part + (size_t)g.n_chunks * B, shape);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  return (int)combine_stats(part, m1, l1, g, st);
}

// K3b: z [B, I], m2, l2 [B]; part [2, n_chunks, B].
extern "C" int acf_apl_z(const float* pu, const float* Qg, const uint8_t* member,
                         const float* nuniq, const float* gn, const float* m1,
                         const float* l1, float* z, float* m2, float* l2, float* part, int B,
                         int I, int d, float omw, float w, float T, void* stream) {
  if (bad_shape(B, I, d)) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(B, I, d, {pu, Qg}, gn, member);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_form(g, [&](auto shape) {
    const auto kernel = z_kernel<decltype(shape)::form>;
    const size_t smem = z_smem(shape);
    const cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<chunk_grid(shape), kThreads, smem, st>>>(pu, Qg, member, nuniq, gn, m1, l1, z, part,
                                                  part + (size_t)g.n_chunks * B, shape, omw, w, T);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  return (int)combine_stats(part, m2, l2, g, st);
}

// K3c: fake [B]; part [n_chunks, B].
extern "C" int acf_apl_fake(const float* pu_c, const float* Qc, const float* z,
                            const float* m2, const float* l2, float* fake, float* part, int B,
                            int I, int d, void* stream) {
  if (bad_shape(B, I, d)) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(B, I, d, {pu_c, Qc}, z, nullptr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_form(g, [&](auto shape) {
    const auto kernel = fake_kernel<decltype(shape)::form>;
    const size_t smem = fake_smem(shape);
    const cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<chunk_grid(shape), kThreads, smem, st>>>(pu_c, Qc, z, m2, l2, part, shape);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  return (int)combine_sums(part, fake, (size_t)B, g.n_chunks, st);
}

// K3d: R [B]; part [n_chunks, B].
extern "C" int acf_apl_bigr(const float* pu_g, const float* Qg, const float* pu_c,
                            const float* Qc, const uint8_t* member, const float* nuniq,
                            const float* z, const float* m1, const float* l1, const float* m2,
                            const float* l2, const float* a, const float* fake, float* R,
                            float* part, int B, int I, int d, float omw, float w,
                            float coef, void* stream) {
  if (bad_shape(B, I, d)) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(B, I, d, {pu_g, Qg, pu_c, Qc}, z, member);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_form(g, [&](auto shape) {
    const auto kernel = bigr_kernel<decltype(shape)::form>;
    const size_t smem = bigr_smem(shape);
    const cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<chunk_grid(shape), kThreads, smem, st>>>(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1,
                                                  m2, l2, a, fake, part, shape, omw, w, coef);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  return (int)combine_sums(part, R, (size_t)B, g.n_chunks, st);
}

// K3e: dQ [I, d], dP [B, d]; part [n_tiles, B, d].
extern "C" int acf_apl_grad(const float* pu_g, const float* Qg, const float* pu_c,
                            const float* Qc, const uint8_t* member, const float* nuniq,
                            const float* z, const float* m1, const float* l1, const float* m2,
                            const float* l2, const float* a, const float* fake, const float* R,
                            float* dQ, float* dP, float* part, int B, int I, int d, float omw,
                            float w, float coef, void* stream) {
  if (bad_shape(B, I, d)) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(B, I, d, {pu_g, Qg, pu_c, Qc}, z, member);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_form(g, [&](auto shape) {
    constexpr int kForm = decltype(shape)::form;
    // 4 register columns a thread up to d = 64, 8 up to d = 128; kSliced 4
    auto kernel = grad_kernel<4, kForm>;
    if constexpr (kForm != kSliced) {
      if (d > 4 * kLanes) kernel = grad_kernel<8, kForm>;
    }
    const size_t smem = grad_smem(shape);
    const cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<shape.n_tiles, kThreads, smem, st>>>(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1,
                                                  m2, l2, a, fake, R, dQ, part, shape, omw, w,
                                                  coef);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  return (int)combine_sums(part, dP, (size_t)B * d, g.n_tiles, st);
}
