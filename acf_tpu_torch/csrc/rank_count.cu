// K1 — full-catalog rank counter for Hopper (sm_90a).
//
// Replaces the TPU kernel `_count_kernel` in acf_tpu/ops/ranking.py (entry
// `rank_positions_dot`). For every user b it counts the items j with
//
//     u_b . e_j + bias_j >= t_b,   id_base + j != 0, id_base + j != gt_b, j < I
//
// in true float32, without materialising the [B, I] score matrix. `id_base`
// is the global id of the table's first row: 0 for a whole catalog, the
// shard's offset for a catalog shard (acf_tpu_torch/parallel/sharded_eval.py),
// whose I is then the shard's real rows.
//
// Bound on an H100: compute. The work is 2*B*I*d float32 operations done as
// FMAs outside the tensor cores (67 TFLOP/s non-tensor FP32 peak): at the
// evaluation's tile of 512 users, I = 23,701 and d = 64, 1.55 GFLOP, 0.0232
// ms, while the bytes (the tables plus per-user scalars, ~6 MB) take ~2 us at
// 3.35 TB/s. TF32 tensor-core products are not float32 and would move rank
// positions, so they are not used.
//
// Design:
//   * Each of 256 threads keeps an 8 x kRI register tile of dot products
//     (users ty + 16i, items tx + 16j), summed over k = 0..d-1 in order with
//     plain fp32 FMAs (acc = fmaf(u_k, e_k, acc)), the bias added after, as
//     every earlier form of this kernel did: the counts do not depend on the
//     tile, the slices or the grid.
//   * Two unit shapes: 128 users x 256 items (8 x 16 a thread, 254
//     registers, one block an SM) where there are at least as many such units
//     as SMs, as at the Video-shaped evaluation; else 128 x 128 (8 x 8, 128
//     registers, two blocks an SM), which keeps more SMs busy on a small
//     table (the ml-1m shape has 60 wide units for 132 SMs).
//   * A warp is 4 user lanes x 8 item lanes, so a float4 read of 8 item rows
//     (or of 4 user rows) from shared memory is one wavefront; per four k a
//     thread reads 8 + kRI float4 for 32 kRI FMAs.
//   * Both operands stream with k: slices of 32 k of the unit's item and user
//     rows go through a ring of two shared-memory slots, one slice ahead, one
//     __syncthreads a slice. One thread issues each slice as two TMA boxes of
//     [rows][36] floats, counted on the slot's mbarrier: 36-float rows (an
//     odd number of 16-byte units) put neighbouring rows in distinct bank
//     groups with no swizzle, and the tensor maps zero-fill rows past B and I
//     and columns past d. A unit's last slice also carries the items' bias
//     and the users' thresholds and gt (4-byte cp.async), so the epilogue
//     reads no device memory. Shared memory does not grow with d.
//   * Any width and alignment: where d % 4 != 0 or u or e is not 16-byte
//     aligned (a row view of a table, a width like 50), no tensor map can
//     describe the table, so the build without TMA stages the same slots
//     with 4-byte cp.async copies of the slice's 32 columns, zero-filled
//     past d, B and I, waited for like the extras (the C entry chooses).
//     The products and the counts are the same code.
//   * A flat list of (user tile, item tile) units, user tile major. The grid
//     is as many blocks as are resident at once, or fewer where that evens
//     out the runs; each block takes a contiguous run of the list, so it
//     stays on one user tile as long as it can.
//   * Item 0, each user's gt and the ragged tail j >= I are masked in the
//     epilogue from the staged data, so the table is never padded or copied
//     in device memory. On a shard the gt is made local as it is read
//     (gt - id_base), so the compare in the count is the same instruction.
//   * The 8 lanes of a warp that share a user halve their 8 users' counts
//     into one user a lane (7 shuffles); a lane keeps its user's count over
//     the block's units of that user tile, then adds it to `out` with one
//     int32 atomicAdd. Integer atomics keep the result deterministic.
// acf_tpu_torch/tools/k1_ablation.py times variants of this file, each with
// one design choice swapped (the constants marked "ablation" among them).
// Later work: 3xTF32 or wgmma products, which sum in another order
// (ROADMAP.md, the product shared by K3a-K3e).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kSliceK = 32;              // ablation: k values a ring slot holds
constexpr int kStages = 2;               // ablation: ring slots
constexpr int kRU = 8;                   // ablation: users a thread (at most 8)
constexpr int kThreads = 256;
constexpr int kUsers = 16 * kRU;         // users a unit
constexpr int kLdk = row_ld(kSliceK);    // a slot's row stride (floats)

// A unit shape: RI items a thread, BLOCKS blocks an SM. A slot holds the
// unit's kItems item rows and kUsers user rows, [.][kLdk], then at kExtra
// its item bias [kItems], its users' thresholds [kUsers] and gt [kUsers].
template <int RI, int BLOCKS>
struct Shape {
  static constexpr int kRI = RI, kBlocks = BLOCKS;
  static constexpr int kItems = 16 * RI;
  static constexpr int kExtra = (kItems + kUsers) * kLdk;
  static constexpr int kSlotFloats = kExtra + kItems + 2 * kUsers;
  static constexpr unsigned kSlotTx = (kItems + kUsers) * kLdk * 4;  // bytes of its two boxes
  static_assert(kSlotFloats * 4 % 128 == 0 && kItems * kLdk * 4 % 128 == 0,
                "TMA boxes land 128-byte aligned");
};
using Wide = Shape<16, 1>;
using Narrow = Shape<8, 2>;              // ablation: the narrow shape

struct Args {
  const float* u;       // [B, d] users and [I, d] items (read by the build
  const float* e;       // without TMA; the other reads the tensor maps)
  const float* bias;    // may be null
  const float* thresh;
  const int* gt;        // may be null
  int* out;
  int B, I, d;
  int n_item_tiles, n_units, n_slices;
  int id_base;          // the global id of row 0 of the table
  bool tma;             // both tables as tensor maps (d % 4 == 0, 16-byte aligned)
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile("{\n .reg .pred p;\n WAIT_%=:\n"
               " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               " @!p bra WAIT_%=;\n}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// The box of `map` at column c0, row r0 into dst (TMA), counted on `bar`.
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map, int c0, int r0,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
         "r"(smem_u32(bar)) : "memory");
}

// The block's units: first + n * stride for n < count. Here a contiguous
// run of the flat list (the split grid of tools/k1_ablation.py strides).
struct Walk {
  int first, stride, count;
};

__device__ __forceinline__ Walk walk(const Args& a) {
  const int first = static_cast<int>(static_cast<long long>(blockIdx.x) * a.n_units / gridDim.x);
  const int end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * a.n_units / gridDim.x);
  return {first, 1, end - first};
}

// The slice ks's columns of the unit's rows as 4-byte cp.async copies, the
// layout the TMA boxes give: item rows i0.. then user rows u0.. of a slot,
// [.][kLdk], zero past d, I and B (the build without TMA).
template <class S>
__device__ __forceinline__ void copy_rows(float* slot, const Args& a, const float* u,
                                          const float* e, int u0, int i0, int ks) {
  const int k0 = ks * kSliceK;
#pragma unroll 1
  for (int idx = threadIdx.x; idx < (S::kItems + kUsers) * kSliceK; idx += kThreads) {
    const int row = idx / kSliceK, c = idx % kSliceK;
    const bool item = row < S::kItems;
    const int r = item ? i0 + row : u0 + row - S::kItems;
    const bool valid = k0 + c < a.d && r < (item ? a.I : a.B);
    const float* src = valid ? (item ? e : u) + static_cast<size_t>(r) * a.d + k0 + c : a.thresh;
    cp_async_n<4>(slot + row * kLdk + c, src, valid ? 4 : 0);
  }
}

// Issue the copies of the walk's step `step` (slice ks of its unit n) into
// `slot`: with TMA the boxes, counted on `bar`; without, copy_rows.
template <class S, bool TMA>
__device__ __forceinline__ void stage(float* slot, uint64_t* bar, const Args& a,
                                      const CUtensorMap& tm_e, const CUtensorMap& tm_u,
                                      const Walk& w, int step) {
  const int n = step / a.n_slices, ks = step - n * a.n_slices;
  const int unit = w.first + n * w.stride;
  const int ut = unit / a.n_item_tiles;
  const int u0 = ut * kUsers, i0 = (unit - ut * a.n_item_tiles) * S::kItems;
  if (TMA && threadIdx.x == 0) {
    mbar_expect_tx(bar, S::kSlotTx);
    tma_box(slot, &tm_e, ks * kSliceK, i0, bar);
    tma_box(slot + S::kItems * kLdk, &tm_u, ks * kSliceK, u0, bar);
  }
  if (!TMA) copy_rows<S>(slot, a, a.u, a.e, u0, i0, ks);
  if (ks != a.n_slices - 1) return;
  // the unit's last slice: what its epilogue reads, zero where there is none
  float* x = slot + S::kExtra;
  for (int idx = threadIdx.x; idx < S::kItems + 2 * kUsers; idx += kThreads) {
    const void* src = a.thresh;
    bool valid;
    if (idx < S::kItems) {
      const int item = i0 + idx;
      valid = a.bias != nullptr && item < a.I;
      if (valid) src = a.bias + item;
    } else if (idx < S::kItems + kUsers) {
      const int row = u0 + idx - S::kItems;
      valid = row < a.B;
      if (valid) src = a.thresh + row;
    } else {
      const int row = u0 + idx - S::kItems - kUsers;
      valid = a.gt != nullptr && row < a.B;
      if (valid) src = a.gt + row;
    }
    cp_async_n<4>(x + idx, src, valid ? 4 : 0);
  }
}

// acc[i][j] += the products of user row ty + 16i (sa, row stride lda) and
// item row tx + 16j (sb) over k < kn, one FMA at a time in k order. The k
// loop is not unrolled: at two blocks an SM the 64 sums, 8 user float4 and an
// item float4 take the 128 registers, and unrolled twice it spills.
template <int RI>
__device__ __forceinline__ void slice_dot(float (&acc)[kRU][RI], const float* sa, int lda,
                                          const float* sb, int kn) {
#pragma unroll 1
  for (int k = 0; k < kn; k += 4) {
    float4 a[kRU];
#pragma unroll
    for (int i = 0; i < kRU; ++i) a[i] = *reinterpret_cast<const float4*>(sa + 16 * i * lda + k);
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(sb + 16 * j * kLdk + k);
#pragma unroll
      for (int i = 0; i < kRU; ++i) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b.x, s);
        s = fmaf(a[i].y, b.y, s);
        s = fmaf(a[i].z, b.z, s);
        s = fmaf(a[i].w, b.w, s);
        acc[i][j] = s;
      }
    }
  }
}

template <class S, bool TMA>
__global__ void __launch_bounds__(kThreads, S::kBlocks)
rank_count_kernel(const Args a, const __grid_constant__ CUtensorMap tm_e,
                  const __grid_constant__ CUtensorMap tm_u) {
  constexpr int kRI = S::kRI, kItems = S::kItems;
  extern __shared__ __align__(128) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * S::kSlotFloats);  // one a slot
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // users ty + 16i
  const int tx = (warp & 1) * 8 + (lane & 7);    // items tx + 16j
  const Walk w = walk(a);
  const int steps = w.count * a.n_slices;  // step s: slice s % n_slices of unit s / n_slices

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) stage<S, TMA>(smem + s * S::kSlotFloats, bars + s, a, tm_e, tm_u, w, s);
    cp_async_commit();  // possibly empty: one group a step
  }

  float acc[kRU][kRI];
#pragma unroll
  for (int i = 0; i < kRU; ++i)
#pragma unroll
    for (int j = 0; j < kRI; ++j) acc[i][j] = 0.f;
  int run = 0;  // this lane's user's count over the block's units of its user tile
  for (int s = 0, slot = 0; s < steps; ++s, slot = slot + 1 == kStages ? 0 : slot + 1) {
    if (TMA) mbar_wait(bars + slot, (s / kStages) & 1);  // step s's boxes
    cp_async_wait<kStages - 2>();  // this thread's copies of step s's extras (and rows)
    __syncthreads();  // step s visible; the slot of step s - 1 read by all: refill it
    if (s + kStages - 1 < steps) {
      const int prev = slot == 0 ? kStages - 1 : slot - 1;
      stage<S, TMA>(smem + prev * S::kSlotFloats, bars + prev, a, tm_e, tm_u, w,
                    s + kStages - 1);
    }
    cp_async_commit();

    const int n = s / a.n_slices, ks = s - n * a.n_slices;
    const int unit = w.first + n * w.stride;
    const int ut = unit / a.n_item_tiles;
    const float* cur = smem + slot * S::kSlotFloats;
    const int k0 = ks * kSliceK;
    slice_dot<kRI>(acc, cur + (kItems + ty) * kLdk, kLdk, cur + tx * kLdk,
                   min(kSliceK, a.d - k0));

    if (ks == a.n_slices - 1) {  // the unit's epilogue
      const float* x = cur + S::kExtra;
      const int* sg = reinterpret_cast<const int*>(x + kItems + kUsers);
      const int i0 = (unit - ut * a.n_item_tiles) * kItems;
      float t[kRU];
      int g[kRU], c[kRU];
#pragma unroll
      for (int i = 0; i < kRU; ++i) {
        t[i] = x[kItems + ty + 16 * i];
        g[i] = sg[ty + 16 * i] - a.id_base;  // the gt's local row
        c[i] = 0;
      }
#pragma unroll
      for (int j = 0; j < kRI; ++j) {
        const int item = i0 + tx + 16 * j;
        if (item + a.id_base <= 0 || item >= a.I) continue;  // pad id 0 and the ragged tail
        const float bj = x[tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRU; ++i) c[i] += (acc[i][j] + bj >= t[i] && item != g[i]) ? 1 : 0;
      }
      // the 8 lanes sharing users (lane & 7 their items) halve the counts:
      // lane l keeps user ty + 16 (l & 7)'s (with kRU < 8, lanes l & 7 < kRU)
#pragma unroll
      for (int h = kRU / 2; h >= 1; h /= 2) {
        const bool upper = lane & h;
#pragma unroll
        for (int i = 0; i < h; ++i) {
          const int send = upper ? c[i] : c[i + h];
          c[i] = (upper ? c[i + h] : c[i]) + __shfl_xor_sync(0xffffffffu, send, h);
        }
      }
#pragma unroll
      for (int h = kRU; h < 8; h *= 2) c[0] += __shfl_xor_sync(0xffffffffu, c[0], h);
      run += c[0];
      if (n + 1 == w.count || (unit + w.stride) / a.n_item_tiles != ut) {
        const int row = ut * kUsers + ty + 16 * (lane & 7);
        if ((lane & 7) < kRU && row < a.B && run != 0) atomicAdd(a.out + row, run);
        run = 0;
      }
#pragma unroll
      for (int i = 0; i < kRU; ++i)
#pragma unroll
        for (int j = 0; j < kRI; ++j) acc[i][j] = 0.f;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A TMA map of the row-major [rows, d] f32 table at base, in boxes of
// [box_rows][kLdk]: a box lands in a slot as it is, with the slot's row
// stride; reads past the table are zeros.
cudaError_t encode_rows(CUtensorMap* map, const float* base, int rows, int d, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                    cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kLdk), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;

// Launch the kernel of shape S on `a` (the tables a.u and a.e, the SM count
// sms of device dev) on `stream`, the build with or without TMA.
template <class S, bool TMA>
cudaError_t launch_as(Args a, int dev, int sms, cudaStream_t stream) {
  a.n_item_tiles = (a.I + S::kItems - 1) / S::kItems;
  const int user_tiles = (a.B + kUsers - 1) / kUsers;
  a.n_units = user_tiles * a.n_item_tiles;
  const size_t smem = kStages * (S::kSlotFloats * sizeof(float) + sizeof(uint64_t));
  // once a device (and shared-memory size): the attributes, and the blocks
  // resident at once
  static size_t smem_of[kMaxDevices];
  static int slots_of[kMaxDevices];
  cudaError_t err;
  if (smem_of[dev] != smem) {
    err = cudaFuncSetAttribute(rank_count_kernel<S, TMA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(rank_count_kernel<S, TMA>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rank_count_kernel<S, TMA>,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots_of[dev] = sms * per_sm;
    smem_of[dev] = smem;
  }
  const int slots = slots_of[dev];
  const int rounds = (a.n_units + slots - 1) / slots;  // units the longest run takes
  const int grid = (a.n_units + rounds - 1) / rounds;
  CUtensorMap tm_e{}, tm_u{};  // unread without TMA
  if (TMA) {
    err = encode_rows(&tm_e, a.e, a.I, a.d, S::kItems);
    if (err != cudaSuccess) return err;
    err = encode_rows(&tm_u, a.u, a.B, a.d, kUsers);
    if (err != cudaSuccess) return err;
  }
  rank_count_kernel<S, TMA><<<grid, kThreads, smem, stream>>>(a, tm_e, tm_u);
  return cudaGetLastError();
}

// launch_as with TMA where both tables can be tensor maps (a.tma), else with
// 4-byte copies.
template <class S>
cudaError_t launch(const Args& a, int dev, int sms, cudaStream_t stream) {
  return a.tma ? launch_as<S, true>(a, dev, sms, stream) : launch_as<S, false>(a, dev, sms, stream);
}

}  // namespace

// Adds the counts into `out` (int32 [B], zeroed by the caller) on `stream`:
// the table e is rows id_base .. id_base + I - 1 of the catalog, and `gt`
// holds global ids. `bias` and `gt` may be null. Returns the cudaError_t of
// the launch.
extern "C" int acf_rank_count_shard(const float* u, const float* e,
                                    const float* bias, const float* thresh,
                                    const int* gt, int* out, int B, int I, int d,
                                    int id_base, void* stream) {
  if (B <= 0 || I <= 0 || d < 0 || id_base < 0) return (int)cudaErrorInvalidValue;
  static int sms_of[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (sms_of[dev] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int sms = sms_of[dev];
  // d = 0: one slice of zeros, so the scores are the biases
  const int n_slices = d > 0 ? (d + kSliceK - 1) / kSliceK : 1;
  const bool tma = d > 0 && d % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(e) % 16 == 0;
  const Args a{u, e, bias, thresh, gt, out, B, I, d, 0, 0, n_slices, id_base, tma};
  const auto s = static_cast<cudaStream_t>(stream);
  // wide units where there are enough of them to give every SM one
  const long long wide_units = static_cast<long long>((B + kUsers - 1) / kUsers) *
                               ((I + Wide::kItems - 1) / Wide::kItems);
  return (int)(wide_units >= sms ? launch<Wide>(a, dev, sms, s)
                                 : launch<Narrow>(a, dev, sms, s));
}

// The whole catalog: acf_rank_count_shard with id_base 0.
extern "C" int acf_rank_count(const float* u, const float* e,
                              const float* bias, const float* thresh,
                              const int* gt, int* out, int B, int I, int d,
                              void* stream) {
  return acf_rank_count_shard(u, e, bias, thresh, gt, out, B, I, d, 0, stream);
}
