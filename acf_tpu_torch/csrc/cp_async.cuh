// What every kernel of csrc/ uses to stage tiles in shared memory: the
// cp.async copies (device memory -> shared memory, asynchronous, grouped and
// waited for by group) and the row stride of a staged [rows][ld] f32 tile.
#pragma once

#include <cuda_runtime.h>

// Row stride of a shared tile of d floats a row: an odd number of 16-byte
// units, so the float4 reads of 8 neighbouring rows fall in 8 distinct bank
// groups.
__host__ __device__ constexpr inline int row_ld(int d) { return 4 * ((d / 4) | 1); }

// 16 bytes from src to dst.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(saddr), "l"(src));
}

// 16 bytes from src to dst, or 16 zero bytes where !valid (src is not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_bytes = valid ? 16 : 0;  // 0: zero-fill the destination
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(saddr), "l"(src), "r"(src_bytes));
}

// A copy of kBytes (16 or 4) of which only the first src_bytes are read (the
// rest zero-filled).
template <int kBytes>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, int src_bytes) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(saddr), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(saddr), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}
