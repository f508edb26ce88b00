// What K3's two kernels share (csrc/scan_topk.cu, the `sync` path, and
// csrc/scan_topk_wgmma.cu, the `wgmma` path): the launch's arguments, the
// (score, id) order and the merge of a query's buffer into its sorted
// list.  The design of each path: the note at the top of
// csrc/scan_topk.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan_topk {

constexpr int kChunk = 128;      // row bytes per ring item (both paths)
constexpr int kStep = 32;        // row bytes per tensor-core k-step
constexpr int kMaxKcap = 256;    // K_MAX in the wrapper
constexpr uint32_t kInfBits = 0x7f800000u;

struct Args {
  const uint8_t* rows;     // [N, row_bytes]: bf16 or int8 rows
  const float* scales;     // [N] (int8 rows)
  const float* norms;      // [N] (l2)
  const uint8_t* deleted;  // [N] bool
  const int* n_live;       // the occupied count n (device scalar)
  const uint8_t* q;        // [B, dp_bytes] queries, zero-padded
  const float* qs;         // [B] int8 query scales
  const float* lb_s;       // [B] the page's bound (score, id), or null
  const int* lb_i;
  float* out_s;            // [B, S, K]
  int* out_i;              // [B, S, K]
  int B, N, row_bytes, dp_bytes, K, kcap, split_rows, S, l2, mask_n, vec,
      stages, tma;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async(uint8_t* dst, const uint8_t* src,
                                         int bytes) {
  const uint32_t d = smem_u32(dst);
  switch (bytes) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                   "l"(src)
                   : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d),
                   "l"(src)
                   : "memory");
      break;
    default:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                   "l"(src)
                   : "memory");
  }
}

// (score, id) order: score, then id as unsigned (the empty entry, id -1
// with score +inf, sorts last)
__device__ __forceinline__ bool before(uint2 x, uint2 y) {
  const float sx = __uint_as_float(x.x), sy = __uint_as_float(y.x);
  return sx < sy || (sx == sy && x.y < y.y);
}

// One warp merges a query's buffer (its first c <= 32 entries, right after
// the list) into its sorted list of kcap (32..256) entries, in registers:
// each buffer entry's place is its rank in the list (a binary search) plus
// its rank in the buffer; the list's entries keep their order and fill
// the other places, so place s takes list entry s - (buffer entries placed
// before s), counted from a bitmask of the buffer's places per 32 places
// (one __reduce_or_sync each).  Places past kcap drop out.  (score, id)
// keys are distinct, so the places are.
__device__ __forceinline__ void merge_rank(uint2* list, int kcap, int c,
                                           int lane) {
  const uint2 empty = make_uint2(kInfBits, 0xffffffffu);
  const uint2 b = lane < c ? list[kcap + lane] : empty;
  int lo = 0, hi = kcap;  // list entries before b: [0, lo)
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(list[mid], b)) lo = mid + 1;
    else hi = mid;
  }
  int rb = 0;  // buffer entries before b
#pragma unroll 4
  for (int i = 0; i < c; ++i) {
    const uint2 o = make_uint2(__shfl_sync(0xffffffffu, b.x, i),
                               __shfl_sync(0xffffffffu, b.y, i));
    rb += before(o, b);
  }
  const int at = lane < c ? lo + rb : kcap;  // b's place
  constexpr int kMaxPer = kMaxKcap / 32;
  const int per = kcap >> 5;
  uint2 keep[kMaxPer];
  int src[kMaxPer];  // the list entry that lands on place lane + 32 m
  int placed = 0;    // buffer entries placed before this 32-place window
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {
    src[m] = -1;
    if (m < per) {
      const uint32_t mask = __reduce_or_sync(
          0xffffffffu, at >> 5 == m ? 1u << (at & 31) : 0u);
      if (!((mask >> lane) & 1)) {
        src[m] = lane + 32 * m - placed - __popc(mask & ((1u << lane) - 1));
        keep[m] = list[src[m]];
      }
      placed += __popc(mask);
    }
  }
  __syncwarp();  // every read of the list done
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m)
    if (src[m] >= 0) list[lane + 32 * m] = keep[m];
  if (at < kcap) list[at] = b;
  __syncwarp();
}

// The wgmma path (csrc/scan_topk_wgmma.cu).  op 0: launch (the tensor map
// over the rows encoded here when a.tma); op 1: blocks per SM into
// *per_sm.  buf: buffer entries per query (16 or 32); qt: queries per
// block (128: two consumer warpgroups, 64: one).  Returns a cudaError_t,
// or kErrTensorMap + the CUresult of a refused tensor map.
constexpr int kErrTensorMap = 100000;
int wgmma_dispatch(int op, int dtype, bool bound, int buf, int qt,
                   const Args& a, int smem_bytes, cudaStream_t stream,
                   int* per_sm);

}  // namespace scan_topk
