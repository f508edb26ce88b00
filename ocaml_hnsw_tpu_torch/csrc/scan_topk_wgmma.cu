// K3's `wgmma` path: a warp-specialised scan-and-select block for Hopper.
// The function, what bounds it and the design: the note at the top of
// csrc/scan_topk.cu.  In short:
//   * 128 (WGS + 1) threads: consumer warpgroups 0 .. WGS - 1 own 64
//     queries each (the M of wgmma): WGS = 2, or 1 where two warpgroups'
//     lists and query tiles pass shared memory (kcap 256, wide rows);
//     warp 4 WGS is the producer, the other three warps of its warpgroup
//     write the tiles' side data.
//   * Rows come in items of 64 rows x 128 bytes (8 KB, one wgmma B tile
//     per k-step of 32 bytes), through a ring of `stages` items with a
//     full and an empty mbarrier each.  TMA brings them (128-byte swizzle,
//     zero fill past the row's end and past N).  Rows TMA refuses (a
//     stride or base off 16 bytes) are copied by the producer's lanes with
//     cp.async into the same swizzled layout.  Each tile's side data
//     (each row's bias: ‖x‖² or 0, +inf at a tombstone, past N and, for
//     the norm-free metrics, at j >= n; its int8 scale) comes through a
//     ring of its own, kSideSlots slots with a full and an empty mbarrier
//     each, written by three side warps, each a tile in turn from the
//     flat's norms, tombstones and scales, so three tiles' loads are in
//     flight.
//   * A consumer warpgroup issues wgmma.mma_async m64n64k16 (bf16 -> f32)
//     or m64n64k32 (s8 -> s32) on its query tile (shared memory, loaded
//     once) and the ring's items of a tile; once they are done it releases
//     the items (one arrival per consumer warp) and runs the tile's
//     epilogue while the other warpgroup's products (WGS = 2) use the
//     tensor cores.
//   * The epilogue turns the accumulators into scores in registers and
//     compares them with the two thresholds each thread holds in
//     registers.  A score below its threshold joins its thread's queue
//     for that query: kQueue (score, id) in registers, filled by register
//     moves, with no shared memory and no atomic, so a tile with
//     candidates costs a few instructions per candidate.  The warp
//     flushes only when a score finds its queue full, and on the split's
//     last tile: the four lanes of a query take their slots in its
//     buffer by a prefix sum of their counts (shuffles), and only a buffer
//     that would overflow is merged first (merge_rank, in registers),
//     after which each queued entry is held against the lowered threshold.
//     A query's 64 scores of a tile lie in one warp (wgmma's accumulator
//     layout), so flushes and merges synchronise that warp alone
//     (__syncwarp): they stall its own warpgroup (through wgmma's aligned
//     issue) and nothing else.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "scan_topk.cuh"

namespace scan_topk {
namespace {

constexpr int kQW = 64;               // queries per consumer warpgroup
constexpr int kRT = 64;               // rows per tile (wgmma N)
constexpr int kItem = kRT * kChunk;   // bytes of one ring item
constexpr int kMaxStages = 16;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// (score, id) a consumer thread queues in registers per query before its
// warp flushes them to the buffers: 4 timed best at lists of 32, 128 and
// 256 (2 and 8 slower; PERF.md §6).  Four lanes share a query, so a
// 16-entry buffer takes their queues once merged
constexpr int kQueue = 4;
// a wait on an mbarrier longer than this is a fault of the kernel: trap
// (an error at the next synchronise) rather than hang the card
constexpr unsigned long long kWaitLimitNs = 2000000000ull;

// Side warps in a producer warpgroup, each writing every kSideWarps-th
// tile's side data, and the side ring's slots (each side warp owns two)
constexpr int kSideWarps = 3;
constexpr int kSideSlots = 2 * kSideWarps;

// Byte offsets of the block's shared memory (the wrapper's block_smem is
// `total`): the ring's items, the wgs warpgroups' query tiles (both
// 1024-byte aligned for the 128-byte swizzle), the side ring's slots, the
// ring's full and empty barriers, then the side ring's, the lists and
// buffers.
struct Layout {
  int ring, qa, side, bars, sbars, lists, total;
};

__host__ __device__ inline Layout layout(int stages, int nchunks, int kcap,
                                         int buf, bool int8, int wgs) {
  Layout l;
  l.ring = 0;
  l.qa = stages * kItem;
  l.side = l.qa + wgs * nchunks * kItem;
  l.bars = l.side + kSideSlots * kRT * 4 * (int8 ? 2 : 1);
  l.sbars = l.bars + 2 * stages * 8;
  l.lists = l.sbars + 2 * kSideSlots * 8;
  l.total = l.lists + wgs * kQW * (kcap + buf) * 8;
  return l;
}

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer() - t0 > kWaitLimitNs) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// an arrival when this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the 128 threads of consumer warpgroup `wg` (barrier 0 is __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// A wgmma shared-memory operand: 64 rows x 128 bytes in 8-row groups of
// 1024 bytes (the stride), 128-byte swizzle, K-major.  Adding 2 steps it
// 32 bytes along K inside the swizzle atom.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// the accumulators as the compiler sees them pinned after a wait (or an
// issue): nothing reads or moves them across this point
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WG_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OPS(c)                                                           \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),  \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),   \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]), \
      c(d[29]), c(d[30]), c(d[31])
#define WG_F(x) "+f"(x)
#define WG_R(x) "+r"(x)

// D (64 x 64) += (or =, scale_d 0) A (64 x 16 bf16) . B (64 x 16 bf16)^T
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OPS(WG_F)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, s32) += (or =) A (64 x 32 s8) . B (64 x 32 s8)^T
__device__ __forceinline__ void mma(int (&d)[32], uint64_t a, uint64_t b,
                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WG_D32
      ", %32, %33, p;\n}\n"
      : WG_OPS(WG_R)
      : "l"(a), "l"(b), "r"(scale_d));
}

// ---------------------------------------------------------------- roles
// The producer (one warp): per item, wait for its slot to be free, then
// fill it (TMA, or cp.async by every lane).
__device__ __forceinline__ void produce(const CUtensorMap& map, const Args& a,
                                        uint8_t* smem, const Layout& L,
                                        int nchunks) {
  const int lane = threadIdx.x & 31;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + L.bars, empty0 = full0 + 8 * a.stages;
  const int split0 = blockIdx.y * a.split_rows;
  const int split_end = min(a.N, split0 + a.split_rows);
  const int nitems = (split_end - split0 + kRT - 1) / kRT * nchunks;
  int s = 0, t = 0, c = 0;
  uint32_t phase = 0;
  for (int i = 0; i < nitems; ++i) {
    mbar_wait(empty0 + 8 * s, phase ^ 1);
    const uint32_t full = full0 + 8 * s;
    const int row0 = split0 + t * kRT;
    if (a.tma) {
      if (lane == 0) {
        mbar_arrive_expect_tx(full, kItem);
        tma_load(base + L.ring + s * kItem, &map, full, c * kChunk, row0);
      }
    } else {
      // the row bytes of chunk c (a multiple of vec) of rows [row0, N),
      // `upr` copies a row, `per` rows a pass; the zero padding past the
      // row's end was written when the ring was cleared and stays
      const int valid = min(kChunk, a.row_bytes - c * kChunk);
      if (valid > 0) {
        const int upr = valid / a.vec, per = 32 / upr;
        const int r0 = lane / upr, col = (lane - r0 * upr) * a.vec;
        const int rows = min(kRT, a.N - row0);
        uint8_t* st = smem + L.ring + s * kItem;
        const uint8_t* src = a.rows +
                             static_cast<long long>(row0) * a.row_bytes +
                             c * kChunk + col;
        if (r0 < per)
          for (int r = r0; r < rows; r += per)
            cp_async(st + r * kChunk + (((col >> 4) ^ (r & 7)) << 4) +
                         (col & 15),
                     src + static_cast<long long>(r) * a.row_bytes, a.vec);
      }
      cp_async_arrive(full);
      if (lane == 0) mbar_arrive(full);
    }
    if (++c == nchunks) c = 0, ++t;
    if (++s == a.stages) s = 0, phase ^= 1;
  }
}

// Side warp `sw`: for tiles sw, sw + kSideWarps, ...: lane l reads rows l
// and l + 32 of the tile from the flat (their loads in flight while the
// other side warps wait), turns them into the bias of score = bias - coef
// · dot (‖x‖² for l2, else 0; +inf at a tombstone, past N and, for the
// norm-free metrics, at j >= n) and the int8 scale, waits for the tile's
// side slot (t mod kSideSlots, this warp's own) to be free, writes them
// there and arrives on its full barrier.
template <bool kInt8>
__device__ __forceinline__ void side_warp(const Args& a, uint8_t* smem,
                                          const Layout& L, int side_bytes,
                                          int sw) {
  const int lane = threadIdx.x & 31;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + L.sbars, empty0 = full0 + 8 * kSideSlots;
  const int split0 = blockIdx.y * a.split_rows;
  const int split_end = min(a.N, split0 + a.split_rows);
  const int ntiles = (split_end - split0 + kRT - 1) / kRT;
  const int n_live = a.mask_n ? *a.n_live : a.N;
  for (int t = sw; t < ntiles; t += kSideWarps) {
    float sb[2], ss[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = split0 + t * kRT + lane + 32 * h;
      sb[h] = __uint_as_float(kInfBits);
      ss[h] = 1.f;
      if (j < split_end) {
        const bool out = a.deleted[j] || j >= n_live;
        const float nrm = a.l2 ? a.norms[j] : 0.f;
        if (!out) sb[h] = nrm;
        if (kInt8) ss[h] = a.scales[j];
      }
    }
    const int s = t % kSideSlots;
    mbar_wait(empty0 + 8 * s, ((t / kSideSlots) & 1) ^ 1);
    float* side = reinterpret_cast<float*>(smem + L.side + s * side_bytes);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      side[lane + 32 * h] = sb[h];
      if (kInt8) side[kRT + lane + 32 * h] = ss[h];
    }
    __syncwarp();  // every lane's writes before the arrival
    if (lane == 0) mbar_arrive(full0 + 8 * s);
  }
}

// v[x] for a thread's own index x < 32, by a tree of selects: an index
// into registers that is not a constant would put v in local memory
__device__ __forceinline__ float pick(const float (&v)[32], int x) {
  float a[16], b[8], c[4], d[2];
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = (x & 1) ? v[2 * i + 1] : v[2 * i];
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = (x & 2) ? a[2 * i + 1] : a[2 * i];
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = (x & 4) ? b[2 * i + 1] : b[2 * i];
#pragma unroll
  for (int i = 0; i < 2; ++i) d[i] = (x & 8) ? c[2 * i + 1] : c[2 * i];
  return (x & 16) ? d[1] : d[0];
}

template <bool kInt8, bool kBound, int BUF, int WGS>
__device__ __forceinline__ void consume(const Args& a, uint8_t* smem,
                                        const Layout& L, int nchunks,
                                        int side_bytes) {
  // a query's buffer, once merged, takes what its four lanes' queues hold
  static_assert(4 * kQueue <= BUF, "queues deeper than a quarter buffer");
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr unsigned kAll = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(kAll, tid >> 5, 0);  // warp-uniform
  const int wg = warp >> 2, q4 = lane & 3, rq = lane >> 2;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + L.bars, empty0 = full0 + 8 * a.stages;
  const uint32_t sfull0 = base + L.sbars;  // the side ring's barriers
  const int split0 = blockIdx.y * a.split_rows;
  const int split_end = min(a.N, split0 + a.split_rows);
  const int ntiles = (split_end - split0 + kRT - 1) / kRT;
  const int q0 = blockIdx.x * WGS * kQW;
  const int lrow0 = wg * kQW + (warp & 3) * 16;  // this warp's 16 queries
  const int lstride = a.kcap + BUF;
  uint2* lists = reinterpret_cast<uint2*>(smem + L.lists);

  // empty lists
  const uint2 empty = make_uint2(kInfBits, 0xffffffffu);
  const int kshift = __ffs(a.kcap) - 1;
  for (int u = lane; u < 16 * a.kcap; u += 32)
    lists[(lrow0 + (u >> kshift)) * lstride + (u & (a.kcap - 1))] = empty;
  // this warpgroup's query tile, each 128-byte chunk as TMA's 128-byte
  // swizzle lays it out (rows past B zero)
  uint8_t* qa = smem + L.qa + wg * nchunks * kItem;
  const int units = a.dp_bytes / 16;
  for (int u = tid & 127; u < kQW * units; u += 128) {
    const int r = u / units, v = u - r * units;
    const int b = q0 + wg * kQW + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (b < a.B)
      val = *reinterpret_cast<const uint4*>(
          a.q + static_cast<long long>(b) * a.dp_bytes + v * 16);
    *reinterpret_cast<uint4*>(qa + (v >> 3) * kItem + r * kChunk +
                              (((v & 7) ^ (r & 7)) << 4)) = val;
  }
  fence_proxy_async();
  warpgroup_sync(wg);

  // this thread's two queries (h = 0, 1: rows rq and rq + 8 of its
  // warp's 16): thresholds (score, id; -inf for a query past B, so none
  // of its scores is kept; the id 0 while the score is +inf, so +inf
  // never enters), int8 scales, page bounds
  bool in[2];
  float th[2], qsc[2], lbs[2];
  uint32_t thi[2];
  int lbi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = q0 + lrow0 + rq + 8 * h;
    in[h] = b < a.B;
    th[h] = __uint_as_float(in[h] ? kInfBits : 0xff800000u);
    thi[h] = 0;
    qsc[h] = kInt8 && in[h] ? a.qs[b] : 1.f;
    if constexpr (kBound) {
      lbs[h] = in[h] ? a.lb_s[b] : __uint_as_float(0xff800000u);
      lbi[h] = in[h] ? a.lb_i[b] : -1;
    }
  }
  const float coef = a.l2 ? 2.f : 1.f;

  auto read_thresholds = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint2 e = lists[(lrow0 + rq + 8 * h) * lstride + a.K - 1];
      if (in[h]) {
        th[h] = __uint_as_float(e.x);
        thi[h] = e.x == kInfBits ? 0 : e.y;
      }
    }
  };
  // (s, j) before query h's threshold in (score, id) order
  auto before_th = [&](float s, uint32_t j, int h) {
    return s < th[h] || (s == th[h] && j < thi[h]);
  };

  // The candidate path.  Each thread queues, per query, up to kQueue
  // (score, id) in registers (qs_, qi_: slot 0 the newest, qn_ of them
  // held); the buffer behind a query holds bc_ entries, a count its four
  // lanes share.
  float qs_[2][kQueue];
  uint32_t qi_[2][kQueue];
  int qn_[2] = {0, 0}, bc_[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int s = 0; s < kQueue; ++s) {
      qs_[h][s] = __uint_as_float(kInfBits);
      qi_[h][s] = 0;
    }
  // the buffer of each query whose flag fh is set merged into its list:
  // query h of lanes 4 r8 .. 4 r8 + 3 (row r8 + 8 h of the warp's 16) is
  // bit 4 r8 + h of the ballot.  One call site of merge_rank: the block's
  // code stays small enough for the instruction cache.
  auto merge_flagged = [&](bool f0, bool f1) {
    for (uint32_t m = __ballot_sync(kAll, q4 == 0 ? f0 : q4 == 1 && f1); m;
         m &= m - 1) {
      const int r8 = (__ffs(m) - 1) >> 2, h = (__ffs(m) - 1) & 1;
      const int c = __shfl_sync(kAll, h ? bc_[1] : bc_[0], 4 * r8);
      merge_rank(lists + (lrow0 + r8 + 8 * h) * lstride, a.kcap, c, lane);
      if (rq == r8) {
        if (h) bc_[1] = 0;
        else bc_[0] = 0;
      }
    }
  };
  // The warp empties every queue into its query's buffer: the four lanes
  // of a query take their slots by a prefix sum of their counts.  A buffer
  // that would overflow is merged first; the thresholds then fall, and
  // each queued entry goes on only if it is before its query's new one.
  auto flush = [&]() {
    uint32_t keep[2];  // bit s: slot s of the queue goes to the buffer
    int pre[2], tot[2];
    auto count = [&]() {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = __popc(keep[h]);
        int v = n, u = __shfl_up_sync(kAll, v, 1, 4);
        if (q4 >= 1) v += u;
        u = __shfl_up_sync(kAll, v, 2, 4);
        if (q4 >= 2) v += u;
        pre[h] = v - n;
        tot[h] = __shfl_sync(kAll, v, 3, 4);
      }
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) keep[h] = (1u << qn_[h]) - 1;
    count();
    const bool over0 = bc_[0] + tot[0] > BUF, over1 = bc_[1] + tot[1] > BUF;
    if (__any_sync(kAll, over0 || over1)) {
      merge_flagged(over0, over1);
      read_thresholds();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int s = 0; s < kQueue; ++s)
          if (!before_th(qs_[h][s], qi_[h][s], h)) keep[h] &= ~(1u << s);
      count();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint2* dst = lists + (lrow0 + rq + 8 * h) * lstride + a.kcap +
                   bc_[h] + pre[h];
#pragma unroll
      for (int s = 0; s < kQueue; ++s)
        if ((keep[h] >> s) & 1)
          *dst++ = make_uint2(__float_as_uint(qs_[h][s]), qi_[h][s]);
      bc_[h] += tot[h];
      qn_[h] = 0;
    }
    __syncwarp();  // the buffers written before any merge reads them
  };
  // The scores of pend (bit x: sv[x]) join their queries' queues while
  // there is room, by register moves; what finds none stays in pend.
  auto enqueue = [&](const float(&sv)[32], uint32_t& pend, int jt) {
    for (uint32_t p = pend; p; p &= p - 1) {
      const int x = __ffs(p) - 1, h = (x >> 1) & 1;
      if ((h ? qn_[1] : qn_[0]) == kQueue) continue;
      const float s = pick(sv, x);
      const uint32_t j = jt + 8 * (x >> 2) + (x & 1);
#pragma unroll
      for (int g = 0; g < 2; ++g)
        if (g == h) {
#pragma unroll
          for (int i = kQueue - 1; i > 0; --i) {
            qs_[g][i] = qs_[g][i - 1];
            qi_[g][i] = qi_[g][i - 1];
          }
          qs_[g][0] = s;
          qi_[g][0] = j;
          ++qn_[g];
        }
      pend &= ~(1u << x);
    }
  };
  // tile t's scores against the thresholds; those below join the queues,
  // and the warp flushes only while some score finds its queue full, and
  // on the split's last tile until every queue is empty.
  // acc[x], sv[x]: query h = (x >> 1) & 1, column 8 (x >> 2) + 2 q4 +
  // (x & 1).  The scores go to registers of their own: read in divergent
  // code, the accumulators would make ptxas put warpgroup-wide waits there.
  auto epilogue = [&](const Acc(&acc)[32], const float(&bias)[16],
                      const float(&rsc)[16], int t) {
    const bool last = t == ntiles - 1;
    const int jt = split0 + t * kRT + 2 * q4;
    float sv[32];
    float mn0 = __uint_as_float(kInfBits), mn1 = mn0;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int jj = 2 * (x >> 2) + (x & 1), h = (x >> 1) & 1;
      if constexpr (kInt8) {
        const float d = __fmul_rn(__int2float_rn(acc[x]),
                                  __fmul_rn(qsc[h], rsc[jj]));
        sv[x] = __fsub_rn(bias[jj], __fmul_rn(coef, d));
      } else {
        sv[x] = __fmaf_rn(-coef, acc[x], bias[jj]);  // coef * acc exact
      }
      if (h) mn1 = fminf(mn1, sv[x]);
      else mn0 = fminf(mn0, sv[x]);
    }
    if (!__any_sync(kAll, mn0 < th[0] || mn1 < th[1] ||
                          (last && qn_[0] + qn_[1] > 0)))
      return;
    // pend: the scores below the thresholds as the tile started (and
    // after the page's bound).  A strict compare is exact here: the
    // threshold's entry comes from an earlier tile, so a score equal to it
    // has the higher id.  A score that waits for a flush is then checked
    // against the threshold as the flush left it, in (score, id) order (an
    // entry that merges past K is dropped there anyway).
    uint32_t pend = 0;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int h = (x >> 1) & 1;
      bool in_ = sv[x] < th[h];
      if constexpr (kBound) {
        const int j = jt + 8 * (x >> 2) + (x & 1);
        in_ = in_ && (sv[x] > lbs[h] || (sv[x] == lbs[h] && j > lbi[h]));
      }
      pend |= static_cast<uint32_t>(in_) << x;
    }
    while (true) {
      enqueue(sv, pend, jt);
      if (!__any_sync(kAll, pend != 0 || (last && qn_[0] + qn_[1] > 0)))
        break;
      flush();
      uint32_t still = 0;
#pragma unroll
      for (int x = 0; x < 32; ++x)
        still |= static_cast<uint32_t>(
                     ((pend >> x) & 1) &&
                     before_th(sv[x], jt + 8 * (x >> 2) + (x & 1),
                               (x >> 1) & 1))
                 << x;
      pend = still;
    }
  };

  // the ring as this warpgroup reads it: `rs` the next item to wait for
  // (round parity rphase), `fs` the next to release
  const uint32_t qa_addr = base + L.qa + wg * nchunks * kItem;
  int rs = 0, fs = 0;
  uint32_t rphase = 0;
  Acc acc[32];
  float bias[16], rsc[16];
  // Each tile: wait for its items and issue their products (the first
  // k-step overwrites acc); then wait for the products and for the tile's
  // side data, read it, release the items and the side slot (each warp's
  // arrival) and run the epilogue, while the other warpgroup's products
  // use the tensor cores.
  for (int t = 0; t < ntiles; ++t) {
    wgmma_fence();
    for (int c = 0; c < nchunks; ++c) {
      mbar_wait(full0 + 8 * rs, rphase);
      __syncwarp();  // the lanes leave the spin apart; wgmma is .aligned
      if (!a.tma) fence_proxy_async();  // cp.async's writes, wgmma's reads
      const int ks = min(kChunk, a.dp_bytes - c * kChunk) / kStep;
      const uint64_t da = desc(qa_addr + c * kItem);
      const uint64_t db = desc(base + L.ring + rs * kItem);
      for (int k = 0; k < ks; ++k)
        mma(acc, da + 2 * k, db + 2 * k, (c | k) != 0);
      if (++rs == a.stages) rs = 0, rphase ^= 1;
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    const int sl = t % kSideSlots;
    mbar_wait(sfull0 + 8 * sl, (t / kSideSlots) & 1);
    __syncwarp();
    const float* side =
        reinterpret_cast<const float*>(smem + L.side + sl * side_bytes);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(side + 8 * j + 2 * q4);
      bias[2 * j] = bv.x;
      bias[2 * j + 1] = bv.y;
      if constexpr (kInt8) {
        const float2 sv =
            *reinterpret_cast<const float2*>(side + kRT + 8 * j + 2 * q4);
        rsc[2 * j] = sv.x;
        rsc[2 * j + 1] = sv.y;
      }
    }
    __syncwarp();  // every lane's reads of the items done before release
    for (int c = 0; c < nchunks; ++c) {
      if (lane == 0) mbar_arrive(empty0 + 8 * fs);
      if (++fs == a.stages) fs = 0;
    }
    if (lane == 0) mbar_arrive(sfull0 + 8 * (kSideSlots + sl));
    epilogue(acc, bias, rsc, t);
  }

  // every buffer in (the last tile emptied the queues), then this warp's
  // 16 lists out
  merge_flagged(bc_[0] > 0, bc_[1] > 0);
  for (int r = 0; r < 16; ++r) {
    const int row = lrow0 + r, b = q0 + row;
    if (b >= a.B) break;
    for (int i = lane; i < a.K; i += 32) {
      const uint2 e = lists[row * lstride + i];
      const long long o =
          (static_cast<long long>(b) * a.S + blockIdx.y) * a.K + i;
      a.out_s[o] = __uint_as_float(e.x);
      a.out_i[o] = static_cast<int>(e.y);
    }
  }
}

template <bool kInt8, bool kBound, int BUF, int WGS>
__global__ void __launch_bounds__(128 * (WGS + 1), 1)
    scan_topk_wgmma(const __grid_constant__ CUtensorMap map, const Args a) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int nchunks = (a.dp_bytes + kChunk - 1) / kChunk;
  const int side_bytes = kRT * 4 * (kInt8 ? 2 : 1);
  const Layout L = layout(a.stages, nchunks, a.kcap, BUF, kInt8, WGS);
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();  // the 128-byte swizzle needs 1024 bytes
  // the role as a value ptxas can see is warp-uniform: wgmma under a
  // branch it takes for divergent is serialized (C7520)
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (tid == 0) {
    // full: the producer's one arrival (with the item's bytes), or, under
    // cp.async, its 32 lanes' too; empty: each consumer warp.  The side
    // ring's: its side warp's; each consumer warp
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(base + L.bars + 8 * s, a.tma ? 1 : 33);
      mbar_init(base + L.bars + 8 * (a.stages + s), 4 * WGS);
    }
    for (int s = 0; s < kSideSlots; ++s) {
      mbar_init(base + L.sbars + 8 * s, 1);
      mbar_init(base + L.sbars + 8 * (kSideSlots + s), 4 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (!a.tma) {
    // cp.async writes only a row's bytes: the padding past them is zero
    // from here on, as TMA's fill makes it
    for (int u = tid; u < a.stages * kItem / 16; u += blockDim.x)
      reinterpret_cast<uint4*>(smem + L.ring)[u] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  __syncthreads();  // every barrier set before any arrival
  // two consumer warpgroups take registers from the producer's
  // (setmaxnreg); one has all it needs at launch
  if (warp >= 4 * WGS) {
    if constexpr (WGS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == 4 * WGS)
      produce(map, a, smem, L, nchunks);
    else
      side_warp<kInt8>(a, smem, L, side_bytes, warp - 4 * WGS - 1);
  } else {
    if constexpr (WGS == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consume<kInt8, kBound, BUF, WGS>(a, smem, L, nchunks, side_bytes);
  }
}

// ---------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

template <bool kInt8, bool kBound, int BUF, int WGS>
int run(int op, const Args& a, int smem_bytes, cudaStream_t stream,
        int* per_sm) {
  constexpr int kThreads = 128 * (WGS + 1);
  auto kernel = scan_topk_wgmma<kInt8, kBound, BUF, WGS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // setmaxnreg moves registers within what the launch gave the block: a
  // kernel compiled to fewer would wait on them forever
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (WGS == 2 && attr.numRegs * kThreads <
                      kConsumerRegs * 128 * WGS + kProducerRegs * 128)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (op == 1)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, kThreads, smem_bytes));
  const int nchunks = (a.dp_bytes + kChunk - 1) / kChunk;
  if (layout(a.stages, nchunks, a.kcap, BUF, kInt8, WGS).total > smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  memset(&map, 0, sizeof map);
  if (a.tma) {
    EncodeTiled encode;
    err = encoder(&encode);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the rows as bytes [N, row_bytes]; a box is 128 bytes of 64 rows
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.row_bytes),
                                static_cast<cuuint64_t>(a.N)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.row_bytes)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunk),
                               static_cast<cuuint32_t>(kRT)};
    const cuuint32_t estrides[2] = {1, 1};
    const CUresult r = encode(
        &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
        const_cast<uint8_t*>(a.rows), dims, strides, box, estrides,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kErrTensorMap + static_cast<int>(r);
  }
  const dim3 grid((a.B + WGS * kQW - 1) / (WGS * kQW), a.S);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt8, bool kBound>
int run_block(int op, int buf, int qt, const Args& a, int smem_bytes,
              cudaStream_t stream, int* per_sm) {
  if (qt == 2 * kQW && buf == 32)
    return run<kInt8, kBound, 32, 2>(op, a, smem_bytes, stream, per_sm);
  if (qt == 2 * kQW && buf == 16)
    return run<kInt8, kBound, 16, 2>(op, a, smem_bytes, stream, per_sm);
  if (qt == kQW && buf == 32)
    return run<kInt8, kBound, 32, 1>(op, a, smem_bytes, stream, per_sm);
  if (qt == kQW && buf == 16)
    return run<kInt8, kBound, 16, 1>(op, a, smem_bytes, stream, per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int wgmma_dispatch(int op, int dtype, bool bound, int buf, int qt,
                   const Args& a, int smem_bytes, cudaStream_t stream,
                   int* per_sm) {
  if (op == 0) {
    // a warpgroup holds a tile's items until its products are done
    const int nchunks = (a.dp_bytes + kChunk - 1) / kChunk;
    if (a.split_rows % kRT || a.stages < 2 || a.stages < nchunks ||
        a.stages > kMaxStages ||
        (a.tma && (a.row_bytes % 16 ||
                   reinterpret_cast<uintptr_t>(a.rows) % 16)) ||
        (!a.tma && a.vec != 16 && a.vec != 8 && a.vec != 4))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0)
    return bound ? run_block<false, true>(op, buf, qt, a, smem_bytes, stream,
                                          per_sm)
                 : run_block<false, false>(op, buf, qt, a, smem_bytes, stream,
                                           per_sm);
  if (dtype == 1)
    return bound ? run_block<true, true>(op, buf, qt, a, smem_bytes, stream,
                                         per_sm)
                 : run_block<true, false>(op, buf, qt, a, smem_bytes, stream,
                                          per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace scan_topk
