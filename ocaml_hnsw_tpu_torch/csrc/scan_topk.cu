// Scan-and-select kernel (K3): for each query, the rerank_k lowest scan
// scores over every row of the flat index and their ids, in one pass.
//
// Replaces what the JAX package runs on the TPU for the flat scan
// (ocaml_hnsw_tpu/models/flat.py:170-200): the bf16 (or int8) MXU
// dot_general fused by XLA with jax.lax.approx_min_k, which the TPU runs as
// a hardware PartialReduce inside the score stream, so the [B, N] score
// block never reaches memory.  It is not a Pallas kernel: the JAX package's
// own Pallas block-min scan lost to that fusion and was deleted
// (ocaml_hnsw_tpu/ops/pallas/__init__.py:6-14).
//
// What it computes (ops/kernels/scan_topk.py::scan_topk_plain is the same
// function in plain torch):
//   dot[b, j]  = bf16 q[b] . bf16 x[j] summed in f32, or for int8 rows
//                (f32)(int32 q8[b] . x8[j]) * (qs[b] * scales[j]);
//   score      = norms[j] - 2 dot (l2), or -dot (ip, cosine);
//   +inf where deleted[j], and for the norm-free metrics where j >= n;
// and per query the rerank_k lowest (score, id) in (score, id) order
// (ties to the lower id) that come after the query's bound (lb_s, lb_i)
// in that order, when one is given: the wrapper serves a rerank_k above
// kMaxKcap in pages, each bounded by the last entry of the page before.
// The order is exact because each block walks its rows in increasing id:
// a score equal to the threshold when its tile starts has a higher id than
// the threshold's entry, so the first compare may be strict.  Each block
// writes its split's list, [B, S, rerank_k] (score, id); the wrapper merges
// the S lists (one top-k over S·rerank_k per query).
//
// What bounds it on an H100: the product, 2·B·N·D operations at 989
// TFLOP/s (bf16) or 1,979 TOP/s (int8), against the distinct bytes (N
// rows, their norms, scales and tombstones, B queries, B·rerank_k results)
// at 3.35 TB/s: at B = 8192 the product is ~120x the bytes' time (the kNN
// table's 8192 x 1M x 128: 2.13 ms against 0.08 ms).  Second, the rows'
// trips from L2 to the SMs: a row tile fetched for Q queries costs N·D
// bytes of L2 traffic per Q queries, and at Q = 64 (the sync block's kNN
// plan) the 32 GB it moves take ~4.7 ms at the ~6.8 TB/s L2 gave on an
// H100, twice the product's bound; the wgmma block fetches a tile for 128
// queries (a model of the bytes: no L2 counter was read).  Measured per block
// (bench/k3_timeline.py), the wgmma block spends its time in its epilogue,
// the compares and appends of a warp whose 16 queries hold a score below
// their threshold in ~45% of the kNN block's tiles, which its warpgroup
// waits for at the next tile's collective wgmma (PERF.md §6).
//
// Two paths, chosen by shape (launch_plan, never after an error):
//
// wgmma (csrc/scan_topk_wgmma.cu): every shape whose block fits.
//   * Roles: 384 threads.  Consumer warpgroups 0 and 1 own 64 queries each
//     (wgmma's M); one producer warp keeps the ring full.  The producer's
//     warpgroup lowers its registers (setmaxnreg 40), the consumers raise
//     theirs (232).  Where two warpgroups' lists and query tiles pass
//     shared memory (kcap 256, the pages of a rerank_k over 256; rows of
//     768 bytes and more), the block has one consumer warpgroup (64
//     queries, 256 threads) and no ping-pong.
//   * The product: wgmma.mma_async m64n64k16 .f32.bf16.bf16 or m64n64k32
//     .s32.s8.s8, A (the warpgroup's 64 queries) from shared memory,
//     loaded once per block, B (a 64-row tile) from the ring, both K-major
//     with the 128-byte swizzle.
//   * The ring: items of 64 rows x 128 bytes, a full and an empty mbarrier
//     each.  TMA (cp.async.bulk.tensor.2d over a [N, row_bytes] byte map,
//     encoded per launch through cudaGetDriverEntryPoint, passed as a
//     __grid_constant__ CUtensorMap) brings them; its zero fill covers the
//     ragged last tile and D's padding to a 32-byte k-step.  Rows TMA
//     refuses (a stride or base not a multiple of 16 bytes: D1's 200-byte
//     glove rows) are copied by the producer's 32 lanes with cp.async (16,
//     8 or 4 bytes) into the same swizzled layout; they arrive on the same
//     full barrier (cp.async.mbarrier.arrive.noinc), so a consumer does
//     not know which producer filled an item.  Each tile's side data (its
//     bias: ‖x‖² or 0, +inf at a tombstone, past N and, for the norm-free
//     metrics, at j >= n; int8 row scales) is read from the flat by the
//     producer warpgroup's other three warps, a tile each in turn, and
//     comes to the consumers through a ring of its own (6 slots, a full
//     and an empty mbarrier each): read by the producer warp itself, the
//     loads' latency held the ring back (D2's batch 67.85 -> 87.95 ms on
//     an H100).  (A cluster of two
//     blocks sharing each fetch by TMA multicast, 256 queries per fetch,
//     was slower at the main shapes: PERF.md §6.)
//   * Merges local to their warp: the epilogue makes each score in
//     registers from the accumulators, compares it with its query's
//     threshold, held in registers (each thread has two queries), and
//     appends those below to the query's buffer of 16 or 32 entries in
//     shared memory (one shared atomic per lane and query for the slots);
//     a full buffer is merged into the query's sorted list in registers
//     (merge_rank: each entry's place is its rank in the list, by binary
//     search, plus its rank in the other side).  A query's scores of a
//     tile lie in one warp (wgmma's accumulator layout), so a merge
//     synchronises only that warp (__syncwarp; the warpgroup's own named
//     barrier, bar.sync 1 + wg, 128, orders the staging of its query
//     tile): no merge stops the producer or the other warpgroup, and none
//     uses __syncthreads.
//   * Overlap: the two consumer warpgroups ping-pong on the tensor cores;
//     each issues a tile's products (wgmma.commit_group, wait_group 0),
//     releases its items and runs the tile's epilogue while the other's
//     products run.  (A second accumulator set per warpgroup, to issue
//     tile t + 1 before tile t's epilogue, gained nothing: ptxas put
//     warpgroup-wide waits into the epilogue to read the registers.)
//
// sync (this file): the first design's block, for the shapes the wgmma block
// cannot hold: rows copied in 2- or 1-byte units (bf16 D odd, int8 D not a
// multiple of 4) and rows so wide that even a 64-query block's lists, query
// tile and a tile's ring items pass shared memory (D = 768 bf16 at rerank_k
// 33 and more, kcap 256 past 640-byte rows).  A tile of QT queries (16 to
// 128) and a row split, 8 warps of mma.sync (m16n8k16 bf16 or m16n8k32 s8 by
// ldmatrix) in lockstep over a cp.async ring of 128-byte row chunks, the
// same lists, buffers and merges, each merge behind __syncthreads_or.
//
// Where its time goes: PERF.md §6 (NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "scan_topk.cuh"

namespace scan_topk {

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowStride = kChunk + 16;  // a staged row chunk, padded
constexpr int kBuf = 32;                // buffer entries per query
constexpr int kMaxStages = 8;

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most n (0..kMaxStages - 2) of this thread's groups are in
// flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
}

// `bytes` (1..16, a power of two) of zeros at an address aligned to them
__device__ __forceinline__ void zero_bytes(uint8_t* dst, int bytes) {
  switch (bytes) {
    case 16: *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0); break;
    case 8: *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0); break;
    case 4: *reinterpret_cast<uint32_t*>(dst) = 0; break;
    case 2: *reinterpret_cast<uint16_t*>(dst) = 0; break;
    default: *dst = 0;
  }
}

// Warps merge the queries whose buffers hold at least `least` entries
// (kBuf: the full ones; 1: every non-empty one) and set their thresholds
// (score, id; the id 0 while the score is +inf).
template <int QT>
__device__ void merge_queries(uint2* lists, float* thr, uint32_t* thr_id,
                              int* cnt, int kcap, int K, int least, int warp,
                              int lane) {
  for (int r = warp; r < QT; r += kWarps) {
    const int c = cnt[r];
    if (c < least) continue;
    uint2* list = lists + (kcap + kBuf) * r;
    merge_rank(list, kcap, min(c, kBuf), lane);
    if (lane == 0) {
      cnt[r] = 0;
      thr[r] = __uint_as_float(list[K - 1].x);
      thr_id[r] = list[K - 1].x == kInfBits ? 0 : list[K - 1].y;
    }
  }
}

// Stage the 128-byte chunk `c` of rows [row0, min(row0 + RT, row_end)):
// cp.async where the rows allow it, plain loads for 2- and 1-byte units,
// zeros past the row's end up to the padded width.
template <int RT>
__device__ __forceinline__ void load_chunk(const Args& a, uint8_t* st,
                                           int row0, int row_end, int c) {
  const int off = c * kChunk;
  const int len = min(kChunk, a.dp_bytes - off);
  const int valid = max(0, min(kChunk, a.row_bytes - off));
  const int v = a.vec;
  const int rows = min(RT, row_end - row0);
  if (v == 16 && valid == kChunk) {  // whole 16-byte units: shifts only
    const uint8_t* src = a.rows + static_cast<long long>(row0) * a.row_bytes +
                         off + (threadIdx.x & 7) * 16;
    for (int r = threadIdx.x >> 3; r < rows; r += kThreads / 8)
      cp_async(st + r * kRowStride + (threadIdx.x & 7) * 16,
               src + static_cast<long long>(r) * a.row_bytes, 16);
    return;
  }
  const int per_row = len / v;
  for (int u = threadIdx.x; u < rows * per_row; u += kThreads) {
    const int r = u / per_row;
    const int col = (u - r * per_row) * v;
    uint8_t* dst = st + r * kRowStride + col;
    if (col >= valid) {
      zero_bytes(dst, v);
      continue;
    }
    const uint8_t* src =
        a.rows + static_cast<long long>(row0 + r) * a.row_bytes + off + col;
    if (v >= 4)
      cp_async(dst, src, v);
    else if (v == 2)
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
    else
      *dst = *src;
  }
}

// The sync path.  QT queries per block; a warp owns (16 MT) queries x 32
// rows: WM x WN warps cover the QT x RT tile.  kBound: the launch has a page
// bound (an instance of its own: the bound's check in the epilogue slows the
// unbounded launches by 7-10% on an H100).
template <int QT, bool kInt8, bool kBound>
__global__ void __launch_bounds__(kThreads, 1)
    scan_topk_kernel(const Args a) {
  constexpr int MT = QT >= 32 ? 2 : 1;
  constexpr int WM = QT / (16 * MT);
  constexpr int WN = kWarps / WM;
  constexpr int RT = 32 * WN;
  using Acc = typename std::conditional<kInt8, int, float>::type;

  extern __shared__ __align__(16) uint8_t smem[];
  const int qstride = a.dp_bytes + 16;
  uint8_t* s_q = smem;
  uint8_t* s_rows = s_q + QT * qstride;
  uint2* s_list =
      reinterpret_cast<uint2*>(s_rows + a.stages * RT * kRowStride);
  float* s_thr = reinterpret_cast<float*>(s_list + (a.kcap + kBuf) * QT);
  uint32_t* s_thr_id = reinterpret_cast<uint32_t*>(s_thr + QT);
  int* s_cnt = reinterpret_cast<int*>(s_thr_id + QT);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp - wm * WN;
  const int q0 = blockIdx.x * QT;
  const int split0 = blockIdx.y * a.split_rows;
  const int split_end = min(a.N, split0 + a.split_rows);
  const int nchunks = (a.dp_bytes + kChunk - 1) / kChunk;
  const int ntiles = max(0, (split_end - split0 + RT - 1) / RT);
  const int nitems = ntiles * nchunks;
  const int n_live = a.mask_n ? *a.n_live : 0;

  // empty lists, no threshold
  const uint2 empty = make_uint2(kInfBits, 0xffffffffu);
  for (int u = tid; u < QT * a.kcap; u += kThreads) {
    const int r = u / a.kcap;
    s_list[(a.kcap + kBuf) * r + (u - r * a.kcap)] = empty;
  }
  // a query past B gets threshold -inf: none of its scores is ever kept;
  // the threshold's id is 0 while its score is infinite, so a score of
  // +inf never enters
  for (int r = tid; r < QT; r += kThreads) {
    s_thr[r] = __uint_as_float(q0 + r < a.B ? kInfBits : 0xff800000u);
    s_thr_id[r] = 0;
    s_cnt[r] = 0;
  }

  // the query tile (rows past B stay unwritten: their scores are never
  // kept), in the first group with the first ring stage
  const int qvec = a.dp_bytes / 16;
  for (int u = tid; u < QT * qvec; u += kThreads) {
    const int r = u / qvec;
    const int col = (u - r * qvec) * 16;
    if (q0 + r < a.B)
      cp_async(s_q + r * qstride + col,
               a.q + static_cast<long long>(q0 + r) * a.dp_bytes + col, 16);
  }
  // the ring is filled item by item (an item: chunk ld_c of row tile ld_t)
  int ld_item = 0, ld_t = 0, ld_c = 0, ld_slot = 0;
  auto issue_next = [&]() {
    if (ld_item < nitems)
      load_chunk<RT>(a, s_rows + ld_slot * RT * kRowStride, split0 + ld_t * RT,
                     split_end, ld_c);
    ++ld_item;
    if (++ld_c == nchunks) ld_c = 0, ++ld_t;
    if (++ld_slot == a.stages) ld_slot = 0;
  };
  for (int s = 0; s < a.stages - 1; ++s) {
    issue_next();
    cp_async_commit();
  }

  // this thread's query rows (mt, h), their int8 scales and bounds (a
  // query past B: (-inf, -1), before every entry)
  int qrow[MT][2], lbi[MT][2];
  float qscale[MT][2], lbs[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qrow[mt][h] = wm * 16 * MT + mt * 16 + (lane >> 2) + 8 * h;
      const bool in = q0 + qrow[mt][h] < a.B;
      qscale[mt][h] = kInt8 && in ? a.qs[q0 + qrow[mt][h]] : 1.f;
      if constexpr (kBound) {
        lbs[mt][h] = in ? a.lb_s[q0 + qrow[mt][h]]
                        : __uint_as_float(0xff800000u);
        lbi[mt][h] = in ? a.lb_i[q0 + qrow[mt][h]] : -1;
      }
    }
  // score = bias - coef * dot: bias = ‖x‖² and coef = 2 for l2, bias = 0
  // and coef = 1 for ip and cosine (0 - dot is -dot), bias = +inf where
  // the row is out: +inf is never below a threshold
  const float coef = a.l2 ? 2.f : 1.f;

  Acc acc[MT][4][4];
  // the rows this thread scores in the current tile: norms (l2), int8
  // scales, tombstones, loaded as the tile starts so that they arrive
  // under its products
  float nrm[4][2], rsc[4][2];
  uint8_t del[4][2];
  int t = 0, c = 0, slot = 0;  // the item being read: chunk c of tile t
  for (int it = 0; it < nitems; ++it) {
    cp_async_wait(a.stages - 2);
    __syncthreads();
    issue_next();
    cp_async_commit();
    const int jt = split0 + t * RT + wn * 32 + 2 * (lane & 3);
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
      // every load unconditional (a row past the split reads the last
      // one; it is masked below), so all are in flight at once
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = min(jt + nt * 8 + e, split_end - 1);
          del[nt][e] = a.deleted[j];
          nrm[nt][e] = a.l2 ? a.norms[j] : 0.f;
          rsc[nt][e] = kInt8 ? a.scales[j] : 1.f;
        }
    }
    const uint8_t* st = s_rows + slot * RT * kRowStride;
    const int ksteps = min(kChunk, a.dp_bytes - c * kChunk) / kStep;
    // fragments of k-step ks + 1 load while ks's products issue
    uint32_t af[2][MT][4], bfr[2][4][2];
    const uint8_t* qa =
        s_q + (wm * 16 * MT + (lane & 15)) * qstride + c * kChunk +
        (lane >> 4) * 16;
    const uint8_t* ra =
        st + (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * kRowStride +
        ((lane >> 3) & 1) * 16;
    auto fragments = [&](int ks, uint32_t(&fa)[MT][4], uint32_t(&fb)[4][2]) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(smem_u32(qa + mt * 16 * qstride + ks * kStep), fa[mt][0],
                    fa[mt][1], fa[mt][2], fa[mt][3]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(smem_u32(ra + np * 16 * kRowStride + ks * kStep),
                    fb[2 * np][0], fb[2 * np][1], fb[2 * np + 1][0],
                    fb[2 * np + 1][1]);
    };
    fragments(0, af[0], bfr[0]);
#pragma unroll
    for (int ks = 0; ks < kChunk / kStep; ++ks) {
      if (ks >= ksteps) break;
      if (ks + 1 < ksteps)
        fragments(ks + 1, af[(ks + 1) & 1], bfr[(ks + 1) & 1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma(acc[mt][nt], af[ks & 1][mt], bfr[ks & 1][nt]);
    }
    if (c == nchunks - 1) {
      // ---- epilogue of row tile t: scores, threshold, buffers
      float bias[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jt + nt * 8 + e;
          const bool out = j >= split_end || del[nt][e] ||
                           (a.mask_n && j >= n_live);
          bias[nt][e] = out ? __uint_as_float(kInfBits) : nrm[nt][e];
        }
      // this thread's queries' thresholds (score, id), in registers for
      // the checks below, read again after each merge
      float th[MT][2];
      uint32_t th_id[MT][2];
      auto read_thresholds = [&]() {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            th[mt][h] = s_thr[qrow[mt][h]];
            th_id[mt][h] = s_thr_id[qrow[mt][h]];
          }
      };
      read_thresholds();
      float sv[MT][4][4];
      uint32_t pend = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float d;
              if constexpr (kInt8)
                d = __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + e]),
                              __fmul_rn(qscale[mt][h], rsc[nt][e]));
              else
                d = acc[mt][nt][2 * h + e];
              const float sc = __fsub_rn(bias[nt][e], __fmul_rn(coef, d));
              sv[mt][nt][2 * h + e] = sc;
              if (sc < th[mt][h])
                pend |= 1u << ((mt * 4 + nt) * 4 + 2 * h + e);
            }
        }
      while (true) {
        if (pend) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const uint32_t bit = 1u << ((mt * 4 + nt) * 4 + x);
                if (!(pend & bit)) continue;
                const int h = x >> 1, r = qrow[mt][h];
                const float sc = sv[mt][nt][x];
                const int j = jt + nt * 8 + (x & 1);
                // in: before the threshold's (score, id), after the bound
                bool in = sc < th[mt][h] ||
                          (sc == th[mt][h] &&
                           static_cast<uint32_t>(j) < th_id[mt][h]);
                if constexpr (kBound)
                  in = in && (sc > lbs[mt][h] ||
                              (sc == lbs[mt][h] && j > lbi[mt][h]));
                if (!in) {
                  pend &= ~bit;
                  continue;
                }
                const int pos = atomicAdd(&s_cnt[r], 1);
                if (pos < kBuf) {
                  s_list[(a.kcap + kBuf) * r + a.kcap + pos] =
                      make_uint2(__float_as_uint(sc), static_cast<uint32_t>(j));
                  pend &= ~bit;
                }
              }
        }
        if (!__syncthreads_or(pend != 0)) break;
        merge_queries<QT>(s_list, s_thr, s_thr_id, s_cnt, a.kcap, a.K, kBuf,
                          warp, lane);
        __syncthreads();
        read_thresholds();
      }
    }
    if (++slot == a.stages) slot = 0;
    if (++c == nchunks) c = 0, ++t;
  }
  cp_async_wait(0);
  __syncthreads();
  merge_queries<QT>(s_list, s_thr, s_thr_id, s_cnt, a.kcap, a.K, 1, warp,
                    lane);
  __syncthreads();
  for (int u = tid; u < QT * a.K; u += kThreads) {
    const int r = u / a.K, i = u - r * a.K;
    if (q0 + r >= a.B) continue;
    const uint2 e = s_list[(a.kcap + kBuf) * r + i];
    const long long o =
        (static_cast<long long>(q0 + r) * a.S + blockIdx.y) * a.K + i;
    a.out_s[o] = __uint_as_float(e.x);
    a.out_i[o] = static_cast<int>(e.y);
  }
}

// The kernel of (QT, kInt8, kBound), with `smem_bytes` of dynamic shared
// memory allowed for it.
template <int QT, bool kInt8, bool kBound>
auto prepared(int smem_bytes, cudaError_t* err) {
  auto kernel = scan_topk_kernel<QT, kInt8, kBound>;
  *err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  return kernel;
}

// op 0: launch; op 1: blocks per SM into *per_sm.
template <int QT, bool kInt8, bool kBound>
int run(int op, const Args& a, int smem_bytes, cudaStream_t stream,
        int* per_sm) {
  cudaError_t err;
  auto kernel = prepared<QT, kInt8, kBound>(smem_bytes, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op == 1)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, kThreads, smem_bytes));
  const dim3 grid((a.B + QT - 1) / QT, a.S);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt8, bool kBound>
int run_qt(int op, int qt, const Args& a, int smem_bytes, cudaStream_t stream,
           int* per_sm) {
  switch (qt) {
    case 16: return run<16, kInt8, kBound>(op, a, smem_bytes, stream, per_sm);
    case 32: return run<32, kInt8, kBound>(op, a, smem_bytes, stream, per_sm);
    case 64: return run<64, kInt8, kBound>(op, a, smem_bytes, stream, per_sm);
    case 128:
      return run<128, kInt8, kBound>(op, a, smem_bytes, stream, per_sm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(int op, int dtype, int qt, bool bound, const Args& a,
             int smem_bytes, cudaStream_t stream, int* per_sm) {
  if (dtype == 0)
    return bound ? run_qt<false, true>(op, qt, a, smem_bytes, stream, per_sm)
                 : run_qt<false, false>(op, qt, a, smem_bytes, stream, per_sm);
  if (dtype == 1)
    return bound ? run_qt<true, true>(op, qt, a, smem_bytes, stream, per_sm)
                 : run_qt<true, false>(op, qt, a, smem_bytes, stream, per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

}  // namespace scan_topk

using scan_topk::Args;

// dtype 0 = bf16 rows and queries, 1 = int8 (with scales and qs); lb_s,
// lb_i: each query's bound
// (f32, int32 [B]; null for none): only entries after it in (score, id)
// order are kept; K = rerank_k <= kcap (a power of two, 32..256); path: 0
// sync, 1 wgmma; qt: queries per block (sync: 16, 32, 64, 128; wgmma:
// 64 or 128); buf: buffer entries per query (sync: 32; wgmma: 16 or 32);
// split_rows: rows per split (a multiple of the row tile), S splits cover
// N; l2: 1 for norms - 2 dot, 0 for -dot; mask_n: +inf at j >= *n_live;
// vec: bytes per row copy (16, 8, 4 by cp.async, 2 or 1 by plain loads:
// sync only); stages: ring stages (sync 2..8, wgmma 2..16); tma: the
// wgmma producer loads by TMA (else cp.async); smem_bytes: the block's
// dynamic shared memory
// (ops/kernels/scan_topk.py::launch_plan).  Returns cudaGetLastError()
// after the launch, or a refusal (scan_topk::kErrTensorMap + CUresult for
// a tensor map the driver refuses).
extern "C" int ohnsw_scan_topk(const void* rows, int dtype, const void* scales,
                               const void* norms, const void* deleted,
                               const void* n_live, const void* q,
                               const void* qs,
                               const void* lb_s, const void* lb_i,
                               void* out_s, void* out_i, int B, int N,
                               int row_bytes, int dp_bytes, int K, int kcap,
                               int path, int qt, int buf, int split_rows,
                               int S, int l2, int mask_n, int vec, int stages,
                               int tma, int smem_bytes,
                               void* stream) {
  using scan_topk::kMaxKcap;
  using scan_topk::kStep;
  if (B == 0 || N == 0) return 0;
  if (K < 1 || K > kcap || kcap < 32 || kcap > kMaxKcap ||
      (kcap & (kcap - 1)) || dp_bytes % kStep || row_bytes > dp_bytes ||
      row_bytes % vec || split_rows < 1 ||
      static_cast<long long>(split_rows) * S < N || S > 65535 ||
      (lb_s == nullptr) != (lb_i == nullptr) ||
      (vec != 16 && vec != 8 && vec != 4 && vec != 2 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint8_t*>(rows),
               static_cast<const float*>(scales),
               static_cast<const float*>(norms),
               static_cast<const uint8_t*>(deleted),
               static_cast<const int*>(n_live),
               static_cast<const uint8_t*>(q),
               static_cast<const float*>(qs),
               static_cast<const float*>(lb_s),
               static_cast<const int*>(lb_i),
               static_cast<float*>(out_s),
               static_cast<int*>(out_i),
               B, N, row_bytes, dp_bytes, K, kcap, split_rows, S, l2, mask_n,
               vec, stages, tma};
  const auto st = static_cast<cudaStream_t>(stream);
  if (path == 1)
    return scan_topk::wgmma_dispatch(0, dtype, lb_s != nullptr, buf, qt, a,
                                     smem_bytes, st, nullptr);
  if (path != 0 || buf != 32 || stages < 2 || stages > 8 || tma)
    return static_cast<int>(cudaErrorInvalidValue);
  return scan_topk::dispatch(0, dtype, qt, lb_s != nullptr, a, smem_bytes,
                             st, nullptr);
}

// Blocks of the (path, dtype, qt, bound, buf) instance with smem_bytes of
// dynamic shared memory that one SM of the current device holds at once,
// into *per_sm (cudaOccupancyMaxActiveBlocksPerMultiprocessor, as the
// launch sets it up).
extern "C" int ohnsw_scan_topk_occupancy(int path, int dtype, int qt,
                                         int bound, int buf, int smem_bytes,
                                         int* per_sm) {
  if (path == 1)
    return scan_topk::wgmma_dispatch(1, dtype, bound != 0, buf, qt, Args{},
                                     smem_bytes, nullptr, per_sm);
  return scan_topk::dispatch(1, dtype, qt, bound != 0, Args{}, smem_bytes,
                             nullptr, per_sm);
}
