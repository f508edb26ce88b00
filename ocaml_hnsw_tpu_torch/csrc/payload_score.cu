// Packed-score kernel (K1): one beam iteration's candidate scoring in the
// packed inline-int8 engine.
//
// Replaces the TPU kernel ocaml_hnsw_tpu/ops/pallas/payload_score.py::
// payload_score and fuses what the JAX engine does inline in its place
// (ocaml_hnsw_tpu/models/packed.py, _beam_body): the meta-row gather
// (neighbour ids + their int32 norms), the fetch of each expanded node's
// [deg, d_pad] int8 neighbour slab, the dot with the int8 query, and the
// distance epilogue
//     l2:        s^2 * (|x8|^2 - 2 dot) + |q|^2
//     ip/cosine: 1 - s^2 * dot
// with id -1 and distance +inf where the node is -1 or the slot is empty.
//
// The dot is exact: __dp4a accumulates int8 x int8 in int32 (the TPU engine
// rounded each product to bf16).  The epilogue uses __fmul_rn/__fadd_rn so the
// compiler cannot contract it into an FMA: the result is bit-identical to the
// plain torch version in ops/kernels/payload_score.py.
//
// Two variants, as the JAX engine's options (models/packed.py):
//   - slots (deg_limit): only the first `slots` rows of each node's slab are
//     scored.  They are a prefix of the slab, so the bulk copy just shrinks
//     to slots * d_pad bytes; the meta row still comes whole (ids at [0,
//     slots), norms at [deg, deg + slots)).  Output [B, E * slots].
//   - kBits = 4: each slab row is d_pad bytes of nibble pairs (low nibble the
//     even component, high the odd one) and the query row is bf16 q/s of
//     2 * d_pad components.  The tensor cores take the dot (mma.sync
//     m16n8k16, bf16 in, f32 sum): each nibble becomes an exact bf16 (one
//     LOP3 puts the bits of 128 + (n + 8) in place for two nibbles, then 136
//     is subtracted in bf16, exact), each product nibble x query is exact,
//     and only the order and rounding of the f32 sum differ from the plain
//     version's (far inside chip_smoke.py's k1_int4_bound).  The epilogue
//     is the same, with the dot an f32 instead of an int.
//
// What bounds it on an H100: memory, as gathers of whole slabs.  At the
// main-path shape (B = 4096 or 8192 queries, E = 2 expanded nodes, deg = 32,
// d_pad = 128) each (query, node) item reads a 4 KB slab and a 256 B meta row
// from random addresses, and does 2 int ops per byte: far below the card's
// ridge point, so the bound is bytes / 3.35 TB/s, and reaching it takes a
// few MB in flight across the card (Little's law).  What a call cannot
// avoid besides: a near-empty launch timed the same way takes ~5 us on the
// card (PERF.md), and the node ids are one dependent load before any slab
// can be asked for.
//
// The design, a bulk-copy slab ring private to each warp: as many warps as
// fit are resident, and each walks a contiguous range of (query, node)
// items.  It loads its node ids and its queries' norms 32 at a time (one
// coalesced load each, the next group's in flight) and arms items ahead:
// for each, one lane issues bulk copies (cp.async.bulk, the TMA's linear
// mode: one instruction per contiguous run, the hardware makes the
// addresses) of the slab prefix and the meta row into a shared-memory
// stage, as soon as the node id is known; nothing waits on the meta
// contents.  The E consecutive items of a query share its query row: the
// first of them in the warp's range also copies the row into one of the
// warp's `query_slots` query slots (counted on its own stage's mbarrier),
// the others read it there, so an item costs two copies, not three.  When
// an item's mbarrier completes the warp scores it from shared memory:
//   - bits 8, slots > 16: lane j scores row j with __dp4a, reading 16-byte
//     chunk (c + j) mod (d_pad / 16) at step c, so the 8 lanes of a
//     quarter-warp hit 8 different bank groups instead of one;
//   - bits 8, slots <= 16: two lanes per row, each half of the rotated
//     chunks, joined by one __shfl_xor (int32: exact in any order), so no
//     lane idles through the dot;
//   - bits 4: the tensor cores, rows in 16-row tiles, each thread a fixed
//     16-byte chunk of its two rows and the matching 64 bytes of the query
//     (all eight columns of B hold the query, so every thread's first
//     accumulator is its row's dot), then a shuffle brings row j's dot to
//     lane j for the epilogue.
//
// A warp keeps one item armed ahead of the one it scores.  Its ring's
// depth (`stages`) comes from the wrapper's launch plan (ops/kernels/
// payload_score.py::launch_plan): with two stages the next item is armed as
// soon as the current one lands, so one item streams while one is scored;
// with one (a slab too large for two), the stage is re-armed after its item
// is scored.  A per-warp timeline of the earlier two-stage ring, which armed
// both stages at once and re-armed after scoring (bench/k1_timeline.py on
// the card, PERF.md), showed why arming more loses, however few items a
// warp has: every copy in flight shares the memory's rate, so copies armed
// together land together, ~4 us after they are issued, and a warp scored
// nothing until its whole share was in; at bits 4, whose scoring kept the
// SM's schedulers busy for ~2 us per item, all of that came after the last
// byte.  Racing 1-4 stages with 1 .. stages items armed ahead at every K1
// row found one ahead as fast as any shape (PERF.md).  The stage size
// follows deg * d_pad, so a 24 KB slab (d_pad = 768) still fits.
//
// Why a ring per warp and not one per block fed by a producer warp: on the
// card, one producer thread issuing every item of a block serialised the
// copies (a timeline of the block showed the ring still being armed long
// after the first slabs had landed); with every warp its own producer the
// copies are issued in parallel, and no warp ever waits on another (no
// "stage empty" barriers).
//
// Every stage a warp arms is consumed before the warp exits: an item whose
// node is < 0 arms its stage with a plain arrive (or with its query row
// alone, when later items of the same query need it), so no mbarrier waits
// on a copy never issued; a stage is re-armed only after its item was
// scored and the warp synchronised, so a warp never runs ahead of its own
// barriers by more than one phase, whatever `stages` (up to 32) is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

constexpr int kMaxWarps = 4;   // per block
constexpr int kMinBlocks = 8;  // per SM, that registers must allow (64
                               // registers): at 72, F4's 2 KB slabs ran 28
                               // warps per SM, and some armed a third item
                               // only after scoring the first
constexpr unsigned kFull = 0xffffffffu;

struct Ring {  // one warp's stages and query slots, and their sources
  const int8_t* pay;
  const int* meta;
  const unsigned char* q;  // int8 [B, d_pad] or bf16 [B, 2 d_pad]
  unsigned char* stage0;   // the warp's first stage
  unsigned char* qslot0;   // the warp's first query slot
  uint64_t* full;          // the warp's stage mbarriers
  int q0;                  // the query of the warp's first item
  int off;                 // that item's place among its query's E items
  int deg, d_pad, slots, q_bytes, E, meta_in_ring, stages, stage_bytes,
      query_slots;
};

// Where the warp's item k stands among the queries: `run`, its query's
// ordinal within the warp's range; `pos`, its place among that query's E
// items; `slot`, its query slot (run mod query_slots: enough for every
// query that the items in flight and the one being scored belong to, the
// launch plan's rule).  32-bit divisions once, then `next` steps it.
struct Pos {
  int run, pos, slot;
  __device__ __forceinline__ Pos(const Ring& r, int k)
      : run((r.off + k) / r.E),
        pos((r.off + k) % r.E),
        slot(run % r.query_slots) {}
  __device__ __forceinline__ void next(const Ring& r) {
    if (++pos == r.E) {
      pos = 0;
      ++run;
      if (++slot == r.query_slots) slot = 0;
    }
  }
};

__device__ __forceinline__ unsigned char* query_slot(const Ring& r,
                                                     const Pos& p) {
  return r.qslot0 + static_cast<size_t>(p.slot) * r.q_bytes;
}

// Arms stage s with item j's copies (p: item j's Pos); one lane calls it.
// The first item of a query in the warp's range also brings the query row.
__device__ __forceinline__ void arm(const Ring& r, int s, int j, int node,
                                    const Pos& p) {
  const int q_bytes = j == 0 || p.pos == 0 ? r.q_bytes : 0;
  if (node < 0 && q_bytes == 0) {
    mbar_arrive(&r.full[s]);  // nothing to fetch
    return;
  }
  const int slab_bytes = node < 0 ? 0 : r.slots * r.d_pad;  // slab prefix
  const int meta_bytes = node >= 0 && r.meta_in_ring ? 8 * r.deg : 0;
  unsigned char* st = r.stage0 + static_cast<size_t>(s) * r.stage_bytes;
  mbar_arrive_expect_tx(&r.full[s], slab_bytes + meta_bytes + q_bytes);
  if (slab_bytes)
    bulk_load(st, r.pay + static_cast<size_t>(node) * r.deg * r.d_pad,
              slab_bytes, &r.full[s]);
  if (meta_bytes)
    bulk_load(st + slab_bytes, r.meta + static_cast<size_t>(node) * 2 * r.deg,
              meta_bytes, &r.full[s]);
  if (q_bytes)
    bulk_load(query_slot(r, p),
              r.q + static_cast<size_t>(r.q0 + p.run) * r.q_bytes, q_bytes,
              &r.full[s]);
}

// Exact int32 dot of n 16-byte chunks of an int8 slab row with the int8
// query row: chunk (first + c) mod nvec at step c (module comment).
template <int kNvec>
__device__ __forceinline__ int dot_int8(const int4* row, const int4* qv,
                                        int first, int n, int nvec) {
  int acc = 0;
  if (kNvec > 0) {
#pragma unroll
    for (int c = 0; c < kNvec; ++c) {
      if (c < n) {
        const int cc = (first + c) % kNvec;  // rotated: no bank conflicts
        const int4 x = row[cc];
        const int4 y = qv[cc];
        acc = __dp4a(x.x, y.x, acc);
        acc = __dp4a(x.y, y.y, acc);
        acc = __dp4a(x.z, y.z, acc);
        acc = __dp4a(x.w, y.w, acc);
      }
    }
  } else {
    int cc = first % nvec;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const int4 x = row[cc];
      const int4 y = qv[cc];
      acc = __dp4a(x.x, y.x, acc);
      acc = __dp4a(x.y, y.y, acc);
      acc = __dp4a(x.z, y.z, acc);
      acc = __dp4a(x.w, y.w, acc);
      cc = cc + 1 == nvec ? 0 : cc + 1;
    }
  }
  return acc;
}

// bf16x2 (a - 136, b - 136) of a bf16x2 (a, b): exact for the values
// 128 ... 143 it is given.
__device__ __forceinline__ uint32_t bf16x2_minus_136(uint32_t v) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(v), "r"(0x43084308u));
  return d;
}

// bf16x2 (n_s, n_{s+4}) of the signed nibbles s and s + 4 of w (bits 4s
// and 4s + 16): masked, biased to n + 8 and given bf16 128's bits in one
// LOP3 ((v & 0x000f000f) ^ 0x43084308: 0x4300 | (n + 8) is 128 + n + 8),
// then 136 comes off.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, int s) {
  uint32_t v;
  asm("lop3.b32 %0, %1, 0x000f000f, 0x43084308, 0x6a;"
      : "=r"(v)
      : "r"(w >> (4 * s)));
  return bf16x2_minus_136(v);
}

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// f32 dots of rows r0 + g, r0 + g + 8 (tile 0) and, with kTwo, r0 + 16 + g,
// r0 + 24 + g (tile 1) of a nibble slab with the bf16 query row, by the
// tensor cores (g = lane / 4, tig = lane % 4).  Thread (g, tig) takes
// 16-byte chunk 4kb + tig of its rows for each block kb of 64 row bytes
// (chunks past d_pad count as zero) and the 64 query bytes of the same
// components.  An m16n8k16 MMA takes 8 k-pairs, a thread holding pairs tig
// and tig + 4: a chunk word's nibbles (0, 4) and (1, 5) feed one MMA, (2, 6)
// and (3, 7) the next, against the query halves of the same components, so
// a k-pair means the same components in every row.  Rows past `slots` read
// row slots - 1 (their results are dropped).  The tiles' MMA chains
// interleave.  Rows and query come one word at a time, so the kernel keeps
// within its 64 registers: holding a chunk's query words at once spilled
// 116 bytes, and with the shared memory carved out to its most, L1 is too
// small to keep a spill (F3 took 18.4 us instead of 15.0 on an H100).
template <int kNvec, bool kTwo>
__device__ __forceinline__ void dot_int4_rows(const unsigned char* slab,
                                              const uint4* qv, int d_pad,
                                              int nvec, int slots, int r0,
                                              int g, int tig, float d[4]) {
  constexpr int kTiles = kTwo ? 2 : 1;
  const int n = kNvec > 0 ? kNvec : nvec;
  const uint32_t* row[2 * kTiles];
#pragma unroll
  for (int k = 0; k < 2 * kTiles; ++k)
    row[k] = reinterpret_cast<const uint32_t*>(
        slab + min(r0 + 8 * k + g, slots - 1) * d_pad);
  float c[kTiles][4] = {};
  const int blocks = (n + 3) / 4;
  for (int kb = 0; kb < blocks; ++kb) {
    const int ch = 4 * kb + tig;
#pragma unroll
    for (int m = 0; m < 4; ++m) {  // word m of the chunk: two MMAs per tile
      // k-pair s of word m is its components (s, s + 4): the query halves
      const uint4 q = ch < n ? qv[4 * ch + m] : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t b0 = __byte_perm(q.x, q.z, 0x5410);
      const uint32_t b1 = __byte_perm(q.x, q.z, 0x7632);
      const uint32_t b2 = __byte_perm(q.y, q.w, 0x5410);
      const uint32_t b3 = __byte_perm(q.y, q.w, 0x7632);
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        const uint32_t wa = ch < n ? row[2 * t][4 * ch + m] : 0u;
        const uint32_t wb = ch < n ? row[2 * t + 1][4 * ch + m] : 0u;
        mma_bf16(c[t], nibble_pair(wa, 0), nibble_pair(wb, 0),
                 nibble_pair(wa, 1), nibble_pair(wb, 1), b0, b1);
        mma_bf16(c[t], nibble_pair(wa, 2), nibble_pair(wb, 2),
                 nibble_pair(wa, 3), nibble_pair(wb, 3), b2, b3);
      }
    }
  }
  d[0] = c[0][0];
  d[1] = c[0][2];
  d[2] = kTwo ? c[kTiles - 1][0] : 0.0f;
  d[3] = kTwo ? c[kTiles - 1][2] : 0.0f;
}

// kNvec: 16-byte chunks per payload row (d_pad / 16) fixed at compile time,
// or 0 to read it from d_pad.  kBits: 8 (int8 rows, int8 query) or 4
// (nibble rows, bf16 query).
template <int kNvec, int kBits>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
    packed_score_kernel(const int* __restrict__ nodes,
                        const int* __restrict__ meta,
                        const int8_t* __restrict__ pay,
                        const unsigned char* __restrict__ q,
                        const float* __restrict__ qn,
                        const float* __restrict__ scale,
                        int* __restrict__ cand_ids,
                        float* __restrict__ cand_d, int share, int extra,
                        int E, int deg, int d_pad, int slots, int needs_norms,
                        int stages, int stage_bytes, int query_slots,
                        int warp_bytes, int meta_in_ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // this warp's contiguous range of (query, node) items: `share` each, one
  // more for the first `extra` warps
  const int gw = blockIdx.x * warps + warp;
  const int lo = gw * share + min(gw, extra);
  const int count = share + (gw < extra);
  const int q_bytes = kBits == 8 ? d_pad : 4 * d_pad;
  unsigned char* mine = smem + header_bytes(warps * stages) +
                        static_cast<size_t>(warp) * warp_bytes;
  const Ring ring{pay,
                  meta,
                  q,
                  mine,
                  mine + static_cast<size_t>(stages) * stage_bytes,
                  reinterpret_cast<uint64_t*>(smem) + warp * stages,
                  lo / E,
                  lo % E,
                  deg,
                  d_pad,
                  slots,
                  q_bytes,
                  E,
                  meta_in_ring,
                  stages,
                  stage_bytes,
                  query_slots};

  // node ids and query norms of items [32g, 32g + 32) and of the next
  // group, in flight while the mbarriers are set up
  int cur = lane < count ? nodes[lo + lane] : -1;
  int nxt = 32 + lane < count ? nodes[lo + 32 + lane] : -1;
  float qcur = needs_norms && lane < count
                   ? qn[ring.q0 + (ring.off + lane) / E]
                   : 0.0f;
  float qnxt = needs_norms && 32 + lane < count
                   ? qn[ring.q0 + (ring.off + 32 + lane) / E]
                   : 0.0f;
  if (lane < stages) mbar_init(&ring.full[lane], 1);
  mbar_init_fence();
  __syncwarp();
  if (lane == 0 && count > 0) arm(ring, 0, 0, cur, Pos(ring, 0));
  // the item scored next (i) and the item armed next (i + 1: before i is
  // scored with two or more stages, after it with one): their places and
  // stages, and i's parity
  const bool early = stages > 1;
  Pos pi(ring, 0), pj(ring, 1);
  int si = 0, sj = 1 % stages, parity = 0;

  const float s = __ldg(scale);
  const float s2 = __fmul_rn(s, s);
  const float inf = __int_as_float(0x7f800000);
  const int nvec = kNvec > 0 ? kNvec : d_pad / 16;
  const int slab_bytes = slots * d_pad;
  for (int i = 0; i < count; ++i) {
    if (i > 0 && (i & 31) == 0) {
      cur = nxt;
      qcur = qnxt;
      const int k = i + 32 + lane;
      nxt = k < count ? nodes[lo + k] : -1;
      qnxt = needs_norms && k < count ? qn[ring.q0 + (ring.off + k) / E]
                                      : 0.0f;
    }
    const int node = __shfl_sync(kFull, cur, i & 31);
    const float qnb = __shfl_sync(kFull, qcur, i & 31);
    mbar_wait(&ring.full[si], parity);
    // arms item j into the stage item j - stages left (scored, and the
    // warp synchronised since)
    auto rearm = [&](int j) {
      if (j < count) {
        const int nj = __shfl_sync(
            kFull, (j >> 5) == (i >> 5) ? cur : nxt, j & 31);
        if (lane == 0) {
          // order this warp's reads of the stage before the async-proxy
          // write
          async_proxy_fence();
          arm(ring, sj, j, nj, pj);
        }
      }
    };
    if (early) rearm(i + 1);  // in flight while i is scored
    int* oid = cand_ids + static_cast<size_t>(lo + i) * slots;
    float* od = cand_d + static_cast<size_t>(lo + i) * slots;
    if (node < 0) {
      for (int r = lane; r < slots; r += 32) {
        oid[r] = -1;
        od[r] = inf;
      }
    } else {
      const unsigned char* st = ring.stage0 + static_cast<size_t>(si) *
                                                  stage_bytes;
      const int* mrow =
          meta_in_ring ? reinterpret_cast<const int*>(st + slab_bytes)
                       : meta + static_cast<size_t>(node) * 2 * deg;
      const unsigned char* qrow = query_slot(ring, pi);
      if constexpr (kBits == 8) {
        const int4* qv = reinterpret_cast<const int4*>(qrow);
        if (slots <= 16) {  // two lanes per row, half the chunks each
          const int r = lane & 15, h = lane >> 4;
          const int n0 = (nvec + 1) / 2;
          int acc = 0;
          if (r < slots)
            acc = dot_int8<kNvec>(reinterpret_cast<const int4*>(
                                      st + r * d_pad),
                                  qv, r + h * n0, h ? nvec - n0 : n0, nvec);
          acc += __shfl_xor_sync(kFull, acc, 16);
          if (h == 0 && r < slots) {
            const int id = mrow[r];
            float d = inf;
            if (id >= 0) {
              d = needs_norms
                      ? __fadd_rn(__fmul_rn(s2, static_cast<float>(
                                                    mrow[deg + r] - 2 * acc)),
                                  qnb)
                      : __fsub_rn(1.0f, __fmul_rn(s2, static_cast<float>(acc)));
            }
            oid[r] = id < 0 ? -1 : id;
            od[r] = d;
          }
        } else {
          for (int r = lane; r < slots; r += 32) {
            const int id = mrow[r];
            if (id < 0) {
              oid[r] = -1;
              od[r] = inf;
              continue;
            }
            const int acc = dot_int8<kNvec>(
                reinterpret_cast<const int4*>(st + r * d_pad), qv, r, nvec,
                nvec);
            oid[r] = id;
            od[r] = needs_norms
                        ? __fadd_rn(__fmul_rn(s2, static_cast<float>(
                                                      mrow[deg + r] - 2 * acc)),
                                    qnb)
                        : __fsub_rn(1.0f,
                                    __fmul_rn(s2, static_cast<float>(acc)));
          }
        }
      } else {
        const uint4* qv = reinterpret_cast<const uint4*>(qrow);
        const int g = lane >> 2, tig = lane & 3;
        for (int r0 = 0; r0 < slots; r0 += 32) {  // 32 rows: two tiles
          float dt[4];
          if (r0 + 16 < slots)
            dot_int4_rows<kNvec, true>(st, qv, d_pad, nvec, slots, r0, g, tig,
                                       dt);
          else
            dot_int4_rows<kNvec, false>(st, qv, d_pad, nvec, slots, r0, g,
                                        tig, dt);
          // row r0 + lane's dot: dt[lane / 8] of the threads of group
          // lane % 8
          const int src = 4 * (lane & 7);
          const float v0 = __shfl_sync(kFull, dt[0], src);
          const float v1 = __shfl_sync(kFull, dt[1], src);
          const float v2 = __shfl_sync(kFull, dt[2], src);
          const float v3 = __shfl_sync(kFull, dt[3], src);
          const float acc =
              lane < 8 ? v0 : lane < 16 ? v1 : lane < 24 ? v2 : v3;
          const int r = r0 + lane;
          if (r < slots) {
            const int id = mrow[r];
            float d = inf;
            if (id >= 0) {
              d = needs_norms
                      ? __fadd_rn(
                            __fmul_rn(s2,
                                      __fsub_rn(static_cast<float>(
                                                    mrow[deg + r]),
                                                __fmul_rn(2.0f, acc))),
                            qnb)
                      : __fsub_rn(1.0f, __fmul_rn(s2, acc));
            }
            oid[r] = id < 0 ? -1 : id;
            od[r] = d;
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the stage
    if (!early) rearm(i + 1);
    pi.next(ring);
    pj.next(ring);
    if (++si == stages) {
      si = 0;
      parity ^= 1;
    }
    if (++sj == stages) sj = 0;
  }
}

template <typename Kernel>
int blocks_per_sm(Kernel kernel, int warps, int smem_bytes, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        32 * warps, smem_bytes);
  return static_cast<int>(err);
}

struct Launch {
  const void *nodes, *meta, *pay, *q, *qn, *scale;
  void *cand_ids, *cand_d;
  int n_items, E, deg, d_pad, slots, needs_norms, stages, warps, stage_bytes,
      query_slots, warp_bytes, smem_bytes, meta_in_ring;
  cudaStream_t stream;
};

template <int kNvec, int kBits>
int launch(const Launch& a) {
  auto kernel = packed_score_kernel<kNvec, kBits>;
  int dev = 0, sms = 0, per_sm = 0;
  int e = blocks_per_sm(kernel, a.warps, a.smem_bytes, &per_sm);
  if (e) return e;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int resident = sms * per_sm;
  const int need = (a.n_items + a.warps - 1) / a.warps;  // a warp per item
  const int blocks = need < resident ? need : resident;
  const int warps_total = blocks * a.warps;
  kernel<<<blocks, 32 * a.warps, a.smem_bytes, a.stream>>>(
      static_cast<const int*>(a.nodes), static_cast<const int*>(a.meta),
      static_cast<const int8_t*>(a.pay), static_cast<const unsigned char*>(a.q),
      static_cast<const float*>(a.qn), static_cast<const float*>(a.scale),
      static_cast<int*>(a.cand_ids), static_cast<float*>(a.cand_d),
      a.n_items / warps_total, a.n_items % warps_total, a.E, a.deg, a.d_pad,
      a.slots, a.needs_norms, a.stages, a.stage_bytes, a.query_slots,
      a.warp_bytes, a.meta_in_ring);
  return static_cast<int>(cudaGetLastError());
}

template <int kNvec, int kBits>
int occupancy(int warps, int smem_bytes, int* per_sm) {
  return blocks_per_sm(packed_score_kernel<kNvec, kBits>, warps, smem_bytes,
                       per_sm);
}

}  // namespace

// The ring's shape (stages per warp, warps per block, stage_bytes,
// query_slots, warp_bytes, smem_bytes, meta_in_ring) comes from
// the wrapper's launch plan (ops/kernels/payload_score.py::launch_plan); the
// grid is as many blocks as are resident at once.  d_pad is the stored
// bytes per slab row; q is int8 [B, d_pad] for bits 8, bf16 [B, 2 d_pad] for
// bits 4.  Returns cudaGetLastError() after the launch.
extern "C" int ohnsw_packed_score(const void* nodes, const void* meta,
                                  const void* pay, const void* q,
                                  const void* qn, const void* scale,
                                  void* cand_ids, void* cand_d, int B, int E,
                                  int deg, int d_pad, int needs_norms,
                                  int slots, int bits, int stages, int warps,
                                  int stage_bytes, int query_slots,
                                  int warp_bytes, int smem_bytes,
                                  int meta_in_ring, void* stream) {
  const long long n_items = static_cast<long long>(B) * E;
  if (n_items == 0 || deg == 0) return 0;
  if (n_items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const long long q_bytes = bits == 8 ? d_pad : 4LL * d_pad;
  if ((bits != 8 && bits != 4) || slots < 1 || slots > deg ||
      d_pad % 16 != 0 || stages < 1 || stages > 32 || warps < 1 ||
      warps > kMaxWarps || stage_bytes % 16 != 0 ||
      stage_bytes < slots * d_pad + (meta_in_ring ? 8 * deg : 0) ||
      (meta_in_ring && deg % 2 != 0) ||
      query_slots < (stages - 1 + E - 1) / E + 1 || warp_bytes % 16 != 0 ||
      warp_bytes < static_cast<long long>(stages) * stage_bytes +
                       query_slots * q_bytes ||
      smem_bytes < header_bytes(warps * stages) +
                       static_cast<long long>(warps) * warp_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{nodes,      meta,        pay,
                 q,          qn,          scale,
                 cand_ids,   cand_d,      static_cast<int>(n_items),
                 E,          deg,         d_pad,
                 slots,      needs_norms, stages,
                 warps,      stage_bytes, query_slots,
                 warp_bytes, smem_bytes,  meta_in_ring,
                 static_cast<cudaStream_t>(stream)};
  if (bits == 8) return d_pad == 128 ? launch<8, 8>(a) : launch<0, 8>(a);
  return d_pad == 64 ? launch<4, 4>(a) : launch<0, 4>(a);
}

// Blocks of `warps` warps with smem_bytes of shared memory that one SM
// holds at once, for the instance ohnsw_packed_score launches at this d_pad
// and bits, into *per_sm.  Returns a cudaError_t.
extern "C" int ohnsw_packed_score_occupancy(int d_pad, int bits, int warps,
                                            int smem_bytes, int* per_sm) {
  if (bits == 8)
    return d_pad == 128 ? occupancy<8, 8>(warps, smem_bytes, per_sm)
                        : occupancy<0, 8>(warps, smem_bytes, per_sm);
  if (bits == 4)
    return d_pad == 64 ? occupancy<4, 4>(warps, smem_bytes, per_sm)
                       : occupancy<0, 4>(warps, smem_bytes, per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}
