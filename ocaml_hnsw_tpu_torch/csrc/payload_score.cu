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
//     2 * d_pad components.  Lane r widens both to f32 and sums nibble x query
//     with fmaf (each product is exact in f32: 4 x 8 significant bits), so
//     only the order of the f32 sum differs from the plain version's.  The
//     epilogue is the same, with the dot an f32 instead of an int.
//
// What bounds it on an H100: memory, as gathers of whole slabs.  At the
// main-path shape (B = 4096 or 8192 queries, E = 2 expanded nodes, deg = 32,
// d_pad = 128) each (query, node) item reads a 4 KB slab, a 256 B meta row and
// the 128 B query row from random addresses, and does 2 int ops per byte:
// far below the card's ridge point, so the bound is bytes / 3.35 TB/s, and
// reaching it takes ~3.4 MB in flight across the card (Little's law), i.e.
// more than 8 slabs per SM at all times.
//
// The design, a bulk-copy slab ring private to each warp: as many warps as
// fit are resident, and each walks a contiguous range of (query, node)
// items.  It loads its node ids 32 at a time (one coalesced load, the next
// group's in flight) and keeps `stages` items in flight: for each, one lane
// issues bulk copies (cp.async.bulk, the TMA's linear mode: one instruction
// per contiguous run, the hardware makes the addresses) of the slab, the
// query row and the meta row into a shared-memory stage, as soon as the node
// id is known; nothing waits on the meta contents.  When an item's mbarrier
// completes, lane j scores row j from shared memory with __dp4a, reading
// 16-byte chunk (c + j) mod (d_pad / 16) at step c, so the 8 lanes of a
// quarter-warp hit 8 different bank groups instead of one; then the warp
// refills the stage with the item `stages` further on.  The stage size
// follows deg * d_pad (the wrapper's launch plan), so a 24 KB slab
// (d_pad = 768) still fits.
//
// Why a ring per warp and not one per block fed by a producer warp: on the
// card, one producer thread issuing every item of a block serialised the
// copies (a timeline of the block showed the ring still being armed long
// after the first slabs had landed); with every warp its own producer the
// copies are issued in parallel, and no warp ever waits on another (no
// "stage empty" barriers).  Two stages per warp with ~24 warps resident per
// SM (~46 slabs, ~200 KB in flight per SM) timed best of the ring shapes
// tried on an H100.
//
// Tensor cores buy nothing here: each query owns its slabs, so an int8 MMA
// would compute a [deg, 16] tile of which one column is wanted (15/16
// wasted), as the TPU kernel's matrix-unit dot did.
//
// Every stage a warp arms is consumed before the warp exits: nodes < 0 arm
// their stage with a plain arrive (no bytes), so no mbarrier waits on a copy
// never issued, and a warp never runs ahead of its own barriers by more than
// one phase.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

constexpr int kMaxWarps = 4;  // per block

struct Item {  // where the copies of this warp's items come from
  const int8_t* pay;
  const int* meta;
  const unsigned char* q;  // int8 [B, d_pad] or bf16 [B, 2 d_pad]
  int deg, d_pad, slots, q_bytes, E, meta_in_ring, stage_bytes;
  long long lo;
};

// Arms stage (i mod stages) with item i's copies; one lane calls it.
__device__ __forceinline__ void issue(const Item& it, unsigned char* ring,
                                      uint64_t* full, int stages, int i,
                                      int node) {
  const int s = i % stages;
  if (node < 0) {
    mbar_arrive(&full[s]);  // nothing to fetch
    return;
  }
  const int slab_bytes = it.slots * it.d_pad;  // a prefix of the node's slab
  const int meta_bytes = it.meta_in_ring ? 8 * it.deg : 0;
  unsigned char* st = ring + static_cast<size_t>(s) * it.stage_bytes;
  mbar_arrive_expect_tx(&full[s], slab_bytes + it.q_bytes + meta_bytes);
  bulk_load(st,
            it.pay + static_cast<size_t>(node) * it.deg * it.d_pad,
            slab_bytes, &full[s]);
  bulk_load(st + slab_bytes,
            it.q + static_cast<size_t>((it.lo + i) / it.E) * it.q_bytes,
            it.q_bytes, &full[s]);
  if (meta_bytes)
    bulk_load(st + slab_bytes + it.q_bytes,
              it.meta + static_cast<size_t>(node) * 2 * it.deg, meta_bytes,
              &full[s]);
}

// Exact int32 dot of an int8 slab row with the int8 query row, 16-byte
// chunk (c + r) mod nvec at step c (module comment).
template <int kNvec>
__device__ __forceinline__ int dot_int8(const int4* row, const int4* qv,
                                        int r, int nvec) {
  int acc = 0;
  if (kNvec > 0) {
#pragma unroll
    for (int c = 0; c < kNvec; ++c) {
      const int cc = (c + r) % kNvec;  // rotated: no bank conflicts
      const int4 x = row[cc];
      const int4 y = qv[cc];
      acc = __dp4a(x.x, y.x, acc);
      acc = __dp4a(x.y, y.y, acc);
      acc = __dp4a(x.z, y.z, acc);
      acc = __dp4a(x.w, y.w, acc);
    }
  } else {
    int cc = r % nvec;
#pragma unroll 4
    for (int c = 0; c < nvec; ++c) {
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

// Four payload bytes (8 components: per byte the low nibble, then the high)
// against the 8 bf16 query values in the 4 words of `q`, summed into acc.
__device__ __forceinline__ float nibble_fma(int x, uint4 q, float acc) {
  const uint32_t qw[4] = {q.x, q.y, q.z, q.w};
  const uint32_t ux = static_cast<uint32_t>(x);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int lo = static_cast<int>(ux << (28 - 8 * t)) >> 28;  // signed
    const int hi = static_cast<int>(ux << (24 - 8 * t)) >> 28;
    acc = fmaf(static_cast<float>(lo), __uint_as_float(qw[t] << 16), acc);
    acc = fmaf(static_cast<float>(hi), __uint_as_float(qw[t] & 0xffff0000u),
               acc);
  }
  return acc;
}

// f32 dot of a nibble-packed slab row with the bf16 query row: 16 payload
// bytes (32 components) pair with 4 16-byte chunks of the query, in the
// same rotated chunk order as dot_int8.
template <int kNvec>
__device__ __forceinline__ float dot_int4(const int4* row, const uint4* qv,
                                          int r, int nvec) {
  float acc = 0.0f;
  const int n = kNvec > 0 ? kNvec : nvec;
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    const int cc = (c + r) % n;
    const int4 x = row[cc];
    acc = nibble_fma(x.x, qv[4 * cc + 0], acc);
    acc = nibble_fma(x.y, qv[4 * cc + 1], acc);
    acc = nibble_fma(x.z, qv[4 * cc + 2], acc);
    acc = nibble_fma(x.w, qv[4 * cc + 3], acc);
  }
  return acc;
}

// kNvec: 16-byte chunks per payload row (d_pad / 16) fixed at compile time,
// or 0 to read it from d_pad.  kBits: 8 (int8 rows, int8 query) or 4
// (nibble rows, bf16 query).
template <int kNvec, int kBits>
__global__ void __launch_bounds__(32 * kMaxWarps)
    packed_score_kernel(const int* __restrict__ nodes,
                        const int* __restrict__ meta,
                        const int8_t* __restrict__ pay,
                        const unsigned char* __restrict__ q,
                        const float* __restrict__ qn,
                        const float* __restrict__ scale,
                        int* __restrict__ cand_ids,
                        float* __restrict__ cand_d, long long n_items, int E,
                        int deg, int d_pad, int slots, int needs_norms,
                        int stages, int stage_bytes, int meta_in_ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem) + warp * stages;
  unsigned char* ring = smem + header_bytes(warps * stages) +
                        static_cast<size_t>(warp) * stages * stage_bytes;
  // this warp's contiguous range of (query, node) items
  const long long gw = static_cast<long long>(blockIdx.x) * warps + warp;
  const long long tw = static_cast<long long>(gridDim.x) * warps;
  const long long lo = n_items * gw / tw;
  const int count = static_cast<int>(n_items * (gw + 1) / tw - lo);
  const int q_bytes = kBits == 8 ? d_pad : 4 * d_pad;
  const Item it{pay,   meta, q,           deg,         d_pad, slots,
                q_bytes, E,  meta_in_ring, stage_bytes, lo};

  if (lane < stages) mbar_init(&full[lane], 1);
  mbar_init_fence();
  __syncwarp();
  // node ids of items [32g, 32g + 32) and of the next group
  int cur = lane < count ? nodes[lo + lane] : -1;
  int nxt = 32 + lane < count ? nodes[lo + 32 + lane] : -1;
  if (lane < min(stages, count)) issue(it, ring, full, stages, lane, cur);

  const float s = __ldg(scale);
  const float s2 = __fmul_rn(s, s);
  const float inf = __int_as_float(0x7f800000);
  const int nvec = kNvec > 0 ? kNvec : d_pad / 16;
  const int slab_bytes = slots * d_pad;
  for (int i = 0; i < count; ++i) {
    if (i > 0 && (i & 31) == 0) {
      cur = nxt;
      nxt = i + 32 + lane < count ? nodes[lo + i + 32 + lane] : -1;
    }
    const int node = __shfl_sync(0xffffffffu, cur, i & 31);
    const long long w = lo + i;
    const float qnb = needs_norms ? qn[w / E] : 0.0f;  // ahead of the wait
    const int st_i = i % stages;
    mbar_wait(&full[st_i], (i / stages) & 1);
    int* oid = cand_ids + w * slots;
    float* od = cand_d + w * slots;
    if (node < 0) {
      for (int r = lane; r < slots; r += 32) {
        oid[r] = -1;
        od[r] = inf;
      }
    } else {
      const unsigned char* st = ring + static_cast<size_t>(st_i) * stage_bytes;
      const int* mrow =
          meta_in_ring
              ? reinterpret_cast<const int*>(st + slab_bytes + q_bytes)
              : meta + static_cast<size_t>(node) * 2 * deg;
      for (int r = lane; r < slots; r += 32) {
        const int id = mrow[r];
        if (id < 0) {
          oid[r] = -1;
          od[r] = inf;
          continue;
        }
        const int4* row = reinterpret_cast<const int4*>(st + r * d_pad);
        float d;
        if constexpr (kBits == 8) {
          const int acc = dot_int8<kNvec>(
              row, reinterpret_cast<const int4*>(st + slab_bytes), r, nvec);
          if (needs_norms) {
            const float t = static_cast<float>(mrow[deg + r] - 2 * acc);
            d = __fadd_rn(__fmul_rn(s2, t), qnb);
          } else {
            d = __fsub_rn(1.0f, __fmul_rn(s2, static_cast<float>(acc)));
          }
        } else {
          const float acc = dot_int4<kNvec>(
              row, reinterpret_cast<const uint4*>(st + slab_bytes), r, nvec);
          if (needs_norms) {
            const float t = __fsub_rn(static_cast<float>(mrow[deg + r]),
                                      __fmul_rn(2.0f, acc));
            d = __fadd_rn(__fmul_rn(s2, t), qnb);
          } else {
            d = __fsub_rn(1.0f, __fmul_rn(s2, acc));
          }
        }
        oid[r] = id;
        od[r] = d;
      }
    }
    __syncwarp();  // every lane is done with the stage: refill it
    const int j = i + stages;
    if (j < count) {
      const int nj = __shfl_sync(0xffffffffu, (j >> 5) == (i >> 5) ? cur : nxt,
                                 j & 31);
      if (lane == 0) {
        // order this warp's reads of the stage before the async-proxy write
        async_proxy_fence();
        issue(it, ring, full, stages, j, nj);
      }
    }
  }
}

template <int kNvec, int kBits>
int launch(const void* nodes, const void* meta, const void* pay,
           const void* q, const void* qn, const void* scale, void* cand_ids,
           void* cand_d, long long n_items, int E, int deg, int d_pad,
           int slots, int needs_norms, int stages, int warps,
           int stage_bytes, int smem_bytes, int meta_in_ring,
           cudaStream_t stream) {
  auto kernel = packed_score_kernel<kNvec, kBits>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 32 * warps;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem_bytes)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long need = (n_items + warps - 1) / warps;  // a warp per item
  const unsigned blocks =
      static_cast<unsigned>(need < resident ? need : resident);
  kernel<<<blocks, threads, smem_bytes, stream>>>(
      static_cast<const int*>(nodes), static_cast<const int*>(meta),
      static_cast<const int8_t*>(pay), static_cast<const unsigned char*>(q),
      static_cast<const float*>(qn), static_cast<const float*>(scale),
      static_cast<int*>(cand_ids), static_cast<float*>(cand_d), n_items, E,
      deg, d_pad, slots, needs_norms, stages, stage_bytes, meta_in_ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The ring's shape (stages per warp, warps per block, stage_bytes,
// smem_bytes, meta_in_ring) comes from the wrapper's launch plan
// (ops/kernels/payload_score.py::launch_plan); the grid is as many blocks as
// are resident at once.  d_pad is the stored bytes per slab row; q is int8
// [B, d_pad] for bits 8, bf16 [B, 2 d_pad] for bits 4.  Returns
// cudaGetLastError() after the launch.
extern "C" int ohnsw_packed_score(const void* nodes, const void* meta,
                                  const void* pay, const void* q,
                                  const void* qn, const void* scale,
                                  void* cand_ids, void* cand_d, int B, int E,
                                  int deg, int d_pad, int needs_norms,
                                  int slots, int bits, int stages, int warps,
                                  int stage_bytes, int smem_bytes,
                                  int meta_in_ring, void* stream) {
  const long long n_items = static_cast<long long>(B) * E;
  if (n_items == 0 || deg == 0) return 0;
  const int q_bytes = bits == 8 ? d_pad : 4 * d_pad;
  if ((bits != 8 && bits != 4) || slots < 1 || slots > deg ||
      d_pad % 16 != 0 || stages < 1 || stages > 32 || warps < 1 ||
      warps > kMaxWarps || stage_bytes % 16 != 0 ||
      stage_bytes < slots * d_pad + q_bytes + (meta_in_ring ? 8 * deg : 0) ||
      (meta_in_ring && deg % 2 != 0) ||
      smem_bytes < header_bytes(warps * stages) + warps * stages * stage_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OHNSW_LAUNCH(NVEC, BITS)                                          \
  launch<NVEC, BITS>(nodes, meta, pay, q, qn, scale, cand_ids, cand_d,   \
                     n_items, E, deg, d_pad, slots, needs_norms, stages, \
                     warps, stage_bytes, smem_bytes, meta_in_ring, st)
  if (bits == 8) return d_pad == 128 ? OHNSW_LAUNCH(8, 8) : OHNSW_LAUNCH(0, 8);
  return d_pad == 64 ? OHNSW_LAUNCH(4, 4) : OHNSW_LAUNCH(0, 4);
#undef OHNSW_LAUNCH
}
