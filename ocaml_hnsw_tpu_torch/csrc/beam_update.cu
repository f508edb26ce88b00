// Beam-update kernel (K4): everything in one iteration of the packed beam
// loop but the candidate scoring (K1).
//
// Replaces no TPU kernel: on the TPU the JAX engine's beam step
// (ocaml_hnsw_tpu/models/packed.py, _beam_body) is one XLA program, fused
// by the compiler.  Run eagerly, the same step was ~215 small torch
// launches per iteration, each costing more host time than device time; this
// kernel does it in one.  Per query row, given the sorted-ascending beam
// (pk = 2 * id + expanded, d) of width ef and K1's C candidates:
//   1. fresh = id >= 0, not in the beam, first occurrence in its row;
//   2. the candidates, fresh ones kept and the rest made (+inf, -1), sorted
//      descending at their own width p2c = next_pow2(C) by the bitonic
//      network of ops/sortmerge.py::bitonic_sort;
//   3. merged into the beam by ops/sortmerge.py::merge_into_beam's network
//      (beam ascending ++ candidates descending, width 2 * p2 with p2 =
//      next_pow2(max(ef, C)), pads of (+inf, -1)), the best ef kept;
//   4. unless told not to, the E nearest unexpanded beam entries selected:
//      their expanded bit set, their ids written to nodes[E] (-1 where
//      fewer than E are left).
// Every compare-exchange swaps only if the partner is strictly better, as
// the plain version's stages do, so ties come out in the same order and the
// outputs equal the plain version's bit for bit: no distance is computed.
// C == 0 is step 4 alone (the loop's first selection).
//
// What bounds it on an H100: neither bytes nor operations.  At the main
// path's shape (B = 4096, ef = 64, C = 64) a row reads and writes ~1 KB, so
// the call moves ~4 MB (~1.3 us at 3.35 TB/s); its time is the latency of a
// row's dependent chain: ~130 broadcast steps of the dedup tests, then 28
// compare-exchange stages.  The design keeps that chain in registers:
//   - widths 2 * p2 <= 256: one warp per row, element i in register i / 32
//     of lane i % 32.  Stages at partner distance < 32 exchange by
//     __shfl_xor_sync, wider ones between a lane's own registers.  The
//     membership and first-occurrence tests broadcast each beam id and each
//     candidate id across the warp by __shfl_sync (no [C, ef] compare is
//     written anywhere), and the selection ranks unexpanded entries by
//     __ballot_sync and __popc.
//   - wider rows (glove's packed point ef 160, the construction beam ef
//     200 with C 256: width 512), up to p2 = 4096: one block per row, the
//     row in shared memory, a __syncthreads between stages.
//
// The classic step (ohnsw_beam_step_classic) is the same kernel for the
// classic engine's beam (ocaml_hnsw_tpu_torch/models/search.py,
// beam_search_layer with beam-only dedup), whose candidate block is built
// before it is scored: its dedup and compaction come ahead of the gather
// distance kernel (K2), so K2 reads only fresh rows.  Per query row it
//   1. merges the previous iteration's scored candidates (pk = 2 * id, or -1
//      where id < 0; their distances as given) into the beam by the networks
//      above (no dedup: the previous step made them fresh);
//   2. records whether the merged beam has an unexpanded entry (*live = 1)
//      and selects the E nearest unexpanded entries as step 4 above;
//   3. expands them: reads each one's adjacency row from a dense table
//      (adj[v]) or from an upper layer's arena (adj[up_base[v] + level - 1]
//      where levels[v] >= level and up_base[v] >= 0, else the sink row);
//   4. marks fresh each of the E * deg slot ids that is >= 0, not in the
//      beam and the first of its id in the row, and writes them, packed left
//      in slot order and cut to C, or in place (-1 elsewhere) when C = E *
//      deg, as K2's next block.
// Eagerly the step was ~290 launches.  Bound: again latency, not bytes: the
// row's dependent chain is the merge, then the adjacency reads (E rows of
// deg ids), then ~(ef + E * deg) broadcast steps of the fresh test.  The
// paths are K4's: one warp per row in registers where the merge is at most
// 256 wide and E * deg at most 256 (the E * deg slots in 8 registers a
// lane), else one block per row in shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxP2 = 4096;        // widest next_pow2(max(ef, C)) taken
constexpr int kWarpWidth = 256;     // widest merge one warp takes
constexpr int kWarpRows = 4;        // rows (warps) per block, warp path
constexpr int kBlockThreads = 512;  // most threads per row, block path

struct Args {
  const int* beam_pk;
  const float* beam_d;
  const int* cand_ids;
  const float* cand_d;
  int* out_pk;
  float* out_d;
  int* nodes;
  int b, ef, c, e, p2, p2c, select;
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// Whether a compare-exchange swaps the pair (lo, hi) = (d at the lower
// index, d at the upper): the lower keeps the min when `up`, else the max.
__device__ __forceinline__ bool swaps(float lo, float hi, bool up) {
  return up ? hi < lo : hi > lo;
}

// Takes the next chunk of 32 beam entries (this lane's pk, `live` if its
// index is < ef) into the selection: the E nearest unexpanded entries in
// beam order.  Returns the count of unexpanded entries seen so far.
__device__ __forceinline__ int select_chunk(int& pk, bool live, int taken,
                                            int e, int* nodes_row, int lane) {
  const bool unexp = live && (pk & 1) == 0;
  const unsigned m = __ballot_sync(kFull, unexp);
  const int rank = taken + __popc(m & ((1u << lane) - 1u));
  if (unexp && rank < e) {
    nodes_row[rank] = pk >> 1;
    pk |= 1;
  }
  return taken + __popc(m);
}

__device__ __forceinline__ void fill_unselected(int taken, int e,
                                                int* nodes_row, int lane) {
  for (int t = min(taken, e) + lane; t < e; t += 32) nodes_row[t] = -1;
}

// ------------------------------------------------------------ warp path
// A stage at partner distance 32 * JR, between registers r and r | JR of
// each lane, over registers [R0, R).  `base` is the network's first index
// (its elements' local index is i - base); a sort stage's direction comes
// from (lower & k), descending; a merge stage is ascending throughout.
template <int R, int R0, int JR>
__device__ __forceinline__ void reg_stage_t(float (&d)[R], int (&p)[R],
                                            int lane, int base, int k,
                                            bool sort) {
#pragma unroll
  for (int r = R0; r < R; ++r) {
    if (r & JR) continue;
    const int r2 = (r | JR) & (R - 1);
    const int lower = r * 32 + lane - base;
    if (swaps(d[r], d[r2], !sort || (lower & k) != 0)) {
      const float td = d[r];
      d[r] = d[r2];
      d[r2] = td;
      const int tp = p[r];
      p[r] = p[r2];
      p[r2] = tp;
    }
  }
}

template <int R, int R0>
__device__ __forceinline__ void reg_stage(float (&d)[R], int (&p)[R], int jr,
                                          int lane, int base, int k,
                                          bool sort) {
  if (jr == 1)
    reg_stage_t<R, R0, 1>(d, p, lane, base, k, sort);
  else if (jr == 2)
    reg_stage_t<R, R0, 2>(d, p, lane, base, k, sort);
  else
    reg_stage_t<R, R0, 4>(d, p, lane, base, k, sort);
}

// A stage at partner distance j < 32, across lanes: each element takes its
// partner's (d, p) when the pair swaps.  Elements below `base` are not in
// the network and keep theirs (their partners are not in it either).
template <int R, int R0>
__device__ __forceinline__ void shfl_stage(float (&d)[R], int (&p)[R], int j,
                                           int lane, int base, int k,
                                           bool sort) {
#pragma unroll
  for (int r = R0; r < R; ++r) {
    const float od = __shfl_xor_sync(kFull, d[r], j);
    const int op = __shfl_xor_sync(kFull, p[r], j);
    const int i = r * 32 + lane - base;
    if (i >= 0) {
      const bool is_lo = (i & j) == 0;
      const bool up = !sort || (i & k) != 0;  // i & k == lower & k: k > j
      if (swaps(is_lo ? d[r] : od, is_lo ? od : d[r], up)) {
        d[r] = od;
        p[r] = op;
      }
    }
  }
}

template <int R, int R0>
__device__ __forceinline__ void stage(float (&d)[R], int (&p)[R], int j,
                                      int lane, int base, int k, bool sort) {
  if (j >= 32)
    reg_stage<R, R0>(d, p, j >> 5, lane, base, k, sort);
  else
    shfl_stage<R, R0>(d, p, j, lane, base, k, sort);
}

// One warp per row; the merge's 2 * p2 elements in R registers a lane (R =
// max(1, 2 * p2 / 32)), the candidates' run [cbase, 2 * p2) in the last RC
// (max(1, p2c / 32)), the beam [0, p2) in the first RB.
template <int R, int RC>
__global__ void __launch_bounds__(32 * kWarpRows)
    beam_update_warp(const Args a) {
  constexpr int RB = R > 1 ? R / 2 : 1;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= a.b) return;
  const int ef = a.ef, c = a.c, p2 = a.p2, p2c = a.p2c;
  const int cbase = 2 * p2 - p2c;
  const long long bo = static_cast<long long>(row) * ef;
  const long long co = static_cast<long long>(row) * c;

  float d[R];
  int p[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * 32 + lane;
    d[r] = inf();
    p[r] = -1;
    if (r < RB && i < ef) {
      d[r] = a.beam_d[bo + i];
      p[r] = a.beam_pk[bo + i];
    }
  }
  int cid[RC];
  float cdv[RC];
  bool keep[RC];
#pragma unroll
  for (int t = 0; t < RC; ++t) {
    const int li = (R - RC + t) * 32 + lane - cbase;
    cid[t] = -1;
    cdv[t] = inf();
    if (li >= 0 && li < c) {
      cid[t] = a.cand_ids[co + li];
      cdv[t] = a.cand_d[co + li];
    }
    keep[t] = cid[t] >= 0;
  }
  // 1. not in the beam: each beam id in turn, broadcast to the warp
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r * 32 >= ef) break;
    const int mine = p[r] >> 1;
    const int n = min(32, ef - r * 32);
    for (int s = 0; s < n; ++s) {
      const int id = __shfl_sync(kFull, mine, s);
#pragma unroll
      for (int t = 0; t < RC; ++t) keep[t] = keep[t] && cid[t] != id;
    }
  }
  //    and the first of its id: each candidate in turn, against later ones
#pragma unroll
  for (int u = 0; u < RC; ++u) {
    for (int s = 0; s < 32; ++s) {
      const int id = __shfl_sync(kFull, cid[u], s);
#pragma unroll
      for (int t = 0; t < RC; ++t)
        keep[t] = keep[t] && (cid[t] != id || t * 32 + lane <= u * 32 + s);
    }
  }
#pragma unroll
  for (int t = 0; t < RC; ++t) {
    const int r = R - RC + t;
    if (r * 32 + lane >= cbase) {
      d[r] = keep[t] ? cdv[t] : inf();
      p[r] = keep[t] ? 2 * cid[t] : -1;
    }
  }
  // 2. the candidates' run sorted descending
  for (int k = 2; k <= p2c; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1)
      stage<R, R - RC>(d, p, j, lane, cbase, k, true);
  // 3. beam ++ run merged ascending
  for (int j = p2; j > 0; j >>= 1) stage<R, 0>(d, p, j, lane, 0, 0, false);
  // 4. the next iteration's nodes
  if (a.select) {
    int* nodes_row = a.nodes + static_cast<long long>(row) * a.e;
    int taken = 0;
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r * 32 < ef && taken < a.e)
        taken = select_chunk(p[r], r * 32 + lane < ef, taken, a.e, nodes_row,
                             lane);
    fill_unselected(taken, a.e, nodes_row, lane);
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int i = r * 32 + lane;
    if (i < ef) {
      a.out_pk[bo + i] = p[r];
      a.out_d[bo + i] = d[r];
    }
  }
}

// ----------------------------------------------------------- block path
// The compare-exchange of elements lo < hi of the shared row.
__device__ __forceinline__ void exchange(float* sd, int* sp, int lo, int hi,
                                         bool up) {
  const float dl = sd[lo], dh = sd[hi];
  if (swaps(dl, dh, up)) {
    sd[lo] = dh;
    sd[hi] = dl;
    const int t = sp[lo];
    sp[lo] = sp[hi];
    sp[hi] = t;
  }
}

// The lower index of pair t of a stage at partner distance j (a power of
// two): pairs are numbered in order of their lower index.
__device__ __forceinline__ int lower_of(int t, int j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// One block per row: the merge's 2 * p2 entries (d, then pk) and the raw
// candidate ids in dynamic shared memory.
__global__ void beam_update_block(const Args a) {
  extern __shared__ float4 smem_f4[];
  const int ef = a.ef, c = a.c, p2 = a.p2, p2c = a.p2c, n = 2 * p2;
  const int cbase = n - p2c;
  float* sd = reinterpret_cast<float*>(smem_f4);
  int* sp = reinterpret_cast<int*>(sd + n);
  int* sc = sp + n;
  const int row = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const long long bo = static_cast<long long>(row) * ef;
  const long long co = static_cast<long long>(row) * c;
  for (int i = tid; i < cbase; i += nt) {
    const bool in = i < ef;
    sd[i] = in ? a.beam_d[bo + i] : inf();
    sp[i] = in ? a.beam_pk[bo + i] : -1;
  }
  for (int t = tid; t < c; t += nt) sc[t] = a.cand_ids[co + t];
  __syncthreads();
  // 1. fresh candidates, against the beam [0, ef) and earlier candidates
  for (int t = tid; t < p2c; t += nt) {
    float dv = inf();
    int pv = -1;
    if (t < c) {
      const int id = sc[t];
      bool keep = id >= 0;
      for (int i = 0; keep && i < ef; ++i) keep = (sp[i] >> 1) != id;
      for (int u = 0; keep && u < t; ++u) keep = sc[u] != id;
      if (keep) {
        dv = a.cand_d[co + t];
        pv = 2 * id;
      }
    }
    sd[cbase + t] = dv;
    sp[cbase + t] = pv;
  }
  __syncthreads();
  // 2. the candidates' run sorted descending
  for (int k = 2; k <= p2c; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < p2c / 2; t += nt) {
        const int lo = lower_of(t, j);
        exchange(sd, sp, cbase + lo, cbase + lo + j, (lo & k) != 0);
      }
      __syncthreads();
    }
  // 3. beam ++ run merged ascending
  for (int j = p2; j > 0; j >>= 1) {
    for (int t = tid; t < p2; t += nt) {
      const int lo = lower_of(t, j);
      exchange(sd, sp, lo, lo + j, true);
    }
    __syncthreads();
  }
  // 4. the next iteration's nodes, by warp 0
  if (a.select && tid < 32) {
    int* nodes_row = a.nodes + static_cast<long long>(row) * a.e;
    int taken = 0;
    for (int base = 0; base < ef && taken < a.e; base += 32) {
      const int i = base + tid;
      int pk = i < ef ? sp[i] : -1;
      taken = select_chunk(pk, i < ef, taken, a.e, nodes_row, tid);
      if (i < ef) sp[i] = pk;
    }
    fill_unselected(taken, a.e, nodes_row, tid);
  }
  __syncthreads();
  for (int i = tid; i < ef; i += nt) {
    a.out_pk[bo + i] = sp[i];
    a.out_d[bo + i] = sd[i];
  }
}

// ---------------------------------------------------------- select only
// Step 4 alone, one warp per row: out_pk is beam_pk with the selection's
// expanded bits set (the distances do not change).
__global__ void __launch_bounds__(32 * kWarpRows)
    beam_select_warp(const Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= a.b) return;
  const long long bo = static_cast<long long>(row) * a.ef;
  int* nodes_row = a.nodes + static_cast<long long>(row) * a.e;
  int taken = 0;
  for (int base = 0; base < a.ef; base += 32) {
    const int i = base + lane;
    int pk = i < a.ef ? a.beam_pk[bo + i] : -1;
    if (taken < a.e)
      taken = select_chunk(pk, i < a.ef, taken, a.e, nodes_row, lane);
    if (i < a.ef) a.out_pk[bo + i] = pk;
  }
  fill_unselected(taken, a.e, nodes_row, lane);
}

// ------------------------------------------------------ classic step
constexpr int kSlotRegs = 8;       // slot registers a lane, warp path
constexpr int kWarpSlots = 32 * kSlotRegs;
constexpr int kMaxSlots = 4096;    // most E * deg slots taken

struct ClassicArgs {
  const int* beam_pk;
  const float* beam_d;
  const int* cand_ids;  // the previous step's block, c_in wide (or none)
  const float* cand_d;
  const int* adj;       // dense [N, deg] table, or an upper layer's arena
  const int* up_base;   // nullptr for a dense table
  const int* levels;
  int* out_pk;
  float* out_d;
  int* out_cand;        // [B, c]
  int* live;
  int b, ef, c_in, e, deg, s, c, level, sink, p2, p2c;
};

// Offset of node v's adjacency row (v >= 0).
__device__ __forceinline__ long long adj_offset(const ClassicArgs& a, int v) {
  long long r = v;
  if (a.up_base != nullptr) {
    const int base = a.up_base[v];
    r = (a.levels[v] >= a.level && base >= 0) ? base + a.level - 1 : a.sink;
  }
  return r * a.deg;
}

// Slot s's neighbour id: the (s % deg)-th of node s / deg, -1 past the slots
// or where that node is -1.
__device__ __forceinline__ int slot_id(const ClassicArgs& a,
                                       const int* nodes, int s) {
  if (s >= a.s) return -1;
  const int k = s / a.deg;
  const int v = nodes[k];
  return v < 0 ? -1 : a.adj[adj_offset(a, v) + (s - k * a.deg)];
}

template <int R, int RC>
__global__ void __launch_bounds__(32 * kWarpRows)
    beam_step_classic_warp(const ClassicArgs a) {
  constexpr int RB = R > 1 ? R / 2 : 1;
  // E <= ef <= p2 <= 128 on this path
  __shared__ int s_nodes[kWarpRows][kWarpWidth / 2];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpRows + w;
  if (row >= a.b) return;
  const int ef = a.ef, c_in = a.c_in, p2 = a.p2, p2c = a.p2c;
  const int cbase = 2 * p2 - p2c;
  const long long bo = static_cast<long long>(row) * ef;

  float d[R];
  int p[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * 32 + lane;
    d[r] = inf();
    p[r] = -1;
    if (r < RB && i < ef) {
      d[r] = a.beam_d[bo + i];
      p[r] = a.beam_pk[bo + i];
    }
  }
  // 1. the previous block merged in
  if (c_in > 0) {
    const long long co = static_cast<long long>(row) * c_in;
#pragma unroll
    for (int t = 0; t < RC; ++t) {
      const int r = R - RC + t;
      const int li = r * 32 + lane - cbase;
      if (li >= 0) {
        const int id = li < c_in ? a.cand_ids[co + li] : -1;
        d[r] = li < c_in ? a.cand_d[co + li] : inf();
        p[r] = id < 0 ? -1 : 2 * id;
      }
    }
    for (int k = 2; k <= p2c; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1)
        stage<R, R - RC>(d, p, j, lane, cbase, k, true);
    for (int j = p2; j > 0; j >>= 1) stage<R, 0>(d, p, j, lane, 0, 0, false);
  }
  // 2. live?, and the E nearest unexpanded entries
  int* nodes = s_nodes[w];
  int taken = 0;
#pragma unroll
  for (int r = 0; r < RB; ++r)
    if (r * 32 < ef && taken < a.e)
      taken = select_chunk(p[r], r * 32 + lane < ef, taken, a.e, nodes, lane);
  fill_unselected(taken, a.e, nodes, lane);
  if (taken > 0 && lane == 0) *a.live = 1;
  __syncwarp();
  // 3. their adjacency rows, slot r * 32 + lane in register r
  int sid[kSlotRegs];
  bool keep[kSlotRegs];
#pragma unroll
  for (int t = 0; t < kSlotRegs; ++t) {
    sid[t] = t * 32 < a.s ? slot_id(a, nodes, t * 32 + lane) : -1;
    keep[t] = sid[t] >= 0;
  }
  // 4. not in the beam: each beam id in turn, broadcast to the warp
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r * 32 >= ef) break;
    const int mine = p[r] >> 1;
    const int n = min(32, ef - r * 32);
    for (int s = 0; s < n; ++s) {
      const int id = __shfl_sync(kFull, mine, s);
#pragma unroll
      for (int t = 0; t < kSlotRegs; ++t)
        if (t * 32 < a.s) keep[t] = keep[t] && sid[t] != id;
    }
  }
  //    and the first of its id: each slot in turn, against later ones
#pragma unroll
  for (int u = 0; u < kSlotRegs; ++u) {
    if (u * 32 >= a.s) break;
    for (int s = 0; s < 32; ++s) {
      const int id = __shfl_sync(kFull, sid[u], s);
#pragma unroll
      for (int t = u; t < kSlotRegs; ++t)
        if (t * 32 < a.s)
          keep[t] = keep[t] && (sid[t] != id || t * 32 + lane <= u * 32 + s);
    }
  }
  int* out = a.out_cand + static_cast<long long>(row) * a.c;
  if (a.c < a.s) {
    //  packed left in slot order, cut to c
    int packed = 0;
#pragma unroll
    for (int t = 0; t < kSlotRegs; ++t) {
      if (t * 32 >= a.s) break;
      const unsigned m = __ballot_sync(kFull, keep[t]);
      const int rank = packed + __popc(m & ((1u << lane) - 1u));
      if (keep[t] && rank < a.c) out[rank] = sid[t];
      packed += __popc(m);
    }
    for (int t = min(packed, a.c) + lane; t < a.c; t += 32) out[t] = -1;
  } else {
#pragma unroll
    for (int t = 0; t < kSlotRegs; ++t) {
      const int s = t * 32 + lane;
      if (s < a.s) out[s] = keep[t] ? sid[t] : -1;
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int i = r * 32 + lane;
    if (i < ef) {
      a.out_pk[bo + i] = p[r];
      a.out_d[bo + i] = d[r];
    }
  }
}

// One block per row: the merge's 2 * p2 entries (d, then pk), the E nodes,
// the E * deg slot ids and their fresh flags in dynamic shared memory.
__global__ void beam_step_classic_block(const ClassicArgs a) {
  extern __shared__ float4 smem_f4[];
  const int ef = a.ef, c_in = a.c_in, p2 = a.p2, p2c = a.p2c, n = 2 * p2;
  const int cbase = n - p2c;
  float* sd = reinterpret_cast<float*>(smem_f4);
  int* sp = reinterpret_cast<int*>(sd + n);
  int* s_nodes = sp + n;
  int* s_slot = s_nodes + a.e;
  int* s_keep = s_slot + a.s;
  const int row = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const long long bo = static_cast<long long>(row) * ef;
  const long long co = static_cast<long long>(row) * c_in;
  for (int i = tid; i < cbase; i += nt) {
    const bool in = i < ef;
    sd[i] = in ? a.beam_d[bo + i] : inf();
    sp[i] = in ? a.beam_pk[bo + i] : -1;
  }
  for (int t = tid; t < p2c; t += nt) {
    const int id = t < c_in ? a.cand_ids[co + t] : -1;
    sd[cbase + t] = t < c_in ? a.cand_d[co + t] : inf();
    sp[cbase + t] = id < 0 ? -1 : 2 * id;
  }
  __syncthreads();
  // 1. the previous block merged in: its run sorted descending, then merged
  if (c_in > 0) {
    for (int k = 2; k <= p2c; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int t = tid; t < p2c / 2; t += nt) {
          const int lo = lower_of(t, j);
          exchange(sd, sp, cbase + lo, cbase + lo + j, (lo & k) != 0);
        }
        __syncthreads();
      }
    for (int j = p2; j > 0; j >>= 1) {
      for (int t = tid; t < p2; t += nt) {
        const int lo = lower_of(t, j);
        exchange(sd, sp, lo, lo + j, true);
      }
      __syncthreads();
    }
  }
  // 2. live?, and the E nearest unexpanded entries, by warp 0
  if (tid < 32) {
    int taken = 0;
    for (int base = 0; base < ef && taken < a.e; base += 32) {
      const int i = base + tid;
      int pk = i < ef ? sp[i] : -1;
      taken = select_chunk(pk, i < ef, taken, a.e, s_nodes, tid);
      if (i < ef) sp[i] = pk;
    }
    fill_unselected(taken, a.e, s_nodes, tid);
    if (taken > 0 && tid == 0) *a.live = 1;
  }
  __syncthreads();
  // 3. their adjacency rows
  for (int s = tid; s < a.s; s += nt) s_slot[s] = slot_id(a, s_nodes, s);
  __syncthreads();
  // 4. fresh: >= 0, not in the beam [0, ef), first of its id
  for (int s = tid; s < a.s; s += nt) {
    const int id = s_slot[s];
    bool keep = id >= 0;
    for (int i = 0; keep && i < ef; ++i) keep = (sp[i] >> 1) != id;
    for (int u = 0; keep && u < s; ++u) keep = s_slot[u] != id;
    s_keep[s] = keep;
  }
  __syncthreads();
  int* out = a.out_cand + static_cast<long long>(row) * a.c;
  if (a.c < a.s) {
    //  packed left in slot order, cut to c, by warp 0
    if (tid < 32) {
      int packed = 0;
      for (int base = 0; base < a.s && packed < a.c; base += 32) {
        const int s = base + tid;
        const bool keep = s < a.s && s_keep[s];
        const unsigned m = __ballot_sync(kFull, keep);
        const int rank = packed + __popc(m & ((1u << tid) - 1u));
        if (keep && rank < a.c) out[rank] = s_slot[s];
        packed += __popc(m);
      }
      for (int t = min(packed, a.c) + tid; t < a.c; t += 32) out[t] = -1;
    }
  } else {
    for (int s = tid; s < a.s; s += nt) out[s] = s_keep[s] ? s_slot[s] : -1;
  }
  for (int i = tid; i < ef; i += nt) {
    a.out_pk[bo + i] = sp[i];
    a.out_d[bo + i] = sd[i];
  }
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <int R, int RC>
int launch_warp(const Args& a, cudaStream_t stream) {
  const int blocks = (a.b + kWarpRows - 1) / kWarpRows;
  beam_update_warp<R, RC><<<blocks, 32 * kWarpRows, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int RC>
int launch_classic_warp(const ClassicArgs& a, cudaStream_t stream) {
  const int blocks = (a.b + kWarpRows - 1) / kWarpRows;
  beam_step_classic_warp<R, RC><<<blocks, 32 * kWarpRows, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One beam update of B rows (C == 0: the selection alone), on `stream`.
// beam_pk i32[B, ef], beam_d f32[B, ef] ascending; cand_ids i32[B, C],
// cand_d f32[B, C]; out_pk i32[B, ef], out_d f32[B, ef] (not written when
// C == 0); nodes i32[B, E] when `select`.  Rows of width next_pow2(max(ef,
// C)) up to 4096.  Returns cudaGetLastError() after the launch.
extern "C" int ohnsw_beam_update(const void* beam_pk, const void* beam_d,
                                 const void* cand_ids, const void* cand_d,
                                 void* out_pk, void* out_d, void* nodes,
                                 int B, int ef, int C, int E, int select,
                                 void* stream) {
  if (B == 0) return 0;
  if (B < 0 || ef < 1 || C < 0 || (select && E < 1) || (!select && C == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int p2 = next_pow2(ef > C ? ef : C);
  if (p2 > kMaxP2) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(beam_pk),
               static_cast<const float*>(beam_d),
               static_cast<const int*>(cand_ids),
               static_cast<const float*>(cand_d),
               static_cast<int*>(out_pk),
               static_cast<float*>(out_d),
               static_cast<int*>(nodes),
               B, ef, C, E, p2, C > 0 ? next_pow2(C) : 0, select};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0) {
    const int blocks = (B + kWarpRows - 1) / kWarpRows;
    beam_select_warp<<<blocks, 32 * kWarpRows, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int n = 2 * p2;
  if (n <= kWarpWidth) {
    const int r = n > 32 ? n / 32 : 1;
    const int rc = a.p2c > 32 ? a.p2c / 32 : 1;
    switch (r * 16 + rc) {
      case 1 * 16 + 1: return launch_warp<1, 1>(a, s);
      case 2 * 16 + 1: return launch_warp<2, 1>(a, s);
      case 4 * 16 + 1: return launch_warp<4, 1>(a, s);
      case 4 * 16 + 2: return launch_warp<4, 2>(a, s);
      case 8 * 16 + 1: return launch_warp<8, 1>(a, s);
      case 8 * 16 + 2: return launch_warp<8, 2>(a, s);
      case 8 * 16 + 4: return launch_warp<8, 4>(a, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int smem = n * 8 + C * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_update_block, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = p2 < kBlockThreads ? p2 : kBlockThreads;
  beam_update_block<<<B, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One classic beam step of B rows, on `stream`: merge the previous
// iteration's block (cand_ids i32[B, C_in], cand_d f32[B, C_in]; C_in = 0:
// none) into the beam (beam_pk i32[B, ef], beam_d f32[B, ef] ascending),
// set *live = 1 if some row then has an unexpanded entry, select E, expand
// them through the adjacency (adj i32[., deg]; up_base and levels i32[N]
// with `level` >= 1 and the arena's sink row `sink` for an upper layer,
// nullptr for a dense table), and write the fresh slot ids as the next
// block, out_cand i32[B, C] (packed left and cut to C when C < E * deg;
// C = E * deg: in place).  out_pk, out_d i32/f32[B, ef].  Rows of width
// next_pow2(max(ef, C_in)) up to 4096 and E * deg up to 4096.  Returns
// cudaGetLastError() after the launch.
extern "C" int ohnsw_beam_step_classic(
    const void* beam_pk, const void* beam_d, const void* cand_ids,
    const void* cand_d, const void* adj, const void* up_base,
    const void* levels, void* out_pk, void* out_d, void* out_cand,
    void* live, int B, int ef, int C_in, int E, int deg, int C, int level,
    int sink, void* stream) {
  if (B == 0) return 0;
  const long long slots = static_cast<long long>(E) * deg;
  if (B < 0 || ef < 1 || C_in < 0 || E < 1 || E > ef || deg < 1 ||
      slots > kMaxSlots || C < 1 || C > slots ||
      (up_base != nullptr && (level < 1 || sink < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int p2 = next_pow2(ef > C_in ? ef : C_in);
  if (p2 > kMaxP2) return static_cast<int>(cudaErrorInvalidValue);
  const int s = static_cast<int>(slots);
  const ClassicArgs a{static_cast<const int*>(beam_pk),
                      static_cast<const float*>(beam_d),
                      static_cast<const int*>(cand_ids),
                      static_cast<const float*>(cand_d),
                      static_cast<const int*>(adj),
                      static_cast<const int*>(up_base),
                      static_cast<const int*>(levels),
                      static_cast<int*>(out_pk),
                      static_cast<float*>(out_d),
                      static_cast<int*>(out_cand),
                      static_cast<int*>(live),
                      B, ef, C_in, E, deg, s, C, level, sink, p2,
                      C_in > 0 ? next_pow2(C_in) : 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = 2 * p2;
  if (n <= kWarpWidth && s <= kWarpSlots) {
    const int r = n > 32 ? n / 32 : 1;
    const int rc = a.p2c > 32 ? a.p2c / 32 : 1;
    switch (r * 16 + rc) {
      case 1 * 16 + 1: return launch_classic_warp<1, 1>(a, st);
      case 2 * 16 + 1: return launch_classic_warp<2, 1>(a, st);
      case 4 * 16 + 1: return launch_classic_warp<4, 1>(a, st);
      case 4 * 16 + 2: return launch_classic_warp<4, 2>(a, st);
      case 8 * 16 + 1: return launch_classic_warp<8, 1>(a, st);
      case 8 * 16 + 2: return launch_classic_warp<8, 2>(a, st);
      case 8 * 16 + 4: return launch_classic_warp<8, 4>(a, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int smem = n * 8 + (E + 2 * s) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_step_classic_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = p2 < kBlockThreads ? p2 : kBlockThreads;
  if (threads < 32) threads = 32;  // warp 0 selects and packs
  beam_step_classic_block<<<B, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
