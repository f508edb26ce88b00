// Gather-distance kernel (K2): d[b,k] = dist(q[b], vectors[ids[b,k]]).
//
// Replaces the TPU kernel ocaml_hnsw_tpu/ops/pallas/gather_dist.py::gather_l2
// and takes the whole contract of ocaml_hnsw_tpu/ops/distance.py::dists_to_ids,
// which the JAX engine runs in its place: rows stored as f32, bf16 or int8
// (per-row dequant scale), l2 = sum (x - q)^2 or ip/cosine = 1 - x.q, f32
// accumulation, and +inf where the id is -1.
//
// What bounds it on an H100: memory, as scattered row fetches.  Each (b, k)
// reads one D-wide row at a random address (512 B at D = 128 f32); the
// arithmetic is 2 flops per byte, far below the card's ridge point, so the
// bound is bytes / 3.35 TB/s, reached only with enough rows in flight.
//
// The design: a warp takes a task = one query b and up to 32 consecutive
// k's (the wrapper's launch plan splits K so the grid fills the card at
// every main-path shape, e.g. B = 1024, K = 97).  It loads the task's ids in
// one coalesced load (one id latency per task, not per row), holds the query
// row in registers as 16-byte vectors, and then keeps 8 16-byte loads in
// flight per lane: a row of 16-byte multiple width is split into chunks, a
// segment of `lpr` lanes (a power of two) covers one row, so one
// warp-instruction moves one f32 D=128 row, two bf16 rows or four int8 rows,
// and 8 / cpl such instructions are issued before any result is needed.  A
// segmented shuffle reduction sums each row, and the task's results leave in
// one coalesced store.  The grid is persistent (resident blocks walk the
// tasks), so no wave is left half full.  (Loading the next task's ids ahead,
// or deferring int8 scales behind the row loads, timed slower on the card:
// both raise the registers per thread and so cut the resident warps.)
//
// Narrow rows go straight to registers rather than through a shared-memory
// ring: a D = 128 f32 row is one 16-byte load per lane and is used once, so
// a ring would add a shared-memory write and read per byte and an mbarrier
// round per 512-byte row, for no more bytes in flight than 8 loads per lane
// already give.
//
// Wide rows (the ring path, from RING_MIN_ROW_BYTES in the wrapper's plan:
// laion's 768-d f32 rows are 3 KB) come through a ring instead.  On the
// vector path a 3 KB row is 192 chunks, so a lane's 8 loads are one row:
// one row in flight per warp, and a 5-step shuffle tree per row.  The ring
// path gives each warp `stages` shared-memory stages of one row each,
// filled by cp.async.bulk copies (ring.cuh), one copy and one mbarrier per
// row, so the bytes in flight cost no registers (at 3 KB rows, 8 stages
// and 8 resident warps per SM keep ~190 KB per SM in flight).  A task's
// query row is staged in shared memory by one more bulk copy, so a lane's
// registers do not grow with D.  Lane r of the task issues the copy of its
// own row r (ids -1 arm their stage with a plain arrive), so up to `stages`
// copies leave in parallel.  The warp consumes rows in groups: a segment
// of 1 << lpr_log2 lanes (8: 4 rows at once) takes one row, each lane a
// strided set of 16-byte chunks of the row and the query, so the segment's
// reduction is 3 shuffles shared by the group's 4 rows.  Then the lanes
// that hold the ids `stages` rows further on refill the freed stages.  Each
// task drains its ring before the next: the many resident warps cover one
// warp's drain.  bf16 and int8 rows read 2 and 4 16-byte query vectors per
// row chunk, in an order rotated by lane so the 8 lanes of a quarter-warp
// hit 8 different bank groups.
//
// Timed on an H100 at (4096, 96) 768-d f32: the ring is ~4% faster than the
// vector path, and with every id distinct both stream the requested rows
// at 87-90% of the memory's rate, whatever the ring's depth.  What is left
// between such a call and its bound (each distinct row read once) is the
// ids' reuse: a call requests each row ~4 times, and L2 keeps few of them.
//
// Rows whose width is not a 16-byte multiple (bf16 D = 100), bases that are
// not 16-byte aligned, and rows too wide for a ring stage in shared memory
// take the generic path of the same kernel family: lanes stride the row
// element by element, 4 rows in flight.  The wrapper picks the path from
// shapes and alignment.
//
// int8 rows widen to f32 by a byte permute and one f32 subtraction
// (`biased_byte`), not by a conversion instruction: on sm_90 I2F issues at
// 16 per clock per SM, f32 add and FMA at 128.  At (4096, 96) x 768 cosine,
// cold, an H100 took 161.7 us with one I2F per element and 134.9 us
// without.  The floats are the same, so the outputs are too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRingWarps = 4;  // per block, on the ring path
constexpr unsigned kFull = 0xffffffffu;

// int8 -> f32 without a conversion instruction.  A signed byte v, stored as
// bits b, has b ^ 0x80 = v + 128; placed in the mantissa of 2^23 it makes
// the float 2^23 + 128 + v (bits kI8Magic | (b ^ 0x80)), and subtracting
// kI8Bias = 2^23 + 128 leaves v exactly.  The wrapper's plain mirror is
// ops/kernels/gather_dist.py::int8_bits_to_float.
constexpr unsigned kI8Magic = 0x4B000000u;
constexpr float kI8Bias = 8388736.0f;

// Byte i of u, whose bytes are already XORed with 0x80, as the float of the
// signed byte: one byte permute (the byte under 0x4B 0x00 0x00) and one add.
__device__ __forceinline__ float biased_byte(unsigned u, int i) {
  return __uint_as_float(__byte_perm(u, kI8Magic, 0x7440 | i)) - kI8Bias;
}

// Four int8 values packed in a word, as floats.
__device__ __forceinline__ float4 int8x4_to_float(int w) {
  const unsigned u = static_cast<unsigned>(w) ^ 0x80808080u;
  return make_float4(biased_byte(u, 0), biased_byte(u, 1), biased_byte(u, 2),
                     biased_byte(u, 3));
}

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f(const int8_t* p) {
  return biased_byte(*reinterpret_cast<const uint8_t*>(p) ^ 0x80u, 0);
}

// A 16-byte chunk of stored row elements as floats.
__device__ __forceinline__ void unpack(const int4& v, float (&x)[4]) {
  x[0] = __int_as_float(v.x);
  x[1] = __int_as_float(v.y);
  x[2] = __int_as_float(v.z);
  x[3] = __int_as_float(v.w);
}
__device__ __forceinline__ void unpack(const int4& v, float (&x)[8]) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<int*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const int4& v, float (&x)[16]) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = int8x4_to_float(w[i]);
    x[4 * i] = f.x;
    x[4 * i + 1] = f.y;
    x[4 * i + 2] = f.z;
    x[4 * i + 3] = f.w;
  }
}

template <bool kL2>
__device__ __forceinline__ float accumulate(float acc, float x, float qv) {
  if (kL2) {
    const float t = x - qv;
    return fmaf(t, t, acc);
  }
  return fmaf(x, qv, acc);
}

// One task: query b, ids k0 .. k0 + kn - 1; lane l holds ids[b, k0 + l]
// (-1 past the task's end) and, for int8 rows, its row's scale.
struct Task {
  int b, k0, kn, id;
  float scale;
};

template <bool kInt8>
__device__ __forceinline__ Task load_task(long long t, int nchunks, int kc,
                                          int K, const int* __restrict__ ids,
                                          const float* __restrict__ scales,
                                          int lane) {
  Task task;
  task.b = static_cast<int>(t / nchunks);
  task.k0 = static_cast<int>(t % nchunks) * kc;
  task.kn = min(kc, K - task.k0);
  task.id = lane < task.kn
                ? ids[static_cast<size_t>(task.b) * K + task.k0 + lane]
                : -1;
  task.scale = kInt8 && task.id >= 0 ? scales[task.id] : 1.0f;
  return task;
}

__device__ __forceinline__ void store_task(const Task& task, float res,
                                           bool l2, float* __restrict__ out,
                                           int K, int lane) {
  if (lane < task.kn)
    out[static_cast<size_t>(task.b) * K + task.k0 + lane] =
        task.id < 0 ? __int_as_float(0x7f800000) : (l2 ? res : 1.0f - res);
}

// Vector path.  kCpl: 16-byte chunks per lane per row (rows wider than 32
// chunks); lpr_log2: log2 of the lanes per row segment.
template <typename T, bool kInt8, bool kL2, int kCpl>
__global__ void __launch_bounds__(kThreads)
    gather_vec_kernel(const T* __restrict__ vectors,
                      const float* __restrict__ scales,
                      const float* __restrict__ q, const int* __restrict__ ids,
                      float* __restrict__ out, int B, int K, int D, int kc,
                      int nchunks, int lpr_log2) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kR = 8 / kCpl;          // row slots per lane in flight
  const int lane = threadIdx.x & 31;
  const int lpr = 1 << lpr_log2;
  const int rpi = 32 >> lpr_log2;  // rows per warp-instruction
  const int seg = lane >> lpr_log2;
  const int sl = lane & (lpr - 1);
  const int nch = D / kPer;
  const int rows_per_it = kR * rpi;
  const long long tasks = static_cast<long long>(B) * nchunks;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long t = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) >> 5;
       t < tasks; t += warps) {
    const Task task = load_task<kInt8>(t, nchunks, kc, K, ids, scales, lane);
    // this lane's query chunks, in registers
    float qv[kCpl][kPer];
    const float4* qrow =
        reinterpret_cast<const float4*>(q + static_cast<size_t>(task.b) * D);
#pragma unroll
    for (int c = 0; c < kCpl; ++c) {
      const int ch = sl + c * lpr;
#pragma unroll
      for (int v = 0; v < kPer / 4; ++v) {
        const float4 f = ch < nch ? __ldg(qrow + ch * (kPer / 4) + v)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        qv[c][4 * v] = f.x;
        qv[c][4 * v + 1] = f.y;
        qv[c][4 * v + 2] = f.z;
        qv[c][4 * v + 3] = f.w;
      }
    }
    float res = 0.0f;
    for (int it = 0; it < task.kn; it += rows_per_it) {
      int4 raw[kR][kCpl];
      float sc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int row = it + r * rpi + seg;
        const int id = __shfl_sync(kFull, task.id, row & 31);
        sc[r] = __shfl_sync(kFull, task.scale, row & 31);
        const bool live = row < task.kn && id >= 0;
        const int4* src = reinterpret_cast<const int4*>(
            vectors + static_cast<size_t>(live ? id : 0) * D);
#pragma unroll
        for (int c = 0; c < kCpl; ++c) {
          const int ch = sl + c * lpr;
          raw[r][c] = live && ch < nch ? __ldg(src + ch) : make_int4(0, 0, 0, 0);
        }
      }
      float acc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        acc[r] = 0.0f;
#pragma unroll
        for (int c = 0; c < kCpl; ++c) {
          float x[kPer];
          unpack(raw[r][c], x);
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            // one rounding, as rows.float() * scale
            const float xv = kInt8 ? __fmul_rn(x[e], sc[r]) : x[e];
            acc[r] = accumulate<kL2>(acc[r], xv, qv[c][e]);
          }
        }
      }
      // segmented reduction: every lane of a segment ends with its row's sum
      for (int o = lpr >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[r] += __shfl_xor_sync(kFull, acc[r], o);
      }
      // lane l keeps the sum of the task's row l
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int rel = lane - it - r * rpi;
        const bool mine = rel >= 0 && rel < rpi;
        const float v = __shfl_sync(kFull, acc[r], mine ? rel << lpr_log2 : 0);
        if (mine) res = v;
      }
    }
    store_task(task, res, kL2, out, K, lane);
  }
}

// Generic path: any width and alignment; lanes stride the row.
template <typename T, bool kInt8, bool kL2>
__global__ void __launch_bounds__(kThreads)
    gather_generic_kernel(const T* __restrict__ vectors,
                          const float* __restrict__ scales,
                          const float* __restrict__ q,
                          const int* __restrict__ ids, float* __restrict__ out,
                          int B, int K, int D, int kc, int nchunks) {
  constexpr int kR = 4;
  const int lane = threadIdx.x & 31;
  const long long tasks = static_cast<long long>(B) * nchunks;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long t = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) >> 5;
       t < tasks; t += warps) {
    const Task task = load_task<kInt8>(t, nchunks, kc, K, ids, scales, lane);
    const float* qr = q + static_cast<size_t>(task.b) * D;
    float res = 0.0f;
    for (int it = 0; it < task.kn; it += kR) {
      const T* rows[kR];
      bool live[kR];
      float sc[kR], acc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int id = __shfl_sync(kFull, task.id, (it + r) & 31);
        sc[r] = __shfl_sync(kFull, task.scale, (it + r) & 31);
        live[r] = it + r < task.kn && id >= 0;  // warp-uniform
        rows[r] = vectors + static_cast<size_t>(live[r] ? id : 0) * D;
        acc[r] = 0.0f;
      }
      for (int d = lane; d < D; d += 32) {
        const float qv = qr[d];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (!live[r]) continue;
          float x = load_f(rows[r] + d);
          if (kInt8) x = __fmul_rn(x, sc[r]);
          acc[r] = accumulate<kL2>(acc[r], x, qv);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[r] += __shfl_xor_sync(kFull, acc[r], o);
        if (lane == it + r) res = acc[r];
      }
    }
    store_task(task, res, kL2, out, K, lane);
  }
}

// One 16-byte row chunk against the query floats it pairs with (kQ float4s
// at qc), summed into acc.  bf16 and int8 read the query vectors from `rot`
// on, so the lanes of a quarter-warp spread over the bank groups (module
// comment); int8 scales each element by the row's `sc` first.
template <typename T, bool kInt8, bool kL2>
struct Chunk;

template <bool kL2>
struct Chunk<float, false, kL2> {
  static constexpr int kQ = 1;
  __device__ __forceinline__ static float dot(const int4& v, const float4* qc,
                                              int, float, float acc) {
    const float4 f = qc[0];
    acc = accumulate<kL2>(acc, __int_as_float(v.x), f.x);
    acc = accumulate<kL2>(acc, __int_as_float(v.y), f.y);
    acc = accumulate<kL2>(acc, __int_as_float(v.z), f.z);
    return accumulate<kL2>(acc, __int_as_float(v.w), f.w);
  }
};

template <bool kL2>
struct Chunk<__nv_bfloat16, false, kL2> {
  static constexpr int kQ = 2;
  __device__ __forceinline__ static float dot(const int4& v, const float4* qc,
                                              int rot, float, float acc) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int j = (i + rot) & 1;
      const float4 f = qc[j];
      __nv_bfloat162 h0, h1;
      *reinterpret_cast<int*>(&h0) = j ? v.z : v.x;
      *reinterpret_cast<int*>(&h1) = j ? v.w : v.y;
      const float2 a = __bfloat1622float2(h0);
      const float2 b = __bfloat1622float2(h1);
      acc = accumulate<kL2>(acc, a.x, f.x);
      acc = accumulate<kL2>(acc, a.y, f.y);
      acc = accumulate<kL2>(acc, b.x, f.z);
      acc = accumulate<kL2>(acc, b.y, f.w);
    }
    return acc;
  }
};

template <bool kL2>
struct Chunk<int8_t, true, kL2> {
  static constexpr int kQ = 4;
  __device__ __forceinline__ static float dot(const int4& v, const float4* qc,
                                              int rot, float sc, float acc) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int j = (i + rot) & 3;
      const float4 f = qc[j];
      const float4 xw =
          int8x4_to_float(j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w);
      const float fq[4] = {f.x, f.y, f.z, f.w};
      const float fx[4] = {xw.x, xw.y, xw.z, xw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // one rounding, as rows.float() * scale
        acc = accumulate<kL2>(acc, __fmul_rn(fx[e], sc), fq[e]);
      }
    }
    return acc;
  }
};

// Arms ring stage s with row `id` (a plain arrive for id -1); the calling
// lane's earlier reads of the stage are ordered before the copy.
template <typename T>
__device__ __forceinline__ void arm_row(unsigned char* ring, uint64_t* full,
                                        int s, const T* vectors, int id,
                                        int D, int row_bytes) {
  async_proxy_fence();
  if (id < 0) {
    mbar_arrive(&full[s]);
    return;
  }
  mbar_arrive_expect_tx(&full[s], row_bytes);
  bulk_load(ring + static_cast<size_t>(s) * row_bytes,
            vectors + static_cast<size_t>(id) * D, row_bytes, &full[s]);
}

// Ring path: rows of a 16-byte multiple width through a per-warp ring of
// `stages` shared-memory stages filled by bulk copies (module comment).
// Shared memory: the mbarriers of every warp (stages + 1 each: one per
// stage, one for the query), then per warp `stages` rows and the query row.
template <typename T, bool kInt8, bool kL2>
__global__ void __launch_bounds__(32 * kMaxRingWarps)
    gather_ring_kernel(const T* __restrict__ vectors,
                       const float* __restrict__ scales,
                       const float* __restrict__ q,
                       const int* __restrict__ ids, float* __restrict__ out,
                       int B, int K, int D, int kc, int nchunks, int lpr_log2,
                       int stages) {
  using C = Chunk<T, kInt8, kL2>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int q_bytes = D * 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem) + warp * (stages + 1);
  uint64_t* qbar = full + stages;
  unsigned char* ring =
      smem + header_bytes(warps * (stages + 1)) +
      static_cast<size_t>(warp) * (stages * row_bytes + q_bytes);
  unsigned char* qst = ring + static_cast<size_t>(stages) * row_bytes;
  const float4* qs = reinterpret_cast<const float4*>(qst);
  const int lpr = 1 << lpr_log2;
  const int rpg = 32 >> lpr_log2;  // rows per group
  const int seg = lane >> lpr_log2;
  const int sl = lane & (lpr - 1);
  const int rot = (sl * C::kQ) >> 3;
  const int nch = row_bytes / 16;

  for (int s = lane; s <= stages; s += 32) mbar_init(&full[s], 1);
  mbar_init_fence();
  __syncwarp();
  uint32_t phase = 0;   // bit s: parity of stage s's next completion
  uint32_t qphase = 0;  // parity of the query barrier's next completion
  const long long tasks = static_cast<long long>(B) * nchunks;
  const long long tw = static_cast<long long>(gridDim.x) * warps;
  for (long long t = static_cast<long long>(blockIdx.x) * warps + warp;
       t < tasks; t += tw) {
    const Task task = load_task<kInt8>(t, nchunks, kc, K, ids, scales, lane);
    // the previous task's reads of the query and the stages are done
    __syncwarp();
    if (lane == 0) {
      async_proxy_fence();
      mbar_arrive_expect_tx(qbar, q_bytes);
      bulk_load(qst, q + static_cast<size_t>(task.b) * D, q_bytes, qbar);
    }
    // lane r arms stage r with its own row r
    if (lane < min(stages, task.kn))
      arm_row(ring, full, lane, vectors, task.id, D, row_bytes);
    mbar_wait(qbar, qphase);
    qphase ^= 1;
    float res = 0.0f;
    for (int it = 0; it < task.kn; it += rpg) {
      const int row = it + seg;
      const int st = row % stages;
      const int id = __shfl_sync(kFull, task.id, row & 31);
      const float sc = __shfl_sync(kFull, task.scale, row & 31);
      float acc = 0.0f;
      if (row < task.kn) {
        mbar_wait(&full[st], (phase >> st) & 1);
        if (id >= 0) {
          const int4* src = reinterpret_cast<const int4*>(
              ring + static_cast<size_t>(st) * row_bytes);
#pragma unroll 4
          for (int ch = sl; ch < nch; ch += lpr)
            acc = C::dot(src[ch], qs + ch * C::kQ, rot, sc, acc);
        }
      }
      // every stage this group consumed moves on to its next phase
      for (int g = 0; g < rpg && it + g < task.kn; ++g)
        phase ^= 1u << ((it + g) % stages);
      for (int o = lpr >> 1; o > 0; o >>= 1)
        acc += __shfl_xor_sync(kFull, acc, o);
      // lane l keeps the sum of the task's row l
      const int rel = lane - it;
      const bool mine = rel >= 0 && rel < rpg;
      const float v = __shfl_sync(kFull, acc, mine ? rel << lpr_log2 : 0);
      if (mine) res = v;
      // the group's stages are free: the lanes of the rows `stages` further
      // on refill them
      __syncwarp();
      const int ahead = lane - stages;  // the row whose stage lane refills
      if (ahead >= it && ahead < it + rpg && lane < task.kn)
        arm_row(ring, full, lane % stages, vectors, task.id, D, row_bytes);
    }
    store_task(task, res, kL2, out, K, lane);
  }
}

// Persistent grid: as many blocks as are resident at once (with `smem`
// bytes of dynamic shared memory each), or fewer if the tasks need fewer.
template <typename Kernel>
int grid_for(Kernel kernel, long long tasks, int threads, int smem,
             unsigned* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           threads, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long need = (tasks + threads / 32 - 1) / (threads / 32);
  const long long resident = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<unsigned>(need < resident ? need : resident);
  return 0;
}

struct Args {
  const void* vectors;
  const float* scales;
  const float* q;
  const int* ids;
  float* out;
  int B, K, D, kc, nchunks, cpl, lpr_log2, stages, warps, smem_bytes;
  cudaStream_t stream;
};

template <typename T, bool kInt8, bool kL2, int kCpl>
int launch_vec(const Args& a) {
  auto kernel = gather_vec_kernel<T, kInt8, kL2, kCpl>;
  unsigned blocks = 0;
  const int err = grid_for(kernel, static_cast<long long>(a.B) * a.nchunks,
                           kThreads, 0, &blocks);
  if (err) return err;
  kernel<<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.vectors), a.scales, a.q, a.ids, a.out, a.B, a.K,
      a.D, a.kc, a.nchunks, a.lpr_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kInt8, bool kL2>
int launch_generic(const Args& a) {
  auto kernel = gather_generic_kernel<T, kInt8, kL2>;
  unsigned blocks = 0;
  const int err = grid_for(kernel, static_cast<long long>(a.B) * a.nchunks,
                           kThreads, 0, &blocks);
  if (err) return err;
  kernel<<<blocks, kThreads, 0, a.stream>>>(static_cast<const T*>(a.vectors),
                                            a.scales, a.q, a.ids, a.out, a.B,
                                            a.K, a.D, a.kc, a.nchunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kInt8, bool kL2>
int launch_ring(const Args& a) {
  const long long row_bytes = static_cast<long long>(a.D) * sizeof(T);
  if (row_bytes % 16 != 0 || a.lpr_log2 < 3 || a.stages < (32 >> a.lpr_log2) ||
      a.stages > 32 || a.warps < 1 || a.warps > kMaxRingWarps ||
      a.smem_bytes < header_bytes(a.warps * (a.stages + 1)) +
                         a.warps * (a.stages * row_bytes + 4LL * a.D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gather_ring_kernel<T, kInt8, kL2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 32 * a.warps;
  unsigned blocks = 0;
  const int e = grid_for(kernel, static_cast<long long>(a.B) * a.nchunks,
                         threads, a.smem_bytes, &blocks);
  if (e) return e;
  kernel<<<blocks, threads, a.smem_bytes, a.stream>>>(
      static_cast<const T*>(a.vectors), a.scales, a.q, a.ids, a.out, a.B, a.K,
      a.D, a.kc, a.nchunks, a.lpr_log2, a.stages);
  return static_cast<int>(cudaGetLastError());
}

// path 0 = generic, 1 = vector (cpl chunks per lane: a lane holds at most 32
// query floats, so f32 rows take cpl 1-8, bf16 1-4, int8 1-2), 2 = ring.
template <typename T, bool kInt8, bool kL2>
int launch(const Args& a, int path) {
  constexpr int kMaxCpl = 32 / (16 / sizeof(T));
  if (path == 0) return launch_generic<T, kInt8, kL2>(a);
  if (path == 2) return launch_ring<T, kInt8, kL2>(a);
  if (path != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.cpl == 1) return launch_vec<T, kInt8, kL2, 1>(a);
  if (a.cpl == 2) return launch_vec<T, kInt8, kL2, 2>(a);
  if constexpr (kMaxCpl >= 4) {
    if (a.cpl == 4) return launch_vec<T, kInt8, kL2, 4>(a);
  }
  if constexpr (kMaxCpl >= 8) {
    if (a.cpl == 8) return launch_vec<T, kInt8, kL2, 8>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool kInt8>
int launch_metric(const Args& a, int metric, int path) {
  if (metric == 0) return launch<T, kInt8, true>(a, path);
  if (metric == 1) return launch<T, kInt8, false>(a, path);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = int8.  metric: 0 = l2, 1 = ip/cosine.
// kc, nchunks: the launch plan's split of K into tasks of at most 32 ids
// (kc * nchunks >= K); path: 0 generic, 1 vector, 2 ring; cpl, lpr_log2:
// the vector path's row layout, lpr_log2 also the ring path's lanes per
// row; stages, warps, smem_bytes: the ring path's stages per warp, warps
// per block and dynamic shared memory per block (both unused elsewhere);
// see ops/kernels/gather_dist.py::launch_plan.  Returns cudaGetLastError()
// after the launch, or the error of a refused shared-memory attribute.
extern "C" int ohnsw_gather_dists(const void* vectors, int dtype,
                                  const void* scales, const void* q,
                                  const void* ids, void* out, int B, int K,
                                  int D, int metric, int kc, int nchunks,
                                  int path, int cpl, int lpr_log2, int stages,
                                  int warps, int smem_bytes, void* stream) {
  if (static_cast<long long>(B) * K == 0) return 0;
  if (kc < 1 || kc > 32 || static_cast<long long>(kc) * nchunks < K ||
      lpr_log2 < 0 || lpr_log2 > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{vectors,
               static_cast<const float*>(scales),
               static_cast<const float*>(q),
               static_cast<const int*>(ids),
               static_cast<float*>(out),
               B, K, D, kc, nchunks, cpl, lpr_log2, stages, warps, smem_bytes,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return launch_metric<float, false>(a, metric, path);
    case 1:
      return launch_metric<__nv_bfloat16, false>(a, metric, path);
    case 2:
      return launch_metric<int8_t, true>(a, metric, path);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
