// Gather-distance kernel (K2): d[b,k] = dist(q[b], vectors[ids[b,k]]).
//
// Replaces the TPU kernel ocaml_hnsw_tpu/ops/pallas/gather_dist.py::gather_l2
// and takes the whole contract of ocaml_hnsw_tpu/ops/distance.py::dists_to_ids,
// which the JAX engine runs in its place: rows stored as f32, bf16 or int8
// (per-row dequant scale), l2 = sum (x - q)^2 or ip/cosine = 1 - x.q, f32
// accumulation, and +inf where the id is -1.
//
// What bounds it on an H100: scattered row fetches.  Each (b, k) reads one
// D-wide row at a random address (512 B at D=128 f32) plus the query row,
// which stays in L1/L2 across the K ids of a query; the arithmetic is 2 flops
// per byte read, far below the card's compute line.  The design is the simple
// one: one warp per (b, k), lanes stride the row (neighbouring lanes read
// neighbouring addresses, so each row is fetched in full 128-byte segments),
// and a shuffle reduction.  A later version can keep more rows in flight per
// warp (cp.async) to hide latency.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f(const int8_t* p) {
  return static_cast<float>(*p);
}

template <typename T, bool kInt8, bool kL2>
__global__ void gather_dists_kernel(const T* __restrict__ vectors,
                                    const float* __restrict__ scales,
                                    const float* __restrict__ q,
                                    const int* __restrict__ ids,
                                    float* __restrict__ out, int B, int K,
                                    int D) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(B) * K) return;  // warp-uniform
  const int b = static_cast<int>(warp / K);
  const int id = ids[warp];
  if (id < 0) {  // warp-uniform
    if (lane == 0) out[warp] = __int_as_float(0x7f800000);  // +inf
    return;
  }
  const T* row = vectors + static_cast<size_t>(id) * D;
  const float* qr = q + static_cast<size_t>(b) * D;
  const float s = kInt8 ? scales[id] : 1.0f;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) {
    float x = load_f(row + d);
    if (kInt8) x = __fmul_rn(x, s);  // one rounding, as rows.float() * scale
    const float qv = qr[d];
    if (kL2) {
      const float t = x - qv;
      acc = fmaf(t, t, acc);
    } else {
      acc = fmaf(x, qv, acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[warp] = kL2 ? acc : 1.0f - acc;
}

template <typename T, bool kInt8>
void launch(const void* vectors, const float* scales, const float* q,
            const int* ids, float* out, int B, int K, int D, int metric,
            unsigned blocks, int threads, cudaStream_t stream) {
  const T* v = static_cast<const T*>(vectors);
  if (metric == 0) {
    gather_dists_kernel<T, kInt8, true>
        <<<blocks, threads, 0, stream>>>(v, scales, q, ids, out, B, K, D);
  } else {
    gather_dists_kernel<T, kInt8, false>
        <<<blocks, threads, 0, stream>>>(v, scales, q, ids, out, B, K, D);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = int8.  metric: 0 = l2, 1 = ip/cosine.
// Returns cudaGetLastError() after the launch.
extern "C" int ohnsw_gather_dists(const void* vectors, int dtype,
                                  const void* scales, const void* q,
                                  const void* ids, void* out, int B, int K,
                                  int D, int metric, void* stream) {
  const long long warps = static_cast<long long>(B) * K;
  if (warps == 0) return 0;
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((warps * 32 + threads - 1) / threads);
  const float* s = static_cast<const float*>(scales);
  const float* qq = static_cast<const float*>(q);
  const int* ii = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float, false>(vectors, s, qq, ii, o, B, K, D, metric, blocks,
                           threads, st);
      break;
    case 1:
      launch<__nv_bfloat16, false>(vectors, s, qq, ii, o, B, K, D, metric,
                                   blocks, threads, st);
      break;
    case 2:
      launch<int8_t, true>(vectors, s, qq, ii, o, B, K, D, metric, blocks,
                           threads, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
