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
// What bounds it on an H100: gathers, and their latency.  At the main-path
// shape (B = 8192 queries, E = 2 expanded nodes, deg = 32, d_pad = 128) one
// call reads 16384 slabs of 4 KB plus 256 B of meta each, about 71 MB from
// random addresses, and does 2 int ops per byte.  The design is the simple
// one: one warp per (query, expanded node), one lane per neighbour row; each
// lane reads its 128-byte row as 16-byte loads, so a warp pulls its node's
// whole slab in 8 load instructions, and the query row is a broadcast read.
// Deeper pipelining (cp.async/TMA rings) and fusing the beam merge are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void packed_score_kernel(const int* __restrict__ nodes,
                                    const int* __restrict__ meta,
                                    const int8_t* __restrict__ pay,
                                    const int8_t* __restrict__ q8,
                                    const float* __restrict__ qn,
                                    const float* __restrict__ scale,
                                    int* __restrict__ cand_ids,
                                    float* __restrict__ cand_d, int B, int E,
                                    int deg, int d_pad, int needs_norms) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(B) * E) return;  // warp-uniform
  const int b = static_cast<int>(warp / E);
  const int node = nodes[warp];
  const float s = __ldg(scale);
  const float s2 = __fmul_rn(s, s);
  const float qnb = qn[b];
  const int nvec = d_pad / 16;
  const int4* qrow = reinterpret_cast<const int4*>(q8 + static_cast<size_t>(b) * d_pad);
  const int* mrow = meta + static_cast<size_t>(node < 0 ? 0 : node) * 2 * deg;
  const float inf = __int_as_float(0x7f800000);
  for (int j = lane; j < deg; j += 32) {
    const size_t o = static_cast<size_t>(warp) * deg + j;  // [b, e*deg + j]
    const int id = node < 0 ? -1 : mrow[j];
    if (id < 0) {
      cand_ids[o] = -1;
      cand_d[o] = inf;
      continue;
    }
    const int4* prow = reinterpret_cast<const int4*>(
        pay + (static_cast<size_t>(node) * deg + j) * d_pad);
    int acc = 0;
    for (int c = 0; c < nvec; ++c) {
      const int4 x = prow[c];
      const int4 y = qrow[c];
      acc = __dp4a(x.x, y.x, acc);
      acc = __dp4a(x.y, y.y, acc);
      acc = __dp4a(x.z, y.z, acc);
      acc = __dp4a(x.w, y.w, acc);
    }
    float d;
    if (needs_norms) {
      const float t = static_cast<float>(mrow[deg + j] - 2 * acc);
      d = __fadd_rn(__fmul_rn(s2, t), qnb);
    } else {
      d = __fsub_rn(1.0f, __fmul_rn(s2, static_cast<float>(acc)));
    }
    cand_ids[o] = id;
    cand_d[o] = d;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int ohnsw_packed_score(const void* nodes, const void* meta,
                                  const void* pay, const void* q8,
                                  const void* qn, const void* scale,
                                  void* cand_ids, void* cand_d, int B, int E,
                                  int deg, int d_pad, int needs_norms,
                                  void* stream) {
  const long long warps = static_cast<long long>(B) * E;
  if (warps == 0) return 0;
  if (d_pad % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((warps * 32 + threads - 1) / threads);
  packed_score_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nodes), static_cast<const int*>(meta),
      static_cast<const int8_t*>(pay), static_cast<const int8_t*>(q8),
      static_cast<const float*>(qn), static_cast<const float*>(scale),
      static_cast<int*>(cand_ids), static_cast<float*>(cand_d), B, E, deg,
      d_pad, needs_norms);
  return static_cast<int>(cudaGetLastError());
}
