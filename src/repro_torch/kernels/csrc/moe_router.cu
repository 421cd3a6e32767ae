// Fused MoE router on Hopper (sm_90a): per token row of f32 logits (T, E),
//   probs = softmax(logits)                      (max subtracted, expf, / sum)
//   k rounds: g = max(remaining), a = lowest index holding g, remaining[a] = -1
//   gates = g / max(sum(g), 1e-9),  ids = a      -> gates (T, k) f32, ids (T, k) i32
//
// Replaces the TPU kernel src/repro/kernels/moe_router.py::moe_router (body
// _router_kernel), which the JAX package reaches from route() in
// models/moe.py through kernels/ops.py::moe_router_diff.
//
// What bounds it on an H100: each row reads E logits and writes k gates and k
// ids, (4 E + 8 k) bytes, and does O(E k) compares -- far below a byte per
// operation of any unit.  At the decode path's shape (T = 8 slots, E = 8,
// k = 2) one call moves 384 bytes (0.1 ns at 3.35 TB/s): the launch's fixed
// cost bounds it.  At a prefill-sized (4096, 384, 8) it moves 6.6 MB, 2 us.
//
// What the design does about that: one launch does the whole route, and the
// logit row never leaves registers.  The TPU kernel kept a (blk_t, E) panel in
// VMEM and reduced along lanes; here one warp owns one token row (8 rows per
// 256-thread block, so a ragged T needs no padding: the last block's extra
// warps exit).  Lane l holds experts l, l + 32, ..., ceil(E / 32) of them, in
// a register array whose size is a template parameter (instances for E up to
// 32, 64, 128, 256, 384, 512).  The max and the sum of expf(x - max) are
// warp-shuffle reductions; each top-k round is a shuffle arg-max over (value,
// index) pairs in which the lower index wins a tie, so the ids follow the
// Pallas kernel's argmax rule exactly.  expf and the division are the IEEE
// ones (no __expf, no fast math), so the probabilities are those of the plain
// PyTorch version to an ulp or two of the sum's order, and equal logits give
// equal probabilities: ties stay ties.  Lanes past E hold -2, below the -1
// that marks a chosen expert, so they are never chosen (the wrapper asks
// k <= E).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;      // token rows per block
constexpr int kMaxTopK = 16;   // k of the register arrays that hold the picks

template <int NPL>
__global__ void moe_router_kernel(const float* __restrict__ logits,
                                  float* __restrict__ gates,
                                  int* __restrict__ ids, int T, int E, int k,
                                  long long row_stride) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;                       // whole warps exit together
  const float* x = logits + (size_t)row * row_stride;

  float v[NPL];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? x[e] : -INFINITY;
    m = fmaxf(m, v[j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));

  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    v[j] = (lane + 32 * j) < E ? expf(v[j] - m) : 0.f;
    s += v[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
  for (int j = 0; j < NPL; ++j)
    v[j] = (lane + 32 * j) < E ? v[j] / s : -2.f;

  float pick_v[kMaxTopK];
  int pick_i[kMaxTopK];
  float total = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxTopK; ++t) {
    if (t >= k) break;
    // this lane's best: indices rise with j, so only a strictly larger value
    // replaces the held one
    float bv = v[0];
    int bi = lane;
#pragma unroll
    for (int j = 1; j < NPL; ++j)
      if (v[j] > bv) { bv = v[j]; bi = lane + 32 * j; }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      if (lane + 32 * j == bi) v[j] = -1.f;
    pick_v[t] = bv;
    pick_i[t] = bi;
    total += bv;
  }
  const float denom = fmaxf(total, 1e-9f);
#pragma unroll
  for (int t = 0; t < kMaxTopK; ++t) {
    if (t >= k) break;
    if (lane == t) {
      gates[(size_t)row * k + t] = pick_v[t] / denom;
      ids[(size_t)row * k + t] = pick_i[t];
    }
  }
}

template <int NPL>
int launch(const float* logits, float* gates, int* ids, int T, int E, int k,
           long long row_stride, cudaStream_t stream) {
  const int blocks = (T + kWarps - 1) / kWarps;
  moe_router_kernel<NPL><<<blocks, 32 * kWarps, 0, stream>>>(
      logits, gates, ids, T, E, k, row_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// logits (T, E) f32 with row stride `row_stride` (unit expert stride), gates
// (T, k) f32 and ids (T, k) i32 contiguous, all on the device.  1 <= E <= 512,
// 1 <= k <= min(E, 16).  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int repro_moe_router_f32(const float* logits, float* gates,
                                    int* ids, int T, int E, int k,
                                    long long row_stride,
                                    cudaStream_t stream) {
  if (T <= 0 || E <= 0 || E > 512 || k <= 0 || k > kMaxTopK || k > E)
    return (int)cudaErrorInvalidValue;
  if (E <= 32) return launch<1>(logits, gates, ids, T, E, k, row_stride, stream);
  if (E <= 64) return launch<2>(logits, gates, ids, T, E, k, row_stride, stream);
  if (E <= 128) return launch<4>(logits, gates, ids, T, E, k, row_stride, stream);
  if (E <= 256) return launch<8>(logits, gates, ids, T, E, k, row_stride, stream);
  if (E <= 384) return launch<12>(logits, gates, ids, T, E, k, row_stride, stream);
  return launch<16>(logits, gates, ids, T, E, k, row_stride, stream);
}
