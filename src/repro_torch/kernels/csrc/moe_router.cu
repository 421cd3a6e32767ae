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
// cost bounds it.  At a prefill-sized (4096, 384, 8) it moves 6.6 MB, 2 us,
// and the instructions each warp issues per row are what the card waits on.
//
// What the design does about that: one launch does the whole route and the
// logit row never leaves registers.  A segment of SEG lanes owns a row (SEG =
// 8 or 16 for E <= 16, so four or two rows share a warp; else the whole
// warp); lane l of it holds experts l, l + SEG, ..., NPL of them, NPL a
// template parameter (instances for E up to 8, 16, 32, 64, 128, 256, 384,
// 512).  The max and the sum of expf(x - max) are shuffle reductions over the
// segment; expf and the division are the IEEE ones (no __expf, no fast math),
// so equal logits give equal probabilities and ties stay ties.  Then each lane
// sorts its own candidates ONCE, keeping its best KT = min(k, NPL) by
// (probability desc, index asc): an insertion in index order in which a
// candidate passes only strictly smaller ones, so equal probabilities keep
// index order.  Each of the k rounds is then one arg-max over the lanes'
// heads -- for a whole warp two redux instructions (the largest probability,
// then the lowest index holding it), for a segment a shuffle arg-max in which
// the lower index wins a tie -- and the winning lane pops its head.  Picks
// compare the divided probabilities' bits (as unsigned + 1, so 0 marks an
// exhausted lane), the Pallas kernel's argmax rule exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTopK = 16;   // rounds a launch may run

template <int SEG>
__device__ __forceinline__ float seg_max(float v) {
#pragma unroll
  for (int o = SEG / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int SEG>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int o = SEG / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// SEG lanes per row, NPL experts per lane, KT candidates kept per lane, at
// most KK rounds (k <= KK).
template <int SEG, int NPL, int KT, int KK>
__global__ void __launch_bounds__(kThreads)
moe_router_kernel(const float* __restrict__ logits, float* __restrict__ gates,
                  int* __restrict__ ids, int T, int E, int k,
                  long long row_stride) {
  constexpr int kRowsPerWarp = 32 / SEG;
  const int lane = threadIdx.x & 31;
  const int sl = lane % SEG;                   // lane within the row's segment
  const long long warp_id =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long row = warp_id * kRowsPerWarp + lane / SEG;
  if (SEG == 32 && row >= T) return;           // whole warps exit together
  const bool live = row < T;                   // a segment past T computes on
  const float* x =                             // the last row, writes nothing
      logits + (size_t)(live ? row : T - 1) * row_stride;

  float v[NPL];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int e = sl + SEG * j;
    v[j] = e < E ? x[e] : -INFINITY;
    m = fmaxf(m, v[j]);
  }
  m = seg_max<SEG>(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    v[j] = (sl + SEG * j) < E ? expf(v[j] - m) : 0.f;
    s += v[j];
  }
  s = seg_sum<SEG>(s);

  // this lane's best KT candidates, sorted once: key = probability bits + 1
  // (probabilities are >= +0, so the bits order as the values), 0 = none
  unsigned tk[KT];
  int ti[KT];
#pragma unroll
  for (int p = 0; p < KT; ++p) { tk[p] = 0u; ti[p] = 0x7fffffff; }
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int e = sl + SEG * j;
    const unsigned key = e < E ? __float_as_uint(v[j] / s) + 1u : 0u;
    // positions past j hold no candidate yet; a key passes only strictly
    // smaller ones, so among equal keys the lower index (inserted first)
    // stays ahead
#pragma unroll
    for (int p = (j < KT - 1 ? j : KT - 1); p >= 1; --p) {
      const bool up = tk[p - 1] < key, here = tk[p] < key;
      ti[p] = up ? ti[p - 1] : (here ? e : ti[p]);
      tk[p] = up ? tk[p - 1] : (here ? key : tk[p]);
    }
    if (tk[0] < key) { tk[0] = key; ti[0] = e; }
  }

  float my_gate = 0.f, total = 0.f;
  int my_id = 0;
#pragma unroll
  for (int t = 0; t < KK; ++t) {
    if (t >= k) break;
    unsigned best;
    int best_i;
    if (SEG == 32) {
      best = __reduce_max_sync(0xffffffffu, tk[0]);
      best_i = (int)__reduce_min_sync(0xffffffffu,
                                      tk[0] == best ? (unsigned)ti[0] : ~0u);
    } else {
      best = tk[0];
      best_i = ti[0];
#pragma unroll
      for (int o = SEG / 2; o > 0; o >>= 1) {
        const unsigned ok = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
        if (ok > best || (ok == best && oi < best_i)) {
          best = ok;
          best_i = oi;
        }
      }
    }
    if (ti[0] == best_i) {                     // this lane's head won: pop it
#pragma unroll
      for (int p = 0; p + 1 < KT; ++p) {
        tk[p] = tk[p + 1];
        ti[p] = ti[p + 1];
      }
      tk[KT - 1] = 0u;
      ti[KT - 1] = 0x7fffffff;
    }
    const float g = __uint_as_float(best - 1u);
    total += g;
    if (sl == t) { my_gate = g; my_id = best_i; }
  }
  if (live && sl < k) {
    gates[(size_t)row * k + sl] = my_gate / fmaxf(total, 1e-9f);
    ids[(size_t)row * k + sl] = my_id;
  }
}

template <int SEG, int NPL, int KK>
int launch(const float* logits, float* gates, int* ids, int T, int E, int k,
           long long row_stride, cudaStream_t stream) {
  constexpr int KT = NPL < KK ? NPL : KK;
  constexpr int rows_per_block = kThreads / SEG;
  const long long blocks =
      ((long long)T + rows_per_block - 1) / rows_per_block;
  moe_router_kernel<SEG, NPL, KT, KK>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(logits, gates, ids, T, E, k,
                                                  row_stride);
  return (int)cudaGetLastError();
}

template <int SEG, int NPL>
int launch_k(const float* logits, float* gates, int* ids, int T, int E, int k,
             long long row_stride, cudaStream_t stream) {
  if (k <= 2)
    return launch<SEG, NPL, 2>(logits, gates, ids, T, E, k, row_stride,
                               stream);
  if (k <= 4)
    return launch<SEG, NPL, 4>(logits, gates, ids, T, E, k, row_stride,
                               stream);
  if (k <= 8)
    return launch<SEG, NPL, 8>(logits, gates, ids, T, E, k, row_stride,
                               stream);
  return launch<SEG, NPL, 16>(logits, gates, ids, T, E, k, row_stride, stream);
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
#define ROUTE(SEG, NPL) \
  return launch_k<SEG, NPL>(logits, gates, ids, T, E, k, row_stride, stream)
  if (E <= 8) ROUTE(8, 1);
  if (E <= 16) ROUTE(16, 1);
  if (E <= 32) ROUTE(32, 1);
  if (E <= 64) ROUTE(32, 2);
  if (E <= 128) ROUTE(32, 4);
  if (E <= 256) ROUTE(32, 8);
  if (E <= 384) ROUTE(32, 12);
  ROUTE(32, 16);
#undef ROUTE
}
