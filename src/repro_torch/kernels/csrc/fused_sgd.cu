// Eq. 5 local SGD on Hopper (sm_90a): `steps` SGD steps of the simulation
// plane's 3-layer ReLU MLP on each gathered worker row of the flat buffer.
//
// Replaces the TPU kernel src/repro/kernels/fused_sgd.py::fused_sgd (body
// _make_kernel).  Numerics follow the plain version, local_sgd_flat_fused:
// the same forward, the closed-form cross-entropy backward
// dz = (softmax(logits) - onehot) / batch, every gradient taken from the
// weights as they were BEFORE the step, and the update w - (active * lr) * g,
// so a row with active = 0 leaves bit-identical.  with_losses = 0 drops the
// log-sum-exp chain and writes zero losses; with_losses = 1 reports, for every
// row (inactive ones too), the mean over steps of the batch-mean NLL.
//
// What bounds it on an H100: at the simulation plane's defaults (P = 6,922,
// batch 32, dim 32, hidden 64, 10 classes, 2 steps) a row costs ~2.3 MFLOP
// and k = 100 rows ~0.24 GFLOP (~3.5 us at 67 TFLOP/s f32) over ~6 MB of rows
// and minibatches (~1.8 us at 3.35 TB/s).  A launch's fixed cost is of the
// same size, so latency, not the card's rates, bounds it: a row's step is a
// chain of six dependent products.
//
// What the design does about that:
// - The row stays in shared memory for all steps (the TPU kernel keeps it in
//   VMEM): it is read once from `buf` (asynchronous copies, all in flight at
//   once) and written once to `out`.  Each weight matrix sits at a
//   16-byte-aligned offset with a row stride of 4 (mod 8) floats, so float4
//   reads of neighbouring rows fall on distinct banks.  Two steps' minibatches
//   sit beside it (the next step's is copied in while this one runs, so the
//   number of steps is not bounded) and one step's activations of the whole
//   batch (72.6 KB at the defaults: three CTAs an SM).
// - One thread-block cluster of C = min(4, batch) CTAs trains a row.  CTA r
//   runs the forward and the per-sample backward (dz, dh2, dh1) of samples
//   [r B / C, (r + 1) B / C) and pushes those activations into every CTA's
//   shared memory (distributed shared memory).  After one cluster barrier each
//   CTA holds the whole batch and computes the gradient of its own rows of
//   w1, w2 and w3 (rows r n / C .. (r + 1) n / C - 1; the owner of a
//   weight's row 0 also sums its bias in the same pass), each summed over the
//   samples in order b = 0 .. B-1 -- the ranks' samples in rank order, no
//   atomics -- updates them and pushes them to every CTA (the last step
//   writes them to `out` instead); a second cluster barrier ends the step.
//   So a row's bits depend on its own inputs only -- never on k, on C or on
//   scheduling -- and five barriers (three block, two cluster) order a step.
// - Register tiles: a thread computes two neighbouring outputs of a forward
//   layer, two outputs of dh1 that share their dh2 reads, or a 2 x 4 tile of
//   a weight gradient from float4 reads; one warp per sample runs the
//   logits, the softmax/CE with shuffles and dh2.  No division by a runtime
//   width sits in an inner loop.
// - IEEE f32 fmaf throughout, the update w - s g included (no TF32, no tensor
//   cores); expf, logf and the divisions are the IEEE ones.
// An MLP whose row, two minibatches and one step's activations do not fit the
// 227 KB a block can have is refused (repro_fused_sgd_smem_bytes says what a
// shape needs).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 4;    // CTAs per row (a portable cluster: <= 8)
constexpr int kThreads = 256;
constexpr long long kSmemLimit = 232448;        // dynamic smem of one block

// Column offsets of the six leaves in a flat row (jax's sorted-key order
// b1, b2, b3, w1, w2, w3) and the layer widths: w1 (d, h), w2 (h, g), w3 (g, c).
struct Layout {
  int off_b1, off_b2, off_b3, off_w1, off_w2, off_w3;
  int d, h, g, c;
};

template <typename I>
__host__ __device__ constexpr I pad4(I n) { return (n + 3) & ~I(3); }
// Row stride of a weight matrix: a multiple of 4 floats with (stride / 4) odd,
// so a quarter-warp's float4 reads of 8 consecutive rows hit 8 bank groups.
template <typename I>
__host__ __device__ constexpr I wld(I n) {
  return (pad4(n) / 4) % 2 ? pad4(n) : pad4(n) + 4;
}

// Float offsets into dynamic shared memory (each a multiple of 4) and strides:
// int on the card, 64-bit on the host, which checks the fit before any int
// arithmetic.
template <typename I>
struct Smem {
  I w1, w2, w3, b1, b2, b3, x, y, h1, h2, dz, dh2, dh1, nll, end;
  I ldw1, ldw2, ldw3, ldh, ldg, ldc, xs, ys;
};

template <typename I>
__host__ __device__ inline Smem<I> smem_layout(I B, I D, I H, I G, I C) {
  Smem<I> s;
  s.ldw1 = wld(H); s.ldw2 = wld(G); s.ldw3 = wld(C);
  s.ldh = pad4(H); s.ldg = pad4(G); s.ldc = pad4(C);
  s.xs = pad4(B * D); s.ys = pad4(B);
  I o = 0;
  s.w1 = o; o += D * s.ldw1;
  s.w2 = o; o += H * s.ldw2;
  s.w3 = o; o += G * s.ldw3;
  s.b1 = o; o += pad4(H);
  s.b2 = o; o += pad4(G);
  s.b3 = o; o += pad4(C);
  s.x = o; o += 2 * s.xs;               // two steps' minibatches, (B, D) each
  s.y = o; o += 2 * s.ys;               // and labels (int)
  s.h1 = o; o += B * s.ldh;             // relu(z1), the whole batch
  s.h2 = o; o += B * s.ldg;             // relu(z2)
  s.dz = o; o += B * s.ldc;             // logits, then d(loss)/d(logits)
  s.dh2 = o; o += B * s.ldg;
  s.dh1 = o; o += B * s.ldh;
  s.nll = o; o += pad4(B);              // per-sample NLL (read on rank 0)
  s.end = o;
  return s;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float a, float4 b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// sum_j a[j] b[j] over 16-byte-aligned rows, as four interleaved partial
// sums combined at the end, then the tail in order.
__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int j = 0;
#pragma unroll 8
  for (; j + 4 <= n; j += 4) {
    const float4 u = ld4(a + j), v = ld4(b + j);
    acc.x = fmaf(u.x, v.x, acc.x);
    acc.y = fmaf(u.y, v.y, acc.y);
    acc.z = fmaf(u.z, v.z, acc.z);
    acc.w = fmaf(u.w, v.w, acc.w);
  }
  float s = (acc.x + acc.y) + (acc.z + acc.w);
  for (; j < n; ++j) s = fmaf(a[j], b[j], s);
  return s;
}

// Two dots of a against b0 and b1, each as dot() sums it.
__device__ __forceinline__ void dot2(const float* a, const float* b0,
                                     const float* b1, int n, float& r0,
                                     float& r1) {
  float4 p = make_float4(0.f, 0.f, 0.f, 0.f), q = p;
  int j = 0;
#pragma unroll 8
  for (; j + 4 <= n; j += 4) {
    const float4 u = ld4(a + j), v = ld4(b0 + j), w = ld4(b1 + j);
    p.x = fmaf(u.x, v.x, p.x); q.x = fmaf(u.x, w.x, q.x);
    p.y = fmaf(u.y, v.y, p.y); q.y = fmaf(u.y, w.y, q.y);
    p.z = fmaf(u.z, v.z, p.z); q.z = fmaf(u.z, w.z, q.z);
    p.w = fmaf(u.w, v.w, p.w); q.w = fmaf(u.w, w.w, q.w);
  }
  r0 = (p.x + p.y) + (p.z + p.w);
  r1 = (q.x + q.y) + (q.z + q.w);
  for (; j < n; ++j) {
    r0 = fmaf(a[j], b0[j], r0);
    r1 = fmaf(a[j], b1[j], r1);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The cluster's view of shared memory: this CTA's base and every CTA's.
struct Peers {
  float* base[kMaxCluster];
  int n, rank;

  // v at float offset `off` of every CTA's shared memory (this one's through
  // the local pointer, the others' through distributed shared memory)
  __device__ __forceinline__ void put(float* local, int off, float v) const {
    local[off] = v;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n && r != rank) base[r][off] = v;
  }
  __device__ __forceinline__ void put2(float* local, int off, float2 v) const {
    *reinterpret_cast<float2*>(local + off) = v;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n && r != rank) *reinterpret_cast<float2*>(base[r] + off) = v;
  }
  __device__ __forceinline__ void put4(float* local, int off, float4 v) const {
    *reinterpret_cast<float4*>(local + off) = v;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n && r != rank) *reinterpret_cast<float4*>(base[r] + off) = v;
  }
};

// 4-byte asynchronous copy global -> shared (the row's leaves are only 8-byte
// aligned): every load of the row is in flight at once.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// Copy an (rows, n) leaf of the flat row into a (rows, ld) smem matrix whose
// padding columns are 0.
__device__ void load_leaf(float* dst, const float* src, int rows, int n,
                          int ld, int tid) {
  for (int i = tid; i < rows * ld; i += kThreads) {
    const int q = i / ld, j = i - q * ld;
    if (j < n) cp_async4(dst + i, src + q * n + j);
    else dst[i] = 0.f;
  }
}

// One group of this CTA's gradient jobs: rows [lo, hi) of a weight, two
// rows by four columns a job, each output a^T d summed over the batch in
// order; the CTA that owns row 0 also sums the layer's bias gradient (d over
// the batch, in order) in the same pass.
struct Grad {
  const float* a;   // (B, lda) activations: column q feeds weight row q
  int lda;
  const float* d;   // (B, ldd) deltas
  int ldd;
  int w, ldw, n;    // the weight's smem offset, stride and real column count
  int lo, hi;       // this CTA's weight rows
  int b;            // the bias's smem offset
  int off_w, off_b; // both leaves' offsets in the flat row

  __device__ int chunks() const { return pad4(n) / 4; }
  __device__ int jobs() const { return (hi - lo + 1) / 2 * chunks(); }
};

// The new values v[0..3] of columns c.. of a leaf (smem offset `at`, flat
// offset `flat`): to every CTA's copy of the row, or on the last step to dst.
__device__ __forceinline__ void store_new(const Peers& peers, float* sm,
                                          float* dst, bool last, int at,
                                          size_t flat, int c, int n,
                                          float4 v4) {
  const float v[4] = {v4.x, v4.y, v4.z, v4.w};
  if (last) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < n) dst[flat + c + e] = v[e];
  } else if (c + 4 <= n) {
    peers.put4(sm, at + c, v4);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < n) peers.put(sm, at + c + e, v[e]);
  }
}

// w - s g, one rounding per output
__device__ __forceinline__ float4 sgd(float4 w, float s, float4 g) {
  return make_float4(fmaf(-s, g.x, w.x), fmaf(-s, g.y, w.y),
                     fmaf(-s, g.z, w.z), fmaf(-s, g.w, w.w));
}

// Job jj of group gr: the gradients, the update scaled by s_lr and the new
// values out.
__device__ __forceinline__ void grad_job(const Grad& gr, int jj, int B,
                                         float s_lr, bool last, float* sm,
                                         const Peers& peers, float* dst) {
  const int nc = gr.chunks(), pi = jj / nc, c = 4 * (jj - pi * nc);
  const int q0 = gr.lo + 2 * pi;
  const bool two = q0 + 1 < gr.hi, bias = q0 == 0;
  const int q1 = two ? q0 + 1 : q0;
  float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0, gb = g0;
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const float4 dv = ld4(gr.d + b * gr.ldd + c);
    fma4(gr.a[b * gr.lda + q0], dv, g0);
    fma4(gr.a[b * gr.lda + q1], dv, g1);
    if (bias) {
      gb.x += dv.x; gb.y += dv.y; gb.z += dv.z; gb.w += dv.w;
    }
  }
  store_new(peers, sm, dst, last, gr.w + q0 * gr.ldw,
            gr.off_w + (size_t)q0 * gr.n, c, gr.n,
            sgd(ld4(sm + gr.w + q0 * gr.ldw + c), s_lr, g0));
  if (two)
    store_new(peers, sm, dst, last, gr.w + q1 * gr.ldw,
              gr.off_w + (size_t)q1 * gr.n, c, gr.n,
              sgd(ld4(sm + gr.w + q1 * gr.ldw + c), s_lr, g1));
  if (bias)
    store_new(peers, sm, dst, last, gr.b, gr.off_b, c, gr.n,
              sgd(ld4(sm + gr.b + c), s_lr, gb));
}

__global__ void __launch_bounds__(kThreads, 3)
fused_sgd_kernel(const float* __restrict__ buf, const float* __restrict__ xb,
                 const int* __restrict__ yb, const float* __restrict__ active,
                 float lr, float* __restrict__ out, float* __restrict__ loss,
                 int P, Layout L, int steps, int B, int with_losses) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int D = L.d, H = L.h, G = L.g, NC = L.c;
  const Smem<int> S = smem_layout(B, D, H, G, NC);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Peers peers;
  peers.n = (int)cluster.num_blocks();
  peers.rank = (int)cluster.block_rank();
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    peers.base[r] = r < peers.n ? cluster.map_shared_rank(sm, r) : sm;
  const int C = peers.n, rank = peers.rank;
  const int row = blockIdx.x / C;
  const float s_lr = active[row] * lr;     // as the plain version rounds it

  // step t's minibatch and labels into buffer t % 2
  auto load_step = [&](int t) {
    const size_t at = (size_t)row * steps + t;
    load_leaf(sm + S.x + (t & 1) * S.xs, xb + at * B * D, 1, B * D, B * D,
              tid);
    load_leaf(sm + S.y + (t & 1) * S.ys,
              reinterpret_cast<const float*>(yb) + at * B, 1, B, B, tid);
  };

  // ---- the row, the first two minibatches, zeroed activations -------------
  const float* src = buf + (size_t)row * P;
  load_leaf(sm + S.w1, src + L.off_w1, D, H, S.ldw1, tid);
  load_leaf(sm + S.w2, src + L.off_w2, H, G, S.ldw2, tid);
  load_leaf(sm + S.w3, src + L.off_w3, G, NC, S.ldw3, tid);
  load_leaf(sm + S.b1, src + L.off_b1, 1, H, pad4(H), tid);
  load_leaf(sm + S.b2, src + L.off_b2, 1, G, pad4(G), tid);
  load_leaf(sm + S.b3, src + L.off_b3, 1, NC, pad4(NC), tid);
  load_step(0);
  if (steps > 1) load_step(1);
  for (int i = S.h1 + 4 * tid; i < S.end; i += 4 * kThreads)
    *reinterpret_cast<float4*>(sm + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the row is in, and every CTA of the cluster has started and zeroed its
  // activations before any other pushes into them
  cluster.sync();

  const int s0 = rank * B / C, s1 = (rank + 1) * B / C;   // this CTA's samples
  const int nown = s1 - s0;
  // this CTA's slice of the parameters: rows of w1, w2 and w3 (gradient jobs
  // in the order w2, w1, w3); the owner of each weight's row 0 owns its bias
  const int d_lo = rank * D / C, d_hi = (rank + 1) * D / C;
  const int h_lo = rank * H / C, h_hi = (rank + 1) * H / C;
  const int g_lo = rank * G / C, g_hi = (rank + 1) * G / C;
  float* dst = out + (size_t)row * P;
  float loss_sum = 0.f;       // rank 0, thread 0: the steps' batch means

  for (int t = 0; t < steps; ++t) {
    const float* x = sm + S.x + (t & 1) * S.xs;
    const int* y = reinterpret_cast<const int*>(sm + S.y + (t & 1) * S.ys);
    const bool last = t + 1 == steps;
    // step t + 1's minibatch goes where step t - 1's was (free since the
    // barrier that ended step t - 1); it is waited for before step t ends
    if (t >= 1 && !last) load_step(t + 1);

    // h1 = relu(x @ w1 + b1) on this CTA's samples, two columns a thread,
    // pushed to every CTA
    {
      const int nc = pad4(H) / 2;
      for (int job = tid; job < nown * nc; job += kThreads) {
        const int si = job / nc, c = 2 * (job - si * nc), s = s0 + si;
        float2 acc = make_float2(0.f, 0.f);
        const float* xs = x + s * D;
#pragma unroll 8
        for (int q = 0; q < D; ++q) {
          const float2 w = ld2(sm + S.w1 + q * S.ldw1 + c);
          acc.x = fmaf(xs[q], w.x, acc.x);
          acc.y = fmaf(xs[q], w.y, acc.y);
        }
        const float2 b = ld2(sm + S.b1 + c);
        peers.put2(sm, S.h1 + s * S.ldh + c,
                   make_float2(fmaxf(acc.x + b.x, 0.f),
                               fmaxf(acc.y + b.y, 0.f)));
      }
    }
    __syncthreads();
    // h2 = relu(h1 @ w2 + b2)
    {
      const int nc = pad4(G) / 2;
      for (int job = tid; job < nown * nc; job += kThreads) {
        const int si = job / nc, c = 2 * (job - si * nc), s = s0 + si;
        float2 acc = make_float2(0.f, 0.f);
        const float* hs = sm + S.h1 + s * S.ldh;
#pragma unroll 8
        for (int q = 0; q < H; ++q) {
          const float2 w = ld2(sm + S.w2 + q * S.ldw2 + c);
          acc.x = fmaf(hs[q], w.x, acc.x);
          acc.y = fmaf(hs[q], w.y, acc.y);
        }
        const float2 b = ld2(sm + S.b2 + c);
        peers.put2(sm, S.h2 + s * S.ldg + c,
                   make_float2(fmaxf(acc.x + b.x, 0.f),
                               fmaxf(acc.y + b.y, 0.f)));
      }
    }
    __syncthreads();
    // one warp per sample: logits = h2 @ w3 + b3, softmax / CE, dz, then
    // dh2 = dz @ w3^T * (z2 > 0)
    for (int s = s0 + warp; s < s1; s += kThreads / 32) {
      const float* hs = sm + S.h2 + s * S.ldg;
      float* lg = sm + S.dz + s * S.ldc;
      float m = -INFINITY;
      for (int j = lane; j < NC; j += 32) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        int q = 0;
#pragma unroll 4
        for (; q + 4 <= G; q += 4) {
          acc.x = fmaf(hs[q], sm[S.w3 + q * S.ldw3 + j], acc.x);
          acc.y = fmaf(hs[q + 1], sm[S.w3 + (q + 1) * S.ldw3 + j], acc.y);
          acc.z = fmaf(hs[q + 2], sm[S.w3 + (q + 2) * S.ldw3 + j], acc.z);
          acc.w = fmaf(hs[q + 3], sm[S.w3 + (q + 3) * S.ldw3 + j], acc.w);
        }
        float l = (acc.x + acc.y) + (acc.z + acc.w);
        for (; q < G; ++q) l = fmaf(hs[q], sm[S.w3 + q * S.ldw3 + j], l);
        l += sm[S.b3 + j];
        lg[j] = l;
        m = fmaxf(m, l);
      }
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < NC; j += 32) sum += expf(lg[j] - m);
      sum = warp_sum(sum);
      const int yl = y[s];
      float nll = 0.f;
      if (with_losses) {
        const float lse = logf(sum);
        for (int j = lane; j < NC; j += 32) {
          const float logp = (lg[j] - m) - lse;
          const float onehot = j == yl ? 1.f : 0.f;
          if (j == yl) nll = -logp;
          peers.put(sm, S.dz + s * S.ldc + j,
                    (expf(logp) - onehot) / (float)B);
        }
        nll = warp_sum(nll);
        if (lane == 0) (rank == 0 ? sm : peers.base[0])[S.nll + s] = nll;
      } else {
        for (int j = lane; j < NC; j += 32) {
          const float onehot = j == yl ? 1.f : 0.f;
          peers.put(sm, S.dz + s * S.ldc + j,
                    (expf(lg[j] - m) / sum - onehot) / (float)B);
        }
      }
      __syncwarp();
      for (int q = lane; q < G; q += 32) {
        const float acc = dot(lg, sm + S.w3 + q * S.ldw3, NC);
        peers.put(sm, S.dh2 + s * S.ldg + q, hs[q] > 0.f ? acc : 0.f);
      }
    }
    __syncthreads();
    // dh1 = dh2 @ w2^T * (z1 > 0), outputs q and q + ceil(H / 2) on one
    // thread sharing dh2's reads (neighbouring lanes read neighbouring rows)
    {
      const int nq = (H + 1) / 2;
      for (int job = tid; job < nown * nq; job += kThreads) {
        const int si = job / nq, q0 = job - si * nq, s = s0 + si;
        const bool two = q0 + nq < H;
        const int q1 = two ? q0 + nq : q0;
        float a0, a1;
        dot2(sm + S.dh2 + s * S.ldg, sm + S.w2 + q0 * S.ldw2,
                 sm + S.w2 + q1 * S.ldw2, G, a0, a1);
        const float* h1s = sm + S.h1 + s * S.ldh;
        peers.put(sm, S.dh1 + s * S.ldh + q0, h1s[q0] > 0.f ? a0 : 0.f);
        if (two)
          peers.put(sm, S.dh1 + s * S.ldh + q1, h1s[q1] > 0.f ? a1 : 0.f);
      }
    }
    // the whole batch's activations are in every CTA, and every read of this
    // step's weights is done
    cluster.sync();

    // this CTA's slice of the parameters: gradients over b = 0 .. B-1 in
    // order, the update, and its copy to every CTA (or, last step, to out)
    if (with_losses && rank == 0 && tid == 0) {
      float tot = 0.f;
      for (int b = 0; b < B; ++b) tot += sm[S.nll + b];
      loss_sum += tot / (float)B;
    }
    // the three groups share one job index space, job j on thread j % 256
    int base = 0;
#pragma unroll
    for (int gi = 0; gi < 3; ++gi) {
      const Grad gr =
          gi == 0 ? Grad{sm + S.h1, S.ldh, sm + S.dh2, S.ldg, S.w2, S.ldw2, G,
                         h_lo, h_hi, S.b2, L.off_w2, L.off_b2}
        : gi == 1 ? Grad{x, D, sm + S.dh1, S.ldh, S.w1, S.ldw1, H, d_lo, d_hi,
                         S.b1, L.off_w1, L.off_b1}
                  : Grad{sm + S.h2, S.ldg, sm + S.dz, S.ldc, S.w3, S.ldw3, NC,
                         g_lo, g_hi, S.b3, L.off_w3, L.off_b3};
      const int nj = gr.jobs();
      for (int j = base + ((tid - base) % kThreads + kThreads) % kThreads;
           j < base + nj; j += kThreads)
        grad_job(gr, j - base, B, s_lr, last, sm, peers, dst);
      base += nj;
    }
    // the updated row and the next minibatch are in every CTA; no CTA reads
    // this step's activations any more (after the last step nothing is read
    // remotely, so the CTAs may exit)
    if (!last) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      cluster.sync();
    }
  }
  if (rank == 0 && tid == 0)
    loss[row] = with_losses ? loss_sum / (float)steps : 0.f;
}

// Lets the kernel use the whole opt-in shared memory, once per device (at
// most 64 devices).
cudaError_t configure() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ULL << dev;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(fused_sgd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemLimit);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs for an MLP of widths
// d-h-g-c at this batch (any number of steps); the kernel takes the shape iff
// this is at most 232,448.
extern "C" long long repro_fused_sgd_smem_bytes(int batch, int d, int h,
                                                int g, int c) {
  return 4 * smem_layout<long long>(batch, d, h, g, c).end;
}

// buf (k, P) f32 rows; xb (k, steps, batch, d) f32; yb (k, steps, batch) i32;
// active (k,) f32 (a row's update scale is active * lr); out (k, P) f32; loss
// (k,) f32: contiguous device arrays.  layout: 10 host ints, the Layout
// fields in order.  Launches on `stream` and returns the launch's error
// (0 = launched).
extern "C" int repro_fused_sgd_f32(const float* buf, const float* xb,
                                   const int* yb, const float* active,
                                   float lr, float* out, float* loss, int k,
                                   int P, const int* layout, int steps,
                                   int batch, int with_losses,
                                   cudaStream_t stream) {
  const Layout L{layout[0], layout[1], layout[2], layout[3], layout[4],
                 layout[5], layout[6], layout[7], layout[8], layout[9]};
  if (k <= 0 || P <= 0 || steps <= 0 || batch <= 0 || L.d <= 0 || L.h <= 0
      || L.g <= 0 || L.c <= 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = repro_fused_sgd_smem_bytes(batch, L.d, L.h, L.g,
                                                    L.c);
  if (smem > kSmemLimit || (long long)k * kMaxCluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  const int cluster = batch < kMaxCluster ? batch : kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)k * (unsigned)cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fused_sgd_kernel, buf, xb, yb, active, lr, out,
                         loss, P, L, steps, batch, with_losses);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
