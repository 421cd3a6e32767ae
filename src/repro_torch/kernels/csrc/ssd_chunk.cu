// Mamba-2 SSD intra-chunk dual form on Hopper (sm_90a).
//
//   y[g, h, q, :] = sum_{t <= q} (C[g, q] . B[g, t])
//                   * exp(la[g, h, q] - la[g, h, t]) * xbar[g, h, t, :]
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py::ssd_chunk (body
// _ssd_chunk_kernel), which the JAX package reaches from models/ssm.py through
// kernels/ops.py::ssd_chunk_diff.  It computes what _ssd_chunk_kernel
// computes, not its block schedule: inputs and sums in f32, the causal mask
// t <= q applied BEFORE exp (for t > q the exponent la_q - la_t is positive
// and at a long chunk with large dt passes f32's exp limit of ~88, so it is
// never evaluated), output (G, H, Q, P) f32.
//
// What bounds it on an H100: at the mamba2-2.7b path's shape (G = batch *
// n_chunks = 8, H = 80, Q = 256, N = 128, P = 64) one call moves 86.6 MB
// (B, C, la and xbar read once, y written once: 25.9 us at 3.35 TB/s) and
// needs 2.76 GFLOP over the 32,896 causal (q, t) pairs of each chunk (2N for
// the score, H * 2P for the products): 41.2 us at 67 TFLOP/s on the f32 CUDA
// cores.  So the f32 FMA rate bounds it.  Every product here is IEEE f32
// fmaf on the CUDA cores -- no TF32, as the TPU kernel accumulated with
// preferred_element_type=f32.
//
// What the design does about it: two kernels per call.
//  * ssd_scores_kernel computes the causal 64 x 64 tiles of S = C B^T once
//    per chunk g, for all H heads (the score is 2.5% of the flops when it is
//    shared by 80 heads), into a (G, Qp, Qp) scratch laid out S^T[t][q]
//    (Qp = Q rounded up to 64; the wrapper allocates it, 2 MB at the path's
//    shape, read back through L2).  Tiles above the diagonal are skipped.
//  * ssd_chunk_kernel: one block per (64 query rows, head, g) -- 2,560 blocks
//    of 2P threads at the path's shape, on a 1-D grid that starts the
//    longest query tiles (the most key tiles) first, so the short ones fill
//    the tail.  Keys stream through a three-stage cp.async ring, 16 keys
//    deep: the S^T rows, xbar's rows and la for those keys.  Below the
//    diagonal tile (t < q0 <= q) the decay factors as exp(la_q - la_q0) *
//    exp(la_q0 - la_t), so a stage's xbar rows are scaled by the key's
//    factor (computed once per block) and each row's sum by its own when
//    the diagonal tile begins: no exp per (q, t) pair there.  That holds
//    where both exponents are <= 0, as when la falls along the chunk (the
//    model's always does); a block where either would be positive forms W
//    per pair in every tile, as in the diagonal one, so no factor can
//    overflow where the single exponent does not.  In the diagonal tile
//    each stage is turned in place into W^T[t][q] = S * exp(la_q - la_t),
//    masked first.  Every thread accumulates a 4-row x 8-column register
//    tile of y: per key three 16-byte shared loads feed 32 FMAs.  The block holds no score
//    panel (27 KB of shared memory at P = 64), so four blocks (16 warps)
//    share an SM, as registers allow; a warp whose rows all lie above a
//    diagonal stage skips its FMAs.
//  * Layout: every tensor takes (g, [h,] q) element strides with a unit last
//    dimension, so the model's (B, nc, Q, H, P) xbar and (B, nc, Q, H)
//    cumulative log-decay go in as head-major views, and y comes back in
//    xbar's layout, with no transpose copy.  xbar and y move in 16-byte
//    copies when their base and strides allow and in 4-byte ones otherwise;
//    B, C and la take any strides.  The ragged Q edge is masked in the
//    kernels (keys past Q are zero-filled, rows past Q are not stored).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block = keys per score tile
constexpr int kJC = 16;        // keys per ring stage
constexpr int kStages = 3;
constexpr int kNK = 32;        // state columns of B / C staged per pass
constexpr int kSS = kBQ + 4;   // padded row stride of the staged B^T / C^T
constexpr int kScoreThreads = 256;
constexpr int kMaxQ = 512;

struct Args {
  const float* B;
  const float* C;
  const float* la;
  const float* x;
  float* o;
  float* S;                    // (G, Qp, Qp) scratch, S^T[t][q]
  int G, H, Q, N, Qp;
  long long b_sg, b_sq, c_sg, c_sq;
  long long la_sg, la_sh, la_sq;
  long long x_sg, x_sh, x_sq;
  long long o_sg, o_sh, o_sq;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// S^T tile (kt, qt) of chunk g: S^T[t][q] = sum_n B[t, n] C[q, n], t in key
// tile kt, q in query tile qt, over n in order.  Rows and keys past Q are
// staged as zeros, so the padded scratch is zero there.
__global__ void __launch_bounds__(kScoreThreads) ssd_scores_kernel(
    const Args a) {
  const int qt = blockIdx.x, kt = blockIdx.y, g = blockIdx.z;
  if (kt > qt) return;                       // above the diagonal: never read
  __shared__ __align__(16) float c_s[kNK][kSS];   // C^T: [n][q]
  __shared__ __align__(16) float b_s[kNK][kSS];   // B^T: [n][t]
  const int tid = threadIdx.x;
  const int tq = tid % 16, tt = tid / 16;    // 4 q columns x 4 t rows each
  const int q0 = qt * kBQ, k0 = kt * kBQ, Q = a.Q, N = a.N;
  const float* Cg = a.C + g * a.c_sg;
  const float* Bg = a.B + g * a.b_sg;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kNK) {
    __syncthreads();                         // the previous stage is consumed
    for (int e = tid; e < kBQ * kNK; e += kScoreThreads) {
      const int r = e / kNK, n = e % kNK, nn = n0 + n;
      c_s[n][r] = (q0 + r < Q && nn < N)
                      ? Cg[(long long)(q0 + r) * a.c_sq + nn] : 0.f;
      b_s[n][r] = (k0 + r < Q && nn < N)
                      ? Bg[(long long)(k0 + r) * a.b_sq + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < kNK; ++n) {
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[n][tt * 4]);
      const float4 cv = *reinterpret_cast<const float4*>(&c_s[n][tq * 4]);
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
      const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(b4[i], c4[c], acc[i][c]);
    }
  }
  float* S = a.S + ((long long)g * a.Qp + k0 + tt * 4) * a.Qp + q0 + tq * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(S + (long long)i * a.Qp) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

constexpr int kTM = 4;               // query rows per thread
constexpr int kTN = 8;               // output columns per thread
constexpr int kMinBlocks = 2;        // per SM: caps registers at 128 (P = 128)
static_assert(kTM % 4 == 0 && kTN % 4 == 0, "16-byte shared reads");

template <int P>
__host__ __device__ constexpr int chunk_threads() {
  return kBQ / kTM * (P / kTN);
}

// y for 64 query rows of one (g, h): thread (rb, cb) keeps a kTM x kTN
// register tile, rows rb*kTM .. +kTM-1 and columns cb*4 + u*(P*4/kTN) ..
// +3 for u < kTN/4, so a quarter warp's 16-byte reads of a key's xbar row
// are 128 consecutive bytes.  VX: xbar / y copy width in floats (4 or 1).
template <int P, int VX>
__global__ void __launch_bounds__(chunk_threads<P>(), kMinBlocks)
ssd_chunk_kernel(const Args a) {
  constexpr int NT = chunk_threads<P>();
  constexpr int CB = P / kTN;           // column blocks
  constexpr int CG = kTN / 4;           // 4-column groups per thread
  constexpr int CS = P / CG;            // their spacing
  constexpr int kVPR = P / VX;
  __shared__ __align__(16) float s_s[kStages][kJC][kBQ];  // S^T, then W^T
  __shared__ __align__(16) float x_s[kStages][kJC][P];
  __shared__ float lt_s[kStages][kJC];
  __shared__ float lq_s[kBQ];
  __shared__ float b_s[kMaxQ - kBQ];     // exp(la_q0 - la_t), keys t < q0

  const int tid = threadIdx.x;
  const int Q = a.Q;
  const int n_q = (Q + kBQ - 1) / kBQ;
  const long long per_tile = (long long)a.G * a.H;
  const int qt = n_q - 1 - (int)(blockIdx.x / per_tile);
  const long long rem = blockIdx.x % per_tile;
  const int g = (int)(rem / a.H), h = (int)(rem % a.H);
  const int q0 = qt * kBQ;
  const int kv_end = min(Q, q0 + kBQ);
  const int n_ch = (kv_end + kJC - 1) / kJC;
  const float* la = a.la + g * a.la_sg + h * a.la_sh;
  const float* X = a.x + g * a.x_sg + h * a.x_sh;
  const float* S = a.S + (long long)g * a.Qp * a.Qp + q0;
  const int cb = tid % CB, rb = tid / CB;
  // the last row of this warp's tiles: a stage whose first key is past it
  // adds nothing to the warp's rows
  const int warp_last_row =
      q0 + (min(NT - 1, (tid | 31)) / CB + 1) * kTM - 1;

  // keys below the diagonal tile: exp(la_q - la_t) = exp(la_q - la_q0) *
  // exp(la_q0 - la_t), both exponents <= 0 where la falls along the chunk
  // (the model's always does).  Where one would be positive, so that a
  // factor could overflow where the single exponent does not, the block
  // takes every pair's exponent directly, as in the diagonal tile.
  const float la0 = la[(long long)q0 * a.la_sq];
  bool rises = false;
  for (int i = tid; i < kBQ; i += NT) {
    lq_s[i] = q0 + i < Q ? la[(long long)(q0 + i) * a.la_sq] : 0.f;
    rises |= q0 + i < Q && lq_s[i] > la0;
  }
  for (int t = tid; t < q0; t += NT) {
    const float d = la0 - la[(long long)t * a.la_sq];
    rises |= d > 0.f;
    b_s[t] = expf(d);
  }
  const bool factored = !__syncthreads_or(rises);

  static_assert((kJC * kBQ / 4) % NT == 0 && (kJC * kVPR) % NT == 0 &&
                (kJC * kBQ) % NT == 0, "whole copy and conversion rounds");
  auto load = [&](int ch, int st) {
    const int t0 = ch * kJC;
#pragma unroll
    for (int i = 0; i < kJC * (kBQ / 4) / NT; ++i) {
      const int e = tid + i * NT;
      const int j = e / (kBQ / 4), v = e % (kBQ / 4);
      cp_async<16>(&s_s[st][j][v * 4], S + (long long)(t0 + j) * a.Qp + v * 4,
                   true);
    }
#pragma unroll
    for (int i = 0; i < kJC * kVPR / NT; ++i) {
      const int e = tid + i * NT;
      const int j = e / kVPR, v = e % kVPR, t = t0 + j;
      const bool ok = t < Q;
      cp_async<4 * VX>(&x_s[st][j][v * VX],
                       ok ? X + (long long)t * a.x_sq + v * VX : a.x, ok);
    }
    if (t0 >= q0 || !factored) {         // la_t: where W^T is formed
      for (int j = tid; j < kJC; j += NT) {
        const int t = t0 + j;
        cp_async<4>(&lt_s[st][j],
                    t < Q ? la + (long long)t * a.la_sq : a.la, t < Q);
      }
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[i][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_ch) load(s, s);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_ch; ++ch) {
    const int st = ch % kStages, t0 = ch * kJC;
    cp_async_wait<kStages - 2>();            // stage ch landed (this thread's)
    __syncthreads();                         // ... everyone's; ch-1 consumed
    if (t0 < q0 && factored) {
      // below the diagonal tile: scale the keys' xbar rows by exp(la_q0 -
      // la_t); the rows' exp(la_q - la_q0) is applied to the sums at q0
#pragma unroll
      for (int i = 0; i < kJC * P / NT; ++i) {
        const int e = tid + i * NT;
        const int j = e / P, p = e % P;
        x_s[st][j][p] *= b_s[t0 + j];
      }
    } else {
      if (t0 == q0 && q0 > 0 && factored) {
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const int q = rb * kTM + i;
          const float r = q0 + q < Q ? expf(lq_s[q] - la0) : 0.f;
#pragma unroll
          for (int c = 0; c < kTN; ++c) acc[i][c] *= r;
        }
      }
      // the diagonal tile (every tile when not factored): W^T = S^T *
      // exp(la_q - la_t) where t <= q < Q, the mask first
#pragma unroll
      for (int i = 0; i < kJC * kBQ / NT; ++i) {
        const int e = tid + i * NT;
        const int j = e / kBQ, q = e % kBQ;
        const int t = t0 + j, row = q0 + q;
        float w = 0.f;
        if (t <= row && row < Q)
          w = s_s[st][j][q] * expf(lq_s[q] - lt_s[st][j]);
        s_s[st][j][q] = w;
      }
    }
    __syncthreads();
    const int nx = ch + kStages - 1;
    if (nx < n_ch) load(nx, nx % kStages);
    cp_async_commit();
    if (t0 > warp_last_row) continue;        // warp-uniform
#pragma unroll
    for (int j = 0; j < kJC; ++j) {
      float w[kTM], x[kTN];
#pragma unroll
      for (int i = 0; i < kTM; i += 4) {
        const float4 t = *reinterpret_cast<const float4*>(
            &s_s[st][j][rb * kTM + i]);
        w[i] = t.x; w[i + 1] = t.y; w[i + 2] = t.z; w[i + 3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < CG; ++u) {
        const float4 t = *reinterpret_cast<const float4*>(
            &x_s[st][j][u * CS + cb * 4]);
        x[4 * u] = t.x; x[4 * u + 1] = t.y; x[4 * u + 2] = t.z;
        x[4 * u + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[i][c] = fmaf(w[i], x[c], acc[i][c]);
    }
  }
  cp_async_wait<0>();

  float* O = a.o + g * a.o_sg + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + rb * kTM + i;
    if (row >= Q) continue;
    float* o = O + (long long)row * a.o_sq + cb * 4;
#pragma unroll
    for (int u = 0; u < CG; ++u) {
      if constexpr (VX == 4) {
        *reinterpret_cast<float4*>(o + u * CS) =
            make_float4(acc[i][4 * u], acc[i][4 * u + 1], acc[i][4 * u + 2],
                        acc[i][4 * u + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) o[u * CS + c] = acc[i][4 * u + c];
      }
    }
  }
}

template <int P, int VX>
int launch(const Args& a, cudaStream_t stream) {
  const int n_q = (a.Q + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_q * a.G * a.H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  ssd_scores_kernel<<<dim3(n_q, n_q, a.G), kScoreThreads, 0, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_kernel<P, VX><<<(unsigned)blocks, chunk_threads<P>(), 0,
                            stream>>>(a);
  return (int)cudaGetLastError();
}

// 16-byte copies of xbar and y need 16-byte bases and every stride a
// multiple of 4 floats.
bool aligned16(const Args& a) {
  const uintptr_t p = (uintptr_t)a.x | (uintptr_t)a.o;
  const long long s = a.x_sg | a.x_sh | a.x_sq | a.o_sg | a.o_sh | a.o_sq;
  return p % 16 == 0 && s % 4 == 0;
}

template <int P>
int launch_p(const Args& a, cudaStream_t stream) {
  return aligned16(a) ? launch<P, 4>(a, stream) : launch<P, 1>(a, stream);
}

}  // namespace

// Bc, Cc (G, Q, N); cum_la (G, H, Q); xbar and y (G, H, Q, P): f32 device
// arrays with a unit last-dimension stride and the given element strides
// (b_sg = Bc's g stride, b_sq its q stride, and so on).  scratch: a
// contiguous f32 (G, Qp, Qp) device array, Qp = Q rounded up to 64.  P in
// {16, 32, 64, 128}, 0 < Q <= 512, G <= 65,535, ceil(Q / 64) * G * H <
// 2^31; any cum_la.  Launches both kernels on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int repro_ssd_chunk_f32(
    const float* Bc, const float* Cc, const float* cum_la, const float* xbar,
    float* y, float* scratch, int G, int H, int Q, int N, int P,
    long long b_sg, long long b_sq, long long c_sg, long long c_sq,
    long long la_sg, long long la_sh, long long la_sq, long long x_sg,
    long long x_sh, long long x_sq, long long o_sg, long long o_sh,
    long long o_sq, cudaStream_t stream) {
  if (G <= 0 || H <= 0 || Q <= 0 || N <= 0 || Q > kMaxQ || G > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.B = Bc; a.C = Cc; a.la = cum_la; a.x = xbar; a.o = y; a.S = scratch;
  a.G = G; a.H = H; a.Q = Q; a.N = N;
  a.Qp = (Q + kBQ - 1) / kBQ * kBQ;
  a.b_sg = b_sg; a.b_sq = b_sq; a.c_sg = c_sg; a.c_sq = c_sq;
  a.la_sg = la_sg; a.la_sh = la_sh; a.la_sq = la_sq;
  a.x_sg = x_sg; a.x_sh = x_sh; a.x_sq = x_sq;
  a.o_sg = o_sg; a.o_sh = o_sh; a.o_sq = o_sq;
  switch (P) {
    case 16: return launch_p<16>(a, stream);
    case 32: return launch_p<32>(a, stream);
    case 64: return launch_p<64>(a, stream);
    case 128: return launch_p<128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
