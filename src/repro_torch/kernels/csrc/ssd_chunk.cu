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
// cores.  Every product here is IEEE f32 fmaf on the CUDA cores -- no TF32,
// as the TPU kernel accumulated with preferred_element_type=f32.
//
// What the design does about it:
//  * The TPU kernel holds the whole (Q, Q) f32 score panel of one (g, h) in
//    VMEM: 256 KB at Q = 256, more than a Hopper block's 227 KB of shared
//    memory.  Here a block owns kBQ = 64 query rows of one g, so its panel
//    is kBQ x Q (65.8 KB at Q = 256, in dynamic shared memory), holding only
//    key tiles at or below its diagonal; tiles above it are never computed.
//  * Heads share B and C (one group), so the TPU grid (G, H) recomputed
//    C B^T for each of the 80 heads.  Here a block computes its score panel
//    once and reuses it for kHeads = 8 heads: per head and key tile it forms
//    W = S * exp(la_q - la_t) (masked) in shared memory and accumulates
//    y += W x_t in registers.  So C B^T is computed H / 8 times per chunk,
//    not H times.
//  * Grid (query tiles, head groups, G): 320 blocks of 256 threads at the
//    path's shape.  Each thread holds a 4 x 4 micro-tile of a 64 x 64 score
//    tile and a 4 x P/16 micro-tile of the output; shared rows are padded by
//    one float so the tile reads do not conflict on banks.  B and C stream
//    through shared memory kNK = 32 state columns at a time, so any N fits.
//  * Layout: every tensor takes (g, [h,] q) element strides with a unit last
//    dimension, so the model's (B, nc, Q, H, P) xbar and (B, nc, Q, H)
//    cumulative log-decay go in as head-major views, and y comes back in
//    xbar's layout, with no transpose copy.  The ragged Q edge is masked in
//    the kernel (rows and keys at or past Q are staged as zeros and rows
//    past Q are not stored).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile (== kBQ: one stage loop)
constexpr int kNK = 32;        // state columns of B / C staged per pass
constexpr int kHeads = 8;      // heads per block, sharing one score panel
constexpr int kThreads = 256;
constexpr int kMaxQ = 512;     // keeps the panel inside 227 KB at P = 128
static_assert(kBQ == kBK, "one loop stages the C rows and the B rows");
static_assert(kThreads == 16 * (kBQ / 4), "4 x 4 micro-tiles cover 64 x 64");

struct Args {
  const float* B;
  const float* C;
  const float* la;
  const float* x;
  float* o;
  int H, Q, N;
  long long b_sg, b_sq, c_sg, c_sq;
  long long la_sg, la_sh, la_sq;
  long long x_sg, x_sh, x_sq;
  long long o_sg, o_sh, o_sq;
};

__host__ __device__ constexpr int padded_q(int Q) {
  return (Q + kBK - 1) / kBK * kBK;
}

template <int P>
size_t smem_bytes(int Q) {
  const int qp = padded_q(Q);
  return sizeof(float) *
         ((size_t)kBQ * (qp + 1) + (size_t)(kBQ + kBK) * (kNK + 1) +
          (size_t)kBK * (P + 1) + (size_t)kBQ * (kBK + 1) + qp);
}

template <int P>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(const Args a) {
  constexpr int LC = kNK + 1;        // padded row stride of the B / C tiles
  constexpr int LX = P + 1;          // of the xbar tile
  constexpr int LW = kBK + 1;        // of the weight tile
  constexpr int OC = P / 16;         // output columns per thread
  const int Q = a.Q;
  const int LS = padded_q(Q) + 1;    // of the score panel
  extern __shared__ float smem[];
  float* s_s = smem;                 // kBQ x LS: S = C B^T, key tiles <= diag
  float* c_s = s_s + kBQ * LS;       // kBQ x LC
  float* b_s = c_s + kBQ * LC;       // kBK x LC
  float* x_s = b_s + kBK * LC;       // kBK x LX: one head's xbar tile
  float* w_s = x_s + kBK * LX;       // kBQ x LW: S * exp(la_q - la_t), masked
  float* la_s = w_s + kBQ * LW;      // one head's la over the block's keys

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h0 = blockIdx.y * kHeads;
  const int g = blockIdx.z;
  const int kv_end = min(Q, q0 + kBQ);           // keys this block can see
  const int n_kt = (kv_end + kBK - 1) / kBK;     // their tiles
  const float* Bg = a.B + g * a.b_sg;
  const float* Cg = a.C + g * a.c_sg;
  // micro-tiles: rows ty * 4 + i, columns tx + 16 * j
  const int ty = tid >> 4, tx = tid & 15;

  // 1. the score panel, one 64 x 64 tile per key tile
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int n0 = 0; n0 < a.N; n0 += kNK) {
      __syncthreads();               // the previous stage is consumed
      for (int i = tid; i < kBQ * kNK; i += kThreads) {
        const int r = i / kNK, n = i % kNK, nn = n0 + n;
        const int row = q0 + r, col = k0 + r;
        c_s[r * LC + n] = (row < Q && nn < a.N)
                              ? Cg[(long long)row * a.c_sq + nn] : 0.f;
        b_s[r * LC + n] = (col < Q && nn < a.N)
                              ? Bg[(long long)col * a.b_sq + nn] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int n = 0; n < kNK; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty * 4 + i) * LC + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * LC + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s_s[(ty * 4 + i) * LS + k0 + tx + 16 * j] = s[i][j];
  }

  // 2. per head: y = sum over key tiles of (S * L) x_t
  const int hn = min(kHeads, a.H - h0);
  for (int hh = 0; hh < hn; ++hh) {
    const int h = h0 + hh;
    const float* la = a.la + g * a.la_sg + h * a.la_sh;
    const float* X = a.x + g * a.x_sg + h * a.x_sh;
    __syncthreads();                 // the panel is written; the previous
                                     // head's la_s is consumed
    for (int t = tid; t < kv_end; t += kThreads)
      la_s[t] = la[(long long)t * a.la_sq];
    float acc[4][OC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;

    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * kBK;
      __syncthreads();               // la_s is loaded; the previous tile is
                                     // consumed
      for (int i = tid; i < kBK * P; i += kThreads) {
        const int r = i / P, p = i % P, col = k0 + r;
        x_s[r * LX + p] = col < Q ? X[(long long)col * a.x_sq + p] : 0.f;
      }
      for (int i = tid; i < kBQ * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK, row = q0 + r, col = k0 + c;
        // the mask comes first: exp is evaluated only for col <= row
        w_s[r * LW + c] =
            (col <= row && row < Q)
                ? s_s[r * LS + col] * expf(la_s[row] - la_s[col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        float wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = w_s[(ty * 4 + i) * LW + j];
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          const float xv = x_s[j * LX + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(wv[i], xv, acc[i][c]);
        }
      }
    }

    float* O = a.o + g * a.o_sg + h * a.o_sh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < Q) {
#pragma unroll
        for (int c = 0; c < OC; ++c)
          O[(long long)row * a.o_sq + tx + 16 * c] = acc[i][c];
      }
    }
  }
}

template <int P>
int launch(const Args& a, int G, cudaStream_t stream) {
  const size_t smem = smem_bytes<P>(a.Q);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Q + kBQ - 1) / kBQ, (a.H + kHeads - 1) / kHeads, G);
  ssd_chunk_kernel<P><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Bc, Cc (G, Q, N); cum_la (G, H, Q); xbar and y (G, H, Q, P): f32 device
// arrays with a unit last-dimension stride and the given element strides
// (b_sg = Bc's g stride, b_sq its q stride, and so on).  P in {16, 32, 64,
// 128}, 0 < Q <= 512.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int repro_ssd_chunk_f32(
    const float* Bc, const float* Cc, const float* cum_la, const float* xbar,
    float* y, int G, int H, int Q, int N, int P, long long b_sg,
    long long b_sq, long long c_sg, long long c_sq, long long la_sg,
    long long la_sh, long long la_sq, long long x_sg, long long x_sh,
    long long x_sq, long long o_sg, long long o_sh, long long o_sq,
    cudaStream_t stream) {
  if (G <= 0 || H <= 0 || Q <= 0 || N <= 0 || Q > kMaxQ || G > 65535 ||
      (H + kHeads - 1) / kHeads > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.B = Bc; a.C = Cc; a.la = cum_la; a.x = xbar; a.o = y;
  a.H = H; a.Q = Q; a.N = N;
  a.b_sg = b_sg; a.b_sq = b_sq; a.c_sg = c_sg; a.c_sq = c_sq;
  a.la_sg = la_sg; a.la_sh = la_sh; a.la_sq = la_sq;
  a.x_sg = x_sg; a.x_sh = x_sh; a.x_sq = x_sq;
  a.o_sg = o_sg; a.o_sh = o_sh; a.o_sq = o_sq;
  switch (P) {
    case 16: return launch<16>(a, G, stream);
    case 32: return launch<32>(a, G, stream);
    case 64: return launch<64>(a, G, stream);
    case 128: return launch<128>(a, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
