// Online-softmax (flash) attention forward on Hopper (sm_90a).
//
//   O[b, h, r, :] = sum_c softmax_c(mask(softcap(q_r . k_c * D^-1/2))) v_c
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel), which the JAX package reaches from
// models/layers.py through kernels/ops.py::flash_attention_diff.  It computes
// what _flash_kernel computes, not its block schedule: q scaled by D^-1/2 in
// f32 before the product, scores and the output accumulator in f32, softcap
// tanh(s / c) * c before the masks, the masks cols < S, causal cols <= rows
// and window rows - cols < window with -1e30 as the masked score, masked
// scores contributing exactly 0, output acc / max(l, 1e-30) cast to the input
// dtype -- so a row whose every column is masked comes out 0, not NaN.
//
// What bounds it on an H100: at the LM path's shape (B = 4, H = 9, S = 256,
// D = 64, bf16, causal, kv heads read in place) one call moves ~3.1 MB
// (0.9 us at 3.35 TB/s) and needs ~0.30 GFLOP (0.3 us at the bf16 tensor-core
// peak, 4.5 us at 67 TFLOP/s on the f32 CUDA cores).  This first kernel does
// every product as IEEE f32 fmaf on the CUDA cores -- no tensor-core product,
// bf16 or TF32, anywhere -- so it sits well above the bf16 bound by design;
// a wgmma/TMA version is later work.
//
// What the design does about it: one launch covers (q tiles, H, B); a block
// owns kBQ = 64 query rows, stages them (scaled, in f32) in shared memory
// once, then loops over kBK = 64-row k/v tiles -- nothing carries between
// blocks on Hopper, so the TPU's sequential kv grid axis becomes this loop.
// Tiles that are masked for every row of the block (above the causal
// diagonal, below the window) are skipped: they would contribute p = 0 and
// alpha = 1 exactly.  The ragged S edge is masked in the kernel (k/v rows
// past S are staged as zeros, query rows past S are not stored), so no
// padding copy exists.  GQA kv heads are read in place (query head h reads kv
// head h / (H / Hk)) and all four tensors take (b, h, s) strides, so the
// model's (B, S, H, D) projections need no transpose copy.  Each of the 128
// threads holds a 8 x 4 micro-tile of the score tile and a 4 x D/8 micro-tile
// of the output accumulator in registers; shared-memory rows are padded by
// one float so the tile reads do not conflict on banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // k/v rows per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hk, S;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  constexpr int LD = D + 1;          // padded row stride of q/k/v tiles
  constexpr int LP = kBK + 1;        // padded row stride of the score tile
  constexpr int OC = D / 8;          // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                 // kBQ x LD, scaled q
  float* k_s = q_s + kBQ * LD;       // kBK x LD
  float* v_s = k_s + kBK * LD;       // kBK x LD
  float* p_s = v_s + kBK * LD;       // kBQ x LP, scores then probabilities
  float* m_s = p_s + kBQ * LP;       // kBQ running max
  float* l_s = m_s + kBQ;            // kBQ running denominator
  float* al_s = l_s + kBQ;           // kBQ this tile's rescale factor

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int S = a.S;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* O = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, row = q0 + r;
    q_s[r * LD + d] =
        row < S ? load_f32(Q + (long long)row * a.q_ss + d) * a.scale : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // output micro-tile: rows oy*4 + i, columns ox + 8*c
  const int oy = tid >> 3, ox = tid & 7;
  float acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  // score micro-tile: rows sy*8 + i, columns sx + 16*j
  const int sy = tid >> 4, sx = tid & 15;

  // the kv rows some row of this block may attend to
  int kv_end = S;
  if (a.causal) kv_end = min(S, q0 + kBQ);
  long long kv_begin = 0;
  if (a.has_window) {
    // rows - cols < window  <=>  cols >= rows - window + 1 >= q0 - window + 1
    const long long lo = (long long)q0 - a.window + 1;
    kv_begin = lo > 0 ? lo : 0;
  }
  const long long t0 = (kv_begin / kBK) * kBK;

  for (long long kt = t0; kt < kv_end; kt += kBK) {
    const int k0 = (int)kt;
    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, col = k0 + r;
      const bool in = col < S;
      k_s[r * LD + d] = in ? load_f32(K + (long long)col * a.k_ss + d) : 0.f;
      v_s[r * LD + d] = in ? load_f32(V + (long long)col * a.v_ss + d) : 0.f;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = q_s[(sy * 8 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(sx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = sy * 8 + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sx + 16 * j, col = k0 + c;
        float x = s[i][j];
        if (a.has_softcap) x = tanhf(x / a.softcap) * a.softcap;
        bool keep = col < S;
        if (a.causal) keep = keep && col <= row;
        if (a.has_window) keep = keep && (row - col) < a.window;
        p_s[r * LP + c] = keep ? x : kNegInf;
      }
    }
    __syncthreads();

    {  // online softmax over this tile: two threads per row
      const int r = tid >> 1, half = tid & 1;
      float* prow = p_s + r * LP;
      float mx = kNegInf;
      for (int c = half; c < kBK; c += 2) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = half; c < kBK; c += 2) {
        const float x = prow[c];
        const float e = x <= kNegInf ? 0.f : expf(x - m_new);
        prow[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        al_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = al_s[oy * 4 + i];
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(oy * 4 + i) * LP + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float vv = v_s[j * LD + ox + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = oy * 4 + i, row = q0 + r;
    if (row < S) {
      const float l = fmaxf(l_s[r], 1e-30f);
      T* orow = O + (long long)row * a.o_ss;
#pragma unroll
      for (int c = 0; c < OC; ++c)
        store_from_f32(orow + ox + 8 * c, acc[i][c] / l);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int B, int H,
        int Hk, int S, int D, long long q_sb, long long q_sh, long long q_ss,
        long long k_sb, long long k_sh, long long k_ss, long long v_sb,
        long long v_sh, long long v_ss, long long o_sb, long long o_sh,
        long long o_ss, int causal, int has_window, int window,
        int has_softcap, float softcap, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || S <= 0 || H % Hk != 0 || B > 65535 ||
      H > 65535 || (has_softcap && !(softcap > 0.f)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.H = H; a.Hk = Hk; a.S = S;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.causal = causal; a.has_window = has_window; a.window = window;
  a.has_softcap = has_softcap; a.softcap = softcap;
  a.scale = (float)(1.0 / sqrt((double)D));   // D ** -0.5, rounded once
  switch (D) {
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, S, D), k and v (B, Hk, S, D), o (B, H, S, D): device arrays of one
// dtype with unit stride along D and the given (b, h, s) element strides.
// causal/has_window/has_softcap are 0 or 1; window may be any int (<= 0 masks
// every column of a causal row).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
#define REPRO_FLASH_ENTRY(NAME, T)                                            \
  extern "C" int NAME(                                                        \
      const void* q, const void* k, const void* v, void* o, int B, int H,     \
      int Hk, int S, int D, long long q_sb, long long q_sh, long long q_ss,   \
      long long k_sb, long long k_sh, long long k_ss, long long v_sb,         \
      long long v_sh, long long v_ss, long long o_sb, long long o_sh,         \
      long long o_ss, int causal, int has_window, int window,                 \
      int has_softcap, float softcap, cudaStream_t stream) {                  \
    return run<T>(q, k, v, o, B, H, Hk, S, D, q_sb, q_sh, q_ss, k_sb, k_sh,   \
                  k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, causal,           \
                  has_window, window, has_softcap, softcap, stream);          \
  }

REPRO_FLASH_ENTRY(repro_flash_attention_f32, float)
REPRO_FLASH_ENTRY(repro_flash_attention_bf16, __nv_bfloat16)
