// Online-softmax (flash) attention forward on Hopper (sm_90a).
//
//   O[b, h, r, :] = sum_c softmax_c(mask(softcap(q_r . k_c * D^-1/2))) v_c
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel), which the JAX package reaches from
// models/layers.py through kernels/ops.py::flash_attention_diff.  It computes
// what _flash_kernel computes, not its block schedule: scores and the output
// accumulator in f32, the D^-1/2 scale in f32 (bf16: on the scores after the
// product; f32: on q, as the Pallas kernel does), softcap tanh(s / c) * c
// before the masks, the masks cols < S, causal cols <= rows
// and window rows - cols < window with -1e30 as the masked score, masked
// scores contributing exactly 0, output acc / max(l, 1e-30) cast to the input
// dtype -- so a row whose every column is masked comes out 0, not NaN.  GQA kv
// heads are read in place (query head h reads kv head h / (H / Hk)) and all
// four tensors take (b, h, s) strides, so the model's (B, S, H, D)
// projections need no transpose copy; the ragged S edge is masked in the
// kernel, so no padding copy exists.
//
// Two entries, two kernels:
//
// bf16 (repro_flash_attention_bf16, the LM path's): tensor cores.  What bounds
// it on an H100: 4 D flops per unmasked (row, column) pair at 989 TFLOP/s, or
// q, k, v and o moved once at 3.35 TB/s, whichever is larger -- 0.94 us (bytes)
// at the LM path's (4, 9, 256, 64) causal shape, ~0.21 ms (operations) at
// (1, 48, 4096, 128).  What the design does about it:
//   * A block is NWG consumer warpgroups of 64 query rows each (consecutive
//     rows of one (b, h)): one for D <= 128, two sharing every k/v tile for
//     D = 256 on a grid that fills the card twice.  The grid is 1-D over
//     (q tile, h, b), the longest causal tiles first, so B and H are not held
//     to the 65,535 of a grid's y and z.
//   * Thread 0 loads the q tiles and the first ring slots; then one lane of
//     warp 1 (k) and of warp 2 (v) streams 64-row k and v tiles into two
//     rings of kStages slots with TMA (cp.async.bulk.tensor over 4-D tensor
//     maps of (D, S, heads, B) built on the host for each call).  Each slot
//     has a full mbarrier (TMA transaction bytes); the slot of tile t is
//     refilled with tile t + kStages by the last warpgroup to release it,
//     so no warpgroup waits for another.  TMA's out-of-bounds zero
//     fill supplies the ragged S edge and pads D to 64, 128 or 256 columns
//     in shared memory, so any D that is a multiple of 8 up to 256 runs
//     (D = 32, 112).  Tiles are 64 x 64 bf16 boxes, 128-byte swizzled.
//   * S = Q K^T is wgmma m64n64k16 (bf16 in, f32 accumulators in registers,
//     both operands K-major in shared memory).  The scale, softcap, masks
//     and an online softmax in base 2 run on those registers, a row reduced
//     across the four lanes that hold it -- no score tile in shared memory.
//   * O += P V is wgmma m64n{64,128,256}k16 with P as the register A operand
//     and V read MN-major from the tile TMA wrote.  P is split into three
//     bf16 parts (hi, mid, lo; ~24 bits), three products into one f32
//     accumulator: V is exact in bf16, and a single bf16 P (2^-9 relative per
//     term) or two parts (2^-18) move outputs near 0 past the 2-bf16-ulp
//     agreement with the f32 reference.  So P V costs three products and the
//     kernel does 2x the bound's operations.
//   * The products of tile t overlap the softmax: S of tile t and P V of
//     tile t - 1 are issued together, and the softmax of tile t runs while
//     P V of tile t - 1 is on the tensor cores.
//   * A block walks only the tiles some row of it may see (none above the
//     causal diagonal or below the window), and only tiles that cross a
//     mask edge evaluate the masks.  The output is written from the
//     accumulators through o's strides; rows past S are not stored.
//
// f32 (repro_flash_attention_f32): every product as IEEE f32 fmaf on the CUDA
// cores -- no tensor-core product, TF32 or bf16, anywhere -- for D in {64,
// 128, 256} and B, H <= 65,535 (grid y and z).  A block owns 64 query rows,
// stages them (scaled, in f32) in shared memory once, then loops over 64-row
// k/v tiles; each of the 128 threads holds an 8 x 4 micro-tile of the score
// tile and a 4 x D/8 micro-tile of the output accumulator in registers.

#include <cuda.h>            // CUtensorMap; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------------------- //
// f32: the CUDA-core kernel
// ------------------------------------------------------------------------- //

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // k/v rows per tile
constexpr int kThreads = 128;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hk, S, D;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1) + 3 * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const Args a) {
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
  const float* Q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* K = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* V = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* O = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, row = q0 + r;
    q_s[r * LD + d] = row < S ? Q[(long long)row * a.q_ss + d] * a.scale : 0.f;
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
      k_s[r * LD + d] = in ? K[(long long)col * a.k_ss + d] : 0.f;
      v_s[r * LD + d] = in ? V[(long long)col * a.v_ss + d] : 0.f;
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
      float* orow = O + (long long)row * a.o_ss;
#pragma unroll
      for (int c = 0; c < OC; ++c) orow[ox + 8 * c] = acc[i][c] / l;
    }
  }
}

template <int D>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, B);
  flash_attention_f32_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int run_f32(const Args& a, int B, cudaStream_t stream) {
  if (B > 65535 || a.H > 65535) return (int)cudaErrorInvalidValue;
  switch (a.D) {
    case 64: return launch_f32<64>(a, B, stream);
    case 128: return launch_f32<128>(a, B, stream);
    case 256: return launch_f32<256>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------------- //
// bf16: wgmma on the tensor cores, TMA into an mbarrier ring
// ------------------------------------------------------------------------- //

constexpr int kStages = 2;                // depth of the k ring and the v ring
constexpr int kRows = 64;                 // rows of a q tile, a k/v tile, a box
constexpr int kBoxBytes = kRows * 128;    // 64 rows x 64 bf16, 128B-swizzled
constexpr float kLog2e = 1.4426950408889634f;

template <int DP, int NWG>
struct Layout {                 // byte offsets from a 1024-aligned base
  static constexpr int kChunks = DP / 64;             // 64-column boxes per row
  static constexpr int kTile = kChunks * kBoxBytes;   // one 64-row tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + NWG * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;   // q, k and v barriers,
  static constexpr int kBytes =                       // then the counts
      kBar + 8 * (1 + 2 * kStages) + 4 * 2 * kStages + 1024;
  static constexpr int kThreads = NWG * 128;
  // D = 64 fits three blocks per SM in 168 registers a thread (the 64K
  // register file); D = 128 needs ~200 (two blocks), D = 256 one block
  static constexpr int kBlocksPerSM = DP == 64 ? 3 : 1;
};

struct HArgs {
  void* o;
  int S, H, Hk, D_true, n_qt;             // n_qt: q tiles of 64 * NWG rows
  long long o_sb, o_sh, o_ss;
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed: one test that does
// not suspend the warp (the tile is usually there), then try_wait polls.  A
// wait that cannot end (a fault in the ring's bookkeeping) traps after ~2^31
// polls (seconds), so the launch fails with an error instead of holding the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, polls = 0;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  if (done) return;
  do {
    if (++polls == 0x80000000u) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// One 64 x 64 box at (column c0, row c1, head c2, batch c3) into `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled tile: start address,
// leading and stride byte offsets (>> 4), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand (q or k, D contiguous): 8-row groups 1024 bytes apart; a
// 16-column k step inside the 128-byte swizzle row advances 32 bytes.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// MN-major operand (a v tile as B of P V, D contiguous along N): 64-column
// atoms kBoxBytes apart along N (the leading offset), 8-row groups 1024
// bytes apart along K (the kv rows; the stride offset).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, kBoxBytes, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across a wgmma
// wait: the asm statements that issue wgmma do not tell it when they finish.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32) = A (64 x 16, K-major in shared) * B (16 x 64, K-major in
// shared) + (accumulate ? d : 0), bf16 inputs.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers, four b32 per thread) *
// B (16 x 64, MN-major in shared).
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16 bf16 in registers) * B (16 x 128, MN-major
// in shared, 64-column atoms kBoxBytes apart).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 f32) += A (64 x 16 bf16 in registers) * B (16 x 256, MN-major
// in shared, 64-column atoms kBoxBytes apart).
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// 2^x on the SFU (ex2.approx, ~2 ulp like exp2f); results below 2^-126 flush
// to 0, which moves no output: each is < 2^-126 of the row's largest term.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One ring of 64-row k or v tiles: kStages slots, each with a full barrier
// (TMA transaction bytes, one expect_tx) and a count of the warpgroups that
// released it.  Tile t of the block sits in slot t % kStages.
struct Ring {
  uint8_t* buf;
  uint64_t* full;
  int* released;
  const CUtensorMap* map;
};

// Load the block's tile t into its slot (one thread, the ring's loader).
template <int DP>
__device__ __forceinline__ void ring_load(const Ring& r, int t, int t_first,
                                          int hk, int b) {
  constexpr int kChunks = DP / 64;
  const int s = t % kStages;
  mbar_expect_tx(&r.full[s], kChunks * kBoxBytes);
  for (int c = 0; c < kChunks; ++c)
    tma_load(r.buf + (s * kChunks + c) * kBoxBytes, r.map, &r.full[s], c * 64,
             (t_first + t) * kRows, hk, b);
}

__device__ __forceinline__ void ring_acquire(const Ring& r, int t) {
  mbar_wait(&r.full[t % kStages], (t / kStages) & 1);
  __syncwarp();
}

// This warpgroup is done with tile t.  A wgmma group completes for the whole
// warpgroup at once, so once a thread of it has waited for the products that
// read the tile, no warp of the group reads it any more (CUTLASS's sm90
// pipelines release the same way).  The ring's loader lane of each
// warpgroup counts the release, and the last warpgroup to release the slot
// loads tile t + kStages into it -- no warpgroup waits for another.
template <int DP, int NWG>
__device__ __forceinline__ void ring_release(const Ring& r, int t, int n_tiles,
                                             int t_first, int hk, int b,
                                             int loader) {
  __syncwarp();
  if (threadIdx.x % 128 == loader) {
    bool last = true;
    if (NWG > 1) {
      __threadfence_block();
      last = atomicAdd(&r.released[t % kStages], 1) % NWG == NWG - 1;
    }
    if (last && t + kStages < n_tiles)
      ring_load<DP>(r, t + kStages, t_first, hk, b);
  }
  __syncwarp();
}

// Accumulator layout of wgmma m64nN (per thread t of the warpgroup, warp
// w = t / 32, lane l): value 4 i + e sits at row 16 w + l / 4 + 8 (e >> 1),
// column 8 i + 2 (l % 4) + (e & 1).  The bf16 A operand of a k16 step j takes
// values 8 j .. 8 j + 7 of that layout, in order, two to a register.
template <int DP>
struct WarpgroupTile {
  float o[DP / 2];                // output accumulator (64 x DP per group)
  float m[2], M[2], l[2];        // running max (raw), m * coef, lane's sums
  uint32_t p[48];                // P = hi + mid + lo, bf16 A operands
};

// S = Q K^T for one k tile, issued and committed (not waited for).  dq and dk
// are the tiles' base descriptors; a step's descriptor adds its byte offset
// >> 4 to the start address field (no carry: shared memory is < 256 KB).
template <int DP>
__device__ __forceinline__ void issue_scores(float (&sc)[32], uint64_t dq,
                                             uint64_t dk) {
  wg_fence();
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t step = (c * kBoxBytes + kk * 32) >> 4;
      wgmma_ss(sc, dq + step, dk + step, (c | kk) != 0);
    }
  wg_commit();
}

// O += P V for one v tile (lo, mid and hi parts, smallest first), issued and
// committed; dv0 is the tile's base descriptor (mnmajor_desc).
template <int DP>
__device__ __forceinline__ void issue_pv(WarpgroupTile<DP>& w, uint64_t dv0) {
  wg_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t dv = dv0 + ((j * 2048) >> 4);
#pragma unroll
    for (int part = 2; part >= 0; --part) {
      if constexpr (DP == 64) wgmma_rs(w.o, w.p + 16 * part + 4 * j, dv);
      if constexpr (DP == 128)
        wgmma_rs_n128(w.o, w.p + 16 * part + 4 * j, dv);
      if constexpr (DP == 256)
        wgmma_rs_n256(w.o, w.p + 16 * part + 4 * j, dv);
    }
  }
  wg_commit();
}

// Scale, softcap and masks on a tile's scores, then the online softmax step:
// sc becomes p (relative to the new running max), the lane's row sums and the
// running max move on, and alpha returns each row's rescale of the output.
// Without softcap the D^-1/2 scale rides in the exponent's coefficient; with
// it, in the tanh argument's (cap_scale = D^-1/2 / softcap).
__device__ __forceinline__ void softmax_step(float (&sc)[32], float (&m)[2],
                                             float (&M)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const HArgs& a, float cap_scale,
                                             int k0, int r_lo, int c_lane,
                                             bool edge) {
  float coef = a.scale * kLog2e;
  if (a.has_softcap) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sc[i] = tanhf(sc[i] * cap_scale) * a.softcap;
    coef = kLog2e;
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r_lo + 8 * ((i >> 1) & 1);
      const int col = k0 + 8 * (i >> 2) + c_lane + (i & 1);
      bool keep = col < a.S;
      if (a.causal) keep = keep && col <= row;
      if (a.has_window) keep = keep && (row - col) < a.window;
      if (!keep) sc[i] = kNegInf;
    }
  }
  float M_use[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = m[hr];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * hr], sc[4 * i + 2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (mx == kNegInf) {         // nothing unmasked yet: p = 0, acc stays 0
      alpha[hr] = 1.f;
      M_use[hr] = 0.f;
    } else {
      const float M_new = mx * coef;
      alpha[hr] = m[hr] == kNegInf ? 0.f : fast_exp2(M[hr] - M_new);
      M[hr] = M_new;
      M_use[hr] = M_new;
    }
    m[hr] = mx;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hr = (i >> 1) & 1;
    const float p = fast_exp2(fmaf(sc[i], coef, -M_use[hr]));   // masked: 0
    sc[i] = p;
    rs[hr] += p;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) l[hr] = alpha[hr] * l[hr] + rs[hr];
}

// p (f32) -> three bf16 parts hi + mid + lo that keep ~24 of its bits: hi
// and mid truncate (each remainder is exact in f32 and < 2^-7 of what it is
// taken from), lo rounds the last remainder, so |p - hi - mid - lo| <= 2^-23
// |p|.  A bf16 pair of truncated values is the high halves of two f32s.
__device__ __forceinline__ void split_p(const float (&sc)[32],
                                        uint32_t (&p)[48]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t x0 = __float_as_uint(sc[2 * j]);
    const uint32_t x1 = __float_as_uint(sc[2 * j + 1]);
    p[j] = __byte_perm(x0, x1, 0x7632);
    const float r0 = sc[2 * j] - __uint_as_float(x0 & 0xFFFF0000u);
    const float r1 = sc[2 * j + 1] - __uint_as_float(x1 & 0xFFFF0000u);
    const uint32_t y0 = __float_as_uint(r0), y1 = __float_as_uint(r1);
    p[16 + j] = __byte_perm(y0, y1, 0x7632);
    p[32 + j] = bf16x2_bits(
        __floats2bfloat162_rn(r0 - __uint_as_float(y0 & 0xFFFF0000u),
                              r1 - __uint_as_float(y1 & 0xFFFF0000u)));
  }
}

// o *= alpha per row; skipped (warp-uniformly) when no row max of the warp
// moved, as on most tiles of a long row.
template <int DP>
__device__ __forceinline__ void rescale(WarpgroupTile<DP>& w,
                                        const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) w.o[i] *= alpha[(i >> 1) & 1];
}

template <int DP, int NWG>
__global__ void __launch_bounds__(Layout<DP, NWG>::kThreads,
                                  Layout<DP, NWG>::kBlocksPerSM)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const HArgs a) {
  using L = Layout<DP, NWG>;
  constexpr int kChunks = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base + L::kQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kBar);
  int* released = reinterpret_cast<int*>(q_full + 1 + 2 * kStages);
  const Ring kr = {base + L::kK, q_full + 1, released, &tk};
  const Ring vr = {base + L::kV, q_full + 1 + kStages, released + kStages,
                   &tv};

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  long long bid = blockIdx.x;
  const int qt = a.n_qt - 1 - (int)(bid % a.n_qt);   // longest tiles first
  bid /= a.n_qt;
  const int h = (int)(bid % a.H);
  const int b = (int)(bid / a.H);
  const int hk = h / (a.H / a.Hk);
  const int S = a.S;
  const int q0 = qt * kRows * NWG;

  // the kv tiles some row of this block may attend to
  const int kv_end = a.causal ? min(S, q0 + kRows * NWG) : S;
  long long kv_begin = 0;
  if (a.has_window) {
    // rows - cols < window  <=>  cols >= rows - window + 1 >= q0 - window + 1
    const long long lo = (long long)q0 - a.window + 1;
    kv_begin = lo > 0 ? lo : 0;
  }
  const int t_first = kv_begin < kv_end ? (int)(kv_begin / kRows) : 0;
  const int n_tiles =
      kv_begin < kv_end ? (kv_end + kRows - 1) / kRows - t_first : 0;
  const int live_wgs = min(NWG, (S - q0 + kRows - 1) / kRows);

  if (tid == 0) {
    for (const CUtensorMap* m : {&tq, &tk, &tv})
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(m)) : "memory");
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kr.full[s], 1);
      mbar_init(&vr.full[s], 1);
      kr.released[s] = vr.released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_tiles > 0) {               // thread 0 is the loader: q, then the
      mbar_expect_tx(q_full, live_wgs * L::kTile);   // first ring slots
      for (int w = 0; w < live_wgs; ++w)
        for (int c = 0; c < kChunks; ++c)
          tma_load(sQ + w * L::kTile + c * kBoxBytes, &tq, q_full, c * 64,
                   q0 + w * kRows, h, b);
      for (int t = 0; t < min(kStages, n_tiles); ++t) {
        ring_load<DP>(kr, t, t_first, hk, b);
        ring_load<DP>(vr, t, t_first, hk, b);
      }
    }
  }
  __syncthreads();

  // Warpgroup wg owns query rows wq0 .. wq0 + 63.  A live warpgroup walks
  // every tile of the block: with one warpgroup that run is exactly the
  // tiles its rows may see; with two, the few tiles masked for all of one
  // group's rows (one diagonal tile) are masked like any edge tile.  So the
  // loop runs over warp-uniform bounds, and the wgmma descriptors stay in
  // uniform registers (wg itself is a constant, or lane 0's value).
  const int wg = NWG == 1 ? 0 : __shfl_sync(0xffffffffu, warp / 4, 0);
  const int wq0 = q0 + wg * kRows;
  const bool live = wg < live_wgs;
  const int r_lo = wq0 + 16 * (warp % 4) + lane / 4;   // and r_lo + 8
  const int c_lane = 2 * (lane % 4);
  const float cap_scale = a.has_softcap ? a.scale * (1.f / a.softcap) : 0.f;

  WarpgroupTile<DP> w;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) w.o[i] = 0.f;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    w.m[hr] = kNegInf;
    w.M[hr] = 0.f;
    w.l[hr] = 0.f;
  }
  auto release = [&](const Ring& r, int t) {   // k refills from warp 1,
    ring_release<DP, NWG>(r, t, n_tiles, t_first, hk, b,   // v from warp 2
                          &r == &kr ? 32 : 64);
  };
  auto is_edge = [&](int k0) {       // does a mask cross this tile?
    return k0 + kRows > S || (a.causal && k0 + kRows - 1 > wq0) ||
           (a.has_window && (long long)wq0 + kRows - 1 - k0 >= a.window);
  };

  if (!live) {         // rows past S: wait for each tile, free it, go
    for (int t = 0; t < n_tiles; ++t) {
      ring_acquire(kr, t);
      release(kr, t);
      ring_acquire(vr, t);
      release(vr, t);
    }
    return;
  }
  if (n_tiles > 0) {
    mbar_wait(q_full, 0);
    __syncwarp();
    // base descriptors: a ring slot s sits s * kTile bytes past slot 0
    const uint64_t dq = kmajor_desc(smem_u32(sQ + wg * L::kTile));
    const uint64_t dk0 = kmajor_desc(smem_u32(kr.buf));
    const uint64_t dv0 = mnmajor_desc(smem_u32(vr.buf));
    auto dk = [&](int t) { return dk0 + (t % kStages) * (L::kTile >> 4); };
    auto dv = [&](int t) { return dv0 + (t % kStages) * (L::kTile >> 4); };
    float sc[32], alpha[2];
    // first tile: scores, softmax, nothing to overlap with yet
    ring_acquire(kr, 0);
    issue_scores<DP>(sc, dq, dk(0));
    wg_wait_all();
    fence_acc(sc);
    release(kr, 0);
    int k0 = t_first * kRows;
    softmax_step(sc, w.m, w.M, w.l, alpha, a, cap_scale, k0, r_lo, c_lane,
                 is_edge(k0));
    split_p(sc, w.p);
    // steady state: S of tile t and P V of tile t - 1 go to the tensor cores
    // together; the softmax of tile t runs beside P V of tile t - 1
    for (int t = 1; t < n_tiles; ++t) {
      ring_acquire(kr, t);
      ring_acquire(vr, t - 1);
      issue_scores<DP>(sc, dq, dk(t));
      issue_pv<DP>(w, dv(t - 1));
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(sc);
      release(kr, t);
      k0 = (t_first + t) * kRows;
      softmax_step(sc, w.m, w.M, w.l, alpha, a, cap_scale, k0, r_lo, c_lane,
                   is_edge(k0));
      fence_acc(sc);               // p and the sums are done before the wait,
      fence_acc(w.l);              // so the softmax overlaps P V on the cores
      wg_wait_all();
      fence_acc(w.o);
      release(vr, t - 1);
      rescale<DP>(w, alpha);
      split_p(sc, w.p);
    }
    ring_acquire(vr, n_tiles - 1);
    issue_pv<DP>(w, dv(n_tiles - 1));
    wg_wait_all();
    fence_acc(w.o);
    release(vr, n_tiles - 1);
  }

  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = w.l[hr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[hr] = 1.f / fmaxf(sum, 1e-30f);
  }
  const int D = a.D_true;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r_lo + 8 * hr;
    if (row >= S) continue;
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb +
                          h * a.o_sh + (long long)row * a.o_ss;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * c + 8 * i + c_lane;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(w.o[32 * c + 4 * i + 2 * hr] * inv[hr],
                                    w.o[32 * c + 4 * i + 2 * hr + 1] * inv[hr]);
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda of its own.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (D, S, heads, B) of bf16 with element strides (ss, sh, sb),
// 64 x 64 boxes, 128B swizzle, zero fill out of bounds.  A dimension of
// extent 1 is never stepped, so its stride is replaced by an aligned one.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
              int B, long long ss, long long sh, long long sb) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)(S > 1 ? ss * 2 : 16),
                           (cuuint64_t)(heads > 1 ? sh * 2 : 16),
                           (cuuint64_t)(B > 1 ? sb * 2 : 16)};
  cuuint32_t box[4] = {64, (cuuint32_t)kRows, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int NWG>
int launch_bf16(const CUtensorMap& tq, const CUtensorMap& tk,
                const CUtensorMap& tv, HArgs a, int B, int dev,
                cudaStream_t stream) {
  using L = Layout<DP, NWG>;
  a.n_qt = (a.S + kRows * NWG - 1) / (kRows * NWG);
  const long long blocks = (long long)a.n_qt * a.H * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  static unsigned long long attr_set = 0;   // devices whose limit is raised
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(attr_set & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<DP, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set |= bit;
  }
  flash_attention_bf16_kernel<DP, NWG>
      <<<(unsigned)blocks, L::kThreads, L::kBytes, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// D <= 128: one warpgroup per block, two blocks per SM.  D = 256 (one block
// per SM by shared memory): two warpgroups share each k/v tile when the grid
// still fills the card twice over.
template <int DP>
int pick_bf16(const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, const HArgs& a, int B,
              cudaStream_t stream) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaErrorInvalidValue;
  if constexpr (DP == 256) {
    static int sms[64] = {0};
    int& n = sms[dev & 63];
    if (n == 0 &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return (int)cudaErrorInvalidValue;
    const long long pairs =
        (long long)((a.S + 2 * kRows - 1) / (2 * kRows)) * a.H * B;
    if (pairs >= 2LL * n)
      return launch_bf16<DP, 2>(tq, tk, tv, a, B, dev, stream);
  }
  return launch_bf16<DP, 1>(tq, tk, tv, a, B, dev, stream);
}

int run_bf16(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hk, int S, int D, long long q_sb, long long q_sh,
             long long q_ss, long long k_sb, long long k_sh, long long k_ss,
             long long v_sb, long long v_sh, long long v_ss, long long o_sb,
             long long o_sh, long long o_ss, int causal, int has_window,
             int window, int has_softcap, float softcap, cudaStream_t stream) {
  if (D % 8 != 0 || D > 256) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, S, H, B, q_ss, q_sh, q_sb) ||
      !make_map(&tk, k, D, S, Hk, B, k_ss, k_sh, k_sb) ||
      !make_map(&tv, v, D, S, Hk, B, v_ss, v_sh, v_sb))
    return (int)cudaErrorInvalidValue;
  HArgs a;
  a.o = o;
  a.S = S; a.H = H; a.Hk = Hk; a.D_true = D; a.n_qt = 0;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.causal = causal; a.has_window = has_window; a.window = window;
  a.has_softcap = has_softcap; a.softcap = softcap;
  a.scale = (float)(1.0 / sqrt((double)D));   // D ** -0.5, rounded once
  if (D <= 64) return pick_bf16<64>(tq, tk, tv, a, B, stream);
  if (D <= 128) return pick_bf16<128>(tq, tk, tv, a, B, stream);
  return pick_bf16<256>(tq, tk, tv, a, B, stream);
}

bool valid(int B, int H, int Hk, int S, int has_softcap, float softcap) {
  return B > 0 && H > 0 && Hk > 0 && S > 0 && H % Hk == 0 &&
         (!has_softcap || softcap > 0.f);
}

}  // namespace

// q (B, H, S, D), k and v (B, Hk, S, D), o (B, H, S, D): device arrays of one
// dtype with unit stride along D and the given (b, h, s) element strides.
// causal/has_window/has_softcap are 0 or 1; window may be any int (<= 0 masks
// every column of a causal row).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for sizes the
// kernel does not take (f32: D in {64, 128, 256}, B and H <= 65,535; bf16: D
// a multiple of 8 up to 256, 16-byte aligned bases and (b, h, s) strides).
extern "C" int repro_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hk, int S, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int has_window, int window, int has_softcap,
    float softcap, cudaStream_t stream) {
  if (!valid(B, H, Hk, S, has_softcap, softcap))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.H = H; a.Hk = Hk; a.S = S; a.D = D;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.causal = causal; a.has_window = has_window; a.window = window;
  a.has_softcap = has_softcap; a.softcap = softcap;
  a.scale = (float)(1.0 / sqrt((double)D));   // D ** -0.5, rounded once
  return run_f32(a, B, stream);
}

extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hk, int S, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int has_window, int window, int has_softcap,
    float softcap, cudaStream_t stream) {
  if (!valid(B, H, Hk, S, has_softcap, softcap))
    return (int)cudaErrorInvalidValue;
  return run_bf16(q, k, v, o, B, H, Hk, S, D, q_sb, q_sh, q_ss, k_sb, k_sh,
                  k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, causal,
                  has_window, window, has_softcap, softcap, stream);
}

