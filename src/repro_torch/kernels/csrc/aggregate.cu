// Eq. 4 model mix on Hopper (sm_90a):  Y[r, p] = sum_j W[r, j] * X[col_ids[j], p]
//
// Replaces the TPU kernel src/repro/kernels/aggregate.py::_panel_matmul (body
// _aggregate_kernel), which the JAX package reaches through aggregate_rows
// (the row-sparse (k, N) @ (N, P) mix) and aggregate_rows_cols (the
// column-sparse (k, u) @ X[col_ids]).  col_ids == NULL means col_ids =
// arange(N).  The TPU path gathered the (u, P) slab X[col_ids] into memory,
// padded P to the panel width and sliced the result back; here the gather is
// fused into the loads (the slab is never written) and the ragged P edge is
// masked in the kernel.
//
// What bounds it on an H100.  At the simulation plane's shapes (N = 100
// workers, P = 6,922 f32 parameters, k and u in {8, 16, 32, 64, 100}) a call
// moves at most 5.6 MB (1.7 us at 3.35 TB/s) and does 2*k*u*P flops, which
// at k = u = 100 is the larger bound (2.1 us at 67 TFLOP/s f32).  At the LM
// fleets' shapes (k = 2 rows of an (8, P) buffer, P = 1.35e8 and 4.5e8) it
// moves 10 * 4 * P bytes and is bound by device memory (1.6 and 5.4 ms).
//
// The design: one pass over X with the rows' sums in registers.  The kernel
// is templated on the row count R in {1, 2, 4, 8} (row groups of 8 over
// blockIdx.y above 8), so k = 2 carries two accumulators, not eight.  Each
// thread works on V adjacent columns with V-wide loads and stores, and loads
// eight X rows before their FMAs, so 8 * 4 * V bytes per thread are in
// flight on a kernel that is bytes-bound at the LM shapes.  W's rows for a
// pass of 128 values of j sit in shared memory j-major, so a thread's R
// weights for one j are adjacent.  Above 8 rows each row group reads X
// again; the sim plane's X (2.8 MB) stays in the H100's 50 MB L2.
//
// Alignment.  X's rows start P * 4 bytes apart, so 16-byte loads are legal
// only when P % 4 == 0 (the LM buffers); the sim plane's P = 6,922 allows 8
// bytes.  The C entry takes V = 4, 2 or 1 floats, the widest that X's and Y's
// base addresses and P allow (a TMA map, whose strides must be multiples of
// 16 bytes, would refuse P = 6,922).
//
// Sums.  Every output is IEEE f32 fmaf over j = 0 .. n_in - 1 in order,
// starting from 0 -- no TF32, as the TPU kernel accumulated with
// preferred_element_type=f32 -- so V and R never change a result's bits.
//
// 64-bit columns.  P and every column offset are 64-bit, so a buffer past
// 2^31 columns (full-depth fleets) needs no split; the launch is refused only
// past the grid's limits (x at most 2^31 - 1 blocks, y at most 65,535).
//
// An entry of col_ids outside [0, n_rows) is never dereferenced: the sums
// that would read it (every output of the call) come out NaN, so a bad
// index shows in the result instead of reading out of bounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr long long kGridXMax = 2147483647LL;
constexpr int kGridYMax = 65535;

// ---- V-wide global loads and stores (V = 4, 2, 1 floats) ----
template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

constexpr int kJTile = 128;   // columns of W (values of j) staged per pass
constexpr int kUnroll = 8;    // X rows loaded before their FMAs

template <int R, int V>
__global__ void __launch_bounds__(1024)
aggregate_kernel(const float* __restrict__ W, const float* __restrict__ X,
                 const int* __restrict__ col_ids, float* __restrict__ Y,
                 int k, int n_in, int n_rows, long long P) {
  __shared__ __align__(16) float w_s[kJTile][R];   // j-major: rows contiguous
  __shared__ int c_s[kJTile];
  const long long p =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int r0 = blockIdx.y * R;
  const int rows = min(R, k - r0);

  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;

  auto step = [&](int j, const float (&x)[V]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float w = w_s[j][r];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = fmaf(w, x[v], acc[r][v]);
    }
  };
  auto load_x = [&](int j, float (&x)[V]) {
    const int c = c_s[j];
    if ((unsigned)c < (unsigned)n_rows) {
      load_vec<V>(x, X + (long long)c * P + p);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = nanf("");
    }
  };

  for (int j0 = 0; j0 < n_in; j0 += kJTile) {
    const int jn = min(kJTile, n_in - j0);
    __syncthreads();                       // the previous pass is consumed
    for (int i = threadIdx.x; i < jn * R; i += blockDim.x) {
      const int j = i / R, r = i % R;
      w_s[j][r] = r < rows ? W[(size_t)(r0 + r) * n_in + j0 + j] : 0.f;
    }
    for (int j = threadIdx.x; j < jn; j += blockDim.x)
      c_s[j] = col_ids ? col_ids[j0 + j] : j0 + j;
    __syncthreads();
    if (p < P) {
      int j = 0;
      for (; j + kUnroll <= jn; j += kUnroll) {
        float x[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) load_x(j + u, x[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) step(j + u, x[u]);
      }
      for (; j < jn; ++j) {
        float x[V];
        load_x(j, x);
        step(j, x);
      }
    }
  }
  if (p < P) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < rows) store_vec<V>(Y + (long long)(r0 + r) * P + p, acc[r]);
  }
}

template <int R, int V>
int launch_stream(const float* W, const float* X, const int* col_ids,
                  float* Y, int k, int n_in, int n_rows, long long P,
                  int p_blk, cudaStream_t stream) {
  const long long cols = (long long)p_blk * V;
  const long long gx = (P + cols - 1) / cols;
  const long long gy = ((long long)k + R - 1) / R;
  if (gx > kGridXMax || gy > kGridYMax) return (int)cudaErrorInvalidValue;
  aggregate_kernel<R, V><<<dim3((unsigned)gx, (unsigned)gy), p_blk, 0,
                           stream>>>(W, X, col_ids, Y, k, n_in, n_rows, P);
  return (int)cudaGetLastError();
}

template <int V>
int stream_rows(const float* W, const float* X, const int* col_ids, float* Y,
                int k, int n_in, int n_rows, long long P, int p_blk,
                cudaStream_t s) {
  if (k <= 1) return launch_stream<1, V>(W, X, col_ids, Y, k, n_in, n_rows,
                                         P, p_blk, s);
  if (k <= 2) return launch_stream<2, V>(W, X, col_ids, Y, k, n_in, n_rows,
                                         P, p_blk, s);
  if (k <= 4) return launch_stream<4, V>(W, X, col_ids, Y, k, n_in, n_rows,
                                         P, p_blk, s);
  return launch_stream<8, V>(W, X, col_ids, Y, k, n_in, n_rows, P, p_blk, s);
}

// The widest copy (in floats) that X's and Y's rows allow: every row starts
// P * 4 bytes after the last.
int vec_width(const void* X, const void* Y, long long P) {
  const uintptr_t a = (uintptr_t)X | (uintptr_t)Y;
  if (P % 4 == 0 && a % 16 == 0) return 4;
  if (P % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

}  // namespace

// W (k, n_in), X (n_rows, P), col_ids (n_in,) or NULL, Y (k, P): contiguous
// f32 / i32 device arrays; p_blk threads per block (a multiple of 32, at most
// 1024), each on V adjacent columns.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for sizes the
// grid cannot hold.
extern "C" int repro_aggregate_f32(const float* W, const float* X,
                                   const int* col_ids, float* Y, int k,
                                   int n_in, int n_rows, long long P,
                                   int p_blk, cudaStream_t stream) {
  if (k <= 0 || n_in <= 0 || P <= 0 || p_blk <= 0 || p_blk > 1024 || p_blk % 32 != 0)
    return (int)cudaErrorInvalidValue;
  switch (vec_width(X, Y, P)) {
    case 4: return stream_rows<4>(W, X, col_ids, Y, k, n_in, n_rows, P,
                                  p_blk, stream);
    case 2: return stream_rows<2>(W, X, col_ids, Y, k, n_in, n_rows, P,
                                  p_blk, stream);
    default: return stream_rows<1>(W, X, col_ids, Y, k, n_in, n_rows, P,
                                   p_blk, stream);
  }
}
