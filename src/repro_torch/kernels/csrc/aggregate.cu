// Eq. 4 model mix on Hopper (sm_90a):  Y[r, p] = sum_j W[r, j] * X[col_ids[j], p]
//
// Replaces the TPU kernel src/repro/kernels/aggregate.py::_panel_matmul (body
// _aggregate_kernel), which the JAX package reaches through aggregate_rows
// (the row-sparse (k, N) @ (N, P) mix) and aggregate_rows_cols (the
// column-sparse (k, u) @ X[col_ids]).  One kernel covers both: col_ids == NULL
// means col_ids = arange(N).
//
// What bounds it on an H100: at the simulation plane's shapes (N = 100
// workers, P = 6,922 f32 parameters, k and u in {8, 16, 32, 64, 100}) one call
// moves (u*P + k*P + k*u) * 4 bytes -- at most 5.6 MB, 1.7 us at 3.35 TB/s --
// and does 2*k*u*P flops, which only at k = u = 100 reaches the f32 op bound
// (2.1 us at 67 TFLOP/s).  Both bounds are a few microseconds or less, so in
// practice a launch's fixed cost bounds it.
//
// What the design does about that: one launch per round does the whole mix.
// The TPU path gathered the (u, P) slab X[col_ids] into memory, padded P to
// the panel width and sliced the result back; here the gather is fused into
// the loads (the slab is never written), the ragged P edge is masked in the
// kernel, and the output needs no slice.  Each block owns kRows output rows
// times a tile of blockDim.x parameter columns, one column per thread; it
// stages its rows of W and the matching col_ids in shared memory, kJTile
// columns of W at a time (so any n_in fits), and each thread keeps its kRows
// sums in f32 registers.  Consecutive threads read consecutive p of the same X
// row, so every X load is a coalesced warp access; X is read once per row
// group and the groups of one column tile hit it in L2.  The sums are IEEE
// f32 fmaf on the CUDA cores in order j = 0..n_in-1 -- no TF32, as the TPU
// kernel accumulated with preferred_element_type=f32.
//
// An entry of col_ids outside [0, n_rows) is never dereferenced: it makes the
// affected outputs NaN, so a bad index shows in the result instead of reading
// out of bounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kRows = 8;      // output rows per block = sums per thread
constexpr int kJTile = 128;   // columns of W staged in shared memory per pass

__global__ void aggregate_kernel(const float* __restrict__ W,
                                 const float* __restrict__ X,
                                 const int* __restrict__ col_ids,
                                 float* __restrict__ Y,
                                 int k, int n_in, int n_rows, int P) {
  __shared__ float w_s[kRows][kJTile];
  __shared__ int c_s[kJTile];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, k - r0);

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int j0 = 0; j0 < n_in; j0 += kJTile) {
    const int jn = min(kJTile, n_in - j0);
    __syncthreads();                       // the previous tile is consumed
    for (int i = threadIdx.x; i < kRows * kJTile; i += blockDim.x) {
      const int r = i / kJTile, j = i % kJTile;
      w_s[r][j] = (r < rows && j < jn)
                      ? W[(size_t)(r0 + r) * n_in + j0 + j] : 0.f;
    }
    for (int j = threadIdx.x; j < jn; j += blockDim.x)
      c_s[j] = col_ids ? col_ids[j0 + j] : j0 + j;
    __syncthreads();
    if (p < P) {
      for (int j = 0; j < jn; ++j) {
        const int c = c_s[j];
        const float x = ((unsigned)c < (unsigned)n_rows)
                            ? X[(size_t)c * P + p] : nanf("");
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(w_s[r][j], x, acc[r]);
      }
    }
  }
  if (p < P) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) Y[(size_t)(r0 + r) * P + p] = acc[r];
  }
}

}  // namespace

// W (k, n_in), X (n_rows, P), col_ids (n_in,) or NULL, Y (k, P): contiguous
// f32 / i32 device arrays.  p_blk threads per block (a multiple of 32, at most
// 1024).  Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int repro_aggregate_f32(const float* W, const float* X,
                                   const int* col_ids, float* Y, int k,
                                   int n_in, int n_rows, int P, int p_blk,
                                   cudaStream_t stream) {
  if (k <= 0 || n_in <= 0 || P <= 0 || p_blk <= 0 || p_blk > 1024 ||
      p_blk % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((P + p_blk - 1) / p_blk, (k + kRows - 1) / kRows);
  aggregate_kernel<<<grid, p_blk, 0, stream>>>(W, X, col_ids, Y, k, n_in,
                                               n_rows, P);
  return (int)cudaGetLastError();
}
