// Eq. 5 local SGD on Hopper (sm_90a): `steps` SGD steps of the simulation
// plane's 3-layer ReLU MLP on each gathered worker row of the flat buffer.
//
// Replaces the TPU kernel src/repro/kernels/fused_sgd.py::fused_sgd (body
// _make_kernel).  Numerics mirror the plain version, local_sgd_flat_fused, op
// for op: the same forward, the closed-form cross-entropy backward
// dz = (softmax(logits) - onehot) / batch, every gradient taken from the
// weights as they were BEFORE the step, and the update w - (active * lr) * g,
// so a row with active = 0 leaves bit-identical.  with_losses = 0 drops the
// log-sum-exp chain and writes zero losses; with_losses = 1 reports, for every
// row (inactive ones too), the mean over steps of the batch-mean NLL.
//
// What bounds it on an H100: at the simulation plane's defaults (P = 6,922,
// batch 32, dim 32, hidden 64, 10 classes, 2 steps) a row costs ~2.3 MFLOP,
// so even k = 100 rows are ~0.24 GFLOP -- ~3.5 us at 67 TFLOP/s f32 -- over
// ~6 MB of rows and minibatches (~1.8 us at 3.35 TB/s).  A launch's fixed
// cost is of the same size, so latency, not the card's rates, bounds it.
//
// What the design does about that: one launch per round trains every row, one
// block per row (k <= 100 < 132 SMs: one wave).  The block copies its row to
// the output and updates the weights there in place; at these sizes a row
// (27 KB) stays in L1/L2 across the steps.  One step's activations (x, z1, z2,
// logits/dz, dh2, dh1: ~38 KB at the defaults) live in dynamic shared memory,
// so the forward, the backward and the update never leave the SM between
// phases.  The layer widths, the leaf offsets, steps and batch are runtime
// arguments, so every MLP that fused_sgd_supported accepts runs, as long as
// one step's activations fit the 227 KB a block can have (the wrapper checks).
// Keeping the whole row resident in shared memory is left for later.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

// Column offsets of the six leaves in a flat row (jax's sorted-key order
// b1, b2, b3, w1, w2, w3) and the layer widths: w1 (d, h), w2 (h, g), w3 (g, c).
struct Layout {
  int off_b1, off_b2, off_b3, off_w1, off_w2, off_w3;
  int d, h, g, c;
};

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.f); }

__global__ void fused_sgd_kernel(const float* __restrict__ buf,
                                 const float* __restrict__ xb,
                                 const int* __restrict__ yb,
                                 const float* __restrict__ scale,
                                 float* __restrict__ out,
                                 float* __restrict__ loss, int P, Layout L,
                                 int steps, int batch, int with_losses) {
  extern __shared__ float smem[];
  const int B = batch, D = L.d, H = L.h, G = L.g, C = L.c;
  float* x_s = smem;              // (B, D) this step's inputs
  float* z1_s = x_s + B * D;      // (B, H) pre-activations of layer 1
  float* z2_s = z1_s + B * H;     // (B, G) pre-activations of layer 2
  float* dz_s = z2_s + B * G;     // (B, C) logits, then d(loss)/d(logits)
  float* dh2_s = dz_s + B * C;    // (B, G)
  float* dh1_s = dh2_s + B * G;   // (B, H)
  float* nll_s = dh1_s + B * H;   // (B,)   per-sample NLL

  const int row = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* src = buf + (size_t)row * P;
  float* w = out + (size_t)row * P;
  for (int i = tid; i < P; i += nt) w[i] = src[i];
  float* b1 = w + L.off_b1;
  float* b2 = w + L.off_b2;
  float* b3 = w + L.off_b3;
  float* w1 = w + L.off_w1;
  float* w2 = w + L.off_w2;
  float* w3 = w + L.off_w3;
  const float s = scale[row];
  float loss_sum = 0.f;           // thread 0: sum over steps of batch means

  for (int t = 0; t < steps; ++t) {
    const float* x = xb + ((size_t)row * steps + t) * B * D;
    const int* y = yb + ((size_t)row * steps + t) * B;
    for (int i = tid; i < B * D; i += nt) x_s[i] = x[i];
    __syncthreads();              // the row copy / last update and x are in

    for (int i = tid; i < B * H; i += nt) {          // z1 = x @ w1 + b1
      const int b = i / H, j = i % H;
      float acc = 0.f;
      for (int q = 0; q < D; ++q) acc = fmaf(x_s[b * D + q], w1[q * H + j], acc);
      z1_s[i] = acc + b1[j];
    }
    __syncthreads();
    for (int i = tid; i < B * G; i += nt) {          // z2 = relu(z1) @ w2 + b2
      const int b = i / G, j = i % G;
      float acc = 0.f;
      for (int q = 0; q < H; ++q)
        acc = fmaf(relu(z1_s[b * H + q]), w2[q * G + j], acc);
      z2_s[i] = acc + b2[j];
    }
    __syncthreads();
    for (int i = tid; i < B * C; i += nt) {          // logits = relu(z2) @ w3 + b3
      const int b = i / C, j = i % C;
      float acc = 0.f;
      for (int q = 0; q < G; ++q)
        acc = fmaf(relu(z2_s[b * G + q]), w3[q * C + j], acc);
      dz_s[i] = acc + b3[j];
    }
    __syncthreads();
    for (int b = tid; b < B; b += nt) {              // softmax / CE per sample
      float* l = dz_s + b * C;
      const int yl = y[b];
      float m = -INFINITY;
      for (int j = 0; j < C; ++j) m = fmaxf(m, l[j]);
      float sum = 0.f;
      for (int j = 0; j < C; ++j) sum += expf(l[j] - m);
      if (with_losses) {
        const float lse = logf(sum);
        float nll = 0.f;
        for (int j = 0; j < C; ++j) {
          const float logp = (l[j] - m) - lse;
          const float onehot = (j == yl) ? 1.f : 0.f;
          if (j == yl) nll = -logp;
          l[j] = (expf(logp) - onehot) / (float)B;
        }
        nll_s[b] = nll;
      } else {
        for (int j = 0; j < C; ++j) {
          const float onehot = (j == yl) ? 1.f : 0.f;
          l[j] = (expf(l[j] - m) / sum - onehot) / (float)B;
        }
      }
    }
    __syncthreads();
    if (with_losses && tid == 0) {
      float tot = 0.f;
      for (int b = 0; b < B; ++b) tot += nll_s[b];
      loss_sum += tot / (float)B;
    }
    for (int i = tid; i < B * G; i += nt) {          // dh2 = dz @ w3^T * (z2 > 0)
      const int b = i / G, q = i % G;
      float acc = 0.f;
      for (int j = 0; j < C; ++j) acc = fmaf(dz_s[b * C + j], w3[q * C + j], acc);
      dh2_s[i] = z2_s[i] > 0.f ? acc : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < B * H; i += nt) {          // dh1 = dh2 @ w2^T * (z1 > 0)
      const int b = i / H, q = i % H;
      float acc = 0.f;
      for (int j = 0; j < G; ++j) acc = fmaf(dh2_s[b * G + j], w2[q * G + j], acc);
      dh1_s[i] = z1_s[i] > 0.f ? acc : 0.f;
    }
    // Every gradient below reads shared memory only, and every weight read of
    // this step (forward, dh2, dh1) happened before this barrier.
    __syncthreads();
    for (int i = tid; i < G * C; i += nt) {          // w3 -= s * relu(z2)^T dz
      const int q = i / C, j = i % C;
      float g = 0.f;
      for (int b = 0; b < B; ++b) g = fmaf(relu(z2_s[b * G + q]), dz_s[b * C + j], g);
      w3[i] = w3[i] - s * g;
    }
    for (int j = tid; j < C; j += nt) {              // b3 -= s * sum_b dz
      float g = 0.f;
      for (int b = 0; b < B; ++b) g += dz_s[b * C + j];
      b3[j] = b3[j] - s * g;
    }
    for (int i = tid; i < H * G; i += nt) {          // w2 -= s * relu(z1)^T dh2
      const int q = i / G, j = i % G;
      float g = 0.f;
      for (int b = 0; b < B; ++b) g = fmaf(relu(z1_s[b * H + q]), dh2_s[b * G + j], g);
      w2[i] = w2[i] - s * g;
    }
    for (int j = tid; j < G; j += nt) {              // b2 -= s * sum_b dh2
      float g = 0.f;
      for (int b = 0; b < B; ++b) g += dh2_s[b * G + j];
      b2[j] = b2[j] - s * g;
    }
    for (int i = tid; i < D * H; i += nt) {          // w1 -= s * x^T dh1
      const int q = i / H, j = i % H;
      float g = 0.f;
      for (int b = 0; b < B; ++b) g = fmaf(x_s[b * D + q], dh1_s[b * H + j], g);
      w1[i] = w1[i] - s * g;
    }
    for (int j = tid; j < H; j += nt) {              // b1 -= s * sum_b dh1
      float g = 0.f;
      for (int b = 0; b < B; ++b) g += dh1_s[b * H + j];
      b1[j] = b1[j] - s * g;
    }
    __syncthreads();              // updates visible before the next forward
  }
  if (tid == 0) loss[row] = with_losses ? loss_sum / (float)steps : 0.f;
}

constexpr int kThreads = 256;

}  // namespace

// Dynamic shared memory one block needs for one step's activations.
extern "C" long long repro_fused_sgd_smem_bytes(int batch, int d, int h,
                                                int g, int c) {
  const long long B = batch;
  return 4LL * (B * d + 2 * B * h + 2 * B * g + B * c + B);
}

// buf (k, P) f32 rows; xb (k, steps, batch, d) f32; yb (k, steps, batch) i32;
// scale (k,) f32 = active * lr; out (k, P) f32; loss (k,) f32: contiguous
// device arrays.  layout: 10 host ints, the Layout fields in order.  Launches
// on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int repro_fused_sgd_f32(const float* buf, const float* xb,
                                   const int* yb, const float* scale,
                                   float* out, float* loss, int k, int P,
                                   const int* layout, int steps, int batch,
                                   int with_losses, cudaStream_t stream) {
  const Layout L{layout[0], layout[1], layout[2], layout[3], layout[4],
                 layout[5], layout[6], layout[7], layout[8], layout[9]};
  const long long smem = repro_fused_sgd_smem_bytes(batch, L.d, L.h, L.g, L.c);
  if (k <= 0 || P <= 0 || steps <= 0 || batch <= 0 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_sgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_sgd_kernel<<<k, kThreads, (size_t)smem, stream>>>(
      buf, xb, yb, scale, out, loss, P, L, steps, batch, with_losses);
  return (int)cudaGetLastError();
}
