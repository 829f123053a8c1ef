// Eq. 5 pseudo-label loss: per row of logits (n, c),
//   max_logp = m - (m + log sum_j exp(x_j - m)),  m = max_j x_j
//   mask = [max_logp >= log theta],  loss = -mask * max_logp.
//
// Replaces: repro/kernels/masked_pseudo_ce.py::masked_pseudo_ce_pallas
// (pallas_call at :45), the TPU kernel that padded C to the 128-lane width
// with -1e30 logits and ran (blk, 128) tiles through VMEM.
//
// What bounds it on the card: launch latency. On the main path a call is
// (100, 9): 3.6 KB in, 0.8 KB out and a few thousand flops, far below a
// microsecond of either memory or arithmetic time, so the launch and the
// host-side dispatch around it are the whole cost.
//
// What the design does about it: the least work per launch. No padding of
// C (that was a TPU lane constraint); one thread owns a row when c <= 32,
// one warp owns a row (shuffle reductions) when c > 32; a single pass in
// registers with no shared memory and no second launch. log(theta) arrives
// already rounded to float32, as the TPU kernel computes it. Fusing the
// backward or batching several steps' rows per launch (or a CUDA graph of
// the whole step) is the lever a later change can pull.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ void finish_row(float m, float s, float log_thr,
                                           float* loss, float* mask, int r) {
  float lse = m + logf(s);
  float max_logp = m - lse;
  float k = max_logp >= log_thr ? 1.0f : 0.0f;
  loss[r] = -k * max_logp;
  mask[r] = k;
}

__global__ void mpce_thread_rows(const float* __restrict__ logits,
                                 float* __restrict__ loss,
                                 float* __restrict__ mask, int n, int c,
                                 float log_thr) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float* x = logits + (size_t)r * c;
  float m = -INFINITY;
  for (int j = 0; j < c; ++j) m = fmaxf(m, x[j]);
  float s = 0.0f;
  for (int j = 0; j < c; ++j) s += expf(x[j] - m);
  finish_row(m, s, log_thr, loss, mask, r);
}

__global__ void mpce_warp_rows(const float* __restrict__ logits,
                               float* __restrict__ loss,
                               float* __restrict__ mask, int n, int c,
                               float log_thr) {
  int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (r >= n) return;  // r is uniform across the warp
  const float* x = logits + (size_t)r * c;
  float m = -INFINITY;
  for (int j = lane; j < c; j += 32) m = fmaxf(m, x[j]);
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.0f;
  for (int j = lane; j < c; j += 32) s += expf(x[j] - m);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) finish_row(m, s, log_thr, loss, mask, r);
}

}  // namespace

extern "C" int masked_pseudo_ce_launch(const float* logits, float* loss,
                                       float* mask, int n, int c,
                                       float log_thr, void* stream) {
  const int threads = 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c <= 32) {
    int blocks = (n + threads - 1) / threads;
    mpce_thread_rows<<<blocks, threads, 0, st>>>(logits, loss, mask, n, c,
                                                 log_thr);
  } else {
    int rows_per_block = threads / 32;
    int blocks = (n + rows_per_block - 1) / rows_per_block;
    mpce_warp_rows<<<blocks, threads, 0, st>>>(logits, loss, mask, n, c,
                                               log_thr);
  }
  return static_cast<int>(cudaGetLastError());
}
