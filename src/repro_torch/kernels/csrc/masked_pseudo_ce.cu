// Eq. 5 pseudo-label loss: per row of logits (n, c),
//   max_logp = m - (m + log sum_j exp(x_j - m)),  m = max_j x_j
//   mask = [max_logp >= log theta],  loss = -mask * max_logp,
// and its backward, grad = (softmax(x) - onehot(argmax x)) * (mask * g).
//
// Replaces: repro/kernels/masked_pseudo_ce.py::masked_pseudo_ce_pallas
// (pallas_call at :45), the TPU kernel that padded C to the 128-lane width
// with -1e30 logits and ran (blk, 128) tiles through VMEM, and the
// reference's plain-jnp backward (repro/kernels/ops.py::_mpce_bwd).
//
// What bounds it on the card: launch latency. On the main path a call is
// (100, 9) or (600, 9): a few KB in and out and a few thousand flops, far
// below a microsecond of either memory or arithmetic time, so the launches
// and the host-side dispatch around them are the whole cost.
//
// What the design does about it: the least work per launch, one launch
// per direction. Forward: no padding of C (that was a TPU lane
// constraint); one thread owns a row when c <= 32, one warp owns a row
// (shuffle reductions) when c > 32; a single pass in registers with no
// shared memory. log(theta) arrives already rounded to float32, as the TPU
// kernel computes it.
//
// Backward: one thread a row, bit for bit the plain version's gradient
// on the card (softmax, argmax, one_hot, a difference and two products:
// eight device ops there). A threshold decision on the updates further
// down the round flips on a gradient's last bit, so the kernel repeats
// torch.softmax's arithmetic for c <= 1024 (softmax_warp_forward in
// ATen/native/cuda/PersistentSoftmax.cuh): with P = next_pow2(c) and
// W = min(P, 32) lanes, lane l sums exp(x_j - max) over j = l, l + W, ...
// in order from 0, the lanes then add by an xor butterfly from offset W/2
// down to 1 (padded lanes add an exact 0), and p = e / sum by IEEE
// division. Here the W lanes are an array in one thread's registers, and
// every add is __fadd_rn, so that none fuses with exp's last product into
// one multiply-add: torch's butterfly adds meet across shuffles, where no
// compiler can fuse them, and chip_smoke.py checks the bits. Then
// argmax with ties to the first index (a NaN wins, as in torch.argmax)
// and (p - onehot) * m with m = mask * g rounded first.
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

// the sum over W lanes of softmax_warp_forward, for one row
template <int W>
__device__ __forceinline__ float softmax_sum(const float* x, int c, float m) {
  float part[W];
#pragma unroll
  for (int l = 0; l < W; ++l) {
    float s = 0.0f;
    for (int j = l; j < c; j += W) s = __fadd_rn(s, expf(x[j] - m));
    part[l] = s;
  }
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int l = 0; l < off; ++l) part[l] = __fadd_rn(part[l], part[l + off]);
  }
  return part[0];
}

template <int W>
__global__ void mpce_bwd_rows(const float* __restrict__ logits,
                              const float* __restrict__ mask,
                              const float* __restrict__ g,
                              float* __restrict__ grad, int n, int c) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float* x = logits + (size_t)r * c;
  float* out = grad + (size_t)r * c;
  float m = x[0], best = x[0];
  int arg = 0;
  for (int j = 1; j < c; ++j) {
    float v = x[j];
    m = m > v ? m : v;
    if (!isnan(best) && (isnan(v) || v > best)) {
      best = v;
      arg = j;
    }
  }
  float sum = softmax_sum<W>(x, c, m);
  float mg = mask[r] * g[r];
  for (int j = 0; j < c; ++j) {
    // torch.softmax writes its quiet NaN where the sum is 0
    float p = sum == 0.0f ? __int_as_float(0x7fc00000)
                          : expf(x[j] - m) / sum;
    out[j] = (p - (j == arg ? 1.0f : 0.0f)) * mg;
  }
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

// c <= 1024, torch.softmax's persistent-kernel range; the wrapper checks it
extern "C" int masked_pseudo_ce_bwd_launch(const float* logits,
                                           const float* mask, const float* g,
                                           float* grad, int n, int c,
                                           void* stream) {
  const int threads = 128;
  int blocks = (n + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int p = 1;
  while (p < c) p <<= 1;
#define MPCE_BWD(W)                                                       \
  mpce_bwd_rows<W><<<blocks, threads, 0, st>>>(logits, mask, g, grad, n, c)
  switch (p < 32 ? p : 32) {
    case 1: MPCE_BWD(1); break;
    case 2: MPCE_BWD(2); break;
    case 4: MPCE_BWD(4); break;
    case 8: MPCE_BWD(8); break;
    case 16: MPCE_BWD(16); break;
    default: MPCE_BWD(32); break;
  }
#undef MPCE_BWD
  return static_cast<int>(cudaGetLastError());
}
