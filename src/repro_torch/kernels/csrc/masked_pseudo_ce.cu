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
//
// Above 1024 classes (a language model's vocabulary, 151,936 for qwen2)
// both directions take one block of 1024 threads a row, reading the row
// with 16-byte loads between a scalar head and tail. The plain versions
// there sum exp(x - max) in float64 and round the sum to float32 once
// (ref.py::_exp_sum), so the kernels do the same: each thread adds its
// float32 expf values into a float64 partial, a warp butterfly and a pass
// over the warps' partials add those, and one conversion rounds. The
// float64 sum of 151,936 terms differs between orders by far less than
// half a float32 ulp, so the rounded sum is the plain version's unless
// the exact sum lies on a float32 rounding boundary. The row max and the
// argmax (ties to the first index, a NaN wins, as torch.max and
// torch.argmax) are block reductions on (value, index) pairs. The forward
// finishes as the narrow kernels do; the backward writes the (n, c)
// gradient in one pass, p = e / s by IEEE division.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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

// -- the vocabulary-wide kernels (c > 1024), one block a row -------------
constexpr int kWideThreads = 1024;
constexpr int kWarps = kWideThreads / 32;

// f(j, x[j]) for every j < c that this thread owns: a scalar head up to
// the first 16-byte boundary, float4 loads, a scalar tail
template <class F>
__device__ __forceinline__ void for_row(const float* x, int c, F f) {
  int head = (int)(((16u - (reinterpret_cast<uintptr_t>(x) & 15u)) & 15u)
                   >> 2);
  if (head > c) head = c;
  for (int j = threadIdx.x; j < head; j += kWideThreads) f(j, x[j]);
  int nvec = (c - head) >> 2;
  const float4* v4 = reinterpret_cast<const float4*>(x + head);
  for (int q = threadIdx.x; q < nvec; q += kWideThreads) {
    float4 v = v4[q];
    int j = head + 4 * q;
    f(j, v.x);
    f(j + 1, v.y);
    f(j + 2, v.z);
    f(j + 3, v.w);
  }
  for (int j = head + 4 * nvec + threadIdx.x; j < c; j += kWideThreads)
    f(j, x[j]);
}

// (value, index) of the argmax: the larger value, a NaN over any number,
// the smaller index between equals (and between NaNs)
__device__ __forceinline__ void arg_join(float& v, int& i, float v2,
                                         int i2) {
  bool n1 = isnan(v), n2 = isnan(v2);
  bool take = n1 ? (n2 && i2 < i)
                 : (n2 || v2 > v || (v2 == v && i2 < i));
  if (take) {
    v = v2;
    i = i2;
  }
}

// the row's (max, argmax) over the block, in every thread
__device__ __forceinline__ void block_argmax(const float* x, int c,
                                             float& best, int& arg) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  float v = -INFINITY;
  int i = INT_MAX;
  for_row(x, c, [&](int j, float y) { arg_join(v, i, y, j); });
  for (int off = 16; off > 0; off >>= 1)
    arg_join(v, i, __shfl_xor_sync(0xffffffffu, v, off),
             __shfl_xor_sync(0xffffffffu, i, off));
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  v = sv[lane];
  i = si[lane];
  for (int off = 16; off > 0; off >>= 1)
    arg_join(v, i, __shfl_xor_sync(0xffffffffu, v, off),
             __shfl_xor_sync(0xffffffffu, i, off));
  best = v;
  arg = i;
  __syncthreads();  // sv / si are read before a later reduction writes
}

// sum_j exp(x_j - m) in float64 over the block, rounded to float32 once,
// in every thread
__device__ __forceinline__ float block_exp_sum(const float* x, int c,
                                               float m) {
  __shared__ double sd[kWarps];
  double s = 0.0;
  for_row(x, c, [&](int, float y) { s += (double)expf(y - m); });
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sd[warp] = s;
  __syncthreads();
  s = sd[lane];
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  __syncthreads();
  return (float)s;
}

__global__ void __launch_bounds__(kWideThreads)
mpce_wide_fwd(const float* __restrict__ logits, float* __restrict__ loss,
              float* __restrict__ mask, int c, float log_thr) {
  int r = blockIdx.x;
  const float* x = logits + (size_t)r * c;
  float m;
  int arg;
  block_argmax(x, c, m, arg);
  float s = block_exp_sum(x, c, m);
  if (threadIdx.x == 0) finish_row(m, s, log_thr, loss, mask, r);
}

__global__ void __launch_bounds__(kWideThreads)
mpce_wide_bwd(const float* __restrict__ logits,
              const float* __restrict__ mask, const float* __restrict__ g,
              float* __restrict__ grad, int c) {
  int r = blockIdx.x;
  const float* x = logits + (size_t)r * c;
  float* out = grad + (size_t)r * c;
  float m;
  int arg;
  block_argmax(x, c, m, arg);
  float s = block_exp_sum(x, c, m);
  float mg = mask[r] * g[r];
  auto value = [&](int j, float y) {
    return (expf(y - m) / s - (j == arg ? 1.0f : 0.0f)) * mg;
  };
  if (((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(out))
       & 15u) == 0) {
    // the same offset from a 16-byte boundary: store as it loads
    for_row(x, c, [&](int j, float y) { out[j] = value(j, y); });
  } else {
    for (int j = threadIdx.x; j < c; j += kWideThreads)
      out[j] = value(j, x[j]);
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

// c > 1024: one block a row
extern "C" int masked_pseudo_ce_wide_launch(const float* logits, float* loss,
                                            float* mask, int n, int c,
                                            float log_thr, void* stream) {
  mpce_wide_fwd<<<n, kWideThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, loss, mask, c, log_thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int masked_pseudo_ce_wide_bwd_launch(const float* logits,
                                                const float* mask,
                                                const float* g, float* grad,
                                                int n, int c, void* stream) {
  mpce_wide_bwd<<<n, kWideThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, mask, g, grad, c);
  return static_cast<int>(cudaGetLastError());
}
