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
// the cost is bytes: a (16, 151936) call reads 9.7 MB (the backward also
// writes 9.7 MB), 2.9 us (5.8 us) at 3.35 TB/s, where one block a row
// kept 16 of the 132 SMs busy and read each row two or three times. So a
// row goes to a cluster of kCluster = 6 blocks, each owning a contiguous
// slice of wide_slice(c) columns (rounded up to 4 floats, so that the
// slices of a 16-byte aligned row start on 16-byte boundaries; the last
// slice is the rest). Six, not the portable eight: on an H100 SXM a
// cluster of 8 finds one block an SM for only 15 clusters at once, so 16
// rows put two blocks on 8 SMs and the cluster waits for them; 16
// clusters of 6 take 96 SMs, one block each, and measured faster at 16
// and at 96 rows. A block copies its slice into shared memory once, by
// TMA 1-D bulk copies (cp.async.bulk, kChunks of them, each completing on
// its own mbarrier, all issued before any is used) for the 16-byte
// aligned middle and scalar loads for the head and tail (fewer than 4
// columns each); the max, the exp sum and the backward's write then read
// that copy, as float4s. The plain versions sum exp(x - max) in float64
// and round the sum to float32 once (ref.py::_exp_sum), and so do the
// kernels: thread t keeps four float64 partials, one a float4 lane, each
// over the slice's float4s w = t, t + 512, ... in order (the head column
// first in partial 0, the tail column last), adds them as (p0 + p1) +
// (p2 + p3), a warp xor butterfly and a butterfly over the 16 warps'
// sums give the block's partial, and the 6 partials are added in rank
// order and rounded once. The float64 sum of 151,936 terms differs
// between orders by far less than half a float32 ulp, so the rounded sum
// is the plain version's unless the exact sum lies on a float32 rounding
// boundary. The row's (max, argmax) (ties to the first index, a NaN wins,
// as torch.max and torch.argmax) is each block's arg_join over its slice,
// then the 6 pairs joined in rank order. The cluster exchanges through
// distributed shared memory: each block stores its pair (then its
// partial) into slot [rank] of every block of the cluster with st.async,
// which counts the bytes on the receiving block's own mbarrier, and each
// block waits on its mbarrier for all six and reads its own slots. The
// only cluster barrier is a relaxed arrive at the start, waited on
// before the first store, so that no block is written to before its
// mbarriers exist; no block reads another's shared memory, and every
// block waits for all stores into it, so a block may exit as soon as it
// is done. The forward finishes as the narrow kernels do, in rank 0; the
// backward writes each slice's (e / s - onehot) * (mask * g) from the
// exp values kept in shared memory, with 16-byte stores where the output
// shares the logits' alignment. A slice whose copy would not fit in
// shared memory (c above 347,112, wide_smem_bytes > kOnChipBytes) is read
// from device memory in each pass, with the same arithmetic in the same
// order: a branch by width, never a fallback. The wrapper's ops.wide_plan
// repeats this plan.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mbarrier.cuh"

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

// -- the vocabulary-wide kernels (c > 1024), a cluster a row ------------
namespace cg = cooperative_groups;

constexpr int kCluster = 6;          // blocks a row (ops.WIDE_CLUSTER)
constexpr int kWideThreads = 512;    // threads a block (ops.WIDE_THREADS)
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kAlign = 4;            // a slice is a multiple of 4 floats
constexpr int kChunks = 4;           // bulk copies a slice
// dynamic shared memory a block may take for its slice (ops.WIDE_ON_CHIP):
// 227 KB less 1 KB for the static arrays
constexpr int kOnChipBytes = 227 * 1024 - 1024;

// columns a block owns: ceil(c / kCluster) rounded up to kAlign
__host__ __device__ __forceinline__ int wide_slice(int c) {
  int q = (c - 1) / kCluster + 1;
  return (q + kAlign - 1) / kAlign * kAlign;
}

// the slice's copy in shared memory: up to kAlign - 1 floats of padding
// put its 16-byte aligned middle on a 16-byte boundary
__host__ __device__ __forceinline__ long long wide_smem_bytes(int c) {
  return 4LL * (wide_slice(c) + kAlign);
}

__host__ __device__ __forceinline__ bool wide_on_chip(int c) {
  return wide_smem_bytes(c) <= kOnChipBytes;
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

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to 16-byte
// aligned shared `dst` by TMA, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// until the phase of parity `parity` has completed, with what the
// cluster's blocks stored into this block (st.async) visible
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the address of this block's shared `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// 8 bytes into another block's shared memory (cluster addresses), counted
// on that block's mbarrier `bar`
__device__ __forceinline__ void st_async_pair(uint32_t addr, float v, int i,
                                              uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
      "[%0], {%1, %2}, [%3];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(i), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async_f64(uint32_t addr, double d,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 "
      "[%0], %1, [%2];\n" ::"r"(addr),
      "d"(d), "r"(bar)
      : "memory");
}

// float4s [v0, v1) of the slice's nvec are chunk k's bulk copy
__device__ __forceinline__ int chunk_vec(int nvec, int k) {
  return (int)((long long)nvec * k / kChunks);
}

// One row a cluster of kCluster blocks; block `rank` owns columns
// [rank q, min(c, (rank + 1) q)), q = wide_slice(c). kFwd: loss and mask
// of row r (out, mask_out); else the gradient (out) from mask_in and g.
// kOnChip: the slice is copied into shared memory once; else each pass
// reads it from device memory.
template <bool kFwd, bool kOnChip>
__global__ void __launch_bounds__(kWideThreads, 2)
mpce_cluster(const float* __restrict__ logits,
             const float* __restrict__ mask_in, const float* __restrict__ g,
             float* __restrict__ out, float* __restrict__ mask_out, int c,
             float log_thr) {
  extern __shared__ __align__(16) float buf[];
  __shared__ __align__(8) uint64_t bars[kChunks];
  // written by the cluster's blocks, slot k by rank k, counted on xbar[0]
  // (pairs) and xbar[1] (partials)
  __shared__ __align__(8) uint64_t xbar[2];
  __shared__ __align__(8) int2 pair[kCluster];   // (value bits, index)
  __shared__ double part[kCluster];
  __shared__ float warp_v[kWideWarps];
  __shared__ int warp_i[kWideWarps];
  __shared__ double warp_s[kWideWarps];

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int r = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = wide_slice(c);
  const int lo = min(c, rank * q);
  const int len = min(c - lo, q);
  const float* x = logits + (size_t)r * c + lo;
  // the slice: a scalar head up to the first 16-byte boundary, nvec
  // float4s, a scalar tail; s_x[j] holds x[j], its middle 16-byte aligned
  int head = (int)(((16u - (reinterpret_cast<uintptr_t>(x) & 15u)) & 15u)
                   >> 2);
  if (head > len) head = len;
  const int nvec = (len - head) >> 2;
  const int tail0 = head + 4 * nvec;   // fewer than 4 columns from here
  float* s_x = buf + ((kAlign - head) & (kAlign - 1));

  if (tid == 0) {
    if (kOnChip)
      for (int k = 0; k < kChunks; ++k) mbar_init(smem_u32(&bars[k]), 1);
    for (int k = 0; k < 2; ++k) {
      mbar_init(smem_u32(&xbar[k]), 1);
      mbar_expect_tx(smem_u32(&xbar[k]), 8 * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this block's mbarriers are ready: the cluster's first store into it
  // waits for every block's arrival
  cluster_arrive_relaxed();
  __syncthreads();
  if (kOnChip) {
    if (tid == 0) {
      for (int k = 0; k < kChunks; ++k) {
        int v0 = chunk_vec(nvec, k), v1 = chunk_vec(nvec, k + 1);
        uint32_t bar = smem_u32(&bars[k]), bytes = 16u * (v1 - v0);
        mbar_expect_tx(bar, bytes);
        if (bytes)
          bulk_load(smem_u32(s_x + head + 4 * v0), x + head + 4 * v0, bytes,
                    bar);
      }
    }
    // head and tail: each column read back only by the thread loading it
    if (tid < head) s_x[tid] = x[tid];
    if (tail0 + tid < len) s_x[tail0 + tid] = x[tail0 + tid];
  }

  // the slice's (max, argmax), chunk by chunk as the copies land: four
  // (value, index) pairs a thread, one a float4 lane, for independent
  // chains; the head and tail columns join pair 0
  const float* src = kOnChip ? s_x : x;   // head + 4 w is 16-byte aligned
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  float v[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  int i[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
  if (tid < head) arg_join(v[0], i[0], src[tid], lo + tid);
  if (tail0 + tid < len)
    arg_join(v[0], i[0], src[tail0 + tid], lo + tail0 + tid);
  for (int k = 0; k < (kOnChip ? kChunks : 1); ++k) {
    int v0 = kOnChip ? chunk_vec(nvec, k) : 0;
    int v1 = kOnChip ? chunk_vec(nvec, k + 1) : nvec;
    if (kOnChip) mbar_wait(smem_u32(&bars[k]), 0);
    int w = v0 + ((tid - v0) % kWideThreads + kWideThreads) % kWideThreads;
#pragma unroll 2
    for (; w < v1; w += kWideThreads) {
      float4 y = src4[w];
      int j = lo + head + 4 * w;
      arg_join(v[0], i[0], y.x, j);
      arg_join(v[1], i[1], y.y, j + 1);
      arg_join(v[2], i[2], y.z, j + 2);
      arg_join(v[3], i[3], y.w, j + 3);
    }
  }
  for (int q = 1; q < 4; ++q) arg_join(v[0], i[0], v[q], i[q]);
  for (int off = 16; off > 0; off >>= 1)
    arg_join(v[0], i[0], __shfl_xor_sync(0xffffffffu, v[0], off),
             __shfl_xor_sync(0xffffffffu, i[0], off));
  if (lane == 0) {
    warp_v[warp] = v[0];
    warp_i[warp] = i[0];
  }
  __syncthreads();
  float bv = lane < kWideWarps ? warp_v[lane] : -INFINITY;
  int bi = lane < kWideWarps ? warp_i[lane] : INT_MAX;
  for (int off = 16; off > 0; off >>= 1)
    arg_join(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
             __shfl_xor_sync(0xffffffffu, bi, off));
  cluster_wait();
  if (tid < kCluster)
    st_async_pair(map_rank(smem_u32(&pair[rank]), tid), bv, bi,
                  map_rank(smem_u32(&xbar[0]), tid));
  mbar_wait_cluster(smem_u32(&xbar[0]), 0);
  float m = __int_as_float(pair[0].x);
  int arg = pair[0].y;
  for (int k = 1; k < kCluster; ++k)
    arg_join(m, arg, __int_as_float(pair[k].x), pair[k].y);

  // the slice's float64 sum of exp(x - m): four partials a thread, one a
  // float4 lane, each in order over w = tid, tid + 512, ...; the head
  // column is partial 0's first term, the tail column its last; the
  // thread's sum is (p0 + p1) + (p2 + p3). The backward keeps exp in s_x.
  double p[4] = {0.0, 0.0, 0.0, 0.0};
  if (tid < head) {
    float e = expf(src[tid] - m);
    if (kOnChip && !kFwd) s_x[tid] = e;
    p[0] += (double)e;
  }
#pragma unroll 2
  for (int w = tid; w < nvec; w += kWideThreads) {
    float4 y = src4[w];
    float4 e = make_float4(expf(y.x - m), expf(y.y - m), expf(y.z - m),
                           expf(y.w - m));
    if (kOnChip && !kFwd) reinterpret_cast<float4*>(s_x + head)[w] = e;
    p[0] += (double)e.x;
    p[1] += (double)e.y;
    p[2] += (double)e.z;
    p[3] += (double)e.w;
  }
  if (tail0 + tid < len) {
    float e = expf(src[tail0 + tid] - m);
    if (kOnChip && !kFwd) s_x[tail0 + tid] = e;
    p[0] += (double)e;
  }
  double s = (p[0] + p[1]) + (p[2] + p[3]);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) warp_s[warp] = s;
  __syncthreads();
  s = lane < kWideWarps ? warp_s[lane] : 0.0;
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (tid < kCluster)
    st_async_f64(map_rank(smem_u32(&part[rank]), tid), s,
                 map_rank(smem_u32(&xbar[1]), tid));
  mbar_wait_cluster(smem_u32(&xbar[1]), 0);
  double total = part[0];
  for (int k = 1; k < kCluster; ++k) total += part[k];
  const float sum = (float)total;

  if (kFwd) {
    if (rank == 0 && tid == 0) finish_row(m, sum, log_thr, out, mask_out, r);
    return;
  }
  // on chip each thread reads back the exp values it wrote; else it
  // computes them again from the logits
  const float mg = mask_in[r] * g[r];
  float* o = out + (size_t)r * c + lo;
  auto value = [&](int j, float y) {
    float e = kOnChip ? y : expf(y - m);
    return (e / sum - (lo + j == arg ? 1.0f : 0.0f)) * mg;
  };
  if (((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(o))
       & 15u) == 0) {
    // the same offset from a 16-byte boundary: 16-byte stores
    if (tid < head) o[tid] = value(tid, src[tid]);
    float4* o4 = reinterpret_cast<float4*>(o + head);
#pragma unroll 2
    for (int w = tid; w < nvec; w += kWideThreads) {
      float4 y = src4[w];
      int j = head + 4 * w;
      o4[w] = make_float4(value(j, y.x), value(j + 1, y.y),
                          value(j + 2, y.z), value(j + 3, y.w));
    }
    if (tail0 + tid < len)
      o[tail0 + tid] = value(tail0 + tid, src[tail0 + tid]);
  } else {
    if (kOnChip) __syncthreads();  // s_x was written in float4 order
    for (int j = tid; j < len; j += kWideThreads) o[j] = value(j, src[j]);
  }
}

// mpce_cluster<kFwd, true>'s dynamic shared memory allowed up to
// kOnChipBytes, once a device
template <bool kFwd>
cudaError_t allow_on_chip() {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(mpce_cluster<kFwd, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kOnChipBytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <bool kFwd, bool kOnChip>
int launch_cluster(const float* logits, const float* mask_in, const float* g,
                   float* out, float* mask_out, int n, int c, float log_thr,
                   cudaStream_t st) {
  if (n > INT_MAX / kCluster) return static_cast<int>(cudaErrorInvalidValue);
  if (kOnChip) {
    cudaError_t err = allow_on_chip<kFwd>();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * kCluster));
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = kOnChip ? (size_t)wide_smem_bytes(c) : 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, mpce_cluster<kFwd, kOnChip>,
                                       logits, mask_in, g, out, mask_out, c,
                                       log_thr);
  cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
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

// c > 1024: a cluster of kCluster blocks a row; a refused cluster launch
// (too much shared memory, no room for the cluster) returns its error
extern "C" int masked_pseudo_ce_wide_launch(const float* logits, float* loss,
                                            float* mask, int n, int c,
                                            float log_thr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wide_on_chip(c)
             ? launch_cluster<true, true>(logits, nullptr, nullptr, loss,
                                          mask, n, c, log_thr, st)
             : launch_cluster<true, false>(logits, nullptr, nullptr, loss,
                                           mask, n, c, log_thr, st);
}

extern "C" int masked_pseudo_ce_wide_bwd_launch(const float* logits,
                                                const float* mask,
                                                const float* g, float* grad,
                                                int n, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wide_on_chip(c)
             ? launch_cluster<false, true>(logits, mask, g, grad, nullptr, n,
                                           c, 0.0f, st)
             : launch_cluster<false, false>(logits, mask, g, grad, nullptr, n,
                                            c, 0.0f, st);
}
