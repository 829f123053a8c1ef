// Quantization and index packing of CSR wire rows, the csr_q wire (§IV-F):
// row k of a packed payload (vals, idx) (K, cap) with stored[k] live slots
// becomes
//   q     (K, cap) int8: clip(rint(v * (1 / scale)), -127, 127), with
//         scale = absmax * fl(1/127) over the stored prefix (an all-zero
//         row gets scale 0 and q 0), or an fp16 cast (round to nearest
//         even) with scale 1;
//   offs  (K, cap) int16: idx % 512, zero past the stored prefix;
//   counts (K, nblk) int16: the stored slots in each 512-column block,
//         nblk = ceil(n / 512);
//   scales (K,) f32.
//
// Replaces: repro/kernels/csr_quant.py::csr_quantize2d_pallas (pallas_call
// at :83; its block counts came from a jnp pass after the kernel). The TPU
// kernel ran one program per row (grid=(K,)) over a whole (1, cap) window,
// which on this card would use K of the 132 SMs.
//
// What bounds it on the card: memory. It reads the stored prefix of vals
// and idx (8 bytes a slot) and writes 3 bytes a slot (int8 + int16; fp16:
// 4) over all of cap, plus 2 bytes a block and 4 a row. At (6, cap =
// 2,606,725) that is at most ~172 MB, ~0.05 ms at 3.35 TB/s.
//
// What the design does about it: the absmax is a max, exact in any order,
// so the row's reduction is split over the card:
//   pass 1  (int8 only) grid (ceil(cap/4096), K): each block reduces
//           |v| over its tile of the stored prefix (warp shuffles, then
//           shared memory) and folds it into absmax[k] with one atomicMax
//           on the float's bits (non-negative floats order as their bits;
//           the wrapper zeroes absmax);
//   pass 2  same grid: scale from absmax, inv = 1 / scale as an IEEE
//           division (no fast math in the build), q and offsets for every
//           slot of the tile, coalesced; the first block of a row writes
//           its scale;
//   pass 3  grid (ceil(nblk/256), K): one thread per 512-column block b
//           finds, by binary search over the row's stored columns (which
//           csr_compact writes in ascending order), the first slot at or
//           past column 512 * b and the first at or past 512 * (b + 1);
//           their difference is the count. No scratch, no atomics.
// The arithmetic is the plain version's: v * inv, not v / scale; rintf
// rounds half to even; fl(1/127) is folded by the compiler in float. So
// the output is the plain version's bit for bit.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;
constexpr int kBlk = 512;
constexpr float kInv127 = 1.0f / 127.0f;

__global__ void absmax_kernel(const float* __restrict__ vals,
                              const int* __restrict__ stored,
                              unsigned int* __restrict__ absmax_bits,
                              int cap) {
  __shared__ float warp_max[kThreads / 32];
  int k = blockIdx.y;
  int live = min(stored[k], cap);
  long long t0 = (long long)blockIdx.x * kTile;
  const float* row = vals + (size_t)k * cap;
  float m = 0.0f;
  if (t0 < live) {
#pragma unroll 4
    for (int i = 0; i < kPerThread; ++i) {
      long long s = t0 + (long long)i * kThreads + threadIdx.x;
      if (s < live) m = fmaxf(m, fabsf(row[s]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    if (m > 0.0f) atomicMax(absmax_bits + k, __float_as_uint(m));
  }
}

template <bool kFp16>
__device__ __forceinline__ void store_q(void* q, size_t at, float v,
                                        float inv) {
  if constexpr (kFp16) {
    static_cast<__half*>(q)[at] = __float2half_rn(v);
  } else {
    float r = fminf(fmaxf(rintf(v * inv), -127.0f), 127.0f);
    static_cast<int8_t*>(q)[at] = static_cast<int8_t>(r);
  }
}

template <bool kFp16>
__global__ void quantize_kernel(const float* __restrict__ vals,
                                const int* __restrict__ idx,
                                const int* __restrict__ stored,
                                const unsigned int* __restrict__ absmax_bits,
                                void* __restrict__ q,
                                int16_t* __restrict__ offs,
                                float* __restrict__ scales, int cap) {
  int k = blockIdx.y;
  int live = min(stored[k], cap);
  float scale = 1.0f, inv = 1.0f;
  if (!kFp16) {
    scale = __uint_as_float(absmax_bits[k]) * kInv127;
    inv = scale > 0.0f ? 1.0f / scale : 0.0f;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) scales[k] = scale;
  long long t0 = (long long)blockIdx.x * kTile;
  size_t base = (size_t)k * cap;
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    long long s = t0 + (long long)i * kThreads + threadIdx.x;
    if (s >= cap) break;
    bool valid = s < live;
    float v = valid ? vals[base + s] : 0.0f;
    int off = valid ? (idx[base + s] & (kBlk - 1)) : 0;
    store_q<kFp16>(q, base + s, v, inv);
    offs[base + s] = static_cast<int16_t>(off);
  }
}

// first slot in [0, live) whose column is >= col (live if none)
__device__ __forceinline__ int first_at_or_past(const int* __restrict__ row,
                                           int live, long long col) {
  int lo = 0, hi = live;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((long long)row[mid] < col) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void block_count_kernel(const int* __restrict__ idx,
                                   const int* __restrict__ stored,
                                   int16_t* __restrict__ counts, int cap,
                                   int nblk) {
  int k = blockIdx.y;
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblk) return;
  int live = min(stored[k], cap);
  const int* row = idx + (size_t)k * cap;
  int first = first_at_or_past(row, live, (long long)b * kBlk);
  int last = first_at_or_past(row, live, (long long)(b + 1) * kBlk);
  counts[(size_t)k * nblk + b] = static_cast<int16_t>(last - first);
}

}  // namespace

// absmax_bits: (k,) zeroed by the caller; fp16 != 0 skips pass 1.
extern "C" int csr_quant_launch(const float* vals, const int* idx,
                                const int* stored, unsigned int* absmax_bits,
                                void* q, int16_t* offs, int16_t* counts,
                                float* scales, int k, int cap, int nblk,
                                int fp16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((cap + kTile - 1) / kTile, k);
  if (fp16) {
    quantize_kernel<true><<<grid, kThreads, 0, s>>>(
        vals, idx, stored, absmax_bits, q, offs, scales, cap);
  } else {
    absmax_kernel<<<grid, kThreads, 0, s>>>(vals, stored, absmax_bits, cap);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    quantize_kernel<false><<<grid, kThreads, 0, s>>>(
        vals, idx, stored, absmax_bits, q, offs, scales, cap);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 cgrid((nblk + kThreads - 1) / kThreads, k);
  block_count_kernel<<<cgrid, kThreads, 0, s>>>(idx, stored, counts, cap,
                                                nblk);
  return static_cast<int>(cudaGetLastError());
}
