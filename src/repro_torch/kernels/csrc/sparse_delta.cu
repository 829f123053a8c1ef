// Magnitude-threshold sparsification of stacked parameter deltas (§IV-F),
// the dense_masked wire: row k of x (K, N) keeps |x| >= thr[k] (exact zeros
// too when thr[k] <= 0), everything else becomes 0, and the survivors of
// every 512-column block are counted into nnz (K, ceil(N / 512)).
//
// Replaces: repro/kernels/sparse_delta.py::sparse_delta2d_pallas
// (pallas_call at :67; the K = 1 sparse_delta_pallas at :109 and the
// quantile-fed sparse_delta2d_quantile_pallas at :96 call it). The TPU
// kernel ran a (K, ceil(N/512)) grid of (1, 512) VMEM tiles after the
// wrapper zero-padded N to a multiple of 512, and kept the pad out of the
// count with a column-index guard.
//
// What bounds it on the card: memory. Per element it reads 4 bytes, writes
// 4 and does a compare and a select; the counts add 4 bytes per 512
// columns. At K = 6, N = 5,213,449 that is ~250 MB, ~75 us at 3.35 TB/s.
//
// What the design does about it: one pass, each element read once and
// written once. Grid (ceil(N/512), K): a block of 128 threads owns one
// 512-column tile of one row, each thread 4 consecutive columns, loaded
// and stored as one 16-byte vector wherever the row's address is aligned
// (rows k > 0 of an odd N are not, and go scalar, as in staleness_agg.cu).
// No padding of N: the ragged tail is masked in the kernel. The tile's
// count is four __syncthreads_count calls, one per column slot, over
// predicates that are false past column N, so thr <= 0 never counts pad
// columns. Blocks are independent, so their order does not matter, and
// the output is the plain version's bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;
constexpr int kThreads = kTile / 4;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void sparse_delta_kernel(const float* __restrict__ x,
                                    const float* __restrict__ thr,
                                    float* __restrict__ out,
                                    int* __restrict__ nnz, long long n,
                                    int nblk) {
  int j = blockIdx.x, k = blockIdx.y;
  long long c0 = (long long)j * kTile + 4LL * threadIdx.x;
  long long rest = n - c0;
  int live = rest <= 0 ? 0 : (rest < 4 ? (int)rest : 4);
  float t = thr[k];
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool keep[4] = {false, false, false, false};
  if (live > 0) {
    const float* row = x + (size_t)k * n + c0;
    float* orow = out + (size_t)k * n + c0;
    if (live == 4 && aligned16(row)) {
      float4 q = *reinterpret_cast<const float4*>(row);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      for (int i = 0; i < live; ++i) v[i] = row[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      keep[i] = i < live && fabsf(v[i]) >= t;
      v[i] = keep[i] ? v[i] : 0.0f;
    }
    if (live == 4 && aligned16(orow)) {
      *reinterpret_cast<float4*>(orow) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int i = 0; i < live; ++i) orow[i] = v[i];
    }
  }
  // every thread of the block reaches the barriers, live or not
  int c = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) c += __syncthreads_count(keep[i]);
  if (threadIdx.x == 0) nnz[(size_t)k * nblk + j] = c;
}

}  // namespace

extern "C" int sparse_delta_launch(const float* x, const float* thr,
                                   float* out, int* nnz, int k, long long n,
                                   int nblk, void* stream) {
  dim3 grid(nblk, k);
  sparse_delta_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, thr, out,
                                                             nnz, n, nblk);
  return static_cast<int>(cudaGetLastError());
}
