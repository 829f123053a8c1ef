// Eq. 10 inner sum of the FedS3A aggregation: out[c] = sum_k w[k] * d[k, c]
// over a (K, N) stack of flattened client (or group) models.
//
// Replaces: repro/kernels/staleness_agg.py::staleness_agg_pallas
// (pallas_call at :33), which ran (K, 512) tiles through VMEM after the
// wrapper padded N to a multiple of 512.
//
// What bounds it on the card: memory. (K + 1) * 4 * N bytes move for
// 2 * K * N flops, a quarter of a flop per byte, far under the H100's
// ~20 flops/byte float32 balance point. At K = 6, N = 5,213,449 that is
// ~146 MB, ~44 us at 3.35 TB/s.
//
// What the design does about it: one pass over the stack, each element
// read once and the output written once. A 1-D grid over N; each thread
// owns 4 consecutive columns and walks k = 0..K-1 in order, accumulating
// in float32 registers, with a 16-byte vector load wherever the row's
// address is aligned and a scalar load otherwise (rows k > 0 of an odd N
// are not). No padding to 512: the ragged tail is masked in the kernel.
// Multiply and add are rounded separately (__fmul_rn/__fadd_rn, no FMA
// contraction), so the result is the plain version's loop bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void staleness_agg_kernel(const float* __restrict__ d,
                                     const float* __restrict__ w,
                                     float* __restrict__ out, int k_rows,
                                     long long n) {
  long long c0 = 4LL * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (c0 >= n) return;
  int live = n - c0 < 4 ? (int)(n - c0) : 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < k_rows; ++k) {
    const float* row = d + (size_t)k * n + c0;
    float wk = w[k];
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live == 4 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
      float4 q = *reinterpret_cast<const float4*>(row);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      for (int i = 0; i < live; ++i) v[i] = row[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(wk, v[i]));
  }
  float* o = out + c0;
  if (live == 4 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    for (int i = 0; i < live; ++i) o[i] = acc[i];
  }
}

}  // namespace

extern "C" int staleness_agg_launch(const float* d, const float* w,
                                    float* out, int k, long long n,
                                    void* stream) {
  const int threads = 256;
  long long per_block = 4LL * threads;
  long long blocks = (n + per_block - 1) / per_block;
  staleness_agg_kernel<<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(d, w, out, k, n);
  return static_cast<int>(cudaGetLastError());
}
