// Stream compaction of sparse-delta rows into the CSR wire payload (§IV-F):
// row k of x (K, N) keeps (|x| >= thr[k]) & (x != 0) in ascending column
// order into vals/idx (K, cap); a survivor of row rank >= cap falls off.
//
// Replaces: repro/kernels/csr_compact.py::csr_compact2d_pallas (pallas_call
// at :98). The TPU kernel packed each 512-column block with a (512, 512)
// one-hot matmul, because Mosaic has no vector scatter, and relied on the
// sequential grid to let one block's window overwrite the previous one's
// stale tail.
//
// What bounds it on the card: memory. The work is pure data movement:
// read 4 * N bytes per row (each pass reads x once), write
// 8 * min(nnz, cap) bytes. At N = 5,213,449 that is ~21 MB in and ~8 MB
// out per row, a few microseconds at 3.35 TB/s.
//
// What the design does about it: Hopper has scatter, so the pack is a
// plain indexed store, and blocks run in any order because every block
// knows its global write offset before it writes:
//   pass 1  grid (ceil(N/512), K): count survivors per 512-column tile
//           (__syncthreads_count), guarding col < N;
//   pass 2  an exclusive scan of the (K, nblk) counts, done by the
//           wrapper with torch.cumsum (the TPU version also scans outside
//           its kernel, in jnp);
//   pass 3  same grid: in-tile rank from __ballot_sync/__popc within each
//           warp plus a shared-memory prefix over the tile's 16 warps;
//           store at offset + rank wherever that is < cap. A tile whose
//           offset is already >= cap returns at once.
// Coalesced loads of x; the stores are contiguous runs per tile. The
// wrapper pre-zeroes vals/idx, so slots past min(nnz, cap) stay zero and
// the output is bit-identical to the plain version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 512;
constexpr int kWarps = kTile / 32;

__device__ __forceinline__ bool keep_of(const float* x, const float* thr,
                                        int k, int col, int n, float* v) {
  if (col >= n) return false;
  *v = x[(size_t)k * n + col];
  return fabsf(*v) >= thr[k] && *v != 0.0f;
}

__global__ void csr_count(const float* __restrict__ x,
                          const float* __restrict__ thr,
                          int* __restrict__ counts, int n, int nblk) {
  int j = blockIdx.x, k = blockIdx.y;
  float v;
  bool keep = keep_of(x, thr, k, j * kTile + threadIdx.x, n, &v);
  int c = __syncthreads_count(keep);
  if (threadIdx.x == 0) counts[(size_t)k * nblk + j] = c;
}

__global__ void csr_scatter(const float* __restrict__ x,
                            const float* __restrict__ thr,
                            const int* __restrict__ offsets,
                            float* __restrict__ vals, int* __restrict__ idx,
                            int n, int nblk, int cap) {
  __shared__ int warp_counts[kWarps];
  int j = blockIdx.x, k = blockIdx.y;
  int base = offsets[(size_t)k * nblk + j];
  if (base >= cap) return;  // uniform across the block
  int col = j * kTile + threadIdx.x;
  float v = 0.0f;
  bool keep = keep_of(x, thr, k, col, n, &v);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  if (!keep) return;
  int pos = base + __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) pos += warp_counts[w];
  if (pos < cap) {
    vals[(size_t)k * cap + pos] = v;
    idx[(size_t)k * cap + pos] = col;
  }
}

}  // namespace

extern "C" int csr_compact_count(const float* x, const float* thr,
                                 int* counts, int k, int n, int nblk,
                                 void* stream) {
  dim3 grid(nblk, k);
  csr_count<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      x, thr, counts, n, nblk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int csr_compact_scatter(const float* x, const float* thr,
                                   const int* offsets, float* vals, int* idx,
                                   int k, int n, int nblk, int cap,
                                   void* stream) {
  dim3 grid(nblk, k);
  csr_scatter<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      x, thr, offsets, vals, idx, n, nblk, cap);
  return static_cast<int>(cudaGetLastError());
}
