// Stream compaction of sparse-delta rows into the CSR wire payload (§IV-F):
// row k of x (K, N) keeps (|x| >= thr[k]) & (x != 0) in ascending column
// order into vals/idx (K, cap); a survivor of row rank >= cap falls off,
// slots past min(nnz, cap) are zero, nnz[k] is the uncapped count.
//
// Replaces: repro/kernels/csr_compact.py::csr_compact2d_pallas (pallas_call
// at :98). The TPU kernel packed each 512-column block with a (512, 512)
// one-hot matmul, because Mosaic has no vector scatter, and relied on the
// sequential grid to carry each block's write offset to the next.
//
// What bounds it on the card: memory. The work is pure data movement:
// read x once (4 * N bytes a row) and write every slot of vals and idx
// once (8 * cap bytes a row), ~250 MB at (6, N = 5,213,449, cap 2,606,725),
// 75 us at 3.35 TB/s.
//
// What the design does about it: one pass in one launch, a single-pass
// scan with decoupled look-back (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016) over tiles of kTile columns:
//   - a block takes its tile from a global ticket counter, row-major, so
//     every tile it waits on below belongs to a block that is already
//     running: no deadlock, whatever order the blocks are scheduled in;
//   - it copies its columns into shared memory (cp.async, so the copies
//     in flight hold no registers and six blocks of 256 threads fit an
//     SM), counts survivors with __ballot_sync / __popc per 32-column
//     chunk and publishes the tile's count in its flag word, status
//     "aggregate";
//   - warp 0 looks back within the row, 32 flags at a time, adding
//     aggregates until it meets an inclusive prefix, then publishes its
//     own inclusive prefix (status "prefix"); the flags are read with
//     ld.acquire.gpu and written with st.release.gpu;
//   - it stores each survivor at offset + rank where that is < cap;
//   - the zero tail [min(nnz, cap), cap) is shared out with no wait: a
//     row's dropped columns, numbered from its last slot downwards in
//     column order, own the slots [nnz, N) one each, so a tile zeroes
//     the slots its own dropped columns own below cap, a contiguous run;
//   - the last tile of the row writes nnz.
// A flag word is epoch << 34 | status << 32 | count. The wrapper gives
// each call a new epoch and the ticket count drawn before it, so neither
// the flags nor the counter are reset between calls: a flag of an earlier
// call reads as "not yet published".
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8192;                    // columns a tile, 16 x 512
constexpr int kItems = kTile / kThreads;       // 32-column chunks a warp
constexpr int kChunks = kTile / 32;            // in column order
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr unsigned long long kStatus = 3ull << 32;

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Warp 0: publish the tile's count, find the survivors of the row's
// earlier tiles, publish the inclusive prefix; returns the exclusive one.
__device__ int look_back(unsigned long long* row_flags, int j, int count,
                         unsigned long long tag, int lane) {
  if (j == 0) {
    if (lane == 0) store_release(row_flags, tag | kPrefix | (unsigned)count);
    return 0;
  }
  if (lane == 0)
    store_release(row_flags + j, tag | kAggregate | (unsigned)count);
  int excl = 0;
  for (int top = j - 1;; top -= 32) {
    int q = top - lane;               // lane 0 reads the nearest tile
    unsigned long long f;
    unsigned waiting, prefixes, needed;
    do {   // tile 0 always publishes a prefix, so q < 0 is never summed
      f = q >= 0 ? load_acquire(row_flags + q) : tag | kPrefix;
      bool ready = (f >> 34) == (tag >> 34) && (f & kStatus);
      waiting = __ballot_sync(0xffffffffu, !ready);
      prefixes = __ballot_sync(0xffffffffu, ready && (f & kStatus) == kPrefix);
      // the lanes up to the nearest published prefix, or all 32
      needed = prefixes ? (2u << (__ffs(prefixes) - 1)) - 1u : 0xffffffffu;
    } while (waiting & needed);
    int v = (int)(unsigned)f;
    excl += warp_sum(needed >> lane & 1u ? v : 0);
    if (prefixes) break;
  }
  if (lane == 0)
    store_release(row_flags + j, tag | kPrefix | (unsigned)(excl + count));
  return excl;
}

__device__ __forceinline__ void copy_async4(float* smem, const float* gmem) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(dst), "l"(gmem) : "memory");
}

__global__ void __launch_bounds__(kThreads)
csr_compact_kernel(const float* __restrict__ x, const float* __restrict__ thr,
                   float* __restrict__ vals, int* __restrict__ idx,
                   int* __restrict__ nnz, unsigned long long* flags,
                   unsigned long long* tickets,
                   unsigned long long ticket_base, unsigned long long tag,
                   int n, int nblk, int cap) {
  __shared__ float s_x[kTile];
  __shared__ unsigned s_ballot[kChunks];
  __shared__ int s_offset[kChunks];     // survivors per chunk, then before it
  __shared__ int s_tile, s_excl, s_count;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    s_tile = (int)(atomicAdd(tickets, 1ull) - ticket_base);
  __syncthreads();
  const int t = s_tile;
  const int k = t / nblk, j = t - k * nblk;
  const int base = j * kTile, cols = min(kTile, n - base);
  const float* xt = x + (size_t)k * n + base;
  const float th = thr[k];

  // thread c copies columns c, c + kThreads, ...: chunk i * kWarps + warp
  // holds the 32 columns (i * kWarps + warp) * 32 + lane, in column order
  for (int c = threadIdx.x; c < cols; c += kThreads)
    copy_async4(s_x + c, xt + c);
  asm volatile("cp.async.wait_all;" ::: "memory");
#pragma unroll 4
  for (int i = 0; i < kItems; ++i) {
    int c = i * kThreads + threadIdx.x;
    float v = c < cols ? s_x[c] : 0.0f;
    unsigned b = __ballot_sync(0xffffffffu, fabsf(v) >= th && v != 0.0f);
    if (lane == 0) {
      s_ballot[i * kWarps + warp] = b;
      s_offset[i * kWarps + warp] = __popc(b);
    }
  }
  __syncthreads();

  if (warp == 0) {
    // exclusive scan of the chunk counts, kChunks / 32 consecutive a lane
    constexpr int kPer = kChunks / 32;
    int c[kPer], own = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      c[i] = s_offset[lane * kPer + i];
      own += c[i];
    }
    int incl = own;
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    int run = incl - own;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      s_offset[lane * kPer + i] = run;
      run += c[i];
    }
    int count = __shfl_sync(0xffffffffu, incl, 31);
    int excl = look_back(flags + (size_t)k * nblk, j, count, tag, lane);
    if (lane == 0) {
      s_excl = excl;
      s_count = count;
    }
  }
  __syncthreads();
  const int excl = s_excl, count = s_count;
  float* vrow = vals + (size_t)k * cap;
  int* irow = idx + (size_t)k * cap;

  if (excl < cap) {
    const unsigned below = (1u << lane) - 1u;
#pragma unroll 4
    for (int i = 0; i < kItems; ++i) {
      unsigned b = s_ballot[i * kWarps + warp];
      if (!((b >> lane) & 1u)) continue;
      int pos = excl + s_offset[i * kWarps + warp] + __popc(b & below);
      if (pos < cap) {
        int c = i * kThreads + threadIdx.x;
        vrow[pos] = s_x[c];
        irow[pos] = base + c;
      }
    }
  }
  // this tile's dropped columns own the slots [hi - dropped, hi)
  const int hi = n - (base - excl);
  const int lo = hi - (cols - count);
  for (int s = lo + threadIdx.x; s < min(hi, cap); s += kThreads) {
    vrow[s] = 0.0f;
    irow[s] = 0;
  }
  if (j == nblk - 1 && threadIdx.x == 0) nnz[k] = excl + count;
}

}  // namespace

// flags: k * ceil(n / kTile) words; tickets: the counter, ticket_base the
// tickets drawn from it before this call; tag: epoch << 34, epoch >= 1
extern "C" int csr_compact_launch(const float* x, const float* thr,
                                  float* vals, int* idx, int* nnz,
                                  void* flags, void* tickets,
                                  long long ticket_base, long long tag, int k,
                                  int n, int cap, void* stream) {
  int nblk = (n + kTile - 1) / kTile;
  csr_compact_kernel<<<k * nblk, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, thr, vals, idx, nnz, static_cast<unsigned long long*>(flags),
      static_cast<unsigned long long*>(tickets),
      (unsigned long long)ticket_base, (unsigned long long)tag, n, nblk, cap);
  return static_cast<int>(cudaGetLastError());
}
