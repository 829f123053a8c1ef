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
// and idx (8 bytes a stored slot) and writes 3 bytes a slot of cap (int8 +
// int16; fp16: 4), 2 bytes a block and 4 a row. At (6, cap = 2,606,725)
// with ~1.04 M slots stored a row that is ~97 MB, 0.029 ms at 3.35 TB/s;
// at (1, cap) ~16 MB, 0.0047 ms.
//
// What the design does about it: one launch, and no byte read twice from
// device memory. A cooperative launch of as many 256-thread blocks as fit
// on the card at once (4 an SM) walks the K * ceil(cap / kTile) tiles of
// kTile slots, grid-stride, twice, with one grid barrier between:
//   phase A  a tile past the stored prefix only writes zero offsets (fp16:
//            zero q). A tile with stored slots reads their values and
//            columns once, every load issued before any store, and writes
//            every offset of the tile (the zero tail included: offsets
//            need no scale). It reduces |v| over the tile and publishes it
//            by one 64-bit atomicMax of epoch << 32 | float bits into its
//            row's word: non-negative floats order as their bits, and a
//            newer epoch dominates any stale word (the words lie apart
//            from the starts, so a stale word is an earlier call's), so
//            no word is zeroed; tile 0 of a row with nothing stored
//            publishes 0, so every row's word carries this call's epoch.
//            It writes the row's block starts: stored slot s writes
//            start[b] = s for every block b in (block(s - 1), block(s)],
//            the neighbour's block from the lane to its left (or one load
//            at a warp's edge), a long run of empty blocks by the whole
//            warp, and the tile holding the prefix's last slot writes
//            start[b] = stored for every b after that slot's block, up to
//            nblk. The ranges of a row partition [0, nblk], so every entry
//            of start (K, nblk + 1) is written exactly once a call: no
//            atomics, no zeroing, and none of the earlier count pass's
//            two binary searches a block (~40 dependent loads). And it
//            keeps its values in shared memory for phase B (the block's
//            first kCacheTiles such tiles; each thread reads back only its
//            own slots, so no sync).
//   barrier  a monotone arrival counter: the wrapper passes the arrivals
//            of earlier calls, so it is never reset. The cooperative
//            launch guarantees every block is resident, or is refused.
//   phase B  the counts start[b + 1] - start[b], their loads issued before
//            the tiles; each tile again: scale and inv = 1 / scale (an
//            IEEE division; no fast math in the build) from its row's
//            word, q for every slot from the kept values (re-read only
//            past the cache's room), the zero tail written without a
//            read.
// A block keeps its row's stored count (and scale) while its tiles stay in
// one row: each read is a round trip. fp16 needs no absmax: q is written
// in phase A, and phase B is the counts alone. The arithmetic is the
// previous three-kernel version's: v * inv, not v / scale; rintf rounds
// half to even; fl(1/127) is folded by the compiler in float; a max is
// exact in any order and the counts are integers. So the output is the
// plain version's bit for bit.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;      // slots a tile
constexpr int kMinBlocks = 4;                     // an SM: <= 64 registers
constexpr int kBlkShift = 9;                      // 512-column blocks
constexpr int kBlk = 1 << kBlkShift;
constexpr int kCacheTiles = 6;                    // tiles a block keeps
constexpr int kCacheBytes = kCacheTiles * kTile * 4;
constexpr float kInv127 = 1.0f / 127.0f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* vals;
  const int* idx;
  const int* stored;
  void* q;
  int16_t* offs;
  int16_t* counts;
  float* scales;
  unsigned long long* absmax;     // (k,) epoch << 32 | float bits
  unsigned long long* arrivals;   // the barrier's counter
  int* start;                     // (k, nblk + 1) block starts
  unsigned long long target;      // arrivals once this call's barrier opens
  unsigned long long tag;         // this call's epoch << 32
  int k, cap, nblk, tiles_per_row;
};

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

// the block of a column; a column past the row's width counts in none
__device__ __forceinline__ int block_of(int col, int nblk) {
  return min(static_cast<int>(static_cast<unsigned>(col) >> kBlkShift), nblk);
}

__device__ __forceinline__ int8_t quantize(float v, float inv) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v * inv), -127.0f), 127.0f));
}

// A block's walk over its tiles t = blockIdx.x, + gridDim.x, ... in
// row-major order: row k, tile j of the row, and the row's stored slots
// (and in phase B its scale), read once for a run of tiles of one row:
// each read is a round trip to memory.
struct Walk {
  int k, j, live;
  int scaled = -1;              // the row whose scale and inv are held
  float scale = 0.0f, inv = 0.0f;

  __device__ explicit Walk(const Args& a)
      : k(blockIdx.x / a.tiles_per_row), j(blockIdx.x % a.tiles_per_row),
        live(min(max(a.stored[k], 0), a.cap)) {}

  __device__ bool next(const Args& a) {
    j += gridDim.x;
    if (j < a.tiles_per_row) return true;
    do {
      j -= a.tiles_per_row;
      ++k;
    } while (j >= a.tiles_per_row);
    if (k >= a.k) return false;
    live = min(max(a.stored[k], 0), a.cap);
    return true;
  }
};

// Slot i of a thread's tile is s0 + i * kThreads, s0 = t0 + threadIdx.x:
// it exists while i * kThreads < cap - s0 and is stored while
// i * kThreads < live - s0.
template <bool kFp16>
__device__ void phase_a(const Args& a, const Walk& w, float* warp_max,
                        float* cache, int& cached) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = w.k, j = w.j, live = w.live;
  const int t0 = j * kTile, s0 = t0 + threadIdx.x;
  const int room = a.cap - s0, lim = live - s0;
  const size_t at = (size_t)k * a.cap + s0;
  int16_t* offs = a.offs + at;
  __half* q16 = static_cast<__half*>(a.q) + at;
  int* srow = a.start + (size_t)k * (a.nblk + 1);
  if (t0 >= live) {                              // block-uniform
    // the zero tail only: offsets (fp16: q) zero; a row with nothing
    // stored writes its starts and publishes a max of 0 from tile 0
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (i * kThreads < room) {
        offs[i * kThreads] = 0;
        if constexpr (kFp16) q16[i * kThreads] = __float2half_rn(0.0f);
      }
    }
    if (j == 0) {
      for (int b = threadIdx.x; b <= a.nblk; b += kThreads) srow[b] = 0;
      if (threadIdx.x == 0) {
        if constexpr (kFp16) a.scales[k] = 1.0f;
        else atomicMax(a.absmax + k, a.tag);
      }
    }
    return;
  }
  // every load of the tile first: a store may alias a load after it in
  // the compiler's view, so loads issued between stores would each wait
  const float* vt = a.vals + at;
  const int* it = a.idx + at;
  float v[kPerThread];
  int col[kPerThread], left[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    v[i] = 0.0f;
    col[i] = left[i] = 0;
    if (i * kThreads < lim) {
      v[i] = vt[i * kThreads];
      col[i] = it[i * kThreads];
      if (lane == 0 && s0 + i * kThreads > 0) left[i] = it[i * kThreads - 1];
    }
  }
  // int8: the block's first kCacheTiles tiles with stored slots keep their
  // values in shared memory for phase B, each thread its own
  if (!kFp16 && cached++ < kCacheTiles) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      cache[(cached - 1) * kTile + i * kThreads + threadIdx.x] = v[i];
  }
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int s = s0 + i * kThreads;
    const bool valid = i * kThreads < lim;
    if (i * kThreads < room) {
      offs[i * kThreads] =
          static_cast<int16_t>(valid ? (col[i] & (kBlk - 1)) : 0);
      if constexpr (kFp16) q16[i * kThreads] = __float2half_rn(v[i]);
    }
    if constexpr (!kFp16) m = fmaxf(m, fabsf(v[i]));
    // block starts: slot s owns the blocks (block(s - 1), block(s)]
    const int cur = valid ? block_of(col[i], a.nblk) : 0;
    int prev = __shfl_up_sync(kFull, cur, 1);
    if (lane == 0 && valid) prev = s == 0 ? -1 : block_of(left[i], a.nblk);
    const bool mine = valid && cur > prev;
    if (!__any_sync(kFull, mine)) continue;      // mostly: no block begins
    const bool wide = mine && cur - prev > 32;
    if (mine && !wide)
      for (int b = prev + 1; b <= cur; ++b) srow[b] = s;
    for (unsigned wb = __ballot_sync(kFull, wide); wb; wb &= wb - 1) {
      const int src = __ffs(wb) - 1;
      const int lo = __shfl_sync(kFull, prev, src) + 1;
      const int hi = __shfl_sync(kFull, cur, src);
      const int from = __shfl_sync(kFull, s, src);
      for (int b = lo + lane; b <= hi; b += 32) srow[b] = from;
    }
  }
  // the tile holding the prefix's last slot writes start[b] = live past
  // that slot's block, up to nblk
  if (live - 1 < t0 + kTile) {
    const int last = a.idx[(size_t)k * a.cap + live - 1];
    for (int b = block_of(last, a.nblk) + 1 + threadIdx.x; b <= a.nblk;
         b += kThreads)
      srow[b] = live;
  }
  if constexpr (kFp16) {
    if (j == 0 && threadIdx.x == 0) a.scales[k] = 1.0f;
  } else {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 1; i < kWarps; ++i) m = fmaxf(m, warp_max[i]);
      atomicMax(a.absmax + k, a.tag | __float_as_uint(m));
    }
    __syncthreads();                             // warp_max is reused
  }
}

__device__ __forceinline__ void grid_barrier(unsigned long long* arrivals,
                                             unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrivals, 1ull);
    while (load_acquire(arrivals) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// counts[i] of the flat (k, nblk) table from the block starts
__device__ __forceinline__ int block_count(const Args& a, long long i) {
  const long long k = i / a.nblk;
  const int* srow = a.start + k * (a.nblk + 1) + (i - k * a.nblk);
  return __ldcg(srow + 1) - __ldcg(srow);
}

// phase B of one int8 tile: the row's scale, then q for every slot, from
// the cache where phase A kept the values, else re-read
__device__ void phase_b_tile(const Args& a, Walk& w, const float* cache,
                             int& cached) {
  const int k = w.k, j = w.j, live = w.live;
  if (k != w.scaled) {
    const unsigned long long word = __ldcg(a.absmax + k);
    if ((word >> 32) != (a.tag >> 32)) __trap();  // no publish this call
    w.scale = __uint_as_float(static_cast<unsigned>(word)) * kInv127;
    w.inv = w.scale > 0.0f ? 1.0f / w.scale : 0.0f;
    w.scaled = k;
  }
  if (j == 0 && threadIdx.x == 0) a.scales[k] = w.scale;
  const int t0 = j * kTile, s0 = t0 + threadIdx.x;
  const int room = a.cap - s0, lim = live - s0;
  const size_t at = (size_t)k * a.cap + s0;
  int8_t* q8 = static_cast<int8_t*>(a.q) + at;
  if (t0 >= live) {                              // block-uniform
    const int8_t zero = quantize(0.0f, w.inv);   // the zero tail
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      if (i * kThreads < room) q8[i * kThreads] = zero;
    return;
  }
  float v[kPerThread];
  if (cached++ < kCacheTiles) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      v[i] = cache[(cached - 1) * kTile + i * kThreads + threadIdx.x];
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      v[i] = i * kThreads < lim ? a.vals[at + i * kThreads] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i)
    if (i * kThreads < room) q8[i * kThreads] = quantize(v[i], w.inv);
}

template <bool kFp16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    csr_quant_kernel(const Args a) {
  __shared__ float warp_max[kWarps];
  extern __shared__ float cache[];               // int8: kCacheBytes
  int cached = 0;
  Walk w(a);
  do {
    phase_a<kFp16>(a, w, warp_max, cache, cached);
  } while (w.next(a));
  grid_barrier(a.arrivals, a.target);
  // counts: a thread's first entry is loaded before the tiles and stored
  // after them, so its loads overlap phase B
  const long long nc = (long long)a.k * a.nblk;
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int first = i < nc ? block_count(a, i) : 0;
  if constexpr (!kFp16) {
    cached = 0;
    Walk wb(a);
    do {
      phase_b_tile(a, wb, cache, cached);
    } while (wb.next(a));
  }
  if (i < nc) a.counts[i] = static_cast<int16_t>(first);
  for (i += stride; i < nc; i += stride)
    a.counts[i] = static_cast<int16_t>(block_count(a, i));
}

const void* kernel_of(int fp16) {
  return fp16 ? reinterpret_cast<const void*>(&csr_quant_kernel<true>)
              : reinterpret_cast<const void*>(&csr_quant_kernel<false>);
}

int cache_bytes(int fp16) { return fp16 ? 0 : kCacheBytes; }

}  // namespace

// Blocks of the fp16 != 0 or int8 kernel that fit on the current device at
// once (the cooperative launch's largest grid), or -cudaError_t; lets the
// int8 kernel take its shared-memory cache. Call it before a launch.
extern "C" int csr_quant_blocks(int fp16) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel_of(fp16),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cache_bytes(fp16));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_of(fp16), kThreads, cache_bytes(fp16));
  return err == cudaSuccess ? sms * per_sm : -static_cast<int>(err);
}

// absmax (k,) and arrivals: 64-bit words; start (k, nblk + 1) int32, apart
// from the words; arrival_base: the arrivals of earlier calls; tag: epoch <<
// 32, epoch >= 1 and above every earlier call's; grid <= csr_quant_blocks.
extern "C" int csr_quant_launch(const float* vals, const int* idx,
                                const int* stored, void* q, int16_t* offs,
                                int16_t* counts, float* scales, void* absmax,
                                void* arrivals, int* start,
                                long long arrival_base, long long tag, int k,
                                int cap, int nblk, int fp16, int grid,
                                void* stream) {
  Args a{vals,
         idx,
         stored,
         q,
         offs,
         counts,
         scales,
         static_cast<unsigned long long*>(absmax),
         static_cast<unsigned long long*>(arrivals),
         start,
         static_cast<unsigned long long>(arrival_base) + grid,
         static_cast<unsigned long long>(tag),
         k,
         cap,
         nblk,
         (cap + kTile - 1) / kTile};
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel_of(fp16), dim3(grid), dim3(kThreads), params, cache_bytes(fp16),
      static_cast<cudaStream_t>(stream)));
}
