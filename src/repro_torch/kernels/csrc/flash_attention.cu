// Causal (optionally sliding-window) attention by online softmax, for the
// prefill of the model zoo's decoders: out = softmax(q k^T / sqrt(hd)) v,
// with q (B, S, Hq, hd) and k, v (B, S, Hkv, hd) in bf16 or float32, the
// output in q's dtype. GQA is read in place: query head h reads KV head
// h / (Hq / Hkv), with no repeated copy of K or V.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention_pallas
// (pallas_call at :86), which ran a (B*H, S/128, S/128) grid of 128 x 128
// tiles in order on one TPU core, carrying the accumulator, the row max m
// and the row sum l in VMEM scratch from one KV step to the next, after its
// wrapper (repro/kernels/ops.py:29) repeated the KV heads G times.
//
// What it computes, as the TPU kernel does, all in float32:
//   s = (q . k) * (1 / sqrt(hd)); s = -1e30 where the key is masked
//   m' = max(m, max_j s); corr = exp(m - m'); p = exp(s - m')
//   l = l * corr + sum_j p;  acc = acc * corr + p v
//   out = acc / max(l, 1e-30), rounded to the output type to nearest
// with m starting at -1e30, exp (not exp2 with a folded log2 e), and a key
// masked unless kp <= qp (and kp > qp - window with a window).
//
// What bounds it on the card: operations. At the serve prefill shape
// (B = 8, S = 1,819, Hq = 12, Hkv = 2, hd = 128, causal) it does 8.14e10
// flops on 104 MB of q, k, v and out in bf16, ~780 flops a byte, far above
// the card's balance point (~295 in bf16 on the tensor cores).
//
// bf16: the tensor cores (flash_attention_wgmma below). One CTA covers 128
// query rows of one (batch, query head): a producer warpgroup, of which one
// thread starts every copy, and two consumer warpgroups of 64 rows. The
// grid is (B * Hq, S / 128) with the query tiles of most causal work first
// over all heads, so the light tiles fill the last wave. 384 threads start
// at 168 registers each (65,536 / 384; ptxas held a CTA with one producer
// warp, 288 threads, to the same 168), and setmaxnreg then moves the
// producer's to the consumers: 40 a thread against 232. The
// producer loads the Q tile once and K and V tiles of BK = 64 keys into a
// ring of NST = 4 stages by TMA, from 4-D tensor maps over (hd, H, S, B)
// with 128-byte swizzle (an hd = 128 row is two 64-column atoms),
// completing on mbarriers; a consumer warp hands a stage back once both of
// its products have read it. TMA fills keys and rows past S with zeros:
// those keys are masked, those rows are not stored. A consumer warpgroup
// computes only the tiles that reach its own 64 rows, and per tile:
//   s = q k^T on wgmma (m64n64k16, A = Q and B = K in shared memory, both
//     K-major), float32 accumulation: a bf16 product is exact in float32,
//     so only the order of summation differs from the plain form;
//   the online softmax on the accumulator fragments, a row's values in the
//     4 threads of a quad (max and sum by __shfl_xor over lanes 1 and 2);
//     only tiles on the diagonal, on the window's edge or past S are masked;
//   o += p v as two wgmma (m64n{hd}k16, A from registers, B = V in shared
//     memory through the transposed, MN-major descriptor), p_hi =
//     bf16_rn(p), then p_lo = bf16_rn(p - p_hi). The float32 accumulator's
//     fragment layout is the A-fragment layout of the next product, so p
//     never leaves registers. One bf16 rounding of p errs by up to 2^-9 of
//     each weight, and an output that cancels near zero then lands hundreds
//     of bf16 ulps from the plain form; hi + lo leaves ~2^-17, for 1.5x the
//     MMA work of one bf16 p v. TF32 for p v would keep only 10 bits.
// The products of neighbouring tiles overlap the softmax: s of tile i and
// p v of tile i - 1 are started together, the softmax of tile i runs once s
// is in, while p v is still on the tensor cores. l is summed from the
// unrounded float32 p. A consumer thread holds the 32-float s accumulator,
// the hd / 2-float o accumulator and p_hi / p_lo as 16 packed registers
// each. Shared memory at hd = 128: Q 32 KB and 32 KB of K + V a stage,
// 160 KB in all, one CTA an SM.
//
// float32: the FFMA kernel (flash_attention_kernel below), no tensor-core
// format keeping its 2e-5 agreement. One CTA of 256 threads per
// (b * Hq + h, 64-row query tile), the query tiles with the most causal
// work launched first. The q tile is staged once in shared memory,
// transposed; each 64-key K and V tile is staged the same way (K
// transposed, V as rows), zero past S. Each thread owns a 4 x 4 block of
// the 64 x 64 logits (4 query rows, 4 keys), built by FFMA from 16-byte
// shared-memory loads, and a 4 x hd/16 block of the output accumulator for
// the same 4 rows, so the rows' m, l and corr stay in its registers; the
// row max and sum are reduced across the 16 threads of a row group by warp
// shuffles. p goes back through shared memory (over the spent K tile) for
// the p v product.
//
// Skipped tiles (both kernels): KV tiles wholly above the diagonal of the
// query tile (the bf16 kernel: of each warpgroup's 64 rows), and with a
// window those wholly before every row's window, are never computed. The
// TPU kernel visits them, but yields the same: a masked score is -1e30,
// so once a row has seen a real key (m > -1e30) a masked key's p is
// exp(-1e30 - m) = 0, and a tile that a row saw before any real key (where
// m = -1e30 and each masked p = 1) is wiped by corr = exp(-1e30 - m') = 0
// at its first real key. Every row sees itself, so every row meets a real
// key. Keys past S (a ragged last tile) are masked the same way; rows past
// S are computed but not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {


constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 256;  // 16 x 16: ty owns 4 rows, tx 4 keys / hd/16 columns
constexpr int KPAD = BK + 4;  // row pitch of the transposed K tile
constexpr int PPAD = BQ + 4;  // row pitch of the transposed p tile
constexpr float MASKED = -1e30f;

__device__ __forceinline__ void load16(const float* src, float* dst) {
  float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

// N consecutive floats of shared memory, 16 bytes at a time
template <int N>
__device__ __forceinline__ void lds(const float* p, float* r) {
  static_assert(N % 4 == 0, "hd/16 must be a multiple of 4");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    float4 x = *reinterpret_cast<const float4*>(p + i);
    r[i] = x.x; r[i + 1] = x.y; r[i + 2] = x.z; r[i + 3] = x.w;
  }
}

template <int HD>
__host__ __device__ constexpr int kp_floats() {  // K tile, then p tile
  return HD * KPAD > BK * PPAD ? HD * KPAD : BK * PPAD;
}

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(HD * BQ + kp_floats<HD>() + BK * HD) * sizeof(float);
}

// rows x HD elements of a (., S, H, HD) tensor from row `row0` into shared
// memory as floats, zero past S: transposed (dst[d * pitch + r]) or as rows
// (dst[r * HD + d])
template <typename T, int HD, int ROWS, bool TRANSPOSE>
__device__ __forceinline__ void stage(const T* __restrict__ src,
                                      long long stride, int row0, int S,
                                      float* dst, int pitch) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = HD / VEC;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    // transposed: neighbouring threads take neighbouring rows, so their
    // shared-memory stores fall in distinct banks; as rows: neighbouring
    // chunks of one row, coalesced in device memory
    int r = TRANSPOSE ? i % ROWS : i / CHUNKS;
    int c = TRANSPOSE ? i / ROWS : i % CHUNKS;
    float x[VEC];
    if (row0 + r < S) {
      load16(src + (long long)(row0 + r) * stride + c * VEC, x);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (TRANSPOSE) dst[(c * VEC + j) * pitch + r] = x[j];
      else dst[r * HD + c * VEC + j] = x[j];
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int Hq, int Hkv, int causal, int window, float scale) {
  constexpr int COLS = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [HD][BQ]: q tile, transposed
  float* ks = qs + HD * BQ;              // [HD][KPAD]: K tile, transposed
  float* ps = ks;                        // [BK][PPAD]: p tile, over the K tile
  float* vs = ks + kp_floats<HD>();      // [BK][HD]: V tile

  const int qt = gridDim.x - 1 - blockIdx.x;  // most causal work first
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long q_stride = (long long)Hq * HD;
  const long long kv_stride = (long long)Hkv * HD;
  const T* qb = q + (long long)b * S * q_stride + (long long)h * HD;
  const T* kb = k + (long long)b * S * kv_stride + (long long)hk * HD;
  const T* vb = v + (long long)b * S * kv_stride + (long long)hk * HD;

  stage<T, HD, BQ, true>(qb, q_stride, q0, S, qs, BQ);

  float o[4][COLS], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) o[i][c] = 0.0f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_end = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  const int kt_begin =
      (causal && window > 0) ? max(q0 - window + 1, 0) / BK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's p and V are consumed
    stage<T, HD, BK, true>(kb, kv_stride, k0, S, ks, KPAD);
    stage<T, HD, BK, false>(vb, kv_stride, k0, S, vs, HD);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float4 a = *reinterpret_cast<const float4*>(qs + d * BQ + ty * 4);
      float4 bk = *reinterpret_cast<const float4*>(ks + d * KPAD + tx * 4);
      float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp && (window <= 0 || kp > qp - window);
        s[i][j] = ok ? s[i][j] * scale : MASKED;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row group are one half-warp (tx = lane % 16)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done with the K tile
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tx * 4 + j) * PPAD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < COLS; ++c) o[i][c] *= corr[i];
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float4 pp = *reinterpret_cast<const float4*>(ps + kk * PPAD + ty * 4);
      float pv[4] = {pp.x, pp.y, pp.z, pp.w};
      float vv[COLS];
      lds<COLS>(vs + kk * HD + tx * COLS, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < COLS; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + ((long long)b * S + qp) * q_stride + (long long)h * HD +
              tx * COLS;
#pragma unroll
    for (int c = 0; c < COLS; ++c) store_out(orow + c, o[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int Hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)(B * Hq));
  flash_attention_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, Hkv, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int S, int Hq, int Hkv, int causal, int window,
              float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, Hq, Hkv, causal, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, Hq, Hkv, causal, window,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// -- bf16 on the tensor cores ----------------------------------------------
namespace tc {

constexpr int BQ = 128;            // query rows per CTA, 64 a warpgroup
constexpr int BK = 64;             // keys per K / V tile
constexpr int NST = 4;             // K / V stages in the ring
constexpr int CONSUMER_WARPS = 8;  // two warpgroups
constexpr int THREADS = 128 * 3;   // + the producer warpgroup
// registers a thread: 168 at launch (65,536 over 384 threads), then the
// producer's handed to the consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ROW = 128;           // bytes of a 64-column atom row (swizzle)
constexpr float MASKED = -1e30f;

// shared memory, from a 1024-byte aligned base: Q as hd / 64 atoms of
// BQ rows, then NST stages of K and V as hd / 64 atoms of BK rows each,
// then the mbarriers full[NST], empty[NST] and q
template <int HD>
struct Smem {
  static constexpr int ATOMS = HD / 64;
  static constexpr int Q_ATOM = BQ * ROW;
  static constexpr int KV_ATOM = BK * ROW;
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;  // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int BARS = Q_BYTES + NST * STAGE;
  static constexpr int BYTES = BARS + 8 * (2 * NST + 1) + 1024;  // + align
};

// the box at (d, h, s, b) of a 4-D tensor map into shared memory by TMA,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s),
      "r"(b)
      : "memory");
}

// shared-memory matrix descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout B128.
// K-major (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (the
// stride offset; the leading one is unused). MN-major (V): a k index is a
// row, 8-k groups 1024 bytes apart (stride offset), the next 64 columns
// one atom further (leading offset).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead,
                                         uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of these registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 64, float32) = A (64 x 16) B^T (16 x 64) (+ D where
// scale_d): both bf16 in shared memory, K-major, 128-byte swizzle
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16, bf16 in registers, the
// float32 accumulator's layout) B (16 x 64, bf16 in shared memory,
// MN-major: the transposed descriptor, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers, the
// float32 accumulator's layout) B (16 x 128, bf16 in shared memory,
// MN-major: the transposed descriptor, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// s = q k^T for one warpgroup's 64 rows and a BK-key tile, started and
// committed, not waited for: Q at `qa`, K at `kbuf`, both as hd / 64
// K-major atoms (16 columns are 32 bytes into an atom's rows)
template <int HD>
__device__ __forceinline__ void start_qk(float (&acc)[BK / 2], uint32_t qa,
                                         uint32_t kbuf) {
  using L = Smem<HD>;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(acc, desc(qa + (kk / 4) * L::Q_ATOM + off, 16, 1024),
                 desc(kbuf + (kk / 4) * L::KV_ATOM + off, 16, 1024),
                 kk > 0);
  }
  wgmma_commit();
}

// o += p_hi v + p_lo v for a BK-key tile, started and committed: V at
// `vbuf`, a key per 128-byte row, 16 keys 2048 bytes on
template <int HD>
__device__ __forceinline__ void start_pv(float (&o)[HD / 2],
                                         uint32_t (&hi)[BK / 16][4],
                                         uint32_t (&lo)[BK / 16][4],
                                         uint32_t vbuf) {
  fence_regs(o);
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = desc(vbuf + kk * 16 * ROW, Smem<HD>::KV_ATOM, 1024);
    mma_rs<HD>(o, hi[kk], dv);
    mma_rs<HD>(o, lo[kk], dv);
  }
  wgmma_commit();
}

// The online softmax of one tile on the s accumulator, in place: s is
// scaled and masked (where `edge`), the rows' max m and sum l advance,
// `corr` is what the output must be scaled by, and acc holds p. A
// thread's element e of 8-column block j sits at row `row` + 8 (e / 2),
// key k0 + 8 j + c2 + e % 2; a row's other elements are in the 3 other
// threads of its quad.
__device__ __forceinline__ void softmax_tile(float (&acc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool edge,
                                             int k0, int row, int c2, int S,
                                             int causal, int window,
                                             float scale) {
  float mx[2] = {MASKED, MASKED};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = acc[4 * j + e] * scale;
      if (edge) {
        const int kp = k0 + 8 * j + c2 + (e & 1);
        const int qp = row + 8 * (e >> 1);
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp && (window <= 0 || kp > qp - window);
        x = ok ? x : MASKED;
      }
      acc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(acc[4 * j + e] - m[e >> 1]);
      acc[4 * j + e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
  }
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
}

// p as the A fragments of p v, p_hi = bf16(p) and p_lo = bf16(p - p_hi):
// register t of k-step kk holds accumulator elements 8 kk + 2 t and
// 8 kk + 2 t + 1, the layout of the next product's A
__device__ __forceinline__ void split(const float (&acc)[BK / 2],
                                      uint32_t (&hi)[BK / 16][4],
                                      uint32_t (&lo)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float p0 = acc[8 * kk + 2 * t], p1 = acc[8 * kk + 2 * t + 1];
      const __nv_bfloat162 ph = __floats2bfloat162_rn(p0, p1);
      const float2 phf = __bfloat1622float2(ph);
      hi[kk][t] = bits(ph);
      lo[kk][t] = bits(__floats2bfloat162_rn(p0 - phf.x, p1 - phf.y));
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      __nv_bfloat16* __restrict__ out, int S, int Hq, int Hkv,
                      int causal, int window, float scale) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, skv = base + L::Q_BYTES, bars = base + L::BARS;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (NST + s), then q's
  const uint32_t qbar = bars + 16 * NST;

  const int qt = gridDim.y - 1 - blockIdx.y;  // most causal work first
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_end = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  const int kt_begin =
      (causal && window > 0) ? max(q0 - window + 1, 0) / BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (NST + s), CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {  // the producer warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, L::Q_BYTES);
      for (int a = 0; a < L::ATOMS; ++a)
        tma_load(sq + a * L::Q_ATOM, &qmap, qbar, 64 * a, h, q0, b);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % NST;
        const uint32_t full = bars + 8 * s, kbuf = skv + s * L::STAGE;
        mbar_wait(bars + 8 * (NST + s), ((i / NST) & 1) ^ 1);
        mbar_expect_tx(full, L::STAGE);
        for (int a = 0; a < L::ATOMS; ++a) {
          tma_load(kbuf + a * L::KV_ATOM, &kmap, full, 64 * a, hk, kt * BK,
                   b);
          tma_load(kbuf + L::KV_BYTES + a * L::KV_ATOM, &vmap, full, 64 * a,
                   hk, kt * BK, b);
        }
      }
    }
  } else {  // two consumer warpgroups of 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp / 4 - 1;
    const int r0 = q0 + 64 * wg;  // the warpgroup's first row
    // this thread's rows are row and row + 8; its columns in each
    // 8-column block c2 and c2 + 1
    const int row = r0 + 16 * (warp % 4) + lane / 4;
    const int c2 = 2 * (lane % 4);
    const uint32_t qa = sq + wg * 64 * ROW;
    // the tiles this warpgroup computes, [kb, ke): none above its
    // diagonal, none wholly before its window; it waits for and hands
    // back the CTA's others all the same
    int kb = kt_begin, ke = kt_end;
    if (r0 >= S) {
      ke = kb;
    } else if (causal) {
      ke = min(kt_end, min(r0 + 63, S - 1) / BK + 1);
      if (window > 0) kb = max(kb, max(r0 - window + 1, 0) / BK);
    }
    float o[HD / 2], m[2] = {MASKED, MASKED}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    float acc[BK / 2], corr[2];
    uint32_t hi[BK / 16][4], lo[BK / 16][4];

    auto stage = [&](int i) { return skv + (i % NST) * L::STAGE; };
    auto wait_full = [&](int i) { mbar_wait(bars + 8 * (i % NST),
                                            (i / NST) & 1); };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (NST + i % NST));
    };
    // some key of tile kt masked for some row of the warpgroup
    auto edge = [&](int kt) {
      const int k0 = kt * BK;
      return k0 + BK > S ||
             (causal && (k0 + BK - 1 > r0 ||
                         (window > 0 && k0 <= r0 + 63 - window)));
    };

    mbar_wait(qbar, 0);
    int i = 0;
    for (int kt = kt_begin; kt < kb; ++kt, ++i) {
      wait_full(i);
      release(i);
    }
    if (kb < ke) {
      // tile kb: s, then p; its p v waits for the next tile's s
      wait_full(i);
      start_qk<HD>(acc, qa, stage(i));
      wgmma_wait<0>();
      fence_regs(acc);
      softmax_tile(acc, m, l, corr, edge(kb), kb * BK, row, c2, S, causal,
                   window, scale);
      split(acc, hi, lo);
      int prev = i++;
      for (int kt = kb + 1; kt < ke; ++kt, ++i) {
        wait_full(i);
        start_qk<HD>(acc, qa, stage(i));                    // s of this tile
        start_pv<HD>(o, hi, lo, stage(prev) + L::KV_BYTES);  // p v of the last
        wgmma_wait<1>();                                    // s is in
        fence_regs(acc);
        softmax_tile(acc, m, l, corr, edge(kt), kt * BK, row, c2, S, causal,
                     window, scale);
        wgmma_wait<0>();                                    // p v is in
        fence_regs(o);
        release(prev);
        rescale<HD>(o, corr);
        split(acc, hi, lo);
        prev = i;
      }
      start_pv<HD>(o, hi, lo, stage(prev) + L::KV_BYTES);
      wgmma_wait<0>();
      fence_regs(o);
      release(prev);
    }
    for (int kt = ke; kt < kt_end; ++kt, ++i) {
      wait_full(i);
      release(i);
    }

    if (kb < ke) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = row + 8 * r;
        if (qp >= S) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow =
            out + ((long long)b * S + qp) * Hq * HD + (long long)h * HD + c2;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] / denom,
                                    o[4 * j + 2 * r + 1] / denom);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, S, H, hd) bf16 tensor as the 4-D map (hd, H, S, B), boxes of 64
// columns x 1 head x `rows` positions, 128-byte swizzle, zero fill
bool tensor_map(CUtensorMap* map, const void* ptr, int hd, int H, int S,
                int B, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)S * H * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int Hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, q, HD, Hq, S, B, BQ) ||
      !tensor_map(&km, k, HD, Hkv, S, B, BK) ||
      !tensor_map(&vm, v, HD, Hkv, S, B, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Smem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((unsigned)(B * Hq), (unsigned)((S + BQ - 1) / BQ));
  flash_attention_wgmma<HD><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), S, Hq, Hkv, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int S, int Hq, int Hkv, int causal, int window,
              float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, out, B, S, Hq, Hkv, causal, window, scale,
                        stream);
    case 128:
      return launch<128>(q, k, v, out, B, S, Hq, Hkv, causal, window, scale,
                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// q, out (B, S, Hq, hd); k, v (B, S, Hkv, hd); all contiguous, 16-byte
// aligned, of one dtype (bf16 = 1: bfloat16 on the tensor cores, else
// float32 on FFMA); hd 64 or 128; Hq a multiple of Hkv; window 0 for none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int Hq, int Hkv, int hd, int bf16,
                                      int causal, int window, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tc::launch_hd(hd, q, k, v, out, B, S, Hq, Hkv, causal, window,
                         scale, st);
  return launch_hd<float>(hd, q, k, v, out, B, S, Hq, Hkv, causal, window,
                          scale, st);
}
