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
//   out = acc / max(l, 1e-30)
// with m starting at -1e30, exp (not exp2 with a folded log2 e), and a key
// masked unless kp <= qp (and kp > qp - window with a window).
//
// What bounds it on the card: operations. At the serve prefill shape
// (B = 8, S = 2,048, Hq = 12, hd = 128, causal) it does ~1.0e11 flops on
// ~117 MB of q, k, v and out in bf16, ~860 flops a byte, far above the
// card's balance point in any precision.
//
// What the design does about it (a simple kernel, right first): one CTA of
// 256 threads per (b * Hq + h, 64-row query tile), the query tiles with
// the most causal work launched first. The q tile is staged once in shared
// memory, transposed to float32; each 64-key K and V tile is staged the
// same way (K transposed, V as rows), zero past S. Each thread owns a
// 4 x 4 block of the 64 x 64 logits (4 query rows, 4 keys), built by FFMA
// from 16-byte shared-memory loads, and a 4 x hd/16 block of the output
// accumulator for the same 4 rows, so the rows' m, l and corr stay in its
// registers; the row max and sum are reduced across the 16 threads of a
// row group by warp shuffles. p goes back through shared memory (over the
// spent K tile) for the p v product. Float32 throughout, no tensor cores:
// wgmma with bf16 operands is later work.
//
// Skipped tiles: KV tiles wholly above the diagonal of the query tile, and
// with a window those wholly before every row's window, are never visited.
// The TPU kernel visits them, but yields the same: a masked score is -1e30,
// so once a row has seen a real key (m > -1e30) a masked key's p is
// exp(-1e30 - m) = 0, and a tile that a row saw before any real key (where
// m = -1e30 and each masked p = 1) is wiped by corr = exp(-1e30 - m') = 0
// at its first real key. Every row sees itself, so every row meets a real
// key. Keys past S (a ragged last tile) are masked the same way; rows past
// S are computed but not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

}  // namespace

// q, out (B, S, Hq, hd); k, v (B, S, Hkv, hd); all contiguous, 16-byte
// aligned, of one dtype (bf16 = 1: bfloat16, else float32); hd 64 or
// 128; Hq a multiple of Hkv; window 0 for none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int Hq, int Hkv, int hd, int bf16,
                                      int causal, int window, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, Hq, Hkv, causal,
                                    window, scale, st);
  return launch_hd<float>(hd, q, k, v, out, B, S, Hq, Hkv, causal, window,
                          scale, st);
}
