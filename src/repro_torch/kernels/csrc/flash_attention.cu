// Flash attention for Hopper (sm_90a).
//
// Replaces flash_attention (_flash_kernel) of
// src/repro/kernels/flash_attention.py: online-softmax attention with
// causal and sliding-window masks aligned at the ends of the query and key
// sequences (query i sits at key position i + Skv - Sq), GQA head grouping
// (query head h reads KV head h / (H / Hkv)), float32 softmax and
// accumulation, the output in q's dtype.
//
// Layout.  The kernel reads the model layout directly: q and out are
// (B, Sq, H, D), k and v (B, Skv, Hkv, D), each contiguous, float32 or
// bfloat16 (all four of one dtype).  The TPU wrapper transposes to
// (B, H, S, D) and pads S to the block; here no copy is made: every row of
// a tile is D contiguous elements, and rows past Sq or Skv are masked in
// the kernel.  Keys at index >= Skv are masked explicitly, so causal=False
// on a ragged Skv is exact (the TPU wrapper's zero-padded keys enter its
// softmax there).  A query row that sees no key comes out 0.
//
// Design.  One block of 256 threads owns one (q-tile of 64 rows, head,
// batch).  It keeps its Q tile, scaled, in shared memory and streams the
// K and V tiles (64 keys) through shared memory; the running max m, sum l
// and the 64 x D accumulator stay in registers, float32.  The threads are
// a 16 x 16 grid: thread (ty, tx) owns query rows ty + 16 i (i < 4), key
// columns tx + 16 j (j < 4) of each score tile and head-dim columns
// tx + 16 jd of the accumulator, so a row's max and sum are reduced over
// the 16 lanes of one half-warp with shuffles, and the row rescale by
// alpha = exp(m_old - m_new) stays in the thread.  Probabilities of
// masked entries are set to 0 (a row whose first visible key tile comes
// late still has m = -1e30 there, where exp(s - m) = 1).  KV tiles wholly
// above the causal diagonal, or wholly before the window of every row of
// the q-tile, are skipped.  Products are float32 FMAs on the CUDA cores
// (float4 shared-memory reads along D), not the tensor cores: this is the
// simple and right first version.  Any D up to 256 works (qwen3's 128,
// zamba2's 112); shared memory is (64 + 2 * 64) * (D4 + 4) + 64 * 68
// floats, D4 = D rounded up to 4: 116 KB at D = 128, so it is dynamic.
//
// Bound on the card: at qwen3-1.7b's prefill (B = 4, S = 2048, H = 16,
// Hkv = 8, D = 128, causal) the kernel must move 0.10 GB in bf16
// (0.030 ms at 3.35 TB/s) and do 4 D flops for each of the
// B H S (S + 1) / 2 visible (query, key) pairs, 0.069 TFLOP (0.070 ms at
// the bf16 tensor-core peak of 989 TFLOP/s): it is bound by operations,
// and this version, on the CUDA cores, is far from that bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kR = kBQ / 16;   // query rows per thread
constexpr int kC = kBK / 16;   // key columns per thread
constexpr int kLdP = kBK + 4;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ int padded_d(int D) { return (D + 3) & ~3; }

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int Hkv, int D, int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kJD = DMAX / 16;  // accumulator columns per thread
  const int DP = padded_d(D), ld = DP + 4;
  float* Qs = smem;              // kBQ x ld, scaled
  float* Ks = Qs + kBQ * ld;     // kBK x ld
  float* Vs = Ks + kBK * ld;     // kBK x ld
  float* Ps = Vs + kBK * ld;     // kBQ x kLdP

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int offset = Skv - Sq;   // aligned ends
  const size_t q_row = (size_t)H * D, kv_row = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Skv * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * Skv * kv_row + (size_t)hk * D;
  T* ob = out + (size_t)b * Sq * q_row + (size_t)h * D;

  for (int e = tid; e < kBQ * DP; e += kThreads) {
    const int r = e / DP, d = e - r * DP;
    Qs[r * ld + d] = (q0 + r < Sq && d < D)
                         ? to_f32(qb[(size_t)(q0 + r) * q_row + d]) * scale
                         : 0.f;
  }

  // the key tiles any row of this q-tile can see
  const int qp_lo = q0 + offset;
  const int qp_hi = min(q0 + kBQ, Sq) - 1 + offset;
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, qp_hi < 0 ? 0 : qp_hi / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && qp_lo - window + 1 > 0)
    kt_begin = (qp_lo - window + 1) / kBK;

  float m[kR], l[kR], acc[kR][kJD];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < kJD; ++jd) acc[i][jd] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // Q is stored; the last tile's K, V, P are read
    for (int e = tid; e < kBK * DP; e += kThreads) {
      const int r = e / DP, d = e - r * DP;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < Skv && d < D) {
        const size_t off = (size_t)(k0 + r) * kv_row + d;
        kv = to_f32(kb[off]);
        vv = to_f32(vb[off]);
      }
      Ks[r * ld + d] = kv;
      Vs[r * ld + d] = vv;
    }
    __syncthreads();

    // scores s = (scale q) k^T for this thread's 4 x 4 entries
    float s[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 qv[kR], kv[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * ld + d]);
#pragma unroll
      for (int j = 0; j < kC; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * ld + d]);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax, P to shared memory, rescale the accumulator
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qp = q0 + ty + 16 * i + offset;
      bool ok[kC];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < Skv && (!causal || kp <= qp) &&
                (window <= 0 || qp - kp < window);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        rowsum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, o);
      l[i] = l[i] * alpha + rowsum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < kJD; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();

    // acc += P V
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kLdP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * ld;
#pragma unroll
        for (int jd = 0; jd < kJD; ++jd) {
          const int d = tx + 16 * jd;
          if (d < D) {
            const float vval = vrow[d];
#pragma unroll
            for (int i = 0; i < kR; ++i) {
              const float p = cc == 0 ? pv[i].x
                            : cc == 1 ? pv[i].y
                            : cc == 2 ? pv[i].z : pv[i].w;
              acc[i][jd] = fmaf(p, vval, acc[i][jd]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < kJD; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) ob[(size_t)r * q_row + d] = from_f32<T>(acc[i][jd] / denom);
    }
  }
}

size_t smem_bytes(int D) {
  const int ld = ((D + 3) & ~3) + 4;
  return ((size_t)(kBQ + 2 * kBK) * ld + (size_t)kBQ * kLdP) * sizeof(float);
}

template <typename T, int DMAX>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Skv, int H, int Hkv, int D, int causal,
                int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = flash_kernel<T, DMAX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, Hkv, D,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Skv, int H, int Hkv,
                       int D, int causal, int window, float scale,
                       cudaStream_t s) {
  if (D <= 64)
    return run<T, 64>(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal, window,
                      scale, s);
  if (D <= 128)
    return run<T, 128>(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal, window,
                       scale, s);
  if (D <= 256)
    return run<T, 256>(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal, window,
                       scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, out: (B, Sq, H, D); k, v: (B, Skv, Hkv, D); contiguous, one dtype:
// 0 = float32, 1 = bfloat16.  H a multiple of Hkv; D <= 256; window <= 0
// means none.  Returns cudaGetLastError() after the launch (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Skv, int H, int Hkv,
                        int D, int causal, int window, float scale, int dtype,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal,
                                  window, scale, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, Hkv, D,
                                          causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
