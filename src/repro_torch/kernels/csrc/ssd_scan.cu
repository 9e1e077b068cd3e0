// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces ssd_scan (_ssd_kernel) of src/repro/kernels/ssd_scan.py: the
// state-space-duality form of the recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t
// for every (batch, head), chunk by chunk.  Inside a chunk of Q tokens,
// with cum the running sum of dt A over the chunk and seg its last value,
//   y = (C B^T o L o dt) x + exp(cum) (C h^T) + D x,  L_ij = exp(cum_i - cum_j)
//   for i >= j, else 0;
//   h <- exp(seg) h + S_c,  S_c = sum_q exp(seg - cum_q) dt_q x_q B_q^T;
// y is written in x's dtype and the final state as float32.
//
// Layout.  The kernels read the model layout directly: x and y are
// (B, S, H, P), dt (B, S, H) float32, A and D (H,) float32, Bm and Cm
// (B, S, N) -- one group shared by every head -- and write h_final
// (B, H, P, N).  x, Bm, Cm and y are float32 or bfloat16 (one dtype).
// Tokens past S in the last chunk are read as zeros, dt included: dt = 0
// means no decay and no input, so h_final is exact without a padded copy.
//
// Bound on the card: at mamba2-130m's prefill (B = 4, S = 2048, H = 24,
// P = 64, N = 128, bf16) a call must move 58 MB (0.017 ms at 3.35 TB/s);
// the recurrence needs 5 P N flops per token and head (3 for the state
// update, 2 for the readout), 8.1 GFLOP (0.0081 ms at the bf16 tensor-
// core peak): it is bound by bytes.
//
// bfloat16 (the LM serving dtype), P <= 128 and N <= 256: three launches
// over the (chunk, head, batch) grid, 16 x 24 x 4 = 1536 blocks at
// mamba2's prefill, products on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulate, on ldmatrix fragments; mma_sm90.cuh).
//   1. chunk_state_kernel: per (b, h, c) the block loads dt and forms
//      cum by shuffle scans of 32 tokens, the groups' totals added in
//      token order, while x and B are copied to shared memory; it scales
//      x there by exp(seg - cum) dt and forms S_c = (x o exp(seg - cum)
//      dt)^T B, a (P x Q)(Q x N) product, into a float32 scratch (B, H,
//      nc, P, N), and seg into (B, H, nc).
//   2. state_pass_kernel: per (b, h, slice of P N) the chunks in order,
//      h_0 = 0, h_c = exp(seg_{c-1}) h_{c-1} + S_{c-1} in f32 registers;
//      writes h_c, the state entering chunk c, as bf16 (B, H, nc, P, N),
//      and h_final = exp(seg_{nc-1}) h_{nc-1} + S_{nc-1} as f32.
//   3. chunk_out_kernel: per (b, h, c), FlashAttention's shape: each
//      warp owns 16 rows i of the chunk (8 warps; with more than 8 row
//      tiles they are dealt back and forth, so the warps' key blocks add
//      up alike); C's fragments stay in registers; o = exp(cum_i) (C_i
//      h_c^T), then per key block of 16 up to the diagonal scores = C B^T
//      (the next block's issued before this one's mask), M = scores o L o
//      dt in registers -- exp(cum_i - cum_j) only where j <= i, since
//      above the diagonal it overflows, as ex2.approx on the SFU (the
//      accurate expf's instructions made the loop issue-bound) -- rounded
//      to bf16 as the A operand of o += M x, x's B fragments from
//      ldmatrix.trans; y = o + D x.
// C B^T is recomputed by every head (24 heads, one group), about 6 GFLOP
// a call on the tensor cores; a copy stored once per (b, c) and read
// back was not tried.
// Deviation from the Pallas kernel, which keeps them in f32: the operands
// of the three products are rounded to bf16 -- x exp(seg - cum) dt, h_c
// and M.  The error stays within the bf16 tolerance (5e-2) of
// tests/test_kernels.py; tests/test_torch_ssd_passes.py models the
// rounding on the CPU.  P, N and Q need not be multiples of 16: tiles
// are zero-padded in shared memory to PMAX (64 or 128) and NMAX (64, 128
// or 256) columns and to Q rounded up to 16 rows, and padded rows carry
// dt = 0, so they add nothing to cum, seg or h.  16-byte cp.async copies
// need rows and bases 16-byte aligned (P or N a multiple of 8); otherwise
// the same kernels copy element by element.  Bytes moved at mamba2's
// prefill: x twice, the f32 states written and read once, h_c written
// and read once, y: about 230 MB, four times the bound's 58 MB.
//
// float32, and bfloat16 where the tensor-core passes do not take P, N
// and Q (P > 128, N > 256, or their blocks past shared memory where this
// kernel's fit; e.g. P = 256, N = 64, Q = 64): ssd_kernel, on the CUDA
// cores (the first port), one launch; ssd_scan_fwd picks by shape.  One
// block of 512 threads owns one (head, batch) and walks the chunks in
// order, with the (P, N) state in shared memory.
// A chunk's B and C (Q x N), x (Q x P), dt and cum are staged in shared
// memory as float32; the masked (Q x Q) product M = C B^T o L o dt is
// formed 16 rows at a time into a 16 x Q buffer and multiplied into x at
// once, so the whole chunk never needs a Q x Q buffer: at mamba2-130m's
// Q = 128, N = 128, P = 64 the block holds 203 KB (dynamic shared memory;
// rows of B, C and h are padded to N + 1 floats against bank conflicts).
// The running sum over the chunk is one thread's loop, in token order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

// ------------------------------------------------ CUDA cores

constexpr int kThreads = 512;
constexpr int kRowTile = 16;   // rows of M formed at once
constexpr size_t kSmemMax = 232448;  // a block's dynamic shared memory

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

size_t smem_floats(int P, int N, int Q) {
  const size_t ldn = (size_t)N + 1;
  return (size_t)P * ldn + 2 * (size_t)Q * ldn + (size_t)Q * P +
         (size_t)kRowTile * Q + 3 * (size_t)Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ Dv,
           T* __restrict__ y, float* __restrict__ h_out, int S, int H, int P,
           int N, int Q) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* hs = smem;               // P x ldn: the carried state
  float* Bs = hs + P * ldn;       // Q x ldn
  float* Cs = Bs + Q * ldn;       // Q x ldn
  float* xs = Cs + Q * ldn;       // Q x P
  float* Ms = xs + Q * P;         // kRowTile x Q
  float* cum = Ms + kRowTile * Q; // Q
  float* dts = cum + Q;           // Q
  float* wts = dts + Q;           // Q: exp(seg - cum_q) dt_q

  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const float a = A[h], dskip = Dv[h];
  for (int e = tid; e < P * N; e += kThreads) hs[(e / N) * ldn + e % N] = 0.f;

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();  // the last chunk is done with every buffer
    for (int e = tid; e < Q; e += kThreads) {
      const int s = s0 + e;
      dts[e] = s < S ? dt[((size_t)b * S + s) * H + h] : 0.f;
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int qq = e / P, p = e - qq * P, s = s0 + qq;
      xs[e] = s < S ? to_f32(x[(((size_t)b * S + s) * H + h) * P + p]) : 0.f;
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int qq = e / N, n = e - qq * N, s = s0 + qq;
      const size_t off = ((size_t)b * S + s) * N + n;
      Bs[qq * ldn + n] = s < S ? to_f32(Bm[off]) : 0.f;
      Cs[qq * ldn + n] = s < S ? to_f32(Cm[off]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int qq = 0; qq < Q; ++qq) {
        run += dts[qq] * a;
        cum[qq] = run;
      }
    }
    __syncthreads();
    const float seg = cum[Q - 1];
    for (int e = tid; e < Q; e += kThreads)
      wts[e] = expf(seg - cum[e]) * dts[e];

    // y, kRowTile rows at a time
    for (int i0 = 0; i0 < Q; i0 += kRowTile) {
      for (int e = tid; e < kRowTile * Q; e += kThreads) {
        const int ii = e / Q, j = e - ii * Q, i = i0 + ii;
        float mval = 0.f;
        if (i < Q && j <= i) {
          float sc = 0.f;
          for (int n = 0; n < N; ++n)
            sc = fmaf(Cs[i * ldn + n], Bs[j * ldn + n], sc);
          mval = sc * expf(cum[i] - cum[j]) * dts[j];
        }
        Ms[e] = mval;
      }
      __syncthreads();
      for (int e = tid; e < kRowTile * P; e += kThreads) {
        const int ii = e / P, p = e - ii * P, i = i0 + ii, s = s0 + i;
        if (i >= Q) continue;
        float acc = 0.f;
        for (int j = 0; j <= i; ++j)
          acc = fmaf(Ms[ii * Q + j], xs[j * P + p], acc);
        float inter = 0.f;
        for (int n = 0; n < N; ++n)
          inter = fmaf(Cs[i * ldn + n], hs[p * ldn + n], inter);
        acc += expf(cum[i]) * inter + dskip * xs[i * P + p];
        if (s < S) y[(((size_t)b * S + s) * H + h) * P + p] = from_f32<T>(acc);
      }
      __syncthreads();  // Ms is rewritten by the next row tile
    }

    // h <- exp(seg) h + sum_q wts_q x_q B_q^T
    const float eseg = expf(seg);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      float acc = 0.f;
      for (int qq = 0; qq < Q; ++qq)
        acc = fmaf(wts[qq] * xs[qq * P + p], Bs[qq * ldn + n], acc);
      hs[p * ldn + n] = eseg * hs[p * ldn + n] + acc;
    }
  }
  __syncthreads();
  float* hb = h_out + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) hb[e] = hs[(e / N) * ldn + e % N];
}

template <typename T>
cudaError_t run_cuda_cores(const void* x, const void* dt, const void* A,
                           const void* Bm, const void* Cm, const void* Dv,
                           void* y, void* h_out, int B, int S, int H, int P,
                           int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(P, N, Q) * sizeof(float);
  const auto kernel = ssd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dv),
      static_cast<T*>(y), static_cast<float*>(h_out), S, H, P, N, Q);
  return cudaGetLastError();
}

// ------------------------------------------------ bfloat16, tensor cores

namespace tc {

using namespace sm90;  // the PTX wrappers of mma_sm90.cuh
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;           // bf16 of padding a shared-memory row
constexpr int kPassThreads = 256; // state_pass_kernel's block
constexpr int kVecX = 1, kVecBC = 2, kVecH = 4, kVecY = 8;  // flags
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// rows x COLS bf16 into shared memory (row stride COLS + kPad) from rows
// of D elements src_stride apart; rows >= valid and columns >= D are 0.
// With vec (D a multiple of 8, every row 16-byte aligned), 16-byte
// cp.async (zero-filled where outside); otherwise element by element.
template <int COLS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t src_stride, int valid,
                                          int D, int rows, bool vec) {
  constexpr int ld = COLS + kPad, cpr = COLS / 8;
  if (vec) {
    for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
      const int r = e / cpr, c = e - r * cpr;
      const bool ok = r < valid && c * 8 < D;
      cp_async16(dst + r * ld + c * 8,
                 ok ? src + (size_t)r * src_stride + c * 8 : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * COLS; e += blockDim.x) {
      const int r = e / COLS, c = e - r * COLS;
      dst[r * ld + c] = (r < valid && c < D)
                            ? src[(size_t)r * src_stride + c]
                            : __float2bfloat16(0.f);
    }
  }
}

// dt of the chunk's Qp rows (0 past Q or S) into dts, every thread at
// once (one round trip to device memory).
__device__ __forceinline__ void chunk_dt(const float* __restrict__ dt,
                                         float* dts, int b, int h, int s0,
                                         int S, int H, int Q, int Qp) {
  for (int q = threadIdx.x; q < Qp; q += blockDim.x) {
    const int s = s0 + q;
    dts[q] = (q < Q && s < S) ? dt[((size_t)b * S + s) * H + h] : 0.f;
  }
}

// cum, the running sum of dt A over the chunk, after chunk_dt and a
// barrier: each warp scans groups of 32 tokens at once (an inclusive
// shuffle scan, the group's total into tot), then after a barrier every
// token adds the totals of the groups before its own, in group order.
// Rows past Q carry dt = 0, so cum stays at seg there.  The caller
// synchronizes before reading cum.
__device__ __forceinline__ void chunk_cum(const float* dts, float a,
                                          float* cum, float* tot, int Qp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q0 = warp * 32; q0 < Qp; q0 += blockDim.x) {
    const int q = q0 + lane;
    float v = q < Qp ? dts[q] * a : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (q < Qp) cum[q] = v;
    if (lane == 31) tot[q0 / 32] = v;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Qp; q += blockDim.x) {
    float carry = 0.f;
    for (int g = 0; g < q / 32; ++g) carry += tot[g];
    cum[q] += carry;
  }
}

// Pass 1: S_c = (x o exp(seg - cum) dt)^T B for one (c, h, b), into
// states (B, H, nc, P, N) f32, and seg into segs (B, H, nc).
template <int PMAX, int NMAX>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const bf16* __restrict__ Bm,
                   float* __restrict__ states, float* __restrict__ segs,
                   int S, int H, int P, int N, int Q, int nc, int flags) {
  constexpr int ldp = PMAX + kPad, ldn = NMAX + kPad;
  const int Qp = round16(Q);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);     // Qp x ldp, scaled
  bf16* Bs = Xs + Qp * ldp;                          // Qp x ldn
  float* dts = reinterpret_cast<float*>(Bs + Qp * ldn);
  float* cum = dts + Qp;
  float* wts = cum + Qp;                             // exp(seg - cum) dt
  float* tot = wts + Qp;                             // Qp / 32 group totals

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = c * Q, valid = min(Q, S - s0);
  const size_t xrow = (size_t)H * P;
  const size_t bhc = ((size_t)b * H + h) * nc + c;
  load_rows<NMAX>(Bs, Bm + ((size_t)b * S + s0) * N, N, valid, N, Qp,
                  flags & kVecBC);
  load_rows<PMAX>(Xs, x + ((size_t)b * S + s0) * xrow + (size_t)h * P, xrow,
                  valid, P, Qp, flags & kVecX);
  cp_async_commit();
  chunk_dt(dt, dts, b, h, s0, S, H, Q, Qp);
  __syncthreads();
  chunk_cum(dts, A[h], cum, tot, Qp);
  __syncthreads();
  const float seg = cum[Qp - 1];
  for (int q = threadIdx.x; q < Qp; q += kThreads)
    wts[q] = expf(seg - cum[q]) * dts[q];
  if (threadIdx.x == 0) segs[bhc] = seg;
  cp_async_wait<0>();
  __syncthreads();

  // x scaled in place by exp(seg - cum) dt, rounded to bf16, 8 at a time
  for (int e = threadIdx.x; e < Qp * (PMAX / 8); e += kThreads) {
    const int r = e / (PMAX / 8), cc = e - r * (PMAX / 8);
    uint4* p = reinterpret_cast<uint4*>(Xs + r * ldp + cc * 8);
    const uint4 in = *p;
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&in);
    const float w = wts[r];
    float2 f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = __bfloat1622float2(v[k]);
    *p = make_uint4(pack_bf16(f[0].x * w, f[0].y * w),
                    pack_bf16(f[1].x * w, f[1].y * w),
                    pack_bf16(f[2].x * w, f[2].y * w),
                    pack_bf16(f[3].x * w, f[3].y * w));
  }
  __syncthreads();

  // (m-tile of 16 rows of P, block of 64 columns of N) items over warps;
  // A = Xs^T and B = Bs both from ldmatrix.trans (tokens are the k axis)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  float* out = states + bhc * (size_t)P * N;
  constexpr int kItems = (PMAX / 16) * (NMAX / 64);
  for (int item = warp; item < kItems; item += kWarps) {
    const int mt = item % (PMAX / 16), nb = item / (PMAX / 16);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < Qp; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, Xs + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ldp
                               + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, Bs + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ldn
                                  + nb * 64 + np * 16 + (lane >> 4) * 8);
        mma(acc[2 * np], a, bb[0], bb[1]);
        mma(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = mt * 16 + g + 8 * half;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = nb * 64 + 8 * j + 2 * tig;
        if (n >= N) continue;
        float* o = out + (size_t)p * N + n;
        if ((N & 1) == 0) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
        } else {
          o[0] = acc[j][2 * half];
          if (n + 1 < N) o[1] = acc[j][2 * half + 1];
        }
      }
    }
  }
}

// Pass 2: the states entering each chunk, in chunk order, for one
// (b, h) and V elements a thread of its P N.
template <int V>
__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(const float* __restrict__ states,
                  const float* __restrict__ segs, bf16* __restrict__ hc,
                  float* __restrict__ h_out, int H, int PN, int nc) {
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * V;
  if (e >= PN) return;
  const float* sc = states + bh * nc * PN + e;
  bf16* hp = hc + bh * nc * PN + e;
  const float* sg = segs + bh * nc;
  float hv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) hv[v] = 0.f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    float s[V];
    if constexpr (V == 4) {
      const float4 t = *reinterpret_cast<const float4*>(sc + (size_t)c * PN);
      s[0] = t.x; s[1] = t.y; s[2] = t.z; s[3] = t.w;
      *reinterpret_cast<uint2*>(hp + (size_t)c * PN) =
          make_uint2(pack_bf16(hv[0], hv[1]), pack_bf16(hv[2], hv[3]));
    } else {
      s[0] = sc[(size_t)c * PN];
      hp[(size_t)c * PN] = __float2bfloat16(hv[0]);
    }
    const float eseg = expf(sg[c]);
#pragma unroll
    for (int v = 0; v < V; ++v) hv[v] = eseg * hv[v] + s[v];
  }
  float* ho = h_out + bh * PN + e;
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(ho) = make_float4(hv[0], hv[1], hv[2], hv[3]);
  } else {
    ho[0] = hv[0];
  }
}

// Pass 3: y for one (c, h, b) from the chunk's C, B, x and h_c.
template <int PMAX, int NMAX>
__global__ void __launch_bounds__(kThreads)
chunk_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, const float* __restrict__ Dv,
                 const bf16* __restrict__ hc, bf16* __restrict__ y, int S,
                 int H, int P, int N, int Q, int nc, int flags) {
  constexpr int ldp = PMAX + kPad, ldn = NMAX + kPad;
  constexpr int kNK = NMAX / 16;          // k-steps over N
  constexpr bool kCRegs = NMAX <= 128;    // C's fragments in registers
  const int Qp = round16(Q);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);   // Qp x ldn
  bf16* Bs = Cs + Qp * ldn;                       // Qp x ldn
  bf16* Xs = Bs + Qp * ldn;                       // Qp x ldp
  bf16* Hs = Xs + Qp * ldp;                       // PMAX x ldn: h_c
  float* dts = reinterpret_cast<float*>(Hs + PMAX * ldn);
  float* cum = dts + Qp;
  float* tot = cum + Qp;                          // Qp / 32 group totals

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = c * Q, valid = min(Q, S - s0);
  const size_t xrow = (size_t)H * P;
  const size_t bc_off = ((size_t)b * S + s0) * N;
  load_rows<NMAX>(Cs, Cm + bc_off, N, valid, N, Qp, flags & kVecBC);
  load_rows<NMAX>(Bs, Bm + bc_off, N, valid, N, Qp, flags & kVecBC);
  load_rows<PMAX>(Xs, x + ((size_t)b * S + s0) * xrow + (size_t)h * P, xrow,
                  valid, P, Qp, flags & kVecX);
  load_rows<NMAX>(Hs, hc + (((size_t)b * H + h) * nc + c) * (size_t)P * N,
                  N, P, N, PMAX, flags & kVecH);
  cp_async_commit();
  chunk_dt(dt, dts, b, h, s0, S, H, Q, Qp);
  __syncthreads();
  chunk_cum(dts, A[h], cum, tot, Qp);
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float dskip = Dv[h];
  const int n_tiles = Qp / 16;
  for (int t = 0; t < n_tiles; ++t) {
    // tiles dealt 0, 1, .., kWarps - 1, kWarps - 1, .., 0, 0, 1, ..: past
    // kWarps tiles a warp's key blocks (t + 1 for tile t) add up alike
    const int m = t % (2 * kWarps);
    if ((m < kWarps ? m : 2 * kWarps - 1 - m) != warp) continue;
    const int i0 = t * 16;
    const bf16* Ct = Cs + i0 * ldn;
    uint32_t cf[kCRegs ? kNK : 1][4];
    if constexpr (kCRegs) {
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk)
        ldmatrix_x4(cf[kk], Ct + (lane & 15) * ldn + kk * 16 + (lane >> 4) * 8);
    }
    const auto c_frag = [&](uint32_t (&a)[4], int kk) {
      if constexpr (kCRegs) {
#pragma unroll
        for (int v = 0; v < 4; ++v) a[v] = cf[kk][v];
      } else {
        ldmatrix_x4(a, Ct + (lane & 15) * ldn + kk * 16 + (lane >> 4) * 8);
      }
    };

    // the carried state: o = exp(cum_i) (C_i h_c^T)
    float o[PMAX / 8][4];
#pragma unroll
    for (int j = 0; j < PMAX / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNK; ++kk) {
      uint32_t a[4];
      c_frag(a, kk);
#pragma unroll
      for (int np = 0; np < PMAX / 16; ++np) {
        uint32_t bh[4];  // p 16 np.., n 16 kk..: two n-tiles
        ldmatrix_x4(bh, Hs + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldn
                            + kk * 16 + ((lane >> 3) & 1) * 8);
        mma(o[2 * np], a, bh[0], bh[1]);
        mma(o[2 * np + 1], a, bh[2], bh[3]);
      }
    }
    const int r0 = i0 + g, r1 = r0 + 8;   // this thread's two rows
    const float cum0 = cum[r0], cum1 = cum[r1];
    const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
    for (int j = 0; j < PMAX / 8; ++j) {
      o[j][0] *= e0;
      o[j][1] *= e0;
      o[j][2] *= e1;
      o[j][3] *= e1;
    }

    // within the chunk: key blocks of 16 up to the diagonal.  The scores
    // of block jb + 1 are issued before block jb's mask and M x, with no
    // branch between them (the last block's are issued twice), so the
    // warp's exp and selects run while its products are in flight.
    const auto scores = [&](float (&sc)[2][4], int jb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) {
        uint32_t a[4], bb[4];  // keys 16 jb.., n 16 kk..: two n-tiles
        c_frag(a, kk);
        ldmatrix_x4(bb, Bs + (jb * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldn
                            + kk * 16 + ((lane >> 3) & 1) * 8);
        mma(sc[0], a, bb[0], bb[1]);
        mma(sc[1], a, bb[2], bb[3]);
      }
    };
    float s[2][4], s_next[2][4];
    scores(s, 0);
    for (int jb = 0; jb <= t; ++jb) {
      scores(s_next, min(jb + 1, t));
      // M = scores o L o dt; exp(cum_i - cum_j) only where j <= i, as
      // 2^x on the SFU (M is rounded to bf16 next)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int i = cc < 2 ? r0 : r1;
          const int j = jb * 16 + nt * 8 + 2 * tig + (cc & 1);
          const float ci = cc < 2 ? cum0 : cum1;
          s[nt][cc] = j <= i ? s[nt][cc] * dts[j] *
                                   fast_exp2((ci - cum[j]) * kLog2e)
                             : 0.f;
        }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dp = 0; dp < PMAX / 16; ++dp) {
        uint32_t bx[4];  // keys 16 jb.., p 16 dp..: two n-tiles
        ldmatrix_x4_trans(bx, Xs + (jb * 16 + (lane & 7) +
                                    (((lane >> 3) & 1) << 3)) * ldp
                                  + dp * 16 + (lane >> 4) * 8);
        mma(o[2 * dp], pa, bx[0], bx[1]);
        mma(o[2 * dp + 1], pa, bx[2], bx[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[nt][cc] = s_next[nt][cc];
    }

    // y = o + D x for the rows of this chunk inside S
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? r1 : r0, s = s0 + i;
      if (i >= Q || s >= S) continue;
      bf16* yr = y + ((size_t)b * S + s) * xrow + (size_t)h * P;
      const bf16* xr = Xs + i * ldp;
#pragma unroll
      for (int j = 0; j < PMAX / 8; ++j) {
        const int p = 8 * j + 2 * tig;
        if (p >= P) continue;
        const float v0 = o[j][2 * half] + dskip * __bfloat162float(xr[p]);
        const float v1 = o[j][2 * half + 1] + dskip * __bfloat162float(xr[p + 1]);
        if (flags & kVecY) {
          *reinterpret_cast<uint32_t*>(yr + p) = pack_bf16(v0, v1);
        } else {
          yr[p] = __float2bfloat16(v0);
          if (p + 1 < P) yr[p + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <int PMAX, int NMAX>
size_t state_smem(int Q) {
  const int Qp = round16(Q);
  return (size_t)Qp * (PMAX + NMAX + 2 * kPad) * sizeof(bf16) +
         (3 * (size_t)Qp + Qp / 16) * sizeof(float);
}

template <int PMAX, int NMAX>
size_t out_smem(int Q) {
  const int Qp = round16(Q);
  return ((size_t)Qp * (2 * NMAX + PMAX + 3 * kPad) +
          (size_t)PMAX * (NMAX + kPad)) * sizeof(bf16) +
         (2 * (size_t)Qp + Qp / 16) * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The operands of one bf16 call (see ssd_scan_fwd).
struct Call {
  const bf16 *x, *Bm, *Cm;
  const float *dt, *A, *Dv;
  bf16 *y, *hc;
  float *h_out, *states, *segs;
  int B, S, H, P, N, Q;
};

// launched[1..3]: chunk_state, state_pass and chunk_out launches.
template <int PMAX, int NMAX>
cudaError_t run(const Call& a, int* launched, cudaStream_t stream) {
  const int nc = (a.S + a.Q - 1) / a.Q;
  const int flags = (a.P % 8 == 0 && aligned16(a.x) ? kVecX : 0) |
                    (a.N % 8 == 0 && aligned16(a.Bm) && aligned16(a.Cm)
                         ? kVecBC : 0) |
                    (a.N % 8 == 0 ? kVecH : 0) | (a.P % 2 == 0 ? kVecY : 0);
  const dim3 grid(nc, a.H, a.B);
  cudaError_t err;

  const size_t smem1 = state_smem<PMAX, NMAX>(a.Q);
  if ((err = allow_smem(chunk_state_kernel<PMAX, NMAX>, smem1)) != cudaSuccess)
    return err;
  chunk_state_kernel<PMAX, NMAX><<<grid, kThreads, smem1, stream>>>(
      a.x, a.dt, a.A, a.Bm, a.states, a.segs, a.S, a.H, a.P, a.N, a.Q, nc,
      flags);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++launched[1];

  const int PN = a.P * a.N;
  if (PN % 4 == 0) {
    const dim3 grid2((PN / 4 + kPassThreads - 1) / kPassThreads, a.H, a.B);
    state_pass_kernel<4><<<grid2, kPassThreads, 0, stream>>>(
        a.states, a.segs, a.hc, a.h_out, a.H, PN, nc);
  } else {
    const dim3 grid2((PN + kPassThreads - 1) / kPassThreads, a.H, a.B);
    state_pass_kernel<1><<<grid2, kPassThreads, 0, stream>>>(
        a.states, a.segs, a.hc, a.h_out, a.H, PN, nc);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++launched[2];

  const size_t smem3 = out_smem<PMAX, NMAX>(a.Q);
  if ((err = allow_smem(chunk_out_kernel<PMAX, NMAX>, smem3)) != cudaSuccess)
    return err;
  chunk_out_kernel<PMAX, NMAX><<<grid, kThreads, smem3, stream>>>(
      a.x, a.dt, a.A, a.Bm, a.Cm, a.Dv, a.hc, a.y, a.S, a.H, a.P, a.N, a.Q,
      nc, flags);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++launched[3];
  return cudaSuccess;
}

// The shared memory of the instantiation (PMAX, NMAX) for P and N: the
// larger of passes 1 and 3, or -1 where P > 128 or N > 256.
long long smem_bytes(int P, int N, int Q) {
  const auto larger = [](size_t a, size_t b) {
    return (long long)(a > b ? a : b);
  };
  if (P > 128 || N > 256) return -1;
  if (P <= 64) {
    if (N <= 64) return larger(state_smem<64, 64>(Q), out_smem<64, 64>(Q));
    if (N <= 128) return larger(state_smem<64, 128>(Q), out_smem<64, 128>(Q));
    return larger(state_smem<64, 256>(Q), out_smem<64, 256>(Q));
  }
  if (N <= 64) return larger(state_smem<128, 64>(Q), out_smem<128, 64>(Q));
  if (N <= 128) return larger(state_smem<128, 128>(Q), out_smem<128, 128>(Q));
  return larger(state_smem<128, 256>(Q), out_smem<128, 256>(Q));
}

cudaError_t dispatch(const Call& a, int* launched, cudaStream_t s) {
  if (a.P > 128 || a.N > 256) return cudaErrorInvalidValue;
  if (a.P <= 64) {
    if (a.N <= 64) return run<64, 64>(a, launched, s);
    if (a.N <= 128) return run<64, 128>(a, launched, s);
    return run<64, 256>(a, launched, s);
  }
  if (a.N <= 64) return run<128, 64>(a, launched, s);
  if (a.N <= 128) return run<128, 128>(a, launched, s);
  return run<128, 256>(a, launched, s);
}

}  // namespace tc

// Whether a bfloat16 call runs the tensor-core passes: they take P and N
// and their blocks fit shared memory (else ssd_kernel<bf16> runs).
bool tensor_cores_take(int P, int N, int Q) {
  const long long b = tc::smem_bytes(P, N, Q);
  return b >= 0 && (size_t)b <= kSmemMax;
}

}  // namespace

extern "C" {

// x, y: (B, S, H, P); dt: (B, S, H) float32; A, D: (H,) float32; Bm, Cm:
// (B, S, N); h_out: (B, H, P, N) float32; all contiguous.  dtype of x,
// Bm, Cm and y: 0 = float32 (ssd_kernel, one launch), 1 = bfloat16: the
// three tensor-core passes where ssd_scan_tensor_cores(P, N, Q), which
// also take the scratch states (B, H, nc, P, N) float32, hc (B, H, nc, P,
// N) bfloat16 and segs (B, H, nc) float32, nc = ceil(S / Q); else
// ssd_kernel, one launch (the scratch pointers unused).  Adds each launch
// to launched[k]: k = 0 ssd_kernel, 1 chunk_state_kernel, 2
// state_pass_kernel, 3 chunk_out_kernel.  Returns cudaGetLastError()
// after the last launch, or the first launch's error (0 = success).
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* Dv, void* y, void* h_out,
                 void* states, void* hc, void* segs, int B, int S, int H,
                 int P, int N, int Q, int dtype, int device, void* stream,
                 int* launched) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 || !tensor_cores_take(P, N, Q)) {
    err = dtype == 0
              ? run_cuda_cores<float>(x, dt, A, Bm, Cm, Dv, y, h_out, B, S,
                                      H, P, N, Q, s)
              : run_cuda_cores<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, y, h_out,
                                              B, S, H, P, N, Q, s);
    if (err == cudaSuccess) ++launched[0];
    return (int)err;
  }
  if (states == nullptr || hc == nullptr || segs == nullptr)
    return (int)cudaErrorInvalidValue;
  using sm90::bf16;
  const tc::Call a{static_cast<const bf16*>(x), static_cast<const bf16*>(Bm),
                   static_cast<const bf16*>(Cm), static_cast<const float*>(dt),
                   static_cast<const float*>(A), static_cast<const float*>(Dv),
                   static_cast<bf16*>(y), static_cast<bf16*>(hc),
                   static_cast<float*>(h_out), static_cast<float*>(states),
                   static_cast<float*>(segs), B, S, H, P, N, Q};
  return (int)tc::dispatch(a, launched, s);
}

// 1 where a bfloat16 call at P, N, Q runs the tensor-core passes (and
// needs ssd_scan_fwd's scratch), else 0.
int ssd_scan_tensor_cores(int P, int N, int Q) {
  return tensor_cores_take(P, N, Q) ? 1 : 0;
}

// Dynamic shared memory the largest block of a call takes (bytes), or -1
// for another dtype.
long long ssd_scan_smem_bytes(int P, int N, int Q, int dtype) {
  if (dtype == 1 && tensor_cores_take(P, N, Q)) return tc::smem_bytes(P, N, Q);
  if (dtype == 0 || dtype == 1)
    return (long long)(smem_floats(P, N, Q) * sizeof(float));
  return -1;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
