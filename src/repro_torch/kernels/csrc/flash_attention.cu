// Causal flash-attention forward for Hopper (sm_90a) on the CUDA cores: q, k,
// v (B*H, S, hd) f32 -> out (B*H, S, hd) f32, hd a multiple of 8 up to 128
// (instantiated at HD = 64 for hd <= 64, else 128; a narrower head's missing
// columns load as zero, add nothing to the scores and are not stored).  It is
// on no route since the f32 route moved to the tensor cores
// (flash_attention_sm90.cu, operands split into three bf16 terms); it stays
// callable (flash_attention.KERNELS["flash_attention"]) to be timed beside
// that route.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (Pallas body _kernel) for f32 inputs, and computes what it computes: q
// multiplied by scale = hd**-0.5 before the product, keys past the query
// masked with -1e30 (not -inf), the softmax carried online over key tiles as
// (running max m, denominator l, accumulator), key tiles past the diagonal
// skipped, and the output acc / max(l, 1e-30).  Exponentials are expf (the
// build has no fast math).
//
// What bounds it on this card: every product runs in f32 on the CUDA cores,
// 4 * S*S/2 * hd operations per head against a few
// bytes per element of q, k, v and out, so it is bound by operations, at the
// 67 TFLOP/s f32 rate.
//
// What the design does about it: one block of 256 threads per (head, 64
// query rows), tiles visited longest first.  The scaled Q tile stays in
// shared memory for the whole block; each 64-key K and V tile is staged
// through shared memory once and read by all 256 threads.  A thread
// owns 4 query rows: 4 x 4 scores (keys c, c+16, c+32, c+48) for S = Q K^T,
// and 4 rows x 4*hd/64 output columns of the accumulator, in registers.  The
// row max and sum are reduced over the 16 threads of a row by warp shuffles.
// P is written transposed into the K tile's buffer (K is dead by then) and
// read as one 16-byte broadcast per key for P V.  Reads are 16-byte vectors
// laid out so that a warp touches the fewest shared-memory wavefronts (the K
// tile's rows are padded by 4 floats).  Not used: a pipelined K/V load, split-K for
// long rows.
//
// Contract checked by the Python wrapper: q, k, v, out contiguous, 16-byte
// aligned, f32, on the current device; hd a multiple of 8 up to 128.

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kThreads = 256;        // 16 row groups x 16 column lanes
constexpr int kPStride = kBQ + 4;    // P^T row stride (floats)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void axpy4(float p, float4 v, float4& acc) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

// reductions over the 16 lanes that share a query row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr int smem_bytes() {
  return (kBQ * HD + kBK * (HD + 4) + kBK * HD) * (int)sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int BH, int S,
                       int hd, float scale) {
  constexpr int KS = HD + 4;   // K tile row stride (floats)
  constexpr int D4 = HD / 4;   // float4 groups per row
  constexpr int JV = HD / 64;  // output float4 groups per thread and row
  static_assert(kBK * KS >= kBK * kPStride, "P^T must fit the K tile's buffer");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][HD], scaled
  float* Ks = Qs + kBQ * HD;                    // [kBK][KS]
  float* Vs = Ks + kBK * KS;                    // [kBK][HD]
  float* Pt = Ks;                               // [kBK][kPStride], after S is formed

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);  // longest rows first
  const size_t base = (size_t)(blockIdx.x % BH) * S * hd;  // rows hd apart
  const int tid = threadIdx.x;
  const int r = tid >> 4;  // query rows 4r .. 4r+3 of the tile
  const int c = tid & 15;  // keys c + 16j; output columns 4c + 64jj .. +3

  for (int g = tid; g < kBQ * D4; g += kThreads) {
    const int row = g / D4, d = (g % D4) * 4;
    const int pos = qt * kBQ + row;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < S && d < hd) {
      x = ldg4(q + base + (size_t)pos * hd + d);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + row * HD + d) = x;
  }

  float m[4], l[4];
  float4 acc[4][JV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < JV; ++jj) acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // the previous tile's P V is done with Pt and Vs
    for (int g = tid; g < kBK * D4; g += kThreads) {
      const int row = g / D4, d = (g % D4) * 4;
      const int pos = kt * kBK + row;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (pos < S && d < hd) {
        kx = ldg4(k + base + (size_t)pos * hd + d);
        vx = ldg4(v + base + (size_t)pos * hd + d);
      }
      *reinterpret_cast<float4*>(Ks + row * KS + d) = kx;
      *reinterpret_cast<float4*>(Vs + row * HD + d) = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = ld4(Qs + (4 * r + i) * HD + 4 * d4);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ld4(Ks + (c + 16 * j) * KS + 4 * d4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qa[i], kb[j], s[i][j]);
    }
    __syncthreads();  // every thread is done reading Ks before P overwrites it

    const bool diag = kt == qt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qt * kBQ + 4 * r + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (diag && kt * kBK + c + 16 * j > qpos) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float alpha = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = mx;
#pragma unroll
      for (int jj = 0; jj < JV; ++jj) {
        acc[i][jj].x *= alpha; acc[i][jj].y *= alpha;
        acc[i][jj].z *= alpha; acc[i][jj].w *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (c + 16 * j) * kPStride + 4 * r) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = ld4(Pt + kk * kPStride + 4 * r);
#pragma unroll
      for (int jj = 0; jj < JV; ++jj) {
        const float4 vv = ld4(Vs + kk * HD + 4 * c + 64 * jj);
        axpy4(p.x, vv, acc[0][jj]);
        axpy4(p.y, vv, acc[1][jj]);
        axpy4(p.z, vv, acc[2][jj]);
        axpy4(p.w, vv, acc[3][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = qt * kBQ + 4 * r + i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < JV; ++jj) {
      const float4 a = acc[i][jj];
      if (4 * c + 64 * jj < hd)
        *reinterpret_cast<float4*>(out + base + (size_t)qpos * hd + 4 * c + 64 * jj) =
            make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int S, int hd,
           float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<HD>;
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)BH * ((S + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), BH, S, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int BH, int S, int hd, float scale,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0 || hd < 8 || hd % 8 || hd > 128) return (int)cudaErrorInvalidValue;
  if (hd <= 64) return launch<64>(q, k, v, out, BH, S, hd, scale, s);
  return launch<128>(q, k, v, out, BH, S, hd, scale, s);
}
