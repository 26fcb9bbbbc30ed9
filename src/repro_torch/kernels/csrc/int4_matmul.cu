// Packed-storage int4 matmul for Hopper (sm_90a): (M, K) int8 activations x
// (K/2, N) uint8 weights holding two signed nibbles per byte -> (M, N) int32.
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py::int4_matmul
// (Pallas body _kernel): unpack the nibbles by arithmetic shifts (row 2i in
// the low nibble), then an int8 dot with int32 accumulation.
//
// What bounds it on this card: at the decode shapes of the main path
// (M = serving slots, 4) it reads 0.5 byte per weight and does 2*M integer
// operations per weight, far below the int8 tensor-core rate, so it is bound
// by the weight bytes streamed from HBM (3.35 TB/s).  At prefill shapes
// (M = 64) the dp4a work on the CUDA cores grows with M and dominates.
//
// What the design does about it: weights are read exactly once per M tile,
// as one 32-bit word (four columns) per thread per packed row, so a warp
// reads 128 contiguous bytes; the nibbles are sign-extended four at a time
// with byte-SIMD (__vsub4), transposed into per-column k-quads with
// __byte_perm and fed to __dp4a, four multiply-adds per instruction, with
// each unpacked weight word reused for every row of the M tile.  A decode
// GEMV is latency-bound unless many loads are in flight: the K loop is
// unrolled four groups deep, and layers too narrow to put about eight
// blocks on every SM split K over blocks; the partial sums meet with
// integer atomicAdd, which is exact and order-independent (int32 addition
// is associative mod 2**32).
// Not yet used: int8 tensor cores (wgmma), TMA and a load pipeline.
//
// Contract checked by the Python wrapper: K % 4 == 0, N % 4 == 0, all
// tensors contiguous on the current device, out zeroed when splits > 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block; each owns four columns

// Four signed nibbles (one per byte lane) -> four sign-extended int8 lanes.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t nib) {
  return __vsub4(nib ^ 0x08080808u, 0x08080808u);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                   int32_t* __restrict__ out, int M, int K, int N,
                   int groups_per_split) {
  const int m0 = blockIdx.x * BM;
  const int n4 = (blockIdx.y * kThreads + threadIdx.x) * 4;
  const int n_groups = K / 4;  // one group = four k values = two packed rows
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(g_begin + groups_per_split, n_groups);
  if (n4 >= N) return;

  int acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;

  const int rows = min(BM, M - m0);
  // unrolled so that several groups' weight loads are in flight at once
#pragma unroll 4
  for (int g = g_begin; g < g_end; ++g) {
    const size_t r0 = (size_t)(2 * g) * N + n4;
    const uint32_t word0 = __ldg(reinterpret_cast<const uint32_t*>(w + r0));
    const uint32_t word1 = __ldg(reinterpret_cast<const uint32_t*>(w + r0 + N));
    // lanes = columns n4..n4+3; L = even k (low nibble), H = odd k (high)
    const uint32_t L0 = sext_nibbles(word0 & 0x0F0F0F0Fu);
    const uint32_t H0 = sext_nibbles((word0 >> 4) & 0x0F0F0F0Fu);
    const uint32_t L1 = sext_nibbles(word1 & 0x0F0F0F0Fu);
    const uint32_t H1 = sext_nibbles((word1 >> 4) & 0x0F0F0F0Fu);
    // transpose to one word per column holding k = 4g .. 4g+3 in byte order
    const uint32_t P = __byte_perm(L0, H0, 0x5140);
    const uint32_t Q = __byte_perm(L0, H0, 0x7362);
    const uint32_t R = __byte_perm(L1, H1, 0x5140);
    const uint32_t S = __byte_perm(L1, H1, 0x7362);
    const int wc[4] = {(int)__byte_perm(P, R, 0x5410), (int)__byte_perm(P, R, 0x7632),
                       (int)__byte_perm(Q, S, 0x5410), (int)__byte_perm(Q, S, 0x7632)};
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      if (m < rows) {
        const int xv = __ldg(reinterpret_cast<const int*>(x + (size_t)(m0 + m) * K + 4 * g));
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = __dp4a(xv, wc[c], acc[m][c]);
      }
    }
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    if (m < rows) {
      int32_t* o = out + (size_t)(m0 + m) * N + n4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (split) atomicAdd(o + c, acc[m][c]);
        else o[c] = acc[m][c];
      }
    }
  }
}

template <int BM>
void launch(const int8_t* x, const uint8_t* w, int32_t* out, int M, int K, int N,
            int splits, cudaStream_t stream) {
  const int n_groups = K / 4;
  const int per_split = (n_groups + splits - 1) / splits;
  dim3 grid((M + BM - 1) / BM, (N / 4 + kThreads - 1) / kThreads, splits);
  int4_matmul_kernel<BM><<<grid, kThreads, 0, stream>>>(x, w, out, M, K, N, per_split);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int int4_matmul_launch(const void* x, const void* w, void* out, int M, int K,
                                  int N, int bm, int splits, void* stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (bm == 4) launch<4>(xp, wp, op, M, K, N, splits, s);
  else if (bm == 8) launch<8>(xp, wp, op, M, K, N, splits, s);
  else if (bm == 16) launch<16>(xp, wp, op, M, K, N, splits, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
