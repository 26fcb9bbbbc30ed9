// Packed-storage int4 matmul for Hopper (sm_90a): (M, K) int8 activations x
// (K/2, N) uint8 weights holding two signed nibbles per byte -> (M, N) int32.
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py::int4_matmul
// (Pallas body _kernel): unpack the nibbles by arithmetic shifts (row 2i in
// the low nibble), then an int8 dot with int32 accumulation.  Two kernels,
// chosen by the wrapper on M:
//
// * int4_matmul_kernel (M <= 16, the decode GEMV).  What bounds it: it reads
//   0.5 byte per weight and does 2*M integer operations per weight, far
//   below any compute rate, so the weight bytes streamed from HBM
//   (3.35 TB/s) bound it.  What the design does: weights are read exactly
//   once per M tile, as one 32-bit word (four columns) per thread per
//   packed row, so a warp reads 128 contiguous bytes; the nibbles are
//   sign-extended four at a time with byte-SIMD (__vsub4), transposed into
//   per-column k-quads with __byte_perm and fed to __dp4a, four
//   multiply-adds per instruction, with each unpacked weight word reused for
//   every row of the M tile.  A decode GEMV is latency-bound unless many
//   loads are in flight: the K loop is unrolled four groups deep, and layers
//   too narrow to put about eight blocks on every SM split K over blocks.
//
// * int4_matmul_tc_kernel (M > 16, prefill chunks).  What bounds it: at
//   M = 64 dp4a on the CUDA cores would do 2*M operations per weight and,
//   with at most 16 rows per block, stream the weights M/16 times; on the
//   int8 tensor cores (1,979 TOP/s) the same work takes a fraction of the
//   weight stream's time, so the weight bytes bound it again.  What the
//   design does: one block covers 64 rows (all of M = 64), so the weights
//   stream from HBM once per launch, through a 4-stage cp.async ring in
//   shared memory together with the activation tile; each warp sign-extends
//   and transposes its 32 columns' nibbles straight out of the ring into
//   the B fragments of mma.sync m16n8k32 s8 (the nibble transpose above
//   yields exactly four consecutive k of one column per 32-bit register, so
//   a warp's mma column g of n-tile j is block column 4g + j), reads A
//   fragments from a padded activation tile (conflict-free), and runs 16
//   mma per 32 k.  Integer tensor-core accumulation is exact.
//
// Both split K over blocks where the layer is too narrow to fill the card;
// the partial sums meet with integer atomicAdd, which is exact and
// order-independent (int32 addition is associative mod 2**32).
// Not yet used: wgmma (s8 wants both operands K-major in shared memory),
// TMA.
//
// Contract checked by the Python wrapper: K % 4 == 0 and N % 4 == 0 for the
// first kernel, K % 64 == 0 and N % 16 == 0 for the second, all tensors
// contiguous and 16-byte aligned on the current device, out zeroed when
// splits > 1.

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

// ---- M > 16: int8 tensor cores ------------------------------------------------

namespace tc {

constexpr int kBM = 64;                       // rows per block: all of M = 64
constexpr int kBN = 128;                      // columns per block, 32 per warp
constexpr int kBK = 64;                       // k per pipeline stage
constexpr int kStages = 4;
constexpr int kThreads = 128;
constexpr int kAStride = kBK + 16;            // bytes per activation row (80):
                                              // A fragment loads hit 32 banks
constexpr int kWStride = kBN + 16;            // bytes per packed weight row (144)
constexpr int kAStage = kBM * kAStride;       // 5120
constexpr int kWStage = (kBK / 2) * kWStride; // 4608
constexpr int kStageBytes = kAStage + kWStage;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two packed rows (k, k+1 in each byte's nibbles; k+2, k+3) of four columns
// -> one register per column holding its four k as sign-extended s8, in
// byte order: the nibbles sign-extended four at a time, then transposed, as
// int4_matmul_kernel does inline.
__device__ __forceinline__ void nibble_quads(uint32_t word0, uint32_t word1, uint32_t (&wc)[4]) {
  const uint32_t L0 = sext_nibbles(word0 & 0x0F0F0F0Fu);
  const uint32_t H0 = sext_nibbles((word0 >> 4) & 0x0F0F0F0Fu);
  const uint32_t L1 = sext_nibbles(word1 & 0x0F0F0F0Fu);
  const uint32_t H1 = sext_nibbles((word1 >> 4) & 0x0F0F0F0Fu);
  const uint32_t P = __byte_perm(L0, H0, 0x5140);
  const uint32_t Q = __byte_perm(L0, H0, 0x7362);
  const uint32_t R = __byte_perm(L1, H1, 0x5140);
  const uint32_t S = __byte_perm(L1, H1, 0x7362);
  wc[0] = __byte_perm(P, R, 0x5410);
  wc[1] = __byte_perm(P, R, 0x7632);
  wc[2] = __byte_perm(Q, S, 0x5410);
  wc[3] = __byte_perm(Q, S, 0x7632);
}

__global__ void __launch_bounds__(kThreads)
int4_matmul_tc_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                      int32_t* __restrict__ out, int M, int K, int N, int k_per_split) {
  __shared__ __align__(16) uint8_t smem[kStages * kStageBytes];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread in group
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_per_split;
  const int n_tiles = (min(k_begin + k_per_split, K) - k_begin) / kBK;

  auto load_stage = [&](int i) {
    uint8_t* sa = smem + (i % kStages) * kStageBytes;
    uint8_t* sw = sa + kAStage;
    const int k0 = k_begin + i * kBK;
    // activations: kBM rows x kBK bytes; rows past M are zero-filled
    for (int c = tid; c < kBM * (kBK / 16); c += kThreads) {
      const int r = c / (kBK / 16), q = c % (kBK / 16);
      const bool ok = m0 + r < M;
      cp_async16(sa + r * kAStride + q * 16,
                 x + (size_t)(ok ? m0 + r : 0) * K + k0 + q * 16, ok ? 16 : 0);
    }
    // weights: kBK/2 packed rows x kBN bytes; columns past N are zero-filled
    for (int c = tid; c < (kBK / 2) * (kBN / 16); c += kThreads) {
      const int r = c / (kBN / 16), q = c % (kBN / 16);
      const bool ok = n0 + q * 16 < N;
      cp_async16(sw + r * kWStride + q * 16,
                 w + (size_t)(k0 / 2 + r) * N + (ok ? n0 + q * 16 : 0), ok ? 16 : 0);
    }
  };

  int acc[4][4][4];  // [m-tile][n-tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_stage(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; every warp is done with stage i - 1
    if (i + kStages - 1 < n_tiles) load_stage(i + kStages - 1);
    cp_async_commit();
    const uint8_t* sa = smem + (i % kStages) * kStageBytes;
    const uint8_t* sw = sa + kAStage + 32 * warp + 4 * g;
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s) {
      // B: k = 32s + 16h + 4t .. +3 of block columns 32*warp + 4g + j
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * s + 8 * h + 2 * t;
        nibble_quads(lds32(sw + r * kWStride), lds32(sw + (r + 1) * kWStride), b[h]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint8_t* ar = sa + (16 * mt + g) * kAStride + 32 * s + 4 * t;
        const uint32_t a[4] = {lds32(ar), lds32(ar + 8 * kAStride), lds32(ar + 16),
                               lds32(ar + 8 * kAStride + 16)};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a, b[0][j], b[1][j]);
      }
    }
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + 16 * mt + g + 8 * (e >> 1);
        const int col = n0 + 32 * warp + 4 * (2 * t + (e & 1)) + j;
        if (row < M && col < N) {
          int32_t* o = out + (size_t)row * N + col;
          if (split) atomicAdd(o, acc[mt][j][e]);
          else *o = acc[mt][j][e];
        }
      }
}

}  // namespace tc

// M > 16 entry: K % 64 == 0, N % 16 == 0.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int int4_matmul_tc_launch(const void* x, const void* w, void* out, int M, int K,
                                     int N, int splits, void* stream) {
  if (K % tc::kBK || N % 16 || splits < 1) return (int)cudaErrorInvalidValue;
  const int tiles = K / tc::kBK;
  const int per = (tiles + splits - 1) / splits;
  splits = (tiles + per - 1) / per;  // no empty split
  dim3 grid((N + tc::kBN - 1) / tc::kBN, (M + tc::kBM - 1) / tc::kBM, splits);
  tc::int4_matmul_tc_kernel<<<grid, tc::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<int32_t*>(out), M, K, N, per * tc::kBK);
  return (int)cudaGetLastError();
}
