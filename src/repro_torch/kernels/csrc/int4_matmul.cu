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
//   (3.35 TB/s) bound it, and a GEMV reaches that rate only with enough
//   bytes in flight on every SM.  The first design (four columns a thread,
//   one 4-byte load per packed row, four groups unrolled, the activations
//   read with one 4-byte __ldg per row and group) kept 32 bytes in flight a
//   thread and issued six loads per 8 bytes of weights at M = 4.  What the
//   design does: each thread owns CPT = 8 consecutive output columns (4
//   where N is not a multiple of 8, or at an M tile of 16) and reads 8 bytes
//   of each packed row in one load, so a warp reads 256 contiguous bytes of
//   a row.  The block's activation rows are staged once per K tile into
//   shared memory as 4-k words, rows fastest, so one 128-bit broadcast load
//   brings four rows' words and the weight stream has the global loads to
//   itself.  The K loop runs 64 bytes of weights a step and issues the next
//   step's loads before this step's arithmetic, so 64 bytes stay in flight a
//   thread.  The nibbles are unpacked times 16 (the high nibble masked in
//   place, the low one shifted up four: each a signed int8 lane), transposed
//   into per-column k-quads with __byte_perm and fed to __dp4a; the sum, a
//   multiple of 16, is shifted back at the end, exact because a split holds
//   at most kMaxGroups groups (|sum| <= 2**30).  A block's 128 threads form
//   CPT / 4 slices over K, so a block covers 512 columns whatever CPT: the
//   slices' sums meet in shared memory, and all threads then store (or
//   atomically add) consecutive columns, coalesced.  Layers too narrow to
//   fill the card split K over blocks (about four a SM, 32 groups a split
//   at least).  Tried on the card and not kept: 16 columns a thread
//   (16-byte loads; their registers leave fewer blocks, so fewer bytes in
//   flight, a SM) and 128 bytes a step, both slower.
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
//   the B fragments of mma.sync m16n8k32 s8 (the nibble transpose below
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
// Contract checked by the Python wrapper: K % 4 == 0 and N % CPT == 0 for
// the first kernel (CPT 8 or 4, BM x CPT at most 64), at most kMaxGroups
// groups of four k per split; K % 64 == 0 and N % 16 == 0 for the second;
// all tensors contiguous and 16-byte aligned on the current device, out
// zeroed when splits > 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // threads per block; each owns CPT columns
constexpr int kStageBytes = 16384;   // staged activation bytes per K tile
constexpr int kMaxGroups = 16384;    // groups a split may hold: |16 * sum| <= 2**30
constexpr int kSmemInts = 8192;      // staged words, then the slices' sums (128 x 64)
constexpr int kStepBytes = 64;       // weight bytes a thread loads a step

// Four signed nibbles (one per byte lane) -> four sign-extended int8 lanes.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t nib) {
  return __vsub4(nib ^ 0x08080808u, 0x08080808u);
}

// Two packed rows (k, k+1 in each byte's nibbles; k+2, k+3) of four columns
// -> one register per column holding its four k as signed int8 lanes, each
// times 16: a nibble moved to the top of its byte is its value times 16 as
// an int8, so masking replaces the sign extension.
__device__ __forceinline__ void nibble_quads16(uint32_t word0, uint32_t word1,
                                               int (&wc)[4]) {
  const uint32_t L0 = (word0 << 4) & 0xF0F0F0F0u, H0 = word0 & 0xF0F0F0F0u;
  const uint32_t L1 = (word1 << 4) & 0xF0F0F0F0u, H1 = word1 & 0xF0F0F0F0u;
  const uint32_t P = __byte_perm(L0, H0, 0x5140);
  const uint32_t Q = __byte_perm(L0, H0, 0x7362);
  const uint32_t R = __byte_perm(L1, H1, 0x5140);
  const uint32_t S = __byte_perm(L1, H1, 0x7362);
  wc[0] = (int)__byte_perm(P, R, 0x5410);
  wc[1] = (int)__byte_perm(P, R, 0x7632);
  wc[2] = (int)__byte_perm(Q, S, 0x5410);
  wc[3] = (int)__byte_perm(Q, S, 0x7632);
}

// CPT bytes of one packed row: one 8- or 4-byte load.
template <int CPT> struct RowBytes { uint32_t w[CPT / 4]; };

template <int CPT>
__device__ __forceinline__ RowBytes<CPT> load_row(const uint8_t* p, bool ok) {
  RowBytes<CPT> r;
  if constexpr (CPT == 8) {
    const uint2 v = ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0, 0);
    r.w[0] = v.x, r.w[1] = v.y;
  } else {
    r.w[0] = ok ? __ldg(reinterpret_cast<const uint32_t*>(p)) : 0u;
  }
  return r;
}

// BM rows x CPT columns a thread; G groups (of four k: two packed rows) a
// step, so that 2 * CPT * G = kStepBytes are loaded a step.  The block's
// threads form KS = CPT / 4 slices of kThreads / KS column threads (a
// warp's columns are contiguous; a block covers 512 columns): each slice
// runs its own share of every staged K tile, and the slices' sums meet in
// shared memory at the end, so that wider threads need no more blocks split
// over K (nor atomics).
template <int BM, int CPT>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                   int32_t* __restrict__ out, int M, int K, int N,
                   int groups_per_split) {
  static_assert(BM % 4 == 0 && BM * CPT <= 64 && kStepBytes % (2 * CPT) == 0, "tile");
  constexpr int G = kStepBytes / (2 * CPT);
  constexpr int KS = CPT / 4;
  constexpr int kTileGroups = kStageBytes / (4 * BM);
  // staged activation words [group][row] (rows fastest), then the slices' sums
  static_assert(kTileGroups * BM <= kSmemInts && kThreads * BM * CPT <= kSmemInts, "smem");
  __shared__ __align__(16) int smem[kSmemInts];
  int* xs = smem;
  constexpr int lanes = kThreads / KS;  // column threads a slice
  const int slice = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const int m0 = blockIdx.x * BM;
  const int n0 = (blockIdx.y * lanes + lane) * CPT;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(g_begin + groups_per_split, K / 4);
  const int rows = min(BM, M - m0);

  int acc[BM][CPT];  // 16 x the dot: the weights enter times 16
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0;

  for (int gt = g_begin; gt < g_end; gt += kTileGroups) {
    const int ng = min(kTileGroups, g_end - gt);
    __syncthreads();  // the previous tile's words are consumed
    for (int i = threadIdx.x; i < ng * BM; i += kThreads) {
      const int m = i % BM, g = i / BM;
      xs[i] = m < rows ? __ldg(reinterpret_cast<const int*>(
                             x + (size_t)(m0 + m) * K + 4 * (gt + g)))
                       : 0;
    }
    __syncthreads();
    if (n0 >= N) continue;
    // this slice's groups of the tile: [s0, s0 + sn)
    const int share = (ng + KS - 1) / KS;
    const int s0 = min(ng, slice * share), sn = min(ng, s0 + share) - s0;
    const uint8_t* wt = w + (size_t)(2 * (gt + s0)) * N + n0;
    const int* xt = xs + s0 * BM;
    RowBytes<CPT> cur[G][2], nxt[G][2];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      cur[u][0] = load_row<CPT>(wt + (size_t)(2 * u) * N, u < sn);
      cur[u][1] = load_row<CPT>(wt + (size_t)(2 * u + 1) * N, u < sn);
    }
    for (int g0 = 0; g0 < sn; g0 += G) {
      // the next step's loads first: they stay in flight during this one
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int g = g0 + G + u;
        nxt[u][0] = load_row<CPT>(wt + (size_t)(2 * g) * N, g < sn);
        nxt[u][1] = load_row<CPT>(wt + (size_t)(2 * g + 1) * N, g < sn);
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int g = g0 + u;
        if (g < sn) {
          int xv[BM];
#pragma unroll
          for (int m4 = 0; m4 < BM / 4; ++m4) {
            const int4 a = reinterpret_cast<const int4*>(xt + g * BM)[m4];
            xv[4 * m4] = a.x, xv[4 * m4 + 1] = a.y, xv[4 * m4 + 2] = a.z,
            xv[4 * m4 + 3] = a.w;
          }
#pragma unroll
          for (int q = 0; q < CPT / 4; ++q) {
            int wc[4];
            nibble_quads16(cur[u][0].w[q], cur[u][1].w[q], wc);
#pragma unroll
            for (int m = 0; m < BM; ++m)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[m][4 * q + c] = __dp4a(xv[m], wc[c], acc[m][4 * q + c]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < G; ++u) cur[u][0] = nxt[u][0], cur[u][1] = nxt[u][1];
    }
  }

  // every slice leaves its sums in shared memory, [slice][row][column], the
  // block's columns consecutive; then all threads add the slices up for
  // consecutive columns, so that the stores (or atomics) coalesce
  constexpr int cols = lanes * CPT;  // the block's columns
  int* sums = smem;
  __syncthreads();  // the staged words are consumed
  if (n0 < N) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int c = 0; c < CPT; c += 4)
        *reinterpret_cast<int4*>(sums + (slice * BM + m) * cols + lane * CPT + c) =
            make_int4(acc[m][c], acc[m][c + 1], acc[m][c + 2], acc[m][c + 3]);
  }
  __syncthreads();
  const int col0 = blockIdx.y * cols;
  const bool split = gridDim.z > 1;
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int m = i / cols, j = i % cols;
    if (col0 + j >= N) continue;
    int v = 0;
#pragma unroll
    for (int s = 0; s < KS; ++s) v += sums[(s * BM + m) * cols + j];
    v >>= 4;  // exact: a multiple of 16
    int32_t* o = out + (size_t)(m0 + m) * N + col0 + j;
    if (split) atomicAdd(o, v);
    else *o = v;
  }
}

template <int BM, int CPT>
int launch(const int8_t* x, const uint8_t* w, int32_t* out, int M, int K, int N,
           int splits, cudaStream_t stream) {
  const int n_groups = K / 4;
  const int per_split = (n_groups + splits - 1) / splits;
  if (per_split > kMaxGroups) return (int)cudaErrorInvalidValue;
  constexpr int cols = kThreads / (CPT / 4) * CPT;  // output columns a block: 512
  dim3 grid((M + BM - 1) / BM, (N + cols - 1) / cols, splits);
  int4_matmul_kernel<BM, CPT><<<grid, kThreads, 0, stream>>>(x, w, out, M, K, N, per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// M <= 16 entry: bm the M tile (4, 8 or 16), cpt the columns a thread (8 or
// 4, bm * cpt <= 64, N % cpt == 0; a block covers 512 columns either way),
// K % 4 == 0.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int int4_matmul_launch(const void* x, const void* w, void* out, int M, int K,
                                  int N, int bm, int cpt, int splits, void* stream) {
  if (K % 4 || cpt < 4 || N % cpt || splits < 1) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (bm == 4 && cpt == 8) return launch<4, 8>(xp, wp, op, M, K, N, splits, s);
  if (bm == 4 && cpt == 4) return launch<4, 4>(xp, wp, op, M, K, N, splits, s);
  if (bm == 8 && cpt == 8) return launch<8, 8>(xp, wp, op, M, K, N, splits, s);
  if (bm == 8 && cpt == 4) return launch<8, 4>(xp, wp, op, M, K, N, splits, s);
  if (bm == 16 && cpt == 4) return launch<16, 4>(xp, wp, op, M, K, N, splits, s);
  return (int)cudaErrorInvalidValue;
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
// byte order: the nibbles sign-extended four at a time, then transposed as
// nibble_quads16 transposes them.
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
