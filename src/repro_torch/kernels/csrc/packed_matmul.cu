// Pair-packed "DSP-sim" matmul for Hopper (sm_90a): (M, K) unsigned
// activations x signed weights -> (M, N) int32, in the paper's packed
// int32 arithmetic, for any legal PackedDotSpec.
//
// Replaces two TPU kernels of src/repro/kernels/packed_matmul.py:
//   * packed_matmul_prepacked (Pallas body _prepacked_kernel, with the fused
//     activation-quantize prologue _quantize_tile): weights arrive packed
//     once as pair words (n_chunks, n_pairs, N) int32, plus, for mr plans,
//     the paired weights wsc (n_chunks, n_pairs, 2, N) int32;
//   * packed_matmul (Pallas body _kernel): weights arrive as (K, N) int8
//     signed integers and are packed into words as they are read.
// Per activation bit-slice column j: activation pair words
// x[2i] + (x[2i+1] << p) times weight words w[2i+1] + (w[2i] << p),
// multiply-accumulated n_pairs at a time in wrapping int32; each chunk's
// middle field is extracted (floor or round-half-up, sign-extended at
// p + mr_bits; mr plans subtract sum(x[2i+1] * w[2i]) mod 2**mr_bits at the
// top mr_bits), and the fields are summed and recombined as
// field << (j * col_bits_a).  All wrapping arithmetic runs in uint32 (signed
// overflow and left shifts of negative values are undefined in C++17); only
// the extraction's arithmetic right shifts run on int32.
//
// What bounds it on this card: at decode shapes (M = 4) it streams 2 bytes
// of words per weight (plus 2 bytes of wsc's even lane for the mr plans
// with bits_w > p, below) and does 2*M (4*M for mr) 32-bit multiply-adds
// per weight and column: HBM bytes bound it.  At prefill shapes (M = 64) the
// 32-bit IMADs on the CUDA cores bound it: there is no tensor-core form of a
// wrapping int32 x int32 product.
//
// The even lane.  An mr plan's contamination needs w_even mod 2**mr_bits
// per pair.  Where bits_w <= p the pair word w_odd + (w_even << p) holds it:
// w_odd = sext_p(word mod 2**p), w_even = (word - w_odd) >> p (even_lane),
// so the prepacked kernels derive it and never read wsc; the other mr plans
// (bits_w > p) read wsc's even lane.
//
// What the design does about it, at M <= 16 (packed_matmul_kernel, both
// entries): activation pair words for the block's M tile are built once per
// K tile into shared memory (quantized there from f32 in the fused form, so
// the integer activations never touch HBM) in a row-fastest layout, so one
// 128-bit broadcast load feeds four rows' multiply-adds, and each weight word
// is loaded once for up to four column streams.  Each thread owns one output
// column, or four for prepacked words at M <= 4 (one 16-byte load brings
// four columns' words: with the even lane derived a pair costs one load, and
// one column's 4-byte loads left HBM at about a third of its rate), and
// reads its words once per M tile, coalesced across the warp.  Extraction
// happens exactly every n_pairs products (a K tile holds whole chunks).  The
// pair loop is unrolled (four deep, eight for prepacked words) so several
// word loads are in flight, and layers too narrow to put about eight blocks
// on every SM split the chunks over blocks; the partial sums meet with
// integer atomicAdd, exact and order-independent mod 2**32.  Not yet done:
// TMA, a load pipeline.
//
// The per-call entry at M <= 16 (packed_matmul_wide_kernel, where N % 8 ==
// 0 and the accumulators fit; the one-column kernel elsewhere).  What bounds
// it: 1 byte of int8 weight per weight and, for INT4_EXACT, 2*M 32-bit
// multiply-adds per weight pair and an extraction per chunk: the bytes
// (0.12 ms at M = 4, 8192 x 49152) lead, the integer work close behind.
// The one-column form read each weight with a 1-byte load, so a warp's
// request covered 32 bytes of a 128-byte line, and kept about 8 bytes in
// flight a thread: latency bounded it, at a fifth of the byte rate.  What
// the design does: each thread owns 8 consecutive columns and reads each
// weight row's 8 int8 values in one 8-byte load (a warp reads 256
// contiguous bytes of the row), builds the 8 pair words (and even weights)
// in registers, and issues the next 64 bytes of rows before this step's
// products.  The block's threads form two slices over K, so a block covers
// 512 columns and the grid splits K no more than before; the slices' sums
// meet in shared memory, and all threads store (or atomically add)
// consecutive columns, coalesced.  Tried on the card and not kept: 16
// columns a thread (16-byte loads; their registers leave two blocks a SM)
// and 128 bytes a step, both slower.
//
// At M > 16 both entries run a tiled kernel instead: packed_matmul_tiled_kernel
// (per-call entry) and packed_matmul_prepacked_tiled_kernel (prepacked).
// What held the one-column kernel back there: a block held at most 16 rows,
// so M = 64 streamed the weights four times and packed every weight word
// four times; every pair product cost a shared-memory load besides its
// IMAD; and each thread's single column gave the scheduler little
// independent work.  What the tiled design does: a block covers 64 rows x
// 128 columns, so the weights stream from HBM once per launch, through a
// 3-stage cp.async ring that also carries the activation tile; each stage is
// turned once per block into activation pair words in shared memory (the
// prepacked kernel quantizes the f32 tile there first: round(x / scale) +
// zp, half to even, clipped, K padded with f32 zeros as the reference pads),
// and into weight pair words (per-call entry; the prepacked words are read
// from the ring as they are stored) and even weights (mr plans); each
// thread then owns an 8-row x 4-column register tile, so one 128-bit load
// of four weight words and two of eight activation words feed 32 IMADs.
// Extraction happens exactly every n_pairs products (a stage holds whole
// chunks); without an mr correction it is one arithmetic shift and an add
// per field, the alignment folded into the weight words and the rounding
// into the partial sum's start (see note above packed_matmul_tiled_kernel).
// The IMADs then bound it: a wrapping int32 x int32 product has no
// tensor-core form, so it stays behind an int8 tensor-core GEMM of the same
// shape.

#include <cuda_runtime.h>
#include <stdint.h>

// Launch parameters; mirrored field for field by the Python wrapper.
struct PackedParams {
  int M, K, N;          // K: activation columns (x's row length)
  int kw;               // weight rows the word grid covers (raw: K of w)
  int n_chunks, n_pairs, p, n_columns, col_bits_a, mr_bits;
  int rounds_half_up, uses_mr, zp;
  int tile_chunks, chunks_per_split;
  int reads_wsc;        // prepacked mr plans: 1 = read wsc's even lane, 0 = derive it
  int cols_per_thread;  // M <= 16: output columns a thread (prepacked 1 or 4, raw 1 or 8)
};

namespace {

using Params = PackedParams;
constexpr int kThreads = 128;  // one output column per thread

__device__ __forceinline__ int32_t sext(uint32_t v, int width) {
  const uint32_t mask = (1u << width) - 1u;
  const uint32_t sign = 1u << (width - 1);
  return (int32_t)(((v & mask) ^ sign) - sign);
}

__device__ __forceinline__ int32_t extract(uint32_t partial_u, uint32_t contam,
                                           const Params& P) {
  const int32_t partial = (int32_t)partial_u;
  int32_t t;
  if (P.rounds_half_up) t = (int32_t)((uint32_t)(partial >> (P.p - 1)) + 1u) >> 1;
  else t = partial >> P.p;
  const int we = P.p + (P.uses_mr ? P.mr_bits : 0);
  int32_t e = sext((uint32_t)t, we);
  if (P.uses_mr) e = sext((uint32_t)e - (contam << (we - P.mr_bits)), we);
  return e;
}

// w_even mod 2**mr_bits from the pair word w_odd + (w_even << p), for plans
// with bits_w <= p (and p + mr_bits <= 32): w_odd = sext_p(word mod 2**p)
// since |w_odd| < 2**(p-1) or w_odd = -2**(p-1), and (word - w_odd) >> p is
// w_even mod 2**(32-p).  Spares the wsc stream its 2 bytes per weight.
__device__ __forceinline__ uint32_t even_lane(uint32_t word, int p, uint32_t mrmask) {
  return ((word - (uint32_t)sext(word, p)) >> p) & mrmask;
}

// One activation value as an unsigned integer.  Fused form: the f32
// activation quantized offset-binary, round half to even (rintf) after an
// IEEE division, exactly the reference's round(x / scale) + zp, clipped.
// Positions past K read as f32 0 (fused) or 0 (integer form), as the
// reference pads them.
template <bool FUSED>
__device__ __forceinline__ uint32_t load_x(const void* x, const float* scale, int row,
                                           int k, const Params& P) {
  if (FUSED) {
    const float xv = k < P.K ? static_cast<const float*>(x)[(size_t)row * P.K + k] : 0.0f;
    float q = rintf(xv / scale[row]) + (float)P.zp;
    q = fminf(fmaxf(q, 0.0f), (float)(2 * P.zp - 1));
    return (uint32_t)(int32_t)q;
  }
  return k < P.K ? (uint32_t)static_cast<const int32_t*>(x)[(size_t)row * P.K + k] : 0u;
}

// Stage the activation pair words of the block's M tile for one K tile
// (tpt pairs from chunk ct on): each (row, pair) loads (or quantizes) its
// two activations once and writes the pair word of every column slice, and
// the odd activation's low mr bits, in the layout [column j][pair q][row m],
// rows fastest (one uint4 = four rows), tile_chunks * n_pairs pairs a column.
template <int BM, bool FUSED>
__device__ __forceinline__ void stage_pairs(const void* x, const float* x_scale,
                                            uint32_t* aw, uint32_t* xo, int m0, int ct,
                                            int tpt, const Params& P) {
  const int chunk = 2 * P.n_pairs;
  const int tp = P.tile_chunks * P.n_pairs;
  const uint32_t cmask = P.n_columns == 1 ? 0xFFFFFFFFu : (1u << P.col_bits_a) - 1u;
  const uint32_t mrmask = (1u << P.mr_bits) - 1u;
  for (int idx = threadIdx.x; idx < tpt * BM; idx += kThreads) {
    const int m = idx % BM;
    const int q = idx / BM;
    const int row = m0 + m;
    const int k = ct * chunk + 2 * q;
    uint32_t v0 = 0u, v1 = 0u;
    if (row < P.M) {
      v0 = load_x<FUSED>(x, x_scale, row, k, P);
      v1 = load_x<FUSED>(x, x_scale, row, k + 1, P);
    }
    for (int j = 0; j < P.n_columns; ++j) {
      const uint32_t s0 = (v0 >> (j * P.col_bits_a)) & cmask;
      const uint32_t s1 = (v1 >> (j * P.col_bits_a)) & cmask;
      const size_t at = ((size_t)j * tp + q) * BM + m;
      aw[at] = s0 + (s1 << P.p);
      xo[at] = s1 & mrmask;
    }
  }
}

// RAW = weights are (kw, N) int8 signed ints packed on the fly; otherwise
// prepacked words (+ wsc for mr plans whose even lane is not derived).  NCP
// = activation columns served per pass over the weights (a divisor of
// n_columns): each weight word is loaded once per pass and multiplied into
// NCP column streams.  CPT = output columns per thread (prepacked only, N
// % CPT == 0): one 16-byte load brings four columns' words, so that a
// thread keeps four times the bytes in flight per load.  The per-call
// entry's several columns a thread are packed_matmul_wide_kernel's.
template <int BM, int NCP, int CPT, bool FUSED, bool RAW>
__global__ void __launch_bounds__(kThreads)
packed_matmul_kernel(const void* __restrict__ x, const float* __restrict__ x_scale,
                     const int32_t* __restrict__ words, const int32_t* __restrict__ wsc,
                     const int8_t* __restrict__ w_raw, int32_t* __restrict__ out,
                     Params P) {
  static_assert(CPT == 1 || (CPT == 4 && !RAW),
                "four columns a thread: prepacked words (raw: packed_matmul_wide_kernel)");
  extern __shared__ __align__(16) uint32_t smem[];
  const int m0 = blockIdx.x * BM;
  const int n = (blockIdx.y * kThreads + threadIdx.x) * CPT;  // the thread's first column
  const int c_begin = blockIdx.z * P.chunks_per_split;
  const int c_end = min(c_begin + P.chunks_per_split, P.n_chunks);
  const int chunk = 2 * P.n_pairs;
  const int tp = P.tile_chunks * P.n_pairs;  // pair words per staged K tile
  // layout [column j][pair q][row m], rows fastest: one uint4 = four rows
  uint32_t* aw = smem;
  uint32_t* xo = smem + (size_t)P.n_columns * tp * BM;
  const uint32_t mrmask = (1u << P.mr_bits) - 1u;

  uint32_t acc[BM][CPT];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int u = 0; u < CPT; ++u) acc[m][u] = 0u;

  for (int ct = c_begin; ct < c_end; ct += P.tile_chunks) {
    const int nct = min(P.tile_chunks, c_end - ct);
    const int tpt = nct * P.n_pairs;
    __syncthreads();  // the previous tile's words are consumed
    stage_pairs<BM, FUSED>(x, x_scale, aw, xo, m0, ct, tpt, P);
    __syncthreads();
    if (n < P.N) {
      for (int j0 = 0; j0 < P.n_columns; j0 += NCP) {
        for (int cc = 0; cc < nct; ++cc) {
          const int c = ct + cc;
          uint32_t part[NCP][BM][CPT], cont[NCP][BM][CPT];
#pragma unroll
          for (int jj = 0; jj < NCP; ++jj)
#pragma unroll
            for (int m = 0; m < BM; ++m)
#pragma unroll
              for (int u = 0; u < CPT; ++u) part[jj][m][u] = cont[jj][m][u] = 0u;
          // unrolled so that several pairs' word loads are in flight at once
          // (eight deep for the prepacked words: one load a pair)
          constexpr int kUnroll = RAW ? 4 : 8;
#pragma unroll kUnroll
          for (int pp = 0; pp < P.n_pairs; ++pp) {
            uint32_t wword[CPT], weven[CPT];
            if (RAW) {
              const int k = c * chunk + 2 * pp;
              const int32_t w0 = k < P.kw ? (int32_t)w_raw[(size_t)k * P.N + n] : 0;
              const int32_t w1 = k + 1 < P.kw ? (int32_t)w_raw[(size_t)(k + 1) * P.N + n] : 0;
              wword[0] = (uint32_t)w1 + ((uint32_t)w0 << P.p);
              weven[0] = (uint32_t)w0 & mrmask;
            } else {
              const size_t wi = ((size_t)c * P.n_pairs + pp) * P.N + n;
              const size_t ei = (((size_t)c * P.n_pairs + pp) * 2) * P.N + n;
              if constexpr (CPT == 4) {
                const uint4 w4 = __ldg(reinterpret_cast<const uint4*>(words + wi));
                wword[0] = w4.x, wword[1] = w4.y, wword[2] = w4.z, wword[3] = w4.w;
                if (P.uses_mr && P.reads_wsc) {
                  const uint4 e4 = __ldg(reinterpret_cast<const uint4*>(wsc + ei));
                  weven[0] = e4.x, weven[1] = e4.y, weven[2] = e4.z, weven[3] = e4.w;
                }
              } else {
                wword[0] = (uint32_t)__ldg(words + wi);
                if (P.uses_mr && P.reads_wsc) weven[0] = (uint32_t)__ldg(wsc + ei);
              }
#pragma unroll
              for (int u = 0; u < CPT; ++u)
                weven[u] = !P.uses_mr ? 0u
                           : P.reads_wsc ? weven[u] & mrmask
                                         : even_lane(wword[u], P.p, mrmask);
            }
#pragma unroll
            for (int jj = 0; jj < NCP; ++jj) {
              const size_t base =
                  ((size_t)(j0 + jj) * tp + (size_t)cc * P.n_pairs + pp) * BM;
              const uint4* a4 = reinterpret_cast<const uint4*>(aw + base);
#pragma unroll
              for (int m4 = 0; m4 < BM / 4; ++m4) {
                const uint4 a = a4[m4];
#pragma unroll
                for (int u = 0; u < CPT; ++u) {
                  part[jj][4 * m4 + 0][u] += a.x * wword[u];
                  part[jj][4 * m4 + 1][u] += a.y * wword[u];
                  part[jj][4 * m4 + 2][u] += a.z * wword[u];
                  part[jj][4 * m4 + 3][u] += a.w * wword[u];
                }
              }
              if (P.uses_mr) {
                const uint4* o4 = reinterpret_cast<const uint4*>(xo + base);
#pragma unroll
                for (int m4 = 0; m4 < BM / 4; ++m4) {
                  const uint4 a = o4[m4];
#pragma unroll
                  for (int u = 0; u < CPT; ++u) {
                    cont[jj][4 * m4 + 0][u] += a.x * weven[u];
                    cont[jj][4 * m4 + 1][u] += a.y * weven[u];
                    cont[jj][4 * m4 + 2][u] += a.z * weven[u];
                    cont[jj][4 * m4 + 3][u] += a.w * weven[u];
                  }
                }
              }
            }
          }
#pragma unroll
          for (int jj = 0; jj < NCP; ++jj) {
            const uint32_t shift = (uint32_t)((j0 + jj) * P.col_bits_a);
#pragma unroll
            for (int m = 0; m < BM; ++m)
#pragma unroll
              for (int u = 0; u < CPT; ++u)
                acc[m][u] += (uint32_t)extract(part[jj][m][u], cont[jj][m][u] & mrmask, P)
                             << shift;
          }
        }
      }
    }
  }

  if (n < P.N) {
    const bool split = gridDim.z > 1;
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      if (m0 + m < P.M) {
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          int32_t* o = out + (size_t)(m0 + m) * P.N + n + u;
          if (split) atomicAdd(o, (int32_t)acc[m][u]);
          else *o = (int32_t)acc[m][u];
        }
      }
    }
  }
}

template <int BM, int NCP, int CPT, bool FUSED, bool RAW>
int launch(const void* x, const float* x_scale, const int32_t* words, const int32_t* wsc,
           const int8_t* w_raw, int32_t* out, const Params& P, int splits,
           cudaStream_t stream) {
  auto kernel = packed_matmul_kernel<BM, NCP, CPT, FUSED, RAW>;
  const size_t smem = 2u * (size_t)P.n_columns * P.tile_chunks * P.n_pairs * BM *
                      sizeof(uint32_t);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int cols = kThreads * CPT;  // output columns per block
  dim3 grid((P.M + BM - 1) / BM, (P.N + cols - 1) / cols, splits);
  kernel<<<grid, kThreads, smem, stream>>>(x, x_scale, words, wsc, w_raw, out, P);
  return (int)cudaGetLastError();
}

// ---- per-call entry at M <= 16, eight columns a thread ----------------------------

constexpr int kWideCols = 8;    // output columns a thread of the wide kernel
constexpr int kWideSlices = 2;  // its block's slices over K: a block covers 512 columns
constexpr int kStepBytes = 64;  // weight bytes a thread of the wide kernel loads a step

// kWideCols bytes of one weight row: one 8-byte load (zero past kw).
__device__ __forceinline__ uint2 load_row(const int8_t* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0, 0);
}

// The per-call entry's M <= 16 kernel where N % 8 == 0 and the
// accumulators fit (NC x BM x 8, twice for an mr plan, at most 64): each
// thread owns CPT = kWideCols = 8 consecutive output columns and reads each
// weight row's 8 int8 values with one 8-byte load, so a warp reads 256
// contiguous bytes of the row.  The pair words w1 + (w0 << p) and the even
// weights (mr plans) are built in registers from the loaded bytes, in the
// one-column kernel's uint32 arithmetic; the activations are staged and the
// fields extracted as that kernel does, all NC = n_columns column streams
// in one pass.  The pairs run U a step (kStepBytes of weights), the next
// step's loads issued before this step's products, so 64 bytes stay in
// flight a thread.  The block's threads form kWideSlices slices of
// kThreads / kWideSlices column threads: each slice runs its share of every
// staged K tile's chunks, and the slices' sums meet in shared memory at the
// end, so that wider threads need no more blocks split over K (and no more
// atomics) than one column a thread did.
template <int BM, int NC, bool MR>
__global__ void __launch_bounds__(kThreads)
packed_matmul_wide_kernel(const int32_t* __restrict__ x, const int8_t* __restrict__ w,
                          int32_t* __restrict__ out, Params P) {
  constexpr int CPT = kWideCols;
  static_assert(NC * BM * CPT * (MR ? 2 : 1) <= 64, "tile");
  constexpr int U = kStepBytes / (2 * CPT);  // pairs a step: 2 rows x CPT bytes x U
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int lanes = kThreads / kWideSlices;  // column threads a slice
  const int slice = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const int m0 = blockIdx.x * BM;
  const int n = (blockIdx.y * lanes + lane) * CPT;  // the thread's first column
  const int c_begin = blockIdx.z * P.chunks_per_split;
  const int c_end = min(c_begin + P.chunks_per_split, P.n_chunks);
  const int chunk = 2 * P.n_pairs;
  const int tp = P.tile_chunks * P.n_pairs;
  const uint32_t* aw = smem;
  const uint32_t* xo = smem + (size_t)NC * tp * BM;
  const uint32_t mrmask = (1u << P.mr_bits) - 1u;

  uint32_t acc[BM][CPT];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int u = 0; u < CPT; ++u) acc[m][u] = 0u;

  for (int ct = c_begin; ct < c_end; ct += P.tile_chunks) {
    const int nct = min(P.tile_chunks, c_end - ct);
    __syncthreads();  // the previous tile's words are consumed
    stage_pairs<BM, false>(x, nullptr, smem, smem + (size_t)NC * tp * BM, m0, ct,
                           nct * P.n_pairs, P);
    __syncthreads();
    if (n >= P.N) continue;
    // this slice's chunks of the tile, as pairs [q_begin, q_end)
    const int share = (nct + kWideSlices - 1) / kWideSlices;
    const int q_begin = min(nct, slice * share) * P.n_pairs;
    const int q_end = min(nct, (slice + 1) * share) * P.n_pairs;
    const int8_t* wt = w + (size_t)ct * chunk * P.N + n;
    const int rows = P.kw - ct * chunk;  // weight rows from this tile's first on
    uint2 cur[U][2], nxt[U][2];  // rows 2q and 2q + 1 of pair q's columns
    auto load = [&](uint2 (&b)[U][2], int q0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = 2 * (q0 + u);
        const bool in = q0 + u < q_end;
        b[u][0] = load_row(wt + (size_t)r * P.N, in && r < rows);
        b[u][1] = load_row(wt + (size_t)(r + 1) * P.N, in && r + 1 < rows);
      }
    };
    uint32_t part[NC][BM][CPT], cont[MR ? NC : 1][BM][CPT];
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int u = 0; u < CPT; ++u) part[jj][m][u] = cont[MR ? jj : 0][m][u] = 0u;
    load(cur, q_begin);
    int pp = 0;  // the pair's place in its chunk (a slice starts on a chunk)
    for (int q0 = q_begin; q0 < q_end; q0 += U) {
      load(nxt, q0 + U);  // in flight during this step's products
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u;
        if (q >= q_end) break;
        uint32_t wword[CPT], weven[CPT];
#pragma unroll
        for (int b = 0; b < CPT; ++b) {
          const int32_t w0 = (int8_t)((b < 4 ? cur[u][0].x : cur[u][0].y) >> (8 * (b % 4)));
          const int32_t w1 = (int8_t)((b < 4 ? cur[u][1].x : cur[u][1].y) >> (8 * (b % 4)));
          wword[b] = (uint32_t)w1 + ((uint32_t)w0 << P.p);
          weven[b] = (uint32_t)w0 & mrmask;
        }
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) {
          const size_t base = ((size_t)jj * tp + q) * BM;
          const uint4* a4 = reinterpret_cast<const uint4*>(aw + base);
#pragma unroll
          for (int m4 = 0; m4 < BM / 4; ++m4) {
            const uint4 a = a4[m4];
#pragma unroll
            for (int b = 0; b < CPT; ++b) {
              part[jj][4 * m4 + 0][b] += a.x * wword[b];
              part[jj][4 * m4 + 1][b] += a.y * wword[b];
              part[jj][4 * m4 + 2][b] += a.z * wword[b];
              part[jj][4 * m4 + 3][b] += a.w * wword[b];
            }
          }
          if constexpr (MR) {
            const uint4* o4 = reinterpret_cast<const uint4*>(xo + base);
#pragma unroll
            for (int m4 = 0; m4 < BM / 4; ++m4) {
              const uint4 a = o4[m4];
#pragma unroll
              for (int b = 0; b < CPT; ++b) {
                cont[jj][4 * m4 + 0][b] += a.x * weven[b];
                cont[jj][4 * m4 + 1][b] += a.y * weven[b];
                cont[jj][4 * m4 + 2][b] += a.z * weven[b];
                cont[jj][4 * m4 + 3][b] += a.w * weven[b];
              }
            }
          }
        }
        if (++pp == P.n_pairs) {  // the chunk is complete: extract its fields
          pp = 0;
#pragma unroll
          for (int jj = 0; jj < NC; ++jj) {
            const uint32_t shift = (uint32_t)(jj * P.col_bits_a);
#pragma unroll
            for (int m = 0; m < BM; ++m)
#pragma unroll
              for (int b = 0; b < CPT; ++b) {
                acc[m][b] += (uint32_t)extract(part[jj][m][b],
                                               MR ? cont[MR ? jj : 0][m][b] & mrmask : 0u, P)
                             << shift;
                part[jj][m][b] = cont[MR ? jj : 0][m][b] = 0u;
              }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u][0] = nxt[u][0], cur[u][1] = nxt[u][1];
    }
  }

  // every slice leaves its sums in shared memory, [slice][row][column], the
  // block's columns consecutive; then all threads add the slices up for
  // consecutive columns, so that the stores (or atomics) coalesce
  constexpr int cols = lanes * CPT;  // the block's columns
  __syncthreads();  // the staged words are consumed
  if (n < P.N) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int b = 0; b < CPT; b += 4)
        *reinterpret_cast<uint4*>(smem + (slice * BM + m) * cols + lane * CPT + b) =
            make_uint4(acc[m][b], acc[m][b + 1], acc[m][b + 2], acc[m][b + 3]);
  }
  __syncthreads();
  const int col0 = blockIdx.y * cols;
  const int rows_out = min(BM, P.M - m0);
  const bool split = gridDim.z > 1;
  for (int i = threadIdx.x; i < rows_out * cols; i += kThreads) {
    const int m = i / cols, j = i % cols;
    if (col0 + j >= P.N) continue;
    uint32_t v = 0u;
#pragma unroll
    for (int s = 0; s < kWideSlices; ++s) v += smem[(s * BM + m) * cols + j];
    int32_t* o = out + (size_t)(m0 + m) * P.N + col0 + j;
    if (split) atomicAdd(o, (int32_t)v);
    else *o = (int32_t)v;
  }
}

template <int BM, int NC, bool MR>
int launch_wide(const int32_t* x, const int8_t* w, int32_t* out, const Params& P, int splits,
                cudaStream_t stream) {
  constexpr int CPT = kWideCols;
  auto kernel = packed_matmul_wide_kernel<BM, NC, MR>;
  const size_t stage = 2u * (size_t)NC * P.tile_chunks * P.n_pairs * BM * sizeof(uint32_t);
  const size_t sums = (size_t)kThreads * BM * CPT * sizeof(uint32_t);
  const size_t smem = stage > sums ? stage : sums;
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  constexpr int cols = kThreads / kWideSlices * CPT;  // output columns a block
  dim3 grid((P.M + BM - 1) / BM, (P.N + cols - 1) / cols, splits);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, out, P);
  return (int)cudaGetLastError();
}

// The wide forms the wrapper picks (packed_matmul.raw_cols_per_thread).
int dispatch_wide(int bm, const int32_t* x, const int8_t* w, int32_t* out, const Params& P,
                  int splits, cudaStream_t stream) {
  const int nc = P.n_columns;
  if (P.cols_per_thread != kWideCols || P.N % kWideCols) return (int)cudaErrorInvalidValue;
  if (bm == 4 && nc == 1)
    return P.uses_mr ? launch_wide<4, 1, true>(x, w, out, P, splits, stream)
                     : launch_wide<4, 1, false>(x, w, out, P, splits, stream);
  if (bm == 4 && nc == 2 && !P.uses_mr) return launch_wide<4, 2, false>(x, w, out, P, splits, stream);
  if (bm == 8 && nc == 1 && !P.uses_mr) return launch_wide<8, 1, false>(x, w, out, P, splits, stream);
  return (int)cudaErrorInvalidValue;
}

// Columns per pass: the largest of 4, 2, 1 dividing n_columns whose
// NCP x BM accumulators stay within 32 registers' worth per array; four
// output columns a thread (P.cols_per_thread, prepacked) at BM = 4.
template <int BM, bool FUSED, bool RAW>
int dispatch_ncp(const void* x, const float* x_scale, const int32_t* words,
                 const int32_t* wsc, const int8_t* w_raw, int32_t* out, const Params& P,
                 int splits, cudaStream_t stream) {
  if constexpr (BM == 4 && !RAW) {
    if (P.cols_per_thread == 4) {
      if (P.n_columns % 2 == 0)
        return launch<BM, 2, 4, FUSED, RAW>(x, x_scale, words, wsc, w_raw, out, P, splits,
                                            stream);
      return launch<BM, 1, 4, FUSED, RAW>(x, x_scale, words, wsc, w_raw, out, P, splits, stream);
    }
  }
  if (P.cols_per_thread != 1) return (int)cudaErrorInvalidValue;
  if (BM <= 8 && P.n_columns % 4 == 0)
    return launch<BM, (BM <= 8 ? 4 : 2), 1, FUSED, RAW>(x, x_scale, words, wsc, w_raw, out, P,
                                                         splits, stream);
  if (P.n_columns % 2 == 0)
    return launch<BM, 2, 1, FUSED, RAW>(x, x_scale, words, wsc, w_raw, out, P, splits, stream);
  return launch<BM, 1, 1, FUSED, RAW>(x, x_scale, words, wsc, w_raw, out, P, splits, stream);
}

template <bool FUSED, bool RAW>
int dispatch_bm(int bm, const void* x, const float* x_scale, const int32_t* words,
                const int32_t* wsc, const int8_t* w_raw, int32_t* out, const Params& P,
                int splits, cudaStream_t stream) {
  if (bm == 4) return dispatch_ncp<4, FUSED, RAW>(x, x_scale, words, wsc, w_raw, out, P, splits, stream);
  if (bm == 8) return dispatch_ncp<8, FUSED, RAW>(x, x_scale, words, wsc, w_raw, out, P, splits, stream);
  if (bm == 16) return dispatch_ncp<16, FUSED, RAW>(x, x_scale, words, wsc, w_raw, out, P, splits, stream);
  return (int)cudaErrorInvalidValue;
}


// ---- per-call entry at M > 16: 2-D register tiles ------------------------------

namespace tiled {

constexpr int kBM = 64, kBN = 128;   // block tile
constexpr int kTM = 8, kTN = 4;      // thread tile: rows tr*8.., columns tc*4..
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256: a warp per 8 rows
constexpr int kStages = 3;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// Shared-memory plan of one launch, in 32-bit words.
struct Layout {
  int kt;        // k per stage: 2 * tile_chunks * n_pairs
  int sp;        // pairs per stage
  int xs;        // activation row stride in the ring (kt + 4: fewer bank conflicts)
  int ring_x, ring_w, stage;  // ring words per stage: x, w, together
  int ww, we, aw, xo;         // offsets of the per-stage compute buffers
  int total;

  __host__ __device__ Layout(int pairs, int n_columns, bool mr) {
    sp = pairs;
    kt = 2 * sp;
    xs = kt + 4;
    ring_x = kBM * xs;
    ring_w = kt * kBN / 4;
    stage = ring_x + ring_w;
    ww = kStages * stage;                 // [sp][kBN] weight pair words
    we = ww + sp * kBN;                   // [sp][kBN] even weights (mr)
    aw = we + (mr ? sp * kBN : 0);        // [n_columns][sp][kBM] pair words
    xo = aw + n_columns * sp * kBM;       // [n_columns][sp][kBM] odd slices (mr)
    total = xo + (mr ? n_columns * sp * kBM : 0);
  }
};

// Extraction without an mr correction, for p <= 15 (the int32 budget of
// every legal spec): sext_p(((v >> (p-1)) + 1) >> 1) (round half up) or
// sext_p(v >> p) (floor) equals (int32)((v + r) << (32-2p)) >> (32-p), with
// r = 2**(p-1) or 0: the left shift drops the bits above the field, the
// arithmetic shift sign-extends it.  The left shift distributes over the
// wrapping sum, so the kernel applies it once to each weight pair word as
// it packs the stage and starts each chunk's partial sum at r << (32-2p):
// the products then arrive aligned, and extraction is one arithmetic shift.

// NP, PB, NC, TCH: n_pairs, p, n_columns and chunks per stage at compile
// time (0 = read from P); MR: an mr plan.
template <int NP, int PB, int NC, int TCH, bool MR>
__global__ void __launch_bounds__(kThreads)
packed_matmul_tiled_kernel(const int32_t* __restrict__ x, const int8_t* __restrict__ w,
                           int32_t* __restrict__ out, Params P) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_pairs = NP > 0 ? NP : P.n_pairs;
  const int p = PB > 0 ? PB : P.p;
  const int n_columns = NC > 0 ? NC : P.n_columns;
  const int tile_chunks = TCH > 0 ? TCH : P.tile_chunks;
  const Layout L(tile_chunks * n_pairs, n_columns, MR);
  const int chunk = 2 * n_pairs;
  const int tid = threadIdx.x;
  const int tr = tid >> 5, tc = tid & 31;  // rows tr*8 .. +7, columns tc*4 .. +3
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int c_begin = blockIdx.z * P.chunks_per_split;
  const int c_end = min(c_begin + P.chunks_per_split, P.n_chunks);
  const int k_begin = c_begin * chunk;
  const int k_lim = min(c_end * chunk, P.K);  // activations past it read as 0
  const int n_tiles = (c_end - c_begin + tile_chunks - 1) / tile_chunks;

  auto load_stage = [&](int i) {
    uint32_t* sx = smem + (i % kStages) * L.stage;
    uint8_t* sw = reinterpret_cast<uint8_t*>(sx + L.ring_x);
    const int k0 = k_begin + i * L.kt;
    const int xq = L.kt / 4;  // 16-byte chunks per activation row
    for (int c = tid; c < kBM * xq; c += kThreads) {
      const int r = c / xq, q = c % xq;
      const int k = k0 + 4 * q;
      const bool ok = m0 + r < P.M && k < k_lim;
      cp_async16(sx + r * L.xs + 4 * q, x + (ok ? (size_t)(m0 + r) * P.K + k : 0),
                 ok ? 16 : 0);
    }
    for (int c = tid; c < L.kt * (kBN / 16); c += kThreads) {
      const int r = c / (kBN / 16), q = c % (kBN / 16);
      const int k = k0 + r, n = n0 + 16 * q;
      const bool ok = k < P.kw && n < P.N;
      cp_async16(sw + r * kBN + 16 * q, w + (ok ? (size_t)k * P.N + n : 0), ok ? 16 : 0);
    }
  };

  const uint32_t cmask = n_columns == 1 ? 0xFFFFFFFFu : (1u << P.col_bits_a) - 1u;
  const uint32_t mrmask = (1u << P.mr_bits) - 1u;
  // non-mr: weight words pre-shifted by 32 - 2p, partial sums start at the
  // shifted rounding offset (see above)
  const int align = MR ? 0 : 32 - 2 * p;
  const uint32_t part0 = !MR && P.rounds_half_up ? 1u << (31 - p) : 0u;

  uint32_t acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[m][n] = 0u;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_stage(i);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = 0; i < n_tiles; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // stage i landed; the previous stage's words are consumed
    if (i + kStages - 1 < n_tiles) load_stage(i + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const uint32_t* sx = smem + (i % kStages) * L.stage;
    const uint8_t* sw = reinterpret_cast<const uint8_t*>(sx + L.ring_x);
    // weight pair words w[2q+1] + (w[2q] << p), four columns per item
    for (int it = tid; it < L.sp * (kBN / 4); it += kThreads) {
      const int q = it / (kBN / 4), c4 = it % (kBN / 4);
      const uint32_t e = *reinterpret_cast<const uint32_t*>(sw + (2 * q) * kBN + 4 * c4);
      const uint32_t o = *reinterpret_cast<const uint32_t*>(sw + (2 * q + 1) * kBN + 4 * c4);
      uint32_t pw[4], pe[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t w0 = (uint32_t)(int32_t)(int8_t)(e >> (8 * b));
        const uint32_t w1 = (uint32_t)(int32_t)(int8_t)(o >> (8 * b));
        pw[b] = (w1 + (w0 << p)) << align;
        pe[b] = w0 & mrmask;
      }
      reinterpret_cast<uint4*>(smem + L.ww)[it] = make_uint4(pw[0], pw[1], pw[2], pw[3]);
      if (MR) reinterpret_cast<uint4*>(smem + L.we)[it] = make_uint4(pe[0], pe[1], pe[2], pe[3]);
    }
    // activation pair words x[2q] + (x[2q+1] << p) per column slice, rows fastest
    for (int it = tid; it < L.sp * kBM; it += kThreads) {
      const int m = it % kBM, q = it / kBM;
      const uint2 v = *reinterpret_cast<const uint2*>(sx + m * L.xs + 2 * q);
      for (int j = 0; j < n_columns; ++j) {
        const uint32_t s0 = (v.x >> (j * P.col_bits_a)) & cmask;
        const uint32_t s1 = (v.y >> (j * P.col_bits_a)) & cmask;
        smem[L.aw + (j * L.sp + q) * kBM + m] = s0 + (s1 << p);
        if (MR) smem[L.xo + (j * L.sp + q) * kBM + m] = s1 & mrmask;
      }
    }
    __syncthreads();
    const uint4* ww4 = reinterpret_cast<const uint4*>(smem + L.ww) + tc;
    const uint4* we4 = reinterpret_cast<const uint4*>(smem + L.we) + tc;
    for (int j = 0; j < n_columns; ++j) {
      const uint4* aw4 = reinterpret_cast<const uint4*>(smem + L.aw + j * L.sp * kBM) + 2 * tr;
      const uint4* xo4 = reinterpret_cast<const uint4*>(smem + L.xo + j * L.sp * kBM) + 2 * tr;
      const int shift = j * P.col_bits_a;
#pragma unroll
      for (int cc = 0; cc < tile_chunks; ++cc) {
        uint32_t part[kTM][kTN], cont[kTM][kTN];
#pragma unroll
        for (int m = 0; m < kTM; ++m)
#pragma unroll
          for (int n = 0; n < kTN; ++n) {
            part[m][n] = part0;
            cont[m][n] = 0u;
          }
#pragma unroll 4
        for (int pp = 0; pp < n_pairs; ++pp) {
          const int q = cc * n_pairs + pp;
          const uint4 wv = ww4[q * (kBN / 4)];
          const uint4 a0 = aw4[q * (kBM / 4)], a1 = aw4[q * (kBM / 4) + 1];
          const uint32_t wr[kTN] = {wv.x, wv.y, wv.z, wv.w};
          const uint32_t ar[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int m = 0; m < kTM; ++m)
#pragma unroll
            for (int n = 0; n < kTN; ++n) part[m][n] += ar[m] * wr[n];
          if (MR) {
            const uint4 ev = we4[q * (kBN / 4)];
            const uint4 o0 = xo4[q * (kBM / 4)], o1 = xo4[q * (kBM / 4) + 1];
            const uint32_t er[kTN] = {ev.x, ev.y, ev.z, ev.w};
            const uint32_t orr[kTM] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
            for (int m = 0; m < kTM; ++m)
#pragma unroll
              for (int n = 0; n < kTN; ++n) cont[m][n] += orr[m] * er[n];
          }
        }
#pragma unroll
        for (int m = 0; m < kTM; ++m)
#pragma unroll
          for (int n = 0; n < kTN; ++n) {
            const int32_t e = MR ? extract(part[m][n], cont[m][n] & mrmask, P)
                                 : (int32_t)part[m][n] >> (32 - p);
            acc[m][n] += NC == 1 ? (uint32_t)e : (uint32_t)e << shift;
          }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int row = m0 + kTM * tr + m;
    if (row >= P.M) continue;
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      const int col = n0 + kTN * tc + n;
      if (col >= P.N) continue;
      int32_t* o = out + (size_t)row * P.N + col;
      if (split) atomicAdd(o, (int32_t)acc[m][n]);
      else *o = (int32_t)acc[m][n];
    }
  }
}

template <int NP, int PB, int NC, int TCH, bool MR>
int launch_tiled(const int32_t* x, const int8_t* w, int32_t* out, const Params& P,
                 int splits, cudaStream_t stream) {
  auto kernel = packed_matmul_tiled_kernel<NP, PB, NC, TCH, MR>;
  const size_t smem =
      (size_t)Layout(P.tile_chunks * P.n_pairs, P.n_columns, P.uses_mr).total *
      sizeof(uint32_t);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((P.N + kBN - 1) / kBN, (P.M + kBM - 1) / kBM, splits);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, out, P);
  return (int)cudaGetLastError();
}

// ---- prepacked entry at M > 16: the same 2-D register tiles ----------------------

// Shared-memory plan of the prepacked tiled kernel, in 32-bit words: the
// ring carries the activation tile (f32 or int32), the stage's weight pair
// words as they are stored, and wsc's even lane where it is read; the
// compute buffers hold the even weights mod 2**mr_bits, and the activation
// pair words and odd slices per column.
struct PrepackedLayout {
  int kt, sp, xs;
  int ring_x, ring_w, ring_e, stage;
  int we, aw, xo;
  int total;

  __host__ __device__ PrepackedLayout(int pairs, int n_columns, bool mr, bool wsc) {
    sp = pairs;
    kt = 2 * sp;
    xs = kt + 4;
    ring_x = kBM * xs;
    ring_w = sp * kBN;                    // [sp][kBN] words
    ring_e = wsc ? sp * kBN : 0;          // [sp][kBN] wsc even lane
    stage = ring_x + ring_w + ring_e;
    we = kStages * stage;                 // [sp][kBN] even weights (mr)
    aw = we + (mr ? sp * kBN : 0);        // [n_columns][sp][kBM] pair words
    xo = aw + n_columns * sp * kBM;       // [n_columns][sp][kBM] odd slices (mr)
    total = xo + (mr ? n_columns * sp * kBM : 0);
  }
};

// FUSED: x is f32, quantized per stage as round(x / scale) + zp (half to
// even), clipped to [0, 2 zp - 1]; else x holds int32 unsigned integers.
// MR: an mr plan; WSC: its even lane read from wsc (bits_w > p), else
// derived from the words.  NP, PB, NC, TCH as in packed_matmul_tiled_kernel.
template <bool FUSED, bool MR, bool WSC, int NP, int PB, int NC, int TCH>
__global__ void __launch_bounds__(kThreads)
packed_matmul_prepacked_tiled_kernel(const void* __restrict__ x,
                                     const float* __restrict__ x_scale,
                                     const int32_t* __restrict__ words,
                                     const int32_t* __restrict__ wsc,
                                     int32_t* __restrict__ out, Params P) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_pairs = NP > 0 ? NP : P.n_pairs;
  const int p = PB > 0 ? PB : P.p;
  const int n_columns = NC > 0 ? NC : P.n_columns;
  const int tile_chunks = TCH > 0 ? TCH : P.tile_chunks;
  const PrepackedLayout L(tile_chunks * n_pairs, n_columns, MR, WSC);
  const int chunk = 2 * n_pairs;
  const int tid = threadIdx.x;
  const int tr = tid >> 5, tc = tid & 31;  // rows tr*8 .. +7, columns tc*4 .. +3
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int c_begin = blockIdx.z * P.chunks_per_split;
  const int c_end = min(c_begin + P.chunks_per_split, P.n_chunks);
  const int k_begin = c_begin * chunk;
  const int k_lim = min(c_end * chunk, P.K);  // activations past it read as 0
  const int row_lim = c_end * n_pairs;        // word rows (chunk, pair) past it read as 0
  const int n_tiles = (c_end - c_begin + tile_chunks - 1) / tile_chunks;

  auto load_stage = [&](int i) {
    uint32_t* sx = smem + (i % kStages) * L.stage;
    uint32_t* sw = sx + L.ring_x;
    const int k0 = k_begin + i * L.kt;
    const int xq = L.kt / 4;  // 16-byte chunks per activation row
    for (int c = tid; c < kBM * xq; c += kThreads) {
      const int r = c / xq, q = c % xq;
      const int k = k0 + 4 * q;
      const bool ok = m0 + r < P.M && k < k_lim;
      cp_async16(sx + r * L.xs + 4 * q,
                 static_cast<const int32_t*>(x) + (ok ? (size_t)(m0 + r) * P.K + k : 0),
                 ok ? 16 : 0);
    }
    const int r0 = (c_begin + i * tile_chunks) * n_pairs;  // the stage's first word row
    for (int c = tid; c < L.sp * (kBN / 4); c += kThreads) {
      const int r = c / (kBN / 4), q = c % (kBN / 4);
      const int n = n0 + 4 * q;
      const bool ok = r0 + r < row_lim && n < P.N;
      cp_async16(sw + r * kBN + 4 * q, words + (ok ? (size_t)(r0 + r) * P.N + n : 0),
                 ok ? 16 : 0);
      if (WSC)  // even lane: wsc[chunk][pair][0][n]
        cp_async16(sw + L.ring_w + r * kBN + 4 * q,
                   wsc + (ok ? (size_t)(r0 + r) * 2 * P.N + n : 0), ok ? 16 : 0);
    }
  };

  const uint32_t cmask = n_columns == 1 ? 0xFFFFFFFFu : (1u << P.col_bits_a) - 1u;
  const uint32_t mrmask = (1u << P.mr_bits) - 1u;
  // non-mr: the words are shifted by 32 - 2p as they are read, and partial
  // sums start at the shifted rounding offset (see packed_matmul_tiled_kernel)
  const int align = MR ? 0 : 32 - 2 * p;
  const uint32_t part0 = !MR && P.rounds_half_up ? 1u << (31 - p) : 0u;
  const float zp = (float)P.zp, qmax = (float)(2 * P.zp - 1);

  uint32_t acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[m][n] = 0u;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_stage(i);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = 0; i < n_tiles; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // stage i landed; the previous stage's buffers are consumed
    if (i + kStages - 1 < n_tiles) load_stage(i + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const uint32_t* sx = smem + (i % kStages) * L.stage;
    const uint32_t* sw = sx + L.ring_x;
    if (MR) {  // even weights mod 2**mr_bits, read or derived once per block
      for (int it = tid; it < L.sp * (kBN / 4); it += kThreads) {
        const uint4 v = reinterpret_cast<const uint4*>(WSC ? sw + L.ring_w : sw)[it];
        reinterpret_cast<uint4*>(smem + L.we)[it] =
            WSC ? make_uint4(v.x & mrmask, v.y & mrmask, v.z & mrmask, v.w & mrmask)
                : make_uint4(even_lane(v.x, p, mrmask), even_lane(v.y, p, mrmask),
                             even_lane(v.z, p, mrmask), even_lane(v.w, p, mrmask));
      }
    }
    // activation pair words x[2q] + (x[2q+1] << p) per column slice, rows
    // fastest; the fused form quantizes the pair first
    for (int it = tid; it < L.sp * kBM; it += kThreads) {
      const int m = it % kBM, q = it / kBM;
      const uint2 v = *reinterpret_cast<const uint2*>(sx + m * L.xs + 2 * q);
      uint32_t v0 = v.x, v1 = v.y;
      if (FUSED) {
        const float s = m0 + m < P.M ? x_scale[m0 + m] : 1.0f;
        const float q0 = fminf(fmaxf(rintf(__uint_as_float(v.x) / s) + zp, 0.0f), qmax);
        const float q1 = fminf(fmaxf(rintf(__uint_as_float(v.y) / s) + zp, 0.0f), qmax);
        v0 = (uint32_t)(int32_t)q0;
        v1 = (uint32_t)(int32_t)q1;
      }
      for (int j = 0; j < n_columns; ++j) {
        const uint32_t s0 = (v0 >> (j * P.col_bits_a)) & cmask;
        const uint32_t s1 = (v1 >> (j * P.col_bits_a)) & cmask;
        smem[L.aw + (j * L.sp + q) * kBM + m] = s0 + (s1 << p);
        if (MR) smem[L.xo + (j * L.sp + q) * kBM + m] = s1 & mrmask;
      }
    }
    __syncthreads();
    const uint4* ww4 = reinterpret_cast<const uint4*>(sw) + tc;
    const uint4* we4 = reinterpret_cast<const uint4*>(smem + L.we) + tc;
    for (int j = 0; j < n_columns; ++j) {
      const uint4* aw4 = reinterpret_cast<const uint4*>(smem + L.aw + j * L.sp * kBM) + 2 * tr;
      const uint4* xo4 = reinterpret_cast<const uint4*>(smem + L.xo + j * L.sp * kBM) + 2 * tr;
      const int shift = j * P.col_bits_a;
#pragma unroll
      for (int cc = 0; cc < tile_chunks; ++cc) {
        uint32_t part[kTM][kTN], cont[kTM][kTN];
#pragma unroll
        for (int m = 0; m < kTM; ++m)
#pragma unroll
          for (int n = 0; n < kTN; ++n) {
            part[m][n] = part0;
            cont[m][n] = 0u;
          }
#pragma unroll 4
        for (int pp = 0; pp < n_pairs; ++pp) {
          const int q = cc * n_pairs + pp;
          const uint4 wv = ww4[q * (kBN / 4)];
          const uint4 a0 = aw4[q * (kBM / 4)], a1 = aw4[q * (kBM / 4) + 1];
          const uint32_t wr[kTN] = {wv.x << align, wv.y << align, wv.z << align, wv.w << align};
          const uint32_t ar[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int m = 0; m < kTM; ++m)
#pragma unroll
            for (int n = 0; n < kTN; ++n) part[m][n] += ar[m] * wr[n];
          if (MR) {
            const uint4 ev = we4[q * (kBN / 4)];
            const uint4 o0 = xo4[q * (kBM / 4)], o1 = xo4[q * (kBM / 4) + 1];
            const uint32_t er[kTN] = {ev.x, ev.y, ev.z, ev.w};
            const uint32_t orr[kTM] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
            for (int m = 0; m < kTM; ++m)
#pragma unroll
              for (int n = 0; n < kTN; ++n) cont[m][n] += orr[m] * er[n];
          }
        }
#pragma unroll
        for (int m = 0; m < kTM; ++m)
#pragma unroll
          for (int n = 0; n < kTN; ++n) {
            const int32_t e = MR ? extract(part[m][n], cont[m][n] & mrmask, P)
                                 : (int32_t)part[m][n] >> (32 - p);
            acc[m][n] += NC == 1 ? (uint32_t)e : (uint32_t)e << shift;
          }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int row = m0 + kTM * tr + m;
    if (row >= P.M) continue;
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      const int col = n0 + kTN * tc + n;
      if (col >= P.N) continue;
      int32_t* o = out + (size_t)row * P.N + col;
      if (split) atomicAdd(o, (int32_t)acc[m][n]);
      else *o = (int32_t)acc[m][n];
    }
  }
}

template <bool FUSED, bool MR, bool WSC, int NP, int PB, int NC, int TCH>
int launch_prepacked_tiled(const void* x, const float* x_scale, const int32_t* words,
                           const int32_t* wsc, int32_t* out, const Params& P, int splits,
                           cudaStream_t stream) {
  auto kernel = packed_matmul_prepacked_tiled_kernel<FUSED, MR, WSC, NP, PB, NC, TCH>;
  const size_t smem =
      (size_t)PrepackedLayout(P.tile_chunks * P.n_pairs, P.n_columns, MR, WSC).total *
      sizeof(uint32_t);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((P.N + kBN - 1) / kBN, (P.M + kBM - 1) / kBM, splits);
  kernel<<<grid, kThreads, smem, stream>>>(x, x_scale, words, wsc, out, P);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int dispatch_prepacked_tiled(const void* x, const float* x_scale, const int32_t* words,
                             const int32_t* wsc, int32_t* out, const Params& P, int splits,
                             cudaStream_t stream) {
  if (P.uses_mr && P.reads_wsc)
    return launch_prepacked_tiled<FUSED, true, true, 0, 0, 0, 0>(x, x_scale, words, wsc, out, P,
                                                                  splits, stream);
  if (P.uses_mr) {
    if (P.n_pairs == 32 && P.p == 10 && P.n_columns == 2 && P.tile_chunks == 1)
      // a4w4-p10-n32-mr+full-c2, dsp_tuned's plan
      return launch_prepacked_tiled<FUSED, true, false, 32, 10, 2, 1>(x, x_scale, words, wsc,
                                                                       out, P, splits, stream);
    return launch_prepacked_tiled<FUSED, true, false, 0, 0, 0, 0>(x, x_scale, words, wsc, out, P,
                                                                   splits, stream);
  }
  return launch_prepacked_tiled<FUSED, false, false, 0, 0, 0, 0>(x, x_scale, words, wsc, out, P,
                                                                  splits, stream);
}

}  // namespace tiled

}  // namespace

// Prepacked entry.  x_scale == nullptr: x holds int32 unsigned activations;
// otherwise x is f32 and is quantized in the prologue with zp = P.zp.
// wsc may be nullptr for plans without an mr correction.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int packed_matmul_prepacked_launch(const void* x, const void* x_scale,
                                              const void* words, const void* wsc,
                                              void* out, const PackedParams* P, int bm,
                                              int splits, void* stream) {
  const auto* s = static_cast<const float*>(x_scale);
  const auto* wd = static_cast<const int32_t*>(words);
  const auto* wc = static_cast<const int32_t*>(wsc);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (s != nullptr) return dispatch_bm<true, false>(bm, x, s, wd, wc, nullptr, o, *P, splits, st);
  return dispatch_bm<false, false>(bm, x, nullptr, wd, wc, nullptr, o, *P, splits, st);
}

// Prepacked entry at M > 16 (2-D register tiles): x (M, K) f32 (x_scale !=
// nullptr: quantized per stage with zp = P.zp) or int32, K % 4 == 0; words
// (n_chunks, n_pairs, N) with N % 4 == 0; wsc read only where P.reads_wsc.
// P.tile_chunks chunks per pipeline stage, P.chunks_per_split a multiple of
// it.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int packed_matmul_prepacked_tiled_launch(const void* x, const void* x_scale,
                                                    const void* words, const void* wsc,
                                                    void* out, const PackedParams* P,
                                                    int splits, void* stream) {
  if (P->K % 4 || P->N % 4 || P->p > 15 || splits < 1 || (P->reads_wsc && wsc == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const float*>(x_scale);
  const auto* wd = static_cast<const int32_t*>(words);
  const auto* wc = static_cast<const int32_t*>(wsc);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (s != nullptr) return tiled::dispatch_prepacked_tiled<true>(x, s, wd, wc, o, *P, splits, st);
  return tiled::dispatch_prepacked_tiled<false>(x, nullptr, wd, wc, o, *P, splits, st);
}

// Per-call entry: x int32 unsigned activations (M, K), w (K, N) int8 signed
// integers packed into words as they are read; P.cols_per_thread > 1 takes
// the wide kernel (dispatch_wide), 1 the one-column kernel.
extern "C" int packed_matmul_launch(const void* x, const void* w, void* out,
                                    const PackedParams* P, int bm, int splits,
                                    void* stream) {
  if (P->cols_per_thread > 1)
    return dispatch_wide(bm, static_cast<const int32_t*>(x), static_cast<const int8_t*>(w),
                         static_cast<int32_t*>(out), *P, splits,
                         static_cast<cudaStream_t>(stream));
  return dispatch_bm<false, true>(bm, x, nullptr, nullptr, nullptr,
                                  static_cast<const int8_t*>(w), static_cast<int32_t*>(out),
                                  *P, splits, static_cast<cudaStream_t>(stream));
}

// Per-call entry at M > 16 (2-D register tiles): x int32 (M, K) with
// K % 4 == 0, w int8 (kw, N) with N % 16 == 0; P.tile_chunks chunks per
// pipeline stage, P.chunks_per_split a multiple of it.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int packed_matmul_tiled_launch(const void* x, const void* w, void* out,
                                          const PackedParams* P, int splits,
                                          void* stream) {
  if (P->K % 4 || P->N % 16 || P->p > 15 || splits < 1) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (P->uses_mr) return tiled::launch_tiled<0, 0, 0, 0, true>(xp, wp, o, *P, splits, st);
  if (P->n_pairs == 4 && P->p == 11 && P->n_columns == 1 && P->tile_chunks == 4)
    // INT4_EXACT / INT4_NAIVE, dsp_packed's default plan
    return tiled::launch_tiled<4, 11, 1, 4, false>(xp, wp, o, *P, splits, st);
  return tiled::launch_tiled<0, 0, 0, 0, false>(xp, wp, o, *P, splits, st);
}
