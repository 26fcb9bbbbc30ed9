// Causal flash-attention forward for Hopper (sm_90a) on the bf16 tensor
// cores: q, k, v (B*H, S, hd) bf16 -> out (B*H, S, hd) bf16, hd a multiple
// of 8 up to 128.
// The f32 route stays on the CUDA cores (flash_attention.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (Pallas body _kernel) for bf16 inputs, and computes what it computes: q, k
// and v taken as f32, scores scaled by hd**-0.5, keys past the query masked
// with -1e30 (not -inf), the softmax carried online over key tiles as
// (running max m, denominator l, accumulator), key tiles past the diagonal
// skipped, and the output acc / max(l, 1e-30) rounded to nearest even in
// bf16.
//
// How each step runs on the card, and where its numbers differ from the f32
// kernel's:
// - S = Q K^T: wgmma m64n64k16 on bf16 operands from shared memory into f32
//   accumulators.  A product of two bf16 values is exact in f32, so S
//   differs from an f32 product only in the order of summation.  The scale
//   is applied after the product (q * scale is not a bf16 value), folded
//   into the exponent below: exact for hd 64 (2**-3); for hd 128, (q *
//   scale) . k and (q . k) * scale differ by f32 roundings of about one ulp
//   of the score.
// - The softmax stays in f32 registers: row max and sum, and the rescale of
//   the accumulator by alpha = exp(scale * (m_old - m_new)).  Exponentials
//   are ex2.approx of log2(e)-scaled arguments, 2**(s * c - m * c) with c =
//   scale * log2(e), one FFMA and one MUFU instruction a score; their
//   relative error (a few f32 ulps) is far below the 2**-16 that P keeps.
//   Every row sees key 0 in the first tile, so no row is ever fully masked;
//   the exponential of a masked score is exactly 0, and so is the first
//   tile's alpha.  A warp skips the rescale when its alphas are all 1.
// - P V: P is split into two bf16 terms, P_hi = bf16(P) and P_lo =
//   bf16(P - P_hi) (P - P_hi is exact in f32), and both go through wgmma
//   m64n{hd}k16 with A from registers into the same f32 accumulator.  One
//   bf16 rounding of P (8 significant bits) puts about a tenth of the
//   outputs outside the f32 kernel's bf16 tolerance (atol 1e-5, rtol 2**-7);
//   the pair carries 16 bits, and none is outside.  B is the V tile in
//   shared memory, MN-major (the transposed operand); V is bf16 at its input
//   and so exact.  The score accumulator's layout is the A operand's register
//   layout for P V, so P never leaves the registers.
// - Loads: TMA (cp.async.bulk.tensor, 128-byte swizzle) copies the Q tile
//   once per block and K/V tiles into a ring of kStages stages, completion
//   counted on mbarriers; one producer warp issues them, and each consumer
//   warp releases a stage once its P V has read it.  Out-of-bounds rows of a
//   box are zero-filled: keys >= S are then past every stored query and so
//   masked, and rows >= S are not stored, which handles ragged S.  The same
//   zero fill handles a head narrower than the instantiation (HD = 64 for
//   hd <= 64, else 128): the tensor maps span the true hd, so the box's
//   columns past it read as zero, add nothing to Q K^T and give output
//   columns that are not stored.  No copy pads the head.
//
// What bounds it on this card: the products, 4 * S*S/2 * hd operations per
// head against 8 bytes per element of q, k, v and out, are far above the
// bytes at the 989 TFLOP/s bf16 tensor-core rate; with P V done twice the
// kernel issues 1.5x the function's operations.  Each score also costs the
// CUDA cores about ten instructions (mask, max, exponential, sum, split),
// which measured on the H100 weigh as much as the products: hd 64 takes
// about 0.8x the time of hd 128 at half the products.
//
// What the design does about it: one block of two consumer warpgroups (64
// query rows each, 128 per block) and one producer warp per (head, query
// tile), tiles visited longest first.  A warpgroup issues tile kt's S = Q
// K^T and tile kt-1's O += P V together, runs tile kt's softmax while P V
// runs, and rescales O once P V is done; the two warpgroups interleave on
// the tensor cores as they may.  Budget at hd 128: Q 128 x 128 bf16 is 32
// KiB, K plus V at 64 keys is 32 KiB a stage, 4 stages (a warpgroup holds
// two: K of tile kt, V of kt-1): 160 KiB of shared memory, one block per
// SM; registers per consumer thread: 64 f32 of output, 32 of scores and 32
// of split P, 168 in all at hd 128 and 155 at hd 64, no spills (ptxas -v).
// Not yet used: ping-pong scheduling of the two warpgroups
// (FlashAttention-3), 128-key tiles (the split doubles P's registers), a
// persistent grid.
//
// Contract checked by the Python wrapper: q, k, v, out contiguous, 16-byte
// aligned, bf16, on the current device; hd a multiple of 8 up to 128.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;             // query rows per block: two consumer warpgroups
constexpr int kBK = 64;              // keys per tile
constexpr int kStages = 4;           // K/V ring depth: a warpgroup holds two
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + one producer warp
constexpr int kRowBytes = 128;       // one 128-byte swizzle row: 64 bf16
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kWaitLimit = 1ll << 34;  // clock cycles (~10 s) of a wait before a trap

template <int HD>
struct Smem {  // byte offsets from a 1024-aligned base (the swizzle atom)
  static constexpr int kChunks = HD / 64;              // 64-column chunks of a row
  static constexpr int kQChunk = kBQ * kRowBytes;      // [kBQ rows][64]
  static constexpr int kTileChunk = kBK * kRowBytes;   // [kBK rows][64]
  static constexpr int kTile = kChunks * kTileChunk;   // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kChunks * kQChunk;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;   // q, full[kStages], empty[kStages]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.  A wait
// that never ends (a fault in the pipeline) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kWaitLimit) __trap();
  }
}

// One box of a 3-D tensor map (innermost coordinate first) into shared
// memory, its bytes counted on ``bar``.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma ----

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1 =
// 128B swizzle.  K-major (Q, K): 8-row groups 1024 bytes apart (stride);
// the leading offset is unused.  MN-major (V): 8-row (key) groups 1024 bytes
// apart (stride), 64-column chunks ``lbo`` bytes apart (leading).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)((lbo & 0x3ffff) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are pending
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers an asynchronous wgmma reads or writes at this point of the
// program, so that the compiler moves no access to them across the fence,
// commit and wait around it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// (x0, x1) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi); x0 in the low half
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2**x in one MUFU instruction (max relative error 2**-22; 0 for x < -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the max and the sum over the 4 lanes that share a row of a wgmma fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator fragment of a 64 x N wgmma, per thread: d[4j + e] holds row
// 16 * (warp % 4) + lane / 4 + 8 * (e / 2) and column 8j + 2 * (lane % 4) +
// e % 2.  The A fragment of an m64k16 wgmma from registers: a[r] holds the
// rows of e = 2 * (r % 2) and the columns 8 * (r / 2) + 2 * (lane % 4) + {0,
// 1} of its 16: so the scores of keys 16kk .. 16kk+15 are the A operand
// a[r] = d[4 * (2kk + r / 2) + 2 * (r % 2)], d[... + 1], unchanged.
template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 64) wgmma_rs_n64(o, a, b);
  else wgmma_rs_n128(o, a, b);
}

// Issue S = Q K^T for one warpgroup's 64 rows: hd / 16 steps of 16
// columns, four per 128-byte swizzle row of Q and of the K tile.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    const uint32_t qa = q_rows + (j / 4) * Smem<HD>::kQChunk + (j % 4) * 32;
    const uint32_t ka = k_tile + (j / 4) * Smem<HD>::kTileChunk + (j % 4) * 32;
    wgmma_ss_n64(s, sw128_desc(qa, 16), sw128_desc(ka, 16));
  }
}

// Issue O += P_hi V + P_lo V: four steps of 16 keys for each term.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&p_hi)[4][4],
                                         const uint32_t (&p_lo)[4][4], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<HD>(o, p_hi[kk], sw128_desc(v_tile + kk * 16 * kRowBytes, Smem<HD>::kTileChunk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<HD>(o, p_lo[kk], sw128_desc(v_tile + kk * 16 * kRowBytes, Smem<HD>::kTileChunk));
}

// Per lane, the two rows (lo, hi) of a fragment: running max m, this lane's
// part of the denominator l, and the rescale factor of the last tile.
struct Rows {
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f, a_lo = 0.f, a_hi = 0.f;
};

// Mask the scores of key tile kt (keys past the row -> -1e30 on the tiles
// that reach the diagonal), fold them into the running max and denominator,
// and turn them into exp(scale * (s - m)) in place, as 2**(s * c - m * c)
// with c = scale * log2(e): one FFMA and one ex2 a score.  The running max
// is kept unscaled (scale > 0 keeps the argmax); masked scores and the
// first tile's alpha come out exactly 0.
__device__ __forceinline__ void online_softmax(float (&s)[32], Rows& r, int kt, bool diag,
                                               int r_lo, int r_hi, int col, float c) {
  float mx_lo = r.m_lo, mx_hi = r.m_hi;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int key = kt * kBK + 8 * (i / 4) + col + (i & 1);
    if (diag && key > ((i & 2) ? r_hi : r_lo)) s[i] = kNegInf;
    if (i & 2) mx_hi = fmaxf(mx_hi, s[i]);
    else mx_lo = fmaxf(mx_lo, s[i]);
  }
  mx_lo = quad_max(mx_lo);
  mx_hi = quad_max(mx_hi);
  const float b_lo = mx_lo * c, b_hi = mx_hi * c;
  r.a_lo = ex2(fmaf(r.m_lo, c, -b_lo));
  r.a_hi = ex2(fmaf(r.m_hi, c, -b_hi));
  r.m_lo = mx_lo;
  r.m_hi = mx_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2(fmaf(s[i], c, (i & 2) ? -b_hi : -b_lo));
    if (i & 2) sum_hi += s[i];
    else sum_lo += s[i];
  }
  r.l_lo = r.l_lo * r.a_lo + sum_lo;
  r.l_hi = r.l_hi * r.a_hi + sum_hi;
}

// P -> (P_hi, P_lo) as the A operands of the four 16-key steps of P V.
__device__ __forceinline__ void split_p(const float (&s)[32], uint32_t (&p_hi)[4][4],
                                        uint32_t (&p_lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * (2 * kk + r / 2) + 2 * (r % 2);
      split_pair(s[i], s[i + 1], p_hi[kk][r], p_lo[kk][r]);
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ out, int BH, int S, int hd,
                            float scale) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_bar + 1;           // K/V tile of a stage has landed
  uint64_t* empty = q_bar + 1 + kStages;  // every consumer warp is done with it

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);  // longest rows first
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: one thread issues every load
    if (lane == 0) {
      const int n_kt = (min(q0 + kBQ, S) - 1) / kBK + 1;  // through the block's last row
      mbar_expect_tx(q_bar, L::kChunks * L::kQChunk);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(smem + L::kQ + c * L::kQChunk, &tm_q, q_bar, 64 * c, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[st], (kt / kStages - 1) & 1);
        mbar_expect_tx(&full[st], 2 * L::kTile);
        for (int c = 0; c < L::kChunks; ++c) {
          const int at = st * L::kTile + c * L::kTileChunk;
          tma_load(smem + L::kK + at, &tm_k, &full[st], 64 * c, kt * kBK, bh);
          tma_load(smem + L::kV + at, &tm_v, &full[st], 64 * c, kt * kBK, bh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows.  Tile kt's S = Q K^T and tile
  // kt-1's O += P V are issued together; the softmax of tile kt runs while
  // P V does, and O is rescaled once P V is done.
  const int wg = warp / 4;
  const int row0 = q0 + 64 * wg;
  const int last = min(row0 + 63, S - 1) / kBK;  // its last key tile
  const int r_lo = row0 + 16 * (warp % 4) + lane / 4;
  const int r_hi = r_lo + 8;
  const int col = 2 * (lane % 4);
  const uint32_t q_rows = base + L::kQ + wg * 64 * kRowBytes;
  const float c = scale * kLog2e;
  auto k_tile = [&](int kt) { return base + L::kK + (kt % kStages) * L::kTile; };
  auto v_tile = [&](int kt) { return base + L::kV + (kt % kStages) * L::kTile; };
  auto diag = [&](int kt) { return kt * kBK + kBK - 1 > row0; };
  auto release = [&](int kt) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[kt % kStages]);
  };

  float o[HD / 2], s[32];
  uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  Rows rows;
  mbar_wait(q_bar, 0);
  mbar_wait(&full[0], 0);
  pin(s);
  wgmma_fence();
  issue_qk<HD>(s, q_rows, k_tile(0));
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
  online_softmax(s, rows, 0, diag(0), r_lo, r_hi, col, c);  // O is 0: no rescale
  split_p(s, p_hi, p_lo);

  for (int kt = 1; kt <= last; ++kt) {
    mbar_wait(&full[kt % kStages], (kt / kStages) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    pin(o);
    pin(p_hi);
    pin(p_lo);
    wgmma_fence();
    issue_qk<HD>(s, q_rows, k_tile(kt));
    wgmma_commit();
    issue_pv<HD>(o, p_hi, p_lo, v_tile(kt - 1));
    wgmma_commit();
    wgmma_wait<1>();  // S is in
    pin(s);
    online_softmax(s, rows, kt, diag(kt), r_lo, r_hi, col, c);
    wgmma_wait<0>();  // P V is done with O, P and tile kt-1
    pin(o);
    pin(p_hi);
    pin(p_lo);
    release(kt - 1);
    // the row max moved for some row of this warp (alpha == 1 leaves O as it is)
    if (!__all_sync(0xffffffffu, rows.a_lo == 1.f && rows.a_hi == 1.f)) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 2) ? rows.a_hi : rows.a_lo;
    }
    split_p(s, p_hi, p_lo);
  }
  pin(o);
  pin(p_hi);
  pin(p_lo);
  wgmma_fence();
  issue_pv<HD>(o, p_hi, p_lo, v_tile(last));
  wgmma_commit();
  wgmma_wait<0>();
  pin(o);

  const float d_lo = fmaxf(quad_sum(rows.l_lo), 1e-30f);
  const float d_hi = fmaxf(quad_sum(rows.l_hi), 1e-30f);
  __nv_bfloat16* head = out + (size_t)bh * S * hd;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + col;  // c + 1 < hd too: hd is a multiple of 8
    if (r_lo < S && c < hd)
      *reinterpret_cast<__nv_bfloat162*>(head + (size_t)r_lo * hd + c) =
          __floats2bfloat162_rn(o[4 * j] / d_lo, o[4 * j + 1] / d_lo);
    if (r_hi < S && c < hd)
      *reinterpret_cast<__nv_bfloat162*>(head + (size_t)r_hi * hd + c) =
          __floats2bfloat162_rn(o[4 * j + 2] / d_hi, o[4 * j + 3] / d_hi);
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no link to libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B*H, S, hd) bf16 as a 3-D tensor map of (64 x rows x 1) boxes, 128-byte
// swizzle; out-of-bounds elements of a box (rows past S, columns past hd)
// read as zero.
CUresult tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int BH, int S, int hd,
                    int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)S * hd * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int S, int hd,
           float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  CUresult res = tensor_map(encode, &tq, q, BH, S, hd, kBQ);
  if (res == CUDA_SUCCESS) res = tensor_map(encode, &tk, k, BH, S, hd, kBK);
  if (res == CUDA_SUCCESS) res = tensor_map(encode, &tv, v, BH, S, hd, kBK);
  if (res != CUDA_SUCCESS) return 1000 + (int)res;
  auto kernel = flash_attention_sm90_kernel<HD>;
  constexpr int smem = Smem<HD>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)BH * ((S + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(tq, tk, tv,
                                                       static_cast<__nv_bfloat16*>(out), BH, S,
                                                       hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 once launched, a cudaError_t, or 1000 + the CUresult of a
// failed cuTensorMapEncodeTiled.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                           void* out, int BH, int S, int hd, float scale,
                                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0 || hd < 8 || hd % 8 || hd > 128) return (int)cudaErrorInvalidValue;
  if (hd <= 64) return launch<64>(q, k, v, out, BH, S, hd, scale, s);
  return launch<128>(q, k, v, out, BH, S, hd, scale, s);
}
