// Causal flash-attention forward for Hopper (sm_90a) on the tensor cores:
// q, k, v (B*H, S, hd) -> out (B*H, S, hd) in the input type, for bf16, f16
// and f32 inputs, hd a multiple of 8 up to 128.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (Pallas body _kernel), and computes what it computes: q, k and v taken as
// f32, scores scaled by hd**-0.5, keys past the query masked with -1e30 (not
// -inf), the softmax carried online over key tiles as (running max m,
// denominator l, accumulator), key tiles past the diagonal skipped, and the
// output acc / max(l, 1e-30) rounded to nearest even in the input type.
//
// Three routes, two kernels that share their helpers and schedule (Design
// below holds each one's tiles):
// - bf16 and f16 inputs (one term per value; flash_attention_sm90_kernel,
//   PR 14's bf16 kernel on the element type).  S = Q K^T runs as wgmma
//   m64n64k16 on the input values from shared memory into f32 accumulators:
//   a product of two bf16 or two f16 values is exact in f32, so S differs
//   from an f32 product only in the order of summation.  The scale is
//   applied after the product (q * scale is not a value of the input type),
//   folded into the exponent below: exact for hd 64 (2**-3); for hd 128,
//   (q * scale) . k and (q . k) * scale differ by f32 roundings of about
//   one ulp of the score.  P V splits P into two terms of the input type,
//   P_hi = E(P) and P_lo = E(P - P_hi) (P - P_hi is exact in f32): one
//   rounding of P (8 significant bits in bf16, 11 in f16) puts a tenth (bf16)
//   or a few hundredths (f16) of the outputs outside the f32 kernel's
//   tolerance at the input type's step (atol 1e-5, rtol 2**-7 in bf16,
//   2**-10 in f16); the pair carries 16 (22) bits, and none is outside.  In
//   f16, P below 2**-14, and P_lo wherever P - P_hi falls below it (every P
//   under about 1/8), are subnormal: the pair still keeps P within 2**-25
//   absolutely, which the output's f16 step (and its 1e-5) does not see.
// - f32 inputs (three terms per value; flash_attention_sm90_f32_kernel).
//   A pre-pass (split3_kernel) writes q * scale (the scale before the
//   product, as the reference), k and v as three bf16 terms each, x = t0 +
//   t1 + t2, exact for every normal f32.
//   The kernel runs S as the six term products t_i(q) t_j(k)^T with
//   i + j <= 2 (the three dropped are below 2**-24 of the product), and P V
//   likewise with P split into three bf16 terms: six bf16 products per f32
//   product, each exact in f32.  The smallest products are issued first,
//   while the accumulator is small: the tensor cores align each step's sum
//   to the accumulator, and the bits they drop are then the small terms'.
//   Emulated on the CPU (flash_attention.emulate_split_f32_flash,
//   python -m repro_torch.kernels.split_study) against the plain f32
//   version at the reference tests' shapes and one S = 4096, hd 128 head:
//   at most 1.2e-6 from it, against atol 1e-5; two terms per value reach
//   1.5e-5.  On the H100 the kernel sits further from the plain version
//   than the emulation (chip_smoke.py phase 8: at most 5.2e-6), the cost
//   of the tensor cores' accumulation; issuing the small products first
//   brought it closer than issuing them last.  Three terms of every tile
//   take the shared memory of 32-key tiles in two-stage rings, K and V
//   apart, so that a K stage is free once S is in.
// The one-term kernel keeps PR 14's body as it was: one template over the
// terms gave the bf16 route the same instructions but ptxas allocated and
// scheduled them otherwise, and it ran about 1% slower on the H100.
// The softmax stays in f32 registers: row max and sum, and the rescale of
// the accumulator by alpha = exp(scale * (m_old - m_new)).  Exponentials are
// ex2.approx of log2(e)-scaled arguments, 2**(s * c - m * c) with c = scale
// * log2(e), one FFMA and one MUFU instruction a score; their relative error
// (a few f32 ulps) is far below what P keeps.  Every row sees key 0 in the
// first tile, so no row is ever fully masked; the exponential of a masked
// score is exactly 0, and so is the first tile's alpha.  A warp skips the
// rescale when its alphas are all 1.  P V takes P from registers (the A
// operand, whose register layout is the score accumulator's) and V from
// shared memory, MN-major (the transposed operand), so P never leaves the
// registers.
//
// Loads: TMA (cp.async.bulk.tensor, 128-byte swizzle) copies the Q tile
// once per block and K and V tiles into a ring of kStages stages (f32: a K
// ring and a V ring), completion counted on mbarriers; one producer thread
// issues them, and each consumer warp releases a stage once it is done with
// it.  Out-of-bounds rows of a box are zero-filled: keys >= S are then past
// every stored query and so masked, and rows >= S are not stored, which
// handles ragged S.  The same zero fill handles a head narrower than the
// instantiation (HD = 64 for hd <= 64, else 128): the tensor maps span the
// true hd, so the box's columns past it read as zero, add nothing to Q K^T
// and give output columns that are not stored.  No copy pads the head.
//
// What bounds it on this card: the products, 4 * S*S/2 * hd operations per
// head against 8 (16 in f32) bytes per element of q, k, v and out, are far
// above the bytes at the 989 TFLOP/s bf16/f16 tensor-core rate; with P V
// done twice the one-term routes issue 1.5x the function's operations, the
// f32 route 6x.  Each score also costs the CUDA cores about ten
// instructions (mask, max, exponential, sum, split), which measured on the
// H100 weigh as much as the products: hd 64 takes about 0.8x the time of
// hd 128 at half the products.
//
// What the design does about it: one block of two consumer warpgroups (64
// query rows each, 128 per block) and a producer per (head, query tile),
// tiles visited longest first.  A warpgroup issues tile kt's S = Q K^T and
// tile kt-1's O += P V together, runs tile kt's softmax while P V runs, and
// rescales O once P V is done; the two warpgroups interleave on the tensor
// cores as they may.  Budget at hd 128: one-term routes, Q 32 KiB, K plus V
// 32 KiB a stage, 4 stages: 160 KiB, a producer warp; f32, Q 96 KiB, K and V
// 24 KiB a stage each, 2 stages each: 192 KiB, a producer warpgroup that
// gives its registers to the consumers (setmaxnreg; at 9 warps a block the
// f32 consumers spill, each SM quarter holding 3 warps' registers); one
// block per SM.  Registers per consumer thread: 64 f32 of output, 32 (f32:
// 16) of scores and 32 (24) of split P.  Not yet used: ping-pong scheduling
// of the two warpgroups (FlashAttention-3), 128-key tiles, a persistent
// grid, the split inside the kernel (the f32 pre-pass moves 28 bytes per
// element), a tile's P V summed apart from O (closer to the plain version on
// the card, but its 64 more registers spill).
//
// Contract checked by the Python wrapper: q, k, v, out contiguous, 16-byte
// aligned, of the route's type, on the current device; hd a multiple of 8
// up to 128; f32: a (3, 3, B*H, S, hd) bf16 scratch for the terms.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 128;             // query rows per block: two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kRowBytes = 128;       // one 128-byte swizzle row: 64 two-byte values
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kWaitLimit = 1ll << 34;  // clock cycles (~10 s) of a wait before a trap

// T terms per input value (1: bf16/f16 inputs, 3: f32 split into bf16).
template <int T>
struct Design {
  static constexpr int kBK = T == 1 ? 64 : 32;     // keys per tile
  static constexpr int kStages = T == 1 ? 4 : 2;   // ring depth (f32: of K's and of V's)
  static constexpr int kPTerms = T == 1 ? 2 : 3;   // terms of P in P V
  static constexpr int kScores = kBK / 2;          // score accumulators per thread
  static constexpr int kSteps = kBK / 16;          // 16-key steps of P V
  // f32: a producer warpgroup that hands its registers to the consumers
  // (setmaxnreg: without it the f32 consumers spill at hd 128); one-term
  // routes: a producer warp
  static constexpr int kProducerWarps = T > 1 ? 4 : 1;
  static constexpr int kThreads = 32 * (kConsumerWarps + kProducerWarps);
};
// f32: the registers a thread of the producer warpgroup keeps, and those a
// consumer thread grows to (setmaxnreg)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

template <int HD, int T>
struct Smem {  // byte offsets from a 1024-aligned base (the swizzle atom)
  static constexpr int kChunks = HD / 64;                    // 64-column chunks of a row
  static constexpr int kQChunk = kBQ * kRowBytes;            // [kBQ rows][64]
  static constexpr int kTileChunk = Design<T>::kBK * kRowBytes;  // [kBK rows][64]
  static constexpr int kTile = T * kChunks * kTileChunk;     // a K or V tile, every term
  static constexpr int kStages = Design<T>::kStages;
  static constexpr int kQ = 0;                               // [term][chunk] of Q
  static constexpr int kK = T * kChunks * kQChunk;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;  // q, K full/empty, V full/empty
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;  // + alignment
  static_assert(kBytes <= 232448, "shared memory of one block");
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


// Accumulator operands of an m64nN wgmma: N / 2 f32 registers per thread.
#define FA_D16 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
    "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define FA_D32 FA_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
    "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define FA_D64 FA_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
    "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
    "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
    "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
    "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
    "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define FA_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define FA_R32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_R64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D[64 x N] += A[64 x 16] B[16 x N], A and B K-major in shared memory
#define FA_WGMMA_SS(NAME, N, TY, REGS, DLIST, IA, IB)                                   \
  __device__ __forceinline__ void NAME(float (&d)[N / 2], uint64_t a, uint64_t b) {    \
    asm volatile("wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " " REGS \
                 ", %" #IA ", %" #IB ", 1, 1, 1, 0, 0;\n"                               \
                 : DLIST                                                               \
                 : "l"(a), "l"(b));                                                    \
  }
// D[64 x N] += A[64 x 16] B[16 x N], A in registers, B MN-major in shared memory
#define FA_WGMMA_RS(NAME, N, TY, REGS, DLIST, I0, I1, I2, I3, IB)                       \
  __device__ __forceinline__ void NAME(float (&d)[N / 2], const uint32_t (&a)[4],      \
                                       uint64_t b) {                                   \
    asm volatile("wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " " REGS \
                 ", {%" #I0 ", %" #I1 ", %" #I2 ", %" #I3 "}, %" #IB ", 1, 1, 1, 1;\n"  \
                 : DLIST                                                               \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));                \
  }
FA_WGMMA_SS(wgmma_ss_n32_bf16, 32, "bf16", FA_R16, FA_D16, 16, 17)
FA_WGMMA_SS(wgmma_ss_n64_bf16, 64, "bf16", FA_R32, FA_D32, 32, 33)
FA_WGMMA_SS(wgmma_ss_n64_f16, 64, "f16", FA_R32, FA_D32, 32, 33)
FA_WGMMA_RS(wgmma_rs_n64_bf16, 64, "bf16", FA_R32, FA_D32, 32, 33, 34, 35, 36)
FA_WGMMA_RS(wgmma_rs_n128_bf16, 128, "bf16", FA_R64, FA_D64, 64, 65, 66, 67, 68)
FA_WGMMA_RS(wgmma_rs_n64_f16, 64, "f16", FA_R32, FA_D32, 32, 33, 34, 35, 36)
FA_WGMMA_RS(wgmma_rs_n128_f16, 128, "f16", FA_R64, FA_D64, 64, 65, 66, 67, 68)

// The element type of the products: its tensor-map type, its wgmmas, and
// (x0, x1) -> a register pair of it (x0 in the low half) and back.
template <typename E>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float x0, float x1) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
  template <int N>
  static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
    if constexpr (N == 32) wgmma_ss_n32_bf16(d, a, b);
    else wgmma_ss_n64_bf16(d, a, b);
  }
  template <int N>
  static __device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t b) {
    if constexpr (N == 64) wgmma_rs_n64_bf16(d, a, b);
    else wgmma_rs_n128_bf16(d, a, b);
  }
};
template <>
struct Elem<__half> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float x0, float x1) {
    const __half2 h = __floats2half2_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
  template <int N>
  static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
    static_assert(N == 64, "the f16 route runs 64-key tiles");
    wgmma_ss_n64_f16(d, a, b);
  }
  template <int N>
  static __device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t b) {
    if constexpr (N == 64) wgmma_rs_n64_f16(d, a, b);
    else wgmma_rs_n128_f16(d, a, b);
  }
};

template <int A, int B, int C>
__device__ __forceinline__ void pin(uint32_t (&r)[A][B][C]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int k = 0; k < C; ++k) asm volatile("" : "+r"(r[i][j][k])::"memory");
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
template <int NS, int BK>
__device__ __forceinline__ void online_softmax(float (&s)[NS], Rows& r, int kt, bool diag,
                                               int r_lo, int r_hi, int col, float c) {
  float mx_lo = r.m_lo, mx_hi = r.m_hi;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int key = kt * BK + 8 * (i / 4) + col + (i & 1);
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
  for (int i = 0; i < NS; ++i) {
    s[i] = ex2(fmaf(s[i], c, (i & 2) ? -b_hi : -b_lo));
    if (i & 2) sum_hi += s[i];
    else sum_lo += s[i];
  }
  r.l_lo = r.l_lo * r.a_lo + sum_lo;
  r.l_hi = r.l_hi * r.a_hi + sum_hi;
}

// ---- the one-term routes (bf16, f16): PR 14's bf16 kernel on the element type ----

// Issue S = Q K^T for one warpgroup's 64 rows: hd / 16 steps of 16
// columns, four per 128-byte swizzle row of Q and of the K tile.
template <int HD, typename E>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_rows, uint32_t k_tile) {
  using L = Smem<HD, 1>;
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    const uint32_t qa = q_rows + (j / 4) * L::kQChunk + (j % 4) * 32;
    const uint32_t ka = k_tile + (j / 4) * L::kTileChunk + (j % 4) * 32;
    Elem<E>::template ss<64>(s, sw128_desc(qa, 16), sw128_desc(ka, 16));
  }
}

// Issue O += P_hi V + P_lo V: four steps of 16 keys for each term.
template <int HD, typename E>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&p_hi)[4][4],
                                         const uint32_t (&p_lo)[4][4], uint32_t v_tile) {
  using L = Smem<HD, 1>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Elem<E>::template rs<HD>(o, p_hi[kk],
                             sw128_desc(v_tile + kk * 16 * kRowBytes, L::kTileChunk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Elem<E>::template rs<HD>(o, p_lo[kk],
                             sw128_desc(v_tile + kk * 16 * kRowBytes, L::kTileChunk));
}

// P -> (P_hi, P_lo) = (E(P), E(P - P_hi)) as the A operands of the four
// 16-key steps of P V.
template <typename E>
__device__ __forceinline__ void split_p(const float (&s)[32], uint32_t (&p_hi)[4][4],
                                        uint32_t (&p_lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * (2 * kk + r / 2) + 2 * (r % 2);
      p_hi[kk][r] = Elem<E>::pack(s[i], s[i + 1]);
      const float2 h = Elem<E>::unpack(p_hi[kk][r]);
      p_lo[kk][r] = Elem<E>::pack(s[i] - h.x, s[i + 1] - h.y);
    }
}

template <int HD, typename E>
__global__ void __launch_bounds__(Design<1>::kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, E* __restrict__ out,
                            int BH, int S, int hd, float scale) {
  using L = Smem<HD, 1>;
  constexpr int kBK = Design<1>::kBK, kStages = Design<1>::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_bar + 1;             // K/V tile of a stage has landed
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

  static_assert(Design<1>::kPTerms == 2, "P V on P_hi and P_lo");
  float o[HD / 2], s[Design<1>::kScores];
  uint32_t p_hi[Design<1>::kSteps][4], p_lo[Design<1>::kSteps][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  Rows rows;
  mbar_wait(q_bar, 0);
  mbar_wait(&full[0], 0);
  pin(s);
  wgmma_fence();
  issue_qk<HD, E>(s, q_rows, k_tile(0));
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
  online_softmax<32, kBK>(s, rows, 0, diag(0), r_lo, r_hi, col, c);  // O is 0: no rescale
  split_p<E>(s, p_hi, p_lo);

  for (int kt = 1; kt <= last; ++kt) {
    mbar_wait(&full[kt % kStages], (kt / kStages) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    pin(o);
    pin(p_hi);
    pin(p_lo);
    wgmma_fence();
    issue_qk<HD, E>(s, q_rows, k_tile(kt));
    wgmma_commit();
    issue_pv<HD, E>(o, p_hi, p_lo, v_tile(kt - 1));
    wgmma_commit();
    wgmma_wait<1>();  // S is in
    pin(s);
    online_softmax<32, kBK>(s, rows, kt, diag(kt), r_lo, r_hi, col, c);
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
    split_p<E>(s, p_hi, p_lo);
  }
  pin(o);
  pin(p_hi);
  pin(p_lo);
  wgmma_fence();
  issue_pv<HD, E>(o, p_hi, p_lo, v_tile(last));
  wgmma_commit();
  wgmma_wait<0>();
  pin(o);

  const float d_lo = fmaxf(quad_sum(rows.l_lo), 1e-30f);
  const float d_hi = fmaxf(quad_sum(rows.l_hi), 1e-30f);
  E* head = out + (size_t)bh * S * hd;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int cc = 8 * j + col;  // cc + 1 < hd too: hd is a multiple of 8
    if (r_lo < S && cc < hd)
      *reinterpret_cast<uint32_t*>(head + (size_t)r_lo * hd + cc) =
          Elem<E>::pack(o[4 * j] / d_lo, o[4 * j + 1] / d_lo);
    if (r_hi < S && cc < hd)
      *reinterpret_cast<uint32_t*>(head + (size_t)r_hi * hd + cc) =
          Elem<E>::pack(o[4 * j + 2] / d_hi, o[4 * j + 3] / d_hi);
  }
}

// ---- the f32 route: q * scale, k and v as three bf16 terms each ----

// Issue S = Q K^T for one warpgroup's 64 rows: for each term product
// (i, j), i + j < T, hd / 16 steps of 16 columns, four per 128-byte swizzle
// row of Q and of the K tile.  The smallest products go first, while the
// accumulator is still small, so that the tensor cores' alignment of each
// step's sum to the accumulator costs them the fewest bits.
template <int HD, int T>
__device__ __forceinline__ void issue_qk_terms(float (&s)[Design<T>::kScores], uint32_t q_rows,
                                               uint32_t k_tile) {
  using L = Smem<HD, T>;
#pragma unroll
  for (int ij = T - 1; ij >= 0; --ij)
#pragma unroll
    for (int i = 0; i <= ij; ++i)
#pragma unroll
      for (int c = 0, j = ij - i; c < HD / 16; ++c) {
        const uint32_t qa = q_rows + (i * L::kChunks + c / 4) * L::kQChunk + (c % 4) * 32;
        const uint32_t ka = k_tile + (j * L::kChunks + c / 4) * L::kTileChunk + (c % 4) * 32;
        Elem<__nv_bfloat16>::template ss<Design<T>::kBK>(s, sw128_desc(qa, 16),
                                                         sw128_desc(ka, 16));
      }
}

// Issue O += P V as the term products P_i V_j, i + j < kPTerms (j < T):
// kSteps steps of 16 keys each, the smallest products first.
template <int HD, int T>
__device__ __forceinline__ void issue_pv_terms(
    float (&o)[HD / 2], const uint32_t (&p)[Design<T>::kPTerms][Design<T>::kSteps][4],
    uint32_t v_tile) {
  using L = Smem<HD, T>;
#pragma unroll
  for (int ij = Design<T>::kPTerms - 1; ij >= 0; --ij)
#pragma unroll
    for (int j = 0; j < T && j <= ij; ++j)
#pragma unroll
      for (int kk = 0, i = ij - j; kk < Design<T>::kSteps; ++kk)
        Elem<__nv_bfloat16>::template rs<HD>(
            o, p[i][kk],
            sw128_desc(v_tile + j * L::kChunks * L::kTileChunk + kk * 16 * kRowBytes,
                       L::kTileChunk));
}

// P -> its PT bf16 terms, P_0 = bf16(P), P_t = bf16(P - P_0 - ... - P_{t-1})
// (every difference exact in f32), as the A operands of the 16-key steps of
// P V.
template <int NS, int PT>
__device__ __forceinline__ void split_p_terms(const float (&s)[NS],
                                              uint32_t (&p)[PT][NS / 8][4]) {
  using E = Elem<__nv_bfloat16>;
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * (2 * kk + r / 2) + 2 * (r % 2);
      float x0 = s[i], x1 = s[i + 1];
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        p[t][kk][r] = E::pack(x0, x1);
        if (t + 1 < PT) {
          const float2 h = E::unpack(p[t][kk][r]);
          x0 -= h.x;
          x1 -= h.y;
        }
      }
    }
}

// The one-term kernel's schedule on three-term operands, with K and V in
// rings of their own (a K stage is free once S is in) and a producer
// warpgroup that hands its registers to the consumers.  ``scale`` is 1:
// q * scale is in the terms.
template <int HD>
__global__ void __launch_bounds__(Design<3>::kThreads, 1)
flash_attention_sm90_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                float* __restrict__ out, int BH, int S, int hd, float scale) {
  constexpr int T = 3;
  using L = Smem<HD, T>;
  using D = Design<T>;
  constexpr int kBK = D::kBK, kStages = D::kStages, NS = D::kScores;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* k_full = q_bar + 1;          // K tile of a stage landed
  uint64_t* k_empty = k_full + kStages;  // every consumer warp's S read it
  uint64_t* v_full = k_empty + kStages;  // V tile of a stage landed
  uint64_t* v_empty = v_full + kStages;  // every consumer warp's P V read it

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);  // longest rows first
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&k_empty[i], kConsumerWarps);
      mbar_init(&v_full[i], 1);
      mbar_init(&v_empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      // term t of head bh is plane t * BH + bh of the tensor maps
      const int n_kt = (min(q0 + kBQ, S) - 1) / kBK + 1;  // through the block's last row
      mbar_expect_tx(q_bar, T * L::kChunks * L::kQChunk);
      for (int t = 0; t < T; ++t)
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(smem + L::kQ + (t * L::kChunks + c) * L::kQChunk, &tm_q, q_bar, 64 * c, q0,
                   t * BH + bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        const uint32_t parity = (kt / kStages - 1) & 1;
        if (kt >= kStages) mbar_wait(&k_empty[st], parity);
        mbar_expect_tx(&k_full[st], L::kTile);
        for (int t = 0; t < T; ++t)
          for (int c = 0; c < L::kChunks; ++c)
            tma_load(smem + L::kK + st * L::kTile + (t * L::kChunks + c) * L::kTileChunk,
                     &tm_k, &k_full[st], 64 * c, kt * kBK, t * BH + bh);
        if (kt >= kStages) mbar_wait(&v_empty[st], parity);
        mbar_expect_tx(&v_full[st], L::kTile);
        for (int t = 0; t < T; ++t)
          for (int c = 0; c < L::kChunks; ++c)
            tma_load(smem + L::kV + st * L::kTile + (t * L::kChunks + c) * L::kTileChunk,
                     &tm_v, &v_full[st], 64 * c, kt * kBK, t * BH + bh);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // a consumer warpgroup, as in the one-term kernel; a K stage is released
  // once S is in, a V stage once P V is done
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
  auto wait_tile = [&](uint64_t* full, int kt) {
    mbar_wait(&full[kt % kStages], (kt / kStages) & 1);
  };
  auto diag = [&](int kt) { return kt * kBK + kBK - 1 > row0; };
  auto release = [&](uint64_t* empty, int kt) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[kt % kStages]);
  };

  float o[HD / 2], s[NS];
  uint32_t p[D::kPTerms][D::kSteps][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
  Rows rows;
  mbar_wait(q_bar, 0);
  wait_tile(k_full, 0);
  pin(s);
  wgmma_fence();
  issue_qk_terms<HD, T>(s, q_rows, k_tile(0));
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
  release(k_empty, 0);
  online_softmax<NS, kBK>(s, rows, 0, diag(0), r_lo, r_hi, col, c);  // O is 0: no rescale
  split_p_terms(s, p);

  for (int kt = 1; kt <= last; ++kt) {
    wait_tile(k_full, kt);
    wait_tile(v_full, kt - 1);
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    pin(s);
    pin(o);
    pin(p);
    wgmma_fence();
    issue_qk_terms<HD, T>(s, q_rows, k_tile(kt));
    wgmma_commit();
    issue_pv_terms<HD, T>(o, p, v_tile(kt - 1));
    wgmma_commit();
    wgmma_wait<1>();  // S is in: K tile kt is read
    pin(s);
    release(k_empty, kt);
    online_softmax<NS, kBK>(s, rows, kt, diag(kt), r_lo, r_hi, col, c);
    wgmma_wait<0>();  // P V is done with O, P and V tile kt-1
    pin(o);
    pin(p);
    release(v_empty, kt - 1);
    // the row max moved for some row of this warp (alpha == 1 leaves O as it is)
    if (!__all_sync(0xffffffffu, rows.a_lo == 1.f && rows.a_hi == 1.f)) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 2) ? rows.a_hi : rows.a_lo;
    }
    split_p_terms(s, p);
  }
  wait_tile(v_full, last);
  pin(o);
  pin(p);
  wgmma_fence();
  issue_pv_terms<HD, T>(o, p, v_tile(last));
  wgmma_commit();
  wgmma_wait<0>();
  pin(o);
  release(v_empty, last);  // the producer may still be waiting for it

  const float d_lo = fmaxf(quad_sum(rows.l_lo), 1e-30f);
  const float d_hi = fmaxf(quad_sum(rows.l_hi), 1e-30f);
  float* head = out + (size_t)bh * S * hd;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int cc = 8 * j + col;  // cc + 1 < hd too: hd is a multiple of 8
    if (r_lo < S && cc < hd)
      *reinterpret_cast<float2*>(head + (size_t)r_lo * hd + cc) =
          make_float2(o[4 * j] / d_lo, o[4 * j + 1] / d_lo);
    if (r_hi < S && cc < hd)
      *reinterpret_cast<float2*>(head + (size_t)r_hi * hd + cc) =
          make_float2(o[4 * j + 2] / d_hi, o[4 * j + 3] / d_hi);
  }
}

// The f32 route's pre-pass: q * scale, k and v (n values each) -> three
// bf16 terms each, terms[(3a + t) * n + i] for a = q, k, v and term t;
// x = t0 + t1 + t2 exactly for every normal f32 x.  Four values a thread.
__global__ void split3_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
                              const float4* __restrict__ v, uint2* __restrict__ terms,
                              size_t n4, float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float4 x = a == 0 ? q[i] : a == 1 ? k[i] : v[i];
      if (a == 0) x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const uint32_t lo = Elem<__nv_bfloat16>::pack(x.x, x.y);
        const uint32_t hi = Elem<__nv_bfloat16>::pack(x.z, x.w);
        terms[(3 * a + t) * n4 + i] = make_uint2(lo, hi);
        const float2 fl = Elem<__nv_bfloat16>::unpack(lo), fh = Elem<__nv_bfloat16>::unpack(hi);
        x = make_float4(x.x - fl.x, x.y - fl.y, x.z - fh.x, x.w - fh.y);
      }
    }
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

// (planes, S, hd) two-byte values as a 3-D tensor map of (64 x rows x 1)
// boxes, 128-byte swizzle; out-of-bounds elements of a box (rows past S,
// columns past hd) read as zero.
CUresult tensor_map(EncodeTiled encode, CUtensorMap* map, CUtensorMapDataType type,
                    const void* ptr, int planes, int S, int hd, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)S * hd * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// q, k, v: the kernel's operands, T planes of (BH, S, hd) each.
template <int HD, typename E, int T>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int S, int hd,
           float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  constexpr CUtensorMapDataType type = Elem<E>::kMap;
  CUresult res = tensor_map(encode, &tq, type, q, T * BH, S, hd, kBQ);
  if (res == CUDA_SUCCESS) res = tensor_map(encode, &tk, type, k, T * BH, S, hd, Design<T>::kBK);
  if (res == CUDA_SUCCESS) res = tensor_map(encode, &tv, type, v, T * BH, S, hd, Design<T>::kBK);
  if (res != CUDA_SUCCESS) return 1000 + (int)res;
  using Out = std::conditional_t<T == 1, E, float>;  // the output type
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, Out*, int, int, int, float);
  if constexpr (T == 1) kernel = flash_attention_sm90_kernel<HD, E>;
  else kernel = flash_attention_sm90_f32_kernel<HD>;
  constexpr int smem = Smem<HD, T>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)BH * ((S + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, Design<T>::kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<Out*>(out), BH, S, hd, scale);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_one_term(const void* q, const void* k, const void* v, void* out, int BH, int S,
                    int hd, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0 || hd < 8 || hd % 8 || hd > 128) return (int)cudaErrorInvalidValue;
  if (hd <= 64) return launch<64, E, 1>(q, k, v, out, BH, S, hd, scale, s);
  return launch<128, E, 1>(q, k, v, out, BH, S, hd, scale, s);
}

int launch_f32(const void* q, const void* k, const void* v, void* out, void* terms, int BH,
               int S, int hd, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0 || hd < 8 || hd % 8 || hd > 128 || terms == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)BH * S * hd;  // a multiple of 8: hd is
  const size_t n4 = n / 4;
  const unsigned grid = (unsigned)((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  split3_kernel<<<grid, 256, 0, s>>>(static_cast<const float4*>(q),
                                     static_cast<const float4*>(k),
                                     static_cast<const float4*>(v), static_cast<uint2*>(terms),
                                     n4, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto* t = static_cast<const __nv_bfloat16*>(terms);
  // q * scale is in the terms: the kernel's scale is 1
  if (hd <= 64)
    return launch<64, __nv_bfloat16, 3>(t, t + 3 * n, t + 6 * n, out, BH, S, hd, 1.f, s);
  return launch<128, __nv_bfloat16, 3>(t, t + 3 * n, t + 6 * n, out, BH, S, hd, 1.f, s);
}

}  // namespace

// Each entry returns 0 once launched, a cudaError_t, or 1000 + the CUresult
// of a failed cuTensorMapEncodeTiled.  ``terms`` is unused but by the f32
// route.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                           void* out, void* terms, int BH, int S, int hd,
                                           float scale, void* stream) {
  return launch_one_term<__nv_bfloat16>(q, k, v, out, BH, S, hd, scale, stream);
}

extern "C" int flash_attention_sm90_f16_launch(const void* q, const void* k, const void* v,
                                               void* out, void* terms, int BH, int S, int hd,
                                               float scale, void* stream) {
  return launch_one_term<__half>(q, k, v, out, BH, S, hd, scale, stream);
}

// f32: ``terms`` is (3, 3, BH, S, hd) bf16 scratch for the split operands.
extern "C" int flash_attention_sm90_f32_launch(const void* q, const void* k, const void* v,
                                               void* out, void* terms, int BH, int S, int hd,
                                               float scale, void* stream) {
  return launch_f32(q, k, v, out, terms, BH, S, hd, scale, stream);
}
