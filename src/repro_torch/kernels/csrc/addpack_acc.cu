// Addition-packing accumulator (paper §VII) for Hopper (sm_90a): (T, 2, N)
// int32 narrow terms -> (2, N) int32 lane sums, two lanes per 32-bit word.
//
// Replaces the TPU kernel src/repro/kernels/addpack_acc.py::addpack_accumulate
// (Pallas body _kernel).  Per chunk of 2**guard steps each lane's term is
// masked to lane_bits, one word lo | (hi << (lane_bits + guard)) is added
// per step (one add, two accumulations), and at the end of the chunk both
// fields are sign-extended out of the word and added to the lane totals.
// Chunks whose sum leaves the signed lane range wrap per chunk, exactly as
// the TPU kernel's do (the plain per-lane sum does not).  A ragged last
// chunk (odd T) holds one step.
//
// What bounds it on this card: every term is read once and feeds two adds,
// so it is bound by the bytes streamed from HBM (3.35 TB/s).
//
// What the design does about it: one thread owns four consecutive columns
// and reads each lane of each step as one 16-byte vector, so a warp reads
// 512 contiguous bytes per lane and step; the step loop is unrolled four
// deep with all loads issued before the adds, so eight 16-byte loads per
// thread are in flight.  No shared memory and no cross-thread traffic: the
// columns are independent.  N not a multiple of four takes the one-column
// form of the same kernel.
//
// All word arithmetic is in uint32_t (wrapping, no undefined overflow).  The
// field shift is logical: the sign extension reads only bits
// [field, field + lane_bits) of the word, which lie below bit 32, so a
// logical and an arithmetic shift give the same lane.
//
// Contract checked by the Python wrapper: terms contiguous, 16-byte aligned,
// int32, on the current device; lane_bits + guard + lane_bits <= 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // steps whose loads are issued together

__device__ __forceinline__ uint32_t sext(uint32_t v, uint32_t mask, uint32_t sign) {
  return ((v & mask) ^ sign) - sign;  // two's complement, wrapping
}

template <int W>
struct Cols;
template <>
struct Cols<4> {
  __device__ __forceinline__ static void load(const int32_t* p, uint32_t (&v)[4]) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = (uint32_t)q.x; v[1] = (uint32_t)q.y; v[2] = (uint32_t)q.z; v[3] = (uint32_t)q.w;
  }
  __device__ __forceinline__ static void store(int32_t* p, const uint32_t (&v)[4]) {
    *reinterpret_cast<int4*>(p) = make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
  }
};
template <>
struct Cols<1> {
  __device__ __forceinline__ static void load(const int32_t* p, uint32_t (&v)[1]) {
    v[0] = (uint32_t)__ldg(p);
  }
  __device__ __forceinline__ static void store(int32_t* p, const uint32_t (&v)[1]) {
    *p = (int)v[0];
  }
};

template <int W>
__global__ void __launch_bounds__(kThreads)
addpack_acc_kernel(const int32_t* __restrict__ terms, int32_t* __restrict__ out,
                   int T, int N, int lane_bits, int guard) {
  const long long n0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * W;
  if (n0 >= N) return;
  const uint32_t mask = (1u << lane_bits) - 1u;
  const uint32_t sign = 1u << (lane_bits - 1);
  const int field = lane_bits + guard;
  const int chunk_mask = (1 << guard) - 1;  // chunks of 2**guard steps
  const size_t lane_stride = (size_t)N;
  const size_t step_stride = 2 * (size_t)N;
  const int32_t* p = terms + n0;

  uint32_t lo_total[W], hi_total[W], acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) lo_total[c] = hi_total[c] = acc[c] = 0u;

  for (int t0 = 0; t0 < T; t0 += kUnroll) {
    uint32_t lo[kUnroll][W], hi[kUnroll][W];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < T) {
        const int32_t* q = p + (size_t)(t0 + u) * step_stride;
        Cols<W>::load(q, lo[u]);
        Cols<W>::load(q + lane_stride, hi[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < T) {
#pragma unroll
        for (int c = 0; c < W; ++c) acc[c] += (lo[u][c] & mask) | ((hi[u][c] & mask) << field);
        if (((t + 1) & chunk_mask) == 0 || t + 1 == T) {  // end of a chunk
#pragma unroll
          for (int c = 0; c < W; ++c) {
            lo_total[c] += sext(acc[c], mask, sign);
            hi_total[c] += sext(acc[c] >> field, mask, sign);
            acc[c] = 0u;
          }
        }
      }
    }
  }
  Cols<W>::store(out + n0, lo_total);
  Cols<W>::store(out + lane_stride + n0, hi_total);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int addpack_acc_launch(const void* terms, void* out, int T, int N,
                                  int lane_bits, int guard, void* stream) {
  if (N <= 0 || lane_bits < 1 || guard < 0 || 2 * lane_bits + guard > 32)
    return (int)cudaErrorInvalidValue;
  const auto* tp = static_cast<const int32_t*>(terms);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (N % 4 == 0) {
    const int blocks = (N / 4 + kThreads - 1) / kThreads;
    addpack_acc_kernel<4><<<blocks, kThreads, 0, s>>>(tp, op, T, N, lane_bits, guard);
  } else {
    const int blocks = (N + kThreads - 1) / kThreads;
    addpack_acc_kernel<1><<<blocks, kThreads, 0, s>>>(tp, op, T, N, lane_bits, guard);
  }
  return (int)cudaGetLastError();
}
