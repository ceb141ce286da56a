// Fused rowwise Adagrad over distinct ids, in place: for each slot i whose
// id u = uids[i] is a real row (0 <= u < V; sentinels and other ids out of
// range are skipped)
//     acc[u]   += mean_j(g[i, j]^2)
//     table[u] -= lr * g[i] / (sqrt(acc[u]) + eps)
//
// Replaces the TPU kernel tfrec_tpu/kernels/scatter_pallas.py
// fused_rowwise_adagrad -> scaled_scatter_sub (body _kernel), and with it
// _scaled_scatter_sub_packed, its 128-lane workaround for D < 128, which
// has no reason to exist here: one kernel takes any D. On the TPU the
// accumulator update stayed in XLA because Mosaic cannot DMA a one-float
// row; the card has no such limit, so this kernel does both parts in one
// pass and the accumulator never makes a second trip.
//
// Bound: bytes, and below them latency. For each real id it must read its
// gradient row (D*4), read and write its table row (2*D*4) and its
// accumulator (8), plus the N*4 bytes of ids: at D=32 and ~2000 distinct
// ids in 8192 slots about 0.8 MB, under 0.3 us at 3.35 TB/s. Operations
// are ~4 per element. So the kernel is bound by the latency of one
// dependent chain per row (read g, reduce, read acc, write), like the row
// gather. Design: one warp per slot; lane j takes elements j, j+32, ... of
// the row (one at D=32), coalesced. The sum of squares is reduced in f32 in
// a fixed order (each lane in order, then a butterfly of shuffles, which
// leaves the same sum in every lane), so runs repeat bit for bit; the
// division, square root and update use the _rn intrinsics so nothing is
// contracted into an FMA and each step rounds as the plain PyTorch version
// does. Warps of sentinel slots leave at once.
//
// Caller contract, as for the TPU kernel: real ids are distinct (the
// duplicate combine runs first); two slots with the same real id would
// race on its row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rowwise_adagrad_kernel(float* __restrict__ table, float* __restrict__ acc,
                       const int* __restrict__ uids, const float* __restrict__ g,
                       int64_t n, int64_t vocab, int d, float lr, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t slot = first; slot < n; slot += stride) {
    const int64_t u = __ldg(uids + slot);
    if (u < 0 || u >= vocab) continue;  // the same for the whole warp
    const float* gr = g + slot * d;
    float ssq = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float v = __ldg(gr + j);
      ssq = __fadd_rn(ssq, __fmul_rn(v, v));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ssq += __shfl_xor_sync(0xffffffffu, ssq, off);
    }
    const float a = __fadd_rn(acc[u], __fdiv_rn(ssq, (float)d));
    const float scale = __fdiv_rn(lr, __fadd_rn(__fsqrt_rn(a), eps));
    float* tr = table + u * d;
    for (int j = lane; j < d; j += 32) {
      tr[j] = __fsub_rn(tr[j], __fmul_rn(scale, __ldg(gr + j)));
    }
    if (lane == 0) acc[u] = a;
  }
}

}  // namespace

// table [vocab, d] f32 and acc [vocab] f32 (updated in place), uids [n]
// int32, g [n, d] f32, all contiguous on the current device; runs on
// `stream`. Returns cudaGetLastError().
extern "C" int tfrec_rowwise_adagrad(void* table, void* acc, const void* uids,
                                     const void* g, long long n, long long vocab,
                                     long long d, float lr, float eps,
                                     void* stream) {
  const int64_t max_blocks = 132 * 16;  // grid-stride beyond this
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  rowwise_adagrad_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<float*>(acc),
      static_cast<const int*>(uids), static_cast<const float*>(g), n, vocab,
      static_cast<int>(d), lr, eps);
  return static_cast<int>(cudaGetLastError());
}
