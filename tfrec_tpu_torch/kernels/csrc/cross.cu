// DCN-v1 cross stack, forward: for l in 0..L-1
//     s_l     = x_l . w_l                (one scalar per row)
//     x_{l+1} = x0 * s_l + b_l + x_l
// out = x_L.
//
// Replaces the TPU kernel tfrec_tpu/kernels/cross_pallas.py
// cross_stack_pallas forward (_cross_fwd_impl, body _fwd_kernel).
//
// Bound: bytes. Each layer is a row dot and an elementwise chain (5*d
// operations per row), far below the card's operations-per-byte balance;
// the least traffic is one read of x0 and one write of x_L, B*d*4*2 bytes,
// plus 2*L*d*4 of weights (B=8192, d=845, L=3: 55.4 MB, 16.5 us at
// 3.35 TB/s). Design: one warp per row. Lane j keeps elements j, j+32,
// j+64, ... of x0 and of the running x in registers (K = chunks per lane,
// a template parameter rounded up to a power of two), so device memory is
// touched once for x0 and once for x_L however many layers there are; w
// and b are small and come through the read-only cache. Loads and stores
// are scalar and coalesced: d = 845 is odd, so rows are not 16-byte aligned
// and vector loads would not line up. The row dot is reduced in f32 in a
// fixed order (each lane sums its chunks in order, then a butterfly of
// warp shuffles) with no atomics, so runs repeat bit for bit. The update is
// written with __fmul_rn/__fadd_rn so the compiler does not fuse it into an
// FMA: it rounds as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cross_v1_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out,
                    int64_t batch, int d, int layers) {
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t row = first; row < batch; row += stride) {
    const float* xr = x0 + row * d;
    float a[K];
    float x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      a[k] = j < d ? xr[j] : 0.0f;
      x[k] = a[k];
    }
    for (int l = 0; l < layers; ++l) {
      const float* wl = w + (int64_t)l * d;
      const float* bl = b + (int64_t)l * d;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = lane + 32 * k;
        if (j < d) s = fmaf(x[k], __ldg(wl + j), s);
      }
      // Butterfly: lanes i and i^off add the same two values, so every
      // lane ends with the same, fixed-order sum.
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = lane + 32 * k;
        if (j < d) {
          x[k] = __fadd_rn(__fadd_rn(__fmul_rn(a[k], s), __ldg(bl + j)), x[k]);
        }
      }
    }
    float* orow = out + row * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      if (j < d) orow[j] = x[k];
    }
  }
}

template <int K>
void launch(const float* x0, const float* w, const float* b, float* out,
            int64_t batch, int d, int layers, cudaStream_t s) {
  const int64_t max_blocks = 132 * 32;  // grid-stride beyond this
  int64_t blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  cross_v1_fwd_kernel<K><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
      x0, w, b, out, batch, d, layers);
}

}  // namespace

// x0 [batch, d] f32, w and b [layers, d] f32, out [batch, d] f32, all
// contiguous on the current device; runs on `stream`. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for d outside [1, 2048].
extern "C" int tfrec_cross_v1_fwd(const void* x0, const void* w, const void* b,
                                  void* out, long long batch, long long d,
                                  long long layers, void* stream) {
  const float* px0 = static_cast<const float*>(x0);
  const float* pw = static_cast<const float*>(w);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d);
  const int li = static_cast<int>(layers);
  const int64_t chunks = (d + 31) / 32;
  if (d < 1 || chunks > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (chunks <= 1) launch<1>(px0, pw, pb, po, batch, di, li, s);
  else if (chunks <= 2) launch<2>(px0, pw, pb, po, batch, di, li, s);
  else if (chunks <= 4) launch<4>(px0, pw, pb, po, batch, di, li, s);
  else if (chunks <= 8) launch<8>(px0, pw, pb, po, batch, di, li, s);
  else if (chunks <= 16) launch<16>(px0, pw, pb, po, batch, di, li, s);
  else if (chunks <= 32) launch<32>(px0, pw, pb, po, batch, di, li, s);
  else launch<64>(px0, pw, pb, po, batch, di, li, s);
  return static_cast<int>(cudaGetLastError());
}
