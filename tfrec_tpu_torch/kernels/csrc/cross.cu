// DCN-v1 cross stack, forward and backward.
//
// Forward: for l in 0..L-1
//     s_l     = x_l . w_l                (one scalar per row)
//     x_{l+1} = x0 * s_l + b_l + x_l
// out = x_L; the per-row scalars s [B, L] are written too when asked for
// (the training forward saves them for the backward).
//
// Backward, from the top layer down, with g = dL/dx_L:
//     ds   = sum_j g_j * x0_j            (one scalar per row)
//     dw_l = sum_batch x_l * ds
//     db_l = sum_batch g
//     dx0 += g * s_l
//     g   += ds * w_l                    (the gradient with respect to x_l)
// and finally dx0 += g (the input of layer 0 is x0 itself).
//
// Replaces the TPU kernels of tfrec_tpu/kernels/cross_pallas.py
// cross_stack_pallas: the forward (_cross_fwd_impl, body _fwd_kernel) and
// the backward (_cross_bwd_rule, body _bwd_kernel).
//
// Forward. Bound: bytes. Each layer is a row dot and an elementwise chain
// (5*d operations per row), far below the card's operations-per-byte
// balance; the least traffic is one read of x0 and one write of x_L,
// B*d*4*2 bytes, plus 2*L*d*4 of weights (B=8192, d=845, L=3: 55.4 MB,
// 16.5 us at 3.35 TB/s). Design: a block of 256 threads per row (row =
// blockIdx.x, + gridDim.x, ...). Thread t keeps elements t, t+256, ... of x0
// and of the running x in registers (K of them, a template parameter rounded
// up to a power of two, at most 32: d <= 8192), so device memory is touched
// once for x0 and once for x_L however many layers there are; w and b are
// small and come through the read-only cache. Loads and stores are scalar
// and coalesced: d = 845 is odd, so rows are not 16-byte aligned and vector
// loads would not line up. The row dot is reduced in f32 in a fixed order
// with no atomics (block_sum, shared with the backward), so runs repeat bit
// for bit. The update is written with __fmul_rn/__fadd_rn so the compiler
// does not fuse it into an FMA: it rounds as the plain PyTorch version does.
// A warp a row (K <= 64 a lane: 145 registers at d=845, so one block of 8
// warps an SM) took 79.1-79.6 us at the flagship's shape against this
// kernel's 38.8-39.3 us (tools/ab_cross_v2.py, one call).
//
// Backward. Bound: bytes. It must read x0 and g and write dx0, 3*B*d*4
// bytes (83.1 MB at B=8192, d=845: 24.8 us at 3.35 TB/s); its ~12
// operations per element and layer are far below the balance. Design: the
// forward saved s [B, L] (98 KB), so x_l is rebuilt elementwise from x0, s
// and b exactly as the forward computed it, with no row dot; only ds needs
// one per layer. A block of 256 threads walks its rows (row = blockIdx.x,
// + gridDim.x, ...); thread t keeps elements t, t+256, ... (K <= 32 of them)
// of x0, g and dx0 in registers, so a row is split over the whole block and
// registers stay few. ds is a block reduction in a fixed order: each thread sums its
// elements in order, a butterfly inside each warp, then every thread adds
// the 8 warp sums in warp order from shared memory (one barrier a
// reduction; the two slots alternate), as in the forward. dw and db are sums over the batch,
// and blocks on Hopper share nothing: each block accumulates its rows into
// [2, L, d] in shared memory (each element owned by one thread, in row
// order), writes that partial to device memory, and a second kernel sums
// the partials of all blocks in a fixed order. No atomics anywhere, so runs
// repeat bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;  // a block, which takes a row at a time
constexpr int kRowWarps = kRowThreads / 32;

// The sum of p over a block of kRowThreads threads, in a fixed order: a
// butterfly inside each warp, then every thread adds the 8 warp sums in
// warp order from shared memory. One barrier a call; red's two slots
// alternate (the other slot's last readers passed this barrier before
// anyone writes it again at the next call).
__device__ __forceinline__ float block_sum(float p, float (&red)[2][kRowWarps], int& slot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    p += __shfl_xor_sync(0xffffffffu, p, off);
  }
  if ((threadIdx.x & 31) == 0) red[slot][threadIdx.x >> 5] = p;
  __syncthreads();
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kRowWarps; ++i) sum += red[slot][i];
  slot ^= 1;
  return sum;
}

// A block of kRowThreads threads a row (row = blockIdx.x, + gridDim.x, ...);
// thread t keeps elements t, t+256, ... (K of them) of x0 and of the running
// x in registers.
template <int K>
__global__ void __launch_bounds__(kRowThreads)
cross_v1_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out,
                    float* __restrict__ s_out, int64_t batch, int d, int layers) {
  __shared__ float red[2][kRowWarps];
  const int tid = threadIdx.x;
  int slot = 0;
  for (int64_t row = blockIdx.x; row < batch; row += gridDim.x) {
    const float* xr = x0 + row * d;
    float a[K];
    float x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + kRowThreads * k;
      a[k] = j < d ? xr[j] : 0.0f;
      x[k] = a[k];
    }
    for (int l = 0; l < layers; ++l) {
      const float* wl = w + (int64_t)l * d;
      const float* bl = b + (int64_t)l * d;
      float p = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = tid + kRowThreads * k;
        if (j < d) p = fmaf(x[k], __ldg(wl + j), p);
      }
      const float s = block_sum(p, red, slot);
      if (s_out != nullptr && tid == 0) s_out[row * layers + l] = s;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = tid + kRowThreads * k;
        if (j < d) {
          x[k] = __fadd_rn(__fadd_rn(__fmul_rn(a[k], s), __ldg(bl + j)), x[k]);
        }
      }
    }
    float* orow = out + row * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + kRowThreads * k;
      if (j < d) orow[j] = x[k];
    }
  }
}

template <int K>
void launch_fwd(const float* x0, const float* w, const float* b, float* out,
                float* s_out, int64_t batch, int d, int layers, cudaStream_t s) {
  const int64_t max_blocks = 132 * 8;  // grid-stride beyond this
  int64_t blocks = batch < max_blocks ? batch : max_blocks;
  if (blocks < 1) blocks = 1;
  cross_v1_fwd_kernel<K><<<(unsigned)blocks, kRowThreads, 0, s>>>(
      x0, w, b, out, s_out, batch, d, layers);
}

// Dynamic shared memory: [2, L, d] floats (dw then db accumulators).
template <int K>
__global__ void __launch_bounds__(kRowThreads)
cross_v1_bwd_kernel(const float* __restrict__ x0, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ s,
                    const float* __restrict__ g_in, float* __restrict__ dx0,
                    float* __restrict__ partial, int64_t batch, int d, int layers) {
  extern __shared__ float acc[];
  __shared__ float red[2][kRowWarps];
  const int tid = threadIdx.x;
  const int64_t width = (int64_t)layers * d;  // one of dw, db
  // Each thread zeroes, accumulates and writes only its own elements
  // (j = tid + 256*k), so the accumulators need no barrier.
  for (int64_t l = 0; l < 2 * layers; ++l) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + kRowThreads * k;
      if (j < d) acc[l * d + j] = 0.0f;
    }
  }
  int slot = 0;
  for (int64_t row = blockIdx.x; row < batch; row += gridDim.x) {
    const float* xr = x0 + row * d;
    const float* gr = g_in + row * d;
    const float* sr = s + row * layers;
    float a[K];
    float g[K];
    float dx[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + kRowThreads * k;
      a[k] = j < d ? xr[j] : 0.0f;
      g[k] = j < d ? gr[j] : 0.0f;
      dx[k] = 0.0f;
    }
    for (int l = layers - 1; l >= 0; --l) {
      float p = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) p = fmaf(g[k], a[k], p);  // 0 past d
      const float ds = block_sum(p, red, slot);
      const float sl = __ldg(sr + l);
      const float* wl = w + (int64_t)l * d;
      float* dw = acc + (int64_t)l * d;
      float* db = acc + width + (int64_t)l * d;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = tid + kRowThreads * k;
        if (j < d) {
          // x_l, rebuilt as the forward computed it.
          float x = a[k];
          for (int m = 0; m < l; ++m) {
            x = __fadd_rn(__fadd_rn(__fmul_rn(a[k], __ldg(sr + m)),
                                    __ldg(b + (int64_t)m * d + j)), x);
          }
          dw[j] = fmaf(x, ds, dw[j]);
          db[j] += g[k];
          dx[k] = fmaf(g[k], sl, dx[k]);
          g[k] = fmaf(ds, __ldg(wl + j), g[k]);
        }
      }
    }
    float* dr = dx0 + row * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + kRowThreads * k;
      if (j < d) dr[j] = dx[k] + g[k];
    }
  }
  float* mine = partial + (int64_t)blockIdx.x * 2 * width;
  for (int64_t l = 0; l < 2 * layers; ++l) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + kRowThreads * k;
      if (j < d) mine[l * d + j] = acc[l * d + j];
    }
  }
}

// out[e] = sum over blocks of partial[block][e], e < 2*width, blocks in
// order: a block of 32x8 threads takes 32 columns; thread row y sums the
// partials y, y+8, ... in order, then row 0 adds the 8 row sums in order.
constexpr int kSumCols = 32;
constexpr int kSumRows = 8;

__global__ void __launch_bounds__(kSumCols * kSumRows)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                    float* __restrict__ db, int nblocks, int64_t width) {
  __shared__ float rows[kSumRows][kSumCols];
  const int tx = threadIdx.x % kSumCols;
  const int ty = threadIdx.x / kSumCols;
  const int64_t e = (int64_t)blockIdx.x * kSumCols + tx;
  const int64_t total = 2 * width;
  float sum = 0.0f;
  if (e < total) {
    for (int blk = ty; blk < nblocks; blk += kSumRows) {
      sum += __ldg(partial + (int64_t)blk * total + e);
    }
  }
  rows[ty][tx] = sum;
  __syncthreads();
  if (ty == 0 && e < total) {
    float out = 0.0f;
#pragma unroll
    for (int y = 0; y < kSumRows; ++y) out += rows[y][tx];
    if (e < width) dw[e] = out;
    else db[e - width] = out;
  }
}

template <int K>
int launch_bwd(const float* x0, const float* w, const float* b, const float* sv,
               const float* g, float* dx0, float* dw, float* db, float* partial,
               int64_t batch, int d, int layers, int nblocks, cudaStream_t s) {
  const size_t smem = (size_t)2 * layers * d * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cross_v1_bwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cross_v1_bwd_kernel<K><<<(unsigned)nblocks, kRowThreads, smem, s>>>(
      x0, w, b, sv, g, dx0, partial, batch, d, layers);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t width = (int64_t)layers * d;
  const int64_t sum_blocks = (2 * width + kSumCols - 1) / kSumCols;
  sum_partials_kernel<<<(unsigned)sum_blocks, kSumCols * kSumRows, 0, s>>>(
      partial, dw, db, nblocks, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x0 [batch, d] f32, w and b [layers, d] f32, out [batch, d] f32, s_out
// [batch, layers] f32 or null, all contiguous on the current device; runs
// on `stream`. Returns cudaGetLastError(), or cudaErrorInvalidValue for d
// outside [1, 8192].
extern "C" int tfrec_cross_v1_fwd(const void* x0, const void* w, const void* b,
                                  void* out, void* s_out, long long batch,
                                  long long d, long long layers, void* stream) {
  const float* px0 = static_cast<const float*>(x0);
  const float* pw = static_cast<const float*>(w);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  float* ps = static_cast<float*>(s_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d);
  const int li = static_cast<int>(layers);
  const int64_t per_thread = (d + kRowThreads - 1) / kRowThreads;
  if (d < 1 || per_thread > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (per_thread <= 1) launch_fwd<1>(px0, pw, pb, po, ps, batch, di, li, s);
  else if (per_thread <= 2) launch_fwd<2>(px0, pw, pb, po, ps, batch, di, li, s);
  else if (per_thread <= 4) launch_fwd<4>(px0, pw, pb, po, ps, batch, di, li, s);
  else if (per_thread <= 8) launch_fwd<8>(px0, pw, pb, po, ps, batch, di, li, s);
  else if (per_thread <= 16) launch_fwd<16>(px0, pw, pb, po, ps, batch, di, li, s);
  else launch_fwd<32>(px0, pw, pb, po, ps, batch, di, li, s);
  return static_cast<int>(cudaGetLastError());
}

// x0 and g [batch, d] f32, w and b [layers, d] f32, s [batch, layers] f32
// (the forward's row scalars); writes dx0 [batch, d], dw and db [layers, d]
// and uses partial [nblocks, 2, layers, d] as scratch, all contiguous on the
// current device; runs on `stream` (two launches). Returns the first
// launch error, or cudaErrorInvalidValue for d outside [1, 8192], nblocks
// < 1 or more than 227 KB of shared memory.
extern "C" int tfrec_cross_v1_bwd(const void* x0, const void* w, const void* b,
                                  const void* s, const void* g, void* dx0,
                                  void* dw, void* db, void* partial,
                                  long long batch, long long d, long long layers,
                                  long long nblocks, void* stream) {
  const float* px0 = static_cast<const float*>(x0);
  const float* pw = static_cast<const float*>(w);
  const float* pb = static_cast<const float*>(b);
  const float* ps = static_cast<const float*>(s);
  const float* pg = static_cast<const float*>(g);
  float* pdx0 = static_cast<float*>(dx0);
  float* pdw = static_cast<float*>(dw);
  float* pdb = static_cast<float*>(db);
  float* pp = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t per_thread = (d + kRowThreads - 1) / kRowThreads;
  if (d < 1 || per_thread > 32 || nblocks < 1 ||
      2 * layers * d * (long long)sizeof(float) > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int di = static_cast<int>(d);
  const int li = static_cast<int>(layers);
  const int nb = static_cast<int>(nblocks);
  if (per_thread <= 1) return launch_bwd<1>(px0, pw, pb, ps, pg, pdx0, pdw, pdb, pp, batch, di, li, nb, st);
  if (per_thread <= 2) return launch_bwd<2>(px0, pw, pb, ps, pg, pdx0, pdw, pdb, pp, batch, di, li, nb, st);
  if (per_thread <= 4) return launch_bwd<4>(px0, pw, pb, ps, pg, pdx0, pdw, pdb, pp, batch, di, li, nb, st);
  if (per_thread <= 8) return launch_bwd<8>(px0, pw, pb, ps, pg, pdx0, pdw, pdb, pp, batch, di, li, nb, st);
  if (per_thread <= 16) return launch_bwd<16>(px0, pw, pb, ps, pg, pdx0, pdw, pdb, pp, batch, di, li, nb, st);
  return launch_bwd<32>(px0, pw, pb, ps, pg, pdx0, pdw, pdb, pp, batch, di, li, nb, st);
}
