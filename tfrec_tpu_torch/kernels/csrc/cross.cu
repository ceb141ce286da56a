// DCN-v1 cross stack, forward and backward.
//
// Forward: for l in 0..L-1
//     s_l     = x_l . w_l                (one scalar per row)
//     x_{l+1} = x0 * s_l + b_l + x_l
// out = x_L; the per-row scalars s [B, L] are written too when asked for
// (the training forward saves them for the backward).
//
// Backward, with g = dL/dx_L. Let c_l = 1 + sum_{m<l} s_m and
// B_l = sum_{m<l} b_m, so that x_l = x0 * c_l + B_l. The reference walks
// the layers from the top down (ds = g_{l+1} . x0, dw_l = sum_batch x_l ds,
// db_l = sum_batch g_{l+1}, g_l = g_{l+1} + ds w_l); regrouped, a row needs
// L independent row dots,
//     q = x0 . g,    p_m = x0 . w_m      (m = 1..L-1)
// and then only scalars and elementwise work:
//     ds_{L-1} = q,  ds_l = q + sum_{m>l} ds_m p_m
//     dx0  = g c_L + sum_m (ds_m c_m) w_m
//     dw_l = sum_batch x0 (c_l ds_l) + B_l sum_batch ds_l
//     db_l = sum_batch g + sum_{m>l} (sum_batch ds_m) w_m
// so the batch sums are L + 1 columns (x0 weighted by c_l ds_l, and g) and
// L scalars (sum_batch ds_l), in place of the reference's 2L columns.
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
// with no atomics (block_sums), so runs repeat bit for bit. The update is
// written with __fmul_rn/__fadd_rn so the compiler does not fuse it into an
// FMA: it rounds as the plain PyTorch version does. A warp a row (K <= 64 a
// lane: 145 registers at d=845, so one block of 8 warps an SM) took
// 79.1-79.6 us at the flagship's shape against this kernel's 38.8-39.3 us
// (tools/ab_cross_v2.py, one call). Wider rows (d > 8192) take the
// streaming route: a block takes 2 rows at once, with the same per-thread
// order of each row dot, and keeps the running x in the output rows
// themselves (L passes over them, from L2) instead of in registers.
//
// Backward. Bound: bytes. It must read x0 and g and write dx0, 3*B*d*4
// bytes (83.1 MB at B=8192, d=845: 24.8 us at 3.35 TB/s); its ~12
// operations per element and layer are far below the balance. Design, for
// d <= 4096 and L <= 4: a persistent grid (as many blocks of 256 threads
// as fit an SM, at most kBwdMaxBlocksPerSM, each at least kBwdMinRows rows)
// walks the rows (row = blockIdx.x, + gridDim.x, ...). Thread t owns
// elements t, t+256, ... (K <= 16 of them) of every row:
//   - rows in flight: the thread copies its elements of x0 and g with 4-byte
//     cp.async (rows at odd d are not 16-byte aligned) into a ring of
//     bwd_stages rows in shared memory (4 at d <= 1024), all but one ahead
//     of the row it computes, and reads back only what it copied itself,
//     so the ring needs no barrier;
//   - one block reduction a row: the L row dots are reduced together as
//     one L-vector (a butterfly in each warp, then every thread adds the 8
//     warp sums in warp order from shared memory: one barrier), then every
//     thread runs the scalar recurrence for ds itself;
//   - dx0 is elementwise from registers and w (staged once in shared
//     memory, each thread its own elements); the L + 1 column sums and the
//     L scalars accumulate in registers.
// Each block ends by finishing its own dw and db, X_l + B_l D_l and
// G + sum_{m>l} D_m w_m over its rows, and writes them as a [2, L, d]
// partial; a second kernel sums the partials of all blocks in a fixed
// order. Wider rows or deeper stacks take the general route, three
// kernels: a block takes 4 rows at once and computes their row dots
// (kLayerChunk layers at a time) and per-row scalars (ds_l, c_l ds_l, c_L)
// into a scratch; then blocks of a column strip by a chunk of rows stream
// x0 and g down their columns, write dx0 and accumulate the same partials
// (a few layers a pass), which the same fixed-order sum finishes. These
// streaming routes re-read w (and, in the forward, b and the running x)
// from L2 in every layer pass: 2.9-3.9x their bounds at d=8333, L=4. No
// atomics anywhere, so runs repeat bit for bit. d is a 32-bit int: rows
// are at most 2^31 - 1 elements wide. The streaming kernels' column walks
// step past d by up to a few thousand, so they must not be signed 32-bit
// (that wraps near 2^31): the forward's are 64-bit, the backward's
// unsigned 32-bit (they stay below 2^31 + 2^12 < 2^32), the faster type
// for each in tools/ab_cross_v1.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;  // a block, which takes a row at a time
constexpr int kRowWarps = kRowThreads / 32;
// The streaming forward: elements a thread loads at once, and rows a block
// takes at once; and the grid of it and of the backward's row-scalar
// kernel, in blocks an SM.
constexpr int kStreamUnroll = 8;
constexpr int kStreamRows = 2;
constexpr int kStreamBlocksPerSM = 4;

// The N sums of p[0..N) over a block of kRowThreads threads, each in a
// fixed order: a butterfly inside each warp, then every thread adds the 8
// warp sums in warp order from shared memory. One barrier a call; red's
// two slots alternate (the other slot's last readers passed this barrier
// before anyone writes it again at the next call).
template <int N>
__device__ __forceinline__ void block_sums(float (&p)[N], float (&red)[2][N][kRowWarps], int& slot) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p[i] += __shfl_xor_sync(0xffffffffu, p[i], off);
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[slot][i][threadIdx.x >> 5] = p[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) sum += red[slot][i][w];
    p[i] = sum;
  }
  slot ^= 1;
}

// A block of kRowThreads threads a row (row = blockIdx.x, + gridDim.x, ...);
// thread t keeps elements t, t+256, ... (K of them) of x0 and of the running
// x in registers.
template <int K>
__global__ void __launch_bounds__(kRowThreads)
cross_v1_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out,
                    float* __restrict__ s_out, int64_t batch, int d, int layers) {
  __shared__ float red[2][1][kRowWarps];
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
      float p[1] = {0.0f};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = tid + kRowThreads * k;
        if (j < d) p[0] = fmaf(x[k], __ldg(wl + j), p[0]);
      }
      block_sums<1>(p, red, slot);
      const float s = p[0];
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

// The forward for rows too wide for registers: a block takes kStreamRows
// rows at once (so each element of w and b is read once for all of them),
// each thread the same elements as in cross_v1_fwd_kernel (j = t, t+256,
// ...) in the same order, so each row dot and update rounds as there. The
// running x lives in the output rows: a pass per layer writes x_{l+1}
// there and sums its dot with w_{l+1}; each thread reads back only what it
// wrote. A thread loads kStreamUnroll of its elements at once.
__global__ void __launch_bounds__(kRowThreads)
cross_v1_fwd_stream_kernel(const float* __restrict__ x0, const float* __restrict__ w,
                           const float* __restrict__ b, float* __restrict__ out,
                           float* __restrict__ s_out, int64_t batch, int d, int layers) {
  constexpr int U = kStreamUnroll;
  constexpr int RB = kStreamRows;
  __shared__ float red[2][RB][kRowWarps];
  const int tid = threadIdx.x;
  int slot = 0;
  for (int64_t row0 = (int64_t)blockIdx.x * RB; row0 < batch; row0 += (int64_t)gridDim.x * RB) {
    float p[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) p[r] = 0.0f;
    for (int64_t j0 = tid; j0 < d; j0 += kRowThreads * U) {
      float a[U][RB];
      float wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t j = j0 + kRowThreads * u;
        wv[u] = j < d && layers > 0 ? __ldg(w + j) : 0.0f;
#pragma unroll
        for (int r = 0; r < RB; ++r) a[u][r] = j < d && row0 + r < batch ? x0[(row0 + r) * d + j] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t j = j0 + kRowThreads * u;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (j < d && row0 + r < batch) {
            if (layers == 0) out[(row0 + r) * d + j] = a[u][r];
            else p[r] = fmaf(a[u][r], wv[u], p[r]);
          }
        }
      }
    }
    for (int l = 0; l < layers; ++l) {
      block_sums<RB>(p, red, slot);
      float sl[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        sl[r] = p[r];
        p[r] = 0.0f;
        if (s_out != nullptr && tid == 0 && row0 + r < batch) s_out[(row0 + r) * layers + l] = sl[r];
      }
      const float* prev = l == 0 ? x0 : out;
      const float* bl = b + (int64_t)l * d;
      const float* wn = w + (int64_t)(l + 1) * d;
      const bool more = l + 1 < layers;
      for (int64_t j0 = tid; j0 < d; j0 += kRowThreads * U) {
        float a[U][RB];
        float x[U][RB];
        float bv[U];
        float wv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t j = j0 + kRowThreads * u;
          bv[u] = j < d ? __ldg(bl + j) : 0.0f;
          wv[u] = j < d && more ? __ldg(wn + j) : 0.0f;
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const bool ok = j < d && row0 + r < batch;
            a[u][r] = ok ? x0[(row0 + r) * d + j] : 0.0f;
            x[u][r] = ok ? prev[(row0 + r) * d + j] : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t j = j0 + kRowThreads * u;
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (j < d && row0 + r < batch) {
              const float xn = __fadd_rn(__fadd_rn(__fmul_rn(a[u][r], sl[r]), bv[u]), x[u][r]);
              out[(row0 + r) * d + j] = xn;
              if (more) p[r] = fmaf(xn, wv[u], p[r]);
            }
          }
        }
      }
    }
  }
}

// The error of a failed call that launches nothing, returned after
// clearing it, so that the next launch's cudaGetLastError() does not
// report it again.
int failed(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

// The current device's SM count, into *sms; returns the CUDA error.
int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? 0 : failed(err);
}

template <int K>
void launch_fwd(const float* x0, const float* w, const float* b, float* out,
                float* s_out, int64_t batch, int d, int layers, int sms, cudaStream_t s) {
  const int64_t max_blocks = (int64_t)sms * 8;  // grid-stride beyond this
  int64_t blocks = batch < max_blocks ? batch : max_blocks;
  if (blocks < 1) blocks = 1;
  cross_v1_fwd_kernel<K><<<(unsigned)blocks, kRowThreads, 0, s>>>(
      x0, w, b, out, s_out, batch, d, layers);
}

// ---- Backward ----

constexpr int kBwdMaxBlocksPerSM = 4;  // the persistent grid's blocks an SM, at most
constexpr int kBwdMinRows = 16;        // rows a block, at least
// The general route: the scalars kernel's layers a pass, rows a block
// takes at once, and elements of each a thread loads at once; the columns
// kernel's columns a thread and blocks an SM (as many as fit).
constexpr int kLayerChunk = 8;
constexpr int kScalarsRows = 4;
constexpr int kScalarsUnroll = 2;
constexpr int kColumnsPerThread = 4;
constexpr int kColumnsBlocksPerSM = 2;
constexpr int64_t kColumnsPartialFloats = 1 << 22;  // partials, at most (unless 8 chunks need more)

// The ring's depth: stages of x0 and g (2*d floats a row), all but one
// copied ahead of the row a block computes; fewer for wider rows, where
// fewer blocks fit an SM.
template <int K>
__host__ __device__ constexpr int bwd_stages() { return K <= 4 ? 4 : (K <= 8 ? 3 : 2); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Thread t's elements of x0 and g of `row` into a ring stage ([x0 row, g
// row], 2*d floats); a group is committed even past the batch, so that the
// count of pending groups stays one a ring slot.
template <int K>
__device__ __forceinline__ void copy_row(float* stage, const float* __restrict__ x0,
                                         const float* __restrict__ g, int64_t row,
                                         int64_t batch, int d) {
  if (row < batch) {
    const float* xr = x0 + row * d;
    const float* gr = g + row * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = threadIdx.x + kRowThreads * k;
      if (j < d) {
        cp_async4(stage + j, xr + j);
        cp_async4(stage + d + j, gr + j);
      }
    }
  }
  cp_async_commit();
}

// The fast route: d <= 256*K, L layers. Dynamic shared memory: w [L, d],
// then bwd_stages<K>() ring stages of [x0 row, g row]. Writes this block's
// partial [2, L, d] (dw then db over its rows).
template <int K, int L>
__global__ void __launch_bounds__(kRowThreads)
cross_v1_bwd_kernel(const float* __restrict__ x0, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ s,
                    const float* __restrict__ g_in, float* __restrict__ dx0,
                    float* __restrict__ partial, int64_t batch, int d) {
  constexpr int S = bwd_stages<K>();
  extern __shared__ float smem[];
  __shared__ float red[2][L][kRowWarps];
  float* ws = smem;
  float* ring = smem + (int64_t)L * d;
  const int tid = threadIdx.x;
  const int64_t stride = gridDim.x;
  // Each thread stages its own elements of w and reads only those.
#pragma unroll
  for (int m = 0; m < L; ++m) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + kRowThreads * k;
      if (j < d) ws[m * d + j] = __ldg(w + (int64_t)m * d + j);
    }
  }
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    copy_row<K>(ring + i * 2 * d, x0, g_in, blockIdx.x + i * stride, batch, d);
  }
  float xs[L][K];  // sum over rows of x0 * c_l ds_l
  float gs[K];     // sum over rows of g
  float dsum[L];   // sum over rows of ds_l (every thread the same)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    gs[k] = 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l) xs[l][k] = 0.0f;
  }
#pragma unroll
  for (int l = 0; l < L; ++l) dsum[l] = 0.0f;
  float sv[L];  // this row's s, loaded a row ahead
#pragma unroll
  for (int l = 0; l < L; ++l) sv[l] = __ldg(s + blockIdx.x * L + l);  // blockIdx.x < batch
  int slot = 0;
  int stage = 0;
  for (int64_t row = blockIdx.x; row < batch; row += stride) {
    copy_row<K>(ring + ((stage + S - 1) % S) * 2 * d, x0, g_in, row + (S - 1) * stride, batch, d);
    cp_async_wait<S - 1>();
    const float* st = ring + stage * 2 * d;
    float a[K];
    float gv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + kRowThreads * k;
      a[k] = j < d ? st[j] : 0.0f;
      gv[k] = j < d ? st[d + j] : 0.0f;
    }
    // dot[0] = q = x0 . g, dot[m] = p_m = x0 . w_m (m >= 1); 0 past d.
    float dot[L];
#pragma unroll
    for (int m = 0; m < L; ++m) dot[m] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + kRowThreads * k;
      dot[0] = fmaf(a[k], gv[k], dot[0]);
      if (j < d) {
#pragma unroll
        for (int m = 1; m < L; ++m) dot[m] = fmaf(a[k], ws[m * d + j], dot[m]);
      }
    }
    const int64_t next = row + stride;
    float sn[L];
#pragma unroll
    for (int l = 0; l < L; ++l) sn[l] = next < batch ? __ldg(s + next * L + l) : 0.0f;
    block_sums<L>(dot, red, slot);
    float ds[L];
    ds[L - 1] = dot[0];
    float run = 0.0f;
#pragma unroll
    for (int l = L - 2; l >= 0; --l) {
      run = fmaf(ds[l + 1], dot[l + 1], run);
      ds[l] = dot[0] + run;
    }
    float e[L];  // c_l ds_l
    float c = 1.0f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      e[l] = c * ds[l];
      c += sv[l];
      dsum[l] += ds[l];
    }
    float* dr = dx0 + row * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + kRowThreads * k;
      if (j < d) {
        float v = gv[k] * c;  // c = c_L here
#pragma unroll
        for (int m = 0; m < L; ++m) v = fmaf(e[m], ws[m * d + j], v);
        dr[j] = v;
      }
      gs[k] += gv[k];
#pragma unroll
      for (int l = 0; l < L; ++l) xs[l][k] = fmaf(a[k], e[l], xs[l][k]);
    }
#pragma unroll
    for (int l = 0; l < L; ++l) sv[l] = sn[l];
    stage = stage + 1 == S ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  float* pdw = partial + (int64_t)blockIdx.x * 2 * L * d;
  float* pdb = pdw + (int64_t)L * d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + kRowThreads * k;
    if (j < d) {
      float bsum = 0.0f;  // B_l
#pragma unroll
      for (int l = 0; l < L; ++l) {
        pdw[l * d + j] = fmaf(bsum, dsum[l], xs[l][k]);
        bsum += __ldg(b + (int64_t)l * d + j);
      }
      float run = gs[k];
#pragma unroll
      for (int l = L - 1; l >= 0; --l) {
        pdb[l * d + j] = run;
        run = fmaf(dsum[l], ws[l * d + j], run);
      }
    }
  }
}

// The general route, first kernel: a block takes kScalarsRows rows at
// once (so each element of w is read once for all of them) and computes
// their L dots (q and p_m), kLayerChunk at a time with one barrier each;
// then thread r runs row r's recurrence and writes its scalars: ds [B, L],
// e = c_l ds_l [B, L] and c_L [B]; dots [B, L] is its own scratch.
__global__ void __launch_bounds__(kRowThreads)
cross_v1_bwd_scalars_kernel(const float* __restrict__ x0, const float* __restrict__ w,
                            const float* __restrict__ s, const float* __restrict__ g,
                            float* __restrict__ dots, float* __restrict__ ds_out,
                            float* __restrict__ e_out, float* __restrict__ cl_out,
                            int64_t batch, int d, int layers) {
  constexpr int RB = kScalarsRows;
  constexpr int C = kLayerChunk;
  __shared__ float red[2][RB * C][kRowWarps];
  const int tid = threadIdx.x;
  int slot = 0;
  for (int64_t row0 = (int64_t)blockIdx.x * RB; row0 < batch; row0 += (int64_t)gridDim.x * RB) {
    for (int c0 = 0; c0 < layers; c0 += C) {
      float p[RB * C];  // p[r*C + i]: row r's dot i of this chunk
#pragma unroll
      for (int i = 0; i < RB * C; ++i) p[i] = 0.0f;
      for (unsigned j0 = tid; j0 < d; j0 += kRowThreads * kScalarsUnroll) {
        float wv[kScalarsUnroll][C];
        float a[kScalarsUnroll][RB];
        float gv[kScalarsUnroll][RB];
#pragma unroll
        for (int u = 0; u < kScalarsUnroll; ++u) {
          const unsigned j = j0 + kRowThreads * u;
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const int m = c0 + i;
            wv[u][i] = j < d && m >= 1 && m < layers ? __ldg(w + (int64_t)m * d + j) : 0.0f;
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const bool ok = j < d && row0 + r < batch;
            a[u][r] = ok ? x0[(row0 + r) * d + j] : 0.0f;
            gv[u][r] = ok && c0 == 0 ? g[(row0 + r) * d + j] : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kScalarsUnroll; ++u) {
#pragma unroll
          for (int r = 0; r < RB; ++r) {
#pragma unroll
            for (int i = 0; i < C; ++i) {
              p[r * C + i] = fmaf(a[u][r], i == 0 && c0 == 0 ? gv[u][r] : wv[u][i], p[r * C + i]);
            }
          }
        }
      }
      block_sums<RB * C>(p, red, slot);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (tid == r && row0 + r < batch) {
#pragma unroll
          for (int i = 0; i < C; ++i) {
            if (c0 + i < layers) dots[(row0 + r) * layers + c0 + i] = p[r * C + i];
          }
        }
      }
    }
    const int64_t row = row0 + tid;
    if (tid < RB && row < batch) {
      const float* dr = dots + row * layers;
      float* dsr = ds_out + row * layers;
      float* er = e_out + row * layers;
      const float* sr = s + row * layers;
      const float q = dr[0];
      dsr[layers - 1] = q;
      float run = 0.0f;
      float next = q;  // ds_{l+1}
      for (int l = layers - 2; l >= 0; --l) {
        run = fmaf(next, dr[l + 1], run);
        next = q + run;
        dsr[l] = next;
      }
      float c = 1.0f;
      for (int l = 0; l < layers; ++l) {
        er[l] = c * dsr[l];
        c += sr[l];
      }
      cl_out[row] = c;
    }
  }
}

// The general route, second kernel: block (x, y) takes columns x*W ..
// x*W + W - 1 (W = 256 * KC; thread t the columns t, t+256, ...) of rows
// y*rows .. (y+1)*rows - 1, and walks them down the rows, U rows' loads at
// once, C layers a pass: dx0 (written in the first pass, added to in the
// later ones), the column sums, and the block's partial [2, L, d] as in
// the fast route. The db half holds D_l w_l until the last pass turns it
// into suffix sums. One instance, KC = 4 columns a thread (a row's 4 KB a
// block), C = 4 layers a pass and U = 4 rows' loads at once: the best of
// the variants tools/ab_cross_v1.py tried at d=8333, L=4.
template <int KC, int C, int U>
__global__ void __launch_bounds__(kRowThreads)
cross_v1_bwd_columns_kernel(const float* __restrict__ x0, const float* __restrict__ w,
                            const float* __restrict__ b, const float* __restrict__ g,
                            const float* __restrict__ ds, const float* __restrict__ e,
                            const float* __restrict__ cl, float* __restrict__ dx0,
                            float* __restrict__ partial, int64_t batch, int d, int layers,
                            int64_t rows) {
  const unsigned j0 = blockIdx.x * kRowThreads * KC + threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.y * rows;
  const int64_t r1 = r0 + rows < batch ? r0 + rows : batch;
  if (j0 >= d) return;  // no barrier below
  const int64_t width = (int64_t)layers * d;
  float* pdw = partial + (int64_t)blockIdx.y * 2 * width;
  float* pdb = pdw + width;
  float gsum[KC];
  float bsum[KC];  // B_l
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    gsum[k] = 0.0f;
    bsum[k] = 0.0f;
  }
  for (int c0 = 0; c0 < layers; c0 += C) {
    const int n = layers - c0 < C ? layers - c0 : C;
    float wr[C][KC];
    float xs[C][KC];
    float dsum[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      dsum[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const unsigned j = j0 + kRowThreads * k;
        wr[i][k] = i < n && j < d ? __ldg(w + (int64_t)(c0 + i) * d + j) : 0.0f;
        xs[i][k] = 0.0f;
      }
    }
    for (int64_t rb = r0; rb < r1; rb += U) {
      float a[U][KC];
      float v[U][KC];  // g, or dx0 so far
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t r = rb + u;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const unsigned j = j0 + kRowThreads * k;
          const bool ok = r < r1 && j < d;
          a[u][k] = ok ? x0[r * d + j] : 0.0f;
          v[u][k] = ok ? (c0 == 0 ? g[r * d + j] : dx0[r * d + j]) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t r = rb + u;
        if (r >= r1) break;
        float ev[C];
#pragma unroll
        for (int i = 0; i < C; ++i) {
          ev[i] = i < n ? __ldg(e + r * layers + c0 + i) : 0.0f;
          if (i < n) dsum[i] += __ldg(ds + r * layers + c0 + i);
        }
        const float clr = c0 == 0 ? __ldg(cl + r) : 0.0f;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const unsigned j = j0 + kRowThreads * k;
          float y = v[u][k];
          if (c0 == 0) {
            gsum[k] += v[u][k];
            y = v[u][k] * clr;
          }
#pragma unroll
          for (int i = 0; i < C; ++i) {
            if (i < n) {
              xs[i][k] = fmaf(a[u][k], ev[i], xs[i][k]);
              y = fmaf(ev[i], wr[i][k], y);
            }
          }
          if (j < d) dx0[r * d + j] = y;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const unsigned j = j0 + kRowThreads * k;
      if (j >= d) break;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (i < n) {
          const int64_t at = (int64_t)(c0 + i) * d + j;
          pdw[at] = fmaf(bsum[k], dsum[i], xs[i][k]);
          bsum[k] += __ldg(b + at);
          pdb[at] = dsum[i] * wr[i][k];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const unsigned j = j0 + kRowThreads * k;
    if (j >= d) break;
    float run = gsum[k];
    for (int l = layers - 1; l >= 0; --l) {
      const int64_t at = (int64_t)l * d + j;
      const float t = pdb[at];
      pdb[at] = run;
      run += t;
    }
  }
}

// out[e] = sum over blocks of partial[block][e], e < 2*width, blocks in
// order: a block of 32x16 threads takes 32 columns; thread row y sums the
// partials y, y+16, ... in order, then row 0 adds the 16 row sums in order.
constexpr int kSumCols = 32;
constexpr int kSumRows = 16;

__global__ void __launch_bounds__(kSumCols * kSumRows)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                    float* __restrict__ db, int64_t nblocks, int64_t width) {
  __shared__ float rows[kSumRows][kSumCols];
  const int tx = threadIdx.x % kSumCols;
  const int ty = threadIdx.x / kSumCols;
  const int64_t e = (int64_t)blockIdx.x * kSumCols + tx;
  const int64_t total = 2 * width;
  float sum = 0.0f;
  if (e < total) {
#pragma unroll 8
    for (int64_t blk = ty; blk < nblocks; blk += kSumRows) {
      sum += __ldg(partial + blk * total + e);
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

struct BwdArgs {
  const float* x0;
  const float* w;
  const float* b;
  const float* s;
  const float* g;
  float* dx0;
  float* dw;
  float* db;
  float* scratch;
  int64_t scratch_floats;
  int64_t batch;
  int d;
  int layers;
  cudaStream_t stream;
};

int launch_sum(const BwdArgs& a, int64_t nblocks, const float* partial) {
  const int64_t width = (int64_t)a.layers * a.d;
  const int64_t blocks = (2 * width + kSumCols - 1) / kSumCols;
  sum_partials_kernel<<<(unsigned)blocks, kSumCols * kSumRows, 0, a.stream>>>(
      partial, a.dw, a.db, nblocks, width);
  return static_cast<int>(cudaGetLastError());
}

// The fast route's plan (*need: scratch floats) and, with `launch`, its
// two launches. The grid depends only on the shape and the device.
template <int K, int L>
int bwd_fast(const BwdArgs& a, bool launch, int64_t* need) {
  const size_t smem = (size_t)(L + 2 * bwd_stages<K>()) * a.d * sizeof(float);
  // Past 48 KB (with the static reduction slots) only after this opt-in.
  cudaError_t err = cudaFuncSetAttribute(cross_v1_bwd_kernel<K, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return failed(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cross_v1_bwd_kernel<K, L>,
                                                      kRowThreads, smem);
  if (err != cudaSuccess) return failed(err);
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  per_sm = per_sm < 1 ? 1 : (per_sm > kBwdMaxBlocksPerSM ? kBwdMaxBlocksPerSM : per_sm);
  int64_t blocks = (a.batch + kBwdMinRows - 1) / kBwdMinRows;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  if (blocks < 1) blocks = 1;
  *need = blocks * 2 * L * a.d;
  if (!launch) return 0;
  if (a.scratch_floats < *need) return static_cast<int>(cudaErrorInvalidValue);
  cross_v1_bwd_kernel<K, L><<<(unsigned)blocks, kRowThreads, smem, a.stream>>>(
      a.x0, a.w, a.b, a.s, a.g, a.dx0, a.scratch, a.batch, a.d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum(a, blocks, a.scratch);
}

template <int K>
int bwd_fast_k(const BwdArgs& a, bool launch, int64_t* need) {
  switch (a.layers) {
    case 1: return bwd_fast<K, 1>(a, launch, need);
    case 2: return bwd_fast<K, 2>(a, launch, need);
    case 3: return bwd_fast<K, 3>(a, launch, need);
    default: return bwd_fast<K, 4>(a, launch, need);
  }
}

// The general route's plan and launches: scratch = dots, ds, e [B, L],
// c_L [B], then the partials [chunks, 2, L, d]; about kBwdMaxBlocksPerSM
// column blocks an SM.
int bwd_general(const BwdArgs& a, bool launch, int64_t* need) {
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const int64_t strip = (int64_t)kRowThreads * kColumnsPerThread;
  const int64_t strips = (a.d + strip - 1) / strip;
  int64_t chunks = ((int64_t)sms * kColumnsBlocksPerSM + strips - 1) / strips;
  const int64_t most = (a.batch + kBwdMinRows - 1) / kBwdMinRows;
  const int64_t small = kColumnsPartialFloats / (2 * a.layers * (int64_t)a.d);
  if (chunks > small) chunks = small > 8 ? small : 8;
  if (chunks > most) chunks = most;
  if (chunks > 65535) chunks = 65535;
  if (chunks < 1) chunks = 1;
  const int64_t rows = (a.batch + chunks - 1) / chunks;
  chunks = (a.batch + rows - 1) / rows;
  const int64_t per_row = a.batch * a.layers;
  const int64_t scalars = 3 * per_row + a.batch;
  *need = scalars + chunks * 2 * a.layers * (int64_t)a.d;
  if (!launch) return 0;
  if (a.scratch_floats < *need) return static_cast<int>(cudaErrorInvalidValue);
  float* dots = a.scratch;
  float* ds = dots + per_row;
  float* e = ds + per_row;
  float* cl = e + per_row;
  float* partial = a.scratch + scalars;
  const int64_t groups = (a.batch + kScalarsRows - 1) / kScalarsRows;
  const int64_t resident = (int64_t)sms * kStreamBlocksPerSM;
  const int64_t row_blocks = groups < resident ? groups : resident;
  cross_v1_bwd_scalars_kernel<<<(unsigned)row_blocks, kRowThreads, 0, a.stream>>>(
      a.x0, a.w, a.s, a.g, dots, ds, e, cl, a.batch, a.d, a.layers);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)strips, (unsigned)chunks);
  cross_v1_bwd_columns_kernel<kColumnsPerThread, 4, 4><<<grid, kRowThreads, 0, a.stream>>>(
      a.x0, a.w, a.b, a.g, ds, e, cl, a.dx0, partial, a.batch, a.d, a.layers, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum(a, chunks, partial);
}

// Chooses the route by shape: the fast one for d <= 4096 and 1 <= L <= 4.
int bwd(const BwdArgs& a, bool launch, int64_t* need) {
  if (a.batch < 1 || a.d < 1 || a.layers < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_thread = ((int64_t)a.d + kRowThreads - 1) / kRowThreads;
  if (a.layers > 4 || per_thread > 16) return bwd_general(a, launch, need);
  if (per_thread <= 1) return bwd_fast_k<1>(a, launch, need);
  if (per_thread <= 2) return bwd_fast_k<2>(a, launch, need);
  if (per_thread <= 4) return bwd_fast_k<4>(a, launch, need);
  if (per_thread <= 8) return bwd_fast_k<8>(a, launch, need);
  return bwd_fast_k<16>(a, launch, need);
}

}  // namespace

// x0 [batch, d] f32, w and b [layers, d] f32, out [batch, d] f32, s_out
// [batch, layers] f32 or null, all contiguous on the current device; runs
// on `stream`. Rows of up to 8192 elements stay in registers; wider ones
// take the streaming kernel. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for d outside [1, 2^31 - 1].
extern "C" int tfrec_cross_v1_fwd(const void* x0, const void* w, const void* b,
                                  void* out, void* s_out, long long batch,
                                  long long d, long long layers, void* stream) {
  const float* px0 = static_cast<const float*>(x0);
  const float* pw = static_cast<const float*>(w);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  float* ps = static_cast<float*>(s_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int di = static_cast<int>(d);
  const int li = static_cast<int>(layers);
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const int64_t per_thread = (d + kRowThreads - 1) / kRowThreads;
  if (per_thread <= 1) launch_fwd<1>(px0, pw, pb, po, ps, batch, di, li, sms, s);
  else if (per_thread <= 2) launch_fwd<2>(px0, pw, pb, po, ps, batch, di, li, sms, s);
  else if (per_thread <= 4) launch_fwd<4>(px0, pw, pb, po, ps, batch, di, li, sms, s);
  else if (per_thread <= 8) launch_fwd<8>(px0, pw, pb, po, ps, batch, di, li, sms, s);
  else if (per_thread <= 16) launch_fwd<16>(px0, pw, pb, po, ps, batch, di, li, sms, s);
  else if (per_thread <= 32) launch_fwd<32>(px0, pw, pb, po, ps, batch, di, li, sms, s);
  else {
    const int64_t max_blocks = (int64_t)sms * kStreamBlocksPerSM;  // rows in flight, their x in L2
    const int64_t groups = (batch + kStreamRows - 1) / kStreamRows;
    const int64_t blocks = groups < max_blocks ? (groups < 1 ? 1 : groups) : max_blocks;
    cross_v1_fwd_stream_kernel<<<(unsigned)blocks, kRowThreads, 0, s>>>(
        px0, pw, pb, po, ps, batch, di, li);
  }
  return static_cast<int>(cudaGetLastError());
}

// The scratch, in floats, that tfrec_cross_v1_bwd needs for this shape on
// the current device, into *floats. Returns 0, a CUDA error, or
// cudaErrorInvalidValue for batch, d or layers below 1 or d past 2^31 - 1.
extern "C" int tfrec_cross_v1_bwd_scratch(long long batch, long long d, long long layers,
                                          long long* floats) {
  if (d > INT32_MAX || layers > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  a.batch = batch;
  a.d = static_cast<int>(d);
  a.layers = static_cast<int>(layers);
  int64_t need = 0;
  const int rc = bwd(a, false, &need);
  *floats = need;
  return rc;
}

// x0 and g [batch, d] f32, w and b [layers, d] f32, s [batch, layers] f32
// (the forward's row scalars); writes dx0 [batch, d], dw and db [layers, d],
// using `scratch` (scratch_floats f32, at least tfrec_cross_v1_bwd_scratch's
// count), all contiguous on the current device; runs on `stream` (two
// launches, three on the general route). Returns the first launch error,
// or cudaErrorInvalidValue for batch, d or layers below 1, d past 2^31 - 1
// or too small a scratch.
extern "C" int tfrec_cross_v1_bwd(const void* x0, const void* w, const void* b,
                                  const void* s, const void* g, void* dx0,
                                  void* dw, void* db, void* scratch,
                                  long long scratch_floats, long long batch,
                                  long long d, long long layers, void* stream) {
  if (d > INT32_MAX || layers > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{static_cast<const float*>(x0), static_cast<const float*>(w),
            static_cast<const float*>(b),  static_cast<const float*>(s),
            static_cast<const float*>(g),  static_cast<float*>(dx0),
            static_cast<float*>(dw),       static_cast<float*>(db),
            static_cast<float*>(scratch),  scratch_floats, batch,
            static_cast<int>(d),           static_cast<int>(layers),
            static_cast<cudaStream_t>(stream)};
  int64_t need = 0;
  return bwd(a, true, &need);
}
