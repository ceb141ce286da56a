// DCN-v2 low-rank cross stack, forward and backward.
//
// Forward: for l in 0..L-1, with U_l and V_l [d, r] and b_l [d]
//     xv_l    = x_l V_l                  ([B, r])
//     f_l     = xv_l U_l^T + b_l         ([B, d])
//     x_{l+1} = x0 * f_l + x_l
// out = x_L. For training it also writes f [L, B, d] and xv [L, B, r].
//
// Backward, from the top layer down, with g = dL/dx_L:
//     df    = g * x0
//     db_l  = sum_batch df
//     t     = df U_l                     ([B, r])
//     dU_l  = df^T xv_l                  ([d, r])
//     dV_l  = x_l^T t                    ([d, r])
//     dx0  += g * f_l
//     g    += t V_l^T                    (the gradient with respect to x_l)
// and finally dx0 += g.
//
// Replaces the TPU kernels of tfrec_tpu/kernels/cross_pallas.py
// cross_stack_pallas_v2: the forward (_cross_v2_fwd_impl, body
// _fwd_kernel_v2) and the backward (_cross_v2_bwd_rule, body
// _bwd_kernel_v2). The TPU wrapper pads d and r to 128 lanes (_v2_prep);
// these kernels take the unpadded shapes.
//
// Bound: operations, in f32 on the CUDA cores. Each layer is two products
// of 2*B*d*r operations in the forward and four in the backward (B=8192,
// d=845, r=64, L=3: 5.38 GFLOP forward, 80 us at 67 TFLOP/s, against 56.7
// MB of x0, x_L and weights, 17 us at 3.35 TB/s; 10.6 GFLOP backward,
// 159 us). No tensor cores (no TF32, no mma): the plain version these are
// held to runs f32 with TF32 off.
//
// Forward design (cross_v2_fwd_kernel). A block of 256 threads holds a tile
// of 16 rows of x0 and of the running x in shared memory across all L
// layers, as the TPU kernel keeps x resident in VMEM, so device memory is
// read once for x0 and written once for x_L. Rows are stored with a stride
// of d rounded up to 4 (zero padded) so that the products read them as
// 16-byte vectors; d = 845 is odd, so the loads from device memory are
// scalar and coalesced. Per layer: xv = x V_l into a [16, r] buffer, then
// f = xv U_l^T + b_l and x = x0 * f + x in place (tile_times_w and
// tile_times_wt below: an 8 x 4 block of outputs a thread, weights read
// from L2 one step ahead of their use). The wrapper hands V zero padded and U
// transposed and zero padded, so that neighbouring threads read
// neighbouring addresses and no load is masked. Two blocks fit an SM
// (110 KB of shared memory and at most 128 registers a thread each). Every
// sum runs in a fixed order, with no atomics, so runs repeat bit for bit;
// the elementwise steps use _rn intrinsics, which the compiler does not
// fuse into FMAs, and round as the plain version does.
//
// Backward design. The forward saved f [L, B, d] and xv [L, B, r] (83 MB
// and 6.3 MB at B=8192, d=845, r=64, L=3, written once), so the backward
// replays no product: the TPU kernel's replay would cost 2 more products a
// layer, 5.3 GFLOP in all. x_l is rebuilt elementwise from x0 and f exactly
// as the forward rounded it. Three kernels:
// - cross_v2_bwd_rows_kernel: the per-row chain (df, t, dx0, g), a tile of
//   16 rows a block with g and df in shared memory, as the forward (t = df
//   U_l from U padded, g += t V_l^T from V transposed and padded); it
//   writes df [L, B, d] and t [L, B, r] for the weight pass, and keeps dx0
//   in its output, each element read and written by one thread. The
//   elementwise steps of a layer (dx0, and the next layer's df) run in the
//   epilogue of g += t V^T, by the thread that owns the column.
// - cross_v2_bwd_weights_kernel: dU, dV and db, sums over the batch. A
//   [2, L, d, r] partial a row block would take 1.3 MB a block, so instead a
//   block owns a 64 x 64 tile of one layer's [d, r] outputs and walks a
//   fixed chunk of the batch in row order (32 rows staged in shared memory
//   at a time); a thread keeps 16 sums of dU and 16 of dV in registers.
// - sum_chunks_kernel: adds the chunks' partials in chunk order.
// No atomics anywhere, so the gradients repeat bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;  // rows a block of the forward and the row pass holds
constexpr int kRows = 8;  // rows of a thread's block of outputs in the products
// tile_times_w: kSplit lanes share each block of outputs, summing every
// kSplit-th group of 4 j; 16 groups of 4 k cover 64 k.
constexpr int kSplit = kThreads / 16 / (kTile / kRows);
static_assert(kSplit >= 1 && kSplit <= 32 && (kSplit & (kSplit - 1)) == 0, "kSplit lanes of a warp");
constexpr int kWThreads = 256;  // weight pass: threads a block
constexpr int kWTile = 64;  // weight pass: a 64 (j of d) x 64 (k of r) tile
constexpr int kWRows = 32;  // weight pass: rows staged at a time
constexpr int kWk = kWTile / (kWThreads / kWTile);  // k a thread sums: 16
constexpr int kStage = kWRows * kWTile / kWThreads;  // rows a thread stages: 8
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on Hopper

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

size_t tile_smem_bytes(int d, int r) {
  return ((size_t)2 * kTile * round4(d) + (size_t)kTile * round4(r)) * sizeof(float);
}

// The two products of a layer, on a tile of kTile = 16 rows held in shared
// memory. Both give a thread a kRows x 4 block of outputs, so that each
// 16-byte load of a weight feeds 4 * kRows FMAs (the loads into the SM,
// not the FMAs, limit these loops), and both read the weights, which come
// from L2, one step ahead of their use. The weights are zero padded (the
// wrapper's layouts), so no load is masked: V and U as [L, d, r4], and U^T
// and V^T as [L, r4, d4], with d4 = round4(d) and r4 = round4(r).

// out[t][k] = sum_{j<d} s[t][j] * w[j][k] for the tile's rows and k < r4;
// s is [kTile][d4] in shared memory (zero past d), w one layer's [d, r4],
// out [kTile][r4] in shared memory. A thread owns kRows rows and k..k+3,
// and sums every kSplit-th group of 4 j (split = lane % kSplit, j
// ascending); the kSplit lanes then add their sums in a butterfly, in
// which both partners add the same two values, so every sum has one fixed
// order and all the lanes hold it.
__device__ void tile_times_w(const float* __restrict__ s, int d4,
                             const float* __restrict__ w, int d, int r4,
                             float* __restrict__ out) {
  const int split = threadIdx.x % kSplit;
  const int t0 = threadIdx.x / (kSplit * 16) * kRows;
  const unsigned group =  // the kSplit lanes of this block of outputs
      (kSplit == 32 ? 0xFFFFFFFFu : (1u << kSplit) - 1) << (threadIdx.x & 31 & ~(kSplit - 1));
  for (int k = threadIdx.x / kSplit % 16 * 4; k < r4; k += 64) {
    float acc[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    }
    float4 wv[4], wn[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * split + q;
      wv[q] = j < d ? __ldg(reinterpret_cast<const float4*>(w + (int64_t)j * r4 + k))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int j0 = 4 * split; j0 < d4; j0 += 4 * kSplit) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + 4 * kSplit + q;
        wn[q] = j < d ? __ldg(reinterpret_cast<const float4*>(w + (int64_t)j * r4 + k))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(s + (t0 + i) * d4 + j0);
        const float xq[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(xq[q], wv[q].x, acc[i][0]);
          acc[i][1] = fmaf(xq[q], wv[q].y, acc[i][1]);
          acc[i][2] = fmaf(xq[q], wv[q].z, acc[i][2]);
          acc[i][3] = fmaf(xq[q], wv[q].w, acc[i][3]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q] = wn[q];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int off = 1; off < kSplit; off <<= 1) {
          acc[i][c] += __shfl_xor_sync(group, acc[i][c], off);
        }
      }
    }
    if (split == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        *reinterpret_cast<float4*>(out + (t0 + i) * r4 + k) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
}

// For the tile's rows t and columns j < d: epi(t, j, sum_{k<r4} a[t][k] *
// wt[k][j]); a is [kTile][r4] in shared memory (zero past r), wt one
// layer's [r4, d4] (a weight transposed, so that neighbouring threads read
// neighbouring j). A thread owns kRows rows and j..j+3, k ascending.
template <typename Epilogue>
__device__ void tile_times_wt(const float* __restrict__ a, int r4,
                              const float* __restrict__ wt, int d4, int d, Epilogue epi) {
  const int nj = d4 / 4;
  for (int item = threadIdx.x; item < kTile / kRows * nj; item += blockDim.x) {
    const int t0 = item / nj * kRows;
    const int j = item % nj * 4;
    float acc[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    }
    float4 wv[4], wn[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wv[q] = __ldg(reinterpret_cast<const float4*>(wt + (int64_t)q * d4 + j));
    for (int k = 0; k < r4; k += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wn[q] = k + 4 < r4 ? __ldg(reinterpret_cast<const float4*>(wt + (int64_t)(k + 4 + q) * d4 + j))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(a + (t0 + i) * r4 + k);
        const float xq[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(xq[q], wv[q].x, acc[i][0]);
          acc[i][1] = fmaf(xq[q], wv[q].y, acc[i][1]);
          acc[i][2] = fmaf(xq[q], wv[q].z, acc[i][2]);
          acc[i][3] = fmaf(xq[q], wv[q].w, acc[i][3]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q] = wn[q];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j + c < d) epi(t0 + i, j + c, acc[i][c]);
      }
    }
  }
}

// Dynamic shared memory: x0 and x [kTile][d4], xv [kTile][r4].
__global__ void __launch_bounds__(kThreads, 2)
cross_v2_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ v4,
                    const float* __restrict__ ut4, const float* __restrict__ b,
                    float* __restrict__ out, float* __restrict__ f_out,
                    float* __restrict__ xv_out, int64_t batch, int d, int r,
                    int layers) {
  extern __shared__ float4 smem4[];
  float* sx0 = reinterpret_cast<float*>(smem4);
  const int d4 = round4(d);
  const int r4 = round4(r);
  float* sx = sx0 + kTile * d4;
  float* sxv = sx + kTile * d4;
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  for (int e = threadIdx.x; e < kTile * d4; e += blockDim.x) {
    const int t = e / d4;
    const int j = e % d4;
    const float val = j < d && row0 + t < batch ? x0[(row0 + t) * d + j] : 0.0f;
    sx0[e] = val;
    sx[e] = val;
  }
  __syncthreads();
  for (int l = 0; l < layers; ++l) {
    tile_times_w(sx, d4, v4 + (int64_t)l * d * r4, d, r4, sxv);  // xv = x V_l
    __syncthreads();
    if (xv_out != nullptr) {
      for (int e = threadIdx.x; e < kTile * r; e += blockDim.x) {
        const int t = e / r;
        if (row0 + t < batch) {
          xv_out[((int64_t)l * batch + row0 + t) * r + e % r] = sxv[t * r4 + e % r];
        }
      }
    }
    const float* bl = b + (int64_t)l * d;
    // f = xv U_l^T + b_l, then x = x0 * f + x.
    tile_times_wt(sxv, r4, ut4 + (int64_t)l * r4 * d4, d4, d, [&](int t, int j, float acc) {
      const float f = __fadd_rn(acc, __ldg(bl + j));
      if (f_out != nullptr && row0 + t < batch) f_out[((int64_t)l * batch + row0 + t) * d + j] = f;
      sx[t * d4 + j] = __fadd_rn(__fmul_rn(sx0[t * d4 + j], f), sx[t * d4 + j]);
    });
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kTile * d; e += blockDim.x) {
    const int t = e / d;
    if (row0 + t < batch) out[(row0 + t) * d + e % d] = sx[t * d4 + e % d];
  }
}

// Dynamic shared memory: g and df [kTile][d4], t [kTile][r4].
__global__ void __launch_bounds__(kThreads, 2)
cross_v2_bwd_rows_kernel(const float* __restrict__ x0, const float* __restrict__ u4,
                         const float* __restrict__ vt4, const float* __restrict__ f,
                         const float* __restrict__ g_in, float* __restrict__ dx0,
                         float* __restrict__ df_out, float* __restrict__ t_out,
                         int64_t batch, int d, int r, int layers) {
  extern __shared__ float4 smem4[];
  float* sg = reinterpret_cast<float*>(smem4);
  const int d4 = round4(d);
  const int r4 = round4(r);
  float* sdf = sg + kTile * d4;
  float* st = sdf + kTile * d4;
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  const int64_t bd = batch * d;
  // g = dL/dx_L, and the top layer's df = g * x0.
  for (int e = threadIdx.x; e < kTile * d4; e += blockDim.x) {
    const int t = e / d4;
    const int j = e % d4;
    const int64_t at = (row0 + t) * d + j;
    const bool in = j < d && row0 + t < batch;
    const float gv = in ? g_in[at] : 0.0f;
    const float df = in ? __fmul_rn(gv, x0[at]) : 0.0f;
    sg[e] = gv;
    sdf[e] = df;
    if (in) df_out[(layers - 1) * bd + at] = df;
  }
  __syncthreads();
  for (int l = layers - 1; l >= 0; --l) {
    tile_times_w(sdf, d4, u4 + (int64_t)l * d * r4, d, r4, st);  // t = df U_l
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * r; e += blockDim.x) {
      const int t = e / r;
      if (row0 + t < batch) {
        t_out[((int64_t)l * batch + row0 + t) * r + e % r] = st[t * r4 + e % r];
      }
    }
    // g += t V_l^T; then, for the same element, the layer's elementwise
    // steps: dx0 += g * f_l (and dx0 += g after layer 0), and the next
    // layer's df = g * x0. Element (t, j) belongs to the same thread in
    // every layer, so its read of dx0 follows its own write.
    tile_times_wt(st, r4, vt4 + (int64_t)l * r4 * d4, d4, d, [&](int t, int j, float acc) {
      if (row0 + t >= batch) return;
      const int64_t at = (row0 + t) * d + j;
      const float g_old = sg[t * d4 + j];
      const float g_new = __fadd_rn(g_old, acc);
      sg[t * d4 + j] = g_new;
      const float gf = __fmul_rn(g_old, f[l * bd + at]);
      const float dx = l == layers - 1 ? gf : __fadd_rn(dx0[at], gf);
      if (l > 0) {
        const float df = __fmul_rn(g_new, x0[at]);
        sdf[t * d4 + j] = df;
        df_out[(l - 1) * bd + at] = df;
        dx0[at] = dx;
      } else {
        dx0[at] = __fadd_rn(dx, g_new);
      }
    });
    __syncthreads();
  }
}

// Block (tile, layer, chunk) sums its 64 x 64 tile of dU_l and dV_l (and,
// for the first k tile, its 64 columns of db_l) over rows
// [chunk * rows_per_chunk, +rows_per_chunk) in row order, and writes them
// into partial[chunk], laid out as the output [dU (L*d*r), dV (L*d*r), db
// (L*d)].
__global__ void __launch_bounds__(kWThreads)
cross_v2_bwd_weights_kernel(const float* __restrict__ x0, const float* __restrict__ f,
                            const float* __restrict__ xv, const float* __restrict__ df,
                            const float* __restrict__ tv, float* __restrict__ partial,
                            int64_t batch, int d, int r, int layers,
                            int64_t rows_per_chunk) {
  __shared__ __align__(16) float sdf[kWRows][kWTile];
  __shared__ __align__(16) float sx[kWRows][kWTile];
  __shared__ __align__(16) float sxv[kWRows][kWTile];
  __shared__ __align__(16) float st[kWRows][kWTile];
  const int jtiles = (d + kWTile - 1) / kWTile;
  const int j0 = (blockIdx.x % jtiles) * kWTile;
  const int k0 = (blockIdx.x / jtiles) * kWTile;
  const int64_t l = blockIdx.y;
  const int64_t first = (int64_t)blockIdx.z * rows_per_chunk;
  const int64_t last = first + rows_per_chunk < batch ? first + rows_per_chunk : batch;
  const int jj = threadIdx.x % kWTile;
  const int kb = (threadIdx.x / kWTile) * kWk;
  const int j = j0 + jj;  // the column this thread stages (and owns in dU, dV)
  const int k = k0 + jj;  // the k this thread stages
  const bool jvalid = j < d;
  const bool kvalid = k < r;
  float au[kWk];
  float av[kWk];
#pragma unroll
  for (int q = 0; q < kWk; ++q) {
    au[q] = 0.0f;
    av[q] = 0.0f;
  }
  float adb = 0.0f;
  for (int64_t base = first; base < last; base += kWRows) {
    // Stage 32 rows: a thread stages column jj (j of df and x_l, k of xv
    // and t) of rows base + threadIdx.x / 64 + 4 i, i < kStage, issuing all
    // its loads before it uses any, so a stage waits for device memory
    // 1 + l times rather than once an element.
    float a[kStage], xl[kStage], dfv[kStage], xvv[kStage], tt[kStage];
    const int rr0 = threadIdx.x / kWTile;
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int64_t row = base + rr0 + i * (kWThreads / kWTile);
      const bool in_j = row < last && jvalid;
      const bool in_k = row < last && kvalid;
      a[i] = in_j ? x0[row * d + j] : 0.0f;
      dfv[i] = in_j ? df[(l * batch + row) * d + j] : 0.0f;
      xvv[i] = in_k ? xv[(l * batch + row) * r + k] : 0.0f;
      tt[i] = in_k ? tv[(l * batch + row) * r + k] : 0.0f;
      xl[i] = a[i];
    }
    for (int m = 0; m < l; ++m) {  // x_l, rebuilt as the forward rounded it
      float fm[kStage];
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        const int64_t row = base + rr0 + i * (kWThreads / kWTile);
        fm[i] = row < last && jvalid ? f[(m * batch + row) * d + j] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kStage; ++i) xl[i] = __fadd_rn(__fmul_rn(a[i], fm[i]), xl[i]);
    }
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int rr = rr0 + i * (kWThreads / kWTile);
      sdf[rr][jj] = dfv[i];
      sx[rr][jj] = xl[i];
      sxv[rr][jj] = xvv[i];
      st[rr][jj] = tt[i];
    }
    __syncthreads();
    const int n = last - base < kWRows ? (int)(last - base) : kWRows;
    for (int rr = 0; rr < n; ++rr) {
      const float dv = sdf[rr][jj];
      const float xr = sx[rr][jj];
      adb += dv;
#pragma unroll
      for (int q = 0; q < kWk; q += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(&sxv[rr][kb + q]);
        const float4 t4 = *reinterpret_cast<const float4*>(&st[rr][kb + q]);
        au[q] = fmaf(dv, a4.x, au[q]);
        au[q + 1] = fmaf(dv, a4.y, au[q + 1]);
        au[q + 2] = fmaf(dv, a4.z, au[q + 2]);
        au[q + 3] = fmaf(dv, a4.w, au[q + 3]);
        av[q] = fmaf(xr, t4.x, av[q]);
        av[q + 1] = fmaf(xr, t4.y, av[q + 1]);
        av[q + 2] = fmaf(xr, t4.z, av[q + 2]);
        av[q + 3] = fmaf(xr, t4.w, av[q + 3]);
      }
    }
    __syncthreads();
  }
  const int64_t width = (int64_t)layers * d * r;
  float* p = partial + (int64_t)blockIdx.z * (2 * width + (int64_t)layers * d);
  if (jvalid) {
#pragma unroll
    for (int q = 0; q < kWk; ++q) {
      const int kq = k0 + kb + q;
      if (kq < r) {
        p[(l * d + j) * r + kq] = au[q];
        p[width + (l * d + j) * r + kq] = av[q];
      }
    }
    if (k0 == 0 && kb == 0) p[2 * width + l * d + j] = adb;
  }
}

// out[e] = sum over chunks c of partial[c][e], c in order.
__global__ void __launch_bounds__(kThreads)
sum_chunks_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int chunks, int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float sum = 0.0f;
  for (int c = 0; c < chunks; ++c) sum += __ldg(partial + (int64_t)c * total + e);
  out[e] = sum;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

}  // namespace

// x0 [batch, d], V zero padded to v4 [layers, d, r4], U transposed and
// zero padded to ut4 [layers, r4, d4] (r4, d4: r and d rounded up to 4),
// b [layers, d], out [batch, d]; f_out [layers, batch, d] and xv_out
// [layers, batch, r], both or neither null; all f32, contiguous, 16-byte
// aligned, on the current device; runs on `stream`. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for d, r, layers or batch
// < 1, or shared memory beyond 227 KB.
extern "C" int tfrec_cross_v2_fwd(const void* x0, const void* v4, const void* ut4,
                                  const void* b, void* out, void* f_out, void* xv_out,
                                  long long batch, long long d, long long r,
                                  long long layers, void* stream) {
  const size_t smem = tile_smem_bytes((int)d, (int)r);
  if (d < 1 || r < 1 || layers < 1 || batch < 1 || smem > kMaxSmem ||
      (f_out == nullptr) != (xv_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = set_smem((const void*)cross_v2_fwd_kernel, smem);
  if (err != 0) return err;
  const int64_t blocks = (batch + kTile - 1) / kTile;
  cross_v2_fwd_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(v4),
      static_cast<const float*>(ut4), static_cast<const float*>(b),
      static_cast<float*>(out), static_cast<float*>(f_out), static_cast<float*>(xv_out),
      batch, (int)d, (int)r, (int)layers);
  return static_cast<int>(cudaGetLastError());
}

// x0 and g [batch, d], U zero padded to u4 [layers, d, r4], V transposed
// and zero padded to vt4 [layers, r4, d4], f [layers, batch, d] and xv
// [layers, batch, r] (from the forward); writes dx0 [batch, d] and grads
// [dU (layers*d*r), dV (layers*d*r), db (layers*d)]; uses df [layers,
// batch, d], t [layers, batch, r] and partial [chunks, grads] as scratch;
// all f32, contiguous, 16-byte aligned, on the current device; runs on
// `stream` (three launches). Returns the first launch error, or
// cudaErrorInvalidValue for d, r, layers, batch or chunks < 1, or shared
// memory beyond 227 KB.
extern "C" int tfrec_cross_v2_bwd(const void* x0, const void* u4, const void* vt4,
                                  const void* f, const void* xv, const void* g,
                                  void* dx0, void* grads, void* df, void* t,
                                  void* partial, long long batch, long long d,
                                  long long r, long long layers, long long chunks,
                                  void* stream) {
  const size_t smem = tile_smem_bytes((int)d, (int)r);
  if (d < 1 || r < 1 || layers < 1 || batch < 1 || chunks < 1 || chunks > 65535 ||
      smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = set_smem((const void*)cross_v2_bwd_rows_kernel, smem);
  if (err != 0) return err;
  const int64_t blocks = (batch + kTile - 1) / kTile;
  cross_v2_bwd_rows_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      static_cast<const float*>(x0), static_cast<const float*>(u4),
      static_cast<const float*>(vt4), static_cast<const float*>(f),
      static_cast<const float*>(g), static_cast<float*>(dx0), static_cast<float*>(df),
      static_cast<float*>(t), batch, (int)d, (int)r, (int)layers);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t rows_per_chunk = (batch + chunks - 1) / chunks;
  const int tiles = (int)(((d + kWTile - 1) / kWTile) * ((r + kWTile - 1) / kWTile));
  const dim3 grid((unsigned)tiles, (unsigned)layers, (unsigned)chunks);
  cross_v2_bwd_weights_kernel<<<grid, kWThreads, 0, s>>>(
      static_cast<const float*>(x0), static_cast<const float*>(f),
      static_cast<const float*>(xv), static_cast<const float*>(df),
      static_cast<const float*>(t), static_cast<float*>(partial), batch, (int)d, (int)r,
      (int)layers, rows_per_chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t total = 2 * layers * d * r + layers * d;
  sum_chunks_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(grads), (int)chunks, total);
  return static_cast<int>(cudaGetLastError());
}
