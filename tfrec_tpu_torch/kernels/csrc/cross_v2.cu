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
// Bound: operations. Each layer is two products of 2*B*d*r operations in
// the forward and four in the backward (B=8192, d=845, r=64, L=3: 5.32
// GFLOP forward, 10.6 GFLOP backward). Every product runs on the tensor
// cores (mma.sync m16n8k8 TF32) as 3xTF32: each f32 operand is split into
// a TF32 high part and a TF32 remainder, and a*b is summed as a_lo*b_hi +
// a_hi*b_lo + a_hi*b_hi in f32, which keeps about f32 accuracy (the plain
// version these are held to runs f32 with TF32 off). The forward's bound is
// 3 x 5.32 G TF32 operations at 495 TFLOP/s, 32.2 us, plus its elementwise
// steps, 0.9 us at 67 TFLOP/s: 33.2 us (80.3 us in f32 on the CUDA cores;
// its bytes, x0 read and x_L written, 56.7 MB, take 16.9 us, and 146.1 MB,
// 43.6 us, when it also writes f and xv for training). The backward's is 3
// x 10.6 G TF32 operations, 64.4 us, plus 2.2 us of elementwise steps:
// 66.6 us (159 us in f32).
//
// Forward design (cross_v2_fwd_kernel). A block holds kM m16 tiles of rows
// (32 rows and 512 threads at kM = 2; 16 rows and 256 threads where 32 rows
// of a wide d do not fit) with two arrays in shared memory across all L
// layers: x [16 kM][frag_stride(d)], the running x, and xv [16 kM][
// frag_stride(r)], the A operands of the layer's two products (118 784 B at
// d=845, r=64). x0 is only ever an elementwise operand: it is held beside
// them where 32 rows of all three fit (d <= 872 at r=64, the flagship's
// 845 included: 228 352 B), else the epilogue reads it from device memory,
// where L2 keeps it across the layers (x0 held: 250.9 us against 272.7-275.3
// at the flagship's shape, tools/ab_cross_v2.py). Device memory is read
// once for x0 and written once for x_L (and for f and xv when training),
// as the TPU kernel keeps x resident in VMEM. Per layer:
// - xv = x V_l, [16 kM, d8] x [d8, r8]: a warp owns an n8 tile of r for all
//   kM m16 tiles of rows; where there are at least twice as many warps as
//   tiles, two warps share a tile, one summing the first half of d and one
//   the second, the halves then added in that order;
// - f = xv U_l^T + b_l and x = x0 * f + x, [16 kM, r8] x [r8, d8]: a warp
//   owns the n8 tiles w, w + 8 kM, ... of d, and runs the elementwise steps
//   on the elements its accumulators hold (rows gid and gid+8 of each m16
//   tile, columns 2 tid4 and 2 tid4 + 1), so each element of x belongs to
//   one thread in every layer; its loads of x0 and b_l are issued a tile
//   ahead, and f is written out when training.
// Then x_L is written out in a coalesced pass. The weights come from L2 as
// B fragments (the wrapper lays V and U^T out in fragment order: one 8-byte
// load a lane a k-step, read 4 k-steps ahead), and each feeds all kM m16
// tiles. Every sum runs in a fixed order, with no atomics, so runs repeat
// bit for bit; the elementwise steps use _rn intrinsics, which the compiler
// does not fuse into FMAs, and round as the plain version does.
//
// Backward design. The forward saved f [L, B, d] and xv [L, B, r] (83 MB
// and 6.3 MB at B=8192, d=845, r=64, L=3, written once), so the backward
// replays no product: the TPU kernel's replay would cost 2 more products a
// layer, 5.3 GFLOP in all. x_l is rebuilt elementwise from x0 and f exactly
// as the forward rounded it. Three kernels:
// - cross_v2_bwd_rows_kernel: the per-row chain (df, t, dx0, g), a tile of
//   32 rows a block of 512 threads (two m16 tiles of the mma; 16 rows and
//   256 threads, two blocks an SM, where 32 rows of a wide d do not fit)
//   with g, df and t in shared memory (222 KB at d=845). Where not even 16
//   rows of all three fit, g moves to a [B, d8] scratch in device memory:
//   only df and t are the products' A operands, and each element of g is
//   read and written by the one thread that owns it in the epilogue, so
//   this needs no other barrier. Where g fits, the scratch would cost time:
//   at the flagship's shape the row pass took 500 us with g in device
//   memory against 402 us with g in shared memory (tools/ab_cross_v2.py,
//   one call). tfrec_cross_v2_bwd_scratch_rows tells the wrapper which
//   applies. The weights come
//   from L2 as B fragments (the wrapper lays U and V^T out in fragment
//   order: one 8-byte load a lane a k-step, read 8 k-steps ahead), and
//   each feeds both m16 tiles, so a row reads half the weight bytes that a
//   16-row tile would. t = df U_l: a warp owns an n8 tile of r and half of
//   d (the two halves added in order). g += t V_l^T: a warp owns the n8
//   tiles w, w+16, ... of d. The elementwise steps of a layer (g, dx0 += g
//   * f_l, the next layer's df = g * x0) run in that product's epilogue on
//   the elements a thread's accumulators hold (rows gid and gid+8 of each
//   m16 tile, columns 2 tid4 and 2 tid4 + 1), so each element belongs to
//   one thread in every layer; their loads of f, x0 and dx0 are issued a
//   tile ahead. It writes df [L, B, d8] and t [L, B, r8] (rows padded to
//   multiples of 8 with zeros) for the weight pass.
// - cross_v2_bwd_weights_kernel: dU, dV and db, sums over the batch. A
//   [2, L, d, r] partial a row block would take 1.3 MB a block, so instead a
//   block owns a 64 (j of d) x 64 (k of r) tile of one layer's outputs and
//   walks a fixed chunk of the batch in row order: dU = df^T xv and dV =
//   x_l^T t as mma with M = j, N = k and the batch rows as K. Eight warps,
//   each two m16 tiles x four n8 tiles of one of the two outputs. Rows are
//   staged in shared memory with cp.async, 32 at a time, two stages in
//   flight, so that the next stage loads while this one's mma run; x_l is
//   rebuilt in place from the staged x0 and f_0..f_{l-1} once a stage,
//   rounded as the forward rounded it. db is a CUDA-core sum: four partial
//   sums a column, each over a quarter of every stage's rows in row order,
//   added in order at the end.
// - sum_chunks_kernel: adds the chunks' partials in chunk order.
// Each output takes its k-steps in one fixed order, with no atomics, so the
// gradients repeat bit for bit.
//
// Any width and depth. The designs above need 16 rows of the products'
// [B, d] and [B, r] A operands in a block's 227 KB (d <= 3560 at r=64,
// 3496 at r=128), and the weight pass two stages of L - 1 layers of f (L
// <= 47). Past either, the C entry points take a general route instead
// (general_rows_kernel, general_weights_kernel below): each product a
// launch of tiled f32 products on the CUDA cores over device memory, with
// its elementwise steps fused, in fixed orders, no atomics. The wrapper
// (cross_v2_cuda.py) chooses the route by shape and passes it in; shapes
// the tiles take run exactly as before.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the chunk sum's block
constexpr int kWThreads = 256;  // weight pass: threads a block
constexpr int kAhead = 4;  // products: k-steps a weight fragment is read ahead
constexpr int kLoad = 8;  // row passes: elements a thread loads at once
constexpr int kWTile = 64;  // weight pass: a 64 (j of d) x 64 (k of r) tile
// Weight pass: row stride of a staged [rows][64] tile. 72 = 8 mod 32, so the
// fragment reads (row tid4, column gid) hit 32 distinct banks.
constexpr int kWStride = kWTile + 8;
constexpr int kWMaxRows = 32;  // weight pass: rows a stage, at most
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on Hopper

// ---- 3xTF32 products on the tensor cores ----

__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }

// Row stride of the A operands' tiles in shared memory (the forward's x
// and xv, the row pass's df and t): n rounded up to 8, and 8 more where
// that is a multiple of 16, so that the stride is 8 or 24 mod 32 and the A
// fragments' 8-byte reads (rows gid, columns 2 tid4) hit 32 distinct banks
// in each half warp.
__host__ __device__ inline int frag_stride(int n) {
  const int n8 = round8(n);
  return n8 % 16 ? n8 : n8 + 8;
}

// Shared memory of a forward block of m m16 tiles: x and xv, and x0 where
// it is held there (x0_shared) rather than read from device memory.
size_t fwd_smem_bytes(int d, int r, int m, bool x0_shared) {
  return (size_t)16 * m * ((x0_shared ? 2 : 1) * frag_stride(d) + frag_stride(r)) * sizeof(float);
}

// Shared memory of a row-pass block of m m16 tiles: df and t, and g where
// it is held there (g_shared) rather than in device memory.
size_t rows_smem_bytes(int d, int r, int m, bool g_shared) {
  return (size_t)16 * m * ((g_shared ? round8(d) : 0) + frag_stride(d) + frag_stride(r)) *
         sizeof(float);
}

// The row pass's layout: 32 rows a block (m = 2) where g, df and t fit in
// shared memory, else 16; where not even 16 rows of all three fit, g moves
// to device memory (g_shared false).
struct RowsLayout {
  int m;
  bool g_shared;
};

RowsLayout rows_layout(int d, int r) {
  const int m = rows_smem_bytes(d, r, 2, true) <= kMaxSmem ? 2 : 1;
  return {m, rows_smem_bytes(d, r, m, true) <= kMaxSmem};
}

// Shared memory of the weight pass: two stages of df, x0, xv, t and
// f_0..f_{L-2}, each [rows][kWStride].
size_t weights_smem_bytes(int layers, int rows) {
  return (size_t)2 * (3 + layers) * rows * kWStride * sizeof(float);
}

// Rows a stage of the weight pass: 32, or fewer where many layers' f would
// not fit; 0 where not even 8 fit.
int weights_rows(int layers) {
  for (int rows = kWMaxRows; rows >= 8; rows /= 2) {
    if (weights_smem_bytes(layers, rows) <= kMaxSmem) return rows;
  }
  return 0;
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), as a 32-bit pattern whose low 13 bits are zero. It is
// computed on the bit pattern with an integer add and an and: with cvt.rna
// the weight pass took 410 us against 353 us (tools/ab_cross_v2.py).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + O(2^-22 |x|): hi and lo TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a b for a 16 x 8 (row) by 8 x 8 (col) product in TF32, f32 sums.
// Fragments (gid = lane / 4, tid4 = lane % 4): a = A[gid][tid4],
// A[gid+8][tid4], A[gid][tid4+4], A[gid+8][tid4+4]; b = B[tid4][gid],
// B[tid4+4][gid]; c = C[gid][2 tid4], C[gid][2 tid4+1], C[gid+8][2 tid4],
// C[gid+8][2 tid4+1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b as 3xTF32: the tensor cores sum a_lo b_hi, then a_hi b_lo, then
// a_hi b_hi (small terms first) into a fresh accumulator, which is then
// added to c on the CUDA cores, rounded to nearest. The tensor cores' own
// f32 sums do not round to nearest: letting the mma add every k-step into
// c left errors ten times those of f32 (dU 2.2e-3 at max |ref| 438 over
// 512-row chunks, against 2.3e-4), so c is only ever added to with
// __fadd_rn. b holds B's two elements as (b0 hi, b1 hi, b0 lo, b1 lo).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], const uint4& b) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(p, alo, b.x, b.y);
  mma_tf32(p, ahi, b.z, b.w);
  mma_tf32(p, ahi, b.x, b.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], p[i]);
}

__device__ __forceinline__ uint4 split2(float b0, float b1) {
  uint4 b;
  split(b0, b.x, b.z);
  split(b1, b.y, b.w);
  return b;
}

// The A fragment of a k-step from a [16][stride] tile in shared memory.
// Within a k-step the k order is free as long as A and B agree, so logical
// k = tid4 and tid4 + 4 are read from columns 2 tid4 and 2 tid4 + 1 (one
// 8-byte load a row); the B fragments in the wrapper's layout follow the
// same order.
__device__ __forceinline__ void a_frag(const float* s, int stride, int k0, int gid, int tid4,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 top = *reinterpret_cast<const float2*>(s + gid * stride + k0 + 2 * tid4);
  const float2 bot = *reinterpret_cast<const float2*>(s + (gid + 8) * stride + k0 + 2 * tid4);
  split(top.x, hi[0], lo[0]);
  split(bot.x, hi[1], lo[1]);
  split(top.y, hi[2], lo[2]);
  split(bot.y, hi[3], lo[3]);
}

// acc[mi] += A_mi B over the k-steps [ks0, ks1): A_mi the mi-th m16 tile of
// rows of s (row stride `stride`), B's fragment of k-step ks at w + ks *
// step (a float2 a lane), read kAhead k-steps ahead of its use. The k-steps
// go in groups of kAhead with no branch inside a group, so that the
// compiler can overlap one k-step's loads and splits with another's mma;
// the ring's loads past ks1 - 1 reread that k-step and go unused.
template <int kM>
__device__ __forceinline__ void tile_times_frags(const float* s, int stride, const float2* w,
                                                 int64_t step, int ks0, int ks1, int gid,
                                                 int tid4, float (&acc)[kM][4]) {
  if (ks1 <= ks0) return;
  auto one_step = [&](int ks, float2 b) {
    const uint4 bs = split2(b.x, b.y);
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
      uint32_t ahi[4], alo[4];
      a_frag(s + mi * 16 * stride, stride, ks * 8, gid, tid4, ahi, alo);
      mma_3xtf32(acc[mi], ahi, alo, bs);
    }
  };
  float2 ring[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) ring[i] = __ldg(w + min(ks0 + i, ks1 - 1) * step);
  int ks = ks0;
  for (; ks + kAhead <= ks1; ks += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const float2 b = ring[i];
      ring[i] = __ldg(w + min(ks + kAhead + i, ks1 - 1) * step);
      one_step(ks + i, b);
    }
  }
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (ks + i < ks1) one_step(ks + i, ring[i]);
  }
}

// out = A B for a block's kM m16 tiles of rows where B is narrow (its N is
// r): A [16 kM][a_stride] in shared memory over ksk k-steps; w the lane's
// own B fragments, [ksk][ksn n8 tiles][32 lanes]; out [16 kM][o_stride] in
// shared memory, and emit(nt, acc) takes each n8 tile's final sums too. A
// warp takes an n8 tile of N for all kM m16 tiles, so that each weight
// fragment it loads feeds kM products. Where there are at least twice as
// many warps as tiles, two warps share a tile, one summing the first half
// of the k-steps and one the second; the halves are then added in that
// order. Ends with out complete for the block (a barrier).
template <int kM, typename Emit>
__device__ __forceinline__ void narrow_product(const float* a, int a_stride, const float2* w,
                                               int ksk, int ksn, float* out, int o_stride,
                                               int gid, int tid4, Emit emit) {
  constexpr int kWarps = 8 * kM;
  const int warp = threadIdx.x / 32;
  auto product = [&](int nt, int ks0, int ks1, float (&acc)[kM][4]) {
    tile_times_frags<kM>(a, a_stride, w + nt * 32, (int64_t)ksn * 32, ks0, ks1, gid, tid4, acc);
  };
  // Element q of m16 tile mi of n8 tile nt: row mi * 16 + gid + 8 (q / 2),
  // column nt * 8 + 2 tid4 + q % 2.
  auto store = [&](int nt, const float (&acc)[kM][4]) {
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = mi * 16 + gid + 8 * h;
        *reinterpret_cast<float2*>(out + t * o_stride + nt * 8 + 2 * tid4) =
            make_float2(acc[mi][2 * h], acc[mi][2 * h + 1]);
      }
    }
  };
  if (2 * ksn <= kWarps) {
    float acc[kM][4] = {};
    const int nt = warp % ksn;
    const int part = warp / ksn;  // 0, 1, or idle
    if (part < 2) product(nt, part ? ksk / 2 : 0, part ? ksk : ksk / 2, acc);
    if (part == 1) store(nt, acc);
    __syncthreads();
    if (part == 0) {
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = mi * 16 + gid + 8 * (q / 2);
          acc[mi][q] = __fadd_rn(acc[mi][q], out[t * o_stride + nt * 8 + 2 * tid4 + q % 2]);
        }
      }
      store(nt, acc);
      emit(nt, acc);
    }
  } else {
    for (int nt = warp; nt < ksn; nt += kWarps) {
      float acc[kM][4] = {};
      product(nt, 0, ksk, acc);
      store(nt, acc);
      emit(nt, acc);
    }
  }
  __syncthreads();
}

// The forward: a block of kM * 256 threads holds kM m16 tiles of rows (kM *
// 16 rows). Dynamic shared memory: x [16 kM][frag_stride(d)], xv [16
// kM][frag_stride(r)] and, where kX0Shared, x0 [16 kM][frag_stride(d)]
// (else the epilogue reads x0 from device memory). vfrag and utfrag: V_l [d, r] and U_l^T [r, d] as B
// operands in fragment order, [L][k-steps][n8 tiles][32 lanes] of (b0, b1),
// zero padded to multiples of 8. f_out [L, B, d] and xv_out [L, B, r], both
// or neither null.
template <int kM, bool kX0Shared>
__global__ void __launch_bounds__(256 * kM, 2 / kM)
cross_v2_fwd_kernel(const float* __restrict__ x0, const float2* __restrict__ vfrag,
                    const float2* __restrict__ utfrag, const float* __restrict__ b,
                    float* __restrict__ out, float* __restrict__ f_out,
                    float* __restrict__ xv_out, int64_t batch, int d, int r, int layers) {
  constexpr int kRTile = 16 * kM;
  constexpr int kRWarps = 8 * kM;
  extern __shared__ float4 smem4[];
  const int d8 = round8(d);
  const int r8 = round8(r);
  const int sd = frag_stride(d);
  const int sr = frag_stride(r);
  float* sx = reinterpret_cast<float*>(smem4);
  float* sxv = sx + kRTile * sd;
  float* sx0 = sxv + kRTile * sr;  // where kX0Shared
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane / 4;
  const int tid4 = lane % 4;
  const int64_t row0 = (int64_t)blockIdx.x * kRTile;
  // x = x0 (zero past d and past the batch), and x0 itself where it is held.
  // A thread issues the loads of kLoad elements before it uses any.
  for (int e0 = threadIdx.x; e0 < kRTile * d8; e0 += kLoad * blockDim.x) {
    float xv0[kLoad];
#pragma unroll
    for (int i = 0; i < kLoad; ++i) {
      const int e = e0 + i * blockDim.x;
      const int t = e / d8;
      const int j = e % d8;
      const bool in = e < kRTile * d8 && j < d && row0 + t < batch;
      xv0[i] = in ? __ldg(x0 + (row0 + t) * d + j) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kLoad; ++i) {
      const int e = e0 + i * blockDim.x;
      if (e >= kRTile * d8) break;
      sx[e / d8 * sd + e % d8] = xv0[i];
      if (kX0Shared) sx0[e / d8 * sd + e % d8] = xv0[i];
    }
  }
  __syncthreads();
  const int ksd = d8 / 8;  // k-steps over d, and n8 tiles of d
  const int ksr = r8 / 8;  // k-steps over r, and n8 tiles of r
  for (int l = 0; l < layers; ++l) {
    // xv = x V_l, [16 kM, d8] x [d8, r8], into sxv (and xv_out).
    float* xvl = xv_out == nullptr ? nullptr : xv_out + ((int64_t)l * batch + row0) * r;
    narrow_product<kM>(sx, sd, vfrag + (int64_t)l * ksd * ksr * 32 + lane, ksd, ksr, sxv, sr,
                       gid, tid4, [&](int nt, const float (&acc)[kM][4]) {
      if (xvl == nullptr) return;
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = mi * 16 + gid + 8 * (q / 2);
          const int k = nt * 8 + 2 * tid4 + q % 2;
          if (k < r && row0 + t < batch) xvl[(int64_t)t * r + k] = acc[mi][q];
        }
      }
    });
    // f = xv U_l^T + b_l, [16 kM, r8] x [r8, d8]: a warp takes the n8 tiles
    // w, w + 8 kM, ... of d, each for all kM m16 tiles of rows; then, for
    // each pair of neighbouring elements of the accumulators, x = x0 * f + x
    // (and f written out when training).
    const float2* ul = utfrag + (int64_t)l * ksr * ksd * 32 + lane;
    const float* bl = b + (int64_t)l * d;
    float* fl = f_out == nullptr ? nullptr : f_out + (int64_t)l * batch * d;
    // The epilogue's loads of x0 and b_l do not wait on the product: a warp
    // issues those of its next tile before the product of this one.
    auto load_epilogue = [&](int nt, float (&xv0)[kM][4], float (&bv)[2]) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = nt * 8 + 2 * tid4 + c;
        bv[c] = j < d ? __ldg(bl + j) : 0.0f;
      }
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = mi * 16 + gid + 8 * (q / 2);
          const int j = nt * 8 + 2 * tid4 + q % 2;
          const bool in = j < d && row0 + t < batch;
          xv0[mi][q] = !in ? 0.0f : kX0Shared ? sx0[t * sd + j] : __ldg(x0 + (row0 + t) * d + j);
        }
      }
    };
    float xv0[kM][4], bv[2];
    load_epilogue(warp, xv0, bv);
    for (int nt = warp; nt < ksd; nt += kRWarps) {
      float next_x0[kM][4], next_b[2];
      load_epilogue(nt + kRWarps, next_x0, next_b);
      float acc[kM][4] = {};
      tile_times_frags<kM>(sxv, sr, ul + nt * 32, (int64_t)ksd * 32, 0, ksr, gid, tid4, acc);
      const int j = nt * 8 + 2 * tid4;
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = mi * 16 + gid + 8 * h;
          const int64_t row = row0 + t;
          if (row >= batch || j >= d) continue;  // x stays 0 there
          // Columns j and j + 1 as one 8-byte access: conflict-free, as the
          // A fragments' reads are.
          float2* xs = reinterpret_cast<float2*>(sx + t * sd + j);
          float2 x = *xs;
          const float f0 = __fadd_rn(acc[mi][2 * h], bv[0]);
          const float f1 = __fadd_rn(acc[mi][2 * h + 1], bv[1]);
          x.x = __fadd_rn(__fmul_rn(xv0[mi][2 * h], f0), x.x);
          if (fl != nullptr) fl[row * d + j] = f0;
          if (j + 1 < d) {
            x.y = __fadd_rn(__fmul_rn(xv0[mi][2 * h + 1], f1), x.y);
            if (fl != nullptr) fl[row * d + j + 1] = f1;
          }
          *xs = x;
        }
      }
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
        for (int q = 0; q < 4; ++q) xv0[mi][q] = next_x0[mi][q];
      }
      bv[0] = next_b[0];
      bv[1] = next_b[1];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kRTile * d; e += blockDim.x) {
    const int t = e / d;
    if (row0 + t < batch) out[(row0 + t) * d + e % d] = sx[t * sd + e % d];
  }
}

// The backward's row pass: a block of kM * 256 threads holds kM m16 tiles
// of rows (kM * 16 rows). Dynamic shared memory: g [16 kM][round8(d)] where
// kGShared (else g lives in g_scratch, [blocks * 16 kM][round8(d)] in
// device memory), df [16 kM][frag_stride(d)] and t [16 kM][frag_stride(r)].
// ufrag and vtfrag: U_l [d, r] and V_l^T [r, d] as B operands in fragment
// order, [L][k-steps][n8 tiles][32 lanes] of (b0, b1), zero padded to
// multiples of 8.
template <int kM, bool kGShared>
__global__ void __launch_bounds__(256 * kM, 2 / kM)
cross_v2_bwd_rows_kernel(const float* __restrict__ x0, const float2* __restrict__ ufrag,
                         const float2* __restrict__ vtfrag, const float* __restrict__ f,
                         const float* __restrict__ g_in, float* __restrict__ dx0,
                         float* __restrict__ df_out, float* __restrict__ t_out,
                         float* __restrict__ g_scratch, int64_t batch, int d, int r,
                         int layers) {
  constexpr int kRTile = 16 * kM;
  constexpr int kRWarps = 8 * kM;
  extern __shared__ float4 smem4[];
  const int d8 = round8(d);
  const int r8 = round8(r);
  const int sd = frag_stride(d);
  const int sr = frag_stride(r);
  const int64_t row0 = (int64_t)blockIdx.x * kRTile;
  float* smem = reinterpret_cast<float*>(smem4);
  float* sg = kGShared ? smem : g_scratch + row0 * d8;
  float* sdf = kGShared ? smem + kRTile * d8 : smem;
  float* st = sdf + kRTile * sd;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane / 4;
  const int tid4 = lane % 4;
  const int64_t bd = batch * d;
  const int64_t bd8 = batch * d8;
  // g = dL/dx_L, and the top layer's df = g * x0 (zero past d and past the
  // batch). A thread issues the loads of kLoad elements before it uses any.
  for (int e0 = threadIdx.x; e0 < kRTile * d8; e0 += kLoad * blockDim.x) {
    float gv[kLoad], xv0[kLoad];
#pragma unroll
    for (int i = 0; i < kLoad; ++i) {
      const int e = e0 + i * blockDim.x;
      const int t = e / d8;
      const int j = e % d8;
      const int64_t at = (row0 + t) * d + j;
      const bool in = e < kRTile * d8 && j < d && row0 + t < batch;
      gv[i] = in ? __ldg(g_in + at) : 0.0f;
      xv0[i] = in ? __ldg(x0 + at) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kLoad; ++i) {
      const int e = e0 + i * blockDim.x;
      const int t = e / d8;
      const int j = e % d8;
      if (e >= kRTile * d8) break;
      const float df = __fmul_rn(gv[i], xv0[i]);
      sg[e] = gv[i];
      sdf[t * sd + j] = df;
      if (row0 + t < batch) df_out[(layers - 1) * bd8 + (row0 + t) * d8 + j] = df;
    }
  }
  __syncthreads();
  const int ksd = d8 / 8;  // k-steps over d, and n8 tiles of d
  const int ksr = r8 / 8;  // k-steps over r, and n8 tiles of r
  for (int l = layers - 1; l >= 0; --l) {
    // t = df U_l, [16 kM, d8] x [d8, r8], into st and t_out.
    float* tl = t_out + ((int64_t)l * batch + row0) * r8;
    narrow_product<kM>(sdf, sd, ufrag + (int64_t)l * ksd * ksr * 32 + lane, ksd, ksr, st, sr,
                       gid, tid4, [&](int nt, const float (&acc)[kM][4]) {
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = mi * 16 + gid + 8 * h;
          if (row0 + t < batch) {
            *reinterpret_cast<float2*>(tl + t * r8 + nt * 8 + 2 * tid4) =
                make_float2(acc[mi][2 * h], acc[mi][2 * h + 1]);
          }
        }
      }
    });
    // g += t V_l^T, [16 kM, r8] x [r8, d8]: a warp takes the n8 tiles w,
    // w + 8 kM, ... of d, each for all kM m16 tiles of rows; then, for each element of
    // the accumulators, the layer's elementwise steps: dx0 += g * f_l (and
    // dx0 += g after layer 0), and the next layer's df = g * x0.
    const float2* vl = vtfrag + (int64_t)l * ksr * ksd * 32 + lane;
    const float* fl = f + l * bd;
    // The epilogue's loads of f, x0 and dx0 (and of g, where it lives in
    // device memory) do not wait on the product: a warp issues those of its
    // next tile before the product of this one.
    auto load_epilogue = [&](int nt, float (&fv)[kM][4], float (&xv0)[kM][4], float (&dxv)[kM][4],
                             float (&gv)[kM][4]) {
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = mi * 16 + gid + 8 * (q / 2);
          const int64_t row = row0 + t;
          const int j = nt * 8 + 2 * tid4 + q % 2;
          const bool in = j < d && row < batch;
          const int64_t at = row * d + j;
          fv[mi][q] = in ? __ldg(fl + at) : 0.0f;
          xv0[mi][q] = in && l > 0 ? __ldg(x0 + at) : 0.0f;
          dxv[mi][q] = in && l < layers - 1 ? dx0[at] : 0.0f;
          gv[mi][q] = !kGShared && in ? sg[t * d8 + j] : 0.0f;
        }
      }
    };
    float fv[kM][4], xv0[kM][4], dxv[kM][4], gv[kM][4];
    load_epilogue(warp, fv, xv0, dxv, gv);
    for (int nt = warp; nt < ksd; nt += kRWarps) {
      float next_f[kM][4], next_x0[kM][4], next_dx[kM][4], next_g[kM][4];
      load_epilogue(nt + kRWarps, next_f, next_x0, next_dx, next_g);
      float acc[kM][4] = {};
      tile_times_frags<kM>(st, sr, vl + nt * 32, (int64_t)ksd * 32, 0, ksr, gid, tid4, acc);
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = mi * 16 + gid + 8 * (q / 2);
          const int64_t row = row0 + t;
          const int j = nt * 8 + 2 * tid4 + q % 2;
          if (row >= batch) continue;
          float* dfl = l > 0 ? df_out + (l - 1) * bd8 + row * d8 + j : nullptr;
          if (j >= d) {  // padding: df stays 0 for the weight pass
            if (l > 0) *dfl = 0.0f;
            continue;
          }
          const int64_t at = row * d + j;
          const float g_old = kGShared ? sg[t * d8 + j] : gv[mi][q];
          const float g_new = __fadd_rn(g_old, acc[mi][q]);
          sg[t * d8 + j] = g_new;
          const float gf = __fmul_rn(g_old, fv[mi][q]);
          const float dx = l == layers - 1 ? gf : __fadd_rn(dxv[mi][q], gf);
          if (l > 0) {
            const float df = __fmul_rn(g_new, xv0[mi][q]);
            sdf[t * sd + j] = df;
            *dfl = df;
            dx0[at] = dx;
          } else {
            dx0[at] = __fadd_rn(dx, g_new);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fv[mi][q] = next_f[mi][q];
          xv0[mi][q] = next_x0[mi][q];
          dxv[mi][q] = next_dx[mi][q];
          gv[mi][q] = next_g[mi][q];
        }
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// Stage rows [base, base + rows) x columns [c0, c0 + 64) of src (row
// stride ld) into dst [rows][kWStride] with cp.async, zero filled past row
// `last` and column `cols`. Vec: 16-byte copies (ld, c0 and cols multiples
// of 4, src 16-byte aligned); else 4-byte copies.
template <bool Vec>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int64_t ld,
                                           int64_t base, int64_t last, int c0, int cols,
                                           int rows) {
  constexpr int kPer = Vec ? 4 : 1;
  constexpr int kAcross = kWTile / kPer;
  for (int e = threadIdx.x; e < rows * kAcross; e += kWThreads) {
    const int rr = e / kAcross;
    const int c = e % kAcross * kPer;
    const int64_t row = base + rr;
    const bool ok = row < last && c0 + c < cols;
    const float* from = ok ? src + row * ld + c0 + c : src;
    if (Vec) {
      cp_async16(dst + rr * kWStride + c, from, ok);
    } else {
      cp_async4(dst + rr * kWStride + c, from, ok);
    }
  }
}

// Block (tile, layer, chunk) sums its 64 x 64 tile of dU_l and dV_l (and,
// for the first k tile, its 64 columns of db_l) over rows
// [chunk * rows_per_chunk, +rows_per_chunk) in row order, and writes them
// into partial[chunk], laid out as the output [dU (L*d*r), dV (L*d*r), db
// (L*d)]. df [L, B, d8] and t [L, B, r8] are the row pass's, padded. A
// stage holds `rows` rows: 32, or 16 or 8 where many layers' f would not fit.
template <int rows>
__global__ void __launch_bounds__(kWThreads, 2)
cross_v2_bwd_weights_kernel(const float* __restrict__ x0, const float* __restrict__ f,
                            const float* __restrict__ xv, const float* __restrict__ df,
                            const float* __restrict__ tv, float* __restrict__ partial,
                            int64_t batch, int d, int r, int layers,
                            int64_t rows_per_chunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d8 = round8(d);
  const int r8 = round8(r);
  const int jtiles = (d + kWTile - 1) / kWTile;
  const int j0 = (blockIdx.x % jtiles) * kWTile;
  const int k0 = (blockIdx.x / jtiles) * kWTile;
  const int l = blockIdx.y;
  const int64_t first = (int64_t)blockIdx.z * rows_per_chunk;
  const int64_t last = first + rows_per_chunk < batch ? first + rows_per_chunk : batch;
  const int tile = rows * kWStride;
  const int per_stage = (3 + layers) * tile;  // df, x0, xv, t, f_0..f_{L-2}
  const float* dfl = df + (int64_t)l * batch * d8;
  const float* xvl = xv + (int64_t)l * batch * r;
  const float* tl = tv + (int64_t)l * batch * r8;
  auto issue = [&](int buf, int64_t base) {
    float* s = smem + buf * per_stage;
    stage_tile<true>(s, dfl, d8, base, last, j0, d8, rows);
    stage_tile<false>(s + tile, x0, d, base, last, j0, d, rows);
    if (r % 4 == 0) {
      stage_tile<true>(s + 2 * tile, xvl, r, base, last, k0, r, rows);
    } else {
      stage_tile<false>(s + 2 * tile, xvl, r, base, last, k0, r, rows);
    }
    stage_tile<true>(s + 3 * tile, tl, r8, base, last, k0, r8, rows);
    for (int m = 0; m < l; ++m) {
      stage_tile<false>(s + (4 + m) * tile, f + (int64_t)m * batch * d, d, base, last, j0, d, rows);
    }
    asm volatile("cp.async.commit_group;");
  };
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane / 4;
  const int tid4 = lane % 4;
  const int out = warp / 4;  // 0: dU = df^T xv, 1: dV = x_l^T t
  const int mrow = (warp / 2) % 2 * 32;  // the warp's two m16 tiles of j
  const int ncol = warp % 2 * 32;  // and its four n8 tiles of k
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][n][c] = 0.0f;
    }
  }
  float adb = 0.0f;
  const int64_t stages = last > first ? (last - first + rows - 1) / rows : 0;
  if (stages > 0) issue(0, first);
  for (int64_t s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      issue((int)((s + 1) & 1), first + (s + 1) * rows);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    if (l > 0) {  // x0 -> x_l in place, as the forward rounded it
      float* bx = smem + (s & 1) * per_stage + tile;
      const float* bf = bx + 3 * tile;
      for (int e = threadIdx.x; e < rows * kWTile; e += kWThreads) {
        const int at = e / kWTile * kWStride + e % kWTile;
        const float a = bx[at];
        float x = a;
        for (int m = 0; m < l; ++m) x = __fadd_rn(__fmul_rn(a, bf[m * tile + at]), x);
        bx[at] = x;
      }
      __syncthreads();
    }
    const float* sdf = smem + (s & 1) * per_stage;
    const float* sxl = sdf + tile;
    const float* sxv = sdf + 2 * tile;
    const float* st = sdf + 3 * tile;
    // Not unrolled: unrolled, the loop spills and takes 360 us against 335
    // (tools/ab_cross_v2.py).
#pragma unroll 1
    for (int k8 = 0; k8 < rows; k8 += 8) {
      // A element q of m16 tile mi: (j = mrow + 16 mi + gid + 8 (q % 2),
      // row = k8 + tid4 + 4 (q / 2)); B: (row k8 + tid4 (+4), k = ncol +
      // 8 n + gid).
      const float* sa = out ? sxl : sdf;
      const float* sb = out ? st : sxv;
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          split(sa[(k8 + tid4 + 4 * (q / 2)) * kWStride + mrow + 16 * mi + gid + 8 * (q % 2)],
                ahi[mi][q], alo[mi][q]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int at = (k8 + tid4) * kWStride + ncol + n * 8 + gid;
        const uint4 bs = split2(sb[at], sb[at + 4 * kWStride]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_3xtf32(acc[mi][n], ahi[mi], alo[mi], bs);
      }
    }
    if (k0 == 0) {  // thread c + 64 q sums rows [q rows/4, (q+1) rows/4) of column c
      const int quarter = rows / 4;
      const int rr0 = threadIdx.x / kWTile * quarter;
      for (int rr = rr0; rr < rr0 + quarter; ++rr) adb += sdf[rr * kWStride + threadIdx.x % kWTile];
    }
    __syncthreads();
  }
  if (k0 == 0) {  // db = the four quarters' sums, added in order
    smem[threadIdx.x] = adb;
    __syncthreads();
    if (threadIdx.x < kWTile) {
      adb = smem[threadIdx.x];
      for (int q = 1; q < kWThreads / kWTile; ++q) adb += smem[q * kWTile + threadIdx.x];
    }
  }
  const int64_t width = (int64_t)layers * d * r;
  float* p = partial + (int64_t)blockIdx.z * (2 * width + (int64_t)layers * d);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + mrow + 16 * mi + gid + 8 * (c / 2);
        const int k = k0 + ncol + 8 * n + 2 * tid4 + c % 2;
        if (j < d && k < r) p[out * width + ((int64_t)l * d + j) * r + k] = acc[mi][n][c];
      }
    }
  }
  if (k0 == 0 && threadIdx.x < kWTile && j0 + (int)threadIdx.x < d) {
    p[2 * width + (int64_t)l * d + j0 + threadIdx.x] = adb;
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

// ---- The general route: tiled f32 products on the CUDA cores ----
//
// Where the tiles above do not fit (16 rows of the products' [B, d] and
// [B, r] operands past 227 KB, or the weight pass's stages of L - 1 layers
// of f), each layer's products run as separate launches of two kernels
// over device memory, with their elementwise steps fused in:
// - general_rows_kernel<A, BTrans, Epi>: C [batch, n] = A [batch, k] B, a
//   64 x 64 tile of C a block, 16 k-steps of A and B staged in shared
//   memory at a time, 4 x 4 outputs a thread, each a sequential fmaf over k
//   in order. A is read as it is, or as df = g * x0 (prologue); B is W [k,
//   n] or W^T with W [n, k], read from U_l or V_l [d, r] as they are. The
//   epilogue stores C, or computes the forward's f = C + b_l and x_{l+1} =
//   x0 * f + x_l, or the backward's g += C with dx0 += g * f_l. The
//   products over k = d that store C [batch, r] (x_l V_l, df U_l) have few
//   tiles and a long walk: they split k into `splits` slices of
//   k_per_split (blockIdx.y), each storing its C into a [splits, batch, r]
//   scratch that sum_chunks_kernel then adds in slice order.
// - general_weights_kernel<Df>: C [d, r] = sum over a chunk of the batch
//   of A^T B, a 64 (j of d) x 64 (k of r) tile a block, 16 rows staged at a
//   time, each output a sequential fmaf over the chunk's rows in order,
//   into partial[chunk]. A is df = g * x0 (and the k-tile-0 blocks also sum
//   db_l's columns, in row order), or x_l rebuilt as x0 * f_{l-1} + x_{l-1}
//   from the x_{l-1} the previous layer's launch kept, rounded as the
//   forward rounded it, and kept in turn for the next layer.
// Forward, per layer: xv_l = x_l V_l, then f and x_{l+1} = x0 * (xv_l
// U_l^T + b_l) + x_l in place in out. Backward, from the top layer: t_l =
// df U_l (kept, [L, B, r]), then dU_l and db_l from df and xv_l, then g +=
// t_l V_l^T with dx0; then from the bottom layer dV_l = x_l^T t_l, x_l
// rebuilt once a layer in a [2, B, d] scratch; then sum_chunks_kernel adds
// the chunks' partials in chunk order. No atomics: bit for bit on repeat.
// Columns, k-steps and tile counts are 64-bit, so d and r up to 2^31 - 1
// walk without wrapping.
// Bound: operations, as the tiles' (each product 2 B d r f32 operations),
// but on the CUDA cores in f32: 4 B d r L / 67 TFLOP/s forward, twice that
// backward. These kernels are simple, not fast.

constexpr int kGTile = 64;  // a block's 64 x 64 tile of C
constexpr int kGStep = 16;  // k-steps (rows, in the weight kernel) staged at once
constexpr int kGThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kGPad = kGTile + 4;  // row stride of the staged tiles

enum GenA { kAPlain, kADf };
enum GenEpi { kEStore, kEFwdX, kEBwdG };

struct RowsArgs {
  const float* a;     // A [batch, k]; kADf: g, with A = g * x0
  const float* x0;    // [batch, d]
  const float* w;     // B = W [k, n] row-major, or W^T with W [n, k] (BTrans)
  int64_t batch, k, n;
  int64_t k_per_split;  // kEStore: k-steps of a slice (blockIdx.y), a multiple of kGStep
  float* out;         // kEStore: C, [gridDim.y, batch, n]; kEFwdX: x_{l+1}; kEBwdG: g after
  const float* in;    // kEFwdX: x_l; kEBwdG: g before (either may be out)
  const float* bias;  // kEFwdX: b_l
  float* f_out;       // kEFwdX: f_l, or null
  const float* f;     // kEBwdG: f_l
  float* dx0;         // kEBwdG
  bool top, bottom;   // kEBwdG: l == L - 1, l == 0
};

template <int kA, bool kBTrans, int kEpi>
__global__ void __launch_bounds__(kGThreads) general_rows_kernel(const RowsArgs p) {
  __shared__ float sa[kGStep][kGPad];  // [k][row]
  __shared__ float sb[kGStep][kGPad];  // [k][column]
  const int64_t ncols = (p.n + kGTile - 1) / kGTile;
  const int64_t row0 = (int64_t)blockIdx.x / ncols * kGTile;
  const int64_t col0 = (int64_t)blockIdx.x % ncols * kGTile;
  const int64_t k_first = kEpi == kEStore ? (int64_t)blockIdx.y * p.k_per_split : 0;
  const int64_t k_last = kEpi == kEStore && k_first + p.k_per_split < p.k ? k_first + p.k_per_split : p.k;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int64_t k0 = k_first; k0 < k_last; k0 += kGStep) {
    for (int e = threadIdx.x; e < kGTile * kGStep; e += kGThreads) {
      const int rr = e / kGStep;
      const int kk = e % kGStep;
      const int64_t row = row0 + rr;
      float a = 0.0f;
      if (row < p.batch && k0 + kk < k_last) {
        const int64_t at = row * p.k + k0 + kk;
        a = kA == kADf ? __fmul_rn(p.a[at], p.x0[at]) : p.a[at];
      }
      sa[kk][rr] = a;
      const int kb = kBTrans ? e % kGStep : e / kGTile;
      const int cb = kBTrans ? e / kGStep : e % kGTile;
      float b = 0.0f;
      if (k0 + kb < k_last && col0 + cb < p.n) {
        b = kBTrans ? p.w[(col0 + cb) * p.k + k0 + kb] : p.w[(k0 + kb) * p.n + col0 + cb];
      }
      sb[kb][cb] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGStep; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = sa[kk][ty + 16 * i];
        bv[i] = sb[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = col0 + tx + 16 * j;
      if (row >= p.batch || c >= p.n) continue;
      const int64_t at = row * p.n + c;
      if (kEpi == kEStore) {
        p.out[(int64_t)blockIdx.y * p.batch * p.n + at] = acc[i][j];
      } else if (kEpi == kEFwdX) {
        const float fv = __fadd_rn(acc[i][j], p.bias[c]);
        p.out[at] = __fadd_rn(__fmul_rn(p.x0[at], fv), p.in[at]);
        if (p.f_out != nullptr) p.f_out[at] = fv;
      } else {
        const float g_old = p.in[at];
        const float g_new = __fadd_rn(g_old, acc[i][j]);
        p.out[at] = g_new;
        const float gf = __fmul_rn(g_old, p.f[at]);
        const float dx = p.top ? gf : __fadd_rn(p.dx0[at], gf);
        p.dx0[at] = p.bottom ? __fadd_rn(dx, g_new) : dx;
      }
    }
  }
}

struct WeightsArgs {
  const float* g;       // Df: the gradient with respect to x_{l+1}
  const float* x0;      // [batch, d]
  const float* f_prev;  // !Df, l >= 1: f_{l-1}
  const float* x_prev;  // !Df: x_{l-1} (x0 at l = 1); null at l = 0 (x_l = x0)
  float* x_keep;        // !Df: where x_l is kept for the next layer, or null
  const float* bm;      // B rows [batch, r]: xv_l (Df) or t_l
  float* partial;       // [chunks][total]
  int64_t batch, rows_per_chunk, total;
  int64_t d, r;
  int64_t out_at;       // dU_l's or dV_l's offset in a chunk's partial
  int64_t db_at;        // Df: db_l's offset
};

template <bool kDf>
__global__ void __launch_bounds__(kGThreads) general_weights_kernel(const WeightsArgs p) {
  __shared__ float sa[kGStep][kGPad];  // [row][j]
  __shared__ float sb[kGStep][kGPad];  // [row][k]
  const int64_t jtiles = (p.d + kGTile - 1) / kGTile;
  const int64_t j0 = (int64_t)blockIdx.x % jtiles * kGTile;
  const int64_t k0 = (int64_t)blockIdx.x / jtiles * kGTile;
  const int64_t first = (int64_t)blockIdx.y * p.rows_per_chunk;
  const int64_t last = first + p.rows_per_chunk < p.batch ? first + p.rows_per_chunk : p.batch;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool sums_db = kDf && k0 == 0 && threadIdx.x < kGTile;
  float acc[4][4] = {};
  float db = 0.0f;
  for (int64_t i0 = first; i0 < last; i0 += kGStep) {
    for (int e = threadIdx.x; e < kGTile * kGStep; e += kGThreads) {
      const int rr = e / kGTile;
      const int cc = e % kGTile;
      const int64_t row = i0 + rr;
      float a = 0.0f;
      float b = 0.0f;
      if (row < last && j0 + cc < p.d) {
        const int64_t at = row * p.d + j0 + cc;
        if (kDf) {
          a = __fmul_rn(p.g[at], p.x0[at]);
        } else if (p.x_prev == nullptr) {
          a = p.x0[at];
        } else {
          a = __fadd_rn(__fmul_rn(p.x0[at], p.f_prev[at]), p.x_prev[at]);
          if (p.x_keep != nullptr && k0 == 0) p.x_keep[at] = a;
        }
      }
      if (row < last && k0 + cc < p.r) b = p.bm[row * p.r + k0 + cc];
      sa[rr][cc] = a;
      sb[rr][cc] = b;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kGStep; ++rr) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = sa[rr][ty + 16 * i];
        bv[i] = sb[rr][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (sums_db) {
      for (int rr = 0; rr < kGStep; ++rr) db = __fadd_rn(db, sa[rr][threadIdx.x]);
    }
    __syncthreads();
  }
  float* out = p.partial + (int64_t)blockIdx.y * p.total;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t j = j0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t k = k0 + tx + 16 * c;
      if (j < p.d && k < p.r) out[p.out_at + j * p.r + k] = acc[i][c];
    }
  }
  if (sums_db && j0 + threadIdx.x < p.d) out[p.db_at + j0 + threadIdx.x] = db;
}

template <int kA, bool kBTrans, int kEpi>
int launch_rows(const RowsArgs& p, int splits, cudaStream_t s) {
  const int64_t tiles = (p.batch + kGTile - 1) / kGTile * ((p.n + kGTile - 1) / kGTile);
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  general_rows_kernel<kA, kBTrans, kEpi><<<dim3((unsigned)tiles, splits), kGThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// C [batch, r] = A [batch, d] W (x_l V_l, or df U_l with kADf) into c, in
// `splits` slices of k through split_scratch [splits, batch, r] where
// splits > 1.
template <int kA>
int launch_rows_split(RowsArgs p, float* c, float* split_scratch, int splits, cudaStream_t s) {
  const int64_t steps = (p.k + kGStep - 1) / kGStep;
  p.k_per_split = (steps + splits - 1) / splits * kGStep;
  p.out = splits > 1 ? split_scratch : c;
  int err = launch_rows<kA, false, kEStore>(p, splits, s);
  if (err != 0 || splits == 1) return err;
  const int64_t total = p.batch * p.n;
  sum_chunks_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      split_scratch, c, splits, total);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDf>
int launch_weights(const WeightsArgs& p, int chunks, cudaStream_t s) {
  const int64_t tiles = (p.d + kGTile - 1) / kGTile * ((p.r + kGTile - 1) / kGTile);
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  general_weights_kernel<kDf><<<dim3((unsigned)tiles, chunks), kGThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The general route of the forward (see above): x0 [batch, d], u and v
// [layers, d, r], b [layers, d]; out [batch, d]; xv_l into xv_out (training)
// or into xv_scratch [batch, r]; split_scratch [splits, batch, r] where
// splits > 1.
int general_fwd(const float* x0, const float* u, const float* v, const float* b, float* out,
                float* f_out, float* xv_out, float* xv_scratch, float* split_scratch,
                int64_t batch, int64_t d, int64_t r, int layers, int splits, cudaStream_t s) {
  for (int l = 0; l < layers; ++l) {
    const float* xl = l == 0 ? x0 : out;
    float* xvl = xv_out != nullptr ? xv_out + (int64_t)l * batch * r : xv_scratch;
    RowsArgs p{};
    p.a = xl;
    p.x0 = x0;
    p.w = v + (int64_t)l * d * r;
    p.batch = batch;
    p.k = d;
    p.n = r;
    int err = launch_rows_split<kAPlain>(p, xvl, split_scratch, splits, s);
    if (err != 0) return err;
    p.a = xvl;
    p.w = u + (int64_t)l * d * r;
    p.k = r;
    p.n = d;
    p.out = out;
    p.in = xl;
    p.bias = b + (int64_t)l * d;
    p.f_out = f_out != nullptr ? f_out + (int64_t)l * batch * d : nullptr;
    err = launch_rows<kAPlain, true, kEFwdX>(p, 1, s);
    if (err != 0) return err;
  }
  return 0;
}

// The general route of the backward (see above). t [layers, batch, r],
// g_scratch [batch, d], x_scratch [2, batch, d] (null where layers < 3),
// partial [chunks, 2 layers d r + layers d] and split_scratch [splits,
// batch, r] (where splits > 1) are scratch.
int general_bwd(const float* x0, const float* u, const float* v, const float* f, const float* xv,
                const float* g, float* dx0, float* grads, float* t, float* g_scratch,
                float* x_scratch, float* partial, float* split_scratch, int64_t batch, int64_t d,
                int64_t r, int layers, int chunks, int splits, cudaStream_t s) {
  const int64_t width = (int64_t)layers * d * r;
  const int64_t total = 2 * width + (int64_t)layers * d;
  const int64_t bd = batch * d;
  WeightsArgs w{};
  w.x0 = x0;
  w.partial = partial;
  w.batch = batch;
  w.rows_per_chunk = (batch + chunks - 1) / chunks;
  w.total = total;
  w.d = d;
  w.r = r;
  for (int l = layers - 1; l >= 0; --l) {
    const float* gl = l == layers - 1 ? g : g_scratch;
    float* tl = t + (int64_t)l * batch * r;
    RowsArgs p{};
    p.a = gl;  // t_l = (g * x0) U_l
    p.x0 = x0;
    p.w = u + (int64_t)l * d * r;
    p.batch = batch;
    p.k = d;
    p.n = r;
    int err = launch_rows_split<kADf>(p, tl, split_scratch, splits, s);
    if (err != 0) return err;
    w.g = gl;  // dU_l = df^T xv_l, db_l = sum df
    w.bm = xv + (int64_t)l * batch * r;
    w.out_at = (int64_t)l * d * r;
    w.db_at = 2 * width + (int64_t)l * d;
    err = launch_weights<true>(w, chunks, s);
    if (err != 0) return err;
    p.a = tl;  // g += t_l V_l^T, dx0 += g * f_l
    p.w = v + (int64_t)l * d * r;
    p.k = r;
    p.n = d;
    p.out = g_scratch;
    p.in = gl;
    p.f = f + (int64_t)l * bd;
    p.dx0 = dx0;
    p.top = l == layers - 1;
    p.bottom = l == 0;
    err = launch_rows<kAPlain, true, kEBwdG>(p, 1, s);
    if (err != 0) return err;
  }
  for (int l = 0; l < layers; ++l) {  // dV_l = x_l^T t_l
    w.f_prev = l > 0 ? f + (int64_t)(l - 1) * bd : nullptr;
    w.x_prev = l == 0 ? nullptr : l == 1 ? x0 : x_scratch + (int64_t)((l - 1) & 1) * bd;
    w.x_keep = l >= 1 && l < layers - 1 ? x_scratch + (int64_t)(l & 1) * bd : nullptr;
    w.bm = t + (int64_t)l * batch * r;
    w.out_at = width + (int64_t)l * d * r;
    const int err = launch_weights<false>(w, chunks, s);
    if (err != 0) return err;
  }
  sum_chunks_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      partial, grads, chunks, total);
  return static_cast<int>(cudaGetLastError());
}

// Whether the tiles above take d and r: 16 rows of the products' [B, d] and
// [B, r] A operands (the forward's x and xv, the row pass's df and t) fit a
// block's 227 KB. The wrapper sends other shapes to the general route.
bool tiles_take(long long d, long long r) {
  return d <= (1 << 20) && r <= (1 << 20) && fwd_smem_bytes((int)d, (int)r, 1, false) <= kMaxSmem;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

}  // namespace

// x0 [batch, d]; b [layers, d]; out [batch, d]; f_out [layers, batch, d]
// and xv_out [layers, batch, r], both or neither null. `general` picks the
// route (the wrapper's choice by shape, cross_v2_cuda.py _fwd_route): 0,
// the tiles, which read V and U^T as B fragments (vfrag [layers, d8/8,
// r8/8, 32, 2] and utfrag [layers, r8/8, d8/8, 32, 2], d8 and r8: d and r
// rounded up to 8; see cross_v2_fwd_kernel); 1, the general route, which
// reads u and v [layers, d, r] as they are, writes xv_l into xv_scratch
// [batch, r] where xv_out is null, and splits its x_l V_l into `splits`
// slices of k through split_scratch [splits, batch, r] where splits > 1.
// A pointer the route does not read may be null. All f32, contiguous,
// 16-byte aligned, on the current device; runs on `stream`. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for d, r, layers, batch or
// splits < 1, d or r past 2^31 - 1, splits past 65535, tiles that do not
// take d and r, or a null pointer the route reads.
extern "C" int tfrec_cross_v2_fwd(const void* x0, const void* vfrag, const void* utfrag,
                                  const void* u, const void* v, const void* b, void* out,
                                  void* f_out, void* xv_out, void* xv_scratch,
                                  void* split_scratch, long long batch, long long d, long long r,
                                  long long layers, long long splits, int general, void* stream) {
  if (d < 1 || r < 1 || layers < 1 || batch < 1 || splits < 1 || splits > 65535 ||
      d > 0x7FFFFFFF || r > 0x7FFFFFFF || layers > 0x7FFFFFFF ||
      (f_out == nullptr) != (xv_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (general) {
    if (u == nullptr || v == nullptr || (xv_out == nullptr && xv_scratch == nullptr) ||
        (splits > 1 && split_scratch == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return general_fwd(static_cast<const float*>(x0), static_cast<const float*>(u),
                       static_cast<const float*>(v), static_cast<const float*>(b),
                       static_cast<float*>(out), static_cast<float*>(f_out),
                       static_cast<float*>(xv_out), static_cast<float*>(xv_scratch),
                       static_cast<float*>(split_scratch), batch, d, r, (int)layers, (int)splits,
                       static_cast<cudaStream_t>(stream));
  }
  if (!tiles_take(d, r) || vfrag == nullptr || utfrag == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 32 rows a block where x and xv fit in shared memory, else 16; x0 held
  // beside them where 32 rows of it fit too.
  const bool x0_shared = fwd_smem_bytes((int)d, (int)r, 2, true) <= kMaxSmem;
  const int m = x0_shared || fwd_smem_bytes((int)d, (int)r, 2, false) <= kMaxSmem ? 2 : 1;
  const size_t smem = fwd_smem_bytes((int)d, (int)r, m, x0_shared);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = x0_shared ? cross_v2_fwd_kernel<2, true>
                : m == 2  ? cross_v2_fwd_kernel<2, false>
                          : cross_v2_fwd_kernel<1, false>;
  const int err = set_smem((const void*)kernel, smem);
  if (err != 0) return err;
  const int64_t blocks = (batch + 16 * m - 1) / (16 * m);
  kernel<<<(unsigned)blocks, 256 * m, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float2*>(vfrag),
      static_cast<const float2*>(utfrag), static_cast<const float*>(b),
      static_cast<float*>(out), static_cast<float*>(f_out), static_cast<float*>(xv_out),
      batch, (int)d, (int)r, (int)layers);
  return static_cast<int>(cudaGetLastError());
}

// x0 and g [batch, d], f [layers, batch, d] and xv [layers, batch, r] (from
// the forward); writes dx0 [batch, d] and grads [dU (layers*d*r), dV
// (layers*d*r), db (layers*d)]. `general` picks the route (the wrapper's
// choice by shape, cross_v2_cuda.py _bwd_route): 0, the tiles, which read
// U and V^T as B fragments (ufrag [layers, d8/8, r8/8, 32, 2] and vtfrag
// [layers, r8/8, d8/8, 32, 2], d8 and r8: d and r rounded up to 8; see
// cross_v2_bwd_rows_kernel) and use df [layers, batch, d8], t [layers,
// batch, r8], partial [chunks, grads] and g_scratch
// [tfrec_cross_v2_bwd_scratch_rows(batch, d, r), d8] (null where that is
// 0) as scratch; 1, the general route, which reads u and v [layers, d, r]
// as they are and uses t [layers, batch, r], g_scratch [batch, d],
// x_scratch [2, batch, d] (null where layers < 3), partial and, where
// splits > 1, split_scratch [splits, batch, r] (its df U_l in `splits`
// slices of k) as scratch. A pointer the route does not read may be null.
// All f32, contiguous, 16-byte aligned, on the current device; runs on
// `stream`. Returns the first launch error, or cudaErrorInvalidValue for
// d, r, layers, batch, chunks or splits < 1, d, r or layers past 2^31 - 1,
// chunks or splits past 65535, tiles that do not take the shape, or a null
// pointer the route reads.
extern "C" int tfrec_cross_v2_bwd(const void* x0, const void* ufrag, const void* vtfrag,
                                  const void* u, const void* v, const void* f, const void* xv,
                                  const void* g, void* dx0, void* grads, void* df, void* t,
                                  void* g_scratch, void* x_scratch, void* partial,
                                  void* split_scratch, long long batch, long long d, long long r,
                                  long long layers, long long chunks, long long splits,
                                  int general, void* stream) {
  if (d < 1 || r < 1 || layers < 1 || batch < 1 || chunks < 1 || chunks > 65535 ||
      splits < 1 || splits > 65535 || d > 0x7FFFFFFF || r > 0x7FFFFFFF ||
      layers > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (general) {
    if (u == nullptr || v == nullptr || t == nullptr || g_scratch == nullptr ||
        partial == nullptr || (layers >= 3 && x_scratch == nullptr) ||
        (splits > 1 && split_scratch == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return general_bwd(static_cast<const float*>(x0), static_cast<const float*>(u),
                       static_cast<const float*>(v), static_cast<const float*>(f),
                       static_cast<const float*>(xv), static_cast<const float*>(g),
                       static_cast<float*>(dx0), static_cast<float*>(grads),
                       static_cast<float*>(t), static_cast<float*>(g_scratch),
                       static_cast<float*>(x_scratch), static_cast<float*>(partial),
                       static_cast<float*>(split_scratch), batch, d, r, (int)layers,
                       (int)chunks, (int)splits, static_cast<cudaStream_t>(stream));
  }
  if (!tiles_take(d, r) || layers > 1024 || ufrag == nullptr || vtfrag == nullptr ||
      df == nullptr || t == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RowsLayout layout = rows_layout((int)d, (int)r);
  const int m = layout.m;
  const bool g_shared = layout.g_shared;
  const size_t smem = rows_smem_bytes((int)d, (int)r, m, g_shared);
  const int rows = weights_rows((int)layers);
  if (smem > kMaxSmem || rows == 0 || (!g_shared && g_scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t wsmem = weights_smem_bytes((int)layers, rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto rows_kernel = !g_shared ? cross_v2_bwd_rows_kernel<1, false>
                     : m == 2  ? cross_v2_bwd_rows_kernel<2, true>
                               : cross_v2_bwd_rows_kernel<1, true>;
  int err = set_smem((const void*)rows_kernel, smem);
  if (err != 0) return err;
  auto weights_kernel = rows == 32   ? cross_v2_bwd_weights_kernel<32>
                        : rows == 16 ? cross_v2_bwd_weights_kernel<16>
                                     : cross_v2_bwd_weights_kernel<8>;
  err = set_smem((const void*)weights_kernel, wsmem);
  if (err != 0) return err;
  const int64_t blocks = (batch + 16 * m - 1) / (16 * m);
  rows_kernel<<<(unsigned)blocks, 256 * m, smem, s>>>(
      static_cast<const float*>(x0), static_cast<const float2*>(ufrag),
      static_cast<const float2*>(vtfrag), static_cast<const float*>(f),
      static_cast<const float*>(g), static_cast<float*>(dx0), static_cast<float*>(df),
      static_cast<float*>(t), static_cast<float*>(g_scratch), batch, (int)d, (int)r,
      (int)layers);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t rows_per_chunk = (batch + chunks - 1) / chunks;
  const int tiles = (int)(((d + kWTile - 1) / kWTile) * ((r + kWTile - 1) / kWTile));
  const dim3 grid((unsigned)tiles, (unsigned)layers, (unsigned)chunks);
  weights_kernel<<<grid, kWThreads, wsmem, s>>>(
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

// Rows of the g scratch that tfrec_cross_v2_bwd takes for these shapes: 0
// where its row pass holds g in shared memory, else the batch rounded up to
// the pass's rows a block.
extern "C" int tfrec_cross_v2_bwd_scratch_rows(long long batch, long long d, long long r) {
  const RowsLayout layout = rows_layout((int)d, (int)r);
  return layout.g_shared ? 0 : (int)((batch + 16 * layout.m - 1) / (16 * layout.m) * 16 * layout.m);
}
