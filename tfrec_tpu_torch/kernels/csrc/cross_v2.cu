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
// launch of 3xTF32 tiled products on the tensor cores that stream their
// operands from device memory, with its elementwise steps fused, in fixed
// orders, no atomics. The wrapper
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

// ---- The general route: 3xTF32 tiled products over device memory ----
//
// Where the tiles above do not fit (16 rows of the products' [B, d] and
// [B, r] operands past 227 KB, or the weight pass's stages of L - 1 layers
// of f), each layer's products run as separate launches of two kernels
// over device memory, with their elementwise steps fused in:
// - general_rows_kernel<A, BTrans, Epi>: C [batch, n] = A [batch, k] B. A
//   is read as it is, or as df = g * x0 (prologue); B is W [k, n] or W^T
//   with W [n, k], read from U_l or V_l [d, r] as they are. The epilogue
//   stores C, or computes the forward's f = C + b_l and x_{l+1} = x0 * f +
//   x_l, or the backward's g += C with dx0 += g * f_l. The products over
//   k = d that store C [batch, r] (x_l V_l, df U_l) have few tiles at a
//   small batch: they split k into `splits` slices of k_per_split
//   (blockIdx.y), each storing its C into a [splits, batch, r] scratch that
//   sum_chunks_kernel then adds in slice order.
// - general_weights_kernel<A>: C [d, r] = sum over a chunk of the batch of
//   A^T B into partial[chunk]. A is df = g * x0 (and the blocks of the
//   first tile of r also sum db_l's columns, in row order), x0 (l = 0), or
//   x_l rebuilt as x0 * f_{l-1} + x_{l-1} from the x_{l-1} the previous
//   layer's launch kept, rounded as the forward rounded it, and kept in
//   turn for the next layer.
// Forward, per layer: xv_l = x_l V_l, then f and x_{l+1} = x0 * (xv_l
// U_l^T + b_l) + x_l in place in out. Backward, from the top layer: t_l =
// df U_l (kept, [L, B, r]), then dU_l and db_l from df and xv_l, then g +=
// t_l V_l^T with dx0; then from the bottom layer dV_l = x_l^T t_l, x_l
// rebuilt once a layer in a [2, B, d] scratch; then sum_chunks_kernel adds
// the chunks' partials in chunk order. No atomics: bit for bit on repeat.
// Columns, k-steps and tile counts are 64-bit, so d and r up to 2^31 - 1
// walk without wrapping.
//
// Bound: operations. Every product is 2 B d r operations, run as 3xTF32
// on the tensor cores like the tiles': 3 x 4 B d r L TF32 operations
// forward and 3 x 8 B d r L backward at 495 TFLOP/s, plus the elementwise
// steps. At B=32768, d=3341, r=512, L=3: 2018 G TF32 operations, 4.08 ms,
// forward (0.51 ms at B=4096, serving) and 8.15 ms backward; the
// elementwise steps are 15 us at 67 TFLOP/s, and the bytes (x0, x_L, f
// and xv written once, 1.8 GB forward) 0.53 ms, under the operations.
//
// Design. Both kernels share one tiled product (gen_product) on Hopper's
// warpgroup mma (wgmma.mma_async m64n128k8, TF32 in, f32 sums): a block of
// two warpgroups owns a 128 x 128 tile of C, each warpgroup 64 rows of it
// (64 sums a thread, and 64 of a fresh sum). Stages of 16 k-steps (rows,
// in the weight products) of A and B stream from device memory into a
// ring of up to 6 stages in shared memory with cp.async (16-byte copies
// where the rows allow, else 4-byte), so that the next stages load while
// one multiplies; no whole row is held. A stage is raw f32, laid out as the
// source lies (K-major [128][16] or M- and N-major [16][128]) with an XOR
// swizzle of 16-byte chunks, so that the reads below hit 32 distinct banks.
// B is split once a block into its TF32 high parts and remainders, written
// in the K-major layout that wgmma reads from shared memory (split_b); A
// is split as each lane loads its fragment (with the prologue: g * x0, or
// x_l's rebuild) and handed to wgmma in registers, so that every operand,
// whatever its major order in device memory, reaches the tensor cores
// K-major. A stage's products, lo B_hi and hi B_lo of both its k8 steps,
// then hi B_hi of both, are summed by the tensor cores into a fresh sum,
// which is then added to the f32 sum with __fadd_rn (mma_3xtf32 does the
// same a k8 step; over two, the errors stay within the tolerances the tiles
// keep). The tensor cores' sums shrink toward zero (they truncate), and
// every product added after a large one is cut at that one's last bit: with
// the high parts' products last, a stage's sum shrinks a third less (dU and
// dV at the benchmark's shapes 1.2e-7 of themselves against float64, not
// 1.8e-7; cuBLAS f32 shrinks 1e-8 but errs 1.2e-6 either way, this route
// 3.2e-7). While they run, the block stages, splits and loads the next stage
// (two split stages of B, two sets of A's fragments). What holds it at the
// benchmark's shape is not the tensor cores but this stage pipeline, one
// block an SM: with the products and splits taken out it takes 34 of the
// 49 ms of a training call's products (tools/ab_cross_v2.py; PERF.md).

constexpr int kGM = 128;  // a block's tile of C: 128 rows (M) ...
constexpr int kGN = 128;  // ... by 128 columns (N)
constexpr int kGK = 16;  // k-steps (rows, in the weight products) of a stage
// Two warpgroups; warp w owns rows 16 w .. 16 w + 15 of the tile, and
// warpgroup w / 4 rows 64 (w / 4) .. 64 (w / 4) + 63.
constexpr int kGThreads = 256;
constexpr int kGFloatsA = kGM * kGK;  // a staged tile of A, 8 KB
constexpr int kGFloatsB = kGN * kGK;  // a staged tile of B, 8 KB
constexpr size_t kGMaxSmem = kMaxSmem;  // one block an SM

// How A is read: K-major ([m][k] rows of the source: x_l, xv, t) as it is
// or as g * x0; M-major ([k][m]: the weight products' df^T and x_l^T) as
// it is (x0), as g * x0, or as x0 * f_{l-1} + x_{l-1}.
enum GenA { kAK, kAKDf, kAM, kAMDf, kAMX };
enum GenEpi { kEStore, kEFwdX, kEBwdG };

__host__ __device__ constexpr int a_tiles(int a) {
  return a == kAKDf || a == kAMDf ? 2 : a == kAMX ? 3 : 1;
}
__host__ __device__ constexpr bool a_kmajor(int a) { return a == kAK || a == kAKDf; }
__host__ __device__ constexpr int g_stage_bytes(int a) {
  return (a_tiles(a) * kGFloatsA + kGFloatsB) * 4;
}
// Stages of the ring: as many as fit beside B's two split stages (4 x 8
// KB), at most 6.
__host__ __device__ constexpr int g_stages(int a) {
  return (kGMaxSmem - 4 * kGFloatsB * 4) / g_stage_bytes(a) > 6
             ? 6
             : (int)((kGMaxSmem - 4 * kGFloatsB * 4) / g_stage_bytes(a));
}
__host__ __device__ constexpr size_t g_smem(int a) {
  return (size_t)g_stages(a) * g_stage_bytes(a) + 4 * kGFloatsB * 4;
}

// Word of element (m, k) of a K-major staged tile of A [128][16]: 16-byte
// chunk k / 4 of row m XOR (m & 2), so that the fragment reads (rows gid,
// columns 2 tid4, 8 bytes) hit 32 distinct banks in each half warp.
__device__ __forceinline__ int rows_at(int m, int k) {
  return m * kGK + (((k >> 2) ^ (m & 2)) << 2) + (k & 3);
}

// Word of element (n, k) of a K-major staged tile of B [128][16]: chunk k /
// 4 of row n XOR (n / 2 % 4), so that eight threads reading a chunk of
// eight consecutive rows hit 32 distinct banks.
__device__ __forceinline__ int rows_b_at(int n, int k) {
  return n * kGK + (((k >> 2) ^ ((n >> 1) & 3)) << 2) + (k & 3);
}

// Word of element (k, m) of an M- or N-major staged tile [16][W]: 16-byte
// chunk m / 4 of row k XOR (k & 6), so that the fragment reads (rows 2 tid4
// and 2 tid4 + 1, columns gid) and the reads of one column a thread hit 32
// distinct banks.
template <int W>
__device__ __forceinline__ int cols_at(int k, int m) {
  return k * W + ((((m >> 2) ^ (k & 6))) << 2) + (m & 3);
}

// Stage rows [r0, r0 + W) x columns [c0, c0 + 16) of src (row stride ld)
// into a K-major tile (B's swizzle with kB, else A's), zero past row rlim
// and column clim. Thread t copies column t % 16 (16-byte chunk t % 4) of
// every 16th (64th) row.
template <int W, bool kB>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int64_t ld,
                                           int64_t r0, int64_t rlim, int64_t c0, int64_t clim,
                                           bool vec) {
  auto at = [](int m, int k) { return kB ? rows_b_at(m, k) : rows_at(m, k); };
  if (vec) {
    constexpr int kDown = kGThreads / 4;  // rows a pass
    const int m = threadIdx.x / 4;
    const int k = threadIdx.x % 4 * 4;
    const bool kok = c0 + k < clim;
    const float* from = src + (r0 + m) * ld + c0 + k;
#pragma unroll
    for (int it = 0; it < W / kDown; ++it) {
      const bool ok = kok && r0 + m + kDown * it < rlim;
      cp_async16(dst + at(m + kDown * it, k), ok ? from + (int64_t)kDown * it * ld : src, ok);
    }
  } else {
    constexpr int kDown = kGThreads / 16;  // rows a pass
    const int m = threadIdx.x / 16;
    const int k = threadIdx.x % 16;
    const bool kok = c0 + k < clim;
    const float* from = src + (r0 + m) * ld + c0 + k;
#pragma unroll
    for (int it = 0; it < W / kDown; ++it) {
      const bool ok = kok && r0 + m + kDown * it < rlim;
      cp_async4(dst + at(m + kDown * it, k), ok ? from + (int64_t)kDown * it * ld : src, ok);
    }
  }
}

// Stage rows [r0, r0 + 16) x columns [c0, c0 + W) of src into an M- or
// N-major tile, zero past row rlim and column clim.
template <int W>
__device__ __forceinline__ void stage_cols(float* dst, const float* __restrict__ src, int64_t ld,
                                           int64_t r0, int64_t rlim, int64_t c0, int64_t clim,
                                           bool vec) {
  if (vec) {
    constexpr int kAcross = W / 4;  // 16-byte chunks a row
    const int k = threadIdx.x / kAcross;
    const int m = threadIdx.x % kAcross * 4;
    const bool mok = c0 + m < clim;
    const float* from = src + (r0 + k) * ld + c0 + m;
#pragma unroll
    for (int it = 0; it < kGK * kAcross / kGThreads; ++it) {
      const int kk = k + it * (kGThreads / kAcross);
      const bool ok = mok && r0 + kk < rlim;
      cp_async16(dst + cols_at<W>(kk, m), ok ? from + (int64_t)(kk - k) * ld : src, ok);
    }
  } else {
    const int k = threadIdx.x / W;
    const int m = threadIdx.x % W;
    const bool mok = c0 + m < clim;
    const float* from = src + (r0 + k) * ld + c0 + m;
#pragma unroll
    for (int it = 0; it < kGK * W / kGThreads; ++it) {
      const int kk = k + it * (kGThreads / W);
      const bool ok = mok && r0 + kk < rlim;
      cp_async4(dst + cols_at<W>(kk, m), ok ? from + (int64_t)(kk - k) * ld : src, ok);
    }
  }
}

__device__ __forceinline__ bool vec_ok(const float* p, int64_t ld) {
  return (ld & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Element (m, k) of a stage's M-major A, prologue applied: the tiles are x0
// (kAM), g and x0 (kAMDf) or x0, f_{l-1} and x_{l-1} (kAMX).
template <int kA>
__device__ __forceinline__ float a_elem(const float* st, int m, int k) {
  const int at = cols_at<kGM>(k, m);
  if (kA == kAM) return st[at];
  if (kA == kAMDf) return __fmul_rn(st[at], st[kGFloatsA + at]);
  return __fadd_rn(__fmul_rn(st[at], st[kGFloatsA + at]), st[2 * kGFloatsA + at]);
}

// B's split stage: bs holds B's TF32 high parts, [4 k/4][16 n/8][8 n % 8][4
// k % 4] words (the K-major layout of wgmma's B without swizzle: core
// matrices of 8 rows of 16 bytes, 128 bytes apart along n, 2048 along k),
// then its remainders in the same layout. Within a k8 step the positions
// are a permutation of the staged columns: position q holds column 2 q and
// position 4 + q column 2 q + 1 (q < 4), so that a lane's A fragment, whose
// logical k are tid4 and tid4 + 4, is columns 2 tid4 and 2 tid4 + 1 of A
// (one 8-byte read). Thread t splits k8 step t / 128 of row t % 128.
static_assert(kGThreads == 2 * kGN && kGK == 16, "split_b's threads");
template <bool kBTrans>
__device__ __forceinline__ void split_b(const float* bt, uint32_t* bs) {
  const int n = threadIdx.x % kGN;
  const int ks = threadIdx.x / kGN;
  float v[8];
  if (kBTrans) {
#pragma unroll
    for (int c = 0; c < 8; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(bt + rows_b_at(n, 8 * ks + c));
      v[c] = q.x;
      v[c + 1] = q.y;
      v[c + 2] = q.z;
      v[c + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = bt[cols_at<kGN>(8 * ks + c, n)];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // positions 4 h .. 4 h + 3 of the k8 step: columns h, h + 2, ...
    uint4 hi, lo;
    split(v[h], hi.x, lo.x);
    split(v[h + 2], hi.y, lo.y);
    split(v[h + 4], hi.z, lo.z);
    split(v[h + 6], hi.w, lo.w);
    const int at = (2 * ks + h) * (kGN * 4) + n * 4;
    *reinterpret_cast<uint4*>(bs + at) = hi;
    *reinterpret_cast<uint4*>(bs + kGFloatsB + at) = lo;
  }
}

// The shared-memory matrix descriptor of a K-major tile in bs's layout:
// start address, leading (k) byte offset 2048, stride (n) byte offset 128,
// no swizzle.
__device__ __forceinline__ uint64_t b_desc(const uint32_t* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(2048 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d = A B (scale_d 0) or d += A B (scale_d 1) for the warpgroup's 64 x 128
// tile over one k8 step, TF32 in, f32 sums, issued asynchronously: a holds
// the lane's A fragment in the m16n8k8 order (rows 16 warp + gid (+8),
// logical k tid4 (+4)), desc B's K-major hi or lo tile in shared memory.
// d's element 4 j + q is row 16 warp + gid + 8 (q / 2), column 8 j + 2 tid4
// + q % 2.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc += A B over k in [k_first, k_last) for the block's 128 x 128 tile of
// C at rows m0.. (< mlim) and columns n0.. (< nlim); warpgroup w holds rows
// 64 w .. 64 w + 63 of it, in wgmma_tf32's order. A's sources a0, a1, a2
// (row stride lda; a1 and a2 where the prologue reads them), B's b (row
// stride ldb): N-major (B[k][n] = b[k ldb + n]) or, with kBTrans, K-major
// (B[k][n] = b[n ldb + k]). on_stage(stage, k) sees each staged stage of
// rows k.. before its products. Each stage: B is split once into its high
// parts and remainders (split_b), the lanes split their A fragments as they
// load them, and the tensor cores run lo B_hi and hi B_lo of both k8 steps,
// then hi B_hi of both, into a fresh sum, which is added to acc with
// __fadd_rn.
template <int kA, bool kBTrans, typename OnStage>
__device__ __forceinline__ void gen_product(const float* a0, const float* a1, const float* a2,
                                            int64_t lda, const float* b, int64_t ldb, int64_t m0,
                                            int64_t mlim, int64_t n0, int64_t nlim,
                                            int64_t k_first, int64_t k_last, float (&acc)[64],
                                            OnStage on_stage) {
  constexpr int kNA = a_tiles(kA);
  constexpr int kStages = g_stages(kA);
  constexpr int kStage = g_stage_bytes(kA) / 4;
  extern __shared__ float4 gsmem4[];
  float* smem = reinterpret_cast<float*>(gsmem4);
  uint32_t* bs = reinterpret_cast<uint32_t*>(smem + kStages * kStage);
  const float* asrc[3] = {a0, a1, a2};
  bool avec[3];
#pragma unroll
  for (int i = 0; i < kNA; ++i) avec[i] = vec_ok(asrc[i], lda);
  const bool bvec = vec_ok(b, ldb);
  const int64_t steps = k_last > k_first ? (k_last - k_first + kGK - 1) / kGK : 0;
  auto issue = [&](int64_t s) {
    if (s < steps) {
      float* st = smem + (int)(s % kStages) * kStage;
      const int64_t k0 = k_first + s * kGK;
#pragma unroll
      for (int i = 0; i < kNA; ++i) {
        if (a_kmajor(kA)) {
          stage_rows<kGM, false>(st + i * kGFloatsA, asrc[i], lda, m0, mlim, k0, k_last, avec[i]);
        } else {
          stage_cols<kGM>(st + i * kGFloatsA, asrc[i], lda, k0, k_last, m0, mlim, avec[i]);
        }
      }
      if (kBTrans) {
        stage_rows<kGN, true>(st + kNA * kGFloatsA, b, ldb, n0, nlim, k0, k_last, bvec);
      } else {
        stage_cols<kGN>(st + kNA * kGFloatsA, b, ldb, k0, k_last, n0, nlim, bvec);
      }
    }
    asm volatile("cp.async.commit_group;");
  };
  const int lane = threadIdx.x % 32;
  const int m = (threadIdx.x / 32) * 16 + lane / 4;  // the lane's rows of A: m and m + 8
  float p[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) p[i] = 0.0f;
  // Stage s's B, split, in bs[s % 2]; its A fragments, split, in registers.
  // Stage s + 1 is prepared while the tensor cores run stage s.
  auto prepare = [&](int64_t s, uint32_t (&ahi)[kGK / 8][4], uint32_t (&alo)[kGK / 8][4]) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 2) : "memory");
    __syncthreads();  // stage s has landed; every thread is done with stage s - 1's raw slot
    issue(s + kStages - 1);  // into stage s - 1's slot
    const float* st = smem + (int)(s % kStages) * kStage;
    on_stage(st, k_first + s * kGK);
    split_b<kBTrans>(st + kNA * kGFloatsA, bs + (int)(s % 2) * 2 * kGFloatsB);
#pragma unroll
    for (int ks = 0; ks < kGK / 8; ++ks) {
      const int c = ks * 8 + 2 * (lane % 4);
      float e[4];  // A[m][c], A[m + 8][c], A[m][c + 1], A[m + 8][c + 1]
      if (a_kmajor(kA)) {
        float2 top = *reinterpret_cast<const float2*>(st + rows_at(m, c));
        float2 bot = *reinterpret_cast<const float2*>(st + rows_at(m + 8, c));
        if (kA == kAKDf) {
          const float2 xt = *reinterpret_cast<const float2*>(st + kGFloatsA + rows_at(m, c));
          const float2 xb = *reinterpret_cast<const float2*>(st + kGFloatsA + rows_at(m + 8, c));
          top = make_float2(__fmul_rn(top.x, xt.x), __fmul_rn(top.y, xt.y));
          bot = make_float2(__fmul_rn(bot.x, xb.x), __fmul_rn(bot.y, xb.y));
        }
        e[0] = top.x;
        e[1] = bot.x;
        e[2] = top.y;
        e[3] = bot.y;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) e[q] = a_elem<kA>(st, m + 8 * (q & 1), c + (q >> 1));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) split(e[q], ahi[ks][q], alo[ks][q]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for wgmma's reads
    __syncthreads();
  };
  // Stage s on the tensor cores: the small terms of both k8 steps (lo B_hi,
  // hi B_lo), then their high parts' products (hi B_hi), into one fresh
  // sum p that is then added to acc; a k8 step's core matrices start 2 x
  // 2048 bytes on (256 in the descriptor's 16-byte units). Stage s + 1 is
  // prepared while they run.
  auto run = [&](int64_t s, uint32_t (&ahi)[kGK / 8][4], uint32_t (&alo)[kGK / 8][4],
                 uint32_t (&nhi)[kGK / 8][4], uint32_t (&nlo)[kGK / 8][4]) {
    const int half = (int)(s % 2) * 2 * kGFloatsB;
    const uint64_t desc_hi = b_desc(bs + half);
    const uint64_t desc_lo = b_desc(bs + half + kGFloatsB);
    wgmma_fence_operands(p);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kGK / 8; ++ks) {
      wgmma_tf32(p, alo[ks], desc_hi + 256 * ks, ks > 0);
      wgmma_tf32(p, ahi[ks], desc_lo + 256 * ks, 1);
    }
#pragma unroll
    for (int ks = 0; ks < kGK / 8; ++ks) wgmma_tf32(p, ahi[ks], desc_hi + 256 * ks, 1);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (s + 1 < steps) prepare(s + 1, nhi, nlo);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    wgmma_fence_operands(p);
#pragma unroll
    for (int ks = 0; ks < kGK / 8; ++ks) {  // the products read these until they are done
#pragma unroll
      for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(ahi[ks][q]), "+r"(alo[ks][q])::"memory");
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], p[i]);
  };
  uint32_t hi0[kGK / 8][4], lo0[kGK / 8][4], hi1[kGK / 8][4], lo1[kGK / 8][4];
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  if (steps > 0) prepare(0, hi0, lo0);
#pragma unroll 1
  for (int64_t s = 0; s < steps; s += 2) {
    run(s, hi0, lo0, hi1, lo1);
    if (s + 1 < steps) run(s + 1, hi1, lo1, hi0, lo0);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

struct RowsArgs {
  const float* a;     // A [batch, k]; kAKDf: g, with A = g * x0
  const float* x0;    // [batch, d]
  const float* w;     // B = W [k, n] row-major, or W^T with W [n, k] (BTrans)
  int64_t batch, k, n;
  int64_t k_per_split;  // kEStore: k-steps of a slice (blockIdx.y), a multiple of kGK
  float* out;         // kEStore: C, [gridDim.y, batch, n]; kEFwdX: x_{l+1}; kEBwdG: g after
  const float* in;    // kEFwdX: x_l; kEBwdG: g before (either may be out)
  const float* bias;  // kEFwdX: b_l
  float* f_out;       // kEFwdX: f_l, or null
  const float* f;     // kEBwdG: f_l
  float* dx0;         // kEBwdG
  bool top, bottom;   // kEBwdG: l == L - 1, l == 0
};

template <int kA, bool kBTrans, int kEpi>
__global__ void __launch_bounds__(kGThreads, 1) general_rows_kernel(const RowsArgs p) {
  const int64_t ncols = (p.n + kGN - 1) / kGN;
  const int64_t row0 = (int64_t)blockIdx.x / ncols * kGM;
  const int64_t col0 = (int64_t)blockIdx.x % ncols * kGN;
  const int64_t k_first = kEpi == kEStore ? (int64_t)blockIdx.y * p.k_per_split : 0;
  const int64_t k_last =
      kEpi == kEStore && k_first + p.k_per_split < p.k ? k_first + p.k_per_split : p.k;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  gen_product<kA, kBTrans>(p.a, p.x0, nullptr, p.k, p.w, kBTrans ? p.k : p.n, row0, p.batch,
                           col0, p.n, k_first, k_last, acc, [](const float*, int64_t) {});
  // Thread (warp, lane) holds rows rbase and rbase + 8 and columns cbase + 8
  // j + e of C. Eight j of a row load all their inputs before they store
  // anything, so that those loads are in flight together (out may be in, so
  // the compiler may not move a load past a store).
  const int lane = threadIdx.x % 32;
  const int64_t rbase = row0 + (threadIdx.x / 32) * 16 + lane / 4;
  const int64_t cbase = col0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = rbase + 8 * h;
    if (row >= p.batch) continue;
    const int64_t at0 = row * p.n;
    if constexpr (kEpi == kEStore) {
      float* out = p.out + (int64_t)blockIdx.y * p.batch * p.n + at0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t c = cbase + 8 * j + e;
          if (c < p.n) out[c] = acc[4 * j + 2 * h + e];
        }
      }
    } else {
#pragma unroll
      for (int jh = 0; jh < 16; jh += 8) {
        float u0[8][2], u1[8][2], u2[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t c = cbase + 8 * (jh + j) + e;
            const bool ok = c < p.n;
            if (kEpi == kEFwdX) {
              u0[j][e] = ok ? p.x0[at0 + c] : 0.0f;
              u1[j][e] = ok ? p.in[at0 + c] : 0.0f;
              u2[j][e] = ok ? p.bias[c] : 0.0f;
            } else {
              u0[j][e] = ok ? p.in[at0 + c] : 0.0f;
              u1[j][e] = ok ? p.f[at0 + c] : 0.0f;
              u2[j][e] = ok && !p.top ? p.dx0[at0 + c] : 0.0f;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t c = cbase + 8 * (jh + j) + e;
            if (c >= p.n) continue;
            const float v = acc[4 * (jh + j) + 2 * h + e];
            const int64_t at = at0 + c;
            if (kEpi == kEFwdX) {
              const float fv = __fadd_rn(v, u2[j][e]);
              p.out[at] = __fadd_rn(__fmul_rn(u0[j][e], fv), u1[j][e]);
              if (p.f_out != nullptr) p.f_out[at] = fv;
            } else {
              const float g_old = u0[j][e];
              const float g_new = __fadd_rn(g_old, v);
              p.out[at] = g_new;
              const float gf = __fmul_rn(g_old, u1[j][e]);
              const float dx = p.top ? gf : __fadd_rn(u2[j][e], gf);
              p.dx0[at] = p.bottom ? __fadd_rn(dx, g_new) : dx;
            }
          }
        }
      }
    }
  }
}

struct WeightsArgs {
  const float* g;       // kAMDf: the gradient with respect to x_{l+1}
  const float* x0;      // [batch, d]
  const float* f_prev;  // kAMX: f_{l-1}
  const float* x_prev;  // kAMX: x_{l-1} (x0 at l = 1)
  float* x_keep;        // kAMX: where x_l is kept for the next layer, or null
  const float* bm;      // B rows [batch, r]: xv_l (kAMDf) or t_l
  float* partial;       // [chunks][total]
  int64_t batch, rows_per_chunk, total;
  int64_t d, r;
  int64_t out_at;       // dU_l's or dV_l's offset in a chunk's partial
  int64_t db_at;        // kAMDf: db_l's offset
};

template <int kA>
__global__ void __launch_bounds__(kGThreads, 1) general_weights_kernel(const WeightsArgs p) {
  const int64_t ktiles = (p.r + kGN - 1) / kGN;
  const int64_t j0 = (int64_t)blockIdx.x / ktiles * kGM;
  const int64_t k0 = (int64_t)blockIdx.x % ktiles * kGN;
  const int64_t first = (int64_t)blockIdx.y * p.rows_per_chunk;
  const int64_t last = first + p.rows_per_chunk < p.batch ? first + p.rows_per_chunk : p.batch;
  const bool sums_db = kA == kAMDf && k0 == 0;
  float db = 0.0f;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const float* a0 = kA == kAMDf ? p.g : p.x0;
  const float* a1 = kA == kAMDf ? p.x0 : p.f_prev;
  float* x_keep = k0 == 0 ? p.x_keep : nullptr;
  gen_product<kA, false>(a0, a1, p.x_prev, p.d, p.bm, p.r, j0, p.d, k0, p.r, first, last, acc,
                         [&](const float* st, int64_t i0) {
    // Thread c < 128: column j0 + c of the stage's rows, in order: db's sum
    // of df (kAMDf), or x_l kept for the next layer (kAMX).
    const int c = threadIdx.x;
    if (c >= kGM || j0 + c >= p.d) return;
    const int rows = last - i0 < kGK ? (int)(last - i0) : kGK;
    if (sums_db) {
      for (int rr = 0; rr < rows; ++rr) {
        const int at = cols_at<kGM>(rr, c);
        db = __fadd_rn(db, __fmul_rn(st[at], st[kGFloatsA + at]));
      }
    } else if (kA == kAMX && x_keep != nullptr) {
      for (int rr = 0; rr < rows; ++rr) x_keep[(i0 + rr) * p.d + j0 + c] = a_elem<kAMX>(st, c, rr);
    }
  });
  const int lane = threadIdx.x % 32;
  const int64_t jbase = j0 + (threadIdx.x / 32) * 16 + lane / 4;
  const int64_t kbase = k0 + 2 * (lane % 4);
  float* out = p.partial + (int64_t)blockIdx.y * p.total;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t j = jbase + 8 * h;
    if (j >= p.d) continue;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t k = kbase + 8 * n + e;
        if (k < p.r) out[p.out_at + j * p.r + k] = acc[4 * n + 2 * h + e];
      }
    }
  }
  if (sums_db && threadIdx.x < kGM && j0 + threadIdx.x < p.d) {
    out[p.db_at + j0 + threadIdx.x] = db;
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

// The general route's kernels take g_smem bytes; ask for the largest carveout
// of shared memory, so that two blocks fit an SM.
int set_general_smem(const void* kernel, size_t smem) {
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared));
}

template <int kA, bool kBTrans, int kEpi>
int launch_rows(const RowsArgs& p, int splits, cudaStream_t s) {
  const int64_t tiles = (p.batch + kGM - 1) / kGM * ((p.n + kGN - 1) / kGN);
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = general_rows_kernel<kA, kBTrans, kEpi>;
  const int err = set_general_smem((const void*)kernel, g_smem(kA));
  if (err != 0) return err;
  kernel<<<dim3((unsigned)tiles, splits), kGThreads, g_smem(kA), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// C [batch, r] = A [batch, d] W (x_l V_l, or df U_l with kAKDf) into c, in
// `splits` slices of k through split_scratch [splits, batch, r] where
// splits > 1.
template <int kA>
int launch_rows_split(RowsArgs p, float* c, float* split_scratch, int splits, cudaStream_t s) {
  const int64_t steps = (p.k + kGK - 1) / kGK;
  p.k_per_split = (steps + splits - 1) / splits * kGK;
  p.out = splits > 1 ? split_scratch : c;
  int err = launch_rows<kA, false, kEStore>(p, splits, s);
  if (err != 0 || splits == 1) return err;
  const int64_t total = p.batch * p.n;
  sum_chunks_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      split_scratch, c, splits, total);
  return static_cast<int>(cudaGetLastError());
}

template <int kA>
int launch_weights(const WeightsArgs& p, int chunks, cudaStream_t s) {
  const int64_t tiles = (p.d + kGM - 1) / kGM * ((p.r + kGN - 1) / kGN);
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = general_weights_kernel<kA>;
  const int err = set_general_smem((const void*)kernel, g_smem(kA));
  if (err != 0) return err;
  kernel<<<dim3((unsigned)tiles, chunks), kGThreads, g_smem(kA), s>>>(p);
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
    int err = launch_rows_split<kAK>(p, xvl, split_scratch, splits, s);
    if (err != 0) return err;
    p.a = xvl;
    p.w = u + (int64_t)l * d * r;
    p.k = r;
    p.n = d;
    p.out = out;
    p.in = xl;
    p.bias = b + (int64_t)l * d;
    p.f_out = f_out != nullptr ? f_out + (int64_t)l * batch * d : nullptr;
    err = launch_rows<kAK, true, kEFwdX>(p, 1, s);
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
    int err = launch_rows_split<kAKDf>(p, tl, split_scratch, splits, s);
    if (err != 0) return err;
    w.g = gl;  // dU_l = df^T xv_l, db_l = sum df
    w.bm = xv + (int64_t)l * batch * r;
    w.out_at = (int64_t)l * d * r;
    w.db_at = 2 * width + (int64_t)l * d;
    err = launch_weights<kAMDf>(w, chunks, s);
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
    err = launch_rows<kAK, true, kEBwdG>(p, 1, s);
    if (err != 0) return err;
  }
  for (int l = 0; l < layers; ++l) {  // dV_l = x_l^T t_l
    w.f_prev = l > 0 ? f + (int64_t)(l - 1) * bd : nullptr;
    w.x_prev = l == 0 ? nullptr : l == 1 ? x0 : x_scratch + (int64_t)((l - 1) & 1) * bd;
    w.x_keep = l >= 1 && l < layers - 1 ? x_scratch + (int64_t)(l & 1) * bd : nullptr;
    w.bm = t + (int64_t)l * batch * r;
    w.out_at = width + (int64_t)l * d * r;
    const int err =
        l == 0 ? launch_weights<kAM>(w, chunks, s) : launch_weights<kAMX>(w, chunks, s);
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
