// DLRM's dot interaction, forward and backward, one launch each. For every
// example b the vectors z_0 .. z_{n-1}, each [D] (the bottom MLP's output
// where the model has one, then the F field embeddings):
//   forward   top_in[b] = [z_0 ; P] (or [P] without a bottom vector), P the
//             strict lower triangle of the products, P_p = z_i . z_j for
//             j < i, pair p = i(i-1)/2 + j: np.tril_indices(n, k=-1)'s
//             row-major order, which the top MLP's first weight reads;
//   backward  dz_i = sum_{j<i} dP_ij z_j + sum_{j>i} dP_ji z_j, from
//             dP = d top_in[:, D:]; d_bottom = d top_in[:, :D] + dz_0.
//
// Replaces no Pallas site: the reference (tfrec_tpu/models/dlrm.py) leaves
// the interaction to XLA as an einsum. The port's first version stacked the
// vectors into [B, n, D], multiplied them into [B, n, n] with torch.bmm,
// picked the triangle by advanced indexing (whose backward is a sort-based
// index_put_ with accumulate into a zeroed [B, n, n]) and concatenated
// [bottom ; pairs]: three copies and a sort, ~3.8 ms of a Criteo-Terabyte
// step for work whose bound is 0.44 ms.
//
// Bound: bytes. At B = 32768, n = 27, D = 128 the forward reads the vectors
// (453 MB) and writes 479 floats an example (63 MB): 0.154 ms at 3.35 TB/s
// for 2.9 GFLOP (0.04 ms at 67 TFLOP/s); the backward reads the vectors and
// d top_in (516 MB) and writes dz (453 MB): 0.289 ms for 5.8 GFLOP. So each
// kernel reads every input once, writes every output once, and keeps all
// else on chip. Vectors are read where they lie, a pointer and a row stride
// each (contiguous views of the gather's one allocation, or lane-packed and
// stacked slices): nothing [B, n, D] is stacked and nothing [B, n, n]
// stored. One warp an example.
//  - Forward: a block is one warp, so that as many stay resident as shared
//    memory allows (13 a SM at n = 27). The warp copies its example's
//    vectors into shared memory with cp.async (16 bytes a lane where
//    aligned, neighbouring lanes on neighbouring addresses), 128 columns at
//    a time; each lane then forms
//    the dots of one or two 4x4 blocks of the triangle (28 blocks at n =
//    27), 8 shared loads for 16 products, from rows stored XOR-swizzled so
//    that the lanes' rows fall in distinct banks. The dots go through a
//    buffer in shared memory, so a warp writes its example's pairs as
//    consecutive floats.
//  - Backward: lane l holds VEC consecutive columns of every vector in
//    registers (16 bytes a lane at VEC = 4); with those loads in flight the
//    warp spreads its example's dP into a symmetric n x n matrix S with a
//    zero diagonal in shared memory; each lane forms dz_i for its columns from S's row i, read four
//    values at a time as broadcasts. No reduction crosses lanes, and each
//    row of dz is written once, into one [n, B, D] allocation (d_bottom,
//    then the fields' gradients, each [B, D] as the gather lays out its
//    rows).
//  - The sums are the former bmm's, term for term and in its order: a dot
//    is one f32 fused multiply-add a column, in column order; dz_i is the
//    sum over j < i plus the sum over j > i, each in order of j, as
//    autograd's two matrix products of the bmm (dP z and dP^T z) form it;
//    d_bottom adds d top_in's bottom columns. Where the matrix library sums
//    a product in column order (cuBLAS's f32 products at these shapes; PERF.md
//    §6), the kernels give its numbers bit for bit. No atomics: repeated runs
//    agree bit for bit.
//  - The register route takes n <= 32 vectors (a lane of the backward holds
//    32 x VEC floats of them). VEC is 4, 2 or 1: the fewest chunks of 32*VEC
//    columns that cover D, the narrowest at a tie, among the widths that D,
//    every vector's pointer and every row stride are aligned to. Past 32
//    vectors the general route takes them stacked [n, B, D] (the wrapper
//    stacks them): one thread an output element, the same sums.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxVectors = 32;   // the register route's vectors
constexpr int kPairFloats = 512;  // a warp's buffer of pairs, >= 32 * 31 / 2
constexpr int kFwdWarps = 1;      // examples a block of the forward, one a warp
constexpr int kBwdWarps = 4;      // of the backward
constexpr int kChunk = 128;       // columns the forward stages at a time
constexpr int kGeneralThreads = 256;

struct Vectors {
  const float* row0[kMaxVectors];  // vector v of example 0
  long long stride[kMaxVectors];   // floats from one example's row to the next
};

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// This lane's columns of every vector of example b; zeros past n and past D
// (VEC divides D, so a lane's columns are all inside D or all past it).
template <int VEC>
__device__ __forceinline__ void load_vectors(const Vectors& vecs, int n, int b, int col, bool live,
                                             float (&z)[kMaxVectors][VEC]) {
#pragma unroll
  for (int v = 0; v < kMaxVectors; ++v) {
    if (v < n && live) {
      load<VEC>(vecs.row0[v] + b * vecs.stride[v] + col, z[v]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) z[v][k] = 0.f;
    }
  }
}

// The forward stages the vectors in shared memory kChunk columns at a
// time. A row's 16-byte column groups are stored XOR-swizzled by its row
// block (row / 4), so the four rows of one 4x4 block of pairs and the rows
// of the other lanes' blocks fall in distinct banks.
__device__ __forceinline__ int staged(int row, int col) {
  return row * kChunk + ((((col >> 2) ^ (row >> 2)) & 7) | ((col >> 2) & ~7)) * 4 + (col & 3);
}

template <int VEC>
__device__ __forceinline__ void copy_async(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  } else if constexpr (VEC == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
  }
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Floats of shared memory a warp of the forward takes for n vectors: the
// staged rows (n rounded up to a whole row block) and the pairs' buffer.
__host__ __device__ constexpr int fwd_warp_floats(int n) { return 4 * ((n + 3) / 4) * kChunk + kPairFloats; }

// A lane's dots of one 4x4 block of pairs, rows i0.., columns j0..: each
// dot one f32 sum over the columns in order, a fused multiply-add a column,
// as a float32 matrix product sums it.
__device__ __forceinline__ void block_dots(const float* zs, int i0, int j0, int cols, float (&acc)[4][4]) {
  int k = 0;
  for (; k + 4 <= cols; k += 4) {
    float a[4][4], c[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(zs + staged(i0 + r, k));
      const float4 y = *reinterpret_cast<const float4*>(zs + staged(j0 + r, k));
      a[r][0] = x.x; a[r][1] = x.y; a[r][2] = x.z; a[r][3] = x.w;
      c[r][0] = y.x; c[r][1] = y.y; c[r][2] = y.z; c[r][3] = y.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r][kk], c[q][kk], acc[r][q]);
      }
    }
  }
  for (; k < cols; ++k) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = zs[staged(i0 + r, k)];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(x, zs[staged(j0 + q, k)], acc[r][q]);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(32 * kFwdWarps)
dot_fwd_kernel(const __grid_constant__ Vectors vecs, int n, int has_bottom, int batch, int dim,
               float* __restrict__ out, long long out_stride) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kFwdWarps + w;
  if (b >= batch) return;  // the whole warp: b is the warp's
  float* zs = smem + w * fwd_warp_floats(n);
  float* pbuf = zs + 4 * ((n + 3) / 4) * kChunk;
  const int pairs = n * (n - 1) / 2;
  float* __restrict__ row = out + b * out_stride;
  float* __restrict__ dots = row + (has_bottom ? dim : 0);
  // The triangle's 4x4 blocks of pairs, row block rb >= column block cb:
  // block t = rb(rb+1)/2 + cb is lane t % 32's, at most two a lane.
  const int row_blocks = (n + 3) / 4;
  const int blocks = row_blocks * (row_blocks + 1) / 2;
  int i0[2], j0[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int t = lane + 32 * s;
    int rb = 0;
    while ((rb + 1) * (rb + 2) / 2 <= t) ++rb;
    i0[s] = 4 * rb;
    j0[s] = 4 * (t - rb * (rb + 1) / 2);
  }
  float acc[2][4][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[s][r][q] = 0.f;
    }
  }
  for (int c0 = 0; c0 < dim; c0 += kChunk) {
    const int cols = min(kChunk, dim - c0);
    __syncwarp();  // the last chunk's reads are done
    for (int v = 0; v < n; ++v) {
      const float* src = vecs.row0[v] + b * vecs.stride[v] + c0;
      for (int c = lane * VEC; c < cols; c += 32 * VEC) copy_async<VEC>(zs + staged(v, c), src + c);
    }
    copy_async_wait();
    __syncwarp();
    if (has_bottom) {  // the output row's stride need not be aligned
      for (int c = lane; c < cols; c += 32) row[c0 + c] = zs[c];
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (lane + 32 * s < blocks) block_dots(zs, i0[s], j0[s], cols, acc[s]);
    }
  }
  // Each lane's dots of the strict triangle to the pairs' buffer, then
  // out as a warp's consecutive floats.
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (lane + 32 * s < blocks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0[s] + r, j = j0[s] + q;
          if (j < i && i < n) pbuf[i * (i - 1) / 2 + j] = acc[s][r][q];
        }
      }
    }
  }
  __syncwarp();
  for (int p = lane; p < pairs; p += 32) dots[p] = pbuf[p];
}

template <int VEC>
__global__ void __launch_bounds__(32 * kBwdWarps)
dot_bwd_kernel(const __grid_constant__ Vectors vecs, int n, int has_bottom, int batch, int dim,
               const float* __restrict__ grad, long long grad_stride, float* __restrict__ dz) {
  __shared__ __align__(16) float sym[kBwdWarps][kMaxVectors][kMaxVectors];
  __shared__ float tri[kBwdWarps][kPairFloats];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kBwdWarps + w;
  if (b >= batch) return;  // no barrier below spans the block
  const float* __restrict__ g = grad + b * grad_stride;
  const float* __restrict__ dp = g + (has_bottom ? dim : 0);
  float(*S)[kMaxVectors] = sym[w];
  const long long plane = (long long)batch * dim;  // one vector's [B, D] in dz
  for (int c0 = 0; c0 < dim; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    const bool live = col < dim;
    float z[kMaxVectors][VEC];
    load_vectors<VEC>(vecs, n, b, col, live, z);
    if (c0 == 0) {
      const int pairs = n * (n - 1) / 2;
      // dP to shared memory (after this tile's vector loads are issued, so
      // the two are in flight together), every load at once, neighbouring
      // lanes on neighbouring addresses.
      float d[kPairFloats / 32];
#pragma unroll
      for (int k = 0; k < kPairFloats / 32; ++k) {
        const int p = 32 * k + lane;
        d[k] = p < pairs ? __ldg(dp + p) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kPairFloats / 32; ++k) tri[w][32 * k + lane] = d[k];
      __syncwarp();
      // Row i of S, lane j its column: dP_ij below the diagonal, dP_ji
      // above, zero on it and past n. Rows past n are never read.
      for (int i = 0; i < n; ++i) {
        const int j = lane;
        float s = 0.f;
        if (j < n && j != i) s = tri[w][j < i ? i * (i - 1) / 2 + j : j * (j - 1) / 2 + i];
        S[i][j] = s;
      }
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < kMaxVectors; ++i) {
      if (i < n) {
        // The products below the diagonal and those above it in two sums,
        // each over j in order, then added: as autograd's two matrix
        // products of the former bmm (dP z and dP^T z) sum them.
        float lo[VEC], hi[VEC], a[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) lo[k] = hi[k] = 0.f;
#pragma unroll
        for (int j0 = 0; j0 < kMaxVectors; j0 += 4) {
          if (j0 < n) {  // S and z are zero past n
            const float4 s4 = *reinterpret_cast<const float4*>(&S[i][j0]);
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
#pragma unroll
              for (int k = 0; k < VEC; ++k) {
                if (j0 + t < i) lo[k] = fmaf(sv[t], z[j0 + t][k], lo[k]);
                if (j0 + t > i) hi[k] = fmaf(sv[t], z[j0 + t][k], hi[k]);
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) a[k] = lo[k] + hi[k];
        if (live) {
          if (i == 0 && has_bottom) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) a[k] += __ldg(g + col + k);
          }
          store<VEC>(dz + i * plane + (long long)b * dim + col, a);
        }
      }
    }
  }
}

// The general route: z [n, B, D] contiguous.
__global__ void __launch_bounds__(kGeneralThreads)
dot_fwd_general(const float* __restrict__ z, int n, int has_bottom, long long batch, long long dim,
                float* __restrict__ out, long long out_stride) {
  const long long head = has_bottom ? dim : 0;
  const long long width = head + (long long)n * (n - 1) / 2;
  const long long plane = batch * dim;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < batch * width;
       e += (long long)gridDim.x * blockDim.x) {
    const long long b = e / width;
    const long long c = e - b * width;
    float s;
    if (c < head) {
      s = z[b * dim + c];
    } else {
      const long long p = c - head;
      long long i = (long long)((1.0 + sqrt(8.0 * (double)p + 1.0)) * 0.5);
      while (i * (i - 1) / 2 > p) --i;
      while ((i + 1) * i / 2 <= p) ++i;
      const long long j = p - i * (i - 1) / 2;
      const float* zi = z + i * plane + b * dim;
      const float* zj = z + j * plane + b * dim;
      s = 0.f;
      for (long long k = 0; k < dim; ++k) s = fmaf(zi[k], zj[k], s);
    }
    out[b * out_stride + c] = s;
  }
}

__global__ void __launch_bounds__(kGeneralThreads)
dot_bwd_general(const float* __restrict__ z, int n, int has_bottom, long long batch, long long dim,
                const float* __restrict__ grad, long long grad_stride, float* __restrict__ dz) {
  const long long plane = batch * dim;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n * plane;
       e += (long long)gridDim.x * blockDim.x) {
    const long long v = e / plane;
    const long long r = e - v * plane;
    const long long b = r / dim;
    const long long c = r - b * dim;
    const float* g = grad + b * grad_stride;
    const float* dp = g + (has_bottom ? dim : 0);
    float lo = 0.f, hi = 0.f;  // as the register route sums them
    for (long long j = 0; j < v; ++j) lo = fmaf(dp[v * (v - 1) / 2 + j], z[j * plane + r], lo);
    for (long long j = v + 1; j < n; ++j) hi = fmaf(dp[j * (j - 1) / 2 + v], z[j * plane + r], hi);
    float s = lo + hi;
    if (has_bottom && v == 0) s += g[c];
    dz[e] = s;
  }
}

// The vector width of the register route (see the note at the top), from
// the vectors' pointers and strides.
int pick_vec(const long long* desc, int n, long long dim) {
  int best = 1;
  long long best_chunks = (dim + 31) / 32;
  for (int vec = 2; vec <= 4; vec *= 2) {
    bool aligned = dim % vec == 0;
    for (int v = 0; v < n && aligned; ++v) {
      aligned = desc[2 * v] % (4 * vec) == 0 && desc[2 * v + 1] % vec == 0;
    }
    const long long chunks = (dim + 32 * vec - 1) / (32 * vec);
    if (aligned && chunks < best_chunks) {
      best = vec;
      best_chunks = chunks;
    }
  }
  return best;
}

bool fill(Vectors& vecs, const long long* desc, int n) {
  if (n < 1 || n > kMaxVectors) return false;
  for (int v = 0; v < kMaxVectors; ++v) {
    vecs.row0[v] = v < n ? reinterpret_cast<const float*>(desc[2 * v]) : nullptr;
    vecs.stride[v] = v < n ? desc[2 * v + 1] : 0;
  }
  return true;
}

unsigned general_blocks(long long elements) {
  const long long blocks = (elements + kGeneralThreads - 1) / kGeneralThreads;
  return static_cast<unsigned>(blocks < 132 * 32 ? blocks : 132 * 32);
}

}  // namespace

// desc holds 2 values a vector: its pointer (f32 on the current device; row
// b at pointer + b * stride, unit stride along D) and its row stride in
// floats. n <= 32 vectors, vector 0 the bottom MLP's output where
// has_bottom. out [batch, (has_bottom ? dim : 0) + n(n-1)/2] with row
// stride out_stride. Returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue, launching nothing, for n or a size it does not
// take).
extern "C" int tfrec_dot_interaction_fwd(const long long* desc, int n, int has_bottom, long long batch,
                                         long long dim, void* out, long long out_stride, void* stream) {
  Vectors vecs;
  if (!fill(vecs, desc, n) || batch < 1 || batch > INT_MAX || dim < 1 || dim > INT_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((batch + kFwdWarps - 1) / kFwdWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int b = static_cast<int>(batch), d = static_cast<int>(dim);
  const size_t smem = sizeof(float) * kFwdWarps * fwd_warp_floats(n);  // <= 18.4 KB
  switch (pick_vec(desc, n, dim)) {
    case 4: dot_fwd_kernel<4><<<blocks, 32 * kFwdWarps, smem, s>>>(vecs, n, has_bottom, b, d, o, out_stride); break;
    case 2: dot_fwd_kernel<2><<<blocks, 32 * kFwdWarps, smem, s>>>(vecs, n, has_bottom, b, d, o, out_stride); break;
    default: dot_fwd_kernel<1><<<blocks, 32 * kFwdWarps, smem, s>>>(vecs, n, has_bottom, b, d, o, out_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// As the forward, with grad = d top_in (row stride grad_stride, unit
// stride along its row) and dz [n, batch, dim] contiguous, 16-byte aligned:
// dz[0] is d_bottom where has_bottom.
extern "C" int tfrec_dot_interaction_bwd(const long long* desc, int n, int has_bottom, long long batch,
                                         long long dim, const void* grad, long long grad_stride, void* dz,
                                         void* stream) {
  Vectors vecs;
  if (!fill(vecs, desc, n) || batch < 1 || batch > INT_MAX || dim < 1 || dim > INT_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((batch + kBwdWarps - 1) / kBwdWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grad);
  float* o = static_cast<float*>(dz);
  const int b = static_cast<int>(batch), d = static_cast<int>(dim);
  switch (pick_vec(desc, n, dim)) {
    case 4: dot_bwd_kernel<4><<<blocks, 32 * kBwdWarps, 0, s>>>(vecs, n, has_bottom, b, d, g, grad_stride, o); break;
    case 2: dot_bwd_kernel<2><<<blocks, 32 * kBwdWarps, 0, s>>>(vecs, n, has_bottom, b, d, g, grad_stride, o); break;
    default: dot_bwd_kernel<1><<<blocks, 32 * kBwdWarps, 0, s>>>(vecs, n, has_bottom, b, d, g, grad_stride, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The general route, any n >= 1: z [n, batch, dim] contiguous.
extern "C" int tfrec_dot_interaction_fwd_general(const void* z, int n, int has_bottom, long long batch,
                                                 long long dim, void* out, long long out_stride,
                                                 void* stream) {
  if (n < 1 || batch < 1 || dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long width = (has_bottom ? dim : 0) + (long long)n * (n - 1) / 2;
  dot_fwd_general<<<general_blocks(batch * width), kGeneralThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), n, has_bottom, batch, dim, static_cast<float*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tfrec_dot_interaction_bwd_general(const void* z, int n, int has_bottom, long long batch,
                                                 long long dim, const void* grad, long long grad_stride,
                                                 void* dz, void* stream) {
  if (n < 1 || batch < 1 || dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  dot_bwd_general<<<general_blocks(n * batch * dim), kGeneralThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), n, has_bottom, batch, dim, static_cast<const float*>(grad), grad_stride,
      static_cast<float*>(dz));
  return static_cast<int>(cudaGetLastError());
}
