// Row gather with clip semantics: out[i, :] = table[clamp(ids[i], 0, V-1), :].
//
// Replaces the TPU kernel tfrec_tpu/kernels/gather_pallas.py gather_pallas
// (body _gather_kernel, and _gather_packed, its 128-lane workaround for
// D in {32, 64}). On the TPU each grid step issued 8 row DMAs into VMEM; on
// Hopper rows are simply read by the threads that write them.
//
// Bound: bytes. The gather does no arithmetic; it moves N*D*4 bytes in,
// N*D*4 out and N*4 of ids (8192 ids at D=32: 2.13 MB, 0.64 us at
// 3.35 TB/s). Design: the output is treated as one flat array of 16-byte
// vectors (4 floats) when D % 4 == 0 and both pointers are 16-byte aligned,
// else of single floats. Thread t of the grid copies element t, so
// neighbouring threads write neighbouring addresses and read neighbouring
// addresses of one row; a warp covers 128/D rows at D <= 128 (4 at D=32)
// and one row in pieces above. Ids are read through the read-only cache and
// clamped to [0, V-1] (negative ids to row 0, sentinels >= V to row V-1),
// the semantics of jnp.take(..., mode="clip"). The copy is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t clamp_row(int id, int64_t vocab) {
  const int64_t r = id;
  return r < 0 ? 0 : (r >= vocab ? vocab - 1 : r);
}

// T is float4 (width = D/4 vectors per row) or float (width = D).
template <typename T>
__global__ void __launch_bounds__(256)
gather_rows_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                   T* __restrict__ out, int64_t n, int64_t vocab, int64_t width) {
  const int64_t total = n * width;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t row = e / width;
    const int64_t col = e - row * width;
    const int64_t src = clamp_row(__ldg(ids + row), vocab);
    out[e] = __ldg(table + src * width + col);
  }
}

}  // namespace

// table [vocab, dim] f32, ids [n] int32, out [n, dim] f32, all contiguous on
// the current device; runs on `stream`. Returns cudaGetLastError().
extern "C" int tfrec_gather_rows(const void* table, const void* ids, void* out,
                                 long long n, long long vocab, long long dim,
                                 void* stream) {
  const int threads = 256;
  const int64_t max_blocks = 132 * 64;  // grid-stride beyond this
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = dim % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t width = vec4 ? dim / 4 : dim;
  int64_t blocks = (n * width + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  if (vec4) {
    gather_rows_kernel<float4><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float4*>(table), static_cast<const int*>(ids),
        static_cast<float4*>(out), n, vocab, width);
  } else {
    gather_rows_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(table), static_cast<const int*>(ids),
        static_cast<float*>(out), n, vocab, width);
  }
  return static_cast<int>(cudaGetLastError());
}
