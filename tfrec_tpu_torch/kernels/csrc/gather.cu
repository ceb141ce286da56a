// Row gather with clip semantics over many tables in one launch: for each
// field f, out_f[i, :] = table_f[clamp(ids_f[i], 0, V_f - 1), :].
//
// Replaces the TPU kernel tfrec_tpu/kernels/gather_pallas.py gather_pallas
// (body _gather_kernel, and _gather_packed, its 128-lane workaround for
// D in {32, 64}). On the TPU each grid step issued 8 row DMAs into VMEM, one
// pallas_call a table; on Hopper one launch covers every table of a batch
// (26 at dcn_criteo), and rows are read by the threads that write them.
//
// Bound: bytes, and below them latency. The gather does no arithmetic; a
// field moves N*D*4 bytes in, N*D*4 out and N*4 of ids (8192 ids at D=32:
// 2.13 MB; 26 fields 55.4 MB, 16.5 us at 3.35 TB/s). One field alone is too
// little to cover the latency of device memory, and each launch pays its
// own ramp and tail, so every field of a batch shares one grid:
//  - The launch takes a descriptor of up to kMaxFields fields BY VALUE, as a
//    __grid_constant__ kernel parameter (no device array of pointers, so no
//    copy to the card a call). The C entry point splits more fields into
//    launches of kMaxFields each.
//  - Blocks map to fields by prefix sums of each field's blocks, so fields
//    of other widths and lengths (multi-hot bags, N_f = B * W_f) share the
//    grid; a block finds its field by a binary search of the prefix.
//  - A row is copied by 2^k threads (the least power of two >= its width,
//    at most a warp, which then loops over the row), as 16-byte vectors
//    where D % 4 == 0 and both pointers are 16-byte aligned, else as floats:
//    neighbouring threads read and write neighbouring addresses.
//  - Each thread keeps kRowsPerThread rows in flight: it reads their ids
//    (once per row: the threads of a row read the same word), then issues
//    every row load before any store. Table reads bypass L1
//    (ld.global.nc.L1::no_allocate): the tables (333 MB at dcn_criteo) dwarf
//    every cache, so a row is read once.
// Ids are clamped to [0, V-1] (negative ids to row 0, sentinels >= V to row
// V-1), the semantics of jnp.take(..., mode="clip"). The copy is exact.
// At dcn_criteo's shape (tools/ab_sparse.py, 10 calls a graph): ~20 us for
// the 26 tables (bound 16.5 us), against 81.8 us for one launch a table of
// the one-table kernel before; 4 or 16 rows a thread, or a cap of 64
// registers, were no faster.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 64;     // fields one launch's descriptor holds
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;  // row loads a thread keeps in flight

struct Field {
  const void* table;  // [vocab, dim] f32
  const int* ids;     // [n] int32
  void* out;          // [n, dim] f32
  long long vocab;
  int n;
  int width;          // vectors a row: dim / 4 when vec4, else dim
  int vec4;           // 1: 16-byte vectors; 0: floats
  int lanes_log2;     // log2 of the threads that copy one row (<= 5)
};

struct Launch {
  Field fields[kMaxFields];
  int block_start[kMaxFields + 1];  // first block of each field; [count] = grid
  int count;
};

// An id is an int, so the row it names, clamped, is one too.
__device__ __forceinline__ int clamp_row(int id, int64_t vocab) {
  return id < 0 ? 0 : (id >= vocab ? static_cast<int>(vocab - 1) : id);
}

__device__ __forceinline__ float4 load_row(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ float load_row(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// T is float4 (width = D/4 vectors a row) or float (width = D).
template <typename T>
__device__ __forceinline__ void gather_field(const Field& f, int local_block) {
  const T* __restrict__ table = static_cast<const T*>(f.table);
  T* __restrict__ out = static_cast<T*>(f.out);
  const int lanes = 1 << f.lanes_log2;
  const int col0 = threadIdx.x & (lanes - 1);
  const int rows_per_pass = kThreads >> f.lanes_log2;
  const int64_t first = (int64_t)local_block * rows_per_pass * kRowsPerThread +
                        (threadIdx.x >> f.lanes_log2);
  const int64_t width = f.width;
  int src[kRowsPerThread];  // the source row of each output row; -1 past n
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t row = first + (int64_t)k * rows_per_pass;
    src[k] = row < f.n ? clamp_row(__ldg(f.ids + row), f.vocab) : -1;
  }
  for (int64_t c = col0; c < width; c += lanes) {
    T v[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (src[k] >= 0) v[k] = load_row(table + src[k] * width + c);
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (src[k] >= 0) out[(first + (int64_t)k * rows_per_pass) * width + c] = v[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const __grid_constant__ Launch launch) {
  // The field of this block: the last whose first block is <= blockIdx.x.
  const int b = blockIdx.x;
  int lo = 0, hi = launch.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (launch.block_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const Field& f = launch.fields[lo];
  const int local_block = b - launch.block_start[lo];
  if (f.vec4) {
    gather_field<float4>(f, local_block);
  } else {
    gather_field<float>(f, local_block);
  }
}

int flush(Launch& launch, int64_t& blocks, cudaStream_t stream, int* launches) {
  if (launch.count == 0) return 0;
  launch.block_start[launch.count] = static_cast<int>(blocks);
  gather_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(launch);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  ++*launches;
  launch.count = 0;
  blocks = 0;
  return 0;
}

}  // namespace

// desc holds 6 values a field: table [vocab, dim] f32, ids [n] int32 and
// out [n, dim] f32 (pointers, contiguous on the current device), vocab, dim
// and n. Fields with n == 0 or dim == 0 are skipped. Launches on `stream`,
// kMaxFields fields a launch, and counts the launches made in *launches.
// Returns cudaGetLastError() of the first launch refused, else 0 (and
// cudaErrorInvalidValue, launching nothing more, for a field past int
// sizes: n or the grid above INT_MAX).
extern "C" int tfrec_gather_rows_multi(const long long* desc, int num_fields,
                                       void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launches = 0;
  Launch launch;
  launch.count = 0;
  int64_t blocks = 0;
  for (int i = 0; i < num_fields; ++i) {
    const long long* e = desc + 6 * i;
    const long long vocab = e[3], dim = e[4], n = e[5];
    if (n <= 0 || dim <= 0) continue;
    if (n > INT_MAX || dim > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec4 = dim % 4 == 0 && e[0] % 16 == 0 && e[2] % 16 == 0;
    const int width = static_cast<int>(vec4 ? dim / 4 : dim);
    int lanes_log2 = 0;
    while (lanes_log2 < 5 && (1 << lanes_log2) < width) ++lanes_log2;
    const int64_t rows_per_block = (int64_t)(kThreads >> lanes_log2) * kRowsPerThread;
    const int64_t field_blocks = (n + rows_per_block - 1) / rows_per_block;
    if (launch.count == kMaxFields || blocks + field_blocks > INT_MAX) {
      const int rc = flush(launch, blocks, s, launches);
      if (rc != 0) return rc;
    }
    if (field_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    Field& f = launch.fields[launch.count];
    f.table = reinterpret_cast<const void*>(e[0]);
    f.ids = reinterpret_cast<const int*>(e[1]);
    f.out = reinterpret_cast<void*>(e[2]);
    f.vocab = vocab;
    f.n = static_cast<int>(n);
    f.width = width;
    f.vec4 = vec4 ? 1 : 0;
    f.lanes_log2 = lanes_log2;
    launch.block_start[launch.count] = static_cast<int>(blocks);
    ++launch.count;
    blocks += field_blocks;
  }
  return flush(launch, blocks, s, launches);
}
