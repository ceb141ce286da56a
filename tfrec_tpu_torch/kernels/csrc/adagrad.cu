// Fused rowwise Adagrad over distinct ids, in place, over many tables in one
// launch: for each table f and each slot i whose id u = uids_f[i] is a real
// row (0 <= u < V_f; sentinels and other ids out of range are skipped)
//     acc_f[u]   += mean_j(g_f[i, j]^2)
//     table_f[u] -= lr * g_f[i] / (sqrt(acc_f[u]) + eps)
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
// accumulator (8), plus the N*4 bytes of ids: at D=32 and ~1 800 distinct
// ids in 8192 slots about 0.74 MB a table, 19.3 MB for dcn_criteo's 26
// tables, 5.8 us at 3.35 TB/s. Operations are ~4 per element. One table
// alone is too little to cover the latency of device memory, so:
//  - One launch covers every table of a step. It takes a descriptor of up
//    to kMaxTables tables BY VALUE, as a __grid_constant__ kernel parameter;
//    the C entry point splits more tables into launches of kMaxTables each.
//    Blocks map to tables by prefix sums of each table's blocks (a binary
//    search of the prefix).
//  - A warp takes 32 consecutive slots: each lane reads one uid (one
//    coalesced load), and a ballot finds the real ones. A group with no
//    real id (~78% of the slots at the Zipf mix are sentinels) leaves after
//    that load; nothing assumes where the sentinels lie.
//  - The real slots of a group are taken kSlotsInFlight at a time, and for
//    all of them the gradient row, the accumulator and the table row are
//    loaded before any is used: they depend only on the uid, so one
//    round trip to memory serves kSlotsInFlight slots, and their
//    arithmetic is interleaved stage by stage. Rows wider than 32 floats
//    take the slots one at a time.
//  - The block copies its table's pointers and sizes into registers once;
//    read through the parameter, they were read again after each store.
// At dcn_criteo's shape (tools/ab_sparse.py, 10 calls a graph): 15.4 us at
// the Zipf mix and 45.5 us at uniform ids (bounds 5.8 and 24.2 us), against
// 66.0 and 115.5 us for one launch a table of the one-table kernel before.
// The arithmetic of a slot is fixed: lane j takes elements j, j+32, ... of
// the row; the sum of squares is reduced in f32 in a fixed order (each lane
// in order, then a butterfly of shuffles, which leaves the same sum in
// every lane), so runs repeat bit for bit, and how many slots are in flight
// changes nothing; the division, square root and update use the _rn
// intrinsics so nothing is contracted into an FMA and each step rounds as
// the plain PyTorch version does.
//
// Caller contract, as for the TPU kernel: real ids are distinct within a
// table (the duplicate combine runs first), and no two tables or
// accumulators share memory; two slots that wrote one row would race.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxTables = 64;     // tables one launch's descriptor holds
constexpr int kWarpsPerBlock = 4;  // against 8: 45.5 against 51.7 us at uniform ids
constexpr int kSlotsInFlight = 8;  // real slots whose rows a warp loads at once
constexpr unsigned kFull = 0xffffffffu;

struct Table {
  float* table;       // [vocab, d] f32, updated in place
  float* acc;         // [vocab] f32, updated in place
  const int* uids;    // [n] int32
  const float* g;     // [n, d] f32
  long long vocab;
  int n;
  int d;
};

struct Launch {
  Table tables[kMaxTables];
  int block_start[kMaxTables + 1];  // first block of each table; [count] = grid
  int count;
  float lr;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// Up to kSlotsInFlight real slots of a group at a time, at d <= 32 (one
// element a lane). `mask` holds the group's real lanes; u is this lane's id.
__device__ __forceinline__ void update_narrow(float* __restrict__ table, float* __restrict__ acc,
                                              const float* __restrict__ g, int d, int64_t base,
                                              int lane, int64_t u, unsigned mask, float lr,
                                              float eps) {
  const bool mine = lane < d;
  while (mask != 0) {
    int64_t row[kSlotsInFlight];  // the real id of each slot taken; -1 if none
    int src[kSlotsInFlight];      // its lane: slot base + src
#pragma unroll
    for (int s = 0; s < kSlotsInFlight; ++s) {
      src[s] = mask != 0 ? __ffs(mask) - 1 : 0;
      const int64_t su = __shfl_sync(kFull, u, src[s]);
      row[s] = mask != 0 ? su : -1;
      mask &= mask - 1;
    }
    float gv[kSlotsInFlight], tv[kSlotsInFlight], av[kSlotsInFlight];
#pragma unroll
    for (int s = 0; s < kSlotsInFlight; ++s) {
      gv[s] = tv[s] = av[s] = 0.0f;
      if (row[s] >= 0) {
        av[s] = acc[row[s]];
        if (mine) {
          gv[s] = __ldg(g + (base + src[s]) * d + lane);
          tv[s] = table[row[s] * d + lane];
        }
      }
    }
    // The slots' arithmetic side by side, stage by stage, so their
    // dependent chains (butterfly, division, square root) overlap.
    float ssq[kSlotsInFlight];
#pragma unroll
    for (int s = 0; s < kSlotsInFlight; ++s) {
      ssq[s] = mine ? __fadd_rn(0.0f, __fmul_rn(gv[s], gv[s])) : 0.0f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int s = 0; s < kSlotsInFlight; ++s) ssq[s] += __shfl_xor_sync(kFull, ssq[s], off);
    }
#pragma unroll
    for (int s = 0; s < kSlotsInFlight; ++s) {
      const float a = __fadd_rn(av[s], __fdiv_rn(ssq[s], (float)d));
      const float scale = __fdiv_rn(lr, __fadd_rn(__fsqrt_rn(a), eps));
      if (row[s] >= 0) {  // the same for the whole warp
        if (mine) table[row[s] * d + lane] = __fsub_rn(tv[s], __fmul_rn(scale, gv[s]));
        if (lane == 0) acc[row[s]] = a;
      }
    }
  }
}

// The real slots of a group one at a time, at any d: two passes over the
// gradient row (the sum of squares, then the update).
__device__ __forceinline__ void update_wide(float* __restrict__ table, float* __restrict__ acc,
                                            const float* __restrict__ g, int d, int64_t base,
                                            int lane, int64_t u, unsigned mask, float lr,
                                            float eps) {
  while (mask != 0) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const int64_t row = __shfl_sync(kFull, u, src);
    const float* gr = g + (base + src) * d;
    float ssq = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float v = __ldg(gr + j);
      ssq = __fadd_rn(ssq, __fmul_rn(v, v));
    }
    ssq = warp_sum(ssq);
    const float a = __fadd_rn(acc[row], __fdiv_rn(ssq, (float)d));
    const float scale = __fdiv_rn(lr, __fadd_rn(__fsqrt_rn(a), eps));
    float* tr = table + row * d;
    for (int j = lane; j < d; j += 32) {
      tr[j] = __fsub_rn(tr[j], __fmul_rn(scale, __ldg(gr + j)));
    }
    if (lane == 0) acc[row] = a;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rowwise_adagrad_kernel(const __grid_constant__ Launch launch) {
  // The table of this block: the last whose first block is <= blockIdx.x.
  const int b = blockIdx.x;
  int lo = 0, hi = launch.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (launch.block_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const Table& t = launch.tables[lo];
  const int local_block = b - launch.block_start[lo];
  // The entry's fields in registers once: read through the parameter's
  // address, they would be read again after every store to a table.
  float* const table = t.table;
  float* const acc = t.acc;
  const int* const uids = t.uids;
  const float* const g = t.g;
  const int64_t vocab = t.vocab;
  const int n = t.n, d = t.d;
  const float lr = launch.lr, eps = launch.eps;
  const int lane = threadIdx.x & 31;
  const int64_t base = ((int64_t)local_block * kWarpsPerBlock + (threadIdx.x >> 5)) * 32;
  if (base >= n) return;  // the same for the whole warp
  const int64_t slot = base + lane;
  const int64_t u = slot < n ? __ldg(uids + slot) : -1;
  const unsigned mask = __ballot_sync(kFull, u >= 0 && u < vocab);
  if (mask == 0) return;
  if (d <= 32) {
    update_narrow(table, acc, g, d, base, lane, u, mask, lr, eps);
  } else {
    update_wide(table, acc, g, d, base, lane, u, mask, lr, eps);
  }
}

int flush(Launch& launch, int64_t& blocks, cudaStream_t stream, int* launches) {
  if (launch.count == 0) return 0;
  launch.block_start[launch.count] = static_cast<int>(blocks);
  rowwise_adagrad_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                           stream>>>(launch);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  ++*launches;
  launch.count = 0;
  blocks = 0;
  return 0;
}

}  // namespace

// desc holds 7 values a table: table [vocab, d] f32 and acc [vocab] f32
// (updated in place), uids [n] int32, g [n, d] f32 (pointers, contiguous on
// the current device), n, vocab and d. Tables with n == 0 or d == 0 are
// skipped. Launches on `stream`, kMaxTables tables a launch, and counts the
// launches made in *launches. Returns cudaGetLastError() of the first launch
// refused, else 0 (and cudaErrorInvalidValue, launching nothing more, for a
// table past int sizes: n, d or the grid above INT_MAX).
extern "C" int tfrec_rowwise_adagrad_multi(const long long* desc, int num_tables,
                                           float lr, float eps, void* stream,
                                           int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launches = 0;
  Launch launch;
  launch.count = 0;
  launch.lr = lr;
  launch.eps = eps;
  int64_t blocks = 0;
  const int64_t slots_per_block = kWarpsPerBlock * 32;
  for (int i = 0; i < num_tables; ++i) {
    const long long* e = desc + 7 * i;
    const long long n = e[4], vocab = e[5], d = e[6];
    if (n <= 0 || d <= 0) continue;
    if (n > INT_MAX || d > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t nb = (n + slots_per_block - 1) / slots_per_block;
    if (launch.count == kMaxTables || blocks + nb > INT_MAX) {
      const int rc = flush(launch, blocks, s, launches);
      if (rc != 0) return rc;
    }
    Table& t = launch.tables[launch.count];
    t.table = reinterpret_cast<float*>(e[0]);
    t.acc = reinterpret_cast<float*>(e[1]);
    t.uids = reinterpret_cast<const int*>(e[2]);
    t.g = reinterpret_cast<const float*>(e[3]);
    t.vocab = vocab;
    t.n = static_cast<int>(n);
    t.d = static_cast<int>(d);
    launch.block_start[launch.count] = static_cast<int>(blocks);
    ++launch.count;
    blocks += nb;
  }
  return flush(launch, blocks, s, launches);
}
