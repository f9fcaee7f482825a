// Gradient of the padded EmbeddingBag with respect to the table, for Hopper
// (sm_90a), by rows: deterministic, no atomics.
//
// Replaces no TPU kernel. The JAX package differentiates the recsys lookups
// (jnp.take) by XLA's scatter-add, outside any Pallas kernel; a PyTorch
// float index_add_ on the card adds with atomics in an order that changes
// from run to run. This kernel gives the gradient of every touched row in
// one fixed order instead. For the bags of ids [B, F] (flat item n = b*F + f)
// and the rows' run of items sorted by id (stable: ascending n within a run,
// index bookkeeping done by the wrapper with torch.sort), each run u gives
//
//   acc = 0;  for n in the run, ascending:
//     t = float(grad_out[n / F, d]);  mean: t = t / max(sum_f w[b,f], 1e-9)
//     weights: t = w[n] * t;  acc = acc + t
//   row_grad[u, d] = acc            (f32)
//
// the plain version's arithmetic (kernels/embedding_bag/ref.py:
// embedding_bag_bwd_runs_ref) in the same order, so the two agree bit for
// bit when built with -fmad=false. The denominator is summed in the order
// f = 0 .. F-1 as in the forward kernel.
//
// What bounds it: bytes (each item's gradient row and position read once,
// each distinct row's f32 sum written once: 0.23 ms at dlrm-mlperf's train
// gather), with a floor set by the longest run: f32 addition does not
// reassociate, so a run's items cannot be split into partial sums and keep
// the bits, and each column of a run is one chain of dependent adds, ~4
// cycles an item. dlrm-mlperf's field of 3 rows gives runs of ~22,000 items,
// ~50 us of adds in series. Two kernels, the runs split by length at
// `long_run` items, and a plan (kernels/embedding_bag/kernel.py: bwd_tiles
// and long_runs are its plain versions):
//
// - Short runs (at most long_run items), for the bytes: one warp a tile of
//   consecutive runs, those whose first item lies in one stretch of
//   tile_items items of `order` (tiles_kernel), so that no warp walks more
//   than tile_items + long_run items; kTile runs at a time, their items
//   contiguous in `order`. The warp reads the runs' offsets and its items'
//   positions 32 at a time and keeps kAhead gradient-row loads a lane in
//   flight across run boundaries, storing each run's sum when its last item
//   is added, so a run of one or two items costs no round trip of its own.
//   Lanes lie across D with loads of up to 4 elements, the fewest that let
//   32 lanes cover the row (8 bytes, 4 bf16, at D = 128), so every lane of a
//   wide row is live.
// - Long runs, for the floor: one block a (run, slice of kLongCols columns)
//   work item, so a long run's columns are spread over D / 32 blocks on as
//   many SMs. kProducers warps stage the run's items through a ring of
//   kStages shared-memory stages with cp.async (16, 8 or 4 bytes a copy, or
//   2-byte loads where the rows allow no more), the items' positions copied
//   ahead of their rows, so ~6 stages (~770 items at bf16) are in flight;
//   one warp adds, one column a lane, each stage's items in order from
//   shared memory. Named barriers hand stages between them. A persistent
//   grid of the blocks the card holds walks the work longest run first (odd
//   rounds backwards), so the longest runs start first and none is left as
//   the tail.
// - The plan: tiles_kernel on the caller's stream; select_long_kernel (each
//   block's long runs, in order) and sort_long_kernel (one block: gathers
//   them and sorts them longest first, stably) on a second stream of higher
//   priority, with the long-run kernel after them. The short-run kernel
//   runs on the caller's stream beside them, and the caller's stream waits
//   for the second at the end. No host read, no atomics.
//
// Indexing is 64-bit: positions run to B*F and rows to 1.9e8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "kernel_attributes.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;

// short runs
constexpr int kShortThreads = 256;
constexpr int kShortWarps = kShortThreads / 32;
constexpr int kTile = 32;                // runs a warp, one a lane for their offsets

// long runs
constexpr int kLongCols = 32;            // columns of a slice, one a lane of the adding warp
constexpr int kStages = 7;               // ring of stages a block
static_assert(2 * kStages < 16, "a named barrier each way a stage, beside barrier 0");
constexpr int kStageBytes = 8192;        // one stage: its items' slices
constexpr int kProducers = 4;            // warps a block that stage the items
constexpr int kLongThreads = 32 * (1 + kProducers);  // and one warp that adds

// the long runs' plan
constexpr int kSelectThreads = 256;
constexpr long long kSelectChunk = 4096;  // runs a block of the selection scans
constexpr int kSortThreads = 1024;
constexpr int kSortCap = 4096;           // long runs sorted in shared memory (more: device)

template <int kBytes> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float clamp_denominator(float denom) {
  return (isnan(denom) || denom > 1e-9f) ? denom : 1e-9f;
}

// max(sum_f w[b, f], 1e-9), summed f = 0 .. F-1 (F with no weights)
__device__ __forceinline__ float bag_denominator(const float* weights, long long b, int F) {
  float denom = 0.0f;
  for (int f = 0; f < F; ++f) denom = denom + (weights ? weights[b * F + f] : 1.0f);
  return clamp_denominator(denom);
}

// ------------------------------------------------------------ short runs

template <int kVec>
__device__ __forceinline__ void store_sum(float* out, long long u, int D, int d0, bool live,
                                          float (&acc)[kVec]) {
  if (live) {
    float* dst = out + u * (long long)D + d0;
    if constexpr (kVec % 4 == 0) {
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(dst + e) = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
    } else if constexpr (kVec == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
    } else {
      dst[0] = acc[0];
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
}

// grad [B, D] (T), order [N] flat positions sorted by id, starts [U + 1] run
// offsets into order, weights [B * F] f32 or null (ones) -> out [U, D] f32
// for the runs of at most long_run items. Warp t takes runs tiles[t] ..
// tiles[t + 1] - 1, kTile at a time; each lane owns kVec consecutive columns
// of a pass.
template <typename T, int kVec>
__global__ void __launch_bounds__(kShortThreads)
short_runs_kernel(const T* __restrict__ grad, const long long* __restrict__ order,
                  const long long* __restrict__ starts, const float* __restrict__ weights,
                  const long long* __restrict__ tiles, long long n_tiles, int F, int D,
                  int mean, long long long_run, float* __restrict__ out) {
  using R = typename Raw<kVec * sizeof(T)>::type;
  constexpr int kAhead = sizeof(R) == 16 ? 8 : 16;   // row loads a lane has in flight
  const int lane = threadIdx.x % 32;
  const long long tile = (long long)blockIdx.x * kShortWarps + threadIdx.x / 32;
  if (tile >= n_tiles) return;
  const long long u_end = tiles[tile + 1];
  for (long long u0 = tiles[tile]; u0 < u_end; u0 += kTile) {
    const int nr = (int)min((long long)kTile, u_end - u0);
    long long my_lo = 0, my_hi = 0;                     // lane r: run u0 + r
    if (lane < nr) {
      my_lo = starts[u0 + lane];
      my_hi = starts[u0 + lane + 1];
    }
    const unsigned longs = __ballot_sync(kAll, lane < nr && my_hi - my_lo > long_run);
    for (int base = 0; base < D; base += 32 * kVec) {
      const int d0 = base + lane * kVec;
      const bool live = d0 < D;            // every lane stays for the shuffles
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
      int r = 0;                           // the run being added (warp-uniform)
      while (r < nr) {
        if (longs >> r & 1u) {             // the long-run kernel's
          ++r;
          continue;
        }
        // runs r .. q-1 are short and their items contiguous: one segment
        const unsigned later = r == 31 ? 0u : longs >> (r + 1) << (r + 1);
        const int q = later ? __ffs(later) - 1 : nr;
        const long long seg_end = __shfl_sync(kAll, my_hi, q - 1);
        long long run_end = __shfl_sync(kAll, my_hi, r);
        for (long long c0 = __shfl_sync(kAll, my_lo, r); c0 < seg_end; c0 += 32) {
          const int n = (int)min(32LL, seg_end - c0);
          // lane i reads item c0 + i: its bag, its weight, its bag's denominator
          long long my_b = 0;
          float my_w = 1.0f, my_den = 1.0f;
          if (lane < n) {
            const long long pos = order[c0 + lane];
            my_b = F == 1 ? pos : pos / F;
            if (weights) my_w = weights[pos];
            if (mean) my_den = bag_denominator(weights, my_b, F);
          }
          for (int i0 = 0; i0 < n; i0 += kAhead) {
            // the window's kAhead gradient-row loads ...
            R x[kAhead];
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
              const int i = i0 + k;        // < 32: kAhead divides 32
              const long long b = __shfl_sync(kAll, my_b, i);
              x[k] = R{};
              if (live && i < n) x[k] = *reinterpret_cast<const R*>(grad + b * D + d0);
            }
            // ... then the adds, in the runs' order
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
              const int i = i0 + k;
              if (i >= n) break;           // the same for the whole warp
              const float w = weights ? __shfl_sync(kAll, my_w, i) : 1.0f;
              const float den = mean ? __shfl_sync(kAll, my_den, i) : 1.0f;
              while (c0 + i == run_end) {  // run r is complete: store it
                store_sum<kVec>(out, u0 + r, D, d0, live, acc);
                ++r;
                run_end = __shfl_sync(kAll, my_hi, r);
              }
              T v[kVec];
              memcpy(v, &x[k], sizeof(R));
#pragma unroll
              for (int e = 0; e < kVec; ++e) {
                float t = to_float(v[e]);
                if (mean) t = t / den;
                if (weights) t = w * t;
                acc[e] = acc[e] + t;
              }
            }
          }
        }
        for (; r < q; ++r) store_sum<kVec>(out, u0 + r, D, d0, live, acc);
      }
    }
  }
}

// ------------------------------------------------------------- long runs

template <int kBytes>
__device__ __forceinline__ void copy_unit(unsigned char* dst, const unsigned char* src) {
  if constexpr (kBytes == 2) {
    *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
  } else {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (kBytes == 16)          // L2 only: the rows are read once
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(kBytes)
                   : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// named barriers of the long-run block's kLongThreads threads
__device__ __forceinline__ void named_sync(int id) {     // wait for the other side's arrive
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kLongThreads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {   // let the other side's sync pass
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kLongThreads) : "memory");
}

// by_len [M] the long runs longest first (stable), then -1s. Round r of
// block b takes work item r * G + b (G blocks; G - 1 - b on odd rounds):
// item i is run by_len[i / slices], columns (i % slices) * kLongCols .. +
// kLongCols - 1, and the walk stops at the first -1. Warp 0 adds, warps 1 ..
// kProducers stage: producer warp p copies, for the items 32k + lane of a
// stage with k = p mod kProducers, their positions (kPosLead stages ahead)
// and then their rows' slices (`units` copies of kCopy bytes each) by
// cp.async, and arrives at the stage's "full" barrier once it has landed;
// the adding warp syncs on "full", adds the stage's items in order, one
// column a lane, and arrives at "empty", which the producers sync on before
// they fill the stage again.
template <typename T, int kCopy>
__global__ void __launch_bounds__(kLongThreads, 1)   // 1: ptxas caps registers, and spills, without it
long_runs_kernel(const T* __restrict__ grad, const long long* __restrict__ order,
                 const long long* __restrict__ starts, const float* __restrict__ weights,
                 const long long* __restrict__ by_len, long long M, int F, int D, int mean,
                 int slices, float* __restrict__ out) {
  constexpr int kPitch = kLongCols * (int)sizeof(T);  // bytes of an item's slice in a stage
  constexpr int kItems = kStageBytes / kPitch;        // items a stage: 128 bf16, 64 f32
  constexpr int kPer = kItems / 32;                   // items a producer lane owns a stage
  constexpr int kFull = 1, kEmpty = 1 + kStages;      // named barrier ids, one a stage
  constexpr int kLag = kStages - 1;                   // stages the producer keeps in flight
  constexpr int kPosLead = kLag;                      // stages positions are copied ahead
  constexpr int kPosSlots = kPosLead + 1;
  // dynamic shared memory (long_smem_bytes): the ring of stages (item i of
  // a stage at i * kPitch), the positions' slots, the scales (w, den) with
  // weights or mean
  extern __shared__ __align__(16) unsigned char smem[];
  auto ring = reinterpret_cast<unsigned char (*)[kItems * kPitch]>(smem);
  auto pos = reinterpret_cast<long long (*)[kItems]>(smem + kStages * kStageBytes);
  auto scale = reinterpret_cast<float2 (*)[kItems]>(smem + kStages * kStageBytes +
                                                    kPosSlots * kItems * sizeof(long long));
  const int lane = threadIdx.x % 32;
  const bool producer = threadIdx.x >= 32;
  const int pw = threadIdx.x / 32 - 1;                // producer warp: items 32k + lane, k = pw mod kProducers
  const bool scaled = weights != nullptr || mean;

  for (long long r = 0;; ++r) {         // round r: work item r * G + b, or G - 1 - b on odd rounds
    const long long w = r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    if (w >= M * slices) break;
    const long long u = by_len[w / slices];
    if (u < 0) break;                                 // no more long runs
    const long long lo = starts[u], hi = starts[u + 1];
    const int col0 = (int)(w % slices) * kLongCols;
    const int cols = min(kLongCols, D - col0);
    const int n_stages = (int)((hi - lo + kItems - 1) / kItems);

    if (producer) {
      const int units = cols * (int)sizeof(T) / kCopy;  // copies an item
      // stage t's positions into pos[t % kPosSlots] (8-byte copies; the
      // run's items only), kPosLead stages before its rows are copied
      auto copy_positions = [&](int t) {
        const long long first = lo + (long long)t * kItems;
        long long* slot = pos[t % kPosSlots];
        for (int k = pw; k < kPer; k += kProducers) {
          const int i = lane + 32 * k;
          if (first + i < hi)
            copy_unit<8>(reinterpret_cast<unsigned char*>(slot + i),
                         reinterpret_cast<const unsigned char*>(order + first + i));
        }
      };
      for (int t = 0; t < kPosLead && t < n_stages; ++t) copy_positions(t);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      for (int s = 0; s < n_stages; ++s) {
        if (s >= kLag) {                 // stage s - kLag has landed, and its positions
          cp_async_wait<kLag - 1>();
          __syncwarp();
          named_arrive(kFull + (s - kLag) % kStages);
        }
        if (s >= kStages) named_sync(kEmpty + s % kStages);   // its buffer is free
        unsigned char* buf = ring[s % kStages];
        const long long first = lo + (long long)s * kItems;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (k % kProducers != pw) continue;
          const int i = lane + 32 * k;
          const long long p = first + i < hi ? pos[s % kPosSlots][i] : -1;
          const long long b = p < 0 ? -1 : F == 1 ? p : p / F;     // this lane's item's row
          if (scaled && p >= 0)
            scale[s % kStages][i] = make_float2(weights ? weights[p] : 1.0f,
                                                mean ? bag_denominator(weights, b, F) : 1.0f);
          if (b >= 0) {
            const unsigned char* src = reinterpret_cast<const unsigned char*>(grad + b * D + col0);
            for (int unit = 0; unit < units; ++unit)
              copy_unit<kCopy>(buf + i * kPitch + unit * kCopy, src + unit * kCopy);
          }
        }
        __syncwarp();                    // pos[s % kPosSlots] is read
        if (s + kPosLead < n_stages) copy_positions(s + kPosLead);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncwarp();
      for (int s = max(0, n_stages - kLag); s < n_stages; ++s) named_arrive(kFull + s % kStages);
    } else {
      float acc = 0.0f;
      for (int s = 0; s < n_stages; ++s) {
        named_sync(kFull + s % kStages);
        const int m = (int)min((long long)kItems, hi - lo - (long long)s * kItems);
        if (lane < cols) {
          const unsigned char* col = ring[s % kStages] + lane * sizeof(T);
          if (!scaled && m == kItems) {  // the common stage: no scales, all items
#pragma unroll 32
            for (int i = 0; i < kItems; ++i)
              acc = acc + to_float(*reinterpret_cast<const T*>(col + i * kPitch));
          } else {
            for (int i = 0; i < m; ++i) {
              float t = to_float(*reinterpret_cast<const T*>(col + i * kPitch));
              if (mean) t = t / scale[s % kStages][i].y;
              if (weights) t = scale[s % kStages][i].x * t;
              acc = acc + t;
            }
          }
        }
        if (s + kStages < n_stages) named_arrive(kEmpty + s % kStages);
      }
      if (lane < cols) out[u * D + col0 + lane] = acc;
    }
    __syncthreads();                     // every warp is done with the ring
  }
}

// ------------------------------------------------------------------ plan

// tiles [n_tiles + 1]: tiles[t] is the first run whose first item lies at
// or after starts[0] + t * tile_items (U if none), so that tile t is runs
// tiles[t] .. tiles[t + 1] - 1. Thread u < U writes the entries t with
// starts[u - 1] - starts[0] < t * tile_items <= starts[u] - starts[0]; thread
// U + 1 + t writes entry t = U if it lies past the last run's first item:
// every entry once.
__global__ void tiles_kernel(const long long* __restrict__ starts, long long U,
                             long long tile_items, long long n_tiles,
                             long long* __restrict__ tiles) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long base = starts[0];
  if (x < U) {
    const long long t_lo = x == 0 ? 0 : (starts[x - 1] - base) / tile_items + 1;
    const long long t_hi = min(n_tiles, (starts[x] - base) / tile_items);
    for (long long t = t_lo; t <= t_hi; ++t) tiles[t] = x;
  } else if (x > U && x - U - 1 <= n_tiles) {
    const long long t = x - U - 1;
    if (t > (starts[U - 1] - base) / tile_items) tiles[t] = U;
  }
}

// Block g writes the runs of more than long_run items among runs
// g * kSelectChunk .. + kSelectChunk - 1, ascending, to seg from
// g * kSelectChunk on, and their number to seg_n[g].
__global__ void __launch_bounds__(kSelectThreads)
select_long_kernel(const long long* __restrict__ starts, long long U, long long long_run,
                   long long* __restrict__ seg, long long* __restrict__ seg_n) {
  __shared__ int warp_n[kSelectThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long lo = (long long)blockIdx.x * kSelectChunk;
  const long long hi = min(lo + kSelectChunk, U);
  long long n = 0;
  for (long long r0 = lo; r0 < hi; r0 += kSelectThreads) {
    const long long u = r0 + threadIdx.x;
    const bool flag = u < hi && starts[u + 1] - starts[u] > long_run;
    const unsigned ballot = __ballot_sync(kAll, flag);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kSelectThreads / 32; ++w) {
      before += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (flag) seg[lo + n + before + __popc(ballot & ((1u << lane) - 1u))] = u;
    n += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) seg_n[blockIdx.x] = n;
}

// Exclusive prefix sum over the block of one value a thread; the block's
// total in *total.
__device__ long long block_exclusive_scan(long long v, long long* warp_sums, long long* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  long long x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < (int)(blockDim.x / 32) ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kAll, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;                 // inclusive over the warps
  }
  __syncthreads();
  const long long before = (warp ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[blockDim.x / 32 - 1];
  __syncthreads();                       // warp_sums is free again
  return before;
}

// Bitonic sort of keys[0 .. n_pow2) into descending order by the block.
__device__ void bitonic_descending(unsigned long long* keys, int n_pow2) {
  for (int k = 2; k <= n_pow2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n_pow2; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = keys[i], b = keys[l];
          if ((i & k) == 0 ? a < b : a > b) {
            keys[i] = b;
            keys[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// One block: gathers the G segments of select_long_kernel in order, sorts
// them by (length descending, run ascending) as one key a run, and writes
// by_len [M]: the runs, then -1s. Up to kSortCap runs sort in shared memory,
// more in keys_global (next_pow2(M) entries).
__global__ void __launch_bounds__(kSortThreads)
sort_long_kernel(const long long* __restrict__ starts, const long long* __restrict__ seg,
                 const long long* __restrict__ seg_n, long long G, long long M,
                 unsigned long long* __restrict__ keys_global, long long* __restrict__ by_len) {
  __shared__ unsigned long long keys_shared[kSortCap];
  __shared__ long long warp_sums[32];
  __shared__ long long offsets[kSortThreads];
  long long n = 0, total;
  for (long long g0 = 0; g0 < G; g0 += kSortThreads) {
    const long long g = g0 + threadIdx.x;
    block_exclusive_scan(g < G ? seg_n[g] : 0, warp_sums, &total);
    n += total;
  }
  unsigned long long* keys = n <= kSortCap ? keys_shared : keys_global;
  long long base = 0;
  for (long long g0 = 0; g0 < G; g0 += kSortThreads) {
    const long long g = g0 + threadIdx.x;
    const long long c = g < G ? seg_n[g] : 0;
    offsets[threadIdx.x] = base + block_exclusive_scan(c, warp_sums, &total);
    __syncthreads();
    const int segs = (int)min((long long)kSortThreads, G - g0);
    for (int k = threadIdx.x / 32; k < segs; k += kSortThreads / 32) {   // segment g0 + k, a warp
      const long long cnt = seg_n[g0 + k], off = offsets[k];
      const long long* src = seg + (g0 + k) * kSelectChunk;
      for (long long i = threadIdx.x % 32; i < cnt; i += 32) {
        const long long u = src[i];
        const long long len = min(starts[u + 1] - starts[u], 0x7fffffffLL);
        keys[off + i] = ((unsigned long long)len << 32) | (0xffffffffull - (unsigned long long)u);
      }
    }
    base += total;
    __syncthreads();
  }
  int n_pow2 = 1;
  while (n_pow2 < n) n_pow2 <<= 1;
  for (long long i = n + threadIdx.x; i < n_pow2; i += kSortThreads) keys[i] = 0;
  __syncthreads();
  bitonic_descending(keys, n_pow2);
  for (long long i = threadIdx.x; i < M; i += kSortThreads)
    by_len[i] = i < n ? (long long)(0xffffffffull - (keys[i] & 0xffffffffull)) : -1;
}

template <typename K>
int resident_per_sm(K kernel, int threads, size_t smem = 0) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess) {
    return 1;
  }
  return n > 0 ? n : 1;
}

// The scratch a call needs, in int64: by_len [M] | tiles [n_tiles + 1] |
// seg [U] | seg_n [G] | keys [P].
struct Layout {
  long long M, n_tiles, G, P;
  Layout(long long U, long long N, long long tile_items, long long long_run) {
    M = N / (long_run + 1) < U ? N / (long_run + 1) : U;
    n_tiles = N > tile_items ? (N + tile_items - 1) / tile_items : 1;
    G = (U + kSelectChunk - 1) / kSelectChunk;
    P = 0;
    if (M > kSortCap)
      for (P = 1; P < M; P <<= 1) {
      }
  }
  long long size(long long U) const { return M + n_tiles + 1 + U + G + P; }
};

// tiles on `s`; with M > 0, the long runs' plan on `ls`
void launch_plan(const long long* starts, long long U, long long tile_items,
                 long long long_run, const Layout& l, long long* scratch, cudaStream_t s,
                 cudaStream_t ls) {
  long long* by_len = scratch;
  long long* tiles = by_len + l.M;
  long long* seg = tiles + l.n_tiles + 1;
  long long* seg_n = seg + U;
  unsigned long long* keys = (unsigned long long*)(seg_n + l.G);
  tiles_kernel<<<(int)((U + l.n_tiles + 2 + 255) / 256), 256, 0, s>>>(starts, U, tile_items,
                                                                      l.n_tiles, tiles);
  if (l.M > 0) {
    select_long_kernel<<<(int)l.G, kSelectThreads, 0, ls>>>(starts, U, long_run, seg, seg_n);
    sort_long_kernel<<<1, kSortThreads, 0, ls>>>(starts, seg, seg_n, l.G, l.M, keys, by_len);
  }
}

template <typename T, int kVec>
void launch_short(const void* grad, const long long* order, const long long* starts,
                  const float* weights, const long long* tiles, long long n_tiles, int F, int D,
                  int mean, long long long_run, float* out, cudaStream_t s) {
  const int blocks = (int)((n_tiles + kShortWarps - 1) / kShortWarps);
  short_runs_kernel<T, kVec><<<blocks, kShortThreads, 0, s>>>(
      (const T*)grad, order, starts, weights, tiles, n_tiles, F, D, mean, long_run, out);
}

template <typename T>
constexpr size_t long_smem_bytes() {
  constexpr size_t items = kStageBytes / (kLongCols * sizeof(T));
  return kStages * (kStageBytes + items * sizeof(long long) + items * sizeof(float2));
}

// a persistent grid: the blocks the card holds resident, at most one a work
// item; above 48 KB of shared memory the kernel must be allowed it first
template <typename T, int kCopy>
cudaError_t launch_long(const void* grad, const long long* order, const long long* starts,
                        const float* weights, const long long* by_len, long long M, int F,
                        int D, int mean, float* out, int sms, cudaStream_t s) {
  constexpr size_t bytes = long_smem_bytes<T>();
  static const cudaError_t allowed = cudaFuncSetAttribute(
      long_runs_kernel<T, kCopy>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (allowed != cudaSuccess) return allowed;
  static const int per_sm = resident_per_sm(long_runs_kernel<T, kCopy>, kLongThreads, bytes);
  const int slices = (D + kLongCols - 1) / kLongCols;
  const long long most = (long long)per_sm * sms, work = M * slices;
  long_runs_kernel<T, kCopy><<<(int)(work < most ? work : most), kLongThreads, bytes, s>>>(
      (const T*)grad, order, starts, weights, by_len, M, F, D, mean, slices, out);
  return cudaGetLastError();
}

bool bad_alignment(const void* grad, int D, int elem, int bytes) {
  return bytes < elem || bytes > 16 || (long long)D * elem % bytes != 0 ||
         (uintptr_t)grad % (uintptr_t)bytes != 0;
}

// the two events a device's calls join their streams by, made at first use
cudaError_t join_events(cudaEvent_t** ev) {
  static cudaEvent_t events[64][2];
  static bool made[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!made[dev]) {
    for (int i = 0; i < 2; ++i)
      if ((err = cudaEventCreateWithFlags(&events[dev][i], cudaEventDisableTiming)) != cudaSuccess)
        return err;
    made[dev] = true;
  }
  *ev = events[dev];
  return cudaSuccess;
}

}  // namespace

// int64 entries of scratch a call of U runs over N items needs; layout (4
// entries) gets M (the most long runs there can be), n_tiles, G and P.
extern "C" long long embedding_bag_bwd_scratch(long long U, long long N, long long tile_items,
                                               long long long_run, long long* layout) {
  const Layout l(U, N, tile_items, long_run);
  layout[0] = l.M;
  layout[1] = l.n_tiles;
  layout[2] = l.G;
  layout[3] = l.P;
  return l.size(U);
}

// The plan alone, on `stream`: by_len (scratch[0 .. M)) and tiles
// (scratch[M .. M + n_tiles]), for checking them against their plain
// versions (kernels/embedding_bag/kernel.py: long_runs, bwd_tiles).
extern "C" int embedding_bag_bwd_plan_launch(const long long* starts, long long U, long long N,
                                             long long tile_items, long long long_run,
                                             long long* scratch, void* stream) {
  if (U <= 0) return (int)cudaGetLastError();
  if (tile_items <= 0 || long_run < 0 || N < U) return (int)cudaErrorInvalidValue;
  const Layout l(U, N, tile_items, long_run);
  launch_plan(starts, U, tile_items, long_run, l, scratch, (cudaStream_t)stream,
              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The gradient: grad_out [B, D] (dtype 0: f32, 1: bf16), order [N] and
// starts [U + 1] from row_runs, weights [B * F] or null, scratch of
// embedding_bag_bwd_scratch's size -> out [U, D] f32. On `stream`: the
// tiles, then the short-run kernel (vec: elements a lane loads, 1, 2 or 4,
// dividing D and grad_out's alignment; kernel.py: bwd_vec). With any run
// that can be long: `long_stream` waits for `stream`, takes the long runs'
// plan and the long-run kernel (copy: bytes a copy moves, 2 (bf16), 4, 8 or
// 16, dividing D * element size and grad_out's address; kernel.py:
// bwd_copy), and `stream` waits for it. Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int embedding_bag_bwd_launch(const void* grad, const long long* order,
                                        const long long* starts, const float* weights,
                                        long long U, long long N, int F, int D, int mean,
                                        int dtype, int vec, int copy, long long tile_items,
                                        long long long_run, long long* scratch, float* out,
                                        void* stream, void* long_stream) {
  if (U <= 0 || D <= 0) return (int)cudaGetLastError();
  const int elem = dtype == 1 ? 2 : 4;
  if (F <= 0 || N < U || tile_items <= 0 || long_run < 0 || (dtype != 0 && dtype != 1) ||
      (vec != 1 && vec != 2 && vec != 4) || bad_alignment(grad, D, elem, vec * elem) ||
      bad_alignment(grad, D, elem, copy))
    return (int)cudaErrorInvalidValue;
  const Layout l(U, N, tile_items, long_run);
  cudaStream_t s = (cudaStream_t)stream, ls = (cudaStream_t)long_stream;
  cudaEvent_t* ev = nullptr;
  int dev = 0, sms = 0;
  cudaError_t err = cudaSuccess;
  if (l.M > 0) {
    if ((err = join_events(&ev)) != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaEventRecord(ev[0], s)) != cudaSuccess ||
        (err = cudaStreamWaitEvent(ls, ev[0], 0)) != cudaSuccess)
      return (int)err;
  }
  launch_plan(starts, U, tile_items, long_run, l, scratch, s, ls);
  const long long* by_len = scratch;
  const long long* tiles = scratch + l.M;
#define BWD_SHORT(T, V) \
  launch_short<T, V>(grad, order, starts, weights, tiles, l.n_tiles, F, D, mean, long_run, out, s)
  if (dtype == 1) {
    switch (vec) {
      case 4: BWD_SHORT(__nv_bfloat16, 4); break;
      case 2: BWD_SHORT(__nv_bfloat16, 2); break;
      default: BWD_SHORT(__nv_bfloat16, 1); break;
    }
  } else {
    switch (vec) {
      case 4: BWD_SHORT(float, 4); break;
      case 2: BWD_SHORT(float, 2); break;
      default: BWD_SHORT(float, 1); break;
    }
  }
#undef BWD_SHORT
  if ((err = cudaGetLastError()) != cudaSuccess || l.M == 0) return (int)err;
#define BWD_LONG(T, C) \
  err = launch_long<T, C>(grad, order, starts, weights, by_len, l.M, F, D, mean, out, sms, ls)
  if (dtype == 1) {
    switch (copy) {
      case 16: BWD_LONG(__nv_bfloat16, 16); break;
      case 8: BWD_LONG(__nv_bfloat16, 8); break;
      case 4: BWD_LONG(__nv_bfloat16, 4); break;
      default: BWD_LONG(__nv_bfloat16, 2); break;
    }
  } else {
    switch (copy) {
      case 16: BWD_LONG(float, 16); break;
      case 8: BWD_LONG(float, 8); break;
      default: BWD_LONG(float, 4); break;
    }
  }
#undef BWD_LONG
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaEventRecord(ev[1], ls)) != cudaSuccess) return (int)err;
  return (int)cudaStreamWaitEvent(s, ev[1], 0);
}

// Registers, shared memory, spills and blocks an SM of every kernel the launch
// function above can reach, at the block and dynamic shared memory it launches
// them with (kernel_attributes.cuh); i < 0 gives their number. Launches nothing.
extern "C" int embedding_bag_bwd_attributes(int i, const char** name, long long* out) {
#define BWD_SHORT(T, N, V) {"short_runs_kernel<" N ", " #V ">", \
                            (const void*)short_runs_kernel<T, V>, kShortThreads, 0, false}
#define BWD_LONG(T, N, C) {"long_runs_kernel<" N ", " #C ">", (const void*)long_runs_kernel<T, C>, \
                           kLongThreads, long_smem_bytes<T>(), true}
  static const KernelEntry kAll[] = {
      {"tiles_kernel", (const void*)tiles_kernel, 256, 0, false},
      {"select_long_kernel", (const void*)select_long_kernel, kSelectThreads, 0, false},
      {"sort_long_kernel", (const void*)sort_long_kernel, kSortThreads, 0, false},
      BWD_SHORT(float, "float", 1), BWD_SHORT(float, "float", 2), BWD_SHORT(float, "float", 4),
      BWD_SHORT(__nv_bfloat16, "bf16", 1), BWD_SHORT(__nv_bfloat16, "bf16", 2),
      BWD_SHORT(__nv_bfloat16, "bf16", 4),
      BWD_LONG(float, "float", 4), BWD_LONG(float, "float", 8), BWD_LONG(float, "float", 16),
      BWD_LONG(__nv_bfloat16, "bf16", 2), BWD_LONG(__nv_bfloat16, "bf16", 4),
      BWD_LONG(__nv_bfloat16, "bf16", 8), BWD_LONG(__nv_bfloat16, "bf16", 16)};
#undef BWD_LONG
#undef BWD_SHORT
  return kernel_attributes(kAll, (int)(sizeof(kAll) / sizeof(kAll[0])), i, name, out);
}
