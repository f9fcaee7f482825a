// Padded EmbeddingBag for Hopper (sm_90a).
//
// Replaces the TPU kernel embedding_bag_pallas (src/repro/kernels/
// embedding_bag/kernel.py:81, body _bag_kernel at :28). For each bag b:
//
//   acc = 0;  for f = 0 .. F-1:  acc = acc + w[b,f] * float(table[ids[b,f]])
//   mean: acc = acc / max(sum_f w[b,f], 1e-9)     (the sum in the same order)
//   out[b] = round_to_nearest(acc) in the table's dtype
//
// f32 accumulation, weights in f32 (a null weights pointer means all ones),
// one rounding at the end, as the Pallas kernel does. With F = 1 and weight
// 1 the result is the row itself, bit for bit: that is the recsys `lookup`,
// one bag per (sample, field).
//
// What bounds it: bytes. Each bag reads F rows of D elements from anywhere in
// a table of up to 10^8 rows and writes one row; the arithmetic is one
// multiply and one add per element read. At uniform ids a row of a large
// field is read about once and a row of a small field (DLRM has 18 of 26
// fields with fewer rows than a bulk batch has samples) again and again, from
// L2. With one row a bag and nothing else to wait on, the card reaches its
// memory rate only with many independent row loads in flight on each SM.
// What the design does about it (the vector path): 16-byte loads and stores,
// 8 bf16 or 4 f32 a lane, so a row of R 16-byte vectors takes a group of
// `lanes` = R rounded up to a power of two (at most 32) and a warp serves
// 32 / lanes bags at once. Each warp takes runs of bags from a grid of at
// most the blocks the card holds resident at once (the occupancy API's count
// for this kernel, times the SMs), looping over runs; a group walks its
// bags' (bag, f) items in
// windows of kAhead: it reads the window's ids and weights, then issues all
// kAhead row loads, and only then accumulates them, in order, into f32
// registers, storing a bag when its last item is added. So each lane has
// kAhead independent 16-byte row loads in flight, whether the bags hold one
// row each or many. The wrapper picks this path when a row is a whole number
// of 16-byte vectors and the table and output are 16-byte aligned, with the
// lanes and bags a group and the grid of one run a warp
// (kernel.py: bag_geometry); the launch caps that grid at the resident blocks.
// The scalar path, for any other width or alignment: one warp a bag, lanes
// striding over D with up to 16 accumulators each, the bag's ids and weights
// read 32 at a time and broadcast by warp shuffles.
//
// Indexing is 64-bit throughout: the full-width DLRM table has
// 187,767,552 x 128 = 2.4e10 elements, so ids[b,f] * D overflows int32.
// Ids are not bounds-checked (the Pallas kernel does not check them either):
// the caller keeps them in [0, V).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_attributes.cuh"

namespace {

constexpr int kThreads = 256;            // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 8;                // row loads a lane has in flight
constexpr int kPerLane = 16;             // scalar path: accumulators per lane
constexpr int kTile = 32 * kPerLane;     // scalar path: columns a warp covers in one pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float clamp_denominator(float denom) {
  return (isnan(denom) || denom > 1e-9f) ? denom : 1e-9f;
}

// ---------------------------------------------------------------- scalar path
template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel_scalar(const T* __restrict__ table, const int* __restrict__ ids,
                            const float* __restrict__ weights, long long B, int F,
                            int D, int mean, T* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const long long b = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (b >= B) return;
  const int* bag_ids = ids + b * F;
  const float* bag_w = weights ? weights + b * F : nullptr;

  // Σw in the order f = 0 .. F-1, as the Pallas kernel's second loop.
  float denom = 0.0f;
  if (mean) {
    for (int f = 0; f < F; ++f) denom = denom + (bag_w ? bag_w[f] : 1.0f);
    denom = clamp_denominator(denom);
  }

  for (int d0 = 0; d0 < D; d0 += kTile) {
    float acc[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] = 0.0f;

    for (int f0 = 0; f0 < F; f0 += 32) {
      const int n = min(32, F - f0);
      const long long my_id = lane < n ? (long long)bag_ids[f0 + lane] : 0;
      const float my_w = lane < n ? (bag_w ? bag_w[f0 + lane] : 1.0f) : 0.0f;
      for (int i = 0; i < n; ++i) {
        const long long row = __shfl_sync(0xffffffffu, my_id, i);
        const float w = __shfl_sync(0xffffffffu, my_w, i);
        const T* src = table + row * (long long)D + d0;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int d = lane + 32 * j;
          if (d0 + d < D) acc[j] = acc[j] + w * to_float(src[d]);
        }
      }
    }

    T* dst = out + b * (long long)D + d0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d0 + d < D) store(dst + d, mean ? acc[j] / denom : acc[j]);
    }
  }
}

// ---------------------------------------------------------------- vector path
// A 16-byte vector as floats, and floats rounded back into one. bf16 -> f32 is
// exact (the bf16 bits are the high half of the f32); f32 -> bf16 rounds to
// nearest even, as __float2bfloat16_rn.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static __forceinline__ float get(const uint4& v, int e) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    return __uint_as_float(w[e]);
  }
  __device__ static __forceinline__ uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ float get(const uint4& v, int e) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const uint32_t word = w[e / 2];
    return __uint_as_float((e & 1) ? (word & 0xFFFF0000u) : (word << 16));
  }
  __device__ static __forceinline__ uint32_t two(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  __device__ static __forceinline__ uint4 pack(const float* x) {
    return make_uint4(two(x[0], x[1]), two(x[2], x[3]), two(x[4], x[5]), two(x[6], x[7]));
  }
};

// kLanes lanes serve one bag; a run gives each of a warp's 32 / kLanes groups
// `bags` bags, interleaved (group g takes bags b0 + g + groups * m), so the
// groups of a warp read neighbouring ids and write neighbouring output rows.
// vpr: 16-byte vectors a row; row r's vector v is table[r * vpr + v].
template <typename T, int kLanes>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel_vector(const uint4* __restrict__ table, const int* __restrict__ ids,
                            const float* __restrict__ weights, long long B, int F,
                            int vpr, int bags, int mean, uint4* __restrict__ out) {
  using V = Vec<T>;
  constexpr int kGroups = 32 / kLanes;
  const int lane = threadIdx.x % 32;
  const int group = lane / kLanes;
  const int glane = lane % kLanes;
  const long long run_bags = (long long)kGroups * bags;
  const long long n_runs = (B + run_bags - 1) / run_bags;
  const long long n_warps = (long long)gridDim.x * kWarps;

  for (long long run = (long long)blockIdx.x * kWarps + threadIdx.x / 32; run < n_runs;
       run += n_warps) {
    const long long b0 = run * run_bags + group;   // the group's m-th bag: b0 + kGroups m
    // (bag, f) items of the group in this run: its bags below B, F items each
    const long long left = B - b0;
    const long long items =
        left <= 0 ? 0 : min((long long)bags, (left + kGroups - 1) / kGroups) * F;
    for (int v = glane; v < vpr; v += kLanes) {
      float acc[V::kN];
      float denom = 0.0f;
      int m = 0, f = 0;                    // the next item to accumulate
      for (long long k0 = 0; k0 < items; k0 += kAhead) {
        // the window's ids and weights ...
        long long row[kAhead];
        float w[kAhead];
        int mi = m, fi = f;
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const long long pos = (b0 + (long long)kGroups * mi) * F + fi;
          row[u] = k0 + u < items ? (long long)ids[pos] : 0;
          w[u] = k0 + u < items && weights ? weights[pos] : 1.0f;
          if (++fi == F) {
            fi = 0;
            ++mi;
          }
        }
        // ... then all of its row loads ...
        uint4 x[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (k0 + u < items) x[u] = table[row[u] * vpr + v];
        }
        // ... then the sums, in the order f = 0 .. F-1 within each bag
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (k0 + u >= items) break;      // the rest of the window is past the items
          if (f == 0) {
#pragma unroll
            for (int e = 0; e < V::kN; ++e) acc[e] = 0.0f;
            denom = 0.0f;
          }
#pragma unroll
          for (int e = 0; e < V::kN; ++e) acc[e] = acc[e] + w[u] * V::get(x[u], e);
          if (mean) denom = denom + w[u];
          if (++f == F) {
            if (mean) {
              const float dd = clamp_denominator(denom);
#pragma unroll
              for (int e = 0; e < V::kN; ++e) acc[e] = acc[e] / dd;
            }
            out[(b0 + (long long)kGroups * m) * vpr + v] = V::pack(acc);
            f = 0;
            ++m;
          }
        }
      }
    }
  }
}

// Blocks of `kernel` an SM holds at once (its registers decide: ptxas -v
// prints them), asked once per kernel.
template <typename K>
int resident_per_sm(K kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) != cudaSuccess) {
    return 1;
  }
  return n > 0 ? n : 1;
}

// `blocks` is the grid of one run a warp; it is capped at the blocks `sms`
// SMs hold resident, and the warps loop over the runs.
template <typename T>
void launch_vector(int lanes, int blocks, int sms, cudaStream_t s, const void* table,
                   const int* ids, const float* weights, long long B, int F, int vpr,
                   int bags, int mean, void* out) {
  const uint4* t = (const uint4*)table;
  uint4* o = (uint4*)out;
  switch (lanes) {
#define EB_CASE(L)                                                                     \
  case L: {                                                                            \
    static const int per_sm = resident_per_sm(embedding_bag_kernel_vector<T, L>);     \
    const long long most = (long long)per_sm * sms;                                    \
    const int grid = blocks < most ? blocks : (int)most;                               \
    embedding_bag_kernel_vector<T, L><<<grid, kThreads, 0, s>>>(t, ids, weights, B, F, \
                                                                 vpr, bags, mean, o);  \
    break;                                                                             \
  }
    EB_CASE(1) EB_CASE(2) EB_CASE(4) EB_CASE(8) EB_CASE(16) EB_CASE(32)
#undef EB_CASE
  }
}

}  // namespace

// dtype 0: float32 table and output; 1: bfloat16. weights may be null (all
// ones). lanes 0 takes the scalar path (one warp a bag, `blocks` blocks of 8
// bags); lanes in {1, 2, 4, 8, 16, 32} the vector path, with `bags` bags a
// group in each run and at most `blocks` blocks (capped at the blocks the
// card holds resident), which needs D * element size a multiple of 16 and
// 16-byte aligned table and out. Launches on `stream` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// geometry the kernels do not take.
extern "C" int embedding_bag_launch(const void* table, const int* ids,
                                    const float* weights, long long B, int F,
                                    int D, int mean, int dtype, int lanes, int bags,
                                    int blocks, void* out, void* stream) {
  if (B <= 0 || D <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = (long long)D * (dtype == 1 ? 2 : 4);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  if (lanes == 0) {
    if ((long long)blocks * kWarps < B) return (int)cudaErrorInvalidValue;
    if (dtype == 1) {
      embedding_bag_kernel_scalar<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          (const __nv_bfloat16*)table, ids, weights, B, F, D, mean, (__nv_bfloat16*)out);
    } else {
      embedding_bag_kernel_scalar<float><<<blocks, kThreads, 0, s>>>(
          (const float*)table, ids, weights, B, F, D, mean, (float*)out);
    }
    return (int)cudaGetLastError();
  }
  const bool pow2 = lanes > 0 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (!pow2 || F <= 0 || bags <= 0 || row_bytes % 16 != 0 ||
      ((uintptr_t)table | (uintptr_t)out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int vpr = (int)(row_bytes / 16);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1) {
    launch_vector<__nv_bfloat16>(lanes, blocks, sms, s, table, ids, weights, B, F, vpr, bags,
                                 mean, out);
  } else {
    launch_vector<float>(lanes, blocks, sms, s, table, ids, weights, B, F, vpr, bags, mean,
                         out);
  }
  return (int)cudaGetLastError();
}

// Registers, shared memory, spills and blocks an SM of every kernel the launch
// function above can reach, at the block and dynamic shared memory it launches
// them with (kernel_attributes.cuh); i < 0 gives their number. Launches nothing.
extern "C" int embedding_bag_attributes(int i, const char** name, long long* out) {
#define EB_SCALAR(T, N) {"embedding_bag_kernel_scalar<" N ">", \
                         (const void*)embedding_bag_kernel_scalar<T>, kThreads, 0, false}
#define EB_VECTOR(T, N, L) {"embedding_bag_kernel_vector<" N ", " #L ">", \
                            (const void*)embedding_bag_kernel_vector<T, L>, kThreads, 0, false}
#define EB_VECTORS(T, N) EB_VECTOR(T, N, 1), EB_VECTOR(T, N, 2), EB_VECTOR(T, N, 4), \
                         EB_VECTOR(T, N, 8), EB_VECTOR(T, N, 16), EB_VECTOR(T, N, 32)
  static const KernelEntry kAll[] = {EB_SCALAR(float, "float"), EB_SCALAR(__nv_bfloat16, "bf16"),
                                     EB_VECTORS(float, "float"),
                                     EB_VECTORS(__nv_bfloat16, "bf16")};
#undef EB_VECTORS
#undef EB_VECTOR
#undef EB_SCALAR
  return kernel_attributes(kAll, (int)(sizeof(kAll) / sizeof(kAll[0])), i, name, out);
}
