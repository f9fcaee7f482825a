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
// a table of up to 10^8 rows (no reuse to speak of at uniform ids) and writes
// one row; the arithmetic is one multiply and one add per element read.
// What the design does about it: one warp per bag, lanes striding over D so
// that a warp's load of a row is 32 neighbouring elements; each lane holds up
// to 16 accumulators in registers, so the loads of one row are independent of
// each other; the bag's ids and weights are read once, 32 at a time, one per
// lane, and broadcast by warp shuffles, so no row load waits on an id load of
// its own. Vectorised 16-byte loads, several bags per warp at small D and a
// TMA gather are later work.
//
// Indexing is 64-bit throughout: the full-width DLRM table has
// 187,767,552 x 128 = 2.4e10 elements, so ids[b,f] * D overflows int32.
// Ids are not bounds-checked (the Pallas kernel does not check them either):
// the caller keeps them in [0, V).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 bags per block
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 16;             // accumulators per lane
constexpr int kTile = 32 * kPerLane;     // columns a warp covers in one pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
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
    denom = (isnan(denom) || denom > 1e-9f) ? denom : 1e-9f;
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

}  // namespace

// dtype 0: float32 table and output; 1: bfloat16. weights may be null (all
// ones). Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int embedding_bag_launch(const void* table, const int* ids,
                                    const float* weights, long long B, int F,
                                    int D, int mean, int dtype, void* out,
                                    void* stream) {
  if (B > 0 && D > 0) {
    const long long blocks = (B + kWarps - 1) / kWarps;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 1) {
      embedding_bag_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const __nv_bfloat16*)table, ids, weights, B, F, D, mean,
          (__nv_bfloat16*)out);
    } else {
      embedding_bag_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const float*)table, ids, weights, B, F, D, mean, (float*)out);
    }
  }
  return (int)cudaGetLastError();
}
