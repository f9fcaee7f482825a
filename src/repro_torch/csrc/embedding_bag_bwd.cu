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
// embedding_bag_padded_bwd_ref) in the same order, so the two agree bit for
// bit when built with -fmad=false. The denominator is summed in the order
// f = 0 .. F-1 as in the forward kernel.
//
// What bounds it: bytes (each item reads a gradient row of D elements and
// adds it once), and on a skewed batch the latency of its longest run: a run
// is one warp and its adds are a serial chain, so a field of 3 rows in a
// batch of 65,536 gives runs of ~22,000 items. What the design does about it:
// one warp a run, lanes across D with vector loads (16, 8, 4 or 2 bytes, as
// D and the alignment allow); the warp reads its run's items 32 at a time,
// one a lane (the position, the weight and the bag's denominator), and
// broadcasts them by shuffles; each lane then issues kAhead gradient-row
// loads before it adds any of them, so a long run keeps kAhead loads in
// flight a lane. Faster kernels for long runs (more lanes on one run's
// columns, loads staged in shared memory) are later work.
//
// Indexing is 64-bit: positions run to B*F and rows to 1.9e8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;            // 8 warps a block, one run a warp
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 16;               // gradient-row loads a lane has in flight
constexpr unsigned kAll = 0xffffffffu;

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

// grad [B, D] (T), order [N] flat positions sorted by id, starts [U + 1] run
// offsets into order, weights [B * F] f32 or null (ones) -> out [U, D] f32.
// Each lane owns kVec consecutive columns d0 .. d0 + kVec - 1 of a pass.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
embedding_bag_bwd_kernel(const T* __restrict__ grad, const long long* __restrict__ order,
                         const long long* __restrict__ starts,
                         const float* __restrict__ weights, long long U, int F, int D,
                         int mean, float* __restrict__ out) {
  using R = typename Raw<kVec * sizeof(T)>::type;
  const int lane = threadIdx.x % 32;
  const long long n_warps = (long long)gridDim.x * kWarps;
  for (long long u = (long long)blockIdx.x * kWarps + threadIdx.x / 32; u < U;
       u += n_warps) {
    const long long lo = starts[u], hi = starts[u + 1];
    for (int base = 0; base < D; base += 32 * kVec) {
      const int d0 = base + lane * kVec;
      const bool live = d0 < D;            // every lane stays for the shuffles
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
      for (long long c0 = lo; c0 < hi; c0 += 32) {
        const int n = (int)min(32LL, hi - c0);
        // lane i reads item c0 + i: its bag, its weight, its bag's denominator
        long long my_b = 0;
        float my_w = 1.0f, my_den = 1.0f;
        if (lane < n) {
          const long long pos = order[c0 + lane];
          my_b = pos / F;
          if (weights) my_w = weights[pos];
          if (mean) {
            float denom = 0.0f;
            for (int f = 0; f < F; ++f) denom = denom + (weights ? weights[my_b * F + f] : 1.0f);
            my_den = clamp_denominator(denom);
          }
        }
        for (int i0 = 0; i0 < n; i0 += kAhead) {
          // the window's kAhead gradient-row loads ...
          R x[kAhead];
          float w[kAhead], den[kAhead];
#pragma unroll
          for (int k = 0; k < kAhead; ++k) {
            const int i = i0 + k;          // < 32: i0 is 0 or kAhead
            const long long b = __shfl_sync(kAll, my_b, i);
            w[k] = __shfl_sync(kAll, my_w, i);
            den[k] = __shfl_sync(kAll, my_den, i);
            x[k] = R{};
            if (live && i < n) x[k] = *reinterpret_cast<const R*>(grad + b * D + d0);
          }
          // ... then the adds, in the run's order
#pragma unroll
          for (int k = 0; k < kAhead; ++k) {
            if (i0 + k >= n) break;        // the same for the whole warp
            T v[kVec];
            memcpy(v, &x[k], sizeof(R));
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              float t = to_float(v[e]);
              if (mean) t = t / den[k];
              if (weights) t = w[k] * t;
              acc[e] = acc[e] + t;
            }
          }
        }
      }
      if (live) {
        float* dst = out + u * (long long)D + d0;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = acc[e];
      }
    }
  }
}

template <typename T, int kVec>
void launch(int blocks, cudaStream_t s, const void* grad, const long long* order,
            const long long* starts, const float* weights, long long U, int F, int D,
            int mean, float* out) {
  embedding_bag_bwd_kernel<T, kVec><<<blocks, kThreads, 0, s>>>(
      (const T*)grad, order, starts, weights, U, F, D, mean, out);
}

}  // namespace

// dtype 0: grad_out f32, 1: bf16. vec: elements a lane loads at once, with
// vec * element size in {2 (bf16 only), 4, 8, 16}, or 1; D must be a
// multiple of vec and grad_out aligned to vec * element size (the wrapper,
// kernels/embedding_bag/kernel.py: bwd_vec, picks it). U runs of order's N
// items; blocks of 8 warps, each warp looping over runs. Launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int embedding_bag_bwd_launch(const void* grad, const long long* order,
                                        const long long* starts, const float* weights,
                                        long long U, int F, int D, int mean, int dtype,
                                        int vec, int blocks, float* out, void* stream) {
  if (U <= 0 || D <= 0) return (int)cudaGetLastError();
  if (F <= 0 || blocks <= 0 || D % vec != 0) return (int)cudaErrorInvalidValue;
  const int elem = dtype == 1 ? 2 : 4;
  if ((uintptr_t)grad % (uintptr_t)(vec * elem) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    switch (vec) {
      case 8: launch<__nv_bfloat16, 8>(blocks, s, grad, order, starts, weights, U, F, D, mean, out); break;
      case 4: launch<__nv_bfloat16, 4>(blocks, s, grad, order, starts, weights, U, F, D, mean, out); break;
      case 2: launch<__nv_bfloat16, 2>(blocks, s, grad, order, starts, weights, U, F, D, mean, out); break;
      case 1: launch<__nv_bfloat16, 1>(blocks, s, grad, order, starts, weights, U, F, D, mean, out); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (dtype == 0) {
    switch (vec) {
      case 4: launch<float, 4>(blocks, s, grad, order, starts, weights, U, F, D, mean, out); break;
      case 2: launch<float, 2>(blocks, s, grad, order, starts, weights, U, F, D, mean, out); break;
      case 1: launch<float, 1>(blocks, s, grad, order, starts, weights, U, F, D, mean, out); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
