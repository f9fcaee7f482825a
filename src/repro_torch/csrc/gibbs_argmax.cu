// Fused Gibbs-sampling / RT-LDA argmax for Hopper (sm_90a).
//
// Replaces the TPU kernel gibbs_argmax_pallas (src/repro/kernels/gibbs/
// kernel.py:92, body _gibbs_kernel at :36). For each token row t:
//
//   z[t] = argmax_k  log(phi[t,k] + beta) - log(psi[t,k] + V*beta)
//                  + log(theta[t,k] + alpha[k]) + tau * Gumbel(seed, uid[t], k)
//
// tau = 1 is an exact categorical draw from the collapsed posterior (Eq. 1),
// tau = 0 the RT-LDA max (Eq. 2). psi is a [T, K] plane (psi_stride = K) or one
// [K] row shared by every token (psi_stride = 0).
//
// What bounds it: bytes. Each of the three [T, K] f32 planes is read once
// (3 * T * K * 4 B; 9.83 GB at T = 8192, K = 100,000) and only [T] int32 is
// written, at roughly one float operation per byte read plus an integer hash.
// What the design does about it: one 256-thread block per row, threads
// striding over k so that every warp load is 128 contiguous bytes of the row,
// each plane element touched once, the (best, index) pair kept in registers
// and reduced by warp shuffles and one shared-memory step. Nothing is written
// but the result. The gather of phi[w]/theta[d]/psi rows into the planes still
// happens outside, in PyTorch; fusing it in is the kernel's first redesign.
//
// Exactness: logf (never __logf), built with -fmad=false and without
// --use_fast_math, so the float ops round as in the plain PyTorch version
// (repro_torch/kernels/gibbs/ref.py). Ties go to the lowest k at every level;
// a NaN counts as the largest value, as in torch.argmax, so every row, even
// one that is all NaN, yields an index in [0, K).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_attributes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

// (v, i) beats (bv, bi): NaN is largest, ties go to the lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (isnan(v)) return !isnan(bv) || i < bi;
  if (isnan(bv)) return false;
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
gibbs_argmax_kernel(const float* __restrict__ phi, const float* __restrict__ psi,
                    long long psi_stride, const float* __restrict__ theta,
                    const float* __restrict__ alpha, const float* __restrict__ beta_p,
                    const long long* __restrict__ uid, uint32_t seed,
                    float vocab_f, float temperature, int K,
                    int* __restrict__ out) {
  const long long t = blockIdx.x;
  const float* phi_r = phi + t * K;
  const float* psi_r = psi + t * psi_stride;
  const float* theta_r = theta + t * K;
  const float beta = *beta_p;
  const float vb = vocab_f * beta;
  const bool noisy = temperature > 0.0f;
  const uint32_t h_tok =
      fmix32(fmix32(seed ^ kGolden) ^ ((uint32_t)uid[t] * kC1 + kGolden));

  // Within a thread k only grows, so a strict '>' keeps the lowest k of a tie.
  float best = -INFINITY;
  int best_k = 0;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float s = logf(phi_r[k] + beta) - logf(psi_r[k] + vb);
    s = s + logf(theta_r[k] + alpha[k]);
    if (noisy) {
      const uint32_t h = fmix32(h_tok ^ ((uint32_t)k * kC2 + kGolden));
      const float u = ((float)(h >> 8) + 0.5f) * (1.0f / 16777216.0f);
      const float g = -logf(-logf(u));
      s = s + temperature * g;
    }
    if (isnan(s) ? !isnan(best) : (!isnan(best) && s > best)) {
      best = s;
      best_k = k;
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_k, off);
    if (better(ov, oi, best, best_k)) {
      best = ov;
      best_k = oi;
    }
  }
  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = best_k;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? s_val[lane] : -INFINITY;
    best_k = lane < kThreads / 32 ? s_idx[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_k, off);
      if (better(ov, oi, best, best_k)) {
        best = ov;
        best_k = oi;
      }
    }
    if (lane == 0) out[t] = best_k;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gibbs_argmax_launch(const float* phi, const float* psi,
                                   long long psi_stride, const float* theta,
                                   const float* alpha, const float* beta,
                                   const long long* uid, unsigned int seed,
                                   float vocab_f, float temperature, int T, int K,
                                   int* out, void* stream) {
  if (T > 0) {
    gibbs_argmax_kernel<<<T, kThreads, 0, (cudaStream_t)stream>>>(
        phi, psi, psi_stride, theta, alpha, beta, uid, seed, vocab_f,
        temperature, K, out);
  }
  return (int)cudaGetLastError();
}

// Registers, shared memory, spills and blocks an SM of every kernel the launch
// function above can reach, at the block and dynamic shared memory it launches
// them with (kernel_attributes.cuh); i < 0 gives their number. Launches nothing.
extern "C" int gibbs_argmax_attributes(int i, const char** name, long long* out) {
  static const KernelEntry kAll[] = {
      {"gibbs_argmax_kernel", (const void*)gibbs_argmax_kernel, kThreads, 0, false}};
  return kernel_attributes(kAll, (int)(sizeof(kAll) / sizeof(kAll[0])), i, name, out);
}
