// Walker/Vose alias-table build for Hopper (sm_90a).
//
// Replaces the TPU kernel alias_build_pallas (src/repro/kernels/alias/
// kernel.py:125, body _alias_build_kernel at :61). For each row r it takes the
// mean-1 weights wn[r], the stable small/large order order[r] and the small
// count ns[r] (all from ops._prepare) and runs the K-step sweep: each step
// finalizes exactly one slot, pairing the next small (or a demoted large) with
// the active large. The result is prob[r] f32 and alias[r] int32 with
//   q(k) = (prob_k + sum_j (1 - prob_j) [alias_j = k]) / K = wn_k / K.
//
// What bounds it: bytes in principle (16 B per (row, k): wn and order read
// once, prob and alias written once; 52.4 GB, 15.6 ms for the full 32,768 x
// 100,000 word table at 3.35 TB/s), but the sweep is a chain of K dependent
// steps per row, each waiting on a load of order[] and then of wn[], so in
// practice the kernel is bound by the latency of that chain.
// What the design does about it: one thread per row with the six-scalar carry
// (i, j, cur, curw, pend, pendw) in registers and every finalized slot stored
// straight to global memory, no shared memory and no synchronization. Rows
// are independent, so the card overlaps the chains of many rows; the loads a
// step does not need (the branch-free Pallas body always reads both cursors)
// are skipped. One thread per row is the first thing to redesign.
//
// Exactness: the only float ops are clip(sw, 0, 1) and curw - (1 - sw), in the
// plain version's order (repro_torch/kernels/alias/ref.py), built with
// -fmad=false and no fast math; the clip propagates a NaN as torch.clamp does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

__global__ void __launch_bounds__(kThreads)
alias_build_kernel(const float* __restrict__ wn, const int* __restrict__ order,
                   const int* __restrict__ ns_p, int R, int K,
                   float* __restrict__ prob, int* __restrict__ alias) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const long long base = (long long)r * K;
  const float* w = wn + base;
  const int* o = order + base;
  float* p = prob + base;
  int* a = alias + base;
  const int ns = ns_p[r];

  int cur = -1;
  float curw = 0.0f;
  if (ns < K) {
    cur = o[ns];
    curw = w[cur];
  }
  int i = 0, j = 1, pend = -1;
  float pendw = 0.0f;
  for (int step = 0; step < K; ++step) {
    int s_slot = -1;
    float sw = 0.0f;
    if (pend >= 0) {
      s_slot = pend;
      sw = pendw;
    } else if (i < ns) {
      s_slot = o[i];
      sw = w[s_slot];
      ++i;
    }
    const bool use_small = s_slot >= 0 && cur >= 0;
    const int slot = s_slot >= 0 ? s_slot : cur;   // -1 when nothing remains
    if (slot >= 0) {
      p[slot] = use_small ? clip01(sw) : 1.0f;
      a[slot] = use_small ? cur : slot;
    }
    const float curw2 = use_small ? curw - (1.0f - sw) : curw;
    const bool demote = use_small && curw2 < 1.0f;
    const bool advance = demote || (s_slot < 0 && cur >= 0);
    pend = demote ? cur : -1;
    pendw = demote ? curw2 : 0.0f;
    if (advance) {
      const int nl = ns + j;
      if (nl < K) {
        cur = o[nl];
        curw = w[cur];
      } else {
        cur = -1;
        curw = 0.0f;
      }
      ++j;
    } else {
      curw = curw2;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int alias_build_launch(const float* wn, const int* order, const int* ns,
                                  int R, int K, float* prob, int* alias,
                                  void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    alias_build_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        wn, order, ns, R, K, prob, alias);
  }
  return (int)cudaGetLastError();
}
