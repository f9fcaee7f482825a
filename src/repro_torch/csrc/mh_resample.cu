// Alias-table Metropolis-Hastings probe (LightLDA) for Hopper (sm_90a).
//
// Replaces the TPU kernel mh_resample_pallas (src/repro/kernels/alias/
// kernel.py:249, body _mh_kernel at :154). Each token t runs n_mh MH steps
// from s = z[t]. Even steps propose from the document, q_d(k) ~ n_dk + alpha_k:
// with probability total/(total + sum alpha) a cumulative walk over the doc's
// sparse (topic, count) pair row, else a draw from the alpha alias table. Odd
// steps propose from the stale word alias table (wp, wa) with weights wq. A
// proposal t is accepted when u < p(t) q(s) / (p(s) q(t)), with the true
// collapsed posterior p(k) = (phi_wk - ex + b)(n_dk - ex + alpha_k) /
// (psi_k - ex + V b) on live counts, ex = [k == z[t]] (exact self-exclusion).
// The uniforms are uniform01(seed2, uid[t], 4 step + {0, 1, 2, 3}).
//
// What bounds it: bytes, as scattered gathers. Per token it reads its w, d,
// z, uid, its doc's pair row (cap slots of topic and count) and a handful of
// 4-byte table entries per step (phi, psi, alpha, wq, wp, wa, ap, aa), each
// in a 32-byte sector of its own; it writes one int32. The work per token is
// O(cap + n_mh), never O(K).
// What the design does about it: one thread per token, everything in
// registers, the pair row re-read from L1/L2 for each lookup; the wrapper
// sorts the tokens by word first, so neighbouring threads probe the same rows
// of phi, wq, wp and wa. Tables stay in global memory: the VMEM capacity
// limit of the Pallas version does not arise.
//
// Exactness: + - * / and compares only, in the plain version's order
// (repro_torch/kernels/alias/ref.py), built with -fmad=false, no fast math,
// IEEE division. Integer-valued float sums (the pair counts) are exact in any
// order. A padding token may give p <= 0 or NaN; every index it reads stays
// in range (jk = min(floor(u K), K - 1), topics from the pair row or the alias
// tables), and a NaN ratio rejects.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
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

// uniform01(seed2, uid, b) given h_tok = fmix32(fmix32(seed2 ^ G) ^ (uid C1 + G)).
__device__ __forceinline__ float uniform01(uint32_t h_tok, uint32_t b) {
  const uint32_t h = fmix32(h_tok ^ (b * kC2 + kGolden));
  return ((float)(h >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

struct DocRow {
  const int* topic;
  const int* count;
  int cap;

  // n_dk including the token itself (the raw stored pairs).
  __device__ __forceinline__ float lookup(int k) const {
    float s = 0.0f;
    for (int c = 0; c < cap; ++c) s = s + (topic[c] == k ? (float)count[c] : 0.0f);
    return s;
  }
};

__global__ void __launch_bounds__(kThreads)
mh_resample_kernel(const int* __restrict__ phi, const int* __restrict__ psi,
                   const int* __restrict__ doc_topic, const int* __restrict__ doc_count,
                   const float* __restrict__ wq, const float* __restrict__ wp,
                   const int* __restrict__ wa, const float* __restrict__ alpha,
                   const float* __restrict__ ap, const int* __restrict__ aa,
                   const int* __restrict__ w, const int* __restrict__ d,
                   const int* __restrict__ z, const long long* __restrict__ uid,
                   uint32_t seed2, const float* __restrict__ beta_p,
                   const float* __restrict__ asum_p, float vocab_f, int n_mh, int T,
                   int K, int cap, int* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const float beta = *beta_p;
  const float vb = vocab_f * beta;
  const float asum = *asum_p;
  const int z0 = z[t];
  const long long row = (long long)w[t] * K;
  const DocRow doc{doc_topic + (long long)d[t] * cap, doc_count + (long long)d[t] * cap,
                   cap};
  const uint32_t h_tok =
      fmix32(fmix32(seed2 ^ kGolden) ^ ((uint32_t)uid[t] * kC1 + kGolden));

  float total = 0.0f;
  for (int c = 0; c < cap; ++c) total = total + (float)doc.count[c];

  auto p_of = [&](int k) {
    const float ex = k == z0 ? 1.0f : 0.0f;
    const float ph = (float)phi[row + k] - ex;
    const float ps = (float)psi[k] - ex;
    const float th = doc.lookup(k) - ex;
    return (ph + beta) * (th + alpha[k]) / (ps + vb);
  };

  int s = z0;
  float p_s = p_of(s);
  for (int step = 0; step < n_mh; ++step) {
    const uint32_t b0 = 4u * (uint32_t)step;
    const float u_draw = uniform01(h_tok, b0 + 1u);
    const float u_coin = uniform01(h_tok, b0 + 2u);
    const int jk = min((int)(u_draw * (float)K), K - 1);
    int t_prop;
    float q_s, q_t;
    if ((step & 1) == 0) {
      // doc proposal: q_d(k) ~ n_dk + alpha_k
      const float u_mix = uniform01(h_tok, b0);
      const float r = u_draw * total;
      float cum = 0.0f;
      int t_cnt = s;
      for (int c = 0; c < cap; ++c) {
        const float cc = (float)doc.count[c];
        cum = cum + cc;
        const float prev = cum - cc;
        if (cum > r && prev <= r && cc > 0.0f) {
          t_cnt = doc.topic[c];
          break;   // the slots' [prev, cum) intervals are disjoint
        }
      }
      const int t_al = u_coin < ap[jk] ? jk : aa[jk];
      const bool use_counts = u_mix * (total + asum) < total;
      t_prop = use_counts ? t_cnt : t_al;
      q_s = doc.lookup(s) + alpha[s];
      q_t = doc.lookup(t_prop) + alpha[t_prop];
    } else {
      // word proposal: stale alias table, O(1) probes
      t_prop = u_coin < wp[row + jk] ? jk : wa[row + jk];
      q_s = wq[row + s];
      q_t = wq[row + t_prop];
    }
    const float u_acc = uniform01(h_tok, b0 + 3u);
    const float p_t = p_of(t_prop);
    const float ratio = (p_t * q_s) / (p_s * q_t);
    if (u_acc < ratio) {
      s = t_prop;
      p_s = p_t;
    }
  }
  out[t] = s;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mh_resample_launch(
    const int* phi, const int* psi, const int* doc_topic, const int* doc_count,
    const float* wq, const float* wp, const int* wa, const float* alpha,
    const float* ap, const int* aa, const int* w, const int* d, const int* z,
    const long long* uid, unsigned int seed2, const float* beta, const float* asum,
    float vocab_f, int n_mh, int T, int K, int cap, int* out, void* stream) {
  if (T > 0) {
    const int blocks = (T + kThreads - 1) / kThreads;
    mh_resample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        phi, psi, doc_topic, doc_count, wq, wp, wa, alpha, ap, aa, w, d, z, uid,
        seed2, beta, asum, vocab_f, n_mh, T, K, cap, out);
  }
  return (int)cudaGetLastError();
}
