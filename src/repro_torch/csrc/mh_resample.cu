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
// O(cap + n_mh), never O(K). Scattered 4-byte reads reach the card's memory
// at a fraction of its streaming rate, so that rate, not the byte count,
// sets the pace (scripts/bag_mh_bench.py times a torch.take of as many
// scattered reads beside the kernel).
// What the design does about it: one thread per token; the wrapper sorts the
// tokens by word, so neighbouring threads probe the same rows of phi, wq, wp
// and wa. For caps up to a compile-time slot bound (16 or 32; the wrapper
// picks it) the pair row is loaded once, all its slots issued back to back,
// into registers; the lookups, the row total and the walk are then unrolled
// compare-selects over the slots, and the walk is a select with no break, so
// a warp does not diverge on it. Slots past cap hold topic -1 and count 0,
// which add 0.0 to an exact sum and never match. In each step the gathers
// known from the uniforms alone (wp[jk] and wq[s]; ap[jk], aa[jk] and
// alpha[s]) are issued together, then phi, psi, alpha (and wq) at the
// proposal, and the next step's uniforms are computed while they are in
// flight. wa[jk] is read only where the coin rejects wp[jk]: reading it
// always moves more scattered sectors and was slower. Longer rows take the
// generic kernel, which reads the row from memory for each lookup. Tables
// stay in global memory: the VMEM capacity limit of the Pallas version does
// not arise.
//
// Exactness: + - * / and compares only, in the plain version's order
// (repro_torch/kernels/alias/ref.py), built with -fmad=false, no fast math,
// IEEE division. Integer-valued float sums (the pair counts) are exact in any
// order. A padding token may give p <= 0 or NaN; every index it reads stays
// in range (jk = min(floor(u K), K - 1), topics from the pair row or the alias
// tables), and a NaN ratio rejects.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_attributes.cuh"

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

// The generic kernel: any cap, the pair row read from memory for each lookup.
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

// The pair row of one token in registers: kSlots slots, those past cap
// holding topic -1 and count 0.
template <int kSlots>
struct RegRow {
  int topic[kSlots];
  float count[kSlots];

  __device__ __forceinline__ void load(const int* __restrict__ tp,
                                       const int* __restrict__ ct, int cap) {
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      topic[c] = c < cap ? tp[c] : -1;
      count[c] = c < cap ? (float)ct[c] : 0.0f;
    }
  }

  // n_dk including the token itself (the raw stored pairs).
  __device__ __forceinline__ float lookup(int k) const {
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) s = s + (topic[c] == k ? count[c] : 0.0f);
    return s;
  }

  __device__ __forceinline__ float total() const {
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) s = s + count[c];
    return s;
  }

  // The topic of the first slot c with prev <= r < cum and count > 0, else
  // `none`: the generic kernel's walk, as selects over every slot.
  __device__ __forceinline__ int walk(float r, int none) const {
    float cum = 0.0f;
    int t = none;
    bool found = false;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const float cc = count[c];
      cum = cum + cc;
      const float prev = cum - cc;
      const bool hit = !found && cum > r && prev <= r && cc > 0.0f;
      t = hit ? topic[c] : t;
      found = found || hit;
    }
    return t;
  }
};

struct Uniforms {
  float mix, draw, coin, acc;
};

__device__ __forceinline__ Uniforms step_uniforms(uint32_t h_tok, int step) {
  const uint32_t b0 = 4u * (uint32_t)step;
  return Uniforms{uniform01(h_tok, b0), uniform01(h_tok, b0 + 1u),
                  uniform01(h_tok, b0 + 2u), uniform01(h_tok, b0 + 3u)};
}

// The same chain as mh_resample_kernel, with the token's pair row in
// registers (cap <= kSlots).
template <int kSlots>
__global__ void __launch_bounds__(kThreads)
mh_resample_kernel_regs(const int* __restrict__ phi, const int* __restrict__ psi,
                        const int* __restrict__ doc_topic,
                        const int* __restrict__ doc_count, const float* __restrict__ wq,
                        const float* __restrict__ wp, const int* __restrict__ wa,
                        const float* __restrict__ alpha, const float* __restrict__ ap,
                        const int* __restrict__ aa, const int* __restrict__ w,
                        const int* __restrict__ d, const int* __restrict__ z,
                        const long long* __restrict__ uid, uint32_t seed2,
                        const float* __restrict__ beta_p, const float* __restrict__ asum_p,
                        float vocab_f, int n_mh, int T, int K, int cap,
                        int* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int z0 = z[t];
  const long long row = (long long)w[t] * K;
  const long long drow = (long long)d[t] * cap;
  const uint32_t h_tok =
      fmix32(fmix32(seed2 ^ kGolden) ^ ((uint32_t)uid[t] * kC1 + kGolden));
  // the first p(s) needs phi, psi and alpha at z0: issue them with the row
  const int phi_z0 = phi[row + z0];
  const int psi_z0 = psi[z0];
  const float alpha_z0 = alpha[z0];
  RegRow<kSlots> doc;
  doc.load(doc_topic + drow, doc_count + drow, cap);
  const float beta = *beta_p;
  const float vb = vocab_f * beta;
  const float asum = *asum_p;
  const float total = doc.total();

  // p(k) from its gathered entries and n_dk = lookup(k)
  auto p_of = [&](int k, int phi_k, int psi_k, float alpha_k, float n_dk) {
    const float ex = k == z0 ? 1.0f : 0.0f;
    const float ph = (float)phi_k - ex;
    const float ps = (float)psi_k - ex;
    const float th = n_dk - ex;
    return (ph + beta) * (th + alpha_k) / (ps + vb);
  };

  int s = z0;
  float p_s = p_of(z0, phi_z0, psi_z0, alpha_z0, doc.lookup(z0));
  Uniforms u = step_uniforms(h_tok, 0);
  for (int step = 0; step < n_mh; ++step) {
    const int jk = min((int)(u.draw * (float)K), K - 1);
    int t_prop;
    float q_s, q_t, n_t, alpha_t;
    int phi_t, psi_t;
    Uniforms next;
    if ((step & 1) == 0) {
      // doc proposal: q_d(k) ~ n_dk + alpha_k
      const float ap_j = ap[jk];
      const int aa_j = aa[jk];
      const float alpha_s = alpha[s];
      const int t_cnt = doc.walk(u.draw * total, s);
      const bool use_counts = u.mix * (total + asum) < total;
      t_prop = use_counts ? t_cnt : (u.coin < ap_j ? jk : aa_j);
      alpha_t = alpha[t_prop];
      phi_t = phi[row + t_prop];
      psi_t = psi[t_prop];
      next = step_uniforms(h_tok, step + 1);
      n_t = doc.lookup(t_prop);
      q_s = doc.lookup(s) + alpha_s;
      q_t = n_t + alpha_t;
    } else {
      // word proposal: stale alias table, O(1) probes
      const float wp_j = wp[row + jk];
      q_s = wq[row + s];
      t_prop = u.coin < wp_j ? jk : wa[row + jk];
      q_t = wq[row + t_prop];
      alpha_t = alpha[t_prop];
      phi_t = phi[row + t_prop];
      psi_t = psi[t_prop];
      next = step_uniforms(h_tok, step + 1);
      n_t = doc.lookup(t_prop);
    }
    const float p_t = p_of(t_prop, phi_t, psi_t, alpha_t, n_t);
    const float ratio = (p_t * q_s) / (p_s * q_t);
    if (u.acc < ratio) {
      s = t_prop;
      p_s = p_t;
    }
    u = next;
  }
  out[t] = s;
}

}  // namespace

// slot_bound 0 runs the generic kernel; 16 or 32 the register kernel with
// that many slots, which needs cap <= slot_bound. Launches on `stream` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// slot bound the kernels do not take.
extern "C" int mh_resample_launch(
    const int* phi, const int* psi, const int* doc_topic, const int* doc_count,
    const float* wq, const float* wp, const int* wa, const float* alpha,
    const float* ap, const int* aa, const int* w, const int* d, const int* z,
    const long long* uid, unsigned int seed2, const float* beta, const float* asum,
    float vocab_f, int n_mh, int T, int K, int cap, int slot_bound, int* out,
    void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  if (slot_bound != 0 && ((slot_bound != 16 && slot_bound != 32) || cap > slot_bound)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (T + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
#define MH_ARGS                                                                        \
  phi, psi, doc_topic, doc_count, wq, wp, wa, alpha, ap, aa, w, d, z, uid, seed2, beta, \
      asum, vocab_f, n_mh, T, K, cap, out
  if (slot_bound == 16) {
    mh_resample_kernel_regs<16><<<blocks, kThreads, 0, s>>>(MH_ARGS);
  } else if (slot_bound == 32) {
    mh_resample_kernel_regs<32><<<blocks, kThreads, 0, s>>>(MH_ARGS);
  } else {
    mh_resample_kernel<<<blocks, kThreads, 0, s>>>(MH_ARGS);
  }
#undef MH_ARGS
  return (int)cudaGetLastError();
}

// Registers, shared memory, spills and blocks an SM of every kernel the launch
// function above can reach, at the block and dynamic shared memory it launches
// them with (kernel_attributes.cuh); i < 0 gives their number. Launches nothing.
extern "C" int mh_resample_attributes(int i, const char** name, long long* out) {
  static const KernelEntry kAll[] = {
      {"mh_resample_kernel_regs<16>", (const void*)mh_resample_kernel_regs<16>, kThreads, 0,
       false},
      {"mh_resample_kernel_regs<32>", (const void*)mh_resample_kernel_regs<32>, kThreads, 0,
       false},
      {"mh_resample_kernel", (const void*)mh_resample_kernel, kThreads, 0, false}};
  return kernel_attributes(kAll, (int)(sizeof(kAll) / sizeof(kAll[0])), i, name, out);
}
