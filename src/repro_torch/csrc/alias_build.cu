// Walker/Vose alias-table build for Hopper (sm_90a).
//
// Replaces the TPU kernel alias_build_pallas (src/repro/kernels/alias/
// kernel.py:125, body _alias_build_kernel at :61). For each row r it takes the
// raw weights w[r] and the mean-1 scale scale[r] (from ops._scale), forms
// wn = w * scale and runs the K-step Walker sweep: each step finalizes exactly
// one slot, pairing the next small slot (wn < 1, NaN included) or a demoted
// large with the active large. The result is prob[r] f32 and alias[r] int32
// with q(k) = (prob_k + sum_j (1 - prob_j) [alias_j = k]) / K = wn_k / K, bit
// for bit the plain version's (repro_torch/kernels/alias/ref.py on
// ops._prepare(w, scale)).
//
// What bounds it: bytes in principle (12 B per (row, k): the weights read
// once, prob and alias written once; 39.3 GB, 11.7 ms for the 32,768 x
// 100,000 word table at 3.35 TB/s; this design reads the weights twice, 16 B),
// but in practice the chain of K dependent steps per row: the carry (cur,
// curw, pend, pendw and the two cursors) cannot be split, so a row takes K
// times the latency of one step, and a warp's step is as slow as its slowest
// lane's.
//
// What the design does about it: every row of the table is in flight at once
// (one launch, one lane per row, 32 rows a warp), and the 32 lanes of a warp
// never wait on device memory nor take different branches inside a round:
// - The small cursor and the large cursor walk the row in index order; that
//   is the stable small/large partition of ops._prepare, so no order array,
//   no sort and no wn array exist on the card.
// - Phase 1 reads each row once, coalesced, and writes per kind one bit per
//   32-slot tile that holds a slot of that kind (scratch `bitmaps`). A cursor
//   jumps straight to its next tile of its kind, so a row with 20 larges in
//   100,000 slots never loads the tiles between them.
// - Each cursor sees a window of two tiles in shared memory (a 64-bit mask;
//   the next slot is an __ffsll and one shared load, read a step ahead). A
//   round is 32 steps, and a window holds more than a round takes, so the
//   windows slide only at the round ends, for all lanes together: the warp
//   copies each new tile as 128 coalesced bytes of one row (cp.async) and
//   classifies it with one __ballot_sync. A window that runs dry inside a
//   round (tiles with few slots of its kind) slides at once, with every
//   other window whose first tile is used up. The loop has one slide site,
//   so its code stays small, and a slide visits only its lanes' rows when
//   they are few (a dry window is usually one lane's).
// - The copy is waited for at once, but each cursor's next tile was fetched
//   into L2 when the window last slid, so the wait is on L2. Other warps of
//   the SM run meanwhile. Keeping the copy in flight for half a round
//   instead, in the same two tiles, was slower (one more slide site).
// - The steps are selects: a lane that consumes nothing this step moves no
//   cursor, with no branch.
// - Final slots are staged in shared memory, prob in place of the consumed
//   weight, and written back as coalesced 128-byte rows when their tile
//   leaves the window: a small slot's alias beside it (`stage_a`), a large
//   slot's not at all, since a demoted large aliases the next large in index
//   order and one finalized with prob 1 aliases itself. A large finalized
//   after its tile left the window (the active large, or the one demoted the
//   step before) is stored at once. Stores of one 4-byte word to each of 32
//   rows held 8 warps an SM at half speed on rows with many larges (the
//   rows of words with few tokens, where wn is near 1 in every slot).
// Shared memory is 26 KB a warp (two tiles per cursor with a 33-word pitch,
// so lanes at one slot hit 32 banks, and the small slots' alias staging), so
// 8 warps share an SM and the 1,024 warps of the word table run in one wave.
// A third tile per cursor, copied a round ahead, made each warp faster but
// took 42 KB and two waves.
//
// Exactness: the only float ops are w * scale, clip(sw, 0, 1) and
// curw - (1 - sw), in the plain version's order, built with -fmad=false and
// no fast math; the clip propagates a NaN as torch.clamp does. Row offsets are
// 64-bit (R * K reaches 3.3e9).
#include <cuda_runtime.h>

#include "kernel_attributes.cuh"

namespace {

constexpr int kRows = 32;          // rows a warp, one per lane; one warp a block
constexpr int kTile = 32;          // slots a cursor tile
constexpr int kPitch = kTile + 1;  // shared-memory row pitch: lanes at one slot hit 32 banks
constexpr unsigned kAll = 0xffffffffu;

// ---- cp.async helpers
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* gmem) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(gmem));
}
// ---- end cp.async helpers

__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// Bits of the slots of tile t that lie inside a row of K.
__device__ __forceinline__ unsigned valid_bits(int t, int K) {
  const long long n = (long long)K - (long long)t * kTile;
  return n >= kTile ? kAll : (n <= 0 ? 0u : (1u << n) - 1u);
}

// One lane's cursor over the slots of one kind (small or large) of its row: a
// window of two tiles, a and b, in shared memory, the tile after them (c)
// found, and the next untaken slot (`pos`, its weight `val`) read ahead.
struct Cursor {
  unsigned long long win;  // untaken slots of this kind: bits 0-31 tile a, 32-63 b
  int ta, tb, tc;          // the tiles, -1 for none
  int ba;                  // buffer of tile a; tile b's is ba ^ 1
  int wi;                  // bitmap word of the tile search
  unsigned wbits;          // tiles of word wi not yet handed out
  unsigned fa, fb;         // all slots of this kind in tiles a and b
  int k;                   // window bit of the next untaken slot, -1 when none
  int pos;                 // that slot, -1 when none remains
  float val;               // its weight w * scale
};

// The next tile whose bit is set in the bitmap `bits` (nw words), -1 if none.
__device__ __forceinline__ int next_tile(Cursor& c, const unsigned* bits, int nw) {
  while (c.wbits == 0u) {
    if (c.wi + 1 >= nw) return -1;
    c.wbits = __ldcg(bits + ++c.wi);
  }
  const int b = __ffs(c.wbits) - 1;
  c.wbits &= c.wbits - 1u;
  return c.wi * 32 + b;
}

// The warp starts the copy of tile t (-1: none) of one row `wr`, 32 weights,
// 128 B coalesced, into that row's buffer `dst`.
__device__ __forceinline__ void copy_tile(float* dst, const float* wr, int t, int K,
                                          int lane) {
  const long long pos = (long long)t * kTile + lane;
  if (t >= 0 && pos < K) cp_async4(dst + lane, wr + pos);
}

// The warp classifies tile t (-1: none) of one row, held in `src` with its
// scale `so`, and returns to all lanes the bits of the slots of `kind`
// (1 large, 0 small).
__device__ __forceinline__ unsigned classify(const float* src, float so, int t, int K,
                                             int kind, int lane) {
  const bool large = src[lane] * so >= 1.0f;
  const bool valid = t >= 0 && (long long)t * kTile + lane < K;
  return __ballot_sync(kAll, valid && (kind == 1 ? large : !large));
}

__global__ void __launch_bounds__(kRows)
alias_build_kernel(const float* __restrict__ w, const float* __restrict__ scale, int R,
                   int K, int nw, float* __restrict__ prob, int* __restrict__ alias,
                   unsigned* bitmaps) {
  // [kind: 0 small, 1 large][buffer][lane][slot]
  __shared__ float tiles[2][2][kRows][kPitch];
  // A consumed small slot's (prob, alias) is staged in place of its weight in
  // the small tile and beside it in `stage_a`, and written back 128 B of one
  // row at a time when its tile leaves the window.
  __shared__ int stage_a[2][kRows][kPitch];
  __shared__ int meta[6][kRows];
  __shared__ float row_scale[kRows];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, R - r0);

  // ---- phase 1, the warp on one row at a time, coalesced: per kind one bit
  // per tile that holds a slot of that kind
  for (int rl = 0; rl < rows; ++rl) {
    const float* wr = w + (long long)(r0 + rl) * K;
    const float sc = scale[r0 + rl];
    unsigned* bits = bitmaps + (long long)(r0 + rl) * 2 * nw;
    for (int u = 0; u < nw; u += 2) {
      float v[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const long long pos = ((long long)u * 32 + i) * kTile + lane;
        v[i] = pos < K ? __ldg(wr + pos) : 0.0f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned has_small = 0u, has_large = 0u;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int t = (u + h) * 32 + i;
          const unsigned valid = valid_bits(t, K);
          const unsigned large = __ballot_sync(kAll, (valid >> lane & 1u) &&
                                                         v[h * 32 + i] * sc >= 1.0f);
          has_small |= (unsigned)((valid & ~large) != 0u) << i;
          has_large |= (unsigned)(large != 0u) << i;
        }
        if (lane == 0 && u + h < nw) {
          bits[u + h] = has_small;
          bits[nw + u + h] = has_large;
        }
      }
    }
  }
  __threadfence_block();
  __syncwarp();

  // ---- phase 2: the sweep, one lane per row, all lanes in lock step
  const bool live = lane < rows;
  const int row = live ? r0 + lane : r0;
  const long long rb = (long long)row * K;
  const float sc = live ? scale[row] : 0.0f;
  const unsigned* bits_s = bitmaps + (long long)row * 2 * nw;
  const unsigned* bits_l = bits_s + nw;
  const int lnw = live ? nw : 0;
  Cursor s, l;   // the small and the large cursor
  int cur = -1, pend = -1;   // the active large and the demoted one, -1 for none
  row_scale[lane] = sc;
  __syncwarp();

  auto head = [&](Cursor& c, int kind) {
    const int k = __ffsll((long long)c.win) - 1;
    const bool in_a = k < 32;
    c.k = k;
    c.pos = k >= 0 ? (in_a ? c.ta : c.tb) * kTile + (k & 31) : -1;
    c.val = tiles[kind][c.ba ^ (in_a ? 0 : 1)][lane][k & 31] * sc;
  };
  // (each lane alone) Tile c, the next to be copied, is fetched into L2, so
  // that its copy waits on L2 rather than on device memory.
  auto ahead = [&](const Cursor& c) {
    if (c.tc >= 0) prefetch_l2(w + rb + (long long)c.tc * kTile);
  };
  // (each lane alone) Tile a is used up: b becomes a, c becomes b (its copy
  // goes to a's buffer), and the tile after it is found.
  auto slide = [&](Cursor& c, const unsigned* bits) {
    c.ta = c.tb;
    c.ba ^= 1;
    c.tb = c.tc;
    c.win >>= 32;
    c.k = c.k >= 32 ? c.k - 32 : c.k;   // the read-ahead slot moved from b to a
    c.tc = next_tile(c, bits, lnw);
    ahead(c);
  };
  // (the warp) body(o) for each lane o of `lanes`: a loop over all 32 rows,
  // unrolled, when many lanes take part, else over the set bits alone.
  auto for_rows = [&](unsigned lanes, auto&& body) {
    if (__popc(lanes) > 8) {
#pragma unroll 8
      for (int o = 0; o < kRows; ++o)
        if (lanes >> o & 1u) body(o);
    } else {
      for (unsigned m = lanes; m != 0u; m &= m - 1u) body(__ffs(m) - 1);
    }
  };
  // (the warp) Write back the staged small slots of tile a of each lane of
  // `lanes`, 128 B of one row at a time. The lanes' cursor fields go through
  // shared memory (`meta`), so the loops over the rows need no shuffles.
  auto flush = [&](unsigned lanes) {
    if (lanes >> lane & 1u) {
      meta[0][lane] = s.ta;
      meta[1][lane] = s.ba;
      meta[2][lane] = (int)s.fa;
    }
    __syncwarp();
    for_rows(lanes, [&](int o) {
      if ((unsigned)meta[2][o] >> lane & 1u) {
        const long long at = (long long)(r0 + o) * K + (long long)meta[0][o] * kTile + lane;
        prob[at] = tiles[0][meta[1][o]][o][lane];
        alias[at] = stage_a[meta[1][o]][o][lane];
      }
    });
    __syncwarp();
  };
  // (the warp) Write back the staged large slots of tile a of each lane of
  // `lanes`, 128 B of one row at a time: the larges taken, except the active
  // one and the one demoted last step. Their alias is not staged: a large
  // finalized with prob < 1 was demoted, and its alias is the large taken
  // after it, the next large in index order (in tile a, or the first of tile
  // b); one finalized with prob 1 aliases itself.
  auto flush_l = [&](unsigned lanes) {
    if (lanes >> lane & 1u) {
      unsigned done = l.fa & ~(unsigned)l.win;
      done &= cur >> 5 == l.ta ? ~(1u << (cur & 31)) : kAll;
      done &= pend >> 5 == l.ta ? ~(1u << (pend & 31)) : kAll;
      meta[0][lane] = l.ta;
      meta[1][lane] = l.ba;
      meta[2][lane] = (int)done;
      meta[3][lane] = (int)l.fa;
      meta[4][lane] = l.tb;
      meta[5][lane] = (int)l.fb;
    }
    __syncwarp();
    for_rows(lanes, [&](int o) {
      if ((unsigned)meta[2][o] >> lane & 1u) {
        const int j = meta[0][o] * kTile + lane;
        const unsigned above = (unsigned)meta[3][o] & ~((2u << lane) - 1u);
        const int next = above ? meta[0][o] * kTile + __ffs(above) - 1
                               : meta[4][o] * kTile + __ffs(meta[5][o]) - 1;
        const float p = tiles[1][meta[1][o]][o][lane];
        const long long at = (long long)(r0 + o) * K + j;
        prob[at] = p;
        alias[at] = p == 1.0f ? j : next;
      }
    });
    __syncwarp();
  };
  // (the warp) Copy tile b of each lane of `lanes` into its buffer.
  auto copy_b = [&](Cursor& c, int kind, unsigned lanes) {
    if (lanes >> lane & 1u) {
      meta[0][lane] = c.tb;
      meta[1][lane] = c.ba ^ 1;
    }
    __syncwarp();
    for_rows(lanes, [&](int o) {
      copy_tile(tiles[kind][meta[1][o]][o], w + (long long)(r0 + o) * K, meta[0][o], K, lane);
    });
    __syncwarp();
  };
  // (the warp) The slots of tile b of each lane of `lanes` join its window.
  auto classify_b = [&](Cursor& c, int kind, unsigned lanes) {
    if (lanes >> lane & 1u) {
      meta[0][lane] = c.tb;
      meta[1][lane] = c.ba ^ 1;
    }
    __syncwarp();
    unsigned mine = 0u;
    for_rows(lanes, [&](int o) {
      const unsigned got = classify(tiles[kind][meta[1][o]][o], row_scale[o], meta[0][o], K,
                                    kind, lane);
      mine = lane == o ? got : mine;
    });
    if (lanes >> lane & 1u) {
      c.win |= (unsigned long long)mine << 32;
      c.fb = mine;
    }
    __syncwarp();
  };
  // Slide the windows of the lanes of `ss` (small) and `sl` (large): a small
  // tile a is written back first, then the new tiles b are copied in and
  // classified.
  auto slide_all = [&](unsigned ss, unsigned sl) {
    flush(ss);
    flush_l(sl);
    if (ss >> lane & 1u) {
      slide(s, bits_s);
      s.fa = s.fb;
    }
    if (sl >> lane & 1u) {
      slide(l, bits_l);
      l.fa = l.fb;
    }
    copy_b(s, 0, ss);
    copy_b(l, 1, sl);
    cp_async_commit();
    cp_async_wait();
    __syncwarp();
    classify_b(s, 0, ss);
    classify_b(l, 1, sl);
  };

  // the first two tiles of each cursor, and the third found
  s.wi = l.wi = -1;
  s.wbits = l.wbits = 0u;
  s.ta = next_tile(s, bits_s, lnw);
  s.tb = next_tile(s, bits_s, lnw);
  s.tc = next_tile(s, bits_s, lnw);
  l.ta = next_tile(l, bits_l, lnw);
  l.tb = next_tile(l, bits_l, lnw);
  l.tc = next_tile(l, bits_l, lnw);
  s.ba = l.ba = 0;
  ahead(s);
  ahead(l);
  for (int o = 0; o < kRows; ++o) {
    const float* wo = w + (long long)(r0 + o) * K;
    copy_tile(tiles[0][0][o], wo, __shfl_sync(kAll, s.ta, o), K, lane);
    copy_tile(tiles[0][1][o], wo, __shfl_sync(kAll, s.tb, o), K, lane);
    copy_tile(tiles[1][0][o], wo, __shfl_sync(kAll, l.ta, o), K, lane);
    copy_tile(tiles[1][1][o], wo, __shfl_sync(kAll, l.tb, o), K, lane);
  }
  cp_async_commit();
  cp_async_wait();
  __syncwarp();
  s.win = l.win = 0ull;
  for (int o = 0; o < kRows; ++o) {
    const float so = __shfl_sync(kAll, sc, o);
    const unsigned ma = classify(tiles[0][0][o], so, __shfl_sync(kAll, s.ta, o), K, 0, lane);
    const unsigned mb = classify(tiles[0][1][o], so, __shfl_sync(kAll, s.tb, o), K, 0, lane);
    const unsigned la = classify(tiles[1][0][o], so, __shfl_sync(kAll, l.ta, o), K, 1, lane);
    const unsigned lb = classify(tiles[1][1][o], so, __shfl_sync(kAll, l.tb, o), K, 1, lane);
    if (lane == o) {
      s.win = ma | (unsigned long long)mb << 32;
      l.win = la | (unsigned long long)lb << 32;
      s.fa = ma;
      s.fb = mb;
      l.fa = la;
      l.fb = lb;
    }
  }
  head(s, 0);
  head(l, 1);

  // the first large is the active one
  cur = l.pos;
  float curw = cur >= 0 ? l.val : 0.0f;
  l.win = cur >= 0 ? l.win & (l.win - 1ull) : l.win;
  if (const unsigned d = __ballot_sync(kAll, l.win == 0ull && l.tc >= 0)) slide_all(0u, d);
  head(l, 1);
  float pendw = 0.0f;
  // The cursors are stepped by selects and read ahead every step; inside a
  // round the lanes part ways only where a slot's output goes (staged or
  // stored) and in the rare slide of a dry window.
  for (int step = 0; step < K; ++step) {
    const bool has_pend = pend >= 0;
    const bool has_small = s.pos >= 0;
    const int sk = s.k;   // window bit of this step's small
    const bool from_s = !has_pend && has_small;
    const int s_slot = has_pend ? pend : s.pos;   // -1 when no small remains
    const float sw = has_pend ? pendw : (has_small ? s.val : 0.0f);
    const bool use_small = s_slot >= 0 && cur >= 0;
    const int slot = s_slot >= 0 ? s_slot : cur;   // -1 when nothing remains
    const float pv = use_small ? clip01(sw) : 1.0f;
    const int av = use_small ? cur : slot;
    // a small slot is staged; a large one too, its prob alone, while its
    // tile is in the window, else stored at once
    if (from_s) {
      tiles[0][s.ba ^ (sk >> 5)][lane][sk & 31] = pv;
      stage_a[s.ba ^ (sk >> 5)][lane][sk & 31] = av;
    } else if (slot >= 0) {
      const int lt = slot >> 5;
      if (lt == l.ta || lt == l.tb) {
        tiles[1][l.ba ^ (lt == l.ta ? 0 : 1)][lane][slot & 31] = pv;
      } else {
        prob[rb + slot] = pv;
        alias[rb + slot] = av;
      }
    }
    // the small cursor moves on
    s.win = from_s ? s.win & (s.win - 1ull) : s.win;

    const float curw2 = use_small ? curw - (1.0f - sw) : curw;
    const bool demote = use_small && curw2 < 1.0f;
    const bool advance = demote || (s_slot < 0 && cur >= 0);
    pend = demote ? cur : -1;
    pendw = demote ? curw2 : 0.0f;
    const bool take_l = advance && l.pos >= 0;
    cur = advance ? l.pos : cur;
    curw = advance ? (l.pos >= 0 ? l.val : 0.0f) : curw2;
    l.win = take_l ? l.win & (l.win - 1ull) : l.win;

    // Every 32 steps, and at once when a window ran dry with tiles left, all
    // lanes together: slide each window whose tile a is used up (at most 32
    // slots are taken a round, and a window holds more). The loop has this
    // one slide site, so its code stays small.
    if (__any_sync(kAll, (s.win == 0ull && s.tc >= 0) || (l.win == 0ull && l.tc >= 0)) ||
        (step & 31) == 31) {
      slide_all(__ballot_sync(kAll, (unsigned)s.win == 0u && s.tb >= 0),
                __ballot_sync(kAll, (unsigned)l.win == 0u && l.tb >= 0));
    }
    // the next slots, read during the carry of the next step
    head(s, 0);
    head(l, 1);
  }
  // the slots still staged: tiles a and b of every row, of both kinds
  __syncwarp();
  flush(__ballot_sync(kAll, s.ta >= 0));
  flush_l(__ballot_sync(kAll, l.ta >= 0));
  if (s.tb >= 0) {
    s.ta = s.tb;
    s.fa = s.fb;
    s.ba ^= 1;
  }
  const unsigned moved = __ballot_sync(kAll, l.tb >= 0);
  if (l.tb >= 0) {
    l.ta = l.tb;
    l.fa = l.fb;
    l.win >>= 32;
    l.ba ^= 1;
  }
  flush(__ballot_sync(kAll, s.tb >= 0));
  flush_l(moved);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Scratch: `bitmaps` R * 2 * nw words, nw = ceil(K / 1024).
extern "C" int alias_build_launch(const float* w, const float* scale, int R, int K,
                                  int nw, float* prob, int* alias, unsigned* bitmaps,
                                  void* stream) {
  if (R > 0) {
    const int blocks = (R + kRows - 1) / kRows;
    alias_build_kernel<<<blocks, kRows, 0, (cudaStream_t)stream>>>(
        w, scale, R, K, nw, prob, alias, bitmaps);
  }
  return (int)cudaGetLastError();
}

// Registers, shared memory, spills and blocks an SM of every kernel the launch
// function above can reach, at the block and dynamic shared memory it launches
// them with (kernel_attributes.cuh); i < 0 gives their number. Launches nothing.
extern "C" int alias_build_attributes(int i, const char** name, long long* out) {
  static const KernelEntry kAll[] = {
      {"alias_build_kernel", (const void*)alias_build_kernel, kRows, 0, false}};
  return kernel_attributes(kAll, (int)(sizeof(kAll) / sizeof(kAll[0])), i, name, out);
}
