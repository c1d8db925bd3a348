// Streaming scaled dot-product attention with an additive bias, bf16 route,
// for Hopper (sm_90a): every bf16 shape the attention operator takes that
// csrc/attention_bf16.cu does not.
//
//   out[b,h] = softmax(q[b,h] · k[b,h]^T / temperature + bias[h]) · v[b,h]
//
// q, k: [B, H, L, d_k]; v: [B, H, L, d_v]; out: [B, H, L, d_v], bfloat16
// views with a unit innermost stride and any other strides.  bias: [H, L, L]
// float32, contiguous, or null; broadcast over B.  Any L, d_k, d_v >= 1.
//
// Replaces the TPU kernel lstc_vad_tpu/ops/pallas_attention.py::_kernel
// (launched by _forward, entry pallas_sdpa) on bf16 inputs at the shapes the
// tiled bf16 kernel does not take: parts longer than 128 tokens, d_k != d_v,
// head widths that are not a multiple of 32 up to 256, strides off the
// 16-byte grid.  Its arithmetic is the tiled kernel's: exact bf16 products
// summed in f32, q·(1/temperature) rounded to bf16, the softmax in f32, P
// formed from the same values plain_sdpa normalises (exp(s - m) / l with
// each row's final max and sum) and rounded to bf16 before P·V, the output
// rounded to bf16.
//
// What bounds it on an H100 SXM.  It must read q, k, v and write out once,
// L·(2·d_k + 2·d_v)·2 bytes a (b, h) pair, and the bias once, against
// 2·L²·(d_k + d_v) FLOP; at 989 bf16 TFLOP/s over 3.35 TB/s (295 FLOP a byte
// against L/2) the bytes bound it up to L ~ 590 and the products past that.
// Past one key tile the statistics phase adds Q·K^T once more (a third of
// the products at d_k = d_v), and every key tile's K, V and bias come from
// L2 once for each work item: that L2-to-SM traffic is what holds it at L >=
// 257 (without any wgmma it still takes 65% of its time at L = 1024:
// scripts/torch_stream_ablation.py, NVIDIA H100 80GB HBM3, 700.00 W).
//
// Design, and what each part does about that bound:
// - Persistent blocks.  One block an SM (grid = min(work items, SMs)) walks
//   a queue of work items, item = pair · n_qt + query block, so that the
//   blocks at work at one moment read neighbouring query blocks of one (b,
//   h) pair and share its K and V in L2.  A block has one producer
//   warpgroup and two consumer warpgroups.
// - Two query tiles in ping-pong (d_v <= 256).  A work item is 128 query
//   rows; each consumer warpgroup takes 64 of them, with all of O's columns
//   (up to 128 f32 registers a thread), and both read the same K, V and
//   bias stages, so that each is brought from L2 once for 128 rows.  A pair
//   of named barriers gives the two warpgroups turns to issue wgmma: while
//   one's products run, the other's softmax runs (worth 11% at L = 49, ~0
//   past one key tile, where the traffic holds it).  A warpgroup whose 64 rows
//   all lie past L (an odd number of query tiles) computes on TMA's zero
//   fill and stores nothing, so both take the same turns.
// - Pipelined products in a warpgroup.  In the statistics phase S of key
//   tile j+1 is issued before the running max and sum of tile j are taken.
//   In the second phase round j issues S(j) and then O += P(j-1)·V(j-1),
//   waits for S(j) alone (wgmma.wait_group 1), forms P(j) in f32 registers
//   while P·V runs, then waits for P·V and packs P(j) into the A fragment.
//   No instruction but a wgmma touches a wgmma's registers while one is
//   in flight: phase 1 reads S only after its own wait, phase 0 copies
//   S(j) out of its accumulators before S(j+1) is issued, P is packed
//   after the wait, and each accumulator's zero-init is pinned before the
//   first wgmma by fence_operand (csrc/hopper.cuh).  Otherwise ptxas
//   serializes every wgmma of the kernel (C7513-C7515): it did, at each of
//   four such places.
// - The softmax, and why two phases past one key tile.  With one key tile
//   (L <= 64) the kernel computes S, the row max and sum, P and P·V in one
//   pass.  With more, phase 0 walks the key tiles for S alone (no V
//   traffic) and keeps each row's running max m and sum l (l rescaled when
//   the max grows); phase 1 walks them again, recomputes S and forms P =
//   exp(s - m) / l as plain_sdpa does before rounding it to bf16.  A
//   one-pass online softmax (exp(s - m) rounded unnormalised, O rescaled,
//   divided by l at the end) came out 1.14x plain_sdpa's distance from
//   float64 at one shape of the card tests (L = 129, d_k 48, d_v 24), past
//   the 1.05 bar, because it rounds other values than plain_sdpa
//   (tests/test_torch_stream_numerics.py).
// - Softmax arithmetic.  exp(s - m) is ex2.approx of fma(s, log2 e,
//   -m·log2 e), and P multiplies by one reciprocal of l a row, where the
//   first design took expf and an IEEE division for every probability:
//   rehearsed on the CPU (tests/test_torch_stream_numerics.py, order
//   ``two_phase_exp2``) and held on the card to the unchanged bars.
// - Past d_v 256 (config B's 384) a warpgroup cannot hold 64 rows of O,
//   so both take the same 64 rows, each half of O's columns (up to 192),
//   and S is computed once: consumer warpgroup 0 computes S, the softmax
//   and P, keeps P in registers for its own P·V and writes it (bf16, 8 KB,
//   in the swizzled layout wgmma reads) into one of two slots of shared
//   memory, from which warpgroup 1 takes its P·V (full and empty mbarriers
//   a slot).
//   Past 384 columns O is walked in passes of 384 (S recomputed a pass, the
//   statistics kept from the first).
// - TMA.  Q, K and V arrive by cp.async.bulk.tensor in boxes of 64 rows x
//   64 columns (128 bytes a row, 128-byte swizzle), from 4-D tensor maps
//   (d, L, H, B) over the views' own strides, so the encoder's strided
//   views of [B, L, H, d] buffers are read in place; rows past L and
//   columns past d are zero-filled by the hardware.  q, k and v come only
//   by TMA: the wrapper first copies a view whose base or strides are off
//   the 16-byte grid into a padded buffer (ops/cuda_attention.py::_padded).
// - The bias by bulk copy.  Where L·4 bytes is a multiple of 16 (and the
//   base 16-byte aligned) the bias tile [rows x 64 keys] f32 comes by TMA
//   in two boxes of 32 keys (128 bytes a row, 128-byte swizzle) from a map
//   over the contiguous [H, L, L] tensor (its batch dimension of size 1),
//   on the stage's `full` barrier like K and V, with an L2 evict_last
//   policy (the bias is read again for every batch row and both phases;
//   Q goes evict_first); the consumers' float2 reads of the swizzled rows
//   are free of bank conflicts.  Elsewhere (odd L, as 129, 257 and 49)
//   each producer thread copies one row with one cp.async.bulk of the
//   16-byte chunks that hold its keys (its bytes counted on the same
//   barrier by mbarrier.expect_tx), read at that row's own offset: 1.26x
//   TMA's time where both apply (L = 1024: 3.32 against 2.63 ms).  The
//   first design copied the bias 4 bytes at a time: 35-38% of its time
//   (scripts/torch_stream_ablation.py, NVIDIA H100 80GB HBM3, 700.00 W).
// - Rings.  K, V and the bias have rings of their own, 1-2 stages each, with
//   `full` (the producer's copies have landed) and `empty` (every consumer
//   thread is done with it) mbarriers, so that the statistics phase brings
//   no V and a stage is released as soon as its reader is done: K once S
//   has completed, the bias once it is added, V once P·V has completed.  Q
//   is resident for the work item (scaled by 1/temperature in place, rounded
//   to bf16) where shared memory holds it; past that (d_k beyond ~768 at d_v
//   256) it is streamed in chunks of d_k beside K and scaled where it lands.
//   At d_k = d_v = 256 with a bias the layout is Q 64 KB, two K and two V
//   stages of 32 KB, one bias stage of 34 KB (128 rows of 272 bytes, what
//   a row copy needs): 226 KB.
// - The producers hand their registers to the consumers (setmaxnreg: 56
//   and 224).  One producer warp walks the key-tile visits in one flat loop
//   and its lane 0 issues every TMA copy; where the bias comes by rows,
//   every producer thread copies one.
// - The launch geometry is computed by one function, `plan`, which the
//   launcher and lstc_attention_stream_bf16_plan (ops/cuda_attention.py::
//   stream_plan) both call; tests/bf16_stream_plan.py mirrors it.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns a
// cudaError_t (0 = launched).  ops/cuda_attention.py routes each shape
// (ops/cuda_attention.py::route) and says which tensors TMA may read.

#include <math.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;         // query rows of a consumer warpgroup
constexpr int kKeys = 64;         // keys of a tile
constexpr int kBars = 18 * 8;     // the barriers
constexpr unsigned kVecQ = 1, kVecK = 2, kVecV = 4;
constexpr float kLog2e = 1.4426950408889634f;
// named barriers: 1 + wg each consumer warpgroup's own (hopper.cuh
// wg_sync), kTurn + wg consumer warpgroup wg's turn to issue wgmma
constexpr int kTurn = 3;
// a bias row copied whole where TMA cannot take the bias: the 16-byte
// chunks that hold 64 keys, at most 17
constexpr int kBiasPitch = 17 * 16;

struct Strides {  // in elements: batch, head and row stride of each tensor
  long long q[3], k[3], v[3], o[3];
};

struct Params {
  const __nv_bfloat16 *q, *k, *v;
  const float* bias;
  __nv_bfloat16* out;
  Strides str;
  int H, L, dk, dv;
  int n_tiles;      // key tiles
  int stats_phase;  // 1: phase 0 (statistics) before phase 1
  int item_rows;    // query rows of a work item: 128 (two tiles) or 64
  int n_qt;         // work items of a (b, h) pair
  int n_items;      // B·H·n_qt
  int bias_tma;     // 1: the bias by TMA; 0: a bulk copy a row
  int k_stages, v_stages, b_stages;  // 1 or 2 each
  int chunk_boxes;  // 64-column boxes of d_k a K stage holds
  int n_chunks;     // K stages a key tile's Q·K^T takes; 1 = Q resident
  int v_boxes;      // 64-column boxes of V a pass
  int n_passes;     // of v_boxes·64 output columns
  int k_stage, v_stage, b_stage;  // bytes of a stage of each ring
  int k_off, v_off, b_off, p_off, bar_off;
  float inv_temp;
};

// the barriers: full and empty of Q, of each stage of the K, V and bias
// rings, and of each of the two P slots (column split)
struct Bars {
  uint32_t base;
  __device__ uint32_t q_full() const { return base; }
  __device__ uint32_t q_empty() const { return base + 8; }
  __device__ uint32_t k_full(int s) const { return base + 8 * (2 + s); }
  __device__ uint32_t k_empty(int s) const { return base + 8 * (4 + s); }
  __device__ uint32_t v_full(int s) const { return base + 8 * (6 + s); }
  __device__ uint32_t v_empty(int s) const { return base + 8 * (8 + s); }
  __device__ uint32_t b_full(int s) const { return base + 8 * (10 + s); }
  __device__ uint32_t b_empty(int s) const { return base + 8 * (12 + s); }
  __device__ uint32_t p_full(int s) const { return base + 8 * (14 + s); }
  __device__ uint32_t p_empty(int s) const { return base + 8 * (16 + s); }
};

// the stage and the parity of ring item `it` in a ring of 1 or 2 stages
__device__ __forceinline__ int stage_of(int it, int stages) {
  return stages == 1 ? 0 : it & 1;
}
__device__ __forceinline__ int parity_of(int it, int stages) {
  return (stages == 1 ? it : it >> 1) & 1;
}

// ------------------------------------------------------------ primitives

// the bias tile's element (row r, key c) in shared memory: two boxes of 32
// keys x BR rows, 128 bytes a row, row r's 16-byte chunk j at chunk
// j ^ (r % 8) (the layout TMA writes with the 128-byte swizzle)
template <int BR>
__device__ __forceinline__ int bias_at(int r, int c) {
  return (c >> 5) * (BR * 128) + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
         (c & 3) * 4;
}

// q·(1/temperature) rounded to bf16, in place, by a warpgroup's threads
__device__ __forceinline__ void scale_q(char* base, int bytes, int tid,
                                        float inv_temp) {
  for (int off = tid * 16; off < bytes; off += kWG * 16) {
    uint4 w = *reinterpret_cast<uint4*>(base + off);
    w.x = scale_bf16(w.x, inv_temp);
    w.y = scale_bf16(w.y, inv_temp);
    w.z = scale_bf16(w.z, inv_temp);
    w.w = scale_bf16(w.w, inv_temp);
    *reinterpret_cast<uint4*>(base + off) = w;
  }
}

// ------------------------------------------------------------- producer

// the L2 policies of the loads: the bias, read again for every batch row
// and both phases, is kept; Q, read once an item, goes first
__device__ __forceinline__ uint64_t bias_policy() { return l2_evict_last(); }
__device__ __forceinline__ uint64_t q_policy() { return l2_evict_first(); }

// the bias tile [BR rows x 64 keys] where L·4 bytes is not a multiple of
// 16: row r (producer thread r) by one bulk copy of the 16-byte chunks that
// hold its keys, to r·kBiasPitch of the stage at shared address `dst`; its
// key c lands at float a_r + c, a_r the first key's float in its chunk.
// The chunks' other floats (neighbouring keys and rows) are not read, and a
// chunk that holds a byte of the tensor lies in a page of the tensor's own.
// Rows past L are not copied.
template <int BR>
__device__ __forceinline__ void copy_bias_row(uint32_t dst, const Params& p,
                                              int h, int q0, int key0, int r,
                                              uint32_t full) {
  if (r >= BR || q0 + r >= p.L) return;
  const float* const first =
      p.bias + (static_cast<long long>(h) * p.L + q0 + r) * p.L + key0;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(first) & ~uintptr_t{15};
  const uintptr_t hi =
      (reinterpret_cast<uintptr_t>(first + min(kKeys, p.L - key0)) + 15) &
      ~uintptr_t{15};
  const int bytes = static_cast<int>(hi - lo);
  mbar_expect_tx(full, bytes);
  bulk_load_hint(dst + r * kBiasPitch, reinterpret_cast<const void*>(lo),
                 bytes, full, bias_policy());
}

// the producer warpgroup: Q of each work item, then its key-tile visits in
// the order the consumers make them (the statistics phase's tiles, then
// phase 1's of each pass): K (in chunks of d_k, with Q's chunk where Q is
// streamed), the bias and (phase 1) V.  The lead thread (LEAD) issues every
// TMA copy from its lane 0; where the bias comes a row at a time every
// producer thread copies its row and arrives (the other warps, !LEAD, only
// that).  The lead warp walks the items in step, so that its loop state is
// warp-uniform, and one flat loop over the visits keeps it within 56
// registers.
template <int SPLIT, bool LEAD>
__device__ __forceinline__ void produce(const Params& p, char* smem,
                                        const CUtensorMap& tq,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        const CUtensorMap& tb, int pt) {
  constexpr int BR = SPLIT ? kRows : 2 * kRows;  // query rows of an item
  const uint32_t sm = smem_u32(smem);
  const Bars bars{sm + p.bar_off};
  const int stats = p.stats_phase ? p.n_tiles : 0;
  const int visits = stats + p.n_passes * p.n_tiles;
  int kit = 0, vit = 0, bit = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int pair = item / p.n_qt;
    const int q0 = (item % p.n_qt) * BR;
    const int b = pair / p.H, h = pair % p.H;
    if (LEAD && p.n_chunks == 1) {
      // Q resident: once the block's previous item has read its own
      const int n_item = (item - static_cast<int>(blockIdx.x)) /
                         static_cast<int>(gridDim.x);
      if (n_item > 0) mbar_wait(bars.q_empty(), (n_item - 1) & 1);
      if (pt == 0) {
      mbar_arrive_tx(bars.q_full(), BR / kRows * p.chunk_boxes * kBoxBytes);
      for (int w = 0; w < BR / kRows; ++w)
#pragma unroll 1
        for (int x = 0; x < p.chunk_boxes; ++x)
          tma_box_hint(sm + (w * p.chunk_boxes + x) * kBoxBytes, &tq,
                       bars.q_full(), 64 * x, q0 + kRows * w, h, b,
                       q_policy());
      }
    }
    for (int visit = 0; visit < visits; ++visit) {
      const int key0 = (visit < stats ? visit : (visit - stats) % p.n_tiles) *
                       kKeys;
      if (LEAD)
#pragma unroll 1
        for (int c = 0; c < p.n_chunks; ++c, ++kit) {
          const int s = stage_of(kit, p.k_stages);
          if (kit >= p.k_stages)
            mbar_wait(bars.k_empty(s),
                      parity_of(kit - p.k_stages, p.k_stages));
          const uint32_t st = sm + p.k_off + s * p.k_stage;
          const int cb = p.chunk_boxes;
          const bool streamed = p.n_chunks > 1;
          if (pt != 0) continue;
          mbar_arrive_tx(bars.k_full(s), (1 + streamed) * cb * kBoxBytes);
#pragma unroll 1
          for (int x = 0; x < cb; ++x) {
            tma_box(st + x * kBoxBytes, &tk, bars.k_full(s),
                    (c * cb + x) * 64, key0, h, b);
            if (streamed)
              tma_box(st + (cb + x) * kBoxBytes, &tq, bars.k_full(s),
                      (c * cb + x) * 64, q0, h, b);
          }
        }
      if (p.bias) {
        const int s = stage_of(bit, p.b_stages);
        if (bit >= p.b_stages)
          mbar_wait(bars.b_empty(s), parity_of(bit - p.b_stages, p.b_stages));
        const uint32_t st = sm + p.b_off + s * p.b_stage;
        if (!p.bias_tma) {
          copy_bias_row<BR>(st, p, h, q0, key0, pt, bars.b_full(s));
          mbar_arrive(bars.b_full(s));
        } else if (LEAD && pt == 0) {
          mbar_arrive_tx(bars.b_full(s), 2 * BR * 128);
          for (int x = 0; x < 2; ++x)
            tma_box_hint(st + x * BR * 128, &tb, bars.b_full(s),
                         key0 + 32 * x, q0, h, 0, bias_policy());
        }
        ++bit;
      }
      if (LEAD && visit >= stats) {  // phase 1: V of the pass's columns
        const int s = stage_of(vit, p.v_stages);
        if (vit >= p.v_stages)
          mbar_wait(bars.v_empty(s), parity_of(vit - p.v_stages, p.v_stages));
        const uint32_t st = sm + p.v_off + s * p.v_stage;
        const int vcol = (visit - stats) / p.n_tiles * p.v_boxes * 64;
        if (pt == 0) {
          mbar_arrive_tx(bars.v_full(s), p.v_boxes * kBoxBytes);
#pragma unroll 1
          for (int x = 0; x < p.v_boxes; ++x)
            tma_box(st + x * kBoxBytes, &tv, bars.v_full(s), vcol + 64 * x,
                    key0, h, b);
        }
        ++vit;
      }
    }
  }
}

// -------------------------------------------------------------- softmax

// e^(x - base) as the kernel computes it: 2^(x·log2 e - base·log2 e) by
// ex2.approx, bl = base·log2 e
__device__ __forceinline__ float exp_at(float x, float base, float bl) {
  return ex2(fmaf(x, kLog2e, -bl));
}

// a thread's view of its two rows (r0 and r0 + 8 of a warpgroup's 64): the
// running max m and sum l, and, once they are final, the offsets and the
// reciprocal (or the sum itself) that form P
struct Rows {
  float m[2], l[2], base[2], bl[2], rl[2];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
  }

  // S of one key tile plus its bias (keys past L at -inf) folded into m,
  // l; accumulator i is row r0 + 8·((i/2)%2).  The sums go to registers of
  // their own: an accumulator is only ever written by wgmma (and zeroed
  // before the first), so that ptxas never finds another instruction
  // writing one while a wgmma is in flight (which serializes every wgmma
  // of the kernel, C7515)
  template <class Bias>
  __device__ __forceinline__ void fold(const float (&s)[32], const Bias& bias) {
    // s + bias is formed twice (for the max, then for the sum) rather than
    // kept: 32 registers fewer beside O
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 b = bias.at(i);
      mx[(i >> 1) & 1] =
          fmaxf(mx[(i >> 1) & 1], fmaxf(s[i] + b.x, s[i + 1] + b.y));
    }
    float bs[2], bls[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      bs[r] = m_new == -INFINITY ? 0.f : m_new;
      bls[r] = bs[r] * kLog2e;
      l[r] *= exp_at(m[r], bs[r], bls[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 b = bias.at(i);
      const int r = (i >> 1) & 1;
      sum[r] += exp_at(s[i] + b.x, bs[r], bls[r]) +
                exp_at(s[i + 1] + b.y, bs[r], bls[r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] += quad_sum(sum[r]);
  }

  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      base[r] = m[r] == -INFINITY ? 0.f : m[r];
      bl[r] = base[r] * kLog2e;
      rl[r] = 1.f / l[r];
    }
  }

  __device__ __forceinline__ float prob(float x, int r) const {
    return exp_at(x, base[r], bl[r]) * rl[r];
  }

  // P of S plus its bias in f32, in the accumulators' order
  template <class Bias>
  __device__ __forceinline__ void probs(const float (&s)[32], const Bias& bias,
                                        float (&e)[32]) const {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 b = bias.at(i);
      e[i] = prob(s[i] + b.x, (i >> 1) & 1);
      e[i + 1] = prob(s[i + 1] + b.y, (i >> 1) & 1);
    }
  }

  // P of S plus its bias as bf16 pairs: pa[kk] is the A fragment of
  // 16-key step kk (an accumulator quad of two 8-key column blocks)
  template <class Bias>
  __device__ __forceinline__ void probs(const float (&s)[32], const Bias& bias,
                                        uint32_t (&pa)[4][4]) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 8 * kk + 2 * x, r = x & 1;
        const float2 b = bias.at(i);
        pa[kk][x] = pack_bf16(prob(s[i] + b.x, r), prob(s[i + 1] + b.y, r));
      }
  }
};

// the bias of this thread's scores in a key tile: at(i) is what the pair
// of accumulators i, i+1 (rows rb0 + 8·((i/2)%2) of the item's BR, keys
// 8·(i/4) + 2t, + 1) takes: from the TMA layout (MODE 1, bias_at), from
// the bulk-copied rows (MODE 2, row x's key c at float ra[x] + c) or
// nothing (MODE 0); -inf at keys past L (EDGE: the tile runs past L)
template <bool EDGE, int MODE, int BR>
struct BiasView {
  const char* bt;
  int rb0, ra0, ra1, t, key0, L;

  __device__ __forceinline__ float2 at(int i) const {
    const int x = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * t;
    float2 b = make_float2(0.f, 0.f);
    if constexpr (MODE == 2) {
      const float* const f =
          reinterpret_cast<const float*>(bt) + (x ? ra1 : ra0) + col;
      b = make_float2(f[0], f[1]);
    } else if constexpr (MODE == 1) {
      b = *reinterpret_cast<const float2*>(bt + bias_at<BR>(rb0 + 8 * x, col));
    }
    if constexpr (EDGE) {
      if (key0 + col >= L) b.x = -INFINITY;
      if (key0 + col + 1 >= L) b.y = -INFINITY;
    }
    return b;
  }
};

// the float offsets ra of this thread's two bias rows (item rows rb0 and
// rb0 + 8, rows row0 + rb0 and + 8 of head h) in the bulk-copied layout
__device__ __forceinline__ void bias_rows(const Params& p, int h, int row0,
                                          int rb0, int (&ra)[2]) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int rb = rb0 + 8 * x;
    const float* const first =
        p.bias + (static_cast<long long>(h) * p.L + row0 + rb) * p.L;
    ra[x] = rb * (kBiasPitch / 4) +
            static_cast<int>((reinterpret_cast<uintptr_t>(first) >> 2) & 3);
  }
}

// ---------------------------------------------------- consumer warpgroups

// O's rows row0 + (r0, r0 + 8) and columns col0 + 64 nb + (8 i/4 + 2t, +1),
// rounded to bf16; nothing past L rows or d_v columns
template <int NB>
__device__ __forceinline__ void store_o(const Params& p, const float (&o)[NB][32],
                                        int b, int h, int row0, int col0,
                                        int r0, int t) {
  __nv_bfloat16* const out = p.out + b * p.str.o[0] + h * p.str.o[1];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = row0 + r0 + ((i & 2) << 2);
      const int col = col0 + 64 * nb + 8 * (i >> 2) + 2 * t;
      if (row >= p.L || col >= p.dv) continue;
      __nv_bfloat16* const dst = out + row * p.str.o[2] + col;
      const float x0 = o[nb][i], x1 = o[nb][i + 1];
      if (col + 1 < p.dv && !(p.dv & 1)) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        if (col + 1 < p.dv) dst[1] = __float2bfloat16_rn(x1);
      }
    }
}

// f(view of key tile `bit`'s bias): the stage waited for before and
// released after; the consumers' part of every key tile's softmax
template <int BR, class F>
__device__ __forceinline__ void with_bias(const Params& p, char* smem,
                                          Bars bars, int bit, int key0,
                                          int rb0, const int (&ra)[2], int t,
                                          F&& f) {
  const bool edge = key0 + kKeys > p.L;
  // offsets recomputed each tile rather than hoisted and held beside O
  rb0 = static_cast<int>(opaque(rb0));
  t = static_cast<int>(opaque(t));
  const int ra_[2] = {static_cast<int>(opaque(ra[0])),
                      static_cast<int>(opaque(ra[1]))};
  if (!p.bias) {
    if (edge)
      f(BiasView<true, 0, BR>{nullptr, rb0, ra_[0], ra_[1], t, key0, p.L});
    else
      f(BiasView<false, 0, BR>{nullptr, rb0, ra_[0], ra_[1], t, key0, p.L});
    return;
  }
  const int bs = stage_of(bit, p.b_stages);
  mbar_wait(bars.b_full(bs), parity_of(bit, p.b_stages));
  const char* const bt = smem + p.b_off + bs * p.b_stage;
  if (p.bias_tma) {
    if (edge)
      f(BiasView<true, 1, BR>{bt, rb0, ra_[0], ra_[1], t, key0, p.L});
    else
      f(BiasView<false, 1, BR>{bt, rb0, ra_[0], ra_[1], t, key0, p.L});
  } else {
    if (edge)
      f(BiasView<true, 2, BR>{bt, rb0, ra_[0], ra_[1], t, key0, p.L});
    else
      f(BiasView<false, 2, BR>{bt, rb0, ra_[0], ra_[1], t, key0, p.L});
  }
  mbar_arrive(bars.b_empty(bs));
}

// two 64-row query tiles of one (b, h) pair, one a consumer warpgroup, in
// ping-pong; d_v <= 64·NB <= 256, Q resident
template <int NB>
__device__ __forceinline__ void consume_pair(const Params& p, char* smem,
                                             int wg, int tid) {
  const Bars bars{smem_u32(smem) + p.bar_off};
  const int n = p.n_tiles, kb = p.chunk_boxes;
  const int KS = p.k_stages, VS = p.v_stages;
  const int warp = tid / 32, lane = tid % 32, t = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);  // rows r0 and r0 + 8 of the tile
  char* const my_q = smem + wg * kb * kBoxBytes;
  const uint32_t qa = smem_u32(my_q);

  // this warpgroup's turn to issue wgmma, and the other's after it
  auto turn_wait = [&] { named_sync(kTurn + wg, 2 * kWG); };
  auto turn_pass = [&] { named_arrive(kTurn + 1 - wg, 2 * kWG); };
  // S = Q·K^T of K stage ks (no commit)
  auto s_mma = [&](float(&s)[32], int ks) {
    const uint32_t ka = smem_u32(smem + p.k_off + ks * p.k_stage);
    for (int x = 0; x < kb; ++x)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_ss(s, desc(qa + x * kBoxBytes + 32 * j, 16, 1024),
                 desc(ka + x * kBoxBytes + 32 * j, 16, 1024), x > 0 || j > 0);
  };
  // O += P·V of V stage vs (no commit)
  auto pv_mma = [&](float(&o)[NB][32], const uint32_t(&pa)[4][4], int vs) {
    const uint32_t va = smem_u32(smem + p.v_off + vs * p.v_stage);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_rs(o[nb], pa[kk],
                 desc(va + nb * kBoxBytes + kk * 2048, kBoxBytes, 1024));
  };

  if (wg == 1) turn_pass();  // consumer warpgroup 0 issues first
  int kit = 0, vit = 0, bit = 0, n_item = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++n_item) {
    const bool last_item = item >= p.n_items - static_cast<int>(gridDim.x);
    const int pair = item / p.n_qt;
    const int q0 = (item % p.n_qt) * 2 * kRows + wg * kRows;  // this tile's
    const int b = pair / p.H, h = pair % p.H;
    int ra[2] = {0, 0};
    if (p.bias && !p.bias_tma)
      bias_rows(p, h, q0 - wg * kRows, wg * kRows + r0, ra);
    mbar_wait(bars.q_full(), n_item & 1);
    scale_q(my_q, kb * kBoxBytes, tid, p.inv_temp);
    fence_async_smem();
    wg_sync(wg);

    Rows rows;
    rows.reset();
    if (p.stats_phase) {
      // phase 0: S(j + 1) issued before the statistics of S(j) are taken
      // and waited for after them.  S(j) is copied out of the accumulators
      // first, once no wgmma is in flight, so that nothing but a wgmma
      // touches them while one is (ptxas serializes every wgmma of the
      // kernel where another instruction reads or writes them then: C7514,
      // C7515); the last tile is peeled, so that no wgmma sits under a
      // branch
      float acc[32], x[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      fence_operand(acc);
      auto issue = [&](int kn) {
        mbar_wait(bars.k_full(stage_of(kn, KS)), parity_of(kn, KS));
        turn_wait();
        wgmma_fence();
        s_mma(acc, stage_of(kn, KS));
        wgmma_commit();
        turn_pass();
      };
      auto take = [&](int j) {  // S(j) out of the accumulators
        wgmma_wait<0>();
        mbar_arrive(bars.k_empty(stage_of(kit + j, KS)));
        fence_operand(acc);
#pragma unroll
        for (int i = 0; i < 32; ++i) x[i] = acc[i];
        fence_operand(x);
      };
      auto fold = [&](int j) {
        with_bias<2 * kRows>(p, smem, bars, bit + j, j * kKeys,
                             wg * kRows + r0, ra, t,
                             [&](const auto& bias) { rows.fold(x, bias); });
      };
      issue(kit);
      for (int j = 0; j < n - 1; ++j) {
        take(j);
        issue(kit + j + 1);
        fold(j);
      }
      take(n - 1);
      fold(n - 1);
      kit += n;
      bit += n;
      rows.finish();
    }

    // phase 1: round j issues S(j) and P(j-1)·V(j-1).  P(j) is formed in
    // f32 while P·V runs and packed into pa, the A fragment, once that has
    // completed, and each round's S has accumulators of its own: no
    // instruction but a wgmma defines a wgmma's registers while one is in
    // flight, else ptxas serializes every wgmma of the kernel (C7513,
    // C7515)
    float o[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
      fence_operand(o[nb]);
    }
    uint32_t pa[4][4];
    {
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_operand(s);
      mbar_wait(bars.k_full(stage_of(kit, KS)), parity_of(kit, KS));
      turn_wait();
      wgmma_fence();
      s_mma(s, stage_of(kit, KS));
      wgmma_commit();
      turn_pass();
      wgmma_wait<0>();
      mbar_arrive(bars.k_empty(stage_of(kit, KS)));
      if (n == 1) mbar_arrive(bars.q_empty());
      with_bias<2 * kRows>(p, smem, bars, bit, 0, wg * kRows + r0, ra, t,
                           [&](const auto& bias) {
                             if (!p.stats_phase) {
                               rows.fold(s, bias);
                               rows.finish();
                             }
                             rows.probs(s, bias, pa);
                           });
    }
    for (int j = 1; j < n; ++j) {
      const int kj = kit + j, vj = vit + j - 1;
      float s[32], e[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_operand(s);
      mbar_wait(bars.k_full(stage_of(kj, KS)), parity_of(kj, KS));
      mbar_wait(bars.v_full(stage_of(vj, VS)), parity_of(vj, VS));
      turn_wait();
      wgmma_fence();
      s_mma(s, stage_of(kj, KS));
      wgmma_commit();
      pv_mma(o, pa, stage_of(vj, VS));
      wgmma_commit();
      turn_pass();
      wgmma_wait<1>();  // S(j)
      mbar_arrive(bars.k_empty(stage_of(kj, KS)));
      if (j == n - 1) mbar_arrive(bars.q_empty());
      with_bias<2 * kRows>(p, smem, bars, bit + j, j * kKeys, wg * kRows + r0,
                           ra, t,
                           [&](const auto& bias) { rows.probs(s, bias, e); });
      wgmma_wait<0>();  // P(j-1)·V(j-1)
      mbar_arrive(bars.v_empty(stage_of(vj, VS)));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = pack_bf16(e[8 * kk + 2 * x], e[8 * kk + 2 * x + 1]);
    }
    // the last tile's P·V
    const int vl = vit + n - 1;
    mbar_wait(bars.v_full(stage_of(vl, VS)), parity_of(vl, VS));
    turn_wait();
    wgmma_fence();
    pv_mma(o, pa, stage_of(vl, VS));
    wgmma_commit();
    // the last turn of warpgroup 1 hands none on: warpgroup 0 is done
    if (!(last_item && wg == 1)) turn_pass();
    wgmma_wait<0>();
    mbar_arrive(bars.v_empty(stage_of(vl, VS)));
    kit += n;
    vit += n;
    bit += n;
    store_o<NB>(p, o, b, h, q0, 0, r0, t);
  }
}

// one 64-row query tile, O's columns split over the consumer warpgroups:
// warpgroup 0 computes S and P, keeps P for its own P·V and hands it to
// warpgroup 1 through a slot of shared memory; passes of 2·64·NB columns
template <int NB>
__device__ __forceinline__ void consume_split(const Params& p, char* smem,
                                              int wg, int tid) {
  const Bars bars{smem_u32(smem) + p.bar_off};
  const int n = p.n_tiles, cb = p.chunk_boxes;
  const int KS = p.k_stages, VS = p.v_stages;
  const bool resident = p.n_chunks == 1;
  const int warp = tid / 32, lane = tid % 32, t = lane & 3, g = lane >> 2;
  const int r0 = 16 * warp + g;
  char* const slots = smem + p.p_off;

  int kit = 0, vit = 0, bit = 0, pit = 0, n_item = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++n_item) {
    const int pair = item / p.n_qt;
    const int q0 = (item % p.n_qt) * kRows;
    const int b = pair / p.H, h = pair % p.H;
    Rows rows;
    rows.reset();
    int ra[2] = {0, 0};
    if (p.bias && !p.bias_tma) bias_rows(p, h, q0, r0, ra);
    if (wg == 0 && resident) {
      mbar_wait(bars.q_full(), n_item & 1);
      scale_q(smem, cb * kBoxBytes, tid, p.inv_temp);
      fence_async_smem();
      wg_sync(0);
    }
    // S of one key tile, its chunks in turn (warpgroup 0)
    auto s_tile = [&](float(&s)[32], bool last_s) {
      for (int c = 0; c < p.n_chunks; ++c, ++kit) {
        const int ks = stage_of(kit, KS);
        mbar_wait(bars.k_full(ks), parity_of(kit, KS));
        char* const st = smem + p.k_off + ks * p.k_stage;
        char* const qb = resident ? smem : st + cb * kBoxBytes;
        if (!resident) {
          scale_q(qb, cb * kBoxBytes, tid, p.inv_temp);
          fence_async_smem();
          wg_sync(0);
        }
        const uint32_t qa = opaque(smem_u32(qb)), ka = opaque(smem_u32(st));
        wgmma_fence();
        for (int x = 0; x < cb; ++x)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wgmma_ss(s, desc(qa + x * kBoxBytes + 32 * j, 16, 1024),
                     desc(ka + x * kBoxBytes + 32 * j, 16, 1024),
                     c > 0 || x > 0 || j > 0);
        wgmma_commit();
        wgmma_wait<0>();
        mbar_arrive(bars.k_empty(ks));
      }
      if (last_s && resident) mbar_arrive(bars.q_empty());
    };
    for (int pass = 0; pass < p.n_passes; ++pass) {
      const bool last_pass = pass == p.n_passes - 1;
      float o[NB][32];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
        fence_operand(o[nb]);
      }
      if (wg == 0) {
        if (pass == 0 && p.stats_phase) {
          for (int j = 0; j < n; ++j, ++bit) {
            float s[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) s[i] = 0.f;
            fence_operand(s);
            s_tile(s, false);
            with_bias<kRows>(p, smem, bars, bit, j * kKeys, r0, ra, t,
                             [&](const auto& bias) { rows.fold(s, bias); });
          }
          rows.finish();
        }
        for (int j = 0; j < n; ++j, ++bit, ++pit, ++vit) {
          float s[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = 0.f;
          fence_operand(s);
          s_tile(s, last_pass && j == n - 1);
          uint32_t pa[4][4];
          with_bias<kRows>(p, smem, bars, bit, j * kKeys, r0, ra, t,
                           [&](const auto& bias) {
                             if (!p.stats_phase && pass == 0) {
                               rows.fold(s, bias);
                               rows.finish();
                             }
                             rows.probs(s, bias, pa);
                           });
          // P into its slot, in the K-major swizzled layout wgmma reads
          const int ps = pit & 1;
          if (pit >= 2) mbar_wait(bars.p_empty(ps), ((pit >> 1) - 1) & 1);
          char* const slot = slots + ps * kBoxBytes +
                             opaque(r0 * 128 + 4 * t);  // this lane's
          const int gl = static_cast<int>(opaque(g));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              *reinterpret_cast<uint32_t*>(
                  slot + 8 * (x & 1) * 128 +
                  (((2 * kk + (x >> 1)) ^ gl) << 4)) = pa[kk][x];
          fence_async_smem();
          mbar_arrive(bars.p_full(ps));
          const int vs = stage_of(vit, VS);
          mbar_wait(bars.v_full(vs), parity_of(vit, VS));
          const uint32_t va = opaque(smem_u32(smem + p.v_off + vs * p.v_stage));
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
              wgmma_rs(o[nb], pa[kk],
                       desc(va + nb * kBoxBytes + kk * 2048, kBoxBytes, 1024));
          wgmma_commit();
          wgmma_wait<0>();
          mbar_arrive(bars.v_empty(vs));
        }
      } else {
        for (int j = 0; j < n; ++j, ++pit, ++vit) {
          const int ps = pit & 1;
          mbar_wait(bars.p_full(ps), (pit >> 1) & 1);
          const int vs = stage_of(vit, VS);
          mbar_wait(bars.v_full(vs), parity_of(vit, VS));
          const uint32_t pa = opaque(smem_u32(slots + ps * kBoxBytes));
          const uint32_t va = opaque(smem_u32(smem + p.v_off + vs * p.v_stage) +
                                     NB * kBoxBytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
              wgmma_ss_mn(o[nb], desc(pa + 32 * kk, 16, 1024),
                          desc(va + nb * kBoxBytes + kk * 2048, kBoxBytes,
                               1024));
          wgmma_commit();
          wgmma_wait<0>();
          mbar_arrive(bars.p_empty(ps));
          mbar_arrive(bars.v_empty(vs));
        }
      }
      store_o<NB>(p, o, b, h, q0, pass * p.v_boxes * 64 + wg * NB * 64, r0,
                  t);
    }
  }
}

// ------------------------------------------------------------------ kernel

// NB: 64-column blocks of O a consumer warpgroup holds; SPLIT: 0 two query
// tiles in ping-pong, 1 one tile with O's columns split
template <int NB, int SPLIT>
__global__ void __launch_bounds__(3 * kWG, 1)
attention_stream_bf16_kernel(const __grid_constant__ Params p,
                             const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tb) {
  // the swizzled boxes need 1024-byte alignment; the kernel has no static
  // shared memory, so the dynamic region starts at offset 0 of the block's
  // window, which the declaration's alignment makes certain (checked)
  extern __shared__ __align__(1024) char smem[];
  if (smem_u32(smem) % kAlign) __trap();

  if (threadIdx.x == 0) {
    const Bars bars{smem_u32(smem) + p.bar_off};
    const int readers = SPLIT ? kWG : 2 * kWG;  // of Q, K and the bias
    mbar_init(bars.q_full(), 1);
    mbar_init(bars.q_empty(), readers);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bars.k_full(s), 1);
      mbar_init(bars.k_empty(s), readers);
      mbar_init(bars.v_full(s), 1);
      mbar_init(bars.v_empty(s), 2 * kWG);
      // every producer thread copies a row where TMA cannot take the bias
      mbar_init(bars.b_full(s), p.bias_tma ? 1 : kWG);
      mbar_init(bars.b_empty(s), readers);
      mbar_init(bars.p_full(s), kWG);
      mbar_init(bars.p_empty(s), kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWG) {
    // 384 threads at 168 registers; the producers keep 56, the consumers
    // take 224 (with 40 and 232 the producer spilled a few values)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int pt = threadIdx.x - 2 * kWG;
    if (pt < 32)
      produce<SPLIT, true>(p, smem, tq, tk, tv, tb, pt);
    else if (p.bias && !p.bias_tma)
      produce<SPLIT, false>(p, smem, tq, tk, tv, tb, pt);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  if constexpr (SPLIT)
    consume_split<NB>(p, smem, wg, tid);
  else
    consume_pair<NB>(p, smem, wg, tid);
}

// ------------------------------------------------------------------ host

struct Plan {
  int split;        // 0: two query tiles in ping-pong; 1: O's columns split
  int nb;           // 64-column blocks of O a consumer warpgroup holds
  int chunk_boxes, n_chunks, v_boxes, n_passes;
  int k_stages, v_stages, b_stages;
  int q_bytes, k_stage, v_stage, b_stage;
  int k_off, v_off, b_off, p_off, bar_off, smem;
};

// the launch geometry at L, d_k, d_v with or without a bias: two 64-row
// query tiles in ping-pong where d_v <= 256 and Q of both fits resident
// beside one stage of each ring; else one tile with O's columns split
// (passes of 512 past 512), Q resident or (past what shared memory holds)
// streamed beside K in chunks of d_k.  Each ring takes as many stages, up
// to two, as fit, K and V before the bias.  False where nothing fits.
bool plan(int L, int dk, int dv, bool with_bias, Plan* pl) {
  if (L < 1 || dk < 1 || dv < 1) return false;
  // a bias stage of BR rows holds them copied a row at a time (kBiasPitch
  // bytes a row) or by TMA (the first 256 bytes a row), whichever comes
  auto bias_bytes = [&](int br) { return with_bias ? br * kBiasPitch : 0; };
  const int kb = (dk + 63) / 64, vb = (dv + 63) / 64;
  static const int kStages[4][3] = {{2, 2, 2}, {2, 2, 1}, {2, 1, 1}, {1, 1, 1}};
  auto fits = [&](int q, int k, int v, int bias, int slots) {
    for (const auto& st : kStages) {
      const int smem = q + st[0] * k + st[1] * v + st[2] * bias + slots + kBars;
      if (smem <= kMaxSmem) {
        pl->k_stages = st[0];
        pl->v_stages = st[1];
        pl->b_stages = with_bias ? st[2] : 0;
        pl->q_bytes = q;
        pl->k_stage = k;
        pl->v_stage = v;
        pl->b_stage = bias;
        pl->k_off = q;
        pl->v_off = pl->k_off + st[0] * k;
        pl->b_off = pl->v_off + st[1] * v;
        pl->p_off = pl->b_off + st[2] * bias;
        pl->bar_off = pl->p_off + slots;
        pl->smem = smem;
        return true;
      }
    }
    return false;
  };
  if (vb <= 4) {
    pl->split = 0;
    pl->nb = pl->v_boxes = vb;
    pl->n_passes = 1;
    pl->chunk_boxes = kb;
    pl->n_chunks = 1;
    if (fits(2 * kb * kBoxBytes, kb * kBoxBytes, vb * kBoxBytes,
             bias_bytes(2 * kRows), 0))
      return true;
  }
  pl->split = 1;
  pl->nb = std::min(3, (std::min(vb, 6) + 1) / 2);
  pl->v_boxes = 2 * pl->nb;
  pl->n_passes = (vb + pl->v_boxes - 1) / pl->v_boxes;
  const int v = pl->v_boxes * kBoxBytes;
  const int bias = bias_bytes(kRows);
  const int slots = 2 * kBoxBytes;
  pl->chunk_boxes = kb;
  pl->n_chunks = 1;
  if (fits(kb * kBoxBytes, kb * kBoxBytes, v, bias, slots)) return true;
  for (int cb = kb; cb >= 1; --cb) {
    pl->chunk_boxes = cb;
    pl->n_chunks = (kb + cb - 1) / cb;
    if (fits(0, 2 * cb * kBoxBytes, v, bias, slots)) return true;
  }
  return false;
}

template <int NB, int SPLIT>
int run(const Params& p, int grid, int smem, const CUtensorMap& tq,
        const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& tb,
        cudaStream_t stream) {
  auto kernel = attention_stream_bf16_kernel<NB, SPLIT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 3 * kWG, smem, stream>>>(p, tq, tk, tv, tb);
  return static_cast<int>(cudaGetLastError());
}

using Runner = int (*)(const Params&, int, int, const CUtensorMap&,
                       const CUtensorMap&, const CUtensorMap&,
                       const CUtensorMap&, cudaStream_t);
// two query tiles: NB 1-4; O's columns split: NB 1-3 (at 4 a warpgroup
// holding 128 registers of O spilled in its epilogue)
constexpr Runner kPair[4] = {run<1, 0>, run<2, 0>, run<3, 0>, run<4, 0>};
constexpr Runner kSplit[3] = {run<1, 1>, run<2, 1>, run<3, 1>};

}  // namespace

// strides: 12 element strides, batch, head and row of q, k, v and out.
// vec: bit 0, 1, 2 set where q, k, v have a 16-byte-aligned base and
// batch, head and row strides, which TMA reads; all three must be set.
extern "C" int lstc_attention_stream_bf16_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    const long long* strides, int B, int H, int L, int dk, int dv,
    unsigned vec, float temperature, void* stream) {
  if (B < 1 || H < 1 || L < 1 || dk < 1 || dv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  if (!plan(L, dk, dv, bias != nullptr, &pl))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  for (int i = 0; i < 3; ++i) {
    p.str.q[i] = strides[i];
    p.str.k[i] = strides[3 + i];
    p.str.v[i] = strides[6 + i];
    p.str.o[i] = strides[9 + i];
  }
  p.H = H;
  p.L = L;
  p.dk = dk;
  p.dv = dv;
  p.n_tiles = (L + kKeys - 1) / kKeys;
  p.stats_phase = p.n_tiles > 1;
  p.item_rows = pl.split ? kRows : 2 * kRows;
  p.n_qt = (L + p.item_rows - 1) / p.item_rows;
  p.k_stages = pl.k_stages;
  p.v_stages = pl.v_stages;
  p.b_stages = pl.b_stages;
  p.chunk_boxes = pl.chunk_boxes;
  p.n_chunks = pl.n_chunks;
  p.v_boxes = pl.v_boxes;
  p.n_passes = pl.n_passes;
  p.k_stage = pl.k_stage;
  p.v_stage = pl.v_stage;
  p.b_stage = pl.b_stage;
  p.k_off = pl.k_off;
  p.v_off = pl.v_off;
  p.b_off = pl.b_off;
  p.p_off = pl.p_off;
  p.bar_off = pl.bar_off;
  p.inv_temp = 1.f / temperature;
  const long long items = static_cast<long long>(B) * H * p.n_qt;
  if (items > 0x3fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.n_items = static_cast<int>(items);

  // every tensor by TMA: the wrapper copies one off the 16-byte grid into a
  // padded buffer first
  CUtensorMap tq{}, tk{}, tv{}, tb{};
  if (vec != (kVecQ | kVecK | kVecV) ||
      !encode(&tq, q, dk, L, H, B, strides, kRows) ||
      !encode(&tk, k, dk, L, H, B, strides + 3, kKeys) ||
      !encode(&tv, v, dv, L, H, B, strides + 6, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  // the bias by TMA where its rows are whole 16 bytes from an aligned base:
  // a map (keys, rows, H, 1) of boxes of 32 keys x the item's rows; else a
  // bulk copy a row
  p.bias_tma = 0;
  if (bias && L % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0) {
    const long long bstr[3] = {0, static_cast<long long>(L) * L, L};
    if (!encode(&tb, bias, L, L, H, 1, bstr, p.item_rows, 1, true))
      return static_cast<int>(cudaErrorInvalidValue);
    p.bias_tma = 1;
  }

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.n_items < sms ? p.n_items : sms;
  return (pl.split ? kSplit : kPair)[pl.nb - 1](
      p, grid, pl.smem, tq, tk, tv, tb, static_cast<cudaStream_t>(stream));
}

// the launch geometry at L, d_k, d_v with or without a bias: out[0]
// dynamic shared memory bytes, [1] threads a block, [2] query rows a work
// item, [3] K stages, [4] 1 where Q is resident, [5] keys a tile, [6] query
// tiles a block holds at once, [7] V stages, [8] bias stages, [9] 1: blocks
// are persistent (one an SM, walking the work items), [10] 1 where the
// consumer warpgroups take turns (ping-pong).  Returns 0, or a cudaError_t
// where no geometry fits.
extern "C" int lstc_attention_stream_bf16_plan(int L, int dk, int dv,
                                               int with_bias, int* out) {
  Plan pl;
  if (L < 1 || dk < 1 || dv < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!plan(L, dk, dv, with_bias != 0, &pl))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  out[0] = pl.smem;
  out[1] = 3 * kWG;
  out[2] = pl.split ? kRows : 2 * kRows;
  out[3] = pl.k_stages;
  out[4] = pl.n_chunks == 1;
  out[5] = kKeys;
  out[6] = pl.split ? 1 : 2;
  out[7] = pl.v_stages;
  out[8] = pl.b_stages;
  out[9] = 1;
  out[10] = !pl.split;
  return 0;
}

extern "C" const char* lstc_cuda_stream_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
