// Fused scaled dot-product attention with an additive bias, for Hopper
// (sm_90a), f32-accurate: the f32 route of the attention operator at L <= 128
// (csrc/attention_bf16.cu is the bf16 route, csrc/attention_stream.cu takes
// every other f32 shape).
//
//   out[b,h] = softmax(q[b,h] · k[b,h]^T / temperature + bias[h]) · v[b,h]
//
// q, k, v, out: [B, H, L, D] float32 views with a unit innermost stride, a
// 16-byte-aligned base, and batch, head and row strides that are multiples of
// 4 elements: the encoder passes its projections as they come out of the
// GEMMs, [B, L, H, D] buffers seen through a transpose, and out is written
// into such a buffer, so no copy is made around the kernel.  bias: [H, L, L]
// float32, contiguous, or null; broadcast over B.  1 <= L <= 128; D a multiple
// of 32 up to 256.
//
// Replaces the TPU kernel lstc_vad_tpu/ops/pallas_attention.py::_kernel
// (launched by _forward, entry pallas_sdpa).  That kernel packs floor(128/L)
// (batch, head) pairs block-diagonally under a -1e30 mask to fill the TPU's
// 128x128 matrix unit; this one packs 4 or 2 heads of one batch row into a
// 64-row tile for wgmma's 64 rows, masked the same way.
//
// Arithmetic: q·(1/temperature) in f32; both products f32-accurate in 3xTF32
// (each operand split x = big + small, big = x rounded to TF32 to nearest,
// small = x - big, and small·big + big·small + big·big summed by the tensor
// core in f32; the dropped small·small and what the tensor core's truncation
// of small loses are about 2^-21 |x|); each 8-deep k-step's three products
// are summed from zero on the tensor core and added to S or O in IEEE f32,
// since the tensor core truncates as it accumulates (one chained sum lost to
// plain_sdpa against float64 at logits near ±100); the softmax in IEEE f32
// (expf, a true division), P normalised before P·V.
//
// What bounds it on an H100 SXM.  It must read q, k, v and write out once:
// 16·L·D bytes per (b, h) pair, and the bias once, against 4·L²·D FLOP for
// its two products.  In 3xTF32 the tensor cores give 495/3 = 165
// f32-accurate TFLOP/s; over 3.35 TB/s that is 49 FLOP per byte against L/4,
// so the bytes bound it at every L it takes.  At the main path's shape
// (B=924, H=8, L=49, D=256, bias) the bytes take 0.443 ms.  The [L, L] scores
// never go to device memory.  Below the bytes, what a tile costs is a chain
// of short dependent steps (wait for a chunk, split it, synchronise, issue
// products, wait for them, add), so the design keeps as many tiles in
// flight on an SM as registers and shared memory allow, and gives the
// products no work past the tile's keys.
//
// Design (csrc/attention_bf16.cu's, carried to f32):
// - Tiles.  A tile is 64 query rows of one batch row b: 4 heads of L <= 16
//   (16 rows each), 2 heads of L <= 32, one head of L <= 64; at L in (64,
//   128] it is 128 rows of one head, split over two consumer warpgroups,
//   which share its K and V.  The products take NK keys: all 64 of a tile
//   of 4 or 2 heads (S set to -inf between heads), 8·ceil(L/8) of a tile of
//   one head (a compile-time instantiation each: NK = 40 ... 128).  Rows
//   past L and heads past H are zero-filled by TMA and never stored; keys
//   past L score -inf.
// - Persistent, warp-specialised blocks.  One block an SM walks the tiles in
//   a strided loop.  At 64-row tiles it has three consumer warpgroups, each
//   with a ring of its own taking every third tile of the block, so that
//   three tiles are in flight and one's splits, softmax and stores overlap
//   the others' products (one or two in flight are slower: the builds
//   one_tile_in_flight and two_tiles_in_flight of
//   scripts/torch_attention_ablation.py, PERF.md §6); 512 threads, 160
//   registers a consumer thread.  At 128-row tiles both consumer
//   warpgroups take one tile from one ring (384 threads, 232 registers).
//   One thread of the producer warpgroup a ring issues the TMA loads; the
//   producers hand their registers to the consumers (setmaxnreg).
// - Chunks of D.  A tile's Q, K and V with K and V's TF32 halves do not fit
//   in 227 KB at D = 256, so the ring's items are 32-column chunks (one
//   128-byte box a row): Q and K's boxes of chunk c, for S, then V's box of
//   chunk c, for O.  S accumulates in registers over the chunks; O is
//   produced, normalised and stored chunk by chunk.  3 or 4 stages a ring.
// - TMA in.  4-D tensor maps (d, L, H, B) over the views' own strides, f32
//   boxes of 32 columns x R rows x G heads (128 rows at 128-row tiles),
//   128-byte swizzle (csrc/hopper.cuh).
// - The split, once per tile.  The consumers that use a chunk split it
//   together, each thread a share, from the landed box into a split buffer
//   (two at 128-row tiles, where one warpgroup may split the next chunk
//   while the other still reads the last): K into its big and small halves
//   in its own layout (K-major, as TF32 wgmma reads B), V transposed to
//   K-major V^T, TF32 wgmma taking no transposed operand.  The producer-side
//   split of csrc/attention_stream.cu (landing zones, ready slots) was built
//   too and was slower at the main shape: its producers, two warps a ring,
//   did not keep up with the consumers (PERF.md §6).
// - S = Q·K^T is wgmma.m64nNKk8 with Q's A fragments from registers: loaded
//   from the landed box a k-step at a time, scaled, split.
// - O = P·V is wgmma.m64n32k8 a chunk, P as the register A operand: the S
//   accumulators of an 8-key group (lane (g, t) holds keys 2t, 2t+1) read as
//   the A fragment of a k-step (k-slots t, t + 4), which puts the keys in
//   the order 0,2,4,6,1,3,5,7; V^T's slots follow it, so P needs no shuffle.
// - The bias [H, L, L] (at most 512 KB, resident in L2) is read once S is
//   complete, so that it holds no registers across the products, all of a
//   thread's loads in flight together.
// - TMA out.  Each O chunk is written into a staging box of its warpgroup
//   (swizzled as TMA reads it; two a warpgroup at 128-row tiles) and stored
//   by a bulk tensor store to out's map, which drops rows past L and heads
//   past H.
// - ptxas serializes every wgmma of a kernel (warnings C7514, C7515, C7518,
//   C7520) whose products stay in flight across a loop's back edge or a
//   branch, that reads or writes their accumulators between issue and wait,
//   or that waits on a barrier between writing a product's registers and
//   issuing it.  So each chunk ends with nothing in flight, its ring stage
//   is waited for before any product register is written, and every k-step
//   runs (a loop that left early was serialized: C7514).
// - The launch geometry (tile rows, heads a tile, keys, threads, rings,
//   stages, shared memory) is computed by one function, `plan`, which the
//   launcher and lstc_attention_f32_plan (ops/cuda_attention.py::f32_plan)
//   both call.
//
// The encoder's GEMMs (projections, FFN, head) stay nn.Linear on cuBLAS, as
// the JAX package left them to XLA.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns a
// cudaError_t (0 = launched).

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxL = 128;
constexpr int kMaxD = 256;
constexpr int kMaxStages = 4;
constexpr int kCols = kBoxColsF32;          // columns of a chunk: 32
constexpr int kRowBytes = 4 * kCols;        // a box row: 128 bytes
constexpr int kOBox = 64 * kRowBytes;       // a staging box: 64 rows of O
constexpr int kVSub = 32 * kRowBytes;       // 32 keys of V^T's 32 rows

struct Params {
  const float* bias;
  int H, L;
  int head_rows;   // R: rows a head takes in a tile (16, 32, 64 or 128)
  int head_shift;  // log2(R)
  int heads;       // G: heads of a tile
  int n_hg;        // tiles of a batch row: ceil(H / G)
  int n_tiles;     // B · n_hg
  int n_chunks;    // D / 32
  int stages;      // of each ring
  float inv_temp;
};

// the threads that split a chunk together: the warpgroup at 64-row tiles,
// both consumer warpgroups at 128-row tiles
template <int NC>
__device__ __forceinline__ void split_sync(int wg) {
  if (NC == 1)
    wg_sync(wg);
  else
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// a landed K box (M keys x 32 columns) into its TF32 halves in the same
// layout, its first NK keys: big at dst, small at dst + M·128; thread i of
// the 2M (NC·128) a share
template <int M, int NK>
__device__ __forceinline__ void split_k(const char* src, char* dst, int i) {
  constexpr int kBox = M * kRowBytes;
#pragma unroll
  for (int n = 0; n < kBox / (16 * 2 * M); ++n) {
    const int off = 16 * (i + 2 * M * n);
    if (off >= NK * kRowBytes) break;
    const float4 x = *reinterpret_cast<const float4*>(src + off);
    uint32_t b[4], s[4];
    split(x.x, b[0], s[0]);
    split(x.y, b[1], s[1]);
    split(x.z, b[2], s[2]);
    split(x.w, b[3], s[3]);
    *reinterpret_cast<uint4*>(dst + off) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(dst + kBox + off) =
        make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// a landed V box (M keys x 32 columns) transposed to V^T (32 rows of columns
// x M keys, in M/32 boxes of 32 keys), the keys of every 8-key group in the
// order 0,2,4,6,1,3,5,7, and split, its first NK keys: big at dst, small at
// dst + M·128.  Unit i (one a thread, 2M of them): columns 4nq .. 4nq + 3 x
// the 4 keys 8G + 2e + par (e = 0..3) that fill slots 4par .. 4par + 3 of
// key group G; a warp's reads and writes each fall on 8 distinct 16-byte
// bank groups.
template <int M, int NK>
__device__ __forceinline__ void split_v(const char* src, char* dst, int i) {
  constexpr int kBox = M * kRowBytes;
  const int gp = i & 7;                  // 2 (G % 4) + par: the slot chunk
  const int nq = (i >> 3) & 7, sub = i >> 6;
  const int G = 4 * sub + (gp >> 1), par = gp & 1;
  if (G >= NK / 8) return;
  float4 x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = 8 * G + 2 * e + par;
    x[e] = *reinterpret_cast<const float4*>(src + key * kRowBytes +
                                            ((nq ^ (key & 7)) << 4));
  }
  const float4 col[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                         make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                         make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                         make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = 4 * nq + c;
    const int off = sub * kVSub + n * kRowBytes + ((gp ^ (n & 7)) << 4);
    uint32_t b[4], s[4];
    split(col[c].x, b[0], s[0]);
    split(col[c].y, b[1], s[1]);
    split(col[c].z, b[2], s[2]);
    split(col[c].w, b[3], s[3]);
    *reinterpret_cast<uint4*>(dst + off) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(dst + kBox + off) =
        make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// The launch geometry of an instantiation.  NC: consumer warpgroups a tile
// (1: 64-row tiles, three in flight a block, a ring and a consumer
// warpgroup each; 2: 128-row tiles, one in flight, both consumer warpgroups
// on it); CW consumer warpgroups and one producer warpgroup a block.
template <int NC>
struct Shape {
  static constexpr int CW = NC == 1 ? 3 : 2;
  static constexpr int RINGS = CW / NC;      // tiles in flight a block
  // split buffers a ring: at 128-row tiles a warpgroup may split the next
  // chunk while the other still reads the last
  static constexpr int SPLITS = NC;
  static constexpr int STAGING = NC;         // staging boxes a warpgroup
  static constexpr int THREADS = (CW + 1) * kWG;
  // registers a producer and a consumer thread keep (setmaxnreg)
  static constexpr int PRODUCER_REGS = NC == 1 ? 32 : 40;
  static constexpr int CONSUMER_REGS = NC == 1 ? 160 : 232;
};

// NK: keys of a tile that the products take, 8·ceil(L / 8) with one head a
// tile, else all 64 (S = Q·K^T is 64 x NK a consumer warpgroup)
template <int NC, int NK>
__global__ void __launch_bounds__(Shape<NC>::THREADS, 1)
attention_fwd_kernel(const __grid_constant__ Params p,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to) {
  constexpr int M = 64 * NC;              // rows (and keys) of a tile
  constexpr int kBox = M * kRowBytes;     // a box of M rows x 32 columns
  constexpr int kStage = 2 * kBox;        // Q and K of a chunk, or V
  constexpr int kSplit = 2 * kBox;        // a chunk's K or V^T, both halves
  constexpr int CW = Shape<NC>::CW, RINGS = Shape<NC>::RINGS;
  constexpr int SPLITS = Shape<NC>::SPLITS, STAGING = Shape<NC>::STAGING;
  constexpr int NS = NK / 2;              // S's accumulators a thread
  constexpr int S_SETS = 2;               // S's k-steps in flight
  constexpr int O_SETS = 2;               // O's
  // the kernel has no static shared memory, so the dynamic region starts at
  // offset 0 of the block's window, 1024-byte aligned for the swizzle
  extern __shared__ __align__(1024) char smem[];
  if (smem_u32(smem) % kAlign) __trap();
  const int S = p.stages;
  char* const split0 = smem + RINGS * S * kStage;
  char* const staging = split0 + RINGS * SPLITS * kSplit;
  const uint32_t bar0 = smem_u32(staging + CW * STAGING * kOBox);
  auto full = [&](int r, int s) { return bar0 + 8 * (2 * S * r + s); };
  auto empty = [&](int r, int s) { return bar0 + 8 * (2 * S * r + S + s); };

  if (threadIdx.x == 0) {
    for (int r = 0; r < RINGS; ++r)
      for (int s = 0; s < S; ++s) {
        mbar_init(full(r, s), 1);
        mbar_init(empty(r, s), NC * kWG);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CW * kWG) {
    // ------------------------------------------------------------ producer
    // lane 0 of warp r feeds ring r: the chunks of every RINGS-th tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Shape<NC>::PRODUCER_REGS) : "memory");
    const int pt = threadIdx.x - CW * kWG, r = pt / 32;
    if (pt % 32 || r >= RINGS) return;
    char* const ring = smem + r * S * kStage;
    int it = 0;
    for (int tile = blockIdx.x + r * gridDim.x; tile < p.n_tiles;
         tile += RINGS * gridDim.x) {
      const int b = tile / p.n_hg, h0 = (tile % p.n_hg) * p.heads;
      for (int x = 0; x < 2 * p.n_chunks; ++x, ++it) {
        const int s = it % S, use = it / S;
        const uint32_t dst = smem_u32(ring + s * kStage);
        if (use > 0) mbar_wait(empty(r, s), (use - 1) & 1);
        if (x < p.n_chunks) {
          mbar_arrive_tx(full(r, s), 2 * kBox);
          tma_box(dst, &tq, full(r, s), kCols * x, 0, h0, b);
          tma_box(dst + kBox, &tk, full(r, s), kCols * x, 0, h0, b);
        } else {
          mbar_arrive_tx(full(r, s), kBox);
          tma_box(dst, &tv, full(r, s), kCols * (x - p.n_chunks), 0, h0, b);
        }
      }
    }
    return;
  }

  // ---------------------------------------------------- consumer warpgroups
  // The producers' registers go to the consumers (512 threads at 128
  // registers: 32 and 160; 384 at 168: 40 and 232).  Warpgroup wg computes
  // rows [64 wr, 64 wr + 64) of the tiles of ring rg.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      Shape<NC>::CONSUMER_REGS) : "memory");
  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int rg = NC == 1 ? wg : 0, wr = NC == 1 ? 0 : wg;
  const int split_tid = NC == 1 ? tid : threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int t = lane & 3, g = lane >> 2;
  const int r0 = 64 * wr + 16 * warp + g;  // rows r0 and r0 + 8 of the tile
  const int L = p.L, R = p.head_rows, hs = p.head_shift;
  char* const ring = smem + rg * S * kStage;
  char* const split_buf = split0 + rg * SPLITS * kSplit;
  char* const my_staging = staging + wg * STAGING * kOBox;
  int it = 0, n_stores = 0;

  // this thread's Q words of k-step kk of a landed box: rows r0 and r0 + 8,
  // columns 8kk + t and 8kk + t + 4 (16-byte chunks 2kk and 2kk + 1)
  auto load_q = [&](float (&a)[4], const char* box, int kk) {
    const char* const hi = box + r0 * kRowBytes;
    const char* const lo = hi + 8 * kRowBytes;
    const int c0 = ((2 * kk) ^ g) << 4, c1 = ((2 * kk + 1) ^ g) << 4;
    a[0] = *reinterpret_cast<const float*>(hi + c0 + 4 * t);
    a[1] = *reinterpret_cast<const float*>(lo + c0 + 4 * t);
    a[2] = *reinterpret_cast<const float*>(hi + c1 + 4 * t);
    a[3] = *reinterpret_cast<const float*>(lo + c1 + 4 * t);
  };

  for (int tile = blockIdx.x + rg * gridDim.x; tile < p.n_tiles;
       tile += RINGS * gridDim.x) {
    const int b = tile / p.n_hg, h0 = (tile % p.n_hg) * p.heads;

    // S = (Q / temperature)·K^T over the chunks of D; sc[i] is row
    // r0 + 8((i >> 1) & 1), key 8(i >> 2) + 2t + (i & 1)
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
#pragma unroll 1
    for (int c = 0; c < p.n_chunks; ++c, ++it) {
      const int s = it % S;
      const char* const st = ring + s * kStage;
      mbar_wait(full(rg, s), (it / S) & 1);
      char* const ks = split_buf + (it % SPLITS) * kSplit;
      split_k<M, NK>(st + kBox, ks, split_tid);
      float raw[4];
      load_q(raw, st, 0);
      fence_async_smem();
      split_sync<NC>(wg);

      // each k-step's three products summed from zero (S_SETS of them in
      // flight), then added to sc in IEEE f32
      float acc[S_SETS][NS];
#pragma unroll
      for (int x = 0; x < S_SETS; ++x)
#pragma unroll
        for (int i = 0; i < NS; ++i) acc[x][i] = 0.f;
      uint32_t fb[S_SETS][4], fs[S_SETS][4];
      const uint64_t kd = desc(smem_u32(ks), 16, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int set = kk % S_SETS;
        if (kk >= S_SETS) {
          wgmma_wait<S_SETS - 1>();
#pragma unroll
          for (int i = 0; i < NS; ++i) sc[i] += acc[set][i];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(raw[e] * p.inv_temp, fb[set][e], fs[set][e]);
        // the next k-step's Q words; after the last, the stage is free
        if (kk + 1 < 4)
          load_q(raw, st, kk + 1);
        else
          mbar_arrive(empty(rg, s));
        const uint64_t at = kd + 2 * kk;  // + 32 bytes a k-step
        wgmma_fence();
        wgmma_tf32(acc[set], fs[set], at, 0);
        wgmma_tf32(acc[set], fb[set], at + (kBox >> 4), 1);
        wgmma_tf32(acc[set], fb[set], at, 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < S_SETS; ++x)
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] += acc[(4 + x) % S_SETS][i];
    }

    // + bias, -inf where the key is past L or of another head; the row
    // softmax in f32.  Row r of the tile is row r % R of head h0 + r / R.
    // The bias is loaded whole first, each load from a valid address, so
    // that its loads are in flight together.
    int head_r[2];
    bool row_live[2];
    const float* bias_row[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r0 + 8 * x, row_l = r & (R - 1);
      head_r[x] = r >> hs;
      const int h = h0 + head_r[x];
      row_live[x] = h < p.H && row_l < L;
      bias_row[x] = p.bias + (row_live[x]
                              ? (static_cast<long long>(h) * L + row_l) * L
                              : 0);
    }
    if (p.bias) {
      float bv[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int key_l = (8 * (i >> 2) + 2 * t + (i & 1)) & (R - 1);
        bv[i] = __ldg(bias_row[(i >> 1) & 1] + (key_l < L ? key_l : 0));
      }
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (row_live[(i >> 1) & 1]) sc[i] += bv[i];
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int x = (i >> 1) & 1;
      const int key = 8 * (i >> 2) + 2 * t + (i & 1);
      if (key >> hs != head_r[x] || (key & (R - 1)) >= L) sc[i] = -INFINITY;
      mx[x] = fmaxf(mx[x], sc[i]);
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) mx[x] = quad_max(mx[x]);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      sc[i] = expf(sc[i] - mx[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) sum[x] = quad_sum(sum[x]);
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = sc[i] / sum[(i >> 1) & 1];

    // O = P·V a 32-column chunk at a time, stored as each is done
#pragma unroll 1
    for (int c = 0; c < p.n_chunks; ++c, ++it) {
      const int s = it % S;
      const char* const st = ring + s * kStage;
      mbar_wait(full(rg, s), (it / S) & 1);
      char* const vs = split_buf + (it % SPLITS) * kSplit;
      split_v<M, NK>(st, vs, split_tid);
      fence_async_smem();
      split_sync<NC>(wg);
      mbar_arrive(empty(rg, s));

      // o[i] is row r0 + 8((i >> 1) & 1), column 32c + 8(i >> 2) + 2t +
      // (i & 1); each k-step's three products summed from zero (O_SETS of
      // them in flight), then added to o in IEEE f32
      float o[16], acc[O_SETS][16];
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] = 0.f;
#pragma unroll
      for (int x = 0; x < O_SETS; ++x)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[x][i] = 0.f;
      uint32_t pb[O_SETS][4], ps[O_SETS][4];
      const uint64_t vd = desc(smem_u32(vs), 16, 1024);
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
        const int set = j % O_SETS;
        if (j >= O_SETS) {
          wgmma_wait<O_SETS - 1>();
#pragma unroll
          for (int i = 0; i < 16; ++i) o[i] += acc[set][i];
        }
        // keys 8j + 2t -> k-slot t, 8j + 2t + 1 -> k-slot t + 4
        split(sc[4 * j + 0], pb[set][0], ps[set][0]);
        split(sc[4 * j + 2], pb[set][1], ps[set][1]);
        split(sc[4 * j + 1], pb[set][2], ps[set][2]);
        split(sc[4 * j + 3], pb[set][3], ps[set][3]);
        const uint64_t at = vd + (((j >> 2) * kVSub + (j & 3) * 32) >> 4);
        wgmma_fence();
        wgmma_tf32(acc[set], ps[set], at, 0);
        wgmma_tf32(acc[set], pb[set], at + (kBox >> 4), 1);
        wgmma_tf32(acc[set], pb[set], at, 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      // the last k-step of each set, in order
#pragma unroll
      for (int x = 0; x < O_SETS; ++x)
#pragma unroll
        for (int i = 0; i < 16; ++i) o[i] += acc[(NK / 8 + x) % O_SETS][i];

      // into a staging box (row r's 16-byte chunk at chunk ^ (r % 8), as
      // TMA reads it) once the store before the last STAGING has read it,
      // then one bulk tensor store
      char* const buf = my_staging + (n_stores % STAGING) * kOBox;
      if (tid == 0) bulk_wait_read<STAGING - 1>();
      wg_sync(wg);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
        const int chunk = (2 * (i >> 2) + (t >> 1)) ^ (r & 7);
        *reinterpret_cast<float2*>(buf + r * kRowBytes + (chunk << 4) +
                                   8 * (t & 1)) = make_float2(o[i], o[i + 1]);
      }
      fence_async_smem();
      wg_sync(wg);
      if (tid == 0) {
        tma_store(&to, smem_u32(buf), kCols * c, 64 * wr, h0, b);
        bulk_commit();
      }
      ++n_stores;
    }
  }
  if (tid == 0) bulk_wait_all();
}

// ------------------------------------------------------------------ host

struct Plan {
  int nc;         // consumer warpgroups a tile
  int head_rows;  // R
  int heads;      // G
  int keys;       // NK
  int threads;    // a block
  int rings;      // tiles in flight a block, a ring each
  int stages;     // of each ring
  int smem;       // dynamic shared memory bytes
};

template <int NC>
void shape(Plan* pl) {
  using S = Shape<NC>;
  const int box = 64 * NC * kRowBytes;
  const int stage = 2 * box + 2 * 8;  // Q and K boxes, full and empty
  const int fixed =
      S::RINGS * S::SPLITS * 2 * box + S::CW * S::STAGING * kOBox;
  pl->threads = S::THREADS;
  pl->rings = S::RINGS;
  pl->stages = (kMaxSmem - fixed) / (S::RINGS * stage);
  if (pl->stages > kMaxStages) pl->stages = kMaxStages;
  pl->smem = S::RINGS * pl->stages * stage + fixed;
}

// the launch geometry at L, D: 64-row tiles of 64/R heads of R = 16, 32 or
// 64 rows, three in flight a block, or one head of 128 rows over both
// consumer warpgroups; as many ring stages, up to kMaxStages, as fit beside
// the split buffers, the staging boxes and the barriers.  A stage holds a
// 32-column chunk, so the geometry does not depend on D.  False where the
// kernel does not take the shape.
bool plan(int L, int D, Plan* pl) {
  if (L < 1 || L > kMaxL || D < kCols || D > kMaxD || D % kCols) return false;
  pl->head_rows = L <= 16 ? 16 : L <= 32 ? 32 : L <= 64 ? 64 : 128;
  pl->heads = pl->head_rows <= 64 ? 64 / pl->head_rows : 1;
  pl->nc = pl->head_rows == 128 ? 2 : 1;
  pl->keys = pl->heads == 1 ? 8 * ((L + 7) / 8) : 64;
  if (pl->nc == 1)
    shape<1>(pl);
  else
    shape<2>(pl);
  return pl->stages >= 2;
}

template <int NC, int NK>
int run(const Params& p, int grid, int smem, const CUtensorMap& tq,
        const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& to,
        cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<NC, NK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, Shape<NC>::THREADS, smem, stream>>>(p, tq, tk, tv, to);
  return static_cast<int>(cudaGetLastError());
}

using Runner = int (*)(const Params&, int, int, const CUtensorMap&,
                       const CUtensorMap&, const CUtensorMap&,
                       const CUtensorMap&, cudaStream_t);
// by NK / 8: 64-row tiles of one head at L in (32, 64] or of 4 or 2 heads
// (NK = 64), 128-row tiles at L in (64, 128]
constexpr Runner kRunners[17] = {
    nullptr,      nullptr,      nullptr,      nullptr,      nullptr,
    run<1, 40>,   run<1, 48>,   run<1, 56>,   run<1, 64>,   run<2, 72>,
    run<2, 80>,   run<2, 88>,   run<2, 96>,   run<2, 104>,  run<2, 112>,
    run<2, 120>,  run<2, 128>};

}  // namespace

// strides: 12 element strides, batch, head and row of q, k, v and out
extern "C" int lstc_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* out,
                                  const long long* strides, int B, int H,
                                  int L, int D, float temperature,
                                  void* stream) {
  Plan pl;
  if (B < 1 || H < 1 || !plan(L, D, &pl) || !(temperature > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.bias = static_cast<const float*>(bias);
  p.H = H;
  p.L = L;
  p.head_rows = pl.head_rows;
  p.head_shift = pl.head_rows == 16 ? 4 : pl.head_rows == 32 ? 5
                 : pl.head_rows == 64 ? 6 : 7;
  p.heads = pl.heads;
  p.n_hg = (H + pl.heads - 1) / pl.heads;
  const long long n_tiles = static_cast<long long>(B) * p.n_hg;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = static_cast<int>(n_tiles);
  p.n_chunks = D / kCols;
  p.stages = pl.stages;
  p.inv_temp = 1.f / temperature;

  // loads: boxes of the tile's rows (R rows of G heads, or 128 rows);
  // stores: a consumer warpgroup's 64 rows
  const int load_rows = pl.nc == 1 ? pl.head_rows : 128;
  const int store_rows = pl.nc == 1 ? pl.head_rows : 64;
  CUtensorMap tq{}, tk{}, tv{}, to{};
  if (!encode(&tq, q, D, L, H, B, strides, load_rows, pl.heads, true) ||
      !encode(&tk, k, D, L, H, B, strides + 3, load_rows, pl.heads, true) ||
      !encode(&tv, v, D, L, H, B, strides + 6, load_rows, pl.heads, true) ||
      !encode(&to, out, D, L, H, B, strides + 9, store_rows, pl.heads, true))
    return static_cast<int>(cudaErrorInvalidValue);

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p.n_tiles + pl.rings - 1) / pl.rings;
  const int grid = blocks < sms ? blocks : sms;
  const auto s = static_cast<cudaStream_t>(stream);
  return kRunners[pl.keys / 8](p, grid, pl.smem, tq, tk, tv, to, s);
}

// the launch geometry at L, D: out[0] dynamic shared memory bytes, [1]
// threads a block, [2] rows a tile, [3] heads a tile, [4] rows a head takes
// in a tile, [5] keys the products take, [6] rings (tiles in flight a
// block), [7] stages a ring.
// Returns 0, or cudaErrorInvalidValue where the kernel does not take the
// shape.
extern "C" int lstc_attention_f32_plan(int L, int D, int* out) {
  Plan pl;
  if (!plan(L, D, &pl)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = pl.smem;
  out[1] = pl.threads;
  out[2] = 64 * pl.nc;
  out[3] = pl.heads;
  out[4] = pl.head_rows;
  out[5] = pl.keys;
  out[6] = pl.rings;
  out[7] = pl.stages;
  return 0;
}

extern "C" const char* lstc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
