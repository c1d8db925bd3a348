// Streaming scaled dot-product attention with an additive bias, f32 route,
// for Hopper (sm_90a): every f32 shape the attention operator takes that
// csrc/attention.cu does not.  (The bf16 route's streaming kernel is
// csrc/attention_stream_bf16.cu.)
//
//   out[b,h] = softmax(q[b,h] · k[b,h]^T / temperature + bias[h]) · v[b,h]
//
// q, k: [B, H, L, d_k]; v: [B, H, L, d_v]; out: [B, H, L, d_v], float32
// views with a unit innermost stride and any other strides.  bias: [H, L, L]
// float32, contiguous, or null; broadcast over B.  Any L, d_k, d_v >= 1.
//
// Replaces the TPU kernel lstc_vad_tpu/ops/pallas_attention.py::_kernel
// (launched by _forward, entry pallas_sdpa) at the shapes the tiled f32
// kernel does not take: parts longer than 128 tokens, d_k != d_v, head widths
// that are not a multiple of 32 up to 256, strides off the 16-byte grid.
// Arithmetic: both products f32-accurate in 3xTF32 (each operand split
// x = big + small, big = x rounded to TF32 to nearest, small = x - big, and
// small·big + big·small + big·big summed by the tensor core in f32),
// q·(1/temperature) in f32 before the split, the softmax in IEEE f32 (expf,
// a true division).
//
// What bounds it on an H100 SXM.  It must read q, k, v and write out once,
// L·(2·d_k + 2·d_v)·4 bytes a (b, h) pair, and the bias once, against
// 2·L²·(d_k + d_v) FLOP.  In 3xTF32 (165 f32-accurate TFLOP/s against 3.35
// TB/s, 49 FLOP a byte against L/4) the bytes bound it up to L ~ 197 and the
// products past that.  Past that, shared memory is the next wall: wgmma
// reads its B operand from it at 64 bytes a tensor-core clock whatever N is
// (half the SM's 128), so the split halves and the TMA landing zones share
// the other half.
//
// Design, and what each part does about that bound:
// - Blocks.  A block takes 64 query rows of one (b, h) pair (wgmma's M) and
//   walks the keys in tiles of 32 with one pass and an online softmax: each
//   row keeps a running max m and sum l, O and l are scaled by exp(m_old -
//   m_new) when a tile raises the max, and O is divided by l once at the
//   end (P is never rounded in this route, so there is no statistics
//   phase).  One consumer warpgroup computes; one producer warpgroup feeds
//   it.  256 threads, one block an SM (~224 KB of shared memory).
// - TMA.  Q, K and V arrive by cp.async.bulk.tensor in boxes of 32 columns
//   (128 bytes a row, 128-byte swizzle) from 4-D tensor maps (d, L, H, B)
//   over the views' own strides; rows past L and columns past d are
//   zero-filled.  A tensor whose base or strides are off the 16-byte grid is
//   copied by the producers element by element into the same swizzled
//   layout (correct, not fast).
// - The split, by the producers.  TF32 wgmma takes K-major operands only, so
//   V (keys x d_v, d_v contiguous) cannot be read as the bf16 kernels read
//   it.  K and V land raw in a ring of landing zones (one chunk of 128
//   columns x 32 keys each); the producer warpgroup splits each chunk into
//   its big and small halves in a ring of ready slots: K in place of its
//   layout, V transposed to K-major V^T, with the keys of every 8-key group
//   in the order 0,2,4,6,1,3,5,7 (see P below).  Each slot has a `full` and
//   an `empty` mbarrier; the landing zones have a `full` one (the TMA's
//   bytes).  The consumers spend no instruction on K or V.  The landing
//   zones let the loads run ahead of the split: chunks landed in the slots
//   themselves and split in place, each slot's next load issued as it was
//   released, took 16.0 ms against 13.4 at L = 1024 on an NVIDIA H100 80GB
//   HBM3 (PERF.md §6).
// - Q once per block, in its raw layout, scaled by 1/temperature in place;
//   the consumers load their A fragments of each 8-column step from it and
//   split them in registers.  S = Q·K^T is wgmma.m64n32k8 with A in
//   registers: each step's three products (small·K_big, big·K_small,
//   big·K_big) are summed from zero in one of two accumulators, a step in
//   flight while the one before is added to S in IEEE f32.  One
//   accumulator over all of d_k sums 3·d_k/8 times, each sum rounded toward
//   zero: at logits near ±100 that lost to plain_sdpa against float64.
//   Past the shared memory a resident Q leaves (d_k > 512), Q goes through
//   the rings beside K, chunk by chunk, every key tile.
// - O += P·V is wgmma.m64n128k8, P in registers: the S accumulators of an
//   8-key block (lane (g, t) holds keys 2t, 2t+1) are read as the A fragment
//   of a k-step (k-slots t, t + 4), which puts the keys in the order
//   0,2,4,6,1,3,5,7; V^T's slots follow it.  O lives in registers, 128
//   columns (64 registers a thread) a V chunk, two chunks a pass; past d_v
//   = 256 the columns are walked in passes, S recomputed each pass.
// - ptxas serializes every wgmma of a kernel (warnings C7518, C7520) whose
//   products stay in flight across a loop's back edge or a branch, or that
//   waits on a barrier in a loop between writing a product's registers and
//   issuing it.  So each d_k chunk of S ends with nothing in flight, and the
//   V slots are waited for, unrolled, before P and O are written.
// - The bias of a thread's 16 scores is read from device memory (__ldg)
//   once S is complete: held in registers across S, it pushed the
//   consumers past 255 registers.
// - Padding.  Keys past L score -inf (their V^T columns are zero); K and V
//   columns past d are zero, so a k-step past d_k or d_v adds 0; query rows
//   past L are computed and not stored.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns a
// cudaError_t (0 = launched).  ops/cuda_attention.py routes each shape
// (ops/cuda_attention.py::route) and says which tensors TMA may read.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;                    // query rows of a block
constexpr int kKeys = 32;                    // keys of a tile
constexpr int kChunk = 128;                  // columns of a K or V chunk
constexpr int kSlot = 32768;                 // a ready slot
constexpr int kHalf = kSlot / 2;             // its small half's offset
constexpr int kRowBytes = 4 * kBoxColsF32;   // a box row: 32 columns
constexpr int kKBox = kKeys * kRowBytes;     // a box of 32 keys
constexpr int kQBox = kRows * kRowBytes;     // a box of 64 query rows
constexpr int kLandKV = 4 * kKBox;           // a landing zone of K or V
constexpr int kLandQ = 4 * kQBox;            // ... of a Q chunk (streamed)
constexpr int kBarBytes = 256;               // the mbarriers
constexpr int kMaxReady = 6, kMaxLand = 4;
constexpr unsigned kVecQ = 1, kVecK = 2, kVecV = 4;

struct Strides {  // in elements: batch, head and row stride of each tensor
  long long q[3], k[3], v[3], o[3];
};

struct Params {
  const float *q, *k, *v, *bias;
  float* out;
  Strides str;
  int H, L, dk, dv, q_tiles, n_tiles;
  int n_kc;       // 128-column chunks of d_k
  int n_vc;       // ... of d_v
  int n_passes;   // of NVC V chunks
  bool resident;  // Q held for the whole of d_k (else a ring item a chunk)
  int ready, land;  // slots of each ring
  int land_bytes;   // of a landing zone
  int q_bytes;      // of the resident Q region (0 when streamed)
  unsigned tma;     // kVecQ | kVecK | kVecV: the tensors read by TMA
  float inv_temp;
};

enum Kind { kQ, kK, kV };

__device__ __forceinline__ void split4(const float4& x, float4& big,
                                       float4& small) {
  uint32_t b[4], s[4];
  split(x.x, b[0], s[0]);
  split(x.y, b[1], s[1]);
  split(x.z, b[2], s[2]);
  split(x.w, b[3], s[3]);
  big = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                    __uint_as_float(b[2]), __uint_as_float(b[3]));
  small = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                      __uint_as_float(s[2]), __uint_as_float(s[3]));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// The ring items of a block, in the order both warpgroups walk them: for
// each pass of V chunks and each key tile, its d_k chunks (a Q chunk before
// each K chunk when Q is streamed), then the pass's V chunks.
struct Seq {
  int pass = 0, tile = 0, j = 0;
};

__device__ __forceinline__ int k_items(const Params& p) {
  return p.resident ? p.n_kc : 2 * p.n_kc;
}

__device__ __forceinline__ int v_items(const Params& p, int nvc, int pass) {
  return min(nvc, p.n_vc - pass * nvc);
}

__device__ __forceinline__ void advance(const Params& p, int nvc, Seq& s) {
  if (++s.j == k_items(p) + v_items(p, nvc, s.pass)) {
    s.j = 0;
    if (++s.tile == p.n_tiles) {
      s.tile = 0;
      ++s.pass;
    }
  }
}

__device__ __forceinline__ Kind kind_of(const Params& p, const Seq& s) {
  if (s.j >= k_items(p)) return kV;
  return p.resident || (s.j & 1) ? kK : kQ;
}

__device__ __forceinline__ int chunk_of(const Params& p, int nvc,
                                        const Seq& s) {
  if (s.j >= k_items(p)) return s.pass * nvc + s.j - k_items(p);
  return p.resident ? s.j : s.j / 2;
}

// 32-column boxes of a chunk that hold columns below d (at most 4)
__device__ __forceinline__ int boxes(int d, int chunk) {
  return max(0, min(4, (d - kChunk * chunk + kBoxColsF32 - 1) / kBoxColsF32));
}

// ------------------------------------------------------------- producer

// n_boxes boxes of `rows` rows x 32 columns of src (row 0, column `col`)
// into the swizzled layout TMA writes: row r's 16-byte chunk c at chunk
// c ^ (r % 8).  Rows from n_rows on and columns from d on are zero.
__device__ __forceinline__ void copy_boxes(char* dst, const float* src,
                                           long long row_stride, int n_rows,
                                           int col, int d, int n_boxes,
                                           int rows, int pt) {
  const int n = n_boxes * rows * 32;
#pragma unroll 4
  for (int i = pt; i < n; i += kWG) {
    const int box = i / (rows * 32), r = (i >> 5) % rows, c = i & 31;
    const int cc = col + box * 32 + c;
    const float x = r < n_rows && cc < d ? src[r * row_stride + cc] : 0.f;
    *reinterpret_cast<float*>(dst + box * rows * kRowBytes + r * kRowBytes +
                              ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4) = x;
  }
}

// a landed chunk into its ready slot.  K: big and small halves in the
// landing layout.  V: transposed to V^T (128 rows of d_v columns x 32 keys,
// the keys of each 8-key group in the order 0,2,4,6,1,3,5,7), big and small.
// Q (streamed): scaled by 1/temperature.  Boxes from n_boxes on are zero.
__device__ __forceinline__ void prepare(Kind kind, const char* land,
                                        char* slot, int n_boxes,
                                        float inv_temp, int pt) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kind == kK) {
#pragma unroll 4
    for (int off = pt * 16; off < kLandKV; off += kWG * 16) {
      const float4 x = off / kKBox < n_boxes
                           ? *reinterpret_cast<const float4*>(land + off)
                           : zero;
      float4 big, small;
      split4(x, big, small);
      *reinterpret_cast<float4*>(slot + off) = big;
      *reinterpret_cast<float4*>(slot + kHalf + off) = small;
    }
  } else if (kind == kQ) {
#pragma unroll 4
    for (int off = pt * 16; off < kLandQ; off += kWG * 16) {
      float4 x = off / kQBox < n_boxes
                     ? *reinterpret_cast<const float4*>(land + off)
                     : zero;
      x.x *= inv_temp;
      x.y *= inv_temp;
      x.z *= inv_temp;
      x.w *= inv_temp;
      *reinterpret_cast<float4*>(slot + off) = x;
    }
  } else {
    // unit u: 4 columns n = 4nq .. 4nq + 3 x the 4 keys 8G + 2e + h (e =
    // 0..3) that fill slots 4h .. 4h + 3 of key group G; the 8 (G, h) of
    // one nq lie in 8 neighbouring lanes, so their stores fall on 8
    // distinct 16-byte bank groups
#pragma unroll
    for (int u = pt; u < 256; u += kWG) {
      const int gh = u & 7, nq = u >> 3;
      const int G = gh >> 1, h = gh & 1, box = nq >> 3, cc = nq & 7;
      float4 x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * G + 2 * e + h;
        x[e] = box < n_boxes
                   ? *reinterpret_cast<const float4*>(
                         land + box * kKBox + key * kRowBytes +
                         ((cc ^ (key & 7)) << 4))
                   : zero;
      }
      const float4 col[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                             make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                             make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                             make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 4 * nq + i;
        const int off = n * kRowBytes + ((gh ^ (n & 7)) << 4);
        float4 big, small;
        split4(col[i], big, small);
        *reinterpret_cast<float4*>(slot + off) = big;
        *reinterpret_cast<float4*>(slot + kHalf + off) = small;
      }
    }
  }
}

// ------------------------------------------------------------------ kernel

template <int NVC>
__global__ void __launch_bounds__(2 * kWG, 1)
attention_stream_tf32_kernel(const __grid_constant__ Params p,
                             const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv) {
  // the swizzled boxes need 1024-byte alignment; the kernel has no static
  // shared memory, so the dynamic region starts at offset 0 of the block's
  // window, which the declaration's alignment makes certain (checked)
  extern __shared__ __align__(1024) char smem[];
  if (smem_u32(smem) % kAlign) __trap();
  char* const q_res = smem;
  char* const ready = smem + p.q_bytes;
  char* const landing = ready + p.ready * kSlot;
  const uint32_t bar0 = smem_u32(landing + p.land * p.land_bytes);
  // full[s], empty[s] of the ready slots, full[s] of the landing zones, Q's
  auto ready_full = [&](int s) { return bar0 + 8 * s; };
  auto ready_empty = [&](int s) { return bar0 + 8 * (kMaxReady + s); };
  auto land_full = [&](int s) { return bar0 + 8 * (2 * kMaxReady + s); };
  const uint32_t q_bar = bar0 + 8 * (2 * kMaxReady + kMaxLand);

  const int L = p.L;
  const int pair = blockIdx.x / p.q_tiles;
  const int q0 = (blockIdx.x % p.q_tiles) * kRows;
  const int b = pair / p.H, h = pair % p.H;
  const int n_items =
      p.n_passes * p.n_tiles * k_items(p) + p.n_tiles * p.n_vc;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.ready; ++s) {
      mbar_init(ready_full(s), kWG);
      mbar_init(ready_empty(s), kWG);
    }
    for (int s = 0; s < p.land; ++s) mbar_init(land_full(s), 1);
    mbar_init(q_bar, kWG + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWG) {
    // -------------------------------------------------- producer warpgroup
    const int pt = threadIdx.x - kWG;
    const float* const q =
        p.q + b * p.str.q[0] + h * p.str.q[1] + q0 * p.str.q[2];
    const float* const k = p.k + b * p.str.k[0] + h * p.str.k[1];
    const float* const v = p.v + b * p.str.v[0] + h * p.str.v[1];
    if (p.resident) {
      const int n_boxes = (p.dk + kBoxColsF32 - 1) / kBoxColsF32;
      if (pt == 0) {
        const bool t = p.tma & kVecQ;
        mbar_arrive_tx(q_bar, t ? n_boxes * kQBox : 0);
        if (t)
          for (int x = 0; x < n_boxes; ++x)
            tma_box(smem_u32(q_res + x * kQBox), &tq, q_bar,
                    kBoxColsF32 * x, q0, h, b);
      }
      if (!(p.tma & kVecQ))
        copy_boxes(q_res, q, p.str.q[2], L - q0, 0, p.dk, n_boxes, kRows, pt);
      mbar_arrive(q_bar);
    }

    // item `s` into landing zone `zone`: its boxes by TMA, or (copied by
    // the producers when it is read) an empty arrival
    auto issue = [&](const Seq& s, int zone) {
      const Kind kind = kind_of(p, s);
      const int chunk = chunk_of(p, NVC, s);
      const unsigned bit = kind == kQ ? kVecQ : kind == kK ? kVecK : kVecV;
      const uint32_t bar = land_full(zone);
      if (!(p.tma & bit)) {
        mbar_arrive(bar);
        return;
      }
      const int n_boxes = boxes(kind == kV ? p.dv : p.dk, chunk);
      const int box_bytes = kind == kQ ? kQBox : kKBox;
      const CUtensorMap* map = kind == kQ ? &tq : kind == kK ? &tk : &tv;
      const int row = kind == kQ ? q0 : s.tile * kKeys;
      const uint32_t dst = smem_u32(landing + zone * p.land_bytes);
      mbar_arrive_tx(bar, n_boxes * box_bytes);
      for (int x = 0; x < n_boxes; ++x)
        tma_box(dst + x * box_bytes, map, bar,
                kChunk * chunk + kBoxColsF32 * x, row, h, b);
    };

    Seq ahead;
    int n_ahead = 0;
    if (pt == 0)
      for (; n_ahead < min(p.land, n_items); ++n_ahead) {
        issue(ahead, n_ahead);
        advance(p, NVC, ahead);
      }
    Seq cur;
    for (int i = 0; i < n_items; ++i) {
      const int zone = i % p.land, slot = i % p.ready;
      const Kind kind = kind_of(p, cur);
      const int chunk = chunk_of(p, NVC, cur);
      const int d = kind == kV ? p.dv : p.dk;
      const int n_boxes = boxes(d, chunk);
      char* const land = landing + zone * p.land_bytes;
      mbar_wait(land_full(zone), (i / p.land) & 1);
      const unsigned bit = kind == kQ ? kVecQ : kind == kK ? kVecK : kVecV;
      if (!(p.tma & bit)) {
        const int key0 = cur.tile * kKeys;
        if (kind == kQ)
          copy_boxes(land, q, p.str.q[2], L - q0, kChunk * chunk, d, n_boxes,
                     kRows, pt);
        else
          copy_boxes(land,
                     (kind == kK ? k + key0 * p.str.k[2]
                                 : v + key0 * p.str.v[2]),
                     kind == kK ? p.str.k[2] : p.str.v[2], L - key0,
                     kChunk * chunk, d, n_boxes, kKeys, pt);
        producers_sync();
      }
      if (i >= p.ready) mbar_wait(ready_empty(slot), (i / p.ready - 1) & 1);
      prepare(kind, land, ready + slot * kSlot, n_boxes, p.inv_temp, pt);
      fence_async_smem();
      mbar_arrive(ready_full(slot));
      // every producer is done with the landing zone: refill it
      producers_sync();
      if (pt == 0 && n_ahead < n_items) {
        issue(ahead, zone);
        advance(p, NVC, ahead);
        ++n_ahead;
      }
      advance(p, NVC, cur);
    }
    return;
  }

  // ---------------------------------------------------- consumer warpgroup
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // rows r0 and r0 + 8 of the block

  if (p.resident) {
    // Q·(1/temperature) in place; boxes past d_k zeroed
    mbar_wait(q_bar, 0);
    const int live = (p.dk + kBoxColsF32 - 1) / kBoxColsF32 * kQBox;
    for (int off = tid * 16; off < p.q_bytes; off += kWG * 16) {
      float4* const x = reinterpret_cast<float4*>(q_res + off);
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (off < live) {
        y = *x;
        y.x *= p.inv_temp;
        y.y *= p.inv_temp;
        y.z *= p.inv_temp;
        y.w *= p.inv_temp;
      }
      *x = y;
    }
    consumers_sync();
  }

  const float* const bias =
      p.bias ? p.bias + static_cast<long long>(h) * L * L : nullptr;
  const int frag_row = r0 * kRowBytes, frag_swz = r0 & 7;
  int it = 0;  // ring items consumed
  for (int pass = 0; pass < p.n_passes; ++pass) {
    float o[NVC][64];
#pragma unroll
    for (int c = 0; c < NVC; ++c)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[c][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const int nv = min(NVC, p.n_vc - pass * NVC);

    for (int tile = 0; tile < p.n_tiles; ++tile) {
      const int key0 = tile * kKeys;
      // S = Q·K^T in IEEE f32: each 8-column step's three products summed
      // from zero by the tensor core (into one of two accumulators, so that
      // a step is in flight while the one before is added), then added to
      // s.  One accumulator over all of d_k would sum 3·d_k/8 products, each
      // sum rounded toward zero.  Each chunk ends with no product in flight
      // and releases its slots: ptxas serializes every wgmma of a kernel
      // whose products stay in flight across a loop's back edge or a
      // branch.
      float s[16], acc[2][16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = acc[0][i] = acc[1][i] = 0.f;
      uint32_t fb[2][4], fs[2][4];  // each accumulator's A fragments
      for (int c = 0; c < p.n_kc; ++c) {
        const int qi = p.resident ? -1 : it, ki = p.resident ? it : it + 1;
        if (qi >= 0) mbar_wait(ready_full(qi % p.ready), (qi / p.ready) & 1);
        mbar_wait(ready_full(ki % p.ready), (ki / p.ready) & 1);
        const char* const qc =
            p.resident ? q_res + c * 4 * kQBox : ready + (qi % p.ready) * kSlot;
        const uint64_t kd = desc(smem_u32(ready + (ki % p.ready) * kSlot),
                                 16, 1024);
        // this thread's A-fragment words of step kk in a Q box: rows r0 and
        // r0 + 8, columns t and t + 4 (16-byte chunks 2(kk % 4) and + 1)
        auto load_q = [&](float (&a)[4], int kk) {
          const char* const hi = qc + (kk >> 2) * kQBox + frag_row;
          const char* const lo = hi + 8 * kRowBytes;  // row r0 + 8
          const int c0 = ((2 * (kk & 3)) ^ frag_swz) << 4;
          const int c1 = ((2 * (kk & 3) + 1) ^ frag_swz) << 4;
          a[0] = *reinterpret_cast<const float*>(hi + c0 + 4 * t);
          a[1] = *reinterpret_cast<const float*>(lo + c0 + 4 * t);
          a[2] = *reinterpret_cast<const float*>(hi + c1 + 4 * t);
          a[3] = *reinterpret_cast<const float*>(lo + c1 + 4 * t);
        };
        float raw[4];
        load_q(raw, 0);
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          const int set = kk & 1;
          // the step before last, this set's, is done: add it (0 at the
          // chunk's first two steps)
          wgmma_wait<1>();
#pragma unroll
          for (int i = 0; i < 16; ++i) s[i] += acc[set][i];
#pragma unroll
          for (int e = 0; e < 4; ++e) split(raw[e], fb[set][e], fs[set][e]);
          if (kk + 1 < 16) load_q(raw, kk + 1);
          // the step's descriptors: kd plus its offset in 16-byte units
          const uint64_t at = kd + (((kk >> 2) * kKBox + (kk & 3) * 32) >> 4);
          wgmma_fence();
          wgmma_tf32(acc[set], fs[set], at, 0);
          wgmma_tf32(acc[set], fb[set], at + (kHalf >> 4), 1);
          wgmma_tf32(acc[set], fb[set], at, 1);
          wgmma_commit();
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          s[i] = (s[i] + acc[0][i]) + acc[1][i];
          acc[0][i] = acc[1][i] = 0.f;
        }
        for (int x = p.resident ? ki : qi; x <= ki; ++x)
          mbar_arrive(ready_empty(x % p.ready));
        it = ki + 1;
      }
      // the tile's bias; S's accumulator layout: i -> row r0 + 8((i >> 1) &
      // 1), key 8(i >> 2) + 2t + (i & 1)
      float bv[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int row = q0 + r0 + 8 * ((i >> 1) & 1);
        const int key = key0 + 8 * (i >> 2) + 2 * t + (i & 1);
        bv[i] = bias && row < L && key < L
                    ? __ldg(bias + static_cast<long long>(row) * L + key)
                    : 0.f;
      }

      // + bias, -inf past L; the running max and sum
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int key = key0 + 8 * (i >> 2) + 2 * t + (i & 1);
        s[i] = key >= L ? -INFINITY : s[i] + bv[i];
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float base[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = expf(m[r] - base[r]);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s[i] = expf(s[i] - base[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);

      // O += P·V, a V^T chunk of 128 columns a slot.  A pass's chunks past
      // d_v (only its last, at an odd count) reread the first and are not
      // stored.  The slots are waited for, unrolled, before P and O are
      // written: a wait between those writes and the products, or in a
      // loop of runtime length, also serializes every wgmma.  Then O
      // rescaled; P split into A fragments of each 8-key step, keys in the
      // order 0,2,4,6,1,3,5,7.
      int vi[NVC];
#pragma unroll
      for (int c = 0; c < NVC; ++c) {
        vi[c] = it + (c < nv ? c : 0);
        mbar_wait(ready_full(vi[c] % p.ready), (vi[c] / p.ready) & 1);
      }
#pragma unroll
      for (int c = 0; c < NVC; ++c)
#pragma unroll
        for (int i = 0; i < 64; ++i) o[c][i] *= alpha[(i >> 1) & 1];
      uint32_t pb[4][4], ps[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split(s[4 * j + 0], pb[j][0], ps[j][0]);
        split(s[4 * j + 2], pb[j][1], ps[j][1]);
        split(s[4 * j + 1], pb[j][2], ps[j][2]);
        split(s[4 * j + 3], pb[j][3], ps[j][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NVC; ++c) {
        const uint32_t vt = smem_u32(ready + (vi[c] % p.ready) * kSlot);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint64_t vd = desc(vt, 16, 1024) + 2 * j;  // + 32j bytes
          wgmma_tf32(o[c], ps[j], vd, 1);
          wgmma_tf32(o[c], pb[j], vd + (kHalf >> 4), 1);
          wgmma_tf32(o[c], pb[j], vd, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      for (int c = 0; c < nv; ++c) mbar_arrive(ready_empty((it + c) % p.ready));
      it += nv;
    }

    // O / l
    float* const out = p.out + b * p.str.o[0] + h * p.str.o[1];
#pragma unroll
    for (int c = 0; c < NVC; ++c)
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int half = (i >> 1) & 1;
        const int row = q0 + r0 + 8 * half;
        const int col = (pass * NVC + c) * kChunk + 8 * (i >> 2) + 2 * t;
        if (c >= nv || row >= L || col >= p.dv) continue;
        float* const dst = out + row * p.str.o[2] + col;
        const float x0 = o[c][i] / l[half], x1 = o[c][i + 1] / l[half];
        if (col + 1 < p.dv && !(p.dv & 1)) {
          *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
        } else {
          dst[0] = x0;
          if (col + 1 < p.dv) dst[1] = x1;
        }
      }
  }
}

// ------------------------------------------------------------------ host

template <int NVC>
int run(const Params& p, int blocks, size_t smem, const CUtensorMap& tq,
        const CUtensorMap& tk, const CUtensorMap& tv, cudaStream_t stream) {
  auto kernel = attention_stream_tf32_kernel<NVC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, 2 * kWG, smem, stream>>>(p, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}

// the launch geometry of a shape: V chunks a pass, Q resident or streamed,
// the two rings' depths; returns the dynamic shared memory (0: none fits)
size_t plan(Params& p, int L, int dk, int dv, int* nvc) {
  p.q_tiles = (L + kRows - 1) / kRows;
  p.n_tiles = (L + kKeys - 1) / kKeys;
  p.n_kc = (dk + kChunk - 1) / kChunk;
  p.n_vc = (dv + kChunk - 1) / kChunk;
  *nvc = p.n_vc == 1 ? 1 : 2;
  p.n_passes = (p.n_vc + *nvc - 1) / *nvc;
  const int budget = kMaxSmem - kBarBytes;
  // Q resident beside two ready slots and two landing zones; else Q
  // through the rings (4 ready slots at least: a chunk's Q and K and the
  // chunk's before)
  p.q_bytes = p.n_kc * 4 * kQBox;
  p.resident = p.q_bytes + 2 * kSlot + 2 * kLandKV <= budget;
  if (!p.resident) p.q_bytes = 0;
  p.land_bytes = p.resident ? kLandKV : kLandQ;
  const int min_ready = p.resident ? 2 : 4;
  p.ready = min(p.resident ? 4 : kMaxReady,
                (budget - p.q_bytes - 2 * p.land_bytes) / kSlot);
  if (p.ready < min_ready) return 0;
  p.land = min(kMaxLand,
               (budget - p.q_bytes - p.ready * kSlot) / p.land_bytes);
  return static_cast<size_t>(p.q_bytes) + p.ready * kSlot +
         p.land * p.land_bytes + kBarBytes;
}

}  // namespace

// strides: 12 element strides, batch, head and row of q, k, v and out.
// vec: bit 0, 1, 2 set where q, k, v have a 16-byte-aligned base and
// strides, which TMA reads; the others are copied element by element.
extern "C" int lstc_attention_stream_fwd(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         void* out, const long long* strides,
                                         int B, int H, int L, int dk, int dv,
                                         unsigned vec, float temperature,
                                         void* stream) {
  if (B < 1 || H < 1 || L < 1 || dk < 1 || dv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
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
  p.inv_temp = 1.f / temperature;
  int nvc = 0;
  const size_t smem = plan(p, L, dk, dv, &nvc);
  if (!smem) return static_cast<int>(cudaErrorInvalidConfiguration);

  CUtensorMap tq{}, tk{}, tv{};
  p.tma = 0;
  if ((vec & kVecQ) && encode(&tq, q, dk, L, H, B, strides, kRows, 1, true))
    p.tma |= kVecQ;
  if ((vec & kVecK) &&
      encode(&tk, k, dk, L, H, B, strides + 3, kKeys, 1, true))
    p.tma |= kVecK;
  if ((vec & kVecV) &&
      encode(&tv, v, dv, L, H, B, strides + 6, kKeys, 1, true))
    p.tma |= kVecV;
  if ((vec & (kVecQ | kVecK | kVecV)) != p.tma)
    return static_cast<int>(cudaErrorInvalidValue);  // a map was refused

  const long long blocks = static_cast<long long>(B) * H * p.q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(blocks);
  return nvc == 1 ? run<1>(p, n, smem, tq, tk, tv, s)
                  : run<2>(p, n, smem, tq, tk, tv, s);
}

// the launch geometry at L, d_k, d_v: out[0] dynamic shared memory bytes,
// [1] threads a block, [2] query rows a block, [3] ready slots (the ring
// the consumers read), [4] 1 where Q is resident, [5] keys a tile, [6]
// landing zones (the ring TMA fills).  Returns 0, or a cudaError_t where no
// geometry fits.  The geometry is the same with or without a bias
// (with_bias is taken for the bf16 route's signature).
extern "C" int lstc_attention_stream_plan(int L, int dk, int dv,
                                          int /*with_bias*/, int* out) {
  if (L < 1 || dk < 1 || dv < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  int nvc = 0;
  const size_t smem = plan(p, L, dk, dv, &nvc);
  if (!smem) return static_cast<int>(cudaErrorInvalidConfiguration);
  out[0] = static_cast<int>(smem);
  out[1] = 2 * kWG;
  out[2] = kRows;
  out[3] = p.ready;
  out[4] = p.resident;
  out[5] = kKeys;
  out[6] = p.land;
  return 0;
}

extern "C" const char* lstc_cuda_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
