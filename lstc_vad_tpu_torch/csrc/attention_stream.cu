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
// Its arithmetic is the tiled kernel's: both products in f32-accurate 3xTF32
// on mma.sync.m16n8k8 (each operand split x = big + small, small·big +
// big·small + big·big, each 8-deep step summed from zero and added in IEEE
// f32), q·(1/temperature) in f32, the softmax in IEEE f32 (expf, a true
// division).
//
// What bounds it on an H100 SXM.  It must read q, k, v and write out once,
// L·(2·d_k + 2·d_v)·4 bytes a (b, h) pair, and the bias once, against
// 2·L²·(d_k + d_v) FLOP.  In 3xTF32 (165 f32-accurate TFLOP/s against 3.35
// TB/s, 49 FLOP a byte against L/4) the bytes bound it up to L ~ 197 and the
// products past that.
//
// Design, and what each part does about that bound:
// - One pass, online softmax.  A block walks the keys in tiles of 32; each
//   row keeps a running max and sum, O and the sum are scaled by
//   exp(m_old - m_new) when a tile raises the max, and O is divided by the
//   sum once at the end.  P is never rounded in this route, so Q·K^T is
//   computed once per (query tile, key tile).
// - Warps.  A row group of 16 query rows has G = ceil(d_v / 64) warps (up
//   to 16; past d_v = 1024 the columns are walked in passes of 1024).  Each
//   warp holds O for 64 of the d_v columns (32 f32 registers a thread).
//   Q·K^T is split along d_k: warp cg of the group takes the 8-column
//   k-steps kk with kk % G == cg for all 32 keys of the tile, the group's
//   warps add their partial scores through shared memory (one barrier a
//   tile, the same order in every warp), and each warp then holds the
//   tile's whole scores: its own softmax, its own P in registers.  So each
//   warp reads 1/G of Q's fragments a tile, where shared-memory bandwidth
//   is what the loop spends most (PERF.md §6).  A block has R row
//   groups, up to 16 warps in all (64 query rows at d_v = 256).
// - Q once per block.  The block's 16·R rows of Q are loaded once (whole
//   mma fragments a thread, 16 loads in flight), scaled by 1/temperature,
//   split into TF32 big and small halves and held in shared memory in
//   fragment order for every key tile.  Past the shared memory that leaves
//   (d_k beyond ~1300 at R = 1), Q is split in chunks of 128 columns beside
//   the K stages instead, double-buffered.
// - K and V through a cp.async ring of 3-6 stages (as many as the shared
//   memory left holds).  A K stage is 32 keys x 128 columns; a V stage is
//   32 keys x 32·G columns (16·G past 8 warps a row group), 32 (16) for
//   each warp.  Each stage waits for its own cp.async group only
//   (wait_group S - 2) and one __syncthreads.  16-byte copies where a
//   tensor's base, strides and width allow, else 4-byte; rows past L and
//   columns past d are zero-filled; padded keys are set to -inf; key tiles
//   past the last valid key skip their mma.  The bias of a thread's 16
//   scores is read from device memory while the tile's last K stage is
//   computed.
// - P in the key order 0,2,4,6,1,3,5,7 (lane (g, t)'s C fragment of 8-key
//   tile j read as an A fragment), with V's rows read in the same order
//   (csrc/attention.cu); shared-memory rows padded to 4 floats past a
//   multiple of 32, so the fragment loads of K (row g, column t) and of V
//   (row 2t, column g) fall on 32 banks.
// - What is left.  Altered builds timed on the card
//   (scripts/torch_stream_ablation.py, PERF.md §6): no one part bounds
//   it (the Q·K^T loop about a quarter of the time, the products, the Q
//   fill, the stage barriers each under a sixth); it runs at a small
//   fraction of the issue rate on chains of shared loads, splits and
//   mma.sync.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns a
// cudaError_t (0 = launched).  ops/cuda_attention.py routes each shape
// (ops/cuda_attention.py::route) and picks the copy width of each tensor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kKeys = 32;        // keys of a tile
constexpr int kNT = kKeys / 8;   // 8-key mma tiles of a key tile
constexpr int kKCols = 128;      // K columns of a stage
constexpr int kWarpCols = 64;    // O columns a warp holds
constexpr int kMaxG = 16;        // warps a row group
constexpr int kMaxWarps = 16;    // warps a block
constexpr int kMinStages = 3, kMaxStages = 6;
constexpr int kMaxSmem = 232448;
constexpr unsigned kVecK = 2, kVecV = 4;  // 16-byte copies of k, v

struct Strides {  // in elements: batch, head and row stride of each tensor
  long long q[3], k[3], v[3], o[3];
};

struct Params {
  const float *q, *k, *v, *bias;
  float* out;
  Strides str;
  int H, L, dk, dv;
  int G, R;        // warps a row group, row groups a block
  int q_tiles;     // blocks a pair
  int n_kc;        // K stages a key tile (64 columns each)
  int n_vc;        // V stages a key tile and pass (<= kVChunks)
  int n_passes;    // of kVChunks V stages
  int stage_cols;  // floats a stage row holds, less its padding
  bool resident;   // Q split once for the whole of d_k
  int stages;      // of the cp.async ring
  unsigned vec;
  float inv_temp;
};

// x rounded to TF32, to nearest with ties away from zero (csrc/attention.cu)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b in 3xTF32: the three products summed from zero, then added to d
// in IEEE f32 (the tensor core truncates as it accumulates)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4],
                                     const uint32_t (&b_big)[2],
                                     const uint32_t (&b_small)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, a_small, b_big);
  mma_tf32(p, a_big, b_small);
  mma_tf32(p, a_big, b_big);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest stages - 2 has landed
__device__ __forceinline__ void cp_async_wait_older(int stages) {
  switch (stages) {
    case 3: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory");
  }
}

// WS: the V columns a warp takes of a stage (32 up to 8 warps a row group,
// 16 past that, so that a V stage stays 256 columns wide)
template <int WS>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
attention_stream_kernel(const Params p) {
  constexpr int kWarpStage = WS;
  constexpr int kVChunks = kWarpCols / kWarpStage;  // V stages a tile
  extern __shared__ float4 smem4[];
  const int L = p.L, G = p.G, R = p.R, S = p.stages;
  const int VW = kWarpStage * G;   // V columns of a stage: 16 a warp
  const int row_f = p.stage_cols + 4;  // floats a stage row
  const int rows = 16 * R;         // query rows of the block
  const int pair = blockIdx.x / p.q_tiles;
  const int q0 = (blockIdx.x % p.q_tiles) * rows;
  const long long b = pair / p.H, h = pair % p.H;
  const float* const q = p.q + b * p.str.q[0] + h * p.str.q[1];
  const float* const k = p.k + b * p.str.k[0] + h * p.str.k[1];
  const float* const v = p.v + b * p.str.v[0] + h * p.str.v[1];
  const float* const bias =
      p.bias ? p.bias + static_cast<long long>(h) * L * L : nullptr;

  // shared memory: Q split (fragment order: per row group and 8-column
  // k-step, 32 lanes' big halves then 32 lanes' small halves, a uint4
  // each), each warp's partial scores (16 a lane), then the ring of
  // stages, each a [32 x row_f] tile of K or V
  const int q_cols = p.resident ? p.n_kc * kKCols : 2 * kKCols;
  const int q_steps = q_cols / 8;
  constexpr int k_steps = kKCols / 8;
  uint4* const qsplit = reinterpret_cast<uint4*>(smem4);
  float* const xs = reinterpret_cast<float*>(qsplit + R * q_steps * 64);
  float* const ring = xs + R * G * 16 * 32;
  const int stage_f = kKeys * row_f;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / G, cg = warp % G;  // row group, column warp
  const int n_tiles = (L + kKeys - 1) / kKeys;
  const int per_tile = p.n_kc + p.n_vc;
  const int n_stages = p.n_passes * n_tiles * per_tile;

  // Q's columns [col, col + kKCols·n) of the block's rows, scaled and split
  // into fragments at `dst` (n·kKCols/8 k-steps a row group): a thread
  // builds whole fragments, 4 at a time, 16 loads in flight
  auto fill_q = [&](uint4* dst, int col, int steps) {
    const int total = R * steps * 32;
    for (int f0 = threadIdx.x; f0 < total; f0 += 4 * blockDim.x) {
      float x[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = f0 + u * blockDim.x;
        const int ln = f & 31, step = (f >> 5) % steps, r = f / (32 * steps);
        const int row = q0 + r * 16 + (ln >> 2);
        const int cc = col + step * 8 + (ln & 3);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = row + (e & 1) * 8, c = cc + (e >> 1) * 4;
          x[u][e] = f < total && rr < L && c < p.dk
                        ? q[rr * p.str.q[2] + c]
                        : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = f0 + u * blockDim.x;
        if (f >= total) break;
        uint32_t big[4], small[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(x[u][e] * p.inv_temp, big[e], small[e]);
        uint4* const frag = dst + (f >> 5) * 64 + (f & 31);
        frag[0] = make_uint4(big[0], big[1], big[2], big[3]);
        frag[32] = make_uint4(small[0], small[1], small[2], small[3]);
      }
    }
  };

  // the copies of stage i of the sequence (pass, key tile, K or V chunk)
  auto load = [&](int i) {
    float* const buf = ring + (i % S) * stage_f;
    const int x = i % per_tile, tile = (i / per_tile) % n_tiles;
    const int pass = i / (per_tile * n_tiles);
    const int key0 = tile * kKeys;
    const bool is_k = x < p.n_kc;
    const float* const src = is_k ? k : v;
    const long long stride = is_k ? p.str.k[2] : p.str.v[2];
    const int d = is_k ? p.dk : p.dv;
    const int width = is_k ? kKCols : VW;
    const int col = is_k ? x * kKCols : (pass * kVChunks + x - p.n_kc) * VW;
    if (p.vec & (is_k ? kVecK : kVecV)) {
      const int pieces = width / 4;
      for (int e = threadIdx.x; e < kKeys * pieces; e += blockDim.x) {
        const int r = e / pieces, c = (e % pieces) * 4;
        const bool valid = key0 + r < L && col + c < d;
        cp_async16(buf + r * row_f + c,
                   valid ? src + (key0 + r) * stride + col + c : src, valid);
      }
    } else {
      for (int e = threadIdx.x; e < kKeys * width; e += blockDim.x) {
        const int r = e / width, c = e % width;
        const bool valid = key0 + r < L && col + c < d;
        cp_async4(buf + r * row_f + c,
                  valid ? src + (key0 + r) * stride + col + c : src, valid);
      }
    }
  };

  // S - 1 stages in flight, then Q (plain loads) while they land
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();
  }
  fill_q(qsplit, 0, p.resident ? q_steps : k_steps);
  int next = 0;  // the stage acquire() returns
  // stage `next` has landed for every thread and every warp is done with
  // the buffer of the stage before it, which the copies issued here reuse
  auto acquire = [&]() -> const float* {
    cp_async_wait_older(S);
    __syncthreads();
    if (next + S - 1 < n_stages) load(next + S - 1);
    cp_async_commit();
    return ring + (next++ % S) * stage_f;
  };

  int k_seq = 0;  // K stages so far, for the streamed Q's double buffer
  for (int pass = 0; pass < p.n_passes; ++pass) {
    float o[kVChunks][kWarpStage / 8][4];
#pragma unroll
    for (int c = 0; c < kVChunks; ++c)
#pragma unroll
      for (int n = 0; n < kWarpStage / 8; ++n)
        o[c][n][0] = o[c][n][1] = o[c][n][2] = o[c][n][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int tile = 0; tile < n_tiles; ++tile) {
      const int key0 = tile * kKeys;
      const int valid_nt = min(kNT, (L - key0 + 7) / 8);
      // the scores of every 8-key tile over this warp's k-steps (kk % G ==
      // cg): the row group's warps split Q·K^T along d_k
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      float bv[kNT][4];
      for (int c = 0; c < p.n_kc; ++c, ++k_seq) {
        const float* const buf = acquire();
        if (c == p.n_kc - 1) {
          // the tile's bias, read while the last K stage is computed
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = q0 + rg * 16 + g + (e >> 1) * 8;
              const int key = key0 + 8 * j + 2 * t + (e & 1);
              bv[j][e] = bias && row < L && key < L
                             ? __ldg(bias + static_cast<long long>(row) * L +
                                     key)
                             : 0.f;
            }
        }
        const uint4* qf;
        if (p.resident) {
          qf = qsplit + (rg * q_steps + c * k_steps) * 64;
        } else {
          // this chunk's Q sits in buffer k_seq % 2; split the next one
          qf = qsplit + ((k_seq & 1) * R + rg) * k_steps * 64;
          fill_q(qsplit + ((k_seq + 1) & 1) * R * k_steps * 64,
                 ((c + 1) % p.n_kc) * kKCols, k_steps);
        }
        for (int kk = cg; kk < k_steps; kk += G) {
          const uint4 qb = qf[kk * 64 + lane], qs = qf[kk * 64 + 32 + lane];
          const uint32_t a_big[4] = {qb.x, qb.y, qb.z, qb.w};
          const uint32_t a_small[4] = {qs.x, qs.y, qs.z, qs.w};
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            if (j < valid_nt) {
              const float* kr = buf + (8 * j + g) * row_f + kk * 8 + t;
              uint32_t b_big[2], b_small[2];
              split(kr[0], b_big[0], b_small[0]);
              split(kr[4], b_big[1], b_small[1]);
              mma3(s[j], a_big, a_small, b_big, b_small);
            }
        }
      }
      if (G > 1) {
        // the partial scores summed over the row group's warps, in the
        // same order in every warp
        float* const mine = xs + (rg * G + cg) * 16 * 32 + lane;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = s[j][e];
        __syncthreads();
        const float* const group = xs + rg * G * 16 * 32 + lane;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = 0.f;
            for (int w = 0; w < G; ++w) x += group[(w * 16 + 4 * j + e) * 32];
            s[j][e] = x;
          }
      }

      // + bias, -inf past L; the running max and sum; O rescaled; P split
      // in the key order 0,2,4,6,1,3,5,7 (csrc/attention.cu)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * j + 2 * t + (e & 1);
          s[j][e] = key >= L ? -INFINITY : s[j][e] + bv[j][e];
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float base[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = expf(m[r] - base[r]);
        m[r] = m_new;
      }
      uint32_t p_big[kNT][4], p_small[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - base[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
        split(s[j][0], p_big[j][0], p_small[j][0]);
        split(s[j][2], p_big[j][1], p_small[j][1]);
        split(s[j][1], p_big[j][2], p_small[j][2]);
        split(s[j][3], p_big[j][3], p_small[j][3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
      for (int c = 0; c < kVChunks; ++c)
#pragma unroll
        for (int n = 0; n < kWarpStage / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[c][n][e] *= alpha[e >> 1];

      // O[chunk c] += P · V[chunk c, this warp's columns]
#pragma unroll
      for (int c = 0; c < kVChunks; ++c)
        if (c < p.n_vc) {
          const float* const vs = acquire() + cg * kWarpStage;
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            if (j < valid_nt) {
              const float* const vr = vs + (8 * j + 2 * t) * row_f + g;
#pragma unroll
              for (int n = 0; n < kWarpStage / 8; ++n) {
                uint32_t b_big[2], b_small[2];
                split(vr[8 * n], b_big[0], b_small[0]);
                split(vr[row_f + 8 * n], b_big[1], b_small[1]);
                mma3(o[c][n], p_big[j], p_small[j], b_big, b_small);
              }
            }
        }
    }

    // O / l
    float* const out = p.out + b * p.str.o[0] + h * p.str.o[1];
#pragma unroll
    for (int c = 0; c < kVChunks; ++c)
#pragma unroll
      for (int n = 0; n < kWarpStage / 8; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = q0 + rg * 16 + g + 8 * half;
          const int col =
              (pass * kVChunks + c) * VW + cg * kWarpStage + 8 * n + 2 * t;
          if (c >= p.n_vc || row >= L || col >= p.dv) continue;
          float* const dst = out + row * p.str.o[2] + col;
          const float x0 = o[c][n][2 * half] / l[half];
          const float x1 = o[c][n][2 * half + 1] / l[half];
          if (col + 1 < p.dv && !(p.dv & 1)) {
            *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
          } else {
            dst[0] = x0;
            if (col + 1 < p.dv) dst[1] = x1;
          }
        }
  }
}

// the launch geometry of a shape: warps, row groups, Q resident or
// streamed, ring depth; returns the dynamic shared memory (0: none fits)
// and the V columns a warp takes of a stage in *ws
size_t plan(Params& p, int L, int dk, int dv, int* ws) {
  p.G = min(kMaxG, (dv + kWarpCols - 1) / kWarpCols);
  *ws = p.G <= kMaxG / 2 ? 32 : 16;
  const int v_chunks = kWarpCols / *ws;
  const int VW = *ws * p.G;
  p.stage_cols = max(kKCols, VW);
  p.n_kc = (dk + kKCols - 1) / kKCols;
  const int vc = (dv + VW - 1) / VW;
  p.n_vc = min(v_chunks, vc);
  p.n_passes = (vc + v_chunks - 1) / v_chunks;

  // as many row groups as make 16 warps (no more than L needs) with Q
  // resident beside 3 stages, else one row group with Q split in chunks
  // beside K; then as many stages as fit, up to 6
  auto bytes = [&](int R, bool resident, int stages) {
    const int q_cols = resident ? p.n_kc * kKCols : 2 * kKCols;
    return static_cast<size_t>(4) *
           (16 * R * q_cols * 2 + R * p.G * 16 * 32 +
            stages * kKeys * (p.stage_cols + 4));
  };
  p.R = max(1, min(kMaxWarps / p.G, (L + 15) / 16));
  p.resident = true;
  while (p.R > 1 && bytes(p.R, true, kMinStages) > kMaxSmem) --p.R;
  if (bytes(p.R, true, kMinStages) > kMaxSmem) p.resident = false;
  p.stages = kMinStages;
  while (p.stages < kMaxStages &&
         bytes(p.R, p.resident, p.stages + 1) <= kMaxSmem)
    ++p.stages;
  p.q_tiles = (L + 16 * p.R - 1) / (16 * p.R);
  const size_t smem = bytes(p.R, p.resident, p.stages);
  return smem <= kMaxSmem ? smem : 0;
}

}  // namespace

// strides: 12 element strides, batch, head and row of q, k, v and out.
// vec: bit 1, 2 set where k, v may be copied 16 bytes at a time (bit 0,
// q's, is not read: Q is loaded once, by plain loads).
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
  p.vec = vec;
  p.inv_temp = 1.f / temperature;
  int ws = 0;
  const size_t smem = plan(p, L, dk, dv, &ws);
  if (!smem) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = static_cast<long long>(B) * H * p.q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ws == 32 ? attention_stream_kernel<32>
                         : attention_stream_kernel<16>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), p.R * p.G * kWarp, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the launch geometry at L, d_k, d_v: out[0] dynamic shared memory bytes,
// [1] threads a block, [2] query rows a block, [3] ring stages, [4] 1 where
// Q is resident.  Returns 0, or a cudaError_t where no geometry fits.  The
// stages keep room for the bias tile with or without a bias (with_bias is
// taken for the bf16 route's signature).
extern "C" int lstc_attention_stream_plan(int L, int dk, int dv,
                                          int /*with_bias*/, int* out) {
  if (L < 1 || dk < 1 || dv < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  int ws = 0;
  const size_t smem = plan(p, L, dk, dv, &ws);
  if (!smem) return static_cast<int>(cudaErrorInvalidConfiguration);
  out[0] = static_cast<int>(smem);
  out[1] = p.R * p.G * kWarp;
  out[2] = 16 * p.R;
  out[3] = p.stages;
  out[4] = p.resident;
  return 0;
}

extern "C" const char* lstc_cuda_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
