// Streaming scaled dot-product attention with an additive bias, for Hopper
// (sm_90a): every shape the attention operator takes that csrc/attention.cu
// (f32) and csrc/attention_bf16.cu (bf16) do not, in both routes.
//
//   out[b,h] = softmax(q[b,h] · k[b,h]^T / temperature + bias[h]) · v[b,h]
//
// q, k: [B, H, L, d_k]; v: [B, H, L, d_v]; out: [B, H, L, d_v], all float32
// (the f32 route) or all bfloat16 (the bf16 route), views with a unit
// innermost stride and any other strides.  bias: [H, L, L] float32,
// contiguous, or null; broadcast over B.  Any L >= 1, d_k >= 1, d_v >= 1.
//
// Replaces the TPU kernel lstc_vad_tpu/ops/pallas_attention.py::_kernel
// (launched by _forward, entry pallas_sdpa) at the shapes the other two
// kernels do not take: parts longer than 128 tokens, d_k != d_v, and head
// widths that are not a multiple of 32 up to 256.  Like them it computes the
// function, not the TPU kernel's block-diagonal packing (at such L that
// kernel packs one pair a block anyway).  Its arithmetic is theirs:
// - f32: both products in f32-accurate 3xTF32 on mma.sync.m16n8k8 (each
//   operand split x = big + small, small·big + big·small + big·big, each
//   step summed from zero and added in IEEE f32), q·(1/temperature) in f32;
// - bf16: mma.sync.m16n8k16 bf16 with f32 sums, q·(1/temperature) rounded to
//   bf16, P rounded to bf16 before P·V, the output rounded to bf16;
// the softmax in IEEE f32 (expf, a true division) in both.
//
// What bounds it on an H100 SXM.  It must read q, k, v and write out once:
// L·(2·d_k + 2·d_v)·itemsize bytes a (b, h) pair, and the bias once, against
// 2·L²·(d_k + d_v) FLOP for its two products.  In f32 (3xTF32, 165 f32-
// accurate TFLOP/s against 3.35 TB/s, 49 FLOP a byte) the bytes bound it up
// to L ~ 197 and the products past that; in bf16 (989 TFLOP/s, 295 FLOP a
// byte against L/2 a byte) the bytes bound it up to L ~ 590.
//
// Design: a simple streaming kernel, right at every shape; its speed is
// later work (wgmma, TMA, persistent blocks).
// - Blocks.  One block of 4 warps takes 64 query rows of one (b, h) pair,
//   16 rows a warp; a pair has ceil(L/64) blocks, adjacent in the grid so
//   that they find its K and V in L2.
// - Keys in tiles of 64, so that no register array grows with L.  Two
//   passes over the key tiles.  Pass 1 computes each tile's scores and keeps
//   each row's running max m and sum of exp l (the sum rescaled when the max
//   grows).  Pass 2 computes each tile's scores again, forms the final
//   probabilities p = exp(s - m) / l, as plain_sdpa's softmax forms them, and
//   accumulates P·V.  The second Q·K^T is the price of rounding the same
//   probabilities as plain_sdpa (the bf16 route rounds P to bf16 before
//   P·V, so P must be final when it is rounded), and it is cheap while the
//   bytes bound the kernel.
// - O in column blocks.  O of 16 rows x 128 columns a warp lives in
//   registers (64 a thread) across the key tiles; d_v is walked in blocks of
//   128 columns, pass 2 running once for each, so any d_v fits.  Pass 1
//   runs once.
// - Staging.  Every operand goes through shared memory in 32-column chunks:
//   a stage holds 64 rows of Q and 64 rows of K (a score chunk), or 64 rows
//   of V (an output chunk).  The stages form one sequence (stage() below
//   decodes it), double-buffered: one stage's copies are in flight while the
//   previous stage is computed.  A tensor whose base, batch, head and row
//   strides and width are all multiples of 16 bytes is copied by 16-byte
//   cp.async.cg; any other by 4-byte cp.async.ca (f32) or 2-byte loads
//   (bf16), since the encoder's views of [B, L, H·d] buffers have row stride
//   H·d, which 16 bytes need not divide.  Rows past L and columns past d are
//   zero-filled: padded keys are set to -inf before the max, padded V rows
//   are exactly 0, padded query rows are computed and never stored, and the
//   zero columns add nothing to Q·K^T.
// - Shared memory rows padded to 36 floats or 40 bf16 (the fragment loads
//   fall on 32 distinct banks, as in the other two kernels): 36 KB (f32) or
//   20 KB (bf16) a block, double-buffered.  Registers: launch bounds of 2
//   blocks of 128 threads an SM at least; chip_smoke.py prints ptxas's count.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).  ops/cuda_attention.py routes each shape
// (ops/cuda_attention.py::route) and picks the copy width of each tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kRows = 16 * kWarps;  // query rows of a block; keys of a tile
constexpr int kNT = kRows / 8;      // 8-key tiles of a key tile's scores
constexpr int kChunk = 32;          // columns of a stage
constexpr int kVBlock = 128;        // output columns held in registers
constexpr int kVChunks = kVBlock / kChunk;
constexpr unsigned kVecQ = 1, kVecK = 2, kVecV = 4;  // 16-byte copies

struct Strides {  // in elements: batch, head and row stride of each tensor
  long long q[3], k[3], v[3], o[3];
};

template <typename T>
struct Args {
  const T *q, *k, *v;
  const float* bias;
  T* out;
  Strides str;
  int H, L, dk, dv, q_tiles;
  unsigned vec;
  float temperature;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------ f32 route

// x rounded to TF32, to nearest with ties away from zero (csrc/attention.cu)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
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
__device__ __forceinline__ void mma3(float* d, const uint32_t (&a_big)[4],
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

struct F32 {
  using T = float;
  static constexpr int kRow = kChunk + 4;  // floats a shared-memory row
  static constexpr int kVec = 4;           // elements in 16 bytes

  // an element copy for a tensor that 16-byte copies do not fit
  static __device__ __forceinline__ void copy1(T* dst, const T* src,
                                               bool valid) {
    cp_async4(dst, src, valid);
  }

  // s[j] += (Q / temperature)[16 rows of qs, chunk] · K[8j .. 8j+8, chunk]^T
  static __device__ __forceinline__ void scores(const T* qs, const T* ks,
                                                float (&s)[kNT][4],
                                                float inv_temp) {
    const int g = (threadIdx.x % kWarp) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 8) {
      uint32_t a_big[4], a_small[4];
      split(qs[g * kRow + kk + t] * inv_temp, a_big[0], a_small[0]);
      split(qs[(g + 8) * kRow + kk + t] * inv_temp, a_big[1], a_small[1]);
      split(qs[g * kRow + kk + t + 4] * inv_temp, a_big[2], a_small[2]);
      split(qs[(g + 8) * kRow + kk + t + 4] * inv_temp, a_big[3],
            a_small[3]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t b_big[2], b_small[2];
        const T* kr = ks + (8 * j + g) * kRow + kk + t;
        split(kr[0], b_big[0], b_small[0]);
        split(kr[4], b_big[1], b_small[1]);
        mma3(s[j], a_big, a_small, b_big, b_small);
      }
    }
  }

  // o[n] += P · V[keys, 8n .. 8n+8 of the chunk], n < 4; P's C fragments
  // read as A fragments with each 8-key tile's keys in the order
  // 0,2,4,6,1,3,5,7, and V's rows read in the same order (csrc/attention.cu)
  static __device__ __forceinline__ void values(const T* vs,
                                                const float (&p)[kNT][4],
                                                float (*o)[4]) {
    const int g = (threadIdx.x % kWarp) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      uint32_t a_big[4], a_small[4];
      split(p[j][0], a_big[0], a_small[0]);
      split(p[j][2], a_big[1], a_small[1]);
      split(p[j][1], a_big[2], a_small[2]);
      split(p[j][3], a_big[3], a_small[3]);
      const T* vr = vs + (8 * j + 2 * t) * kRow + g;
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n) {
        uint32_t b_big[2], b_small[2];
        split(vr[8 * n], b_big[0], b_small[0]);
        split(vr[kRow + 8 * n], b_big[1], b_small[1]);
        mma3(o[n], a_big, a_small, b_big, b_small);
      }
    }
  }

  static __device__ __forceinline__ T out(float x) { return x; }
};

// ----------------------------------------------------------- bf16 route

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(p[0]), "+f"(p[1]), "+f"(p[2]), "+f"(p[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

// two floats to a bf16 pair, each rounded to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a bf16 pair scaled by s in f32 and rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16(uint32_t w, float s) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return pack_bf16(f.x * s, f.y * s);
}

__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from two rows of one column: lo from a, hi from b
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* a,
                                         const __nv_bfloat16* b) {
  const uint16_t lo = *reinterpret_cast<const uint16_t*>(a);
  const uint16_t hi = *reinterpret_cast<const uint16_t*>(b);
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

struct BF16 {
  using T = __nv_bfloat16;
  static constexpr int kRow = kChunk + 8;  // bf16 a shared-memory row
  static constexpr int kVec = 8;

  static __device__ __forceinline__ void copy1(T* dst, const T* src,
                                               bool valid) {
    *reinterpret_cast<uint16_t*>(dst) =
        valid ? *reinterpret_cast<const uint16_t*>(src) : uint16_t{0};
  }

  static __device__ __forceinline__ void scores(const T* qs, const T* ks,
                                                float (&s)[kNT][4],
                                                float inv_temp) {
    const int g = (threadIdx.x % kWarp) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      uint32_t a[4];
      a[0] = scale_bf16(word(qs + g * kRow + kk + 2 * t), inv_temp);
      a[1] = scale_bf16(word(qs + (g + 8) * kRow + kk + 2 * t), inv_temp);
      a[2] = scale_bf16(word(qs + g * kRow + kk + 2 * t + 8), inv_temp);
      a[3] = scale_bf16(word(qs + (g + 8) * kRow + kk + 2 * t + 8),
                        inv_temp);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const T* kr = ks + (8 * j + g) * kRow + kk + 2 * t;
        const uint32_t bw[2] = {word(kr), word(kr + 8)};
        mma_bf16(s[j], a, bw);
      }
    }
  }

  // P rounded to bf16: the C fragments of 8-key tiles 2jj and 2jj+1 packed
  // to pairs are the A fragment of 16-key step jj (csrc/attention_bf16.cu)
  static __device__ __forceinline__ void values(const T* vs,
                                                const float (&p)[kNT][4],
                                                float (*o)[4]) {
    const int g = (threadIdx.x % kWarp) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int jj = 0; jj < kNT / 2; ++jj) {
      const float(&lo)[4] = p[2 * jj];
      const float(&hi)[4] = p[2 * jj + 1];
      const uint32_t a[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                             pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3])};
      const T* vr = vs + (16 * jj + 2 * t) * kRow + g;
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n) {
        const T* c = vr + 8 * n;
        const uint32_t bw[2] = {pair(c, c + kRow),
                                pair(c + 8 * kRow, c + 9 * kRow)};
        mma_bf16(o[n], a, bw);
      }
    }
  }

  static __device__ __forceinline__ T out(float x) {
    return __float2bfloat16_rn(x);
  }
};

// ---------------------------------------------------------------- kernel

// Stage i of a block's sequence: pass 1, for each key tile, the score
// chunks of Q and K; then for each 128-column block of d_v, for each key
// tile, the score chunks again and that block's V chunks of the tile.
struct Stage {
  bool values;  // V rows; else Q and K rows
  int tile;     // key tile
  int col;      // first column
};

__device__ __forceinline__ int v_chunks(int dv, int block) {
  return min(kVChunks, (dv - block * kVBlock + kChunk - 1) / kChunk);
}

__device__ __forceinline__ Stage stage(int i, int n_tiles, int n_chunks,
                                       int dv) {
  const int pass1 = n_tiles * n_chunks;
  if (i < pass1) return {false, i / n_chunks, (i % n_chunks) * kChunk};
  i -= pass1;
  const int block = i / (n_tiles * (n_chunks + kVChunks));
  i -= block * n_tiles * (n_chunks + kVChunks);
  const int per_tile = n_chunks + v_chunks(dv, block);
  const int tile = i / per_tile, x = i % per_tile;
  if (x < n_chunks) return {false, tile, x * kChunk};
  return {true, tile, block * kVBlock + (x - n_chunks) * kChunk};
}

// kRows rows x kChunk columns from src (row 0, column 0 of the tile) into
// dst; rows from n_rows on and columns from n_cols on are zero
template <class R>
__device__ __forceinline__ void copy_tile(typename R::T* dst,
                                          const typename R::T* src,
                                          long long row_stride, int n_rows,
                                          int col, int n_cols, bool vec) {
  using T = typename R::T;
  if (vec) {
    constexpr int kPieces = kChunk / R::kVec;
#pragma unroll
    for (int i = threadIdx.x; i < kRows * kPieces; i += kThreads) {
      const int r = i / kPieces, c = (i % kPieces) * R::kVec;
      const bool valid = r < n_rows && col + c < n_cols;
      cp_async16(dst + r * R::kRow + c,
                 valid ? src + r * row_stride + col + c : src, valid);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i % kChunk;
      const bool valid = r < n_rows && col + c < n_cols;
      R::copy1(dst + r * R::kRow + c,
               valid ? src + r * row_stride + col + c : src, valid);
    }
  }
}

template <class R>
__global__ void __launch_bounds__(kThreads, 2)
attention_stream_kernel(const Args<typename R::T> a) {
  using T = typename R::T;
  constexpr int kStageElems = 2 * kRows * R::kRow;  // Q rows, then K or V
  extern __shared__ float4 smem4[];
  T* const smem = reinterpret_cast<T*>(smem4);

  const int L = a.L;
  const int pair_id = blockIdx.x / a.q_tiles;
  const int q0 = (blockIdx.x % a.q_tiles) * kRows;
  const long long b = pair_id / a.H, h = pair_id % a.H;
  const T* const q = a.q + b * a.str.q[0] + h * a.str.q[1] + q0 * a.str.q[2];
  const T* const k = a.k + b * a.str.k[0] + h * a.str.k[1];
  const T* const v = a.v + b * a.str.v[0] + h * a.str.v[1];
  const float* const bias =
      a.bias ? a.bias + static_cast<long long>(h) * L * L : nullptr;
  // q·(1/temperature), as PyTorch scales a CUDA tensor by a host scalar
  const float inv_temp = 1.f / a.temperature;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;  // this warp's query rows in the block
  const int n_tiles = (L + kRows - 1) / kRows;
  const int n_chunks = (a.dk + kChunk - 1) / kChunk;
  const int n_blocks = (a.dv + kVBlock - 1) / kVBlock;
  const int n_stages = n_tiles * n_chunks * (1 + n_blocks) +
                       n_tiles * ((a.dv + kChunk - 1) / kChunk);

  auto load = [&](int i) {
    T* const buf = smem + (i & 1) * kStageElems;
    const Stage s = stage(i, n_tiles, n_chunks, a.dv);
    const int key0 = s.tile * kRows;
    if (s.values) {
      copy_tile<R>(buf + kRows * R::kRow, v + key0 * a.str.v[2], a.str.v[2],
                   L - key0, s.col, a.dv, a.vec & kVecV);
    } else {
      copy_tile<R>(buf, q, a.str.q[2], L - q0, s.col, a.dk, a.vec & kVecQ);
      copy_tile<R>(buf + kRows * R::kRow, k + key0 * a.str.k[2], a.str.k[2],
                   L - key0, s.col, a.dk, a.vec & kVecK);
    }
  };
  int next = 0;  // the stage the next call of acquire() returns
  // The stage `next` has landed for every thread, and every warp is done
  // with the buffer of the stage before it, which the copies of stage
  // next + 1, issued here, reuse.
  auto acquire = [&]() -> const T* {
    cp_async_wait_all();
    __syncthreads();
    if (next + 1 < n_stages) load(next + 1);
    cp_async_commit();
    return smem + (next++ & 1) * kStageElems;
  };

  // this key tile's scores of the warp's rows: + bias, -inf at padded keys
  float s[kNT][4];
  auto tile_scores = [&](int tile) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const T* buf = acquire();
      R::scores(buf + m0 * R::kRow, buf + kRows * R::kRow, s, inv_temp);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + m0 + g + (e >> 1) * 8;
        const int key = tile * kRows + 8 * j + 2 * t + (e & 1);
        if (key >= L)
          s[j][e] = -INFINITY;
        else if (bias && row < L)
          s[j][e] += __ldg(bias + static_cast<long long>(row) * L + key);
      }
  };

  load(0);
  cp_async_commit();

  // pass 1: each row's max and sum of exp (rows g and g+8 of the warp)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int tile = 0; tile < n_tiles; ++tile) {
    tile_scores(tile);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(m[r], quad_max(mx[r]));
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(s[j][e] - mx[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * expf(m[r] - mx[r]) + quad_sum(sum[r]);
      m[r] = mx[r];
    }
  }

  // pass 2, for each 128-column block of d_v: P·V over the key tiles
  for (int block = 0; block < n_blocks; ++block) {
    const int n_v = v_chunks(a.dv, block);
    float o[kVChunks * 4][4];
#pragma unroll
    for (int n = 0; n < kVChunks * 4; ++n)
      o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    for (int tile = 0; tile < n_tiles; ++tile) {
      tile_scores(tile);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = expf(s[j][e] - m[e >> 1]) / l[e >> 1];
#pragma unroll
      for (int c = 0; c < kVChunks; ++c)
        if (c < n_v) {
          const T* buf = acquire();
          R::values(buf + kRows * R::kRow, s, o + 4 * c);
        }
    }
#pragma unroll
    for (int n = 0; n < kVChunks * 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + m0 + g + (e >> 1) * 8;
        const int col = block * kVBlock + 8 * n + 2 * t + (e & 1);
        if (row < L && col < a.dv)
          a.out[b * a.str.o[0] + h * a.str.o[1] + row * a.str.o[2] + col] =
              R::out(o[n][e]);
      }
  }
}

template <class R>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, const long long* strides, int B, int H, int L, int dk,
           int dv, unsigned vec, float temperature, cudaStream_t stream) {
  using T = typename R::T;
  Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const float*>(bias),
            static_cast<T*>(out), {}, H, L, dk, dv, (L + kRows - 1) / kRows,
            vec, temperature};
  for (int i = 0; i < 3; ++i) {
    a.str.q[i] = strides[i];
    a.str.k[i] = strides[3 + i];
    a.str.v[i] = strides[6 + i];
    a.str.o[i] = strides[9 + i];
  }
  const long long blocks = static_cast<long long>(B) * H * a.q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * 2 * kRows * R::kRow * sizeof(T);
  attention_stream_kernel<R><<<static_cast<unsigned>(blocks), kThreads, smem,
                               stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: 0 for float32 q, k, v, out; 1 for bfloat16.  strides: 12 element
// strides, batch, head and row of q, k, v and out.  vec: bit 0, 1, 2 set
// where q, k, v may be copied 16 bytes at a time.
extern "C" int lstc_attention_stream_fwd(int bf16, const void* q,
                                         const void* k, const void* v,
                                         const void* bias, void* out,
                                         const long long* strides, int B,
                                         int H, int L, int dk, int dv,
                                         unsigned vec, float temperature,
                                         void* stream) {
  if (B < 1 || H < 1 || L < 1 || dk < 1 || dv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16>(q, k, v, bias, out, strides, B, H, L, dk, dv,
                             vec, temperature, s)
              : launch<F32>(q, k, v, bias, out, strides, B, H, L, dk, dv, vec,
                            temperature, s);
}

extern "C" const char* lstc_cuda_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
