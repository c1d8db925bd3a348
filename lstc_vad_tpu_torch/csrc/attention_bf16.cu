// Fused scaled dot-product attention with an additive bias, for Hopper
// (sm_90a), on bfloat16 operands with f32 accumulation: the bf16 route of the
// attention operator (csrc/attention.cu is the f32 route).
//
//   s   = (q[b,h] / temperature)_bf16 · k[b,h]^T     products exact, sum f32
//   p   = bf16(softmax(s + bias[h]))                 softmax in f32
//   out = bf16(p · v[b,h])                           sum in f32
//
// q, k, v, out: [B, H, L, D] bfloat16 views with a unit innermost stride, a
// 16-byte-aligned base, and batch, head and row strides that are multiples of
// 8 elements (16 bytes): the encoder's projections as they come out of the
// GEMMs, [B, L, H, D] buffers seen through a transpose, and out written into
// such a buffer.  bias: [H, L, L] float32, contiguous, or null; broadcast over
// B.  1 <= L <= 128; D a multiple of 32 up to 256.
//
// Replaces the TPU kernel lstc_vad_tpu/ops/pallas_attention.py::_kernel at
// encoder.compute_dtype="bfloat16": there it takes bf16 q, k, v, accumulates
// both products in f32 (preferred_element_type), rounds the probabilities to
// v's type before P·V and returns q's type.  The scaling q·(1/temperature) is
// an f32 product rounded to bf16, as PyTorch divides a bf16 CUDA tensor by a
// host scalar, so this kernel and ops/attention.py::plain_sdpa round the same
// scaled q.
//
// What bounds it on an H100 SXM.  It must read q, k, v and write out once:
// 8·L·D bytes per (b, h) pair, and the bias once, against 4·L²·D FLOP for
// its two products at the bf16 tensor-core rate (989 TFLOP/s dense).  That is
// L/2 FLOP per byte against the card's 295, so the bytes bound it at every L
// it takes.  At the main path's shape (B=924, H=8, L=49, D=256, bias) the
// bytes take 0.221 ms and the products 0.018 ms.  The [L, L] scores never go
// to device memory.
//
// Design (a first, simple version; wgmma and TMA are later work):
// - Tiling.  Both products run as mma.sync.m16n8k16 bf16 tiles with f32
//   accumulators, one warp per 16 query rows.  Query rows and keys are padded
//   to 16: at L=49 a pair has 4 warps over 64 rows and 64 keys.  One block
//   covers one (b, h) pair; at L <= 32 a block covers 4 or 2 pairs so that it
//   still has 4 warps.  The 16-key-tile count ceil(L/16) is the compile-time
//   instantiation (1..8); D is a runtime count of 32-column chunks.
// - Accuracy.  bf16 products are exact in f32.  Each 16-deep step's products
//   are summed from zero on the tensor core and added to the running sum by an
//   IEEE f32 add, since the tensor core truncates as it accumulates.  The
//   softmax is IEEE f32 in registers (expf, a true division); P is rounded to
//   bf16 to nearest even, as is the output.
// - Staging.  Q and K, then V, stream through shared memory in 32-column
//   D-chunks by 16-byte cp.async.cg copies into a double buffer, as in the f32
//   route.  Rows past L, and all rows of a pair past B·H, are zero-filled by
//   the copy (src-size 0): padded V rows are exactly 0, and padded keys are set
//   to -inf before the row max.  Shared-memory rows are padded from 32 to 40
//   elements (20 words): the fragment loads of Q and K (lane (g, t) reads the
//   word t of row g) then fall on banks 20g + t mod 32, and those of V (rows
//   2t and 2t+1, column g) on distinct banks too.  A stage holds pairs · 32 ·
//   ceil(L/16) rows: 20 KB double-buffered at L=49, 40 KB at L=128.
// - P stays in registers.  The C fragments of key tiles 2j and 2j+1 (lane
//   (g, t): rows g and g+8, keys 2t and 2t+1 of each) are, packed to bf16
//   pairs, exactly the A fragment of the 16-key step j of P·V.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).  The caller picks the pairs per block
// (ops/cuda_attention.py::tile_bf16 holds the table and mirrors the
// shared-memory size below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 32;        // D-columns per pipeline stage
constexpr int kRow = kChunk + 8;  // bf16 elements per shared-memory row
constexpr int kMaxTiles = 8;      // 16-key tiles: L <= 128
constexpr int kMaxD = 256;
constexpr int kStages = 2;        // shared-memory buffers in the pipeline

struct Strides {  // in elements: batch, head and row stride of each tensor
  long long q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b: the products summed from zero, then added in IEEE f32
__device__ __forceinline__ void mma_add(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma(p, a, b);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest kStages - 2 groups have landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// KT: 16-key tiles, ceil(L / 16); a pair has KT warps of 16 query rows; a
// block has pairs_per_block pairs, 4 warps up to L = 64.
template <int KT>
constexpr int block_threads() {
  return KT <= 4 ? 4 * kWarp : KT * kWarp;
}

template <int KT>
__global__ void __launch_bounds__(block_threads<KT>())
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, const Strides str,
                      int n_pairs, int pairs_per_block, int H, int L, int D,
                      float temperature) {
  constexpr int NT = 2 * KT;            // 8-key tiles of S
  constexpr int QROWS = 16 * KT, ROWS = 2 * QROWS;  // Q rows, then K or V
  constexpr int PIECES = kChunk / 8;    // 16-byte copies a row
  extern __shared__ float4 smem4[];
  __nv_bfloat16* const smem = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int stage_elems = pairs_per_block * ROWS * kRow;
  const int n_chunks = D / kChunk;
  const int n_stages = 2 * n_chunks;  // Q and K chunks, then V chunks
  // q·(1/temperature), as PyTorch scales a CUDA tensor by a host scalar
  const float inv_temp = 1.f / temperature;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column
  const int slot = warp / KT;             // the block's pair of this warp
  const int m0 = (warp % KT) * 16;        // its 16 query rows
  const int pair_id = blockIdx.x * pairs_per_block + slot;
  const bool live = pair_id < n_pairs;
  const long long b = live ? pair_id / H : 0, h = live ? pair_id % H : 0;

  // Stage s < n_chunks: columns [32s, 32s + 32) of Q into rows [0, QROWS) and
  // of K into rows [QROWS, ROWS); stage n_chunks + c: columns [32c, 32c + 32)
  // of V into rows [QROWS, ROWS).  Thread i copies 16 bytes at column
  // 8·(i % 4) of rows i/4, i/4 + blockDim/4, ...; rows [n_valid, n_rows) are
  // padding, zero-filled from no source.
  const int copy_row = threadIdx.x / PIECES, copy_step = blockDim.x / PIECES;
  const int copy_col = (threadIdx.x % PIECES) * 8;
  auto copy_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                       long long row_stride, int n_rows, int n_valid) {
    int r = copy_row;
    dst += r * kRow;
    src += r * row_stride;
    for (; r < n_valid; r += copy_step) {
      cp_async16(dst, src, true);
      dst += copy_step * kRow;
      src += copy_step * row_stride;
    }
    for (; r < n_rows; r += copy_step) {
      cp_async16(dst, q, false);
      dst += copy_step * kRow;
    }
  };
  auto load = [&](int s, __nv_bfloat16* buf) {
    const bool is_v = s >= n_chunks;
    const int col = (is_v ? s - n_chunks : s) * kChunk + copy_col;
    for (int p = 0; p < pairs_per_block; ++p) {
      const int pr = blockIdx.x * pairs_per_block + p;
      const bool pr_live = pr < n_pairs;
      const long long pb = pr_live ? pr / H : 0, ph = pr_live ? pr % H : 0;
      const int n_valid = pr_live ? L : 0;
      __nv_bfloat16* const dst = buf + p * ROWS * kRow + copy_col;
      if (is_v) {
        copy_rows(dst + QROWS * kRow, v + pb * str.v[0] + ph * str.v[1] + col,
                  str.v[2], QROWS, n_valid);
      } else {
        copy_rows(dst, q + pb * str.q[0] + ph * str.q[1] + col, str.q[2],
                  QROWS, n_valid);
        copy_rows(dst + QROWS * kRow, k + pb * str.k[0] + ph * str.k[1] + col,
                  str.k[2], QROWS, n_valid);
      }
    }
  };

  // s[j]: C fragment of key tile j; lane (g, t) holds rows m0+g (s[j][0..1])
  // and m0+g+8 (s[j][2..3]) at keys 8j+2t and 8j+2t+1.  Scores, then P.
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // P as bf16 pairs: the A fragment of 16-key step j of P·V
  uint32_t p[KT][4];

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages) load(st, smem + st * stage_elems);
    cp_async_commit();
  }
  for (int stage = 0; stage < n_stages; ++stage) {
    cp_async_wait();
    // the stage has landed for every thread, and every warp is done with the
    // buffer computed in the previous iteration, which the next copy reuses
    __syncthreads();
    const int ahead = stage + kStages - 1;
    if (ahead < n_stages) load(ahead, smem + (ahead % kStages) * stage_elems);
    cp_async_commit();
    const __nv_bfloat16* tile =
        smem + (stage % kStages) * stage_elems + slot * ROWS * kRow;
    const __nv_bfloat16* kv = tile + QROWS * kRow;

    if (stage < n_chunks) {
      // S += (Q / temperature)[:, chunk] · K[:, chunk]^T
      const __nv_bfloat16* qs = tile + m0 * kRow;
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 16) {
        uint32_t a[4];
        a[0] = scale_bf16(word(qs + g * kRow + kk + 2 * t), inv_temp);
        a[1] = scale_bf16(word(qs + (g + 8) * kRow + kk + 2 * t), inv_temp);
        a[2] = scale_bf16(word(qs + g * kRow + kk + 2 * t + 8), inv_temp);
        a[3] = scale_bf16(word(qs + (g + 8) * kRow + kk + 2 * t + 8),
                          inv_temp);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat16* kr = kv + (8 * j + g) * kRow + kk + 2 * t;
          const uint32_t bw[2] = {word(kr), word(kr + 8)};
          mma_add(s[j], a, bw);
        }
      }

      if (stage == n_chunks - 1) {
        // + bias, -inf at padded keys, the row softmax in f32, P to bf16
        const float* bias_h = bias ? bias + h * L * L : nullptr;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + g + (e >> 1) * 8;
            const int key = 8 * j + 2 * t + (e & 1);
            if (key >= L)
              s[j][e] = -INFINITY;
            else if (bias_h && row < L)
              s[j][e] += __ldg(bias_h + row * L + key);
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = expf(s[j][e] - mx[e >> 1]);
            sum[e >> 1] += s[j][e];
          }
        sum[0] = quad_sum(sum[0]);
        sum[1] = quad_sum(sum[1]);
#pragma unroll
        for (int jj = 0; jj < KT; ++jj) {
          const float(&lo)[4] = s[2 * jj];
          const float(&hi)[4] = s[2 * jj + 1];
          p[jj][0] = pack_bf16(lo[0] / sum[0], lo[1] / sum[0]);  // row g
          p[jj][1] = pack_bf16(lo[2] / sum[1], lo[3] / sum[1]);  // row g+8
          p[jj][2] = pack_bf16(hi[0] / sum[0], hi[1] / sum[0]);  // keys +8
          p[jj][3] = pack_bf16(hi[2] / sum[1], hi[3] / sum[1]);
        }
      }
    } else {
      // O[:, chunk] = P · V[:, chunk]
      float o[kChunk / 8][4];
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n)
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) {
        const __nv_bfloat16* vr = kv + (16 * jj + 2 * t) * kRow + g;
#pragma unroll
        for (int n = 0; n < kChunk / 8; ++n) {
          const __nv_bfloat16* c = vr + 8 * n;
          const uint32_t bw[2] = {pair(c, c + kRow),
                                  pair(c + 8 * kRow, c + 9 * kRow)};
          mma_add(o[n], p[jj], bw);
        }
      }
      if (live) {
        const int col = (stage - n_chunks) * kChunk + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + g + 8 * half;
          if (row >= L) continue;
          __nv_bfloat16* dst =
              out + b * str.o[0] + h * str.o[1] + row * str.o[2] + col;
#pragma unroll
          for (int n = 0; n < kChunk / 8; ++n)
            *reinterpret_cast<uint32_t*>(dst + 8 * n) =
                pack_bf16(o[n][2 * half], o[n][2 * half + 1]);
        }
      }
    }
  }
}

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  const float* bias;
  __nv_bfloat16* out;
  Strides str;
  int n_pairs, pairs_per_block, H, L, D;
  float temperature;
};

template <int KT>
int launch(const Args& a, cudaStream_t stream) {
  // keep in step with ops/cuda_attention.py::tile_bf16
  const size_t smem = kStages * sizeof(__nv_bfloat16) *
                      static_cast<size_t>(a.pairs_per_block) * 32 * KT *
                      kRow;
  const int threads = a.pairs_per_block * KT * kWarp;
  if (threads > block_threads<KT>())
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bf16_kernel<KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>(
      (a.n_pairs + a.pairs_per_block - 1) / a.pairs_per_block);
  attention_bf16_kernel<KT><<<grid, threads, smem, stream>>>(
      a.q, a.k, a.v, a.bias, a.out, a.str, a.n_pairs, a.pairs_per_block, a.H,
      a.L, a.D, a.temperature);
  return static_cast<int>(cudaGetLastError());
}

using Launcher = int (*)(const Args&, cudaStream_t);
constexpr Launcher kLaunchers[kMaxTiles] = {launch<1>, launch<2>, launch<3>,
                                            launch<4>, launch<5>, launch<6>,
                                            launch<7>, launch<8>};

}  // namespace

// strides: 12 element strides, batch, head and row of q, k, v and out
extern "C" int lstc_attention_bf16_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* out, const long long* strides,
                                       int B, int H, int L, int D,
                                       int pairs_per_block, float temperature,
                                       void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > 16 * kMaxTiles || D < kChunk ||
      D > kMaxD || D % kChunk || pairs_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const __nv_bfloat16*>(q),
         static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v),
         static_cast<const float*>(bias),
         static_cast<__nv_bfloat16*>(out),
         {},
         B * H,
         pairs_per_block,
         H,
         L,
         D,
         temperature};
  for (int i = 0; i < 3; ++i) {
    a.str.q[i] = strides[i];
    a.str.k[i] = strides[3 + i];
    a.str.v[i] = strides[6 + i];
    a.str.o[i] = strides[9 + i];
  }
  return kLaunchers[(L + 15) / 16 - 1](a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* lstc_cuda_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
