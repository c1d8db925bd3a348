// Fused scaled dot-product attention with an additive bias, for Hopper
// (sm_90a), on the tensor cores in f32-accurate 3xTF32.
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
// 128x128 matrix unit; the packing is a layout for that unit only, so this
// kernel computes the function and not the packing.
//
// What bounds it on an H100 SXM.  It must read q, k, v and write out once:
// 16·L·D bytes per (b, h) pair, against 4·L²·D FLOP for its two products, so
// L/4 FLOP per byte.  In 3xTF32 the tensor cores give 495/3 = 165 f32-accurate
// TFLOP/s; over 3.35 TB/s that is 49 FLOP per byte, so the kernel is bound by
// the bytes at every L it takes (L <= 128 < 197).  At the main path's shape
// (B=924, H=8, L=49, D=256, bias) the bytes take 0.443 ms and the products
// 0.11 ms.  The [L, L] scores never go to device memory.
//
// Design, and what each part does about that bound:
// - Tiling.  Both products run as mma.sync.m16n8k8 TF32 tensor-core tiles,
//   one warp per 16 query rows.  Query rows are padded to 16 per warp and keys
//   to 8: at L=49 a pair has 4 warps over 64 rows and 56 keys.  One block
//   covers one (b, h) pair; at L <= 32 a block covers 4 or 2 pairs so that it
//   still has 4 warps.  The key-tile count ceil(L/8) is the compile-time
//   instantiation (1..16); D is a runtime count of 32-column chunks.
// - f32 accuracy.  Each operand is split x = big + small with big = tf32(x)
//   and small = tf32(x - big), and every product accumulates
//   small·big + big·small + big·big in f32 (CUTLASS's OpMultiplyAddFastF32).
//   The dropped small·small term and what neither half keeps are about
//   2^-22 |x|, near f32's own rounding.  Single-pass TF32 keeps 11 bits and
//   is not used.  Each 8-deep step's three products are summed from zero on
//   the tensor core and added to the running sum by an IEEE f32 add, since
//   the tensor core truncates as it accumulates.  The rounding to TF32 is
//   two integer instructions.  The softmax is IEEE f32 in registers: expf,
//   a true division, row max and sum across the 4 lanes of an mma quad.
// - Staging.  Q and K, then V, stream through shared memory in 32-column
//   D-chunks by 16-byte cp.async.cg copies into a double buffer, so one
//   chunk's copies overlap the previous chunk's products; S accumulates in
//   registers over the chunks, and each chunk of O is stored as it completes.
//   Rows past L, and all rows of a pair past B·H, are zero-filled by the
//   copy (src-size 0): nothing past a tensor is read, padded V rows are
//   exactly 0, and padded keys are set to -inf before the row max.  Padded
//   query rows are computed and never stored.  Shared-memory rows are padded
//   from 32 to 36 floats: the fragment loads of Q and K (lane (g, t) reads
//   row g, column t) then fall on banks 4g + t, and those of V (row 2t,
//   column g) on banks 8t + g, 32 different banks each.  A stage holds
//   pairs · (16·ceil(L/16) + 8·ceil(L/8)) rows: 34.5 KB double-buffered at
//   L=49, so 6 blocks fit on an SM by shared memory, 72 KB at L=128.
// - P stays in registers.  Lane (g, t) holds the scores of keys 8j+2t and
//   8j+2t+1 of its rows g and g+8 as the C fragment of key tile j.  Read as
//   the A fragment of P·V, they stand at k = t and k = t+4 if the tile's keys
//   are taken in the order 0,2,4,6,1,3,5,7; V's B fragment is read in the
//   same order (rows 2t and 2t+1), so the sum is unchanged and P needs no
//   shuffle and no shared tile.
// - What is left.  On the card the kernel stays short of the bytes bound
//   because of instruction issue, not the tensor cores or the bytes: a 3xTF32
//   step is 2 shared loads, 10 instructions of splitting, 3 mma and 4 adds,
//   and each warp splits all of K and V itself.  PERF.md has the numbers.
//
// The encoder's GEMMs (projections, FFN, head) stay nn.Linear on cuBLAS, as
// the JAX package left them to XLA.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).  The caller picks the pairs per block
// (ops/cuda_attention.py::tile holds the table and mirrors the shared-memory
// size below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 32;         // D-columns per pipeline stage
constexpr int kRow = kChunk + 4;   // floats per shared-memory row
constexpr int kMaxKeyTiles = 16;   // L <= 128
constexpr int kMaxD = 256;
constexpr int kStages = 2;         // shared-memory buffers in the pipeline

struct Strides {  // in elements: batch, head and row stride of each tensor
  long long q[3], k[3], v[3], o[3];
};

// x rounded to TF32, to nearest with ties away from zero: what
// cvt.rna.tf32.f32 gives, in 2 integer instructions where ptxas lowers the
// cvt to 4 with a guard for inf and NaN (which this form also carries
// through: the mantissa add cannot turn either into a finite value).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b in 3xTF32, the small cross terms first.  The three products go
// into a zeroed fragment that is then added to d in IEEE f32: the tensor
// core's own accumulation truncates, and over many steps into a large
// running sum its error drifts one way (1e-4 on the output at logits ~±100).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4],
                                     const uint32_t (&b_big)[2],
                                     const uint32_t (&b_small)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma(p, a_small, b_big);
  mma(p, a_big, b_small);
  mma(p, a_big, b_big);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

// NT: key tiles of 8, ceil(L / 8).  A pair has MT = ceil(NT / 2) warps of 16
// query rows; a block has pairs_per_block pairs, 4 warps up to L = 64.
template <int NT>
constexpr int block_threads() {
  return NT <= 4 ? 4 * kWarp : (NT + 1) / 2 * kWarp;
}

// Registers are capped for the blocks an SM holds: 6 (24 warps, as many as
// shared memory allows) at L = 49..64, the SHT LTN length; 4 below, where 80
// registers a thread would spill; 2 above, where uncapped ptxas takes up to
// 255 a thread at L = 81 and leaves 1 block of 6 warps on an SM.
template <int NT>
__global__ void __launch_bounds__(block_threads<NT>(),
                                  NT <= 6 ? 4 : NT <= 8 ? 6 : 2)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     float* __restrict__ out, const Strides str, int n_pairs,
                     int pairs_per_block, int H, int L, int D,
                     float temperature) {
  constexpr int MT = (NT + 1) / 2;
  constexpr int QROWS = 16 * MT, ROWS = QROWS + 8 * NT;  // Q rows, then K or V
  constexpr int PIECES = kChunk / 4;  // 16-byte copies a row
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int stage_floats = pairs_per_block * ROWS * kRow;
  const int n_chunks = D / kChunk;
  const int n_stages = 2 * n_chunks;  // Q and K chunks, then V chunks
  // q·(1/temperature), as PyTorch scales a CUDA tensor by a host scalar
  const float inv_temp = 1.f / temperature;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column
  const int slot = warp / MT;             // the block's pair of this warp
  const int m0 = (warp % MT) * 16;        // its 16 query rows
  const int pair = blockIdx.x * pairs_per_block + slot;
  const bool live = pair < n_pairs;
  const long long b = live ? pair / H : 0, h = live ? pair % H : 0;

  // Stage s < n_chunks: columns [32s, 32s + 32) of Q into rows [0, QROWS) and
  // of K into rows [QROWS, ROWS); stage n_chunks + c: columns [32c, 32c + 32)
  // of V into rows [QROWS, ROWS).  Thread i copies 16 bytes at column
  // 4·(i % 8) of rows i/8, i/8 + blockDim/8, ...; rows [n_valid, n_rows)
  // are padding, zero-filled from no source.
  const int copy_row = threadIdx.x / PIECES, copy_step = blockDim.x / PIECES;
  const int copy_col = (threadIdx.x % PIECES) * 4;
  auto copy_rows = [&](float* dst, const float* src, long long row_stride,
                       int n_rows, int n_valid) {
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
  auto load = [&](int s, float* buf) {
    const bool is_v = s >= n_chunks;
    const int col = (is_v ? s - n_chunks : s) * kChunk + copy_col;
    for (int p = 0; p < pairs_per_block; ++p) {
      const int pr = blockIdx.x * pairs_per_block + p;
      const bool pr_live = pr < n_pairs;
      const long long pb = pr_live ? pr / H : 0, ph = pr_live ? pr % H : 0;
      const int n_valid = pr_live ? L : 0;
      float* const dst = buf + p * ROWS * kRow + copy_col;
      if (is_v) {
        copy_rows(dst + QROWS * kRow, v + pb * str.v[0] + ph * str.v[1] + col,
                  str.v[2], ROWS - QROWS, n_valid);
      } else {
        copy_rows(dst, q + pb * str.q[0] + ph * str.q[1] + col, str.q[2],
                  QROWS, n_valid);
        copy_rows(dst + QROWS * kRow, k + pb * str.k[0] + ph * str.k[1] + col,
                  str.k[2], ROWS - QROWS, n_valid);
      }
    }
  };

  // s[j]: C fragment of key tile j; lane (g, t) holds rows m0+g (s[j][0..1])
  // and m0+g+8 (s[j][2..3]) at keys 8j+2t and 8j+2t+1.  Scores, then P.
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

  // kStages - 1 stages in flight ahead of the one computed; one group per
  // stage, empty ones at the end, so that the wait stays uniform
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load(s, smem + s * stage_floats);
    cp_async_commit();
  }
  for (int stage = 0; stage < n_stages; ++stage) {
    cp_async_wait();
    // the stage has landed for every thread, and every warp is done with the
    // buffer computed in the previous iteration, which the next copy reuses
    __syncthreads();
    const int ahead = stage + kStages - 1;
    if (ahead < n_stages) load(ahead, smem + (ahead % kStages) * stage_floats);
    cp_async_commit();
    const float* tile =
        smem + (stage % kStages) * stage_floats + slot * ROWS * kRow;
    const float* kv = tile + QROWS * kRow;

    if (stage < n_chunks) {
      // S += (Q / temperature)[:, chunk] · K[:, chunk]^T
      const float* qs = tile + m0 * kRow;
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 8) {
        uint32_t a_big[4], a_small[4];
        split(qs[g * kRow + kk + t] * inv_temp, a_big[0], a_small[0]);
        split(qs[(g + 8) * kRow + kk + t] * inv_temp, a_big[1], a_small[1]);
        split(qs[g * kRow + kk + t + 4] * inv_temp, a_big[2], a_small[2]);
        split(qs[(g + 8) * kRow + kk + t + 4] * inv_temp, a_big[3],
              a_small[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b_big[2], b_small[2];
          const float* kr = kv + (8 * j + g) * kRow + kk + t;
          split(kr[0], b_big[0], b_small[0]);
          split(kr[4], b_big[1], b_small[1]);
          mma3(s[j], a_big, a_small, b_big, b_small);
        }
      }

      if (stage == n_chunks - 1) {
        // + bias, -inf at padded keys, then the row softmax in f32
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
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] / sum[e >> 1];
      }
    } else {
      // O[:, chunk] = P · V[:, chunk], keys of each tile in the order
      // 0,2,4,6,1,3,5,7 on both sides
      float o[kChunk / 8][4];
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n)
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t a_big[4], a_small[4];
        split(s[j][0], a_big[0], a_small[0]);  // row g,   key 2t   -> k = t
        split(s[j][2], a_big[1], a_small[1]);  // row g+8, key 2t   -> k = t
        split(s[j][1], a_big[2], a_small[2]);  // row g,   key 2t+1 -> k = t+4
        split(s[j][3], a_big[3], a_small[3]);  // row g+8, key 2t+1 -> k = t+4
        const float* vr = kv + (8 * j + 2 * t) * kRow + g;
#pragma unroll
        for (int n = 0; n < kChunk / 8; ++n) {
          uint32_t b_big[2], b_small[2];
          split(vr[8 * n], b_big[0], b_small[0]);
          split(vr[kRow + 8 * n], b_big[1], b_small[1]);
          mma3(o[n], a_big, a_small, b_big, b_small);
        }
      }
      if (live) {
        const int col = (stage - n_chunks) * kChunk + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + g + 8 * half;
          if (row >= L) continue;
          float* dst = out + b * str.o[0] + h * str.o[1] + row * str.o[2] + col;
#pragma unroll
          for (int n = 0; n < kChunk / 8; ++n)
            *reinterpret_cast<float2*>(dst + 8 * n) =
                make_float2(o[n][2 * half], o[n][2 * half + 1]);
        }
      }
    }
  }
}

struct Args {
  const float *q, *k, *v, *bias;
  float* out;
  Strides str;
  int n_pairs, pairs_per_block, H, L, D;
  float temperature;
};

template <int NT>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int MT = (NT + 1) / 2;
  // keep in step with ops/cuda_attention.py::tile
  const size_t smem = kStages * sizeof(float) *
                      static_cast<size_t>(a.pairs_per_block) *
                      (16 * MT + 8 * NT) * kRow;
  const int threads = a.pairs_per_block * MT * kWarp;
  if (threads > block_threads<NT>())
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>(
      (a.n_pairs + a.pairs_per_block - 1) / a.pairs_per_block);
  attention_fwd_kernel<NT><<<grid, threads, smem, stream>>>(
      a.q, a.k, a.v, a.bias, a.out, a.str, a.n_pairs, a.pairs_per_block, a.H,
      a.L, a.D, a.temperature);
  return static_cast<int>(cudaGetLastError());
}

using Launcher = int (*)(const Args&, cudaStream_t);
constexpr Launcher kLaunchers[kMaxKeyTiles] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
    launch<13>, launch<14>, launch<15>, launch<16>};

}  // namespace

// strides: 12 element strides, batch, head and row of q, k, v and out
extern "C" int lstc_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* out,
                                  const long long* strides, int B, int H,
                                  int L, int D, int pairs_per_block,
                                  float temperature, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > 8 * kMaxKeyTiles || D < kChunk ||
      D > kMaxD || D % kChunk || pairs_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(bias),
         static_cast<float*>(out), {}, B * H, pairs_per_block, H, L, D,
         temperature};
  for (int i = 0; i < 3; ++i) {
    a.str.q[i] = strides[i];
    a.str.k[i] = strides[3 + i];
    a.str.v[i] = strides[6 + i];
    a.str.o[i] = strides[9 + i];
  }
  return kLaunchers[(L + 7) / 8 - 1](a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* lstc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
