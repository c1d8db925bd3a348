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
// summed in f32, q·(1/temperature) rounded to bf16, the softmax in IEEE f32
// (expf, a true division), P rounded to bf16 before P·V, the output rounded
// to bf16.
//
// What bounds it on an H100 SXM.  It must read q, k, v and write out once,
// L·(2·d_k + 2·d_v)·2 bytes a (b, h) pair, and the bias once, against
// 2·L²·(d_k + d_v) FLOP; at 989 bf16 TFLOP/s over 3.35 TB/s (295 FLOP a byte
// against L/2) the bytes bound it up to L ~ 590 and the products past that.
//
// Design, and what each part does about that bound:
// - Blocks.  A block takes 64 query rows of one (b, h) pair and walks the
//   keys in tiles of KEYS = 64, or 32 past one tile of 64 at d_v <= 256.
//   One producer warpgroup fills a ring of 1-2 stages in shared memory; one
//   or two consumer warpgroups compute.  Each stage has a `full` mbarrier
//   (the producer's copies have landed) and an `empty` one (every consumer
//   thread is done with it).  The producers hand all but 40 of their
//   registers to the consumers (setmaxnreg).
// - The softmax, and why two phases past one key tile.  With one key tile
//   (L <= 64) the kernel computes S, the row max and sum, P = exp(s - m) / l
//   rounded to bf16, and P·V in one pass.  With more, phase 0 walks the key
//   tiles for S alone (no V traffic) and keeps each row's running max m and
//   sum l (l rescaled when the max grows); phase 1 walks them again,
//   recomputes S and forms P = exp(s - m) / l exactly as plain_sdpa forms
//   it before rounding it to bf16.  A one-pass online softmax (exp(s - m)
//   rounded unnormalised, O rescaled, divided by l at the end) is closer to
//   float64 on average (tests/test_torch_stream_numerics.py), but on the
//   card it came out 1.14x plain_sdpa's distance from float64 at one
//   shape of the card tests (L = 129, d_k 48, d_v 24), past the 1.05 bar,
//   because it rounds other values than plain_sdpa; the two-phase order
//   rounds the same ones (1.00x at every shape).
// - TMA.  Q, K and V arrive by cp.async.bulk.tensor in 64-row x 64-column
//   boxes (128 bytes a row, 128-byte swizzle), from 4-D tensor maps (d, L,
//   H, B) over the views' own strides, so the encoder's strided views of
//   [B, L, H, d] buffers are read in place; rows past L and columns past d
//   are zero-filled by the hardware.  The maps are encoded in the launcher
//   through cudaGetDriverEntryPoint (no -lcuda).  The TMA, mbarrier and
//   wgmma helpers live in csrc/hopper.cuh, shared with attention_bf16.cu.  A tensor whose base or
//   strides are not multiples of 16 bytes is copied by the producers
//   element by element into the same swizzled layout (correct, not fast).
// - Q once per block.  Q's boxes land once in a resident region; the
//   consumers scale it by 1/temperature in place (rounding to bf16) and
//   hold it for every key tile and both phases.  Past the shared memory a
//   resident Q leaves (d_k beyond ~768 at d_v 256), Q is streamed in chunks
//   of d_k beside K instead, and each chunk is scaled where it lands.
// - wgmma.  S = Q·K^T is wgmma.m64n{KEYS}k16 with both operands in shared
//   memory (K-major, 128-byte swizzle descriptors), f32 sums.  O += P·V is
//   wgmma.m64n64k16 with P as the A operand in registers (the S accumulators
//   re-packed to bf16 pairs: an accumulator quad of two 8-key column blocks
//   is exactly the A fragment of a 16-key step) and V from shared memory
//   MN-major (the descriptor's transpose bit).
// - O in registers.  A consumer warpgroup holds 64 rows x up to 256 columns
//   of O (up to 128 f32 registers a thread, NB 64-column blocks).  At d_v in
//   (256, 512] two consumer warpgroups each take half the columns and each
//   compute S, in parallel.  Past 512 the columns are walked in passes of
//   512 (S recomputed a pass).
// - The bias tile [64 rows x KEYS keys] f32 comes into the stage by 4-byte
//   cp.async from the producers (completion signalled on the stage's
//   mbarrier by cp.async.mbarrier.arrive), stored with its 8-float groups
//   XOR-swizzled by row so that the consumers' float2 reads are free of
//   bank conflicts.
// - Occupancy over depth.  The launcher takes the first layout that fits:
//   32-key tiles in two stages with two blocks an SM (at d 256 that is 112
//   KB a block), then 64-key tiles in two stages, then one, two blocks an
//   SM; then one block of two stages, or one.  Two blocks with a shallow
//   ring beat one with a deep one: each block's consumers then overlap the
//   other's softmax and copies (scripts/torch_stream_ablation.py, PERF.md
//   §6).  The kernel has no static shared memory, so its dynamic region
//   is 1024-byte aligned without slack.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns a
// cudaError_t (0 = launched).  ops/cuda_attention.py routes each shape
// (ops/cuda_attention.py::route) and says which tensors TMA may read.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;               // query rows of a block (wgmma M)
constexpr int kPairSmem = 115712;       // of each of two blocks on an SM
constexpr unsigned kVecQ = 1, kVecK = 2, kVecV = 4;

struct Strides {  // in elements: batch, head and row stride of each tensor
  long long q[3], k[3], v[3], o[3];
};

struct Params {
  const __nv_bfloat16 *q, *k, *v;
  const float* bias;
  __nv_bfloat16* out;
  Strides str;
  int H, L, dk, dv, q_tiles;
  unsigned tma;    // kVecQ | kVecK | kVecV: the tensors read by TMA
  int stages;      // of the ring
  int chunk_boxes; // 64-column boxes of d_k a stage holds
  int n_chunks;    // stages a key tile's Q·K^T takes; 1 = Q resident
  int v_boxes;     // 64-column boxes of V a pass (all consumer warpgroups)
  int n_passes;    // of v_boxes·64 output columns
  int q_res;       // bytes of the resident Q region (0 when streamed)
  int stage_bytes, k_off, q_off, v_off, bias_off;
  int keys;        // of a tile: 64, or 32 (the kernel's KEYS)
  float inv_temp;
};

// ------------------------------------------------------------ primitives

// an arrival on the barrier once this thread's earlier cp.async have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void consumers_sync(int n_threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n_threads) : "memory");
}

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// ------------------------------------------------------------- producer

// n_boxes boxes of `rows` rows x 64 columns of src (row 0, column `col` of
// the tile) into the swizzled layout TMA writes: row r's 16-byte chunk c
// lands at chunk c ^ (r % 8).  Rows from n_rows on and columns from n_cols
// on are zero.
__device__ __forceinline__ void copy_boxes(char* dst, const __nv_bfloat16* src,
                                           long long row_stride, int n_rows,
                                           int col, int n_cols, int n_boxes,
                                           int rows, int pt) {
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
  const int n = n_boxes * rows * 64;
#pragma unroll 4
  for (int i = pt; i < n; i += kWG) {
    const int box = i / (rows * 64), r = (i >> 6) % rows, c = i & 63;
    const int cc = col + box * 64 + c;
    const uint16_t x =
        r < n_rows && cc < n_cols ? s[r * row_stride + cc] : uint16_t{0};
    *reinterpret_cast<uint16_t*>(dst + box * rows * 128 + r * 128 +
                                 ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2) =
        x;
  }
}

// the bias's column group of 8 floats at row r of a KEYS-key tile: the
// groups XOR r, so that the consumers' float2 reads spread over the banks
template <int KEYS>
__device__ __forceinline__ int bias_at(int r, int c) {
  return r * KEYS + (c ^ ((r & (KEYS / 8 - 1)) << 3));
}

// the tile's bias [64 rows x KEYS keys] f32
template <int KEYS>
__device__ __forceinline__ void copy_bias(char* dst, const float* bias,
                                          int L, int q0, int key0, int pt) {
  const uint32_t base = smem_u32(dst);
  const int rows = min(kRows, L - q0), keys = min(KEYS, L - key0);
#pragma unroll 4
  for (int i = pt; i < kRows * KEYS; i += kWG) {
    const int r = i / KEYS, c = i % KEYS;
    if (r < rows && c < keys)
      cp_async4(base + bias_at<KEYS>(r, c) * 4,
                bias + static_cast<long long>(q0 + r) * L + key0 + c);
  }
}

// ------------------------------------------------------------------ kernel

template <int NB, int NC, int KEYS>
__global__ void __launch_bounds__(NC * kWG + kWG, NC == 1 ? 2 : 1)
attention_stream_bf16_kernel(const __grid_constant__ Params p,
                             const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv) {
  // the swizzled boxes need 1024-byte alignment; the kernel has no static
  // shared memory, so the dynamic region starts at offset 0 of the block's
  // window, which the declaration's alignment makes certain (checked)
  extern __shared__ __align__(1024) char smem[];
  if (smem_u32(smem) % kAlign) __trap();
  char* const q_res = smem;
  char* const ring = smem + p.q_res;
  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(ring + p.stages * p.stage_bytes);
  // full[s] = bars[s], empty[s] = bars[stages + s], Q's = bars[2 stages]
  const uint32_t bar0 = smem_u32(bars);
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (p.stages + s); };
  const uint32_t q_bar = bar0 + 16 * p.stages;

  const int L = p.L;
  const int pair = blockIdx.x / p.q_tiles;
  const int q0 = (blockIdx.x % p.q_tiles) * kRows;
  const int b = pair / p.H, h = pair % p.H;
  const int n_tiles = (L + KEYS - 1) / KEYS;
  const bool resident = p.n_chunks == 1;
  constexpr int kKVBox = KEYS * 128;  // a box of KEYS keys x 64 columns
  const int chunk_bytes = p.chunk_boxes * kBoxBytes;  // of Q
  const int k_bytes = p.chunk_boxes * kKVBox;
  constexpr int kConsumers = NC * kWG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), kWG + 1);  // each producer's cp.async + expect_tx
      mbar_init(empty(s), kConsumers);
    }
    mbar_init(q_bar, kWG + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // -------------------------------------------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x - kConsumers;
    const __nv_bfloat16* const q =
        p.q + b * p.str.q[0] + h * p.str.q[1] + q0 * p.str.q[2];
    const __nv_bfloat16* const k = p.k + b * p.str.k[0] + h * p.str.k[1];
    const __nv_bfloat16* const v = p.v + b * p.str.v[0] + h * p.str.v[1];
    const float* const bias =
        p.bias ? p.bias + static_cast<long long>(h) * L * L : nullptr;
    if (resident) {
      if (!(p.tma & kVecQ)) {
        copy_boxes(q_res, q, p.str.q[2], L - q0, 0, p.dk, p.chunk_boxes,
                   kRows, pt);
        fence_async_smem();
      }
      cp_async_arrive(q_bar);
      producers_sync();
      if (pt == 0) {
        const bool t = p.tma & kVecQ;
        mbar_arrive_tx(q_bar, t ? chunk_bytes : 0);
        if (t)
          for (int x = 0; x < p.chunk_boxes; ++x)
            tma_box(smem_u32(q_res + x * kBoxBytes), &tq, q_bar, 64 * x, q0,
                    h, b);
      }
    }
    int it = 0;
    for (int pass = 0; pass < p.n_passes; ++pass)
      for (int phase = n_tiles > 1 ? 0 : 1; phase < 2; ++phase)
        for (int tile = 0; tile < n_tiles; ++tile)
          for (int c = 0; c < p.n_chunks; ++c, ++it) {
            const int s = it % p.stages, use = it / p.stages;
            if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
            char* const st = ring + s * p.stage_bytes;
            const int key0 = tile * KEYS, col = c * p.chunk_boxes * 64;
            const bool last = c == p.n_chunks - 1;
            const bool values = last && phase == 1;  // V only with P
            const int vcol = pass * p.v_boxes * 64;
            bool wrote = false;
            if (!(p.tma & kVecK)) {
              copy_boxes(st + p.k_off, k + key0 * p.str.k[2], p.str.k[2],
                         L - key0, col, p.dk, p.chunk_boxes, KEYS, pt);
              wrote = true;
            }
            if (!resident && !(p.tma & kVecQ)) {
              copy_boxes(st + p.q_off, q, p.str.q[2], L - q0, col, p.dk,
                         p.chunk_boxes, kRows, pt);
              wrote = true;
            }
            if (values && !(p.tma & kVecV)) {
              copy_boxes(st + p.v_off, v + key0 * p.str.v[2], p.str.v[2],
                         L - key0, vcol, p.dv, p.v_boxes, KEYS, pt);
              wrote = true;
            }
            if (wrote) fence_async_smem();
            if (last && bias)
              copy_bias<KEYS>(st + p.bias_off, bias, L, q0, key0, pt);
            cp_async_arrive(full(s));
            // every producer's stores precede thread 0's arrival
            producers_sync();
            if (pt == 0) {
              const bool tk_on = p.tma & kVecK;
              const bool tq_on = !resident && (p.tma & kVecQ);
              const bool tv_on = values && (p.tma & kVecV);
              mbar_arrive_tx(full(s), tk_on * k_bytes + tq_on * chunk_bytes +
                                          tv_on * p.v_boxes * kKVBox);
              for (int x = 0; x < p.chunk_boxes; ++x) {
                if (tk_on)
                  tma_box(smem_u32(st + p.k_off + x * kKVBox), &tk, full(s),
                          col + 64 * x, key0, h, b);
                if (tq_on)
                  tma_box(smem_u32(st + p.q_off + x * kBoxBytes), &tq, full(s),
                          col + 64 * x, q0, h, b);
              }
              if (tv_on)
                for (int x = 0; x < p.v_boxes; ++x)
                  tma_box(smem_u32(st + p.v_off + x * kKVBox), &tv, full(s),
                          vcol + 64 * x, key0, h, b);
            }
          }
    return;
  }

  // --------------------------------------------------- consumer warpgroups
  // the launch bounds give a block NC·128 + 128 threads at 128 (NC = 1, two
  // blocks an SM) or 168 (NC = 2) registers a thread; the producers keep 40
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(NC == 1 ? 216
                                                                      : 232)
               : "memory");
  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32;
  const int t = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);  // rows r0 and r0 + 8 of the tile

  // q·(1/temperature) rounded to bf16, in place, by every consumer thread
  auto scale_q = [&](char* base) {
    for (int off = threadIdx.x * 16; off < chunk_bytes; off += kConsumers * 16) {
      uint4 w = *reinterpret_cast<uint4*>(base + off);
      w.x = scale_bf16(w.x, p.inv_temp);
      w.y = scale_bf16(w.y, p.inv_temp);
      w.z = scale_bf16(w.z, p.inv_temp);
      w.w = scale_bf16(w.w, p.inv_temp);
      *reinterpret_cast<uint4*>(base + off) = w;
    }
    fence_async_smem();
    consumers_sync(kConsumers);
  };
  if (resident) {
    mbar_wait(q_bar, 0);
    scale_q(q_res);
  }

  int it = 0;
  const int first_phase = n_tiles > 1 ? 0 : 1;
  for (int pass = 0; pass < p.n_passes; ++pass) {
    float o[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // phase 0 (more than one key tile): each row's max and sum, Q·K^T
    // only; phase 1: the probabilities as plain_sdpa forms them,
    // exp(s - m) / l, rounded to bf16, and O += P·V
    for (int phase = first_phase; phase < 2; ++phase)
      for (int tile = 0; tile < n_tiles; ++tile) {
        // this tile's scores of rows r0 and r0 + 8 (sc, in the accumulator
        // layout: column 8(i/4) + 2t + i%2, row r0 + 8((i/2)%2)); the stage
        // of the tile's last chunk stays unreleased until P·V
        constexpr int kS = KEYS / 2;  // S accumulators a thread
        float sc[kS];
#pragma unroll
        for (int i = 0; i < kS; ++i) sc[i] = 0.f;
        char* st = nullptr;
        int s = 0;
        for (int c = 0; c < p.n_chunks; ++c, ++it) {
          s = it % p.stages;
          mbar_wait(full(s), (it / p.stages) & 1);
          st = ring + s * p.stage_bytes;
          char* const qb = resident ? q_res : st + p.q_off;
          if (!resident) scale_q(qb);
          const uint32_t qa = smem_u32(qb), ka = smem_u32(st + p.k_off);
          wgmma_fence();
          for (int kk = 0; kk < 4 * p.chunk_boxes; ++kk) {
            const uint32_t off = (kk & 3) * 32;
            wgmma_ss(sc, desc(qa + (kk >> 2) * kBoxBytes + off, 16, 1024),
                     desc(ka + (kk >> 2) * kKVBox + off, 16, 1024),
                     c > 0 || kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          if (c + 1 < p.n_chunks) mbar_arrive(empty(s));
        }
        // + bias, -inf past L; each row's max over the tile
        const int key0 = tile * KEYS;
        const float* const bt =
            p.bias ? reinterpret_cast<const float*>(st + p.bias_off) : nullptr;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          const int row = r0 + ((i & 2) << 2);
          const int col = 8 * (i >> 2) + 2 * t + (i & 1);
          float x = sc[i];
          if (key0 + col >= L)
            x = -INFINITY;
          else if (bt)
            x += bt[bias_at<KEYS>(row, col)];
          sc[i] = x;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
        if (phase == 0 || n_tiles == 1) {
          // the running max m and sum l of exp(s - m) over the tiles so far
          float base[2], sum[2] = {0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], quad_max(mx[r]));
            base[r] = m_new == -INFINITY ? 0.f : m_new;
            l[r] *= expf(m[r] - base[r]);
            m[r] = m_new;
          }
#pragma unroll
          for (int i = 0; i < kS; ++i)
            sum[(i >> 1) & 1] += expf(sc[i] - base[(i >> 1) & 1]);
#pragma unroll
          for (int r = 0; r < 2; ++r) l[r] += quad_sum(sum[r]);
        }
        if (phase == 0) {
          mbar_arrive(empty(s));
          continue;
        }
        float base[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) base[r] = m[r] == -INFINITY ? 0.f : m[r];
        constexpr int kSteps = KEYS / 16;  // 16-key steps of P·V
        uint32_t pa[kSteps][4];
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = 8 * kk + 2 * x, r = x & 1;
            pa[kk][x] = pack_bf16(expf(sc[i] - base[r]) / l[r],
                                  expf(sc[i + 1] - base[r]) / l[r]);
          }
        const uint32_t va = smem_u32(ring + s * p.stage_bytes + p.v_off) +
                            wg * NB * kKVBox;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            wgmma_rs(o[nb], pa[kk],
                     desc(va + nb * kKVBox + kk * 2048, kKVBox, 1024));
        wgmma_commit();
        wgmma_wait_all();
        mbar_arrive(empty(s));
      }

    // O rounded to bf16
    const int col0 = pass * p.v_boxes * 64 + wg * NB * 64 + 2 * t;
    __nv_bfloat16* const out = p.out + b * p.str.o[0] + h * p.str.o[1];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = q0 + r0 + ((i & 2) << 2);
        const int col = col0 + 64 * nb + 8 * (i >> 2);
        if (row >= L || col >= p.dv) continue;
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
}

// ------------------------------------------------------------------ host

template <int NB, int NC, int KEYS>
int run(const Params& p, int blocks, size_t smem, const CUtensorMap& tq,
        const CUtensorMap& tk, const CUtensorMap& tv, cudaStream_t stream) {
  auto kernel = attention_stream_bf16_kernel<NB, NC, KEYS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  // all of the SM's 228 KB as shared memory, so that two blocks of up to
  // 113 KB (one key tile at d 256) share an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, NC * kWG + kWG, smem, stream>>>(p, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}

// the launch geometry of a shape: O's column blocks (nc consumer
// warpgroups of nb 64-column blocks), Q resident or streamed, ring depth
// and the stage layout; returns the dynamic shared memory (0: none fits)
size_t plan(Params& p, int L, int dk, int dv, bool with_bias, int* nc,
            int* nb) {
  p.q_tiles = (L + kRows - 1) / kRows;
  // O's 64-column blocks: one consumer warpgroup up to 256 columns, two
  // (half each) up to 512, passes of 512 past that
  const int v_blocks = (dv + 63) / 64;
  *nc = v_blocks <= 4 ? 1 : 2;
  *nb = *nc == 1 ? v_blocks : v_blocks <= 6 ? 3 : 4;
  p.v_boxes = *nc * *nb;
  p.n_passes = (v_blocks + p.v_boxes - 1) / p.v_boxes;

  // shared memory, the first of these that fits, Q resident: past one key
  // tile of 64, tiles of 32 keys with two stages where two such blocks fit
  // an SM (one consumer warpgroup); tiles of 64 with two stages, then one,
  // where two blocks fit; two stages, then one, in the whole of a block's
  // shared memory (two blocks of one stage beat one block of two on an
  // H100: scripts/torch_stream_ablation.py, PERF.md §6).  Else Q
  // streamed beside K in chunks of d_k, in tiles of 64 keys.
  const int k_boxes = (dk + 63) / 64;
  const int fixed = 64;  // the barriers
  struct Layout {
    int keys, stages, limit;
  };
  const Layout layouts[] = {{32, 2, kPairSmem}, {64, 2, kPairSmem},
                            {64, 1, kPairSmem}, {64, 2, kMaxSmem},
                            {64, 1, kMaxSmem}};
  p.stages = 0;
  for (const Layout& t : layouts) {
    const int n_tiles = (L + t.keys - 1) / t.keys;
    if (t.keys == 32 && (L <= 64 || *nc != 1)) continue;
    if (t.stages == 2 && p.n_passes * n_tiles == 1) continue;
    const int kv = t.keys * 128, bias_bytes = with_bias ? kRows * t.keys * 4
                                                        : 0;
    const int stage = (k_boxes + p.v_boxes) * kv + bias_bytes;
    if (fixed + k_boxes * kBoxBytes + t.stages * stage <= t.limit) {
      p.keys = t.keys;
      p.stages = t.stages;
      p.chunk_boxes = k_boxes;
      p.n_chunks = 1;
      p.q_res = k_boxes * kBoxBytes;
      p.k_off = p.q_off = 0;
      p.v_off = k_boxes * kv;
      p.bias_off = p.v_off + p.v_boxes * kv;
      p.stage_bytes = p.bias_off + bias_bytes;
      return fixed + p.q_res + p.stages * p.stage_bytes;
    }
  }
  p.keys = 64;
  const int bias_bytes = with_bias ? kRows * 64 * 4 : 0;
  const int v_bytes = p.v_boxes * kBoxBytes;
  for (int cb = k_boxes; cb >= 1 && !p.stages; --cb)
    for (int stages = 2; stages >= 1 && !p.stages; --stages)
      if (fixed + stages * (2 * cb * kBoxBytes + v_bytes + bias_bytes) <=
          kMaxSmem) {
        p.stages = stages;
        p.chunk_boxes = cb;
      }
  if (!p.stages) return 0;
  p.n_chunks = (k_boxes + p.chunk_boxes - 1) / p.chunk_boxes;
  p.q_res = 0;
  p.k_off = 0;
  p.q_off = p.chunk_boxes * kBoxBytes;
  p.v_off = 2 * p.chunk_boxes * kBoxBytes;
  p.bias_off = p.v_off + v_bytes;
  p.stage_bytes = p.bias_off + bias_bytes;
  return fixed + p.stages * p.stage_bytes;
}

}  // namespace

// strides: 12 element strides, batch, head and row of q, k, v and out.
// vec: bit 0, 1, 2 set where q, k, v have a 16-byte-aligned base and
// strides, which TMA reads; the others are copied element by element.
extern "C" int lstc_attention_stream_bf16_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    const long long* strides, int B, int H, int L, int dk, int dv,
    unsigned vec, float temperature, void* stream) {
  if (B < 1 || H < 1 || L < 1 || dk < 1 || dv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.q_tiles = (L + kRows - 1) / kRows;
  p.inv_temp = 1.f / temperature;

  int nc = 0, nb = 0;
  const size_t smem = plan(p, L, dk, dv, bias != nullptr, &nc, &nb);
  if (!smem) return static_cast<int>(cudaErrorInvalidConfiguration);

  CUtensorMap tq{}, tk{}, tv{};
  p.tma = 0;
  if ((vec & kVecQ) && encode(&tq, q, dk, L, H, B, strides, kRows))
    p.tma |= kVecQ;
  if ((vec & kVecK) && encode(&tk, k, dk, L, H, B, strides + 3, p.keys))
    p.tma |= kVecK;
  if ((vec & kVecV) && encode(&tv, v, dv, L, H, B, strides + 6, p.keys))
    p.tma |= kVecV;
  if ((vec & (kVecQ | kVecK | kVecV)) != p.tma)
    return static_cast<int>(cudaErrorInvalidValue);  // a map was refused

  const long long blocks = static_cast<long long>(B) * H * p.q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(blocks);
  if (nc == 1) {
    switch (nb) {
      case 1:
        return p.keys == 32 ? run<1, 1, 32>(p, n, smem, tq, tk, tv, s)
                            : run<1, 1, 64>(p, n, smem, tq, tk, tv, s);
      case 2:
        return p.keys == 32 ? run<2, 1, 32>(p, n, smem, tq, tk, tv, s)
                            : run<2, 1, 64>(p, n, smem, tq, tk, tv, s);
      case 3:
        return p.keys == 32 ? run<3, 1, 32>(p, n, smem, tq, tk, tv, s)
                            : run<3, 1, 64>(p, n, smem, tq, tk, tv, s);
      default:
        return p.keys == 32 ? run<4, 1, 32>(p, n, smem, tq, tk, tv, s)
                            : run<4, 1, 64>(p, n, smem, tq, tk, tv, s);
    }
  }
  return nb == 3 ? run<3, 2, 64>(p, n, smem, tq, tk, tv, s)
                 : run<4, 2, 64>(p, n, smem, tq, tk, tv, s);
}

// the launch geometry at L, d_k, d_v with or without a bias: out[0]
// dynamic shared memory bytes, [1] threads a block, [2] query rows a block,
// [3] ring stages, [4] 1 where Q is resident.  Returns 0, or a cudaError_t
// where no geometry fits.
extern "C" int lstc_attention_stream_bf16_plan(int L, int dk, int dv,
                                               int with_bias, int* out) {
  if (L < 1 || dk < 1 || dv < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  int nc = 0, nb = 0;
  const size_t smem = plan(p, L, dk, dv, with_bias != 0, &nc, &nb);
  if (!smem) return static_cast<int>(cudaErrorInvalidConfiguration);
  out[0] = static_cast<int>(smem);
  out[1] = nc * kWG + kWG;
  out[2] = kRows;
  out[3] = p.stages;
  out[4] = p.n_chunks == 1;
  return 0;
}

extern "C" const char* lstc_cuda_stream_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
