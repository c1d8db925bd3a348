// Fused scaled dot-product attention with an additive bias, for Hopper
// (sm_90a), on bfloat16 operands with f32 accumulation: the bf16 route of the
// attention operator at L <= 128 (csrc/attention.cu is the f32 route,
// csrc/attention_stream_bf16.cu takes every other bf16 shape).
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
// scaled q.  Where the temperature is a power of two (16 at every preset) that
// rounding is exact, and the kernel scales S in f32 instead: the same values,
// since both products and sums commute with a power of two (q/T subnormal
// aside).  The softmax is IEEE f32 (expf, a true division); P and the output
// are rounded to nearest even.
//
// What bounds it on an H100 SXM.  It must read q, k, v and write out once:
// 8·L·D bytes per (b, h) pair, and the bias once, against 4·L²·D FLOP for
// its two products at the bf16 tensor-core rate (989 TFLOP/s dense).  That is
// L/2 FLOP per byte against the card's 295, so the bytes bound it at every L
// it takes.  At the main path's shape (B=924, H=8, L=49, D=256, bias) the
// bytes take 0.221 ms and the products 0.018 ms.  The [L, L] scores never go
// to device memory.  So the design is about keeping bytes in flight and
// overlapping one tile's loads with another's compute and store.
//
// Design:
// - Tiles.  A tile is 64 query rows of one batch row b: 4 heads of L <= 16
//   (16 rows each), 2 heads of L <= 32, one head of L <= 64; at L in (64,
//   128] it is 128 rows of one head, split over two consumer warpgroups that
//   share its K and V.  Head-packed tiles hold the keys of the same heads;
//   S is set to -inf between heads.  Rows past L and heads past H are
//   zero-filled by TMA (their outputs are never stored), so every row has a
//   finite score and V's padding rows are exactly 0.
// - Persistent, warp-specialised blocks.  One block an SM walks the tiles in
//   a strided loop, so that neighbouring blocks hold neighbouring heads of
//   one b at any moment.  A block has two consumer warpgroups: at 64-row
//   tiles each takes every other tile of the block, so that one's softmax
//   overlaps the other's products and stores (one warpgroup alone left the
//   copies waiting on its serial chain: scripts/torch_tiled_bf16_ablation.py,
//   PERF.md §6); at 128-row tiles both take one.  One producer thread
//   issues TMA into a ring of 1-4 stages (Q | K | V of a tile each); each
//   stage has a `full` mbarrier for Q and K and one for V, so that Q·K^T
//   starts before V lands, and an `empty` one for each, so that the next
//   tile's Q and K load while this tile's softmax, P·V and store run.  The
//   producer warpgroup hands the consumers its registers (setmaxnreg).
// - TMA in.  4-D tensor maps (d, L, H, B) over the views' own strides, boxes
//   of 64 columns x R rows x G heads, 128-byte swizzle: a row's 64-column
//   boxes are issued together; a 64-row tile of 4 heads is one box a column
//   block.  The maps are encoded through cudaGetDriverEntryPoint (no -lcuda;
//   csrc/hopper.cuh, shared with the streaming kernel).
// - wgmma.  S = Q·K^T is wgmma.m64n64k16 with both operands in shared memory
//   (K-major), twice at 128 keys.  O = P·V is wgmma.m64n64k16 with P as the
//   register A operand (the S accumulators re-packed to bf16 pairs) and V
//   MN-major, a 64-column block of O at a time.
// - The bias [H, L, L] f32 (at most 512 KB, resident in L2) is read by the
//   consumers while the tile's Q and K land.
// - TMA out.  Each consumer warpgroup rounds a 64 x 64 block of O to bf16
//   into one of two staging boxes of its own (swizzled as TMA reads them)
//   and stores it with a bulk tensor store to out's map, which drops rows
//   past L, heads past H and columns past D.  A staging box is rewritten once
//   its previous store has read it (cp.async.bulk.wait_group.read).  The
//   ring's stages are never held for the store.
// - The launch geometry (tile rows, heads a tile, stages, shared memory) is
//   computed by one function, `plan`, which the launcher and
//   lstc_attention_bf16_plan (ops/cuda_attention.py::bf16_plan) both call.
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
constexpr int kStoreBytes = 2 * kBoxBytes;  // a consumer warpgroup's O boxes

struct Params {
  const float* bias;
  int H, L;
  int head_rows;  // R: rows a head takes in a tile (16, 32, 64 or 128)
  int head_shift; // log2(R)
  int heads;      // G: heads of a tile
  int n_hg;       // tiles of a batch row: ceil(H / G)
  int n_tiles;    // B · n_hg
  int stages;     // of the ring
  int scale_q;    // 1: q·(1/T) rounded in shared memory; 0: S·(1/T)
  float inv_temp;
};

// NC: consumer warpgroups a tile (1: 64-row tiles, two in flight a block;
// 2: 128-row tiles, one in flight); DB: 64-column boxes of D
template <int NC, int DB>
__global__ void __launch_bounds__(3 * kWG, 1)
attention_bf16_kernel(const __grid_constant__ Params p,
                      const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to) {
  constexpr int M = 64 * NC;               // rows (and keys) of a tile
  constexpr int kBox = M * 128;            // a box of M rows x 64 columns
  constexpr int kQK = 2 * DB * kBox;       // Q and K of a tile
  constexpr int kV = DB * kBox;
  constexpr int kStage = kQK + kV;
  constexpr int kSteps = 4 * NC;           // 16-key steps of P·V
  constexpr int OB = DB < 2 ? DB : 2;      // O's 64-column blocks a batch
  constexpr int CG = 2 / NC;               // tiles in flight a block
  // the kernel has no static shared memory, so the dynamic region starts at
  // offset 0 of the block's window, 1024-byte aligned for the swizzle
  extern __shared__ __align__(1024) char smem[];
  if (smem_u32(smem) % kAlign) __trap();
  const int S = p.stages;
  char* const staging = smem + S * kStage;
  const uint32_t bar0 = smem_u32(staging + 2 * kStoreBytes);
  // full Q·K, full V, empty Q·K, empty V of stage s
  auto full_qk = [&](int s) { return bar0 + 8 * s; };
  auto full_v = [&](int s) { return bar0 + 8 * (S + s); };
  auto empty_qk = [&](int s) { return bar0 + 8 * (2 * S + s); };
  auto empty_v = [&](int s) { return bar0 + 8 * (3 * S + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_qk(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_qk(s), NC * kWG);
      mbar_init(empty_v(s), NC * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWG) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 2 * kWG) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++it) {
      const int s = it % S, use = it / S;
      const int b = tile / p.n_hg, h0 = (tile % p.n_hg) * p.heads;
      const uint32_t st = smem_u32(smem + s * kStage);
      if (use > 0) mbar_wait(empty_qk(s), (use - 1) & 1);
      mbar_arrive_tx(full_qk(s), kQK);
#pragma unroll
      for (int x = 0; x < DB; ++x) {
        tma_box(st + x * kBox, &tq, full_qk(s), 64 * x, 0, h0, b);
        tma_box(st + (DB + x) * kBox, &tk, full_qk(s), 64 * x, 0, h0, b);
      }
      if (use > 0) mbar_wait(empty_v(s), (use - 1) & 1);
      mbar_arrive_tx(full_v(s), kV);
#pragma unroll
      for (int x = 0; x < DB; ++x)
        tma_box(st + (2 * DB + x) * kBox, &tv, full_v(s), 64 * x, 0, h0, b);
    }
    return;
  }

  // ---------------------------------------------------- consumer warpgroups
  // 384 threads at 168 registers; the producers keep 24, so each consumer
  // thread may take 240.  Consumer warpgroup wg is of group wg / NC, which
  // takes every CG-th of the block's tiles; it computes rows [64 wr,
  // 64 wr + 64) of each.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int group = wg / NC, wr = wg % NC;
  const int warp = tid / 32, lane = tid % 32;
  const int t = lane & 3, g = lane >> 2;
  const int L = p.L, R = p.head_rows, hs = p.head_shift;
  char* const my_staging = staging + wg * kStoreBytes;
  const float scale = p.scale_q ? 1.f : p.inv_temp;
  // keys of a tile that may be live: past L with one head a tile, whole
  // 8-key groups of S and 16-key steps of P·V are skipped (P is 0 there)
  const int key_end = p.heads == 1 ? L : 64;
  int n_stores = 0;

  // O's 64-column block nb of this warpgroup's 64 rows: rounded to bf16 into
  // one of two staging boxes (row r's chunk c at chunk c ^ (r % 8), as TMA
  // reads it), then one bulk tensor store; the other box's store may still
  // be reading
  auto store_block = [&](const float(&o)[32], int nb, int b, int h0) {
    char* const buf = my_staging + (n_stores & 1) * kBoxBytes;
    if (tid == 0) bulk_wait_read<1>();  // the store before last has read it
    wg_sync(wg);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = 16 * warp + g + ((i & 2) << 2);
      *reinterpret_cast<uint32_t*>(buf + r * 128 + (((i >> 2) ^ g) << 4) +
                                   4 * t) = pack_bf16(o[i], o[i + 1]);
    }
    fence_async_smem();
    wg_sync(wg);
    if (tid == 0) {
      tma_store(&to, smem_u32(buf), 64 * nb, 64 * wr, h0, b);
      bulk_commit();
    }
    ++n_stores;
  };

  for (int it = group, tile = blockIdx.x + group * gridDim.x;
       tile < p.n_tiles; it += CG, tile += CG * gridDim.x) {
    const int s = it % S, ph = (it / S) & 1;
    const int b = tile / p.n_hg, h0 = (tile % p.n_hg) * p.heads;
    char* const st = smem + s * kStage;

    // this thread's rows r0 and r0 + 8 of the tile: head h0 + r / R, row
    // r % R of it; a row of a padding head or past L is computed, not stored
    int head_r[2], row_l[2];
    const float* bias_row[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = 64 * wr + 16 * warp + g + 8 * x;
      head_r[x] = r >> hs;
      row_l[x] = r & (R - 1);
      const int h = h0 + head_r[x];
      bias_row[x] = p.bias && h < p.H && row_l[x] < L
                        ? p.bias + (static_cast<long long>(h) * L + row_l[x]) * L
                        : nullptr;
    }

    // the bias of this thread's scores while Q and K land; -inf where the
    // key is past L or of another head
    float bv[NC][32];
#pragma unroll
    for (int kb = 0; kb < NC; ++kb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int x = (i >> 1) & 1;
        const int key = 64 * kb + 8 * (i >> 2) + 2 * t + (i & 1);
        const int key_l = key & (R - 1);
        if (key >> hs != head_r[x] || key_l >= L)
          bv[kb][i] = -INFINITY;
        else
          bv[kb][i] = bias_row[x] ? __ldg(bias_row[x] + key_l) : 0.f;
      }
    mbar_wait(full_qk(s), ph);
    if (p.scale_q) {
      // q·(1/temperature) rounded to bf16, in place: this warpgroup's rows
#pragma unroll
      for (int x = 0; x < DB; ++x)
        for (int off = tid * 16; off < kBoxBytes; off += kWG * 16) {
          uint4* const w = reinterpret_cast<uint4*>(st + x * kBox +
                                                    wr * kBoxBytes + off);
          uint4 v = *w;
          v.x = scale_bf16(v.x, p.inv_temp);
          v.y = scale_bf16(v.y, p.inv_temp);
          v.z = scale_bf16(v.z, p.inv_temp);
          v.w = scale_bf16(v.w, p.inv_temp);
          *w = v;
        }
      fence_async_smem();
      wg_sync(wg);
    }

    // S = Q·K^T: keys in blocks of 64; sc[kb][i] is row r0 + 8((i/2)%2),
    // key 64kb + 8(i/4) + 2t + i%2
    float sc[NC][32];
#pragma unroll
    for (int kb = 0; kb < NC; ++kb)
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[kb][i] = 0.f;
    {
      const uint32_t qa = smem_u32(st) + wr * kBoxBytes;
      const uint32_t ka = smem_u32(st + DB * kBox);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < NC; ++kb)
#pragma unroll
        for (int kk = 0; kk < 4 * DB; ++kk) {
          const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
          wgmma_ss(sc[kb], desc(qa + off, 16, 1024),
                   desc(ka + kb * kBoxBytes + off, 16, 1024), kk > 0);
        }
      wgmma_commit();
    }
    wgmma_wait_all();
    mbar_arrive(empty_qk(s));

    // + bias, the row softmax in f32, P rounded to bf16
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int kb = 0; kb < NC; ++kb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool live = 64 * kb + 8 * (i >> 2) < key_end;
        const float x = !live || bv[kb][i] == -INFINITY
                            ? -INFINITY
                            : sc[kb][i] * scale + bv[kb][i];
        sc[kb][i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) mx[x] = quad_max(mx[x]);
#pragma unroll
    for (int kb = 0; kb < NC; ++kb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (64 * kb + 8 * (i >> 2) < key_end) {
          sc[kb][i] = expf(sc[kb][i] - mx[(i >> 1) & 1]);
          sum[(i >> 1) & 1] += sc[kb][i];
        } else {
          sc[kb][i] = 0.f;  // a dead group in a live 16-key step
        }
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) sum[x] = quad_sum(sum[x]);
    // P as bf16 pairs: the A fragment of 16-key step kk
    uint32_t pa[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = (8 * kk + 2 * x) % 32, kb = kk / 4;
        pa[kk][x] = 16 * kk < key_end
                        ? pack_bf16(sc[kb][i] / sum[x & 1],
                                    sc[kb][i + 1] / sum[x & 1])
                        : 0u;
      }

    // O = P·V, OB 64-column blocks at a time, stored as they are done
    mbar_wait(full_v(s), ph);
    const uint32_t va = smem_u32(st + 2 * DB * kBox);
#pragma unroll
    for (int nb0 = 0; nb0 < DB; nb0 += OB) {
      float o[OB][32];
#pragma unroll
      for (int j = 0; j < OB; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < OB; ++j)
        if (nb0 + j < DB)
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            if (16 * kk < key_end)
              wgmma_rs(o[j], pa[kk],
                       desc(va + (nb0 + j) * kBox + kk * 2048, kBox, 1024));
      wgmma_commit();
      wgmma_wait_all();
      if (nb0 + OB >= DB) mbar_arrive(empty_v(s));
#pragma unroll
      for (int j = 0; j < OB; ++j)
        if (nb0 + j < DB) store_block(o[j], nb0 + j, b, h0);
    }
  }
  if (tid == 0) bulk_wait_all();
}

// ------------------------------------------------------------------ host

struct Plan {
  int nc;         // consumer warpgroups
  int db;         // 64-column boxes of D
  int head_rows;  // R
  int heads;      // G
  int stages;
  int smem;       // dynamic shared memory bytes
};

// the launch geometry at L, D: 64-row tiles of 64/R heads of R = 16, 32 or
// 64 rows, one a consumer warpgroup, or one head of 128 rows over both; as
// many ring stages, up to kMaxStages, as fit beside the two warpgroups'
// staging boxes and the barriers, an even number at 64-row tiles.  False
// where the kernel does not take the shape.
bool plan(int L, int D, Plan* pl) {
  if (L < 1 || L > kMaxL || D < 32 || D > kMaxD || D % 32) return false;
  pl->head_rows = L <= 16 ? 16 : L <= 32 ? 32 : L <= 64 ? 64 : 128;
  pl->heads = pl->head_rows <= 64 ? 64 / pl->head_rows : 1;
  pl->nc = pl->head_rows == 128 ? 2 : 1;
  pl->db = (D + 63) / 64;
  const int stage = 3 * pl->db * 64 * pl->nc * 128;
  const int fixed = 2 * kStoreBytes;
  const int bars = 4 * 8;  // a stage's barriers
  pl->stages = (kMaxSmem - fixed) / (stage + bars);
  if (pl->stages > kMaxStages) pl->stages = kMaxStages;
  // each of two tiles in flight owns every other stage
  if (pl->nc == 1) pl->stages -= pl->stages % 2;
  if (pl->stages < 1) return false;
  pl->smem = pl->stages * (stage + bars) + fixed;
  return true;
}

template <int NC, int DB>
int run(const Params& p, int grid, int smem, const CUtensorMap& tq,
        const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& to,
        cudaStream_t stream) {
  auto kernel = attention_bf16_kernel<NC, DB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 3 * kWG, smem, stream>>>(p, tq, tk, tv, to);
  return static_cast<int>(cudaGetLastError());
}

using Runner = int (*)(const Params&, int, int, const CUtensorMap&,
                       const CUtensorMap&, const CUtensorMap&,
                       const CUtensorMap&, cudaStream_t);
constexpr Runner kRunners[2][4] = {
    {run<1, 1>, run<1, 2>, run<1, 3>, run<1, 4>},
    {run<2, 1>, run<2, 2>, run<2, 3>, run<2, 4>}};

}  // namespace

// strides: 12 element strides, batch, head and row of q, k, v and out
extern "C" int lstc_attention_bf16_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* out, const long long* strides,
                                       int B, int H, int L, int D,
                                       float temperature, void* stream) {
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
  p.stages = pl.stages;
  p.inv_temp = 1.f / temperature;
  int e2 = 0;
  p.scale_q = frexpf(temperature, &e2) != 0.5f;  // not a power of two

  // loads: boxes of the tile's rows (R rows of G heads, or 128 rows);
  // stores: a consumer warpgroup's 64 rows
  const int load_rows = pl.nc == 1 ? pl.head_rows : 128;
  const int store_rows = pl.nc == 1 ? pl.head_rows : 64;
  CUtensorMap tq{}, tk{}, tv{}, to{};
  if (!encode(&tq, q, D, L, H, B, strides, load_rows, pl.heads) ||
      !encode(&tk, k, D, L, H, B, strides + 3, load_rows, pl.heads) ||
      !encode(&tv, v, D, L, H, B, strides + 6, load_rows, pl.heads) ||
      !encode(&to, out, D, L, H, B, strides + 9, store_rows, pl.heads))
    return static_cast<int>(cudaErrorInvalidValue);

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a block keeps 2 / nc tiles in flight
  const int in_flight = 2 / pl.nc;
  const int grid = (p.n_tiles + in_flight - 1) / in_flight < sms
                       ? (p.n_tiles + in_flight - 1) / in_flight
                       : sms;
  return kRunners[pl.nc - 1][pl.db - 1](p, grid, pl.smem, tq, tk, tv, to,
                                        static_cast<cudaStream_t>(stream));
}

// the launch geometry at L, D: out[0] dynamic shared memory bytes, [1]
// threads a block, [2] rows a tile, [3] heads a tile, [4] rows a head takes
// in a tile, [5] ring stages.  Returns 0, or cudaErrorInvalidValue where the
// kernel does not take the shape.
extern "C" int lstc_attention_bf16_plan(int L, int D, int* out) {
  Plan pl;
  if (!plan(L, D, &pl)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = pl.smem;
  out[1] = 3 * kWG;
  out[2] = 64 * pl.nc;
  out[3] = pl.heads;
  out[4] = pl.head_rows;
  out[5] = pl.stages;
  return 0;
}

extern "C" const char* lstc_cuda_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
