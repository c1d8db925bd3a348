// f32-accurate matrix product with a bias, for Hopper (sm_90a): the
// encoder's f32 Linears, ops/cuda_linear.py's operator lstc_vad::linear.
//
//   C[M, N] = A[M, K] · B[N, K]^T (+ bias[N])
//
// A and B row-major with row strides lda and ldb (at least K, multiples of
// 4 elements: rows of whole 16 bytes, which TMA needs) and 16-byte-aligned
// bases, C row-major with row stride N: any K and N.  The wrapper pads a
// ragged K (not a multiple of 4) into its row stride; TMA reads the columns
// past K as zeros, so the padding is never read.  The forward of a Linear is A = x, B = its
// weight [out, in]; the input gradient is A = dY, B = the weight transposed
// [in, out], so that both operands are K-major, the only layout TF32 wgmma
// reads (csrc/hopper.cuh).  B arrives split: lstc_gemm_split writes its two
// TF32 halves (transposed or not) into scratch the wrapper allocates on
// every call, so no split outlives the weight it was made from.
//
// Replaces no TPU kernel: the JAX package left its Dense layers to XLA, and
// until this kernel the port ran them on cuBLAS's FP32 kernels (FFMA, no
// tensor cores).  This one puts them on the tensor cores at f32 accuracy.
//
// Arithmetic: 3xTF32.  Each operand x = big + small, big = x rounded to TF32
// to nearest, small = x - big rounded to TF32 to nearest; a product is
// small·big + big·small + big·big on the tensor core, each summed in f32;
// the rounding of small and the dropped small·small lose at most about
// 2^-22 |x| each.  The
// tensor core truncates as it accumulates, so a chain of products held there
// over all of K (1,536 products at K = 4096) drifts toward zero; here each
// 32-deep stage's twelve products are summed from zero on the tensor core
// and then added to the tile's sums in IEEE f32 (as csrc/attention.cu does
// for each 8-deep k-step).  The order of every sum is fixed by the shape:
// no split of K across blocks and no atomics, so two calls on the same
// inputs give the same bits.  The bias is added once, to the finished sum.
//
// What bounds it on an H100 SXM: 2·M·N·K operations, which 3xTF32 runs at
// 495 / 3 = 165 TFLOP/s, against (M·K + 2·N·K + M·N)·4 bytes at 3.35 TB/s;
// at the encoder's shapes (M ~ 100,000, N and K 1024-4096) the operations
// bound it by two orders of magnitude.  So the design keeps the tensor
// cores fed: operands in shared memory ahead of the products, no thread
// waiting on a load or a store while products could issue.
//
// Design:
// - Tiles.  128 x BN of C (BN = 128, or 64 where 128-wide tiles would leave
//   SMs without one: small M), 64 rows a consumer warpgroup; tiles walked in
//   groups of 8 M-tiles over every N-tile, so that the blocks in flight
//   share their A rows and B columns in L2.
// - Persistent, warp-specialised blocks.  One block an SM walks the tiles in
//   a strided loop.  One thread of the producer warpgroup keeps a ring of
//   stages in flight by TMA (A's 128 rows and B's two halves, 32 columns of
//   K each, 128-byte swizzle) and runs on into the next tile's stages while
//   the consumers finish a tile; the two consumer warpgroups issue wgmma,
//   each on its 64 rows, so that one's products run while the other adds
//   or stores.  The producers hand their registers to the consumers
//   (setmaxnreg).
// - A in registers.  A arrives as f32; each consumer thread loads its A
//   fragment of a stage (rows r and r + 8, 16 columns) from the landed box
//   and splits it there, and issues the register-A form of
//   wgmma.m64nBNk8.tf32.  A is never written back split.
// - A stage: wait for its TMA; load and split A; twelve products (four
//   k-steps of three) into a fresh sum (the first one's accumulate flag
//   off); wait for them; free the stage; add the sum to the tile's.  Nothing is in flight across a branch or a
//   barrier wait, so ptxas does not serialize the wgmma (C7514-C7520).
// - Epilogue: the bias added in registers, C written into staging boxes of
//   64 rows x 32 columns (swizzled as TMA reads them) and stored by TMA,
//   which drops rows past M and columns past N; the ragged K is zero-filled
//   by TMA on the way in.  Where N is not a multiple of 4 (C's rows are not
//   whole 16 bytes, which a TMA store needs), each thread stores its sums
//   from registers, the rows past M and the columns past N left out.
//
// The weight gradient, lstc_gemm_wgrad: dW[N, K] = dY[M, N]^T · X[M, K],
// the sums over M, the tokens.  Both operands arrive MN-major (M is their
// row index), and TF32 wgmma reads only K-major ones, so each has to be
// turned on the way.  It replaces no TPU kernel either (XLA computed the
// JAX package's Dense gradients; the port ran them on cuBLAS's FP32 SIMT
// sgemm).  It is bound by operations as the forward is: 2·M·N·K at 165
// TFLOP/s against (M·N + M·K + N·K)·4 bytes at 3.35 TB/s.  It keeps the
// forward's shape (persistent warp-specialised blocks, 128 x BN tiles of
// dW in raster groups, 32-deep stages, 3xTF32, each stage's products
// summed from zero and added in IEEE f32, no split of M and no atomics, so
// two calls give the same bits), and what is new is the turn:
// - A = dY^T in registers.  dY's 32 rows x 128 columns land raw (four
//   boxes); each consumer thread loads its A words with transposed
//   addressing and splits them in registers, as the forward does A.  The
//   tile's rows are dealt to the accumulator rows in an order that puts
//   each load of a warp on 32 distinct banks.
// - B = X^T by the producer warpgroup, as the f32 streaming attention
//   kernel turns V into V^T (csrc/attention_stream.cu): X's 32 rows x BN
//   columns land raw in a ring of landing zones beside dY's; three warps
//   of the producer warpgroup split them into TF32 halves written
//   transposed, M contiguous, into a ring of ready slots, each slot with a
//   full and an empty mbarrier.  A landing zone is freed once its A is in
//   registers and its X split, so the TMA runs ahead of the split and the
//   split ahead of the products.
// - Both operands are split by hopper.cuh's split, not the forward's
//   split_rn: big rounded to TF32, small the exact rest, which the tensor
//   core truncates as it reads it.  Three operations an element where
//   split_rn takes five, and the split runs on twice the elements the
//   forward splits; each product's error stays under 2^-19 of it (against
//   split_rn's 2^-21), which the f32 sums over M's thousands of rows
//   outweigh: dW sits at 0.3-0.5x cuBLAS FP32's error against float64
//   (tests/test_torch_cuda_linear.py).
// - What bounds it.  A stage moves ~192 KB through shared memory: dY and X
//   landed (32 KB), read (32 KB), X's halves written (32 KB) and read by
//   wgmma (96 KB: each warpgroup's m64 products read all of B), against
//   the forward's ~160 KB; at the tensor core's 3xTF32 rate that is all
//   of shared memory's 128 bytes a cycle, so shared memory and the card's
//   power hold the kernel rather than the tensor core alone; the design keeps
//   every other cost off that path: dY never leaves registers split, X is
//   split once for both warpgroups, and no stage waits on device memory.
//   The transposed copy of dY and X in device memory that this avoids
//   would move ~32 GB a step at the LTN's widths.
// - Rows of M past the end are zero-filled by TMA, so a ragged M costs
//   nothing; the epilogue stores from registers (it runs once a tile of
//   M / 32 stages).  Tiles 128 x 128, or 128 x 64 where 128-column ones
//   would leave SMs without one; the encoder's widths give at least 128.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// caller's stream, do not synchronise, allocate nothing, and return a
// cudaError_t (0 = launched).

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;            // rows of a tile: 64 a consumer warpgroup
constexpr int kBK = kBoxColsF32;    // K-depth of a ring stage: 32
constexpr int kRowBytes = 4 * kBK;  // a box row: 128 bytes
constexpr int kOutBox = 64 * kRowBytes;  // a staging box: 64 rows x 32 cols
constexpr int kGroupM = 8;          // M-tiles of a raster group
constexpr int kThreads = 3 * kWG;   // two consumer warpgroups, one producer
constexpr int kMaxStages = 6;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int BN>
struct Tile {
  static constexpr int A_BOX = kBM * kRowBytes;       // 16 KB
  static constexpr int B_BOX = BN * kRowBytes;        // a half of B
  static constexpr int STAGE = A_BOX + 2 * B_BOX;
  static constexpr int OUT = 2 * (BN / kBK) * kOutBox;  // both warpgroups
  static constexpr int FIT = (kMaxSmem - OUT) / (STAGE + 16);
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  // the ring, the staging boxes, a full and an empty barrier a stage
  static constexpr int SMEM = STAGES * STAGE + OUT + 16 * STAGES;
  static constexpr int NA = BN / 2;  // sums a consumer thread holds
};

struct Params {
  const float* bias;  // [N] or null
  float* c;           // C for stores from registers (N ragged), else null
  int M, N, K;
  int n_m, n_n;       // M-tiles, N-tiles
  int n_k;            // stages a tile: ceil(K / 32)
  int n_tiles;
};

// tile t's (M-tile, N-tile): groups of kGroupM M-tiles, each over every
// N-tile, M fastest within a group
__device__ __forceinline__ void tile_of(const Params& p, int t, int& mt,
                                        int& nt) {
  const int per = kGroupM * p.n_n;
  const int first = (t / per) * kGroupM;
  const int rows = min(kGroupM, p.n_m - first);
  const int r = t - (t / per) * per;
  mt = first + r % rows;
  nt = r / rows;
}

// x = big + small for 3xTF32, both rounded to TF32 to nearest: big is
// hopper.cuh's, small the rest rounded rather than left for the tensor core
// to truncate, which halves the split's error and keeps it unbiased
__device__ __forceinline__ void split_rn(float x, uint32_t& big,
                                         uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// one box of a 2-D tensor map, coordinates (column, row)
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// one box from shared memory into a 2-D tensor map; elements past the
// map's bounds are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ Params p,
            const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb_big,
            const __grid_constant__ CUtensorMap tb_small,
            const __grid_constant__ CUtensorMap tc) {
  using T = Tile<BN>;
  constexpr int S = T::STAGES, NA = T::NA;
  // no static shared memory: the dynamic region starts at offset 0 of the
  // block's window, 1024-byte aligned for the swizzle
  extern __shared__ __align__(1024) char smem[];
  if (smem_u32(smem) % kAlign) __trap();
  char* const staging = smem + S * T::STAGE;
  const uint32_t bar0 = smem_u32(staging + T::OUT);
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (S + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWG) {
    // -------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (threadIdx.x != 2 * kWG) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      int mt, nt;
      tile_of(p, tile, mt, nt);
      for (int kb = 0; kb < p.n_k; ++kb, ++it) {
        const int s = it % S, use = it / S;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        const uint32_t dst = smem_u32(smem + s * T::STAGE);
        mbar_arrive_tx(full(s), T::STAGE);
        tma_load_2d(dst, &ta, full(s), kBK * kb, kBM * mt);
        tma_load_2d(dst + T::A_BOX, &tb_big, full(s), kBK * kb, BN * nt);
        tma_load_2d(dst + T::A_BOX + T::B_BOX, &tb_small, full(s), kBK * kb,
                    BN * nt);
      }
    }
    return;
  }

  // ---------------------------------------------------- consumer warpgroups
  // warpgroup wg computes rows [64 wg, 64 wg + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
               : "memory");
  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32;
  const int t = lane & 3, g = lane >> 2;
  const int r0 = 64 * wg + 16 * warp + g;  // rows r0 and r0 + 8 of a tile
  char* const my_out = staging + wg * (T::OUT / 2);
  // c[i] is row r0 + 8((i >> 1) & 1), column 8(i >> 2) + 2t + (i & 1) of the
  // tile; acc the same of one stage's products
  float c[NA], acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  int it = 0, n_tiles_done = 0;

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    int mt, nt;
    tile_of(p, tile, mt, nt);
#pragma unroll
    for (int i = 0; i < NA; ++i) c[i] = 0.f;

#pragma unroll 1
    for (int kb = 0; kb < p.n_k; ++kb, ++it) {
      const int s = it % S;
      const char* const st = smem + s * T::STAGE;
      mbar_wait(full(s), (it / S) & 1);
      // this thread's A words of k-step kk: rows r0 and r0 + 8, columns
      // 8kk + t and 8kk + t + 4 (16-byte chunks 2kk and 2kk + 1, swizzled
      // by the row's place in its 8-row group, which is g)
      uint32_t ab[4][4], as[4][4];
      const char* const hi = st + r0 * kRowBytes;
      const char* const lo = hi + 8 * kRowBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c0 = (((2 * kk) ^ g) << 4) + 4 * t;
        const int c1 = (((2 * kk + 1) ^ g) << 4) + 4 * t;
        const float* const w0 = reinterpret_cast<const float*>(hi + c0);
        const float* const w1 = reinterpret_cast<const float*>(lo + c0);
        const float* const w2 = reinterpret_cast<const float*>(hi + c1);
        const float* const w3 = reinterpret_cast<const float*>(lo + c1);
        split_rn(*w0, ab[kk][0], as[kk][0]);
        split_rn(*w1, ab[kk][1], as[kk][1]);
        split_rn(*w2, ab[kk][2], as[kk][2]);
        split_rn(*w3, ab[kk][3], as[kk][3]);
      }
      const uint64_t bb = desc(smem_u32(st + T::A_BOX), 16, 1024);
      const uint64_t bs = desc(smem_u32(st + T::A_BOX + T::B_BOX), 16, 1024);
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // + 32 bytes (2 units) a k-step
        wgmma_tf32(acc, as[kk], bb + 2 * kk, kk > 0);
        wgmma_tf32(acc, ab[kk], bs + 2 * kk, 1);
        wgmma_tf32(acc, ab[kk], bb + 2 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
      mbar_arrive(empty(s));
#pragma unroll
      for (int i = 0; i < NA; ++i) c[i] += acc[i];
    }

    // + bias, then into the staging boxes once the last tile's stores have
    // read them, then one TMA store a box
    const int n0 = BN * nt;
    if (p.bias) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (col < p.N) c[i] += __ldg(p.bias + col);
      }
    }
    if (p.c) {
      // rows of 4N bytes: stored from registers, no staging
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int row = kBM * mt + r0 + 8 * ((i >> 1) & 1);
        const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (row < p.M && col < p.N)
          p.c[static_cast<long long>(row) * p.N + col] = c[i];
      }
      continue;
    }
    if (n_tiles_done > 0 && tid == 0) bulk_wait_read<0>();
    wg_sync(wg);
#pragma unroll
    for (int cc = 0; cc < BN / kBK; ++cc) {
      char* const buf = my_out + cc * kOutBox;
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
        const int chunk = (2 * (i >> 2) + (t >> 1)) ^ (r & 7);
        *reinterpret_cast<float2*>(buf + r * kRowBytes + (chunk << 4) +
                                   8 * (t & 1)) =
            make_float2(c[16 * cc + i], c[16 * cc + i + 1]);
      }
    }
    fence_async_smem();
    wg_sync(wg);
    if (tid == 0) {
#pragma unroll
      for (int cc = 0; cc < BN / kBK; ++cc)
        tma_store_2d(&tc, smem_u32(my_out + cc * kOutBox), n0 + kBK * cc,
                     kBM * mt + 64 * wg);
      bulk_commit();
    }
    ++n_tiles_done;
  }
  if (tid == 0) bulk_wait_all();
}

// ------------------------------------------------------- weight gradient

constexpr int kMBox = kBK * kRowBytes;  // a landed box: 32 rows of M
constexpr int kReady = 3;               // ready slots of the B ring
constexpr int kSplitters = kWG - 32;    // the producer warpgroup's warps 1-3
constexpr int kWgradProducerRegs = 56;
constexpr int kWgradConsumerRegs = 224;

template <int BN>
struct WTile {
  static constexpr int DY = (kBM / kBK) * kMBox;  // dY's 128 columns: 16 KB
  static constexpr int X = (BN / kBK) * kMBox;    // X's BN columns
  static constexpr int LAND = DY + X;             // a landing zone
  static constexpr int HALF = BN * kRowBytes;     // a half of B = X^T
  static constexpr int SLOT = 2 * HALF;           // a ready slot
  static constexpr int FIT =
      (kMaxSmem - kReady * SLOT - 16 * (kMaxStages + kReady)) / LAND;
  static constexpr int LANDS = FIT < kMaxStages ? FIT : kMaxStages;
  // the ready slots, the landing zones, a full and an empty barrier each
  static constexpr int SMEM = kReady * SLOT + LANDS * LAND +
                              16 * (LANDS + kReady);
};

// a landed stage of X (32 rows of M x BN columns of K, BN / 32 boxes) into
// a ready slot: B = X^T, BN rows of K x 32 of M (K-major for wgmma), as
// its big and small halves, 128-byte swizzled.  Unit u = 8d + l takes
// rows 4q .. 4q + 3 of M, q = (l + d) % 8, and columns 4j .. 4j + 3 of K,
// j = 8(d / 8) + l: the 8 units of an 8-lane phase read 8 distinct
// 16-byte bank groups and write 8 distinct ones
template <int BN>
__device__ __forceinline__ void split_transposed(const char* land, char* slot,
                                                 int st) {
  using T = WTile<BN>;
  for (int u = st; u < 2 * BN; u += kSplitters) {
    const int l = u & 7, d = u >> 3;
    const int q = (l + d) & 7, j = 8 * (d >> 3) + l;
    const char* const box = land + (j >> 3) * kMBox;
    float4 x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 4 * q + e;
      x[e] = *reinterpret_cast<const float4*>(box + m * kRowBytes +
                                               (((j ^ m) & 7) << 4));
    }
    const float col[4][4] = {{x[0].x, x[1].x, x[2].x, x[3].x},
                             {x[0].y, x[1].y, x[2].y, x[3].y},
                             {x[0].z, x[1].z, x[2].z, x[3].z},
                             {x[0].w, x[1].w, x[2].w, x[3].w}};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 4 * j + i;
      char* const dst = slot + n * kRowBytes + (((q ^ n) & 7) << 4);
      uint32_t b[4], s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(col[i][e], b[e], s[e]);
      *reinterpret_cast<uint4*>(dst) = make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(dst + T::HALF) =
          make_uint4(s[0], s[1], s[2], s[3]);
    }
  }
}

// dW = dY^T · X: C = dW [N, K] of tiles 128 x BN, the sums over M.  In
// Params, M and N are C's rows and columns (the Linear's N and K), K the
// depth (the Linear's M); c is dW.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const __grid_constant__ Params p,
             const __grid_constant__ CUtensorMap tdy,
             const __grid_constant__ CUtensorMap tx) {
  using T = WTile<BN>;
  constexpr int L = T::LANDS, R = kReady, NA = BN / 2;
  extern __shared__ __align__(1024) char smem[];
  if (smem_u32(smem) % kAlign) __trap();
  char* const ready = smem;
  char* const landing = smem + R * T::SLOT;
  const uint32_t bar0 = smem_u32(landing + L * T::LAND);
  auto land_full = [&](int s) { return bar0 + 8 * s; };
  auto land_empty = [&](int s) { return bar0 + 8 * (L + s); };
  auto ready_full = [&](int s) { return bar0 + 8 * (2 * L + s); };
  auto ready_empty = [&](int s) { return bar0 + 8 * (2 * L + R + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < L; ++s) {
      mbar_init(land_full(s), 1);
      mbar_init(land_empty(s), 2 * kWG);
    }
    for (int s = 0; s < R; ++s) {
      mbar_init(ready_full(s), kSplitters);
      mbar_init(ready_empty(s), 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWG) {
    // -------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     kWgradProducerRegs)
                 : "memory");
    const int pt = threadIdx.x - 2 * kWG;
    int it = 0;
    if (pt < 32) {
      // one thread keeps the landing zones in flight: dY's 128 columns and
      // X's BN columns of 32 rows of M a stage
      if (pt != 0) return;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        int mt, nt;
        tile_of(p, tile, mt, nt);
        for (int kb = 0; kb < p.n_k; ++kb, ++it) {
          const int s = it % L, use = it / L;
          if (use > 0) mbar_wait(land_empty(s), (use - 1) & 1);
          const uint32_t dst = smem_u32(landing + s * T::LAND);
          mbar_arrive_tx(land_full(s), T::LAND);
#pragma unroll
          for (int b = 0; b < kBM / kBK; ++b)
            tma_load_2d(dst + b * kMBox, &tdy, land_full(s),
                        kBM * mt + kBK * b, kBK * kb);
#pragma unroll
          for (int b = 0; b < BN / kBK; ++b)
            tma_load_2d(dst + T::DY + b * kMBox, &tx, land_full(s),
                        BN * nt + kBK * b, kBK * kb);
        }
      }
      return;
    }
    // the other three warps turn each landed X into B's halves
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x)
      for (int kb = 0; kb < p.n_k; ++kb, ++it) {
        const int s = it % L, r = it % R;
        mbar_wait(land_full(s), (it / L) & 1);
        if (it >= R) mbar_wait(ready_empty(r), (it / R - 1) & 1);
        split_transposed<BN>(landing + s * T::LAND + T::DY,
                             ready + r * T::SLOT, pt - 32);
        fence_async_smem();
        mbar_arrive(ready_full(r));
      }
    return;
  }

  // ---------------------------------------------------- consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                   kWgradConsumerRegs)
               : "memory");
  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32;
  const int t = lane & 3, g = lane >> 2;
  // the tile's rows of this thread's sums 16 warp + g and 16 warp + g + 8:
  // C rows n0 and n0 + 4, chosen so that each load of A (dY^T, read from
  // dY's landed boxes: rows of M, 128-byte swizzled) falls on 32 distinct
  // banks over the warp
  const int n0 = 64 * wg + 32 * (warp >> 1) + 8 * (warp & 1) +
                 16 * (g >> 2) + (g & 3);
  // byte offset of dY's (row m, column n) in a landing zone, m < 8
  auto at = [](int m, int n) {
    return (n >> 5) * kMBox + m * kRowBytes +
           (((((n & 31) >> 2) ^ m) & 7) << 4) + 4 * (n & 3);
  };
  // A's k-slots t and t + 4 of k-step kk are rows 8kk + t and 8kk + t + 4
  const int o0 = at(t, n0), o1 = at(t, n0 + 4), o2 = at(t + 4, n0),
            o3 = at(t + 4, n0 + 4);
  float c[NA], acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  int it = 0;

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    int mt, nt;
    tile_of(p, tile, mt, nt);
#pragma unroll
    for (int i = 0; i < NA; ++i) c[i] = 0.f;

#pragma unroll 1
    for (int kb = 0; kb < p.n_k; ++kb, ++it) {
      const int s = it % L, r = it % R;
      const char* const dy = landing + s * T::LAND;
      mbar_wait(land_full(s), (it / L) & 1);
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const char* const row = dy + kk * 8 * kRowBytes;
        split(*reinterpret_cast<const float*>(row + o0), ab[kk][0],
              as[kk][0]);
        split(*reinterpret_cast<const float*>(row + o1), ab[kk][1],
              as[kk][1]);
        split(*reinterpret_cast<const float*>(row + o2), ab[kk][2],
              as[kk][2]);
        split(*reinterpret_cast<const float*>(row + o3), ab[kk][3],
              as[kk][3]);
      }
      mbar_wait(ready_full(r), (it / R) & 1);
      // A is in registers and X split: the landing zone is free
      mbar_arrive(land_empty(s));
      const char* const slot = ready + r * T::SLOT;
      const uint64_t bb = desc(smem_u32(slot), 16, 1024);
      const uint64_t bs = desc(smem_u32(slot + T::HALF), 16, 1024);
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // + 32 bytes (2 units) a k-step
        wgmma_tf32(acc, as[kk], bb + 2 * kk, kk > 0);
        wgmma_tf32(acc, ab[kk], bs + 2 * kk, 1);
        wgmma_tf32(acc, ab[kk], bb + 2 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
      mbar_arrive(ready_empty(r));
#pragma unroll
      for (int i = 0; i < NA; ++i) c[i] += acc[i];
    }

    // the epilogue, once a tile of n_k stages: from registers, pairs of
    // columns where C's rows are whole 8 bytes
    const int col0 = BN * nt + 2 * t;
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int row = kBM * mt + n0 + 4 * ((i >> 1) & 1);
      const int col = col0 + 8 * (i >> 2);
      if (row >= p.M || col >= p.N) continue;
      float* const dst = p.c + static_cast<long long>(row) * p.N + col;
      if (p.N % 2 == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(c[i], c[i + 1]);
      } else {
        dst[0] = c[i];
        if (col + 1 < p.N) dst[1] = c[i + 1];
      }
    }
  }
}

// w [R, C] row-major into its TF32 halves big and small: [R, C] as w is, or
// transposed to [C, R], each row of the halves `ld` elements apart (the
// padding past a row's end left unwritten).  32 x 32 tiles, 256 threads.
__global__ void __launch_bounds__(256)
split_kernel(const float* __restrict__ w, float* __restrict__ big,
             float* __restrict__ small, int R, int C, int ld, int transpose) {
  __shared__ float tb[32][33], ts[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int r0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int r = r0 + j;
    if (r >= R || c >= C) continue;
    uint32_t b, s;
    split_rn(w[static_cast<long long>(r) * C + c], b, s);
    if (transpose) {
      tb[j][threadIdx.x] = __uint_as_float(b);
      ts[j][threadIdx.x] = __uint_as_float(s);
    } else {
      const long long at = static_cast<long long>(r) * ld + c;
      big[at] = __uint_as_float(b);
      small[at] = __uint_as_float(s);
    }
  }
  if (!transpose) return;
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int col = blockIdx.x * 32 + j, r = r0 + threadIdx.x;
    if (col >= C || r >= R) continue;
    const long long at = static_cast<long long>(col) * ld + r;
    big[at] = tb[threadIdx.x][j];
    small[at] = ts[threadIdx.x][j];
  }
}

// ------------------------------------------------------------------ host

// a 2-D map over a row-major [rows, cols] f32 matrix of row stride ld, of
// boxes of 32 columns (128 bytes) x box_rows rows, 128-byte swizzle.  Reads
// past a bound give zeros; writes past one are dropped.
bool encode_2d(CUtensorMap* map, const void* base, int cols, int rows,
               int ld, int box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int run(const Params& p, int grid, const CUtensorMap& ta,
        const CUtensorMap& tbb, const CUtensorMap& tbs, const CUtensorMap& tc,
        cudaStream_t stream) {
  auto kernel = gemm_kernel<BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, Tile<BN>::SMEM, stream>>>(p, ta, tbb, tbs, tc);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int run_wgrad(const Params& p, int grid, const CUtensorMap& tdy,
              const CUtensorMap& tx, cudaStream_t stream) {
  auto kernel = wgrad_kernel<BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WTile<BN>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, WTile<BN>::SMEM, stream>>>(p, tdy, tx);
  return static_cast<int>(cudaGetLastError());
}

int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<int>(err);
}

}  // namespace

// C[M, N] = A[M, K] · B[N, K]^T (+ bias[N]), B given as its TF32 halves
// (lstc_gemm_split); A and B row-major with row strides lda and ldb
// (multiples of 4, at least K), C row-major and contiguous.  Tiles of 128
// columns, or 64 where 128-column ones would not give every SM one.
extern "C" int lstc_gemm(const void* a, int lda, const void* b_big,
                         const void* b_small, int ldb, const void* bias,
                         void* c, int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1 || lda < K || ldb < K || lda % 4 || ldb % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const long long n_m = (M + kBM - 1) / kBM;
  const int bn = n_m * ((N + 127) / 128) < sms ? 64 : 128;
  const long long tiles = n_m * ((N + bn - 1) / bn);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.bias = static_cast<const float*>(bias);
  const bool ragged = N % 4 != 0;  // C's rows not whole 16 bytes
  p.c = ragged ? static_cast<float*>(c) : nullptr;
  p.M = M;
  p.N = N;
  p.K = K;
  p.n_m = static_cast<int>(n_m);
  p.n_n = (N + bn - 1) / bn;
  p.n_k = (K + kBK - 1) / kBK;
  p.n_tiles = static_cast<int>(tiles);
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  CUtensorMap ta{}, tbb{}, tbs{}, tc{};
  if (!encode_2d(&ta, a, K, M, lda, kBM) ||
      !encode_2d(&tbb, b_big, K, N, ldb, bn) ||
      !encode_2d(&tbs, b_small, K, N, ldb, bn) ||
      (!ragged && !encode_2d(&tc, c, N, M, N, 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return bn == 64 ? run<64>(p, grid, ta, tbb, tbs, tc, s)
                  : run<128>(p, grid, ta, tbb, tbs, tc, s);
}

// dW[N, K] = dY[M, N]^T · X[M, K], dY and X row-major with row strides
// lddy and ldx (multiples of 4, at least N and K), dW row-major and
// contiguous.  Tiles of 128 x 128, or 128 x 64 where 128-column ones would
// not give every SM one.
extern "C" int lstc_gemm_wgrad(const void* dy, int lddy, const void* x,
                               int ldx, void* dw, int M, int N, int K,
                               void* stream) {
  if (M < 1 || N < 1 || K < 1 || lddy < N || ldx < K || lddy % 4 || ldx % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const long long n_m = (N + kBM - 1) / kBM;
  const int bn = n_m * ((K + 127) / 128) < sms ? 64 : 128;
  const long long tiles = n_m * ((K + bn - 1) / bn);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.c = static_cast<float*>(dw);
  p.M = N;
  p.N = K;
  p.K = M;
  p.n_m = static_cast<int>(n_m);
  p.n_n = (K + bn - 1) / bn;
  p.n_k = (M + kBK - 1) / kBK;
  p.n_tiles = static_cast<int>(tiles);
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  CUtensorMap tdy{}, tx{};
  if (!encode_2d(&tdy, dy, N, M, lddy, kBK) ||
      !encode_2d(&tx, x, K, M, ldx, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return bn == 64 ? run_wgrad<64>(p, grid, tdy, tx, s)
                  : run_wgrad<128>(p, grid, tdy, tx, s);
}

// w [rows, cols] row-major into big and small, each [rows, cols], or
// [cols, rows] with `transpose`, their rows `ld` elements apart
extern "C" int lstc_gemm_split(const void* w, void* big, void* small,
                               int rows, int cols, int ld, int transpose,
                               void* stream) {
  if (rows < 1 || cols < 1 || (rows + 31) / 32 > 65535 ||
      ld < (transpose ? rows : cols))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32), block(32, 8);
  split_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(big),
      static_cast<float*>(small), rows, cols, ld, transpose);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lstc_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
