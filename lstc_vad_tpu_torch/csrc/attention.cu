// Fused scaled dot-product attention with an additive bias, for Hopper (sm_90a).
//
//   out[b,h] = softmax(q[b,h] · k[b,h]^T / temperature + bias[h]) · v[b,h]
//
// q, k, v, out: [B, H, L, D] float32, contiguous.  bias: [H, L, L] float32 or
// null, broadcast over B.  D is a multiple of 32 and at most 256.
//
// Replaces the TPU kernel lstc_vad_tpu/ops/pallas_attention.py::_kernel
// (launched by _forward, entry pallas_sdpa).  That kernel packs floor(128/L)
// (batch, head) pairs block-diagonally under a -1e30 mask to fill the TPU's
// 128x128 matrix unit; the packing is a layout for that unit only, so this
// kernel computes the function and not the packing.
//
// What bounds it on an H100 SXM.  At the main path's widest shape (L=49,
// B=2048, H=8, D=256, f32) it must move q, k, v and out once:
// 4 * 16384 * 49 * 256 * 4 B ~= 3.3 GB, about 1.0 ms at 3.35 TB/s.  Its
// arithmetic, 2 * 2 * 16384 * 49^2 * 256 FLOP ~= 40 GFLOP, takes about 0.6 ms
// at the 67 TFLOP/s of f32 outside the tensor cores.  So it is bound by the
// bytes.  The [L, L] scores never go to device memory, which is the point of
// fusing.  The math is IEEE f32 throughout (no TF32, no fast-math exp): the
// port's parity path is f32.
//
// Design (simple first; speed is later work):
// - one block per (b, h) pair, B*H blocks;
// - K and V of the pair staged once in dynamic shared memory with 16-byte
//   loads: 2*L*D*4 bytes, 166 KB at L=81, D=256 (above 48 KB only after
//   cudaFuncSetAttribute; the wrapper refuses shapes past 227 KB);
// - one warp per query row, min(L, 16) warps per block striding the rows.
//   Lane l holds q[row, l + 32t] / temperature in registers (t < D/32), so
//   its shared-memory reads of a K or V row are consecutive across the warp
//   and free of bank conflicts.  A score is an f32 FMA chain per lane and a
//   butterfly sum by warp shuffle; the row's max, exp and sum follow with the
//   row's L scores in shared memory; then sum_j p_j * v_j accumulates in
//   registers and is stored coalesced.
//
// The encoder's GEMMs (projections, FFN, head: about 9.9 GFLOP per part at
// sht_ltn width) stay nn.Linear / torch.matmul on cuBLAS, as the JAX package
// left them to XLA.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPerLane = 8;  // D <= 8 * 32
constexpr int kMaxWarps = 16;

__device__ __forceinline__ float warp_sum(float x) {
  // butterfly: every lane ends with the same, bit-identical sum
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void attention_fwd_kernel(const float* __restrict__ q,
                                     const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const float* __restrict__ bias,
                                     float* __restrict__ out,
                                     int H, int L, int D, float temperature) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + static_cast<size_t>(L) * D;
  float* ps = vs + static_cast<size_t>(L) * D;  // one row of L scores per warp

  const size_t pair = blockIdx.x;  // b * H + h
  const int h = static_cast<int>(pair % H);
  const size_t base = pair * static_cast<size_t>(L) * D;

  // stage K and V of this (b, h) pair; D % 32 == 0 keeps rows 16-byte aligned
  const int n4 = L * D / 4;
  const float4* k4 = reinterpret_cast<const float4*>(k + base);
  const float4* v4 = reinterpret_cast<const float4*>(v + base);
  float4* ks4 = reinterpret_cast<float4*>(ks);
  float4* vs4 = reinterpret_cast<float4*>(vs);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    ks4[i] = k4[i];
    vs4[i] = v4[i];
  }
  __syncthreads();

  const int n_warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int per_lane = D / kWarp;
  float* p = ps + static_cast<size_t>(warp) * L;
  const float* bias_h = bias ? bias + static_cast<size_t>(h) * L * L : nullptr;

  for (int row = warp; row < L; row += n_warps) {
    const float* q_row = q + base + static_cast<size_t>(row) * D;
    float qr[kMaxPerLane];
#pragma unroll
    for (int t = 0; t < kMaxPerLane; ++t)
      qr[t] = t < per_lane ? q_row[lane + kWarp * t] / temperature : 0.f;

    // scores of this row against every key
    float row_max = -INFINITY;
    for (int j = 0; j < L; ++j) {
      const float* k_row = ks + static_cast<size_t>(j) * D;
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxPerLane; ++t)
        if (t < per_lane) s = fmaf(qr[t], k_row[lane + kWarp * t], s);
      s = warp_sum(s);
      if (bias_h) s += bias_h[static_cast<size_t>(row) * L + j];
      row_max = fmaxf(row_max, s);
      if (lane == 0) p[j] = s;
    }
    __syncwarp();

    // softmax over the row, lanes striding the keys
    float sum = 0.f;
    for (int j = lane; j < L; j += kWarp) {
      const float e = expf(p[j] - row_max);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += kWarp) p[j] = p[j] / sum;
    __syncwarp();

    // out[row] = sum_j p_j * v_j
    float acc[kMaxPerLane];
#pragma unroll
    for (int t = 0; t < kMaxPerLane; ++t) acc[t] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float pj = p[j];
      const float* v_row = vs + static_cast<size_t>(j) * D;
#pragma unroll
      for (int t = 0; t < kMaxPerLane; ++t)
        if (t < per_lane) acc[t] = fmaf(pj, v_row[lane + kWarp * t], acc[t]);
    }
    float* o_row = out + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int t = 0; t < kMaxPerLane; ++t)
      if (t < per_lane) o_row[lane + kWarp * t] = acc[t];
    __syncwarp();  // p is rewritten by this warp's next row
  }
}

}  // namespace

extern "C" int lstc_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, int B, int H,
                                  int L, int D, float temperature,
                                  void* stream) {
  // keep in step with ops/cuda_attention.py::smem_bytes
  const int n_warps = L < kMaxWarps ? L : kMaxWarps;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(L) * D + static_cast<size_t>(n_warps) * L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>(B) * static_cast<unsigned>(H);
  attention_fwd_kernel<<<grid, n_warps * kWarp, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), H, L, D, temperature);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lstc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
