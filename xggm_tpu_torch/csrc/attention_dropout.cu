// Attention with in-kernel dropout on the probabilities, forward and
// backward, for LXMERT's short sequences, for Hopper (sm_90a).
//
// Replaces the TPU kernels of xggm_tpu/ops/pallas_attention.py:
//   _attention_dropout_fwd_kernel (launched by _fused_dropout_fwd_impl) and
//   _attention_dropout_bwd_kernel (launched by _fused_dropout_bwd_impl),
// reached through mha_pallas_dropout on every training forward and
// backward. For each (batch * head) row r, with q [BH, Lq, 64], k and v
// [BH, Lk, 64], bias an fp32 additive key mask [B, Lk] read at r / heads
// (null: no mask) and scale = 1 / sqrt(64):
//
//   p  = softmax(q k^T * scale + bias)                      fp32
//   m  = keep_scale where Philox(seed, r, i, j) >= threshold, else 0
//   o  = round(p * m) v              forward; round = to the input type,
//                                    as the TPU kernel's (p * m).astype
//   dv = (p * m)^T g                 backward, all fp32, from the same m
//   dp = m * (g v^T)
//   ds = p * (dp - rowsum(dp * p))
//   dq = ds k * scale,  dk = ds^T q * scale
//
// The mask is never stored: both kernels draw it from the counter-based
// Philox4x32-10 of attention_common.cuh, so the backward redraws exactly
// the forward's mask (and ops/philox.py draws it on the host). There is no
// bias gradient. With threshold 0 and keep_scale 1 the backward is the
// gradient of attention_fwd.cu, which uses it as its own backward.
//
// What bounds them: memory bandwidth. At Lq = Lk = 36 in bf16 a row of the
// backward reads q, k, v, g and writes dq, dk, dv, about 32 KB, for about
// 1.3 MFLOP and 1296 Philox draws: far below the ~295 FLOP/byte at which
// the tensor cores become the limit. So the design keeps p, m, dp and ds
// out of device memory and reads each input once, with 16-byte loads.
//
// Design, simple first (as attention_fwd.cu): one block of four warps per
// row; the inputs staged in shared memory as fp32, k and v rows padded to
// 65 floats so that 32 lanes reading 32 keys hit 32 banks; lane j holds
// keys j and j + 32, and row reductions are warp shuffles. The forward is
// kernel 1's body with the dropout multiplier (attention_common.cuh,
// attention_forward_block). The backward keeps p * m and ds in shared
// memory ([Lq][Lk] fp32 each): a first pass over query rows computes them
// and dq, a second pass over key rows sums dv and dk. wgmma, TMA and
// several rows per block are left for later work.

#include "attention_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_dropout_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ bias,
                             T* __restrict__ o, int lq, int lk, int heads,
                             float scale, Dropout drop) {
  attention_forward_block<T, true>(q, k, v, bias, o, lq, lk, heads, scale,
                                   drop);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_dropout_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ bias,
                             const T* __restrict__ g, T* __restrict__ dq,
                             T* __restrict__ dk, T* __restrict__ dv, int lq,
                             int lk, int heads, float scale, Dropout drop) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [lq][64]
  float* gs = qs + lq * kHeadDim;       // [lq][64]
  float* ks = gs + lq * kHeadDim;       // [lk][65]
  float* vs = ks + lk * kKeyPitch;      // [lk][65]
  float* pms = vs + lk * kKeyPitch;     // [lq][lk]  p * m
  float* dss = pms + lq * lk;           // [lq][lk]  ds

  const size_t row = blockIdx.x;
  stage(q + row * lq * kHeadDim, qs, lq, kHeadDim);
  stage(g + row * lq * kHeadDim, gs, lq, kHeadDim);
  stage(k + row * lk * kHeadDim, ks, lk, kKeyPitch);
  stage(v + row * lk * kHeadDim, vs, lk, kKeyPitch);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has0 = lane < lk;
  const bool has1 = lane + 32 < lk;
  const float* brow = bias ? bias + (row / heads) * lk : nullptr;
  const float b0 = (brow && has0) ? brow[lane] : 0.f;
  const float b1 = (brow && has1) ? brow[lane + 32] : 0.f;
  const int j0 = has0 ? lane : 0;  // lanes past lk read row 0, discard it
  const int j1 = has1 ? lane + 32 : 0;
  const float* k0 = ks + j0 * kKeyPitch;
  const float* k1 = ks + j1 * kKeyPitch;
  const float* v0 = vs + j0 * kKeyPitch;
  const float* v1 = vs + j1 * kKeyPitch;

  // pass 1, over query rows: p, m, dp, ds; p * m and ds to shared memory;
  // dq[i] = scale * sum_j ds[i][j] k[j]
  for (int i = warp; i < lq; i += kWarps) {
    const float* qi = qs + i * kHeadDim;
    const float* gi = gs + i * kHeadDim;
    const float2 p = softmax_row(qi, k0, k1, has0, has1, b0, b1, scale);
    const float m0 = has0 ? dropout_multiplier(drop.seed, (uint32_t)row, i,
                                               lane, drop.threshold,
                                               drop.keep_scale)
                          : 0.f;
    const float m1 = has1 ? dropout_multiplier(drop.seed, (uint32_t)row, i,
                                               lane + 32, drop.threshold,
                                               drop.keep_scale)
                          : 0.f;
    float gv0 = 0.f, gv1 = 0.f;
#pragma unroll 16
    for (int d = 0; d < kHeadDim; ++d) {
      const float gd = gi[d];
      gv0 = fmaf(gd, v0[d], gv0);
      gv1 = fmaf(gd, v1[d], gv1);
    }
    const float dp0 = m0 * gv0;  // m is 0 past lk
    const float dp1 = m1 * gv1;
    const float rowsum = warp_sum(dp0 * p.x + dp1 * p.y);
    const float ds0 = p.x * (dp0 - rowsum);
    const float ds1 = p.y * (dp1 - rowsum);
    if (has0) {
      pms[i * lk + lane] = p.x * m0;
      dss[i * lk + lane] = ds0;
    }
    if (has1) {
      pms[i * lk + lane + 32] = p.y * m1;
      dss[i * lk + lane + 32] = ds1;
    }

    float a0 = 0.f, a1 = 0.f;  // dq dims lane and lane + 32
    for (int j = 0; j < lk; ++j) {
      const float dsj = __shfl_sync(0xffffffffu, j < 32 ? ds0 : ds1, j & 31);
      a0 = fmaf(dsj, ks[j * kKeyPitch + lane], a0);
      a1 = fmaf(dsj, ks[j * kKeyPitch + lane + 32], a1);
    }
    T* out = dq + (row * lq + i) * kHeadDim;
    out[lane] = from_float<T>(a0 * scale);
    out[lane + 32] = from_float<T>(a1 * scale);
  }
  __syncthreads();

  // pass 2, over key rows: dv[j] = sum_i pm[i][j] g[i],
  // dk[j] = scale * sum_i ds[i][j] q[i]
  for (int j = warp; j < lk; j += kWarps) {
    float v0acc = 0.f, v1acc = 0.f, k0acc = 0.f, k1acc = 0.f;
    for (int i = 0; i < lq; ++i) {
      const float pm = pms[i * lk + j];  // one address: a broadcast
      const float ds = dss[i * lk + j];
      v0acc = fmaf(pm, gs[i * kHeadDim + lane], v0acc);
      v1acc = fmaf(pm, gs[i * kHeadDim + lane + 32], v1acc);
      k0acc = fmaf(ds, qs[i * kHeadDim + lane], k0acc);
      k1acc = fmaf(ds, qs[i * kHeadDim + lane + 32], k1acc);
    }
    T* dvrow = dv + (row * lk + j) * kHeadDim;
    T* dkrow = dk + (row * lk + j) * kHeadDim;
    dvrow[lane] = from_float<T>(v0acc);
    dvrow[lane + 32] = from_float<T>(v1acc);
    dkrow[lane] = from_float<T>(k0acc * scale);
    dkrow[lane + 32] = from_float<T>(k1acc * scale);
  }
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, void* o, int bh, int lq, int lk,
                       int heads, Dropout drop, cudaStream_t stream) {
  const size_t smem = forward_smem_bytes(lq, lk);
  const cudaError_t err = allow_smem(attention_dropout_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  attention_dropout_fwd_kernel<T><<<bh, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), lq, lk, heads, head_scale(), drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* bias, const void* g, void* dq, void* dk,
                       void* dv, int bh, int lq, int lk, int heads,
                       Dropout drop, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * lq * kHeadDim +
                                               2 * lk * kKeyPitch +
                                               2 * lq * lk);
  const cudaError_t err = allow_smem(attention_dropout_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  attention_dropout_bwd_kernel<T><<<bh, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), lq, lk, heads, head_scale(), drop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel 2. q [bh, lq, 64], k and v [bh, lk, 64], o [bh, lq, 64], all
// contiguous, 16-byte aligned and of one type (is_bf16: 1 for bf16, 0 for
// fp32); bias fp32 [bh / heads, lk] or null. Row r keeps score (i, j) when
// Philox draws at least `threshold` and scales it by keep_scale. Returns
// cudaGetLastError() after the launch.
int xggm_attention_dropout_fwd(const void* q, const void* k, const void* v,
                               const void* bias, void* o, int bh, int lq,
                               int lk, int heads, int is_bf16, uint32_t seed,
                               uint32_t threshold, float keep_scale,
                               void* stream) {
  if (bad_shape(bh, lq, lk, heads)) return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, threshold, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, bias, o, bh, lq,
                                                   lk, heads, drop, s)
                       : launch_fwd<float>(q, k, v, bias, o, bh, lq, lk,
                                           heads, drop, s));
}

// Kernel 3. As kernel 2, plus g [bh, lq, 64] (the gradient of o) in, and
// dq [bh, lq, 64], dk and dv [bh, lk, 64] out, in the inputs' type.
int xggm_attention_dropout_bwd(const void* q, const void* k, const void* v,
                               const void* bias, const void* g, void* dq,
                               void* dk, void* dv, int bh, int lq, int lk,
                               int heads, int is_bf16, uint32_t seed,
                               uint32_t threshold, float keep_scale,
                               void* stream) {
  if (bad_shape(bh, lq, lk, heads)) return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, threshold, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, bias, g, dq, dk,
                                                   dv, bh, lq, lk, heads,
                                                   drop, s)
                       : launch_bwd<float>(q, k, v, bias, g, dq, dk, dv, bh,
                                           lq, lk, heads, drop, s));
}

const char* xggm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
