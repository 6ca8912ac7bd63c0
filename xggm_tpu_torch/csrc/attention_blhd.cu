// Attention in the [B, L, H, 64] projection layout (BLHD), with and without
// dropout on the probabilities, forward and backward, for LXMERT's short
// sequences, for Hopper (sm_90a).
//
// Replaces the TPU kernels of xggm_tpu/ops/pallas_attention.py:
//   kernel 4, _attention_blhd_kernel (launched by _fused_attention_blhd_impl,
//             reached through fused_attention_blhd and mha_pallas_blhd);
//   kernel 5, _attention_dropout_blhd_fwd_kernel and
//   kernel 6, _attention_dropout_blhd_bwd_kernel (launched by
//             _fused_dropout_blhd_{fwd,bwd}_impl, reached through
//             fused_attention_dropout_blhd and mha_pallas_dropout_blhd).
// They compute what kernels 1, 2 and 3 compute (attention_fwd.cu,
// attention_dropout.cu set out the math) on q [B, Lq, H, 64], k and v
// [B, Lk, H, 64], o, dq [B, Lq, H, 64] and dk, dv [B, Lk, H, 64], with bias
// an fp32 additive key mask [B, Lk] (null: no mask): the layout of the
// projections before the head transpose. p * m is rounded to the input type
// before p v, as the TPU kernel's (p * m).astype; there is no bias
// gradient. Kernel 4's backward is kernel 6 at threshold 0 and keep_scale 1.
//
// The mask. The TPU kernels seed the TPU's generator per program and draw
// in head order; neither exists here. Head h of batch b is the (batch *
// head) row r = b * H + h, and draws the Philox4x32-10 mask of
// attention_common.cuh under key (seed + r): the draws of kernel 2's row r.
// So kernels 5 and 6 on a BLHD tensor give the same bits as kernels 2 and 3
// on its permuted [B * H, L, 64] copy with the same seed, and the backward
// redraws the forward's mask.
//
// What bounds them: memory bandwidth, as kernels 1 to 3 (the same bytes and
// FLOPs; the layout changes only the addresses).
//
// Design: kernels 1 to 3's bodies (attention_common.cuh), given H heads
// between positions where kernels 1 to 3 give 1. Kernels 4 and 5 run the
// forward (attention_forward_block_bf16 or _f32, kernel 5 with the dropout
// multiplier: one warp per 16 queries, one block per (b, h);
// attention_fwd.cu sets out why) and kernel 6 the backward
// (attention_backward_block_bf16 or _f32; attention_dropout.cu sets out
// why); all copy their inputs by cp.async. The row of one position of one
// head is 64 contiguous elements (128 bytes in bf16, 256 in fp32), so each
// staged row is still read with coalesced 16-byte loads; rows lie H * 64
// elements apart instead of 64. No transpose is ever materialised, and
// kernels 4 to 6 give the bits of kernels 1 to 3 on the permuted inputs.

#include <type_traits>

#include "attention_common.cuh"

namespace {

// Kernel 4 in bf16 on the tensor cores, keys padded to 16 * kKeyTiles.
template <int kKeyTiles>
__global__ void __launch_bounds__(kMaxThreads,
                                  kForwardBf16MinBlocks<kKeyTiles>)
attention_blhd_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const float* __restrict__ bias,
                               __nv_bfloat16* __restrict__ o, int lq,
                               int lk, int heads, float scale,
                               Dropout drop) {
  attention_forward_block_bf16<kKeyTiles, false>(q, k, v, bias, o, lq, lk,
                                                 heads, heads, scale, drop);
}

const Bf16ForwardKernel kBlhdFwdBf16[4] = {
    attention_blhd_fwd_bf16_kernel<1>, attention_blhd_fwd_bf16_kernel<2>,
    attention_blhd_fwd_bf16_kernel<3>, attention_blhd_fwd_bf16_kernel<4>};

// Kernel 5 in bf16: kernel 4's body with the dropout multiplier.
template <int kKeyTiles>
__global__ void __launch_bounds__(kMaxThreads,
                                  kForwardBf16MinBlocks<kKeyTiles>)
attention_blhd_dropout_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                       const __nv_bfloat16* __restrict__ k,
                                       const __nv_bfloat16* __restrict__ v,
                                       const float* __restrict__ bias,
                                       __nv_bfloat16* __restrict__ o, int lq,
                                       int lk, int heads, float scale,
                                       Dropout drop) {
  attention_forward_block_bf16<kKeyTiles, true>(q, k, v, bias, o, lq, lk,
                                                heads, heads, scale, drop);
}

const Bf16ForwardKernel kBlhdDropoutFwdBf16[4] = {
    attention_blhd_dropout_fwd_bf16_kernel<1>,
    attention_blhd_dropout_fwd_bf16_kernel<2>,
    attention_blhd_dropout_fwd_bf16_kernel<3>,
    attention_blhd_dropout_fwd_bf16_kernel<4>};

// Kernel 4 in fp32 (scores by FMAs, the other products on the
// tensor cores in three TF32 passes), keys up to 16 * kKeyTiles.
template <int kKeyTiles>
__global__ void __launch_bounds__(kMaxThreads,
                                  kForwardF32MinBlocks<kKeyTiles>)
attention_blhd_fwd_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ bias,
                              float* __restrict__ o, int lq, int lk,
                              int heads, float scale, Dropout drop) {
  attention_forward_block_f32<kKeyTiles, false>(q, k, v, bias, o, lq, lk,
                                                heads, heads, scale, drop);
}

const F32ForwardKernel kBlhdFwdF32[4] = {
    attention_blhd_fwd_f32_kernel<1>, attention_blhd_fwd_f32_kernel<2>,
    attention_blhd_fwd_f32_kernel<3>, attention_blhd_fwd_f32_kernel<4>};

// Kernel 5 in fp32: kernel 4's body with the dropout multiplier.
template <int kKeyTiles>
__global__ void __launch_bounds__(kMaxThreads,
                                  kForwardF32MinBlocks<kKeyTiles>)
attention_blhd_dropout_fwd_f32_kernel(const float* __restrict__ q,
                                      const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const float* __restrict__ bias,
                                      float* __restrict__ o, int lq, int lk,
                                      int heads, float scale, Dropout drop) {
  attention_forward_block_f32<kKeyTiles, true>(q, k, v, bias, o, lq, lk,
                                               heads, heads, scale, drop);
}

const F32ForwardKernel kBlhdDropoutFwdF32[4] = {
    attention_blhd_dropout_fwd_f32_kernel<1>,
    attention_blhd_dropout_fwd_f32_kernel<2>,
    attention_blhd_dropout_fwd_f32_kernel<3>,
    attention_blhd_dropout_fwd_f32_kernel<4>};

template <typename T, bool kDropout>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, void* o, int bh, int lq, int lk,
                       int heads, Dropout drop, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const Bf16ForwardKernel(&kernels)[4] =
        kDropout ? kBlhdDropoutFwdBf16 : kBlhdFwdBf16;
    static const cudaError_t prepared = prefer_shared_memory(kernels);
    if (prepared != cudaSuccess) return prepared;
    return launch_forward_bf16(kernels, q, k, v, bias, o, bh, lq, lk, heads,
                               drop, stream);
  } else {
    const F32ForwardKernel(&kernels)[4] =
        kDropout ? kBlhdDropoutFwdF32 : kBlhdFwdF32;
    static const cudaError_t prepared = prefer_shared_memory(kernels);
    if (prepared != cudaSuccess) return prepared;
    return launch_forward_f32(kernels, q, k, v, bias, o, bh, lq, lk, heads,
                              drop, stream);
  }
}

// The bf16 backward on the tensor cores, keys padded to 16 * kKeyTiles.
template <int kKeyTiles>
__global__ void __launch_bounds__(kMaxThreads,
                                  kBackwardBf16MinBlocks<kKeyTiles>)
attention_blhd_bwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int lq,
    int lk, int heads, float scale, Dropout drop) {
  attention_backward_block_bf16<kKeyTiles>(q, k, v, bias, g, dq, dk, dv, lq,
                                           lk, heads, heads, scale, drop);
}

const Bf16BackwardKernel kBlhdBwdBf16[4] = {
    attention_blhd_bwd_bf16_kernel<1>,
    attention_blhd_bwd_bf16_kernel<2>,
    attention_blhd_bwd_bf16_kernel<3>,
    attention_blhd_bwd_bf16_kernel<4>};

// Kernel 6 in fp32 (scores by FMAs, the other products on the
// tensor cores in three TF32 passes), keys up to 16 * kKeyTiles.
template <int kKeyTiles>
__global__ void __launch_bounds__(kMaxThreads,
                                  kBackwardF32MinBlocks<kKeyTiles>)
attention_blhd_bwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ g, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
    int heads, float scale, Dropout drop) {
  attention_backward_block_f32<kKeyTiles>(q, k, v, bias, g, dq, dk, dv, lq,
                                          lk, heads, heads, scale, drop);
}

const F32BackwardKernel kBlhdBwdF32[4] = {
    attention_blhd_bwd_f32_kernel<1>, attention_blhd_bwd_f32_kernel<2>,
    attention_blhd_bwd_f32_kernel<3>, attention_blhd_bwd_f32_kernel<4>};

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* bias, const void* g, void* dq, void* dk,
                       void* dv, int bh, int lq, int lk, int heads,
                       Dropout drop, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_backward_bf16(kBlhdBwdBf16, q, k, v, bias, g, dq, dk, dv,
                                bh, lq, lk, heads, drop, stream);
  } else {
    static const cudaError_t prepared = prefer_shared_memory(kBlhdBwdF32);
    if (prepared != cudaSuccess) return prepared;
    return launch_backward_f32(kBlhdBwdF32, q, k, v, bias, g, dq, dk, dv, bh,
                               lq, lk, heads, drop, stream);
  }
}

bool bad_blhd_shape(int batch, int lq, int lk, int heads) {
  return batch <= 0 || heads <= 0 ||
         bad_shape(batch * heads, lq, lk, heads);
}

}  // namespace

extern "C" {

// Kernel 4. q [batch, lq, heads, 64], k and v [batch, lk, heads, 64], o
// [batch, lq, heads, 64], all contiguous, 16-byte aligned and of one type
// (is_bf16: 1 for bf16, 0 for fp32); bias fp32 [batch, lk] or null.
// Returns cudaGetLastError() after the launch.
int xggm_attention_blhd_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* o, int batch, int lq,
                            int lk, int heads, int is_bf16, void* stream) {
  if (bad_blhd_shape(batch, lq, lk, heads)) return (int)cudaErrorInvalidValue;
  const Dropout none{0u, 0u, 1.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  return (int)(is_bf16 ? launch_fwd<__nv_bfloat16, false>(
                             q, k, v, bias, o, bh, lq, lk, heads, none, s)
                       : launch_fwd<float, false>(q, k, v, bias, o, bh, lq,
                                                  lk, heads, none, s));
}

// Kernel 5. As kernel 4; head h of batch b keeps score (i, j) when the
// Philox draw of row b * heads + h is at least `threshold`, and scales it
// by keep_scale.
int xggm_attention_dropout_blhd_fwd(const void* q, const void* k,
                                    const void* v, const void* bias, void* o,
                                    int batch, int lq, int lk, int heads,
                                    int is_bf16, uint32_t seed,
                                    uint32_t threshold, float keep_scale,
                                    void* stream) {
  if (bad_blhd_shape(batch, lq, lk, heads)) return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, threshold, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  return (int)(is_bf16 ? launch_fwd<__nv_bfloat16, true>(
                             q, k, v, bias, o, bh, lq, lk, heads, drop, s)
                       : launch_fwd<float, true>(q, k, v, bias, o, bh, lq,
                                                 lk, heads, drop, s));
}

// Kernel 6. As kernel 5, plus g [batch, lq, heads, 64] (the gradient of o)
// in, and dq [batch, lq, heads, 64], dk and dv [batch, lk, heads, 64] out,
// in the inputs' type. Threshold 0 and keep_scale 1: kernel 4's backward.
int xggm_attention_dropout_blhd_bwd(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* g, void* dq, void* dk,
                                    void* dv, int batch, int lq, int lk,
                                    int heads, int is_bf16, uint32_t seed,
                                    uint32_t threshold, float keep_scale,
                                    void* stream) {
  if (bad_blhd_shape(batch, lq, lk, heads)) return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, threshold, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
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
