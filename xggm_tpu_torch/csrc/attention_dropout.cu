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
// The forward (kernel 2) in bf16 is kernel 1's tensor-core body with the
// dropout multiplier (attention_common.cuh, attention_forward_block_bf16
// with kDropout; attention_fwd.cu sets out the design), shared with kernel
// 5 of attention_blhd.cu: p * m in fp32 between the softmax and the bf16
// rounding of p v's operand, m drawn as the bf16 backward draws it (one
// Philox call per four keys) while v is still in flight. The first port's
// body, which it replaces in bf16, staged the inputs in shared memory as
// fp32, ran q k^T and p v as scalar FMAs (p broadcast by shuffle, one key
// at a time) and made one Philox call per key: 1.65 ms per training
// forward against a 0.162 ms bound on an H100 (700 W), slower than SDPA at
// dropout 0.1. fp32 inputs keep it (attention_forward_block).
//
// The backward (kernel 3) in bf16 is attention_backward_block_bf16, shared
// with kernel 6 of attention_blhd.cu. The first port of it, a scalar-FMA
// body like the forward's, was bound by shared-memory instructions (a load
// for every FMA, 3.24 ms per training backward against a 0.284 ms bound on
// an H100, 700 W), by fp32 staging that left 4 blocks of 47.5 KB per SM,
// and by one Philox call per key. The bf16 body runs the five products on
// the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulation; p * m
// and ds as bf16 hi + lo), copies q, k, v and g once with cp.async into
// bf16 shared memory, reads the transposes with ldmatrix.trans, draws one
// Philox call per four keys, and runs one warp per 16 queries: 2 or 3 warps
// and 18 to 37 KB per row on the path, 6 to 12 rows per SM. fp32 inputs
// keep the first port's body (attention_backward_block): they cannot be
// bf16 tensor-core operands, and fp32 is on no path. The mask is drawn
// with the same bits by every body of kernels 2 and 3.

#include <type_traits>

#include "attention_common.cuh"

namespace {

// The scalar forward, launched for fp32 only.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_dropout_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ bias,
                             T* __restrict__ o, int lq, int lk, int heads,
                             float scale, Dropout drop) {
  attention_forward_block<T, true>(q, k, v, bias, o, lq, lk, heads, 1,
                                   scale, drop);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, kBackwardBlocksPerSm)
attention_dropout_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ bias,
                             const T* __restrict__ g, T* __restrict__ dq,
                             T* __restrict__ dk, T* __restrict__ dv, int lq,
                             int lk, int heads, float scale, Dropout drop) {
  attention_backward_block<T>(q, k, v, bias, g, dq, dk, dv, lq, lk, heads, 1,
                              scale, drop);
}

// The bf16 forward on the tensor cores, keys padded to 16 * kKeyTiles.
template <int kKeyTiles>
__global__ void __launch_bounds__(kBf16MaxThreads,
                                  kForwardBf16MinBlocks<kKeyTiles>)
attention_dropout_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const float* __restrict__ bias,
                                  __nv_bfloat16* __restrict__ o, int lq,
                                  int lk, int heads, float scale,
                                  Dropout drop) {
  attention_forward_block_bf16<kKeyTiles, true>(q, k, v, bias, o, lq, lk,
                                                heads, 1, scale, drop);
}

const Bf16ForwardKernel kDropoutFwdBf16[4] = {
    attention_dropout_fwd_bf16_kernel<1>,
    attention_dropout_fwd_bf16_kernel<2>,
    attention_dropout_fwd_bf16_kernel<3>,
    attention_dropout_fwd_bf16_kernel<4>};

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, void* o, int bh, int lq, int lk,
                       int heads, Dropout drop, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static const cudaError_t prepared = prefer_shared_memory(kDropoutFwdBf16);
    if (prepared != cudaSuccess) return prepared;
    return launch_forward_bf16(kDropoutFwdBf16, q, k, v, bias, o, bh, lq, lk,
                               heads, drop, stream);
  } else {
    const size_t smem = forward_smem_bytes(lq, lk);
    const cudaError_t err = allow_smem(attention_dropout_fwd_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    attention_dropout_fwd_kernel<T><<<bh, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(bias),
        static_cast<T*>(o), lq, lk, heads, head_scale(), drop);
    return cudaGetLastError();
  }
}

// The bf16 backward on the tensor cores, keys padded to 16 * kKeyTiles.
template <int kKeyTiles>
__global__ void __launch_bounds__(kBf16MaxThreads,
                                  kBackwardBf16MinBlocks<kKeyTiles>)
attention_dropout_bwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int lq,
    int lk, int heads, float scale, Dropout drop) {
  attention_backward_block_bf16<kKeyTiles>(q, k, v, bias, g, dq, dk, dv, lq,
                                           lk, heads, 1, scale, drop);
}

const Bf16BackwardKernel kDropoutBwdBf16[4] = {
    attention_dropout_bwd_bf16_kernel<1>,
    attention_dropout_bwd_bf16_kernel<2>,
    attention_dropout_bwd_bf16_kernel<3>,
    attention_dropout_bwd_bf16_kernel<4>};

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* bias, const void* g, void* dq, void* dk,
                       void* dv, int bh, int lq, int lk, int heads,
                       Dropout drop, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_backward_bf16(kDropoutBwdBf16, q, k, v, bias, g, dq, dk, dv,
                                bh, lq, lk, heads, drop, stream);
  } else {
    const size_t smem = backward_smem_bytes(lq, lk);
    const cudaError_t err = allow_smem(attention_dropout_bwd_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    attention_dropout_bwd_kernel<T><<<bh, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(bias),
        static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), lq, lk, heads, head_scale(), drop);
    return cudaGetLastError();
  }
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

// Dynamic shared memory of one block of kernel 3's bf16 body at (lq, lk),
// for reports; kernel 6 takes the same.
size_t xggm_attention_bwd_bf16_smem_bytes(int lq, int lk) {
  return backward_bf16_smem_bytes(lq, lk);
}

const char* xggm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
