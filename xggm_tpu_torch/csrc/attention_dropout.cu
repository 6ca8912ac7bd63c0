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
// attention_forward_block). The backward (attention_backward_block, shared
// with kernel 6 of attention_blhd.cu) keeps p * m and ds in shared memory
// ([Lq][Lk] fp32 each): a first pass over query rows computes them and dq,
// a second pass over key rows sums dv and dk. wgmma, TMA and several rows
// per block are left for later work.

#include "attention_common.cuh"

namespace {

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
