// Fused softmax attention forward for LXMERT's short sequences, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel xggm_tpu/ops/pallas_attention.py::_attention_kernel
// (launched by _fused_attention_fwd_impl, reached through mha_pallas). For
// each (batch * head) row it computes
//
//     o = softmax(q k^T / sqrt(64) + bias) v
//
// with q [BH, Lq, 64], k and v [BH, Lk, 64], bias an fp32 additive key mask
// [B, Lk] read for row r at r / heads (a null pointer means no mask), the
// scores and the softmax in fp32, p rounded to the input type before the
// second product (as the TPU kernel's p.astype(v.dtype)), the second product
// accumulated in fp32 and the output written in the input type. Inputs are
// bf16 (the serving path) or fp32.
//
// What bounds it: memory bandwidth. At Lq = Lk = 36 in bf16 a row reads
// q, k, v and writes o, about 18.4 KB, for about 0.33 MFLOP: some
// 18 FLOP/byte, far below the ~295 FLOP/byte at which an H100's tensor
// cores become the limit. So the design keeps the [Lq, Lk] scores and
// probabilities out of device memory, reads each input once and writes o
// once, 16 bytes a thread, and keeps the instructions around the products
// few enough that the bytes stay the limit.
//
// Design, bf16 (the serving path; attention_common.cuh,
// attention_forward_block_bf16, shared with kernels 2, 4 and 5): both
// products on the
// tensor cores, mma.sync m16n8k16 with bf16 operands and fp32 accumulation,
// one warp per 16 queries; q, k and v copied by cp.async into bf16 shared
// memory, the operands read by ldmatrix; the scores and the fp32 softmax
// are the code of kernel 3's bf16 body (softmax_bf16), and p enters p v
// from registers, rounded to bf16. mma.sync and not wgmma: wgmma takes
// tiles of 64 rows, and a row here has at most 36 queries on the path.
// One block per row: on an H100 that beat persistent blocks with a
// two-stage cp.async ring. The first port's scalar body (fp32 in shared
// memory, one warp per query row, two scalar FMAs per shared-memory load
// pair) ran at 12% of its bound on an H100 (700 W); by a count of its
// instructions, shared-memory loads held it. fp32 inputs keep it
// (attention_forward_block): fp32 cannot be a bf16 tensor-core operand, and
// fp32 is on no path.

#include <type_traits>

#include "attention_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ o, int lq, int lk, int heads,
                     float scale) {
  attention_forward_block<T, false>(q, k, v, bias, o, lq, lk, heads, 1,
                                    scale, Dropout{0u, 0u, 1.f});
}

// The bf16 forward on the tensor cores, keys padded to 16 * kKeyTiles.
template <int kKeyTiles>
__global__ void __launch_bounds__(kBf16MaxThreads,
                                  kForwardBf16MinBlocks<kKeyTiles>)
attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ o, int lq, int lk,
                          int heads, float scale, Dropout drop) {
  attention_forward_block_bf16<kKeyTiles, false>(q, k, v, bias, o, lq, lk,
                                                 heads, 1, scale, drop);
}

const Bf16ForwardKernel kFwdBf16[4] = {
    attention_fwd_bf16_kernel<1>, attention_fwd_bf16_kernel<2>,
    attention_fwd_bf16_kernel<3>, attention_fwd_bf16_kernel<4>};

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, int bh, int lq, int lk,
                   int heads, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static const cudaError_t prepared = prefer_shared_memory(kFwdBf16);
    if (prepared != cudaSuccess) return prepared;
    return launch_forward_bf16(kFwdBf16, q, k, v, bias, o, bh, lq, lk, heads,
                               Dropout{0u, 0u, 1.f}, stream);
  } else {
    const size_t smem = forward_smem_bytes(lq, lk);
    const cudaError_t err = allow_smem(attention_fwd_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    attention_fwd_kernel<T><<<bh, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(bias),
        static_cast<T*>(o), lq, lk, heads, head_scale());
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// q [bh, lq, 64], k and v [bh, lk, 64], o [bh, lq, 64], all contiguous,
// 16-byte aligned and of one type (is_bf16: 1 for bf16, 0 for fp32);
// bias fp32 [bh / heads, lk] or null. Returns cudaGetLastError() after the
// launch, so a refused launch is reported here and not lost.
int xggm_attention_fwd(const void* q, const void* k, const void* v,
                       const void* bias, void* o, int bh, int lq, int lk,
                       int heads, int is_bf16, void* stream) {
  if (bad_shape(bh, lq, lk, heads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch<__nv_bfloat16>(q, k, v, bias, o, bh, lq, lk,
                                           heads, s)
                   : launch<float>(q, k, v, bias, o, bh, lq, lk, heads, s));
}

// For reports: the dynamic shared memory of one block of kernel 1's bf16
// body at (lq, lk).
size_t xggm_attention_fwd_bf16_smem_bytes(int lq, int lk) {
  return forward_bf16_smem_bytes(lq, lk);
}

const char* xggm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
