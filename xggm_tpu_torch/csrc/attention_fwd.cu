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
// q, k, v and writes o, about 18.6 KB, for about 0.33 MFLOP: some
// 18 FLOP/byte, far below the ~295 FLOP/byte at which an H100's tensor
// cores become the limit. So the design only keeps the [Lq, Lk] scores and
// probabilities out of device memory and reads each input once, with
// 16-byte loads.
//
// Design, simple first: one block of four warps per (batch * head) row.
// q, k and v are staged in shared memory as fp32 (at most 64 x 64 each);
// k's rows are padded to 65 floats so that the 32 lanes, one key each,
// read 32 different banks. Each warp takes query rows in turn: lane j holds
// the scores of keys j and j + 32 in registers, the row max and sum are
// warp shuffles, and the p @ v product broadcasts p_j by shuffle while lane
// d accumulates output dims d and d + 32. wgmma, TMA and several rows per
// block are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kMaxKeys = 64;           // two keys per lane
constexpr int kWarps = 4;
constexpr int kKeyPitch = kHeadDim + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

// 16 bytes of T as fp32 values, unpacked by bit operations so that the
// vector stays in registers. bf16 is the upper half of an fp32, and element
// 0 sits in the low half of each 32-bit word.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kLen = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kLen = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Copy `rows` contiguous rows of 64 elements into shared memory as fp32,
// `pitch` floats apart, with one 16-byte load per thread and step.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      int rows, int pitch) {
  constexpr int kVec = Vec16<T>::kLen;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  const int n = rows * kHeadDim / kVec;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float f[kVec];
    Vec16<T>::unpack(s[i], f);
    const int r = (i * kVec) / kHeadDim;
    const int c = (i * kVec) % kHeadDim;
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * pitch + c + j] = f[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ o, int lq, int lk, int heads,
                     float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [lq][64]
  float* ks = qs + lq * kHeadDim;       // [lk][65]
  float* vs = ks + lk * kKeyPitch;      // [lk][64]

  const size_t row = blockIdx.x;
  stage(q + row * lq * kHeadDim, qs, lq, kHeadDim);
  stage(k + row * lk * kHeadDim, ks, lk, kKeyPitch);
  stage(v + row * lk * kHeadDim, vs, lk, kHeadDim);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has0 = lane < lk;
  const bool has1 = lane + 32 < lk;
  const float* brow = bias ? bias + (row / heads) * lk : nullptr;
  const float b0 = (brow && has0) ? brow[lane] : 0.f;
  const float b1 = (brow && has1) ? brow[lane + 32] : 0.f;
  // lanes past lk read row 0 and discard the result
  const float* k0 = ks + (has0 ? lane : 0) * kKeyPitch;
  const float* k1 = ks + (has1 ? lane + 32 : 0) * kKeyPitch;

  for (int i = warp; i < lq; i += kWarps) {
    const float* qi = qs + i * kHeadDim;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
    for (int d = 0; d < kHeadDim; ++d) {
      const float qd = qi[d];
      s0 = fmaf(qd, k0[d], s0);
      s1 = fmaf(qd, k1[d], s1);
    }
    s0 = has0 ? s0 * scale + b0 : -INFINITY;
    s1 = has1 ? s1 * scale + b1 : -INFINITY;

    float m = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float e0 = has0 ? expf(s0 - m) : 0.f;
    const float e1 = has1 ? expf(s1 - m) : 0.f;
    float sum = e0 + e1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float p0 = to_float(from_float<T>(e0 / sum));
    const float p1 = to_float(from_float<T>(e1 / sum));

    float o0 = 0.f, o1 = 0.f;  // output dims lane and lane + 32
    for (int j = 0; j < lk; ++j) {
      const float pj = __shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j & 31);
      o0 = fmaf(pj, vs[j * kHeadDim + lane], o0);
      o1 = fmaf(pj, vs[j * kHeadDim + lane + 32], o1);
    }
    T* orow = o + (row * lq + i) * kHeadDim;
    orow[lane] = from_float<T>(o0);
    orow[lane + 32] = from_float<T>(o1);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, int bh, int lq, int lk,
                   int heads, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(lq * kHeadDim + lk * kKeyPitch + lk * kHeadDim);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  attention_fwd_kernel<T><<<bh, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), lq, lk, heads,
      (float)(1.0 / sqrt((double)kHeadDim)));
  return cudaGetLastError();
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
  if (bh <= 0 || lq <= 0 || lk <= 0 || lk > kMaxKeys || lq > kMaxKeys ||
      heads <= 0 || bh % heads != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch<__nv_bfloat16>(q, k, v, bias, o, bh, lq, lk,
                                           heads, s)
                   : launch<float>(q, k, v, bias, o, bh, lq, lk, heads, s));
}

const char* xggm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
