// Code shared by the port's attention kernels (attention_fwd.cu and
// attention_dropout.cu): fp32 <-> input-type conversions that round as the
// TPU kernels' astype does, 16-byte staging of [rows, 64] tiles into shared
// memory as fp32, warp reductions, the Philox4x32-10 generator of the
// dropout masks (the same generator as xggm_tpu_torch/ops/philox.py), the
// row softmax, and the forward of kernels 1 and 2, which differ only in the
// dropout multiplier.
#pragma once

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Philox4x32-10 (Salmon et al., SC 2011; the Random123 round and
// constants): counter c under key k -> four uint32 words.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// Dropout multiplier of score (row, i, j): keep_scale where the draw is at
// or above `threshold`, else 0. The draw is word j % 4 of Philox at counter
// (row, i, j / 4, 0) under key (seed + row, 0), the layout of
// ops/philox.py. threshold 0 keeps everything without drawing.
__device__ __forceinline__ float dropout_multiplier(uint32_t seed,
                                                    uint32_t row, int i,
                                                    int j, uint32_t threshold,
                                                    float keep_scale) {
  if (threshold == 0u) return keep_scale;
  const uint4 w = philox4x32_10(
      make_uint4(row, (uint32_t)i, (uint32_t)(j >> 2), 0u),
      make_uint2(seed + row, 0u));
  const int lane4 = j & 3;
  const uint32_t bits =
      lane4 == 0 ? w.x : lane4 == 1 ? w.y : lane4 == 2 ? w.z : w.w;
  return bits >= threshold ? keep_scale : 0.f;
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline float head_scale() { return (float)(1.0 / sqrt((double)kHeadDim)); }

inline bool bad_shape(int bh, int lq, int lk, int heads) {
  return bh <= 0 || lq <= 0 || lk <= 0 || lk > kMaxKeys || lq > kMaxKeys ||
         heads <= 0 || bh % heads != 0;
}

// Dropout of one call: keep score (r, i, j) when Philox draws at least
// `threshold` and scale it by keep_scale. threshold 0 and keep_scale 1:
// no dropout.
struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float keep_scale;
};

// Scores of query row qi against keys lane and lane + 32, softmaxed across
// the warp: (p0, p1), 0 for lanes past lk.
__device__ __forceinline__ float2 softmax_row(const float* qi,
                                              const float* k0,
                                              const float* k1, bool has0,
                                              bool has1, float b0, float b1,
                                              float scale) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
  for (int d = 0; d < kHeadDim; ++d) {
    const float qd = qi[d];
    s0 = fmaf(qd, k0[d], s0);
    s1 = fmaf(qd, k1[d], s1);
  }
  s0 = has0 ? s0 * scale + b0 : -INFINITY;
  s1 = has1 ? s1 * scale + b1 : -INFINITY;
  const float m = warp_max(fmaxf(s0, s1));
  const float e0 = has0 ? expf(s0 - m) : 0.f;
  const float e1 = has1 ? expf(s1 - m) : 0.f;
  const float sum = warp_sum(e0 + e1);
  return make_float2(e0 / sum, e1 / sum);
}

// Shared memory of the forward: q [lq][64], k [lk][65], v [lk][64] in fp32.
inline size_t forward_smem_bytes(int lq, int lk) {
  return sizeof(float) *
         (size_t)(lq * kHeadDim + lk * kKeyPitch + lk * kHeadDim);
}

// The forward of kernels 1 and 2 for the (batch * head) row of this block
// of kWarps warps: o = round(p * m) v, with p the fp32 softmax of
// q k^T * scale + bias, m the dropout multiplier (1 without kDropout),
// round = to the input type (the TPU kernels' astype before p @ v), the
// product accumulated in fp32 and written in the input type. q, k and v
// are staged in shared memory as fp32, k's rows padded to 65 floats so that
// the 32 lanes, one key each, read 32 different banks. Each warp takes query
// rows in turn: lane j holds keys j and j + 32, and the p @ v product
// broadcasts p_j by shuffle while lane d accumulates output dims d, d + 32.
template <typename T, bool kDropout>
__device__ __forceinline__ void attention_forward_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ bias,
    T* __restrict__ o, int lq, int lk, int heads, float scale,
    Dropout drop) {
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
    float2 p = softmax_row(qs + i * kHeadDim, k0, k1, has0, has1, b0, b1,
                           scale);
    if (kDropout) {
      p.x *= has0 ? dropout_multiplier(drop.seed, (uint32_t)row, i, lane,
                                       drop.threshold, drop.keep_scale)
                  : 0.f;
      p.y *= has1 ? dropout_multiplier(drop.seed, (uint32_t)row, i,
                                       lane + 32, drop.threshold,
                                       drop.keep_scale)
                  : 0.f;
    }
    const float pm0 = to_float(from_float<T>(p.x));
    const float pm1 = to_float(from_float<T>(p.y));

    float o0 = 0.f, o1 = 0.f;  // output dims lane and lane + 32
    for (int j = 0; j < lk; ++j) {
      const float pj = __shfl_sync(0xffffffffu, j < 32 ? pm0 : pm1, j & 31);
      o0 = fmaf(pj, vs[j * kHeadDim + lane], o0);
      o1 = fmaf(pj, vs[j * kHeadDim + lane + 32], o1);
    }
    T* orow = o + (row * lq + i) * kHeadDim;
    orow[lane] = from_float<T>(o0);
    orow[lane + 32] = from_float<T>(o1);
  }
}

}  // namespace
