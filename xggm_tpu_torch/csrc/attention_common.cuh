// Code shared by the port's attention kernels (attention_fwd.cu,
// attention_dropout.cu and attention_blhd.cu): fp32 <-> input-type
// conversions that round as the TPU kernels' astype does, 16-byte staging of
// [rows, 64] tiles into shared memory as fp32, warp reductions, the
// Philox4x32-10 generator of the dropout masks (the same generator as
// xggm_tpu_torch/ops/philox.py), the row softmax, the two layouts, and the
// bodies of the forward (kernels 1, 2, 4 and 5, which differ only in the
// dropout multiplier and the layout) and of the backward (kernels 3 and 6,
// which differ only in the layout).
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
// The backward kernels' __launch_bounds__ minimum of blocks per SM: 8 caps
// them at 64 registers, and ptxas then takes 64 without spills. Left to
// itself it took 32 to 48 and spilled in bf16: kernel 3 in bf16 took 0.195
// ms at B = 96, 36 x 36 (0.170 ms before it shared this body with kernel
// 6), and takes 0.151 ms with this bound (NVIDIA H100 80GB HBM3, 700 W).
constexpr int kBackwardBlocksPerSm = 8;

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

// Copy `rows` rows of 64 elements, `stride` elements apart in device memory,
// into shared memory as fp32, `pitch` floats apart, with one 16-byte load per
// thread and step. A row is 128 (bf16) or 256 (fp32) contiguous bytes, so
// the loads of one row coalesce whatever the stride.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      int rows, int pitch, int stride) {
  constexpr int kVec = Vec16<T>::kLen;
  const int n = rows * kHeadDim / kVec;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = (i * kVec) / kHeadDim;
    const int c = (i * kVec) % kHeadDim;
    float f[kVec];
    Vec16<T>::unpack(
        *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c), f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * pitch + c + j] = f[j];
  }
}

// Where the (batch * head) row `row` of a tensor of sequence length `len`
// lies, in a layout of `lh` heads between positions. BLHD [B, L, H, 64]
// (lh = H): position l of head h of batch b sits at ((b * L + l) * H + h) *
// 64, so the row starts at (b * L * H + h) * 64 and its positions lie
// H * 64 elements apart. Flattened [BH, L, 64] is the case lh = 1: the L
// positions of row r are contiguous from r * L * 64.
struct Layout {
  size_t q, kv;  // first element of this row in q/o and in k/v
  int stride;    // elements between its positions
  __device__ __forceinline__ Layout(size_t row, int lq, int lk, int lh)
      : q(((row / lh) * (size_t)lq * lh + row % lh) * kHeadDim),
        kv(((row / lh) * (size_t)lk * lh + row % lh) * kHeadDim),
        stride(lh * kHeadDim) {}
};

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

// Shared memory of the backward: q and g [lq][64], k and v [lk][65], p * m
// and ds [lq][lk], in fp32.
inline size_t backward_smem_bytes(int lq, int lk) {
  return sizeof(float) * (size_t)(2 * lq * kHeadDim + 2 * lk * kKeyPitch +
                                  2 * lq * lk);
}

// The forward of kernels 1, 2, 4 and 5 for the (batch * head) row
// blockIdx.x of this block of kWarps warps, in the layout of `lh` heads
// (1: flattened, heads: BLHD): o = round(p * m) v, with p the fp32 softmax of
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
    T* __restrict__ o, int lq, int lk, int heads, int lh, float scale,
    Dropout drop) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [lq][64]
  float* ks = qs + lq * kHeadDim;       // [lk][65]
  float* vs = ks + lk * kKeyPitch;      // [lk][64]

  const size_t row = blockIdx.x;
  const Layout at(row, lq, lk, lh);
  stage(q + at.q, qs, lq, kHeadDim, at.stride);
  stage(k + at.kv, ks, lk, kKeyPitch, at.stride);
  stage(v + at.kv, vs, lk, kHeadDim, at.stride);
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
    T* orow = o + at.q + (size_t)i * at.stride;
    orow[lane] = from_float<T>(o0);
    orow[lane + 32] = from_float<T>(o1);
  }
}

// The backward of kernels 3 and 6 for the (batch * head) row blockIdx.x of
// this block of kWarps warps, in the layout of `lh` heads: dq, dk and dv of
// round(p * m) v at output gradient g, all in fp32 from the same m, rounded
// once to the input type (attention_dropout.cu sets out the math). q, g, k
// and v are staged as fp32, k and v padded to 65 floats; p * m and ds are
// kept in shared memory ([lq][lk] fp32 each): a first pass over query rows
// computes them and dq, a second pass over key rows sums dv and dk.
template <typename T>
__device__ __forceinline__ void attention_backward_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ bias,
    const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, int lq, int lk, int heads, int lh, float scale,
    Dropout drop) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [lq][64]
  float* gs = qs + lq * kHeadDim;       // [lq][64]
  float* ks = gs + lq * kHeadDim;       // [lk][65]
  float* vs = ks + lk * kKeyPitch;      // [lk][65]
  float* pms = vs + lk * kKeyPitch;     // [lq][lk]  p * m
  float* dss = pms + lq * lk;           // [lq][lk]  ds

  const size_t row = blockIdx.x;
  const Layout at(row, lq, lk, lh);
  stage(q + at.q, qs, lq, kHeadDim, at.stride);
  stage(g + at.q, gs, lq, kHeadDim, at.stride);
  stage(k + at.kv, ks, lk, kKeyPitch, at.stride);
  stage(v + at.kv, vs, lk, kKeyPitch, at.stride);
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
    T* out = dq + at.q + (size_t)i * at.stride;
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
    T* dvrow = dv + at.kv + (size_t)j * at.stride;
    T* dkrow = dk + at.kv + (size_t)j * at.stride;
    dvrow[lane] = from_float<T>(v0acc);
    dvrow[lane + 32] = from_float<T>(v1acc);
    dkrow[lane] = from_float<T>(k0acc * scale);
    dkrow[lane + 32] = from_float<T>(k1acc * scale);
  }
}

}  // namespace
