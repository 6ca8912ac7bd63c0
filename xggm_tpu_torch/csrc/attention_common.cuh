// Code shared by the port's attention kernels (attention_fwd.cu,
// attention_dropout.cu and attention_blhd.cu): fp32 <-> input-type
// conversions that round as the TPU kernels' astype does, 16-byte staging of
// [rows, 64] tiles into shared memory as fp32, warp reductions, the
// Philox4x32-10 generator of the dropout masks (the same generator as
// xggm_tpu_torch/ops/philox.py), the row softmax, the two layouts, and the
// bodies of the forward (kernels 1, 2, 4 and 5, which differ only in the
// dropout multiplier and the layout) and of the backward (kernels 3 and 6,
// which differ only in the layout).
//
// bf16, the type of the training and serving paths, runs on the tensor
// cores (cp.async into bf16 shared memory, mma.sync m16n8k16 with fp32
// accumulation, ldmatrix; one warp per 16 queries) in two bodies that share
// the scores, the softmax (softmax_bf16) and the mask draw (dropout_quad,
// one Philox call per four keys): the forward, kernels 1 and 4 without
// dropout and kernels 2 and 5 with it (attention_forward_block_bf16), and
// the backward, kernels 3 and 6 (attention_backward_block_bf16). Their
// notes set out the designs. fp32 inputs cannot be bf16 tensor-core
// operands, and fp32 is on no path, so fp32 keeps the first port's scalar
// bodies (attention_forward_block, attention_backward_block), instantiated
// for float only.
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
// The fp32 backward kernels' __launch_bounds__ minimum of blocks per SM: 8
// caps them at 64 registers, and ptxas then takes 64 without spills; left
// to itself it took 32 to 48 and spilled.
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
// ops/philox.py. threshold 0 keeps everything without drawing. The draw of
// the scalar bodies (fp32); the bf16 bodies take the same bits four keys
// a call (dropout_quad).
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

// The scalar forward of kernels 1, 2, 4 and 5 in fp32 (bf16 runs
// attention_forward_block_bf16), for the (batch * head) row blockIdx.x of
// this block of kWarps warps, in the layout of `lh` heads (1: flattened,
// heads: BLHD): o = round(p * m) v, with p the fp32 softmax of q k^T *
// scale + bias, m the dropout multiplier (1 without kDropout), round = to
// the input type (the TPU kernels' astype before p @ v), the product
// accumulated in fp32 and written in the input type. q, k and v
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

// The fp32 backward of kernels 3 and 6 for the (batch * head) row
// blockIdx.x of this block of kWarps warps, in the layout of `lh` heads:
// dq, dk and dv of round(p * m) v at output gradient g, all in fp32 from the
// same m, rounded once to the input type (attention_dropout.cu sets out the
// math). q, g, k
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

// ---- the bf16 backward of kernels 3 and 6, on the tensor cores -----------
//
// Replaces, for bf16, _attention_dropout_bwd_kernel and
// _attention_dropout_blhd_bwd_kernel of xggm_tpu/ops/pallas_attention.py.
// Bound by bytes: 10 B H Lq Lk 64 FLOPs are about 1.5 us per training
// launch at mma.sync rates, the bytes 6 to 11 us. wgmma takes tiles of 64
// rows, and a row here has at most 36 queries on the path, so the products
// are mma.sync; what the body keeps small is the instructions around them.
//
// One block per (batch * head) row, one warp per tile of 16 queries (Lq 36:
// 3 warps). The five products are mma.sync m16n8k16 (bf16 operands, fp32
// accumulation), with Lq and Lk padded to multiples of 16 inside the tiles:
//   phase 1, warp w on queries 16w..16w+15, all keys:
//     s = q k^T and g v^T, exact bf16 operands (A and B by ldmatrix);
//     p = softmax(s * scale + bias) in fp32 over the quad's shuffles;
//     m by one Philox call per thread and 8 keys (dropout_quad);
//     dp = m * (g v^T), ds = p * (dp - rowsum(dp * p));
//     p * m and ds to shared memory as bf16 hi and lo (x = hi + lo);
//     dq = ds k * scale, ds from registers: the m16n8 accumulators of two
//     neighbouring key tiles are the A fragment of one k16 step.
//   phase 2, after one barrier, work items (16 keys, dv or dk) in turn:
//     dv = (p * m)^T g and dk = ds^T q * scale, the transposes read by
//     ldmatrix.trans from the hi and lo tiles.
// An fp32 operand (p * m, ds) is split into bf16 hi + lo and multiplied
// twice: rounding it once to bf16 puts the gradients more than one bf16 ulp
// from the fp32 math (tests/test_torch_attention_bwd_numerics.py).
// q, k, v and g arrive by cp.async, 16 bytes a thread, straight into bf16
// shared memory, rows 144 bytes apart (9 x 16: the 8 rows of an ldmatrix
// hit 8 different bank groups); q and k in a first group, so that s starts
// while g and v are in flight. Rows past Lq or Lk are not stored: ldmatrix
// reads them from one line of zeros, so a padded query has q = g = 0
// (p * m and ds of that row are never stored, and read as 0) and a padded
// key has k = v = 0 and the score -inf (p = 0, ds = 0).

constexpr int kPitch = kHeadDim + 8;  // bf16 per staged row: 144 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8. Plain: register i holds (row lane / 4, columns 2 (lane % 4)
// + {0, 1}) of matrix i; .trans: the same place of its transpose.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b: a the m16k16 A fragment, (b0, b1) the k16n8 B fragment, d the
// m16n8 accumulator (d[0], d[1] at row lane / 4, columns 2 (lane % 4) +
// {0, 1}; d[2], d[3] eight rows below).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) as bf16 pairs hi and lo with x = hi + lo to about 2^-16
// relative; x0 in the low half, as the fragments hold the lower column.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - f.x, x1 - f.y));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy `rows` rows of 64 bf16, `stride` elements apart in device memory,
// into shared memory kPitch apart, 16 bytes a thread and copy.
__device__ __forceinline__ void stage_async(const __nv_bfloat16* src,
                                            __nv_bfloat16* dst, int rows,
                                            int stride) {
  for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    cp_async16(smem_u32(dst + r * kPitch + c), src + (size_t)r * stride + c);
  }
}

// The shared address of the 16 bytes at column `col` of row `r` of a tile
// of `rows` rows `pitch` bf16 apart; a row past the tile reads the zeros.
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int r, int rows,
                                              int pitch, int col,
                                              uint32_t zeros) {
  return r < rows ? base + 2u * (uint32_t)(r * pitch + col) : zeros;
}

// The scores and the softmax of both bf16 bodies (forward and backward),
// for this warp's queries i0 + lane / 4 (e = 0, 1) and i0 + lane / 4 + 8
// (e = 2, 3) against every key: s = q k^T by mma.sync, the A fragments of
// the staged q at qa and the B fragments of the staged k at ka by ldmatrix
// (rows past lq or lk read the zeros at z), then p = softmax(s * scale +
// bias) in fp32 over the quad's shuffles, the score -inf and so p = 0 past
// lk. p is left in s: m16n8 tile n holds keys 8n + 2 (lane % 4) + {0, 1}.
// brow is the row's fp32 bias [lk] or null.
template <int kKeyTiles>
__device__ __forceinline__ void softmax_bf16(float (&s)[2 * kKeyTiles][4],
                                             uint32_t qa, uint32_t ka,
                                             uint32_t z, int i0, int lq,
                                             int lk, const float* brow,
                                             float scale) {
  constexpr int kN = 2 * kKeyTiles;
  const int lane = threadIdx.x & 31;
  const int gc = 2 * (lane & 3);
  const int mat = lane >> 3, mrow = lane & 7;
  // ldmatrix rows and columns of the A fragment (16 x 16: matrices
  // top-left, bottom-left, top-right, bottom-right) and of two B fragments
  // of K^T (key rows: top-left, top-right, bottom-left, bottom-right)
  const int a_row = mrow + 8 * (mat & 1), a_col = 8 * (mat >> 1);
  const int bt_row = mrow + 8 * (mat >> 1), bt_col = 8 * (mat & 1);
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < kHeadDim / 16; ++kd) {
    uint32_t a[4];
    ldsm_x4(a, tile_addr(qa, i0 + a_row, lq, kPitch, 16 * kd + a_col, z));
#pragma unroll
    for (int p = 0; p < kKeyTiles; ++p) {
      uint32_t b[4];
      ldsm_x4(b, tile_addr(ka, 16 * p + bt_row, lk, kPitch,
                           16 * kd + bt_col, z));
      mma_bf16(s[2 * p], a, b[0], b[1]);
      mma_bf16(s[2 * p + 1], a, b[2], b[3]);
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * n + gc + (e & 1);
      const float b = (brow && j < lk) ? brow[j] : 0.f;
      s[n][e] = j < lk ? s[n][e] * scale + b : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = expf(s[n][e] - mx[e >> 1]);  // 0 past lk
      sum[e >> 1] += s[n][e];
    }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] /= sum[e >> 1];  // p
}

// The dropout multipliers of this thread's scores in the m16n8 tile n of
// the warp's queries i and i + 8 (i = first query + lane / 4): keys 8n +
// 2 (lane % 4) + {0, 1}, as m[0], m[1] (query i) and m[2], m[3] (i + 8).
// Philox word j % 4 at counter (row, query, j / 4, 0) decides key j, so
// lanes 2c and 2c + 1 of a quad need the same two counters (queries i and
// i + 8, block 2n + c): the even lane draws query i, the odd lane i + 8,
// and each hands its partner the two words it needs, with the bits of
// dropout_multiplier and ops/philox.py. Called by the whole warp.
__device__ __forceinline__ void dropout_quad(const Dropout& drop,
                                             uint32_t row, int i, int n,
                                             int lk, float (&m)[4]) {
  if (drop.threshold == 0u || 8 * n >= lk) {  // uniform over the warp
    const float all = drop.threshold == 0u ? drop.keep_scale : 0.f;
    m[0] = m[1] = m[2] = m[3] = all;
    return;
  }
  const int lane = threadIdx.x & 31;
  const bool odd = lane & 1;
  const uint4 w = philox4x32_10(
      make_uint4(row, (uint32_t)(odd ? i + 8 : i),
                 (uint32_t)(2 * n + ((lane & 3) >> 1)), 0u),
      make_uint2(drop.seed + row, 0u));
  // even: keep words 0, 1 of query i, send 2, 3; odd: keep words 2, 3 of
  // query i + 8, send 0, 1
  const uint32_t in0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const uint32_t in1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  const uint32_t bits[4] = {odd ? in0 : w.x, odd ? in1 : w.y,
                            odd ? w.z : in0, odd ? w.w : in1};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    m[e] = bits[e] >= drop.threshold ? drop.keep_scale : 0.f;
}

// Threads of a bf16 block, forward or backward: one warp per 16 queries.
inline int bf16_threads(int lq) { return 32 * ((lq + 15) / 16); }

// Shared memory of a bf16 backward block: q and g [lq][kPitch], k and v
// [lk][kPitch], p * m and ds as hi and lo [lq][pad16(lk) + 8], and one
// 16-byte line of zeros.
inline size_t backward_bf16_smem_bytes(int lq, int lk) {
  const int pp = 16 * ((lk + 15) / 16) + 8;
  return sizeof(__nv_bfloat16) *
             ((size_t)(2 * lq + 2 * lk) * kPitch + (size_t)4 * lq * pp) +
         16;
}

// __launch_bounds__ of the bf16 kernels: at most 4 warps (Lq 64), and the
// blocks per SM that the shared memory allows by key tiles (Lk up to 16 *
// kKeyTiles). The backward at Lk 20 on the path: 12 blocks of 2 warps at
// (20, 20), 8 of 3 at (36, 20); Lk 36: 6 of 3 warps at (36, 36), 8 of 2 at
// (20, 36); Lk 64: 3 of 4 warps at (64, 64). 6, 4 and 3 blocks of 4 warps
// cap a thread at 80, 128 and 168 registers. At 5 (96 registers) the Lk 36
// body spilled 8 bytes; what it takes under 128 allows 5 to 6 blocks of 3
// warps.
constexpr int kBf16MaxThreads = 32 * (kMaxKeys / 16);
template <int kKeyTiles>
constexpr int kBackwardBf16MinBlocks =
    kKeyTiles <= 2 ? 6 : kKeyTiles == 3 ? 4 : 3;

// The bf16 backward of kernels 3 and 6 for the (batch * head) row
// blockIdx.x, keys padded to 16 * kKeyTiles (the note above sets out the
// design; attention_dropout.cu the math). blockDim.x is
// bf16_threads(lq), the dynamic shared memory
// backward_bf16_smem_bytes(lq, lk).
template <int kKeyTiles>
__device__ __forceinline__ void attention_backward_block_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int lq,
    int lk, int heads, int lh, float scale, Dropout drop) {
  constexpr int kN = 2 * kKeyTiles;  // m16n8 tiles across the keys
  const int pp = 16 * kKeyTiles + 8;  // pitch of the p * m and ds tiles
  extern __shared__ uint4 bwd_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* gs = qs + lq * kPitch;
  __nv_bfloat16* ks = gs + lq * kPitch;
  __nv_bfloat16* vs = ks + lk * kPitch;
  __nv_bfloat16* pm_hi = vs + lk * kPitch;
  __nv_bfloat16* pm_lo = pm_hi + lq * pp;
  __nv_bfloat16* ds_hi = pm_lo + lq * pp;
  __nv_bfloat16* ds_lo = ds_hi + lq * pp;
  uint4* zeros = reinterpret_cast<uint4*>(ds_lo + lq * pp);

  const size_t row = blockIdx.x;
  const Layout at(row, lq, lk, lh);
  stage_async(q + at.q, qs, lq, at.stride);
  stage_async(k + at.kv, ks, lk, at.stride);
  cp_async_commit();
  stage_async(g + at.q, gs, lq, at.stride);
  stage_async(v + at.kv, vs, lk, at.stride);
  cp_async_commit();
  if (threadIdx.x == 0) *zeros = make_uint4(0u, 0u, 0u, 0u);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int gr = lane >> 2;       // accumulator row (and row + 8)
  const int gc = 2 * (lane & 3);  // accumulator column pair
  const int mat = lane >> 3;      // ldmatrix: this lane's matrix ...
  const int mrow = lane & 7;      // ... and row in it
  const uint32_t z = smem_u32(zeros);
  const uint32_t qa = smem_u32(qs), ga = smem_u32(gs), ka = smem_u32(ks),
                 va = smem_u32(vs);
  const int i0 = 16 * warp;  // this warp's first query
  // ldmatrix rows and columns of an A fragment (16 x 16 at row r0, column
  // c0: matrices top-left, bottom-left, top-right, bottom-right) and of two
  // B fragments of K^T (key rows: top-left, top-right, bottom-left,
  // bottom-right), and of the .trans B fragments of a [k][n] row-major tile
  const int a_row = mrow + 8 * (mat & 1), a_col = 8 * (mat >> 1);
  const int bt_row = mrow + 8 * (mat >> 1), bt_col = 8 * (mat & 1);

  // phase 1: p from s = q k^T (q, k arrived), then g v^T
  cp_async_wait<1>();
  __syncthreads();
  float s[kN][4];
  softmax_bf16<kKeyTiles>(s, qa, ka, z, i0, lq, lk,
                          bias ? bias + (row / heads) * lk : nullptr, scale);
  float t[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[n][e] = 0.f;

  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int kd = 0; kd < kHeadDim / 16; ++kd) {
    uint32_t a[4];
    ldsm_x4(a, tile_addr(ga, i0 + a_row, lq, kPitch, 16 * kd + a_col, z));
#pragma unroll
    for (int p = 0; p < kKeyTiles; ++p) {
      uint32_t b[4];
      ldsm_x4(b, tile_addr(va, 16 * p + bt_row, lk, kPitch,
                           16 * kd + bt_col, z));
      mma_bf16(t[2 * p], a, b[0], b[1]);
      mma_bf16(t[2 * p + 1], a, b[2], b[3]);
    }
  }

  // m, dp = m * (g v^T) into t, p * m to shared memory, rowsum(dp * p)
  const bool row0 = i0 + gr < lq, row1 = i0 + gr + 8 < lq;
  const int off0 = (i0 + gr) * pp + gc, off1 = off0 + 8 * pp;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    float m[4];
    dropout_quad(drop, (uint32_t)row, i0 + gr, n, lk, m);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t[n][e] *= m[e];
      rs[e >> 1] += t[n][e] * s[n][e];
    }
    uint32_t hi, lo;
    if (row0) {
      split_bf16(s[n][0] * m[0], s[n][1] * m[1], hi, lo);
      *reinterpret_cast<uint32_t*>(pm_hi + off0 + 8 * n) = hi;
      *reinterpret_cast<uint32_t*>(pm_lo + off0 + 8 * n) = lo;
    }
    if (row1) {
      split_bf16(s[n][2] * m[2], s[n][3] * m[3], hi, lo);
      *reinterpret_cast<uint32_t*>(pm_hi + off1 + 8 * n) = hi;
      *reinterpret_cast<uint32_t*>(pm_lo + off1 + 8 * n) = lo;
    }
  }
  rs[0] = quad_sum(rs[0]);
  rs[1] = quad_sum(rs[1]);

  // ds = p * (dp - rowsum): to shared memory, and as the hi and lo A
  // fragments of dq's k16 steps (m16n8 tiles 2 kk and 2 kk + 1)
  uint32_t dsa[kKeyTiles][2][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    uint32_t h0, l0, h1, l1;
    split_bf16(s[n][0] * (t[n][0] - rs[0]), s[n][1] * (t[n][1] - rs[0]), h0,
               l0);
    split_bf16(s[n][2] * (t[n][2] - rs[1]), s[n][3] * (t[n][3] - rs[1]), h1,
               l1);
    if (row0) {
      *reinterpret_cast<uint32_t*>(ds_hi + off0 + 8 * n) = h0;
      *reinterpret_cast<uint32_t*>(ds_lo + off0 + 8 * n) = l0;
    }
    if (row1) {
      *reinterpret_cast<uint32_t*>(ds_hi + off1 + 8 * n) = h1;
      *reinterpret_cast<uint32_t*>(ds_lo + off1 + 8 * n) = l1;
    }
    const int half = 2 * (n & 1);
    dsa[n >> 1][0][half] = h0;
    dsa[n >> 1][0][half + 1] = h1;
    dsa[n >> 1][1][half] = l0;
    dsa[n >> 1][1][half + 1] = l1;
  }

  // dq = ds k * scale
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKeyTiles; ++kk)
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      uint32_t b[4];
      ldsm_x4_trans(b, tile_addr(ka, 16 * kk + a_row, lk, kPitch,
                                 16 * d + a_col, z));
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        mma_bf16(acc[2 * d], dsa[kk][part], b[0], b[1]);
        mma_bf16(acc[2 * d + 1], dsa[kk][part], b[2], b[3]);
      }
    }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    __nv_bfloat16* out = dq + at.q + 8 * n + gc;
    if (row0)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(i0 + gr) * at.stride) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (row1)
      *reinterpret_cast<__nv_bfloat162*>(
          out + (size_t)(i0 + gr + 8) * at.stride) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
  __syncthreads();  // the p * m and ds tiles are complete

  // phase 2: items (keys 16 it / 2 .., dv for even it, dk for odd)
  for (int it = warp; it < kN; it += warps) {
    const int j0 = 16 * (it >> 1);
    const bool is_dk = it & 1;
    const uint32_t ah = smem_u32(is_dk ? ds_hi : pm_hi);
    const uint32_t al = smem_u32(is_dk ? ds_lo : pm_lo);
    const uint32_t ba = is_dk ? qa : ga;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 1
    for (int ic = 0; ic < lq; ic += 16) {
      // A = (p * m)^T or ds^T [16 keys][16 queries]: the transposes of
      // the stored [query][key] tile's 8 x 8 blocks
      uint32_t a_hi[4], a_lo[4];
      ldsm_x4_trans(a_hi, tile_addr(ah, ic + bt_row, lq, pp, j0 + bt_col, z));
      ldsm_x4_trans(a_lo, tile_addr(al, ic + bt_row, lq, pp, j0 + bt_col, z));
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        uint32_t b[4];
        ldsm_x4_trans(b, tile_addr(ba, ic + a_row, lq, kPitch, 16 * d + a_col,
                                   z));
        mma_bf16(acc[2 * d], a_hi, b[0], b[1]);
        mma_bf16(acc[2 * d], a_lo, b[0], b[1]);
        mma_bf16(acc[2 * d + 1], a_hi, b[2], b[3]);
        mma_bf16(acc[2 * d + 1], a_lo, b[2], b[3]);
      }
    }
    const float f = is_dk ? scale : 1.f;
    __nv_bfloat16* out = (is_dk ? dk : dv) + at.kv + gc;
    const int j = j0 + gr;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (j < lk)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)j * at.stride +
                                           8 * n) =
            __floats2bfloat162_rn(acc[n][0] * f, acc[n][1] * f);
      if (j + 8 < lk)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(j + 8) * at.stride +
                                           8 * n) =
            __floats2bfloat162_rn(acc[n][2] * f, acc[n][3] * f);
    }
  }
}

// The kernels of one bf16 backward, by key tiles (1 to 4), each with the C
// signature of its source's launch; launched with cudaLaunchKernel.
using Bf16BackwardKernel = void (*)(
    const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
    const float*, const __nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16*,
    __nv_bfloat16*, int, int, int, float, Dropout);

inline cudaError_t launch_backward_bf16(
    const Bf16BackwardKernel (&kernels)[4], const void* q, const void* k,
    const void* v, const void* bias, const void* g, void* dq, void* dk,
    void* dv, int bh, int lq, int lk, int heads, Dropout drop,
    cudaStream_t stream) {
  const Bf16BackwardKernel kernel = kernels[(lk + 15) / 16 - 1];
  const size_t smem = backward_bf16_smem_bytes(lq, lk);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  float scale = head_scale();
  void* args[] = {&q,  &k,  &v,  &bias,  &g,     &dq,  &dk,
                  &dv, &lq, &lk, &heads, &scale, &drop};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(bh),
                          dim3(bf16_threads(lq)), args, smem, stream);
}

// ---- the bf16 forward of kernels 1, 2, 4 and 5, on the tensor cores ------
//
// Replaces, for bf16, _attention_kernel, _attention_dropout_fwd_kernel,
// _attention_blhd_kernel and _attention_dropout_blhd_fwd_kernel of
// xggm_tpu/ops/pallas_attention.py: o = round(p * m) v with p = softmax(q
// k^T * scale + bias) in fp32, m the dropout multiplier (kDropout; 1
// without), p * m in fp32 and round = to bf16 (the TPU kernels'
// (p * m).astype), the product accumulated in fp32 and o rounded to bf16.
// Bound by bytes: 4 B H Lq Lk 64 FLOPs take about 0.1 us a launch on the
// tensor cores, the bytes 2 to 6 us. wgmma takes tiles of 64 rows and a
// row here has at most 36 queries on the path, so the products are
// mma.sync m16n8k16.
//
// One warp per tile of 16 queries (Lq 36: 3 warps). Per (batch * head) row:
//   q and k by cp.async into bf16 shared memory (first group), v (second);
//   s = q k^T and p = softmax(s * scale + bias), the code the backward runs
//   (softmax_bf16), so the forward's p is the p that the backward
//   recomputes;
//   with kDropout, m by one Philox call per thread and m16n8 tile
//   (dropout_quad, the backward's draw of the same bits) and p *= m in
//   fp32, while v is still in flight; then, once v has arrived,
//   o = p v: p rounded to bf16 (round to nearest even) from the m16n8
//   accumulators of two neighbouring key tiles is the A fragment of one k16
//   step, v [keys][64] the B fragments by ldmatrix.trans; o in eight m16n8
//   fp32 accumulators, rounded to bf16 into the warp's own q rows (q is
//   spent by then) and stored from there 16 bytes a lane, rows < lq only.
// Padded rows are not stored: ldmatrix reads them from one line of zeros,
// so a padded key has k = v = 0 and the score -inf (p = 0).
// One block per row: each block's copies overlap other blocks' compute
// through the block scheduler. Persistent blocks that walk several rows
// with a two-stage cp.async ring were measured against it on an H100 and
// were slower at every path shape (PERF.md): their blocks are twice
// the size, so fewer are resident.

// Shared memory of a bf16 forward block: q [lq][kPitch], k and v
// [lk][kPitch], and one 16-byte line of zeros. At most 27,664 bytes (Lq =
// Lk = 64), under the 48 KB above which a launch must opt in.
inline size_t forward_bf16_smem_bytes(int lq, int lk) {
  return sizeof(__nv_bfloat16) * (size_t)(lq + 2 * lk) * kPitch + 16;
}

// The forward kernels' __launch_bounds__ minimum of blocks of 4 warps per
// SM by key tiles, with and without dropout: 8, 7 and 5 cap a thread at 64,
// 72 and 96 registers. A block takes 8,656 to 15,568 bytes at the path's
// shapes, so registers, not shared memory, bound the blocks per SM. Left at
// 6, 5 and 4, ptxas took 78 and 96 registers for 2 and 3 key tiles without
// dropout (64 and 88 with it), 12 and 7 blocks per SM at (20, 20) and (36,
// 36) where these caps give 16 and 9, and trial builds on an H100 ran
// slower: without dropout at every path shape, with it by 5% per training
// forward and 15% at (36, 36). Tighter caps spill: at 10 and 8 the Lk 48
// body without dropout, at 10, 8 and 6 the dropout body of 2 and 4 key
// tiles. The dropout body fits these caps without a spill: its Philox state
// is live between the softmax and p v, before the accumulators of o are.
template <int kKeyTiles>
constexpr int kForwardBf16MinBlocks =
    kKeyTiles <= 2 ? 8 : kKeyTiles == 3 ? 7 : 5;

// The bf16 forward for (batch * head) row blockIdx.x, in the layout of `lh`
// heads, keys padded to 16 * kKeyTiles (the note above sets out the
// design): kernels 1 and 4 without kDropout (drop unread), kernels 2 and 5
// with it. blockDim.x is bf16_threads(lq), the dynamic shared memory
// forward_bf16_smem_bytes(lq, lk).
template <int kKeyTiles, bool kDropout>
__device__ __forceinline__ void attention_forward_block_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ o, int lq, int lk, int heads, int lh,
    float scale, Dropout drop) {
  extern __shared__ uint4 fwd_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fwd_smem);
  __nv_bfloat16* ks = qs + lq * kPitch;
  __nv_bfloat16* vs = ks + lk * kPitch;
  uint4* zeros = reinterpret_cast<uint4*>(vs + lk * kPitch);
  const size_t row = blockIdx.x;
  const Layout at(row, lq, lk, lh);
  if (threadIdx.x == 0) *zeros = make_uint4(0u, 0u, 0u, 0u);
  stage_async(q + at.q, qs, lq, at.stride);
  stage_async(k + at.kv, ks, lk, at.stride);
  cp_async_commit();
  stage_async(v + at.kv, vs, lk, at.stride);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int i0 = 16 * (threadIdx.x >> 5);  // this warp's first query
  const int gr = lane >> 2;                // accumulator row (and row + 8)
  const int gc = 2 * (lane & 3);           // accumulator column pair
  const int mat = lane >> 3, mrow = lane & 7;
  // ldmatrix.trans rows and columns of the B fragments of v [keys][64]
  const int v_row = mrow + 8 * (mat & 1), v_col = 8 * (mat >> 1);
  const uint32_t z = smem_u32(zeros);
  const uint32_t va = smem_u32(vs);

  // p from s = q k^T (q and k arrived)
  cp_async_wait<1>();
  __syncthreads();
  float s[2 * kKeyTiles][4];
  softmax_bf16<kKeyTiles>(s, smem_u32(qs), smem_u32(ks), z, i0, lq, lk,
                          bias ? bias + (row / heads) * lk : nullptr, scale);
  if constexpr (kDropout) {  // p *= m in fp32, while v is in flight
#pragma unroll
    for (int n = 0; n < 2 * kKeyTiles; ++n) {
      float m[4];
      dropout_quad(drop, (uint32_t)row, i0 + gr, n, lk, m);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= m[e];
    }
  }

  // o = round(p * m) v (v arrived)
  cp_async_wait<0>();
  __syncthreads();
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKeyTiles; ++kk) {
    // keys 16 kk .. 16 kk + 15: tiles 2 kk (A registers 0, 1) and
    // 2 kk + 1 (2, 3), rows gr and gr + 8
    const uint32_t a[4] = {
        bf16x2_bits(__floats2bfloat162_rn(s[2 * kk][0], s[2 * kk][1])),
        bf16x2_bits(__floats2bfloat162_rn(s[2 * kk][2], s[2 * kk][3])),
        bf16x2_bits(
            __floats2bfloat162_rn(s[2 * kk + 1][0], s[2 * kk + 1][1])),
        bf16x2_bits(
            __floats2bfloat162_rn(s[2 * kk + 1][2], s[2 * kk + 1][3]))};
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      uint32_t b[4];
      ldsm_x4_trans(b, tile_addr(va, 16 * kk + v_row, lk, kPitch,
                                 16 * d + v_col, z));
      mma_bf16(acc[2 * d], a, b[0], b[1]);
      mma_bf16(acc[2 * d + 1], a, b[2], b[3]);
    }
  }

  // o to bf16 in the warp's own q rows, then 16 bytes a lane to memory
  const bool row0 = i0 + gr < lq, row1 = i0 + gr + 8 < lq;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    __nv_bfloat16* out = qs + (i0 + gr) * kPitch + 8 * n + gc;
    if (row0)
      *reinterpret_cast<__nv_bfloat162*>(out) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (row1)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * kPitch) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * 8; c += 32) {
    const int r = i0 + (c >> 3), col = 8 * (c & 7);
    if (r < lq)
      *reinterpret_cast<uint4*>(o + at.q + (size_t)r * at.stride + col) =
          *reinterpret_cast<const uint4*>(qs + r * kPitch + col);
  }
}

// The kernels of one bf16 forward, by key tiles (1 to 4), each with the C
// signature of its source's launch; launched with cudaLaunchKernel.
using Bf16ForwardKernel = void (*)(const __nv_bfloat16*,
                                   const __nv_bfloat16*,
                                   const __nv_bfloat16*, const float*,
                                   __nv_bfloat16*, int, int, int, float,
                                   Dropout);

// Ask each kernel of a bf16 forward to prefer the most shared memory per SM
// (up to 16 blocks of 8.6 to 15.6 KB at the path's shapes). A host call:
// each source makes it once, before its first launch, and not on each of a
// forward's 34 launches.
inline cudaError_t prefer_shared_memory(
    const Bf16ForwardKernel (&kernels)[4]) {
  for (const Bf16ForwardKernel kernel : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Launch a bf16 forward over bh rows, one block per row.
inline cudaError_t launch_forward_bf16(const Bf16ForwardKernel (&kernels)[4],
                                       const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, int bh, int lq, int lk,
                                       int heads, Dropout drop,
                                       cudaStream_t stream) {
  const Bf16ForwardKernel kernel = kernels[(lk + 15) / 16 - 1];
  float scale = head_scale();
  void* args[] = {&q, &k, &v, &bias, &o, &lq, &lk, &heads, &scale, &drop};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(bh),
                          dim3(bf16_threads(lq)), args,
                          forward_bf16_smem_bytes(lq, lk), stream);
}

}  // namespace
