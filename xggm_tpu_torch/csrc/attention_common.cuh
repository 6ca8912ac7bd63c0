// Code shared by the port's attention kernels (attention_fwd.cu,
// attention_dropout.cu and attention_blhd.cu): the two layouts, the
// Philox4x32-10 generator of the dropout masks (the same generator as
// xggm_tpu_torch/ops/philox.py), cp.async staging, the row softmax, and the
// bodies of the forward (kernels 1, 2, 4 and 5, which differ only in the
// dropout multiplier and the layout) and of the backward (kernels 3 and 6,
// which differ only in the layout), one of each per input type.
//
// Both types run one block per (batch * head) row and one warp per 16
// queries, the inputs copied once by cp.async into shared memory, the
// products on the tensor cores with mma.sync, the softmax in registers over
// the quad's shuffles (softmax_tiles) and the mask drawn one Philox call
// per four keys (dropout_quad):
// - bf16, the type of the training and serving paths: m16n8k16 with bf16
//   operands and fp32 accumulation, operands by ldmatrix; the forward
//   (attention_forward_block_bf16) and the backward
//   (attention_backward_block_bf16).
// - fp32 (--dtype float32 training and evaluation, the adjacency
//   precompute): the scores by fp32 FMAs in the plain version's order, the
//   other products m16n8k8 in TF32 with fp32 accumulation in three passes
//   (hi and lo TF32 parts, a b = a_hi b_hi + a_hi b_lo + a_lo b_hi), which
//   keeps fp32's accuracy; the forward (attention_forward_block_f32) and
//   the backward (attention_backward_block_f32).
// Their notes set out the designs.
#pragma once

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kMaxKeys = 64;  // Lq and Lk: at most four tiles of 16

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

// The softmax of every body over m16n8 accumulator tiles of scores, in
// place: tile n holds, for this thread's queries (row lane / 4 in e = 0, 1,
// that row + 8 in e = 2, 3), keys 8n + 2 (lane % 4) + {0, 1}. p =
// softmax(s * scale + bias) in fp32 over the quad's shuffles, the score
// -inf and so p = 0 past lk; brow is the row's fp32 bias [lk] or null.
template <int kN>
__device__ __forceinline__ void softmax_tiles(float (&s)[kN][4], int lk,
                                              const float* brow,
                                              float scale) {
  const int gc = 2 * (threadIdx.x & 3);
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

// The scores and the softmax of both bf16 bodies (forward and backward),
// for this warp's queries i0 + lane / 4 (e = 0, 1) and i0 + lane / 4 + 8
// (e = 2, 3) against every key: s = q k^T by mma.sync, the A fragments of
// the staged q at qa and the B fragments of the staged k at ka by ldmatrix
// (rows past lq or lk read the zeros at z), then p = softmax(s * scale +
// bias) by softmax_tiles. p is left in s: m16n8 tile n holds keys 8n + 2
// (lane % 4) + {0, 1}. brow is the row's fp32 bias [lk] or null.
template <int kKeyTiles>
__device__ __forceinline__ void softmax_bf16(float (&s)[2 * kKeyTiles][4],
                                             uint32_t qa, uint32_t ka,
                                             uint32_t z, int i0, int lq,
                                             int lk, const float* brow,
                                             float scale) {
  constexpr int kN = 2 * kKeyTiles;
  const int lane = threadIdx.x & 31;
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

  softmax_tiles<kN>(s, lk, brow, scale);
}

// The dropout multipliers of this thread's scores in the m16n8 tile n of
// the warp's queries i and i + 8 (i = first query + lane / 4): keys 8n +
// 2 (lane % 4) + {0, 1}, as m[0], m[1] (query i) and m[2], m[3] (i + 8).
// Philox word j % 4 at counter (row, query, j / 4, 0) decides key j, so
// lanes 2c and 2c + 1 of a quad need the same two counters (queries i and
// i + 8, block 2n + c): the even lane draws query i, the odd lane i + 8,
// and each hands its partner the two words it needs, with the bits of
// ops/philox.py. Called by the whole warp. The m16n8k8 accumulators of the
// fp32 bodies hold the same keys, so both bodies draw with it.
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

// Threads of a block of either type, forward or backward: one warp per 16
// queries.
inline int attention_threads(int lq) { return 32 * ((lq + 15) / 16); }

// Shared memory of a bf16 backward block: q and g [lq][kPitch], k and v
// [lk][kPitch], p * m and ds as hi and lo [lq][pad16(lk) + 8], and one
// 16-byte line of zeros.
inline size_t backward_bf16_smem_bytes(int lq, int lk) {
  const int pp = 16 * ((lk + 15) / 16) + 8;
  return sizeof(__nv_bfloat16) *
             ((size_t)(2 * lq + 2 * lk) * kPitch + (size_t)4 * lq * pp) +
         16;
}

// __launch_bounds__ of every attention kernel: at most 4 warps (Lq 64); of
// the bf16 backward, the blocks per SM that the shared memory allows by key
// tiles (Lk up to 16 * kKeyTiles). The backward at Lk 20 on the path: 12
// blocks of 2 warps at (20, 20), 8 of 3 at (36, 20); Lk 36: 6 of 3 warps
// at (36, 36), 8 of 2 at (20, 36); Lk 64: 3 of 4 warps at (64, 64). 6, 4
// and 3 blocks of 4 warps cap a thread at 80, 128 and 168 registers. At 5
// (96 registers) the Lk 36 body spilled 8 bytes; what it takes under 128
// allows 5 to 6 blocks of 3 warps.
constexpr int kMaxThreads = 32 * (kMaxKeys / 16);
template <int kKeyTiles>
constexpr int kBackwardBf16MinBlocks =
    kKeyTiles <= 2 ? 6 : kKeyTiles == 3 ? 4 : 3;

// The bf16 backward of kernels 3 and 6 for the (batch * head) row
// blockIdx.x, keys padded to 16 * kKeyTiles (the note above sets out the
// design; attention_dropout.cu the math). blockDim.x is
// attention_threads(lq), the dynamic shared memory
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
                          dim3(attention_threads(lq)), args, smem, stream);
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
// with it. blockDim.x is attention_threads(lq), the dynamic shared memory
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

// Ask each kernel of a forward (and of an fp32 backward) to prefer the most
// shared memory per SM (bf16: up to 16 blocks of 8.6 to 15.6 KB at the
// path's shapes). A host call: each source makes it once, before its first
// launch, and not on each of a forward's 34 launches.
template <typename Kernel>
inline cudaError_t prefer_shared_memory(const Kernel (&kernels)[4]) {
  for (const Kernel kernel : kernels) {
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
                          dim3(attention_threads(lq)), args,
                          forward_bf16_smem_bytes(lq, lk), stream);
}

// ---- the fp32 bodies of kernels 1 to 6: FMAs and TF32 tensor cores ------
//
// Replace, for fp32, the six TPU kernels of xggm_tpu/ops/pallas_attention.py
// that the bf16 bodies replace (kernels 1, 2, 4 and 5: the forward; 3 and
// 6: the backward), with the same math: the softmax, the mask and the
// backward's ds in fp32, p * m not rounded (round to fp32 is the identity),
// every product accumulated in fp32 and the outputs written once.
// Bound by bytes, as in bf16 but twice the bytes: at Lq = Lk = 36 a
// training backward row reads q, k, v, g and writes dq, dk, dv, 64.5 KB,
// for 10 Lq Lk 64 FLOPs; at the FFMA peak (67 TFLOP/s) those FLOPs take
// half of the byte bound (0.28 of 0.567 ms per training backward), so a
// body of FMAs alone has little room to reach the bound.
//
// The scores (q k^T, and the backward's g v^T) are fp32 FMAs, register
// tiled, each lane summing the 64 dims in order from 0 (scores_f32): the
// order of the plain version's product, so the scores are its scores bit
// for bit. A key mask adds -10000 to a masked score, where fp32's spacing
// is 2^-10; a score summed in another order rounds to a neighbour now and
// then, which moves that p by 1e-3 of itself: with every key of an element
// masked, tensor-core scores put o 3.2e-4 from the plain version's on an
// H100 (PERF.md), though no farther from float64.
//
// The other products (p v; ds k, (p * m)^T g, ds^T q) run on the tensor
// cores, mma.sync m16n8k8 with TF32 operands (wgmma takes tiles of 64
// rows; a row here has at most 36 queries on the path). A TF32 operand
// keeps 10 of fp32's 23 mantissa bits, so one pass leaves about 2^-11 of
// each product: outside the port's fp32 tolerance
// (tests/test_torch_attention_fp32_numerics.py). Each fp32 operand x is
// split into hi = tf32(x) and lo = x - hi, whose top 11 bits the tensor
// cores take (split_tf32), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi
// (three passes, mma_3xtf32; a_lo b_lo and lo's dropped bits, about 2^-21
// of the product, are lost).
//
// Tiling: the bf16 bodies', by tiles of 8 keys where bf16 has 16. One
// block per (batch * head) row, one warp per 16 queries; keys in m16n8
// tiles of 8 (Lk 36: 5 tiles; tiles past Lk are skipped, warp-uniformly),
// the body instantiated for 16 * kKeyTiles keys. q, k, v and g are copied
// once by cp.async into fp32 shared memory, rows 68 floats apart (a
// lane's rows r = lane / 4 or 2 (lane % 4) + {0, 1} start 4r words apart
// mod 32, so a warp's loads hit distinct banks), q and k in a first group
// so that the scores start while v and g are in flight; the rows past Lq
// (to 16 per warp) and Lk (to 8 per tile) are zeros, so that padded
// queries and keys add nothing. The m16n8 accumulator of a tile of 8 keys
// holds keys 2 (lane % 4) + {0, 1}; as the A fragment of the next
// product's k8 step it is read with k = lane % 4 standing for key
// 2 (lane % 4) and k = lane % 4 + 4 for key 2 (lane % 4) + 1, and the B
// fragment's rows are permuted alike, so p and ds enter p v and ds k from
// registers with no shuffle.
//   forward: s = q k^T; p = softmax_tiles (the bf16 bodies' code); with
//     kDropout, m from dropout_quad (the same bits) and p *= m; o = p v,
//     stored from the accumulators, 8 floats (32 bytes) a quad and row.
//   backward, phase 1, warp w on queries 16w..16w+15: s = q k^T, p, then
//     t = g v^T; m, dp = m t, ds = p (dp - rowsum(dp p)), the kept keys
//     as a bit mask; dq = ds k * scale. After a barrier, p * m and ds go to
//     shared memory over k and v (no longer read), zeros for rows past Lq.
//   backward, phase 2, after a barrier, work items (16 keys, dv or dk) in
//     turn: dv = (p * m)^T g, dk = ds^T q * scale, the transposes read as
//     A fragments from the [query][key] tiles (rows 16 kKeyTiles + 4 floats
//     apart: conflict-free).

constexpr int kF32Pitch = kHeadDim + 4;  // floats per staged row: 272 bytes

// Fragments of n fp32 values as TF32 hi and lo parts, x = hi + lo: hi
// rounded to TF32 (10 mantissa bits) to nearest, ties away from zero
// (cvt.rna), and lo = x - hi, exact in fp32, of which the tensor cores read
// the top 19 bits (they ignore an operand's low 13): a truncation of about
// 2^-21 of x.
template <int n>
__device__ __forceinline__ void split_tf32(const float (&x)[n],
                                           uint32_t (&hi)[n],
                                           uint32_t (&lo)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi[i]) : "f"(x[i]));
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
  }
}

// d += a b (m16n8k8, TF32 operands, fp32 accumulation): a the A fragment
// (a[0] at row lane / 4, column lane % 4; a[1] eight rows below; a[2],
// a[3] four columns right of a[0], a[1]), b the B fragment (b[0] at row
// lane % 4, column lane / 4; b[1] four rows below), d the accumulator (as
// in bf16's mma).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in three TF32 passes, the small terms first, a split into (ah,
// al) by the caller (an A fragment serves several B fragments), b here. The
// passes sum from 0 and the k8 step's sum is added to d in fp32: the
// tensor cores' accumulation truncates, and three passes a step into d
// itself put the gradients 4.4 times as far from float64 as the plain
// version's on an H100 (PERF.md).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float (&b)[2]) {
  uint32_t bh[2], bl[2];
  split_tf32(b, bh, bl);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh);
  mma_tf32(t, ah, bl);
  mma_tf32(t, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// Fragment loads from shared memory, `pitch` floats between rows, at this
// thread's gr = lane / 4, tc = lane % 4:
// the B fragment of t, row-major [k][n], its k rows permuted as the
// accumulators' keys: k = tc is row 2 tc, k = tc + 4 row 2 tc + 1;
__device__ __forceinline__ void frag_b_kn(float (&b)[2], const float* t,
                                          int pitch) {
  const int gr = (threadIdx.x & 31) >> 2, tc = threadIdx.x & 3;
  b[0] = t[2 * tc * pitch + gr];
  b[1] = t[(2 * tc + 1) * pitch + gr];
}

// the A fragment of t^T, t row-major [k][m], its k rows permuted alike.
__device__ __forceinline__ void frag_a_t(float (&a)[4], const float* t,
                                         int pitch) {
  const int gr = (threadIdx.x & 31) >> 2, tc = threadIdx.x & 3;
  a[0] = t[2 * tc * pitch + gr];
  a[1] = t[2 * tc * pitch + gr + 8];
  a[2] = t[(2 * tc + 1) * pitch + gr];
  a[3] = t[(2 * tc + 1) * pitch + gr + 8];
}

// An m16n8 accumulator tile of 8 keys as the A fragment of a k8 step over
// those keys (k = tc: key 2 tc; k = tc + 4: key 2 tc + 1).
__device__ __forceinline__ void acc_as_a(float (&a)[4], const float (&c)[4]) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}

// Copy `rows` rows of 64 fp32, `stride` elements apart in device memory,
// into shared memory kF32Pitch apart, 16 bytes a thread and copy, and zero
// the rows from `rows` to `padded`.
__device__ __forceinline__ void stage_async_f32(const float* src, float* dst,
                                                int rows, int padded,
                                                int stride) {
  for (int i = threadIdx.x; i < padded * 16; i += blockDim.x) {
    const int r = i >> 4;
    const int c = (i & 15) * 4;
    if (r < rows)
      cp_async16(smem_u32(dst + r * kF32Pitch + c),
                 src + (size_t)r * stride + c);
    else
      *reinterpret_cast<float4*>(dst + r * kF32Pitch + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// s[n] = x k^T for this warp's 16 rows of x (at xs) against the key tiles
// n < n8 of ks (tiles past n8 are left 0), in the m16n8 accumulator layout
// (tile n: rows lane / 4 and + 8, keys 8n + 2 (lane % 4) + {0, 1}), by fp32
// FMAs over the 64 dims in order from 0: the order in which the plain
// version's product (cuBLAS) sums them, so that the scores are its scores
// bit for bit (the note above says why). Each lane reads 16 bytes of its
// two rows and of its two keys per tile and step of 4 dims.
template <int kN>
__device__ __forceinline__ void scores_f32(float (&s)[kN][4], const float* xs,
                                           const float* ks, int n8) {
  const int gr = (threadIdx.x & 31) >> 2, tc = threadIdx.x & 3;
  const float* x0 = xs + gr * kF32Pitch;
  const float* x1 = x0 + 8 * kF32Pitch;
  const float* k0 = ks + 2 * tc * kF32Pitch;
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 1
  for (int d = 0; d < kHeadDim; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(x0 + d);
    const float4 a1 = *reinterpret_cast<const float4*>(x1 + d);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (n < n8) {
        const float* kn = k0 + 8 * n * kF32Pitch + d;
        const float4 b0 = *reinterpret_cast<const float4*>(kn);
        const float4 b1 = *reinterpret_cast<const float4*>(kn + kF32Pitch);
        const float4 a[2] = {a0, a1}, b[2] = {b0, b1};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 x = a[e >> 1], y = b[e & 1];
          float acc = s[n][e];
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
          acc = fmaf(x.z, y.z, acc);
          s[n][e] = fmaf(x.w, y.w, acc);
        }
      }
    }
  }
}

// acc[d] (64 output dims in 8 tiles) += the k8 steps n < n8 of a b, a from
// the accumulator tiles c (keys or queries), b the rows of ys (row-major
// [keys][64], rows permuted by frag_b_kn).
template <int kN>
__device__ __forceinline__ void product_f32(float (&acc)[8][4],
                                            const float (&c)[kN][4],
                                            const float* ys, int n8) {
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    if (n < n8) {
      float a[4];
      acc_as_a(a, c[n]);
      uint32_t ah[4], al[4];
      split_tf32(a, ah, al);
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        float b[2];
        frag_b_kn(b, ys + 8 * n * kF32Pitch + 8 * d, kF32Pitch);
        mma_3xtf32(acc[d], ah, al, b);
      }
    }
  }
}

// Store the accumulators of 16 rows (from r0, rows < rows only) and 64
// columns, times f, to row-major out `stride` floats apart, 8 bytes a
// thread: a quad writes 32 contiguous bytes of a row.
__device__ __forceinline__ void store_rows_f32(float* out,
                                               const float (&acc)[8][4],
                                               int r0, int rows, int stride,
                                               float f) {
  const int gr = (threadIdx.x & 31) >> 2, tc = threadIdx.x & 3;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    float* at = out + 8 * d + 2 * tc;
    if (r0 + gr < rows)
      *reinterpret_cast<float2*>(at + (size_t)(r0 + gr) * stride) =
          make_float2(acc[d][0] * f, acc[d][1] * f);
    if (r0 + gr + 8 < rows)
      *reinterpret_cast<float2*>(at + (size_t)(r0 + gr + 8) * stride) =
          make_float2(acc[d][2] * f, acc[d][3] * f);
  }
}

// Shared memory of an fp32 forward block: q [pad16(lq)][68], k and v
// [pad8(lk)][68] fp32. 34,816 bytes at Lq = Lk = 36.
inline size_t forward_f32_smem_bytes(int lq, int lk) {
  return sizeof(float) * kF32Pitch *
         (size_t)(16 * ((lq + 15) / 16) + 2 * 8 * ((lk + 7) / 8));
}

// The pitch of the backward's p * m and ds tiles: 16 kKeyTiles + 4 floats,
// which is 4 mod 16, so that frag_a_t's rows 2 tc hit banks 8 tc apart.
inline int f32_prob_pitch(int lk) { return 16 * ((lk + 15) / 16) + 4; }

// Shared memory of an fp32 backward block: q and g [pad16(lq)][68], then k
// and v [pad8(lk)][68], over which phase 2 lays p * m and ds
// [pad16(lq)][f32_prob_pitch(lk)]. 47,872 bytes at Lq = Lk = 36.
inline size_t backward_f32_smem_bytes(int lq, int lk) {
  const size_t qrows = 16 * ((lq + 15) / 16), krows = 8 * ((lk + 7) / 8);
  const size_t kv = 2 * krows * kF32Pitch;
  const size_t probs = 2 * qrows * f32_prob_pitch(lk);
  return sizeof(float) * (2 * qrows * kF32Pitch + (kv > probs ? kv : probs));
}

// __launch_bounds__ of the fp32 kernels: at most 4 warps (Lq 64), and the
// blocks of 4 warps per SM by key tiles of 16. The forward: 5 (at most 102
// registers; ptxas takes 90 to 95) up to 3 key tiles, where 128 let it
// take 112 to 115 and so 5 blocks of 3 warps per SM at (36, 36), not the 6
// that shared memory allows, and ran 5 to 6% slower on an H100
// (PERF.md); 4 at Lk 64 (128), which spilled under 102, as up to 2 key
// tiles spill under 85. The backward: 3 (168), whose phase 1 holds p, ds
// and dq's accumulators and which spilled under 128, and 2 at Lk 64 (255),
// which spilled under 168.
template <int kKeyTiles>
constexpr int kForwardF32MinBlocks = kKeyTiles == 4 ? 4 : 5;
template <int kKeyTiles>
constexpr int kBackwardF32MinBlocks = kKeyTiles == 4 ? 2 : 3;

// The fp32 forward for (batch * head) row blockIdx.x, in the layout of `lh`
// heads, keys up to 16 * kKeyTiles (the note above sets out the design):
// kernels 1 and 4 without kDropout (drop unread), kernels 2 and 5 with it.
// blockDim.x is attention_threads(lq), the dynamic shared memory
// forward_f32_smem_bytes(lq, lk).
template <int kKeyTiles, bool kDropout>
__device__ __forceinline__ void attention_forward_block_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ o, int lq, int lk, int heads, int lh, float scale,
    Dropout drop) {
  constexpr int kN = 2 * kKeyTiles;  // m16n8 tiles of 8 keys
  extern __shared__ float4 f32_fwd_smem[];
  const int n8 = (lk + 7) >> 3;  // tiles that hold keys
  float* qs = reinterpret_cast<float*>(f32_fwd_smem);
  float* ks = qs + 16 * (blockDim.x >> 5) * kF32Pitch;
  float* vs = ks + 8 * n8 * kF32Pitch;
  const size_t row = blockIdx.x;
  const Layout at(row, lq, lk, lh);
  stage_async_f32(q + at.q, qs, lq, 16 * (blockDim.x >> 5), at.stride);
  stage_async_f32(k + at.kv, ks, lk, 8 * n8, at.stride);
  cp_async_commit();
  stage_async_f32(v + at.kv, vs, lk, 8 * n8, at.stride);
  cp_async_commit();

  const int i0 = 16 * (threadIdx.x >> 5);  // this warp's first query

  // p from s = q k^T (q and k arrived)
  cp_async_wait<1>();
  __syncthreads();
  float s[kN][4];
  scores_f32<kN>(s, qs + i0 * kF32Pitch, ks, n8);
  softmax_tiles<kN>(s, lk, bias ? bias + (row / heads) * lk : nullptr,
                    scale);
  if constexpr (kDropout) {  // p *= m, while v is in flight
    const int i = i0 + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      float m[4];
      dropout_quad(drop, (uint32_t)row, i, n, lk, m);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= m[e];
    }
  }

  // o = (p * m) v (v arrived)
  cp_async_wait<0>();
  __syncthreads();
  float acc[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  product_f32<kN>(acc, s, vs, n8);
  store_rows_f32(o + at.q, acc, i0, lq, at.stride, 1.f);
}

// The fp32 backward of kernels 3 and 6 for the (batch * head) row
// blockIdx.x, keys up to 16 * kKeyTiles (the note above sets out the
// design; attention_dropout.cu the math). blockDim.x is
// attention_threads(lq), the dynamic shared memory
// backward_f32_smem_bytes(lq, lk).
template <int kKeyTiles>
__device__ __forceinline__ void attention_backward_block_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ g, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
    int heads, int lh, float scale, Dropout drop) {
  constexpr int kN = 2 * kKeyTiles;  // m16n8 tiles of 8 keys
  extern __shared__ float4 f32_bwd_smem[];
  const int warps = blockDim.x >> 5;
  const int qrows = 16 * warps;
  const int n8 = (lk + 7) >> 3;
  const int pp = 16 * kKeyTiles + 4;  // f32_prob_pitch(lk)
  float* qs = reinterpret_cast<float*>(f32_bwd_smem);
  float* gs = qs + qrows * kF32Pitch;
  float* ks = gs + qrows * kF32Pitch;
  float* vs = ks + 8 * n8 * kF32Pitch;
  float* pms = ks;               // phase 2: p * m [qrows][pp] over k, v
  float* dss = pms + qrows * pp;  // and ds
  const size_t row = blockIdx.x;
  const Layout at(row, lq, lk, lh);
  stage_async_f32(q + at.q, qs, lq, qrows, at.stride);
  stage_async_f32(k + at.kv, ks, lk, 8 * n8, at.stride);
  cp_async_commit();
  stage_async_f32(g + at.q, gs, lq, qrows, at.stride);
  stage_async_f32(v + at.kv, vs, lk, 8 * n8, at.stride);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int gr = (threadIdx.x & 31) >> 2, tc = threadIdx.x & 3;
  const int i0 = 16 * warp;  // this warp's first query

  // phase 1: p from s = q k^T (q, k arrived), then t = g v^T
  cp_async_wait<1>();
  __syncthreads();
  float s[kN][4];
  scores_f32<kN>(s, qs + i0 * kF32Pitch, ks, n8);
  softmax_tiles<kN>(s, lk, bias ? bias + (row / heads) * lk : nullptr,
                    scale);
  cp_async_wait<0>();
  __syncthreads();
  float t[kN][4];
  scores_f32<kN>(t, gs + i0 * kF32Pitch, vs, n8);

  // m (kept: bit 4n + e), dp = m t, rowsum(dp p), then ds = p (dp - rs)
  uint32_t kept = 0u;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    float m[4];
    dropout_quad(drop, (uint32_t)row, i0 + gr, n, lk, m);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t[n][e] *= m[e];
      rs[e >> 1] += t[n][e] * s[n][e];
      kept |= (m[e] != 0.f ? 1u : 0u) << (4 * n + e);
    }
  }
  rs[0] = quad_sum(rs[0]);
  rs[1] = quad_sum(rs[1]);
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[n][e] = s[n][e] * (t[n][e] - rs[e >> 1]);

  // dq = ds k * scale
  float acc[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  product_f32<kN>(acc, t, ks, n8);
  store_rows_f32(dq + at.q, acc, i0, lq, at.stride, scale);

  // p * m and ds over k and v, once every warp is done with them; rows
  // past lq are 0 (their p is not; their ds is)
  __syncthreads();
  const bool row0 = i0 + gr < lq, row1 = i0 + gr + 8 < lq;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    float pm[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pm[e] = (kept >> (4 * n + e)) & 1u ? s[n][e] * drop.keep_scale : 0.f;
    const int off = (i0 + gr) * pp + 8 * n + 2 * tc;
    *reinterpret_cast<float2*>(pms + off) =
        row0 ? make_float2(pm[0], pm[1]) : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(pms + off + 8 * pp) =
        row1 ? make_float2(pm[2], pm[3]) : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(dss + off) = make_float2(t[n][0], t[n][1]);
    *reinterpret_cast<float2*>(dss + off + 8 * pp) =
        make_float2(t[n][2], t[n][3]);
  }
  __syncthreads();

  // phase 2: items (keys 16 (it / 2) .., dv for even it, dk for odd)
  for (int it = warp; it < kN; it += warps) {
    const int j0 = 16 * (it >> 1);
    const bool is_dk = it & 1;
    const float* xs = (is_dk ? dss : pms) + j0;
    const float* ys = is_dk ? qs : gs;
#pragma unroll
    for (int d = 0; d < 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
#pragma unroll 1
    for (int iq = 0; iq < lq; iq += 8) {
      float a[4];
      frag_a_t(a, xs + iq * pp, pp);
      uint32_t ah[4], al[4];
      split_tf32(a, ah, al);
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        float b[2];
        frag_b_kn(b, ys + iq * kF32Pitch + 8 * d, kF32Pitch);
        mma_3xtf32(acc[d], ah, al, b);
      }
    }
    store_rows_f32((is_dk ? dk : dv) + at.kv, acc, j0, lk, at.stride,
                   is_dk ? scale : 1.f);
  }
}

// The kernels of one fp32 forward or backward, by key tiles of 16 (1 to
// 4), each with the C signature of its source's launch; launched with
// cudaLaunchKernel.
using F32ForwardKernel = void (*)(const float*, const float*, const float*,
                                  const float*, float*, int, int, int, float,
                                  Dropout);
using F32BackwardKernel = void (*)(const float*, const float*, const float*,
                                   const float*, const float*, float*,
                                   float*, float*, int, int, int, float,
                                   Dropout);

// Launch an fp32 forward over bh rows, one block per row.
inline cudaError_t launch_forward_f32(const F32ForwardKernel (&kernels)[4],
                                      const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* o, int bh, int lq, int lk,
                                      int heads, Dropout drop,
                                      cudaStream_t stream) {
  const F32ForwardKernel kernel = kernels[(lk + 15) / 16 - 1];
  const size_t smem = forward_f32_smem_bytes(lq, lk);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  float scale = head_scale();
  void* args[] = {&q, &k, &v, &bias, &o, &lq, &lk, &heads, &scale, &drop};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(bh),
                          dim3(attention_threads(lq)), args, smem, stream);
}

// Launch an fp32 backward over bh rows, one block per row.
inline cudaError_t launch_backward_f32(
    const F32BackwardKernel (&kernels)[4], const void* q, const void* k,
    const void* v, const void* bias, const void* g, void* dq, void* dk,
    void* dv, int bh, int lq, int lk, int heads, Dropout drop,
    cudaStream_t stream) {
  const F32BackwardKernel kernel = kernels[(lk + 15) / 16 - 1];
  const size_t smem = backward_f32_smem_bytes(lq, lk);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  float scale = head_scale();
  void* args[] = {&q,  &k,  &v,  &bias,  &g,     &dq,  &dk,
                  &dv, &lq, &lk, &heads, &scale, &drop};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(bh),
                          dim3(attention_threads(lq)), args, smem, stream);
}

}  // namespace
