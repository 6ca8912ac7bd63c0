// Fused BertAdam update (clip scale, moments, update, apply) over every
// parameter of one optimizer update, in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel xggm_tpu/ops/pallas_optim.py::_adam_kernel
// (launched by fused_adam_leaf, once per parameter leaf, from
// training/bert_adam.py::make_fused_bert_adam_step). Per fp32 element of a
// parameter with gradient g, moments m and v and value p:
//
//   g' = g * c                               c = min(1, clip / (|g| + 1e-6))
//   m' = b1 * m + (1 - b1) * g'
//   v' = b2 * v + (1 - b2) * g' * g'
//   p' = p - lr_eff * (m' / (sqrt(v') + eps) + wd * p)     (wd * p if wd > 0)
//
// written to m, v and p in place (the TPU kernel's input_output_aliases).
// c is one fp32 on the device for the whole update; lr_eff is entry `index`
// of a device vector of per-parameter rates, lr(count) * lr_scale where the
// parameter is active and 0 where it is not. A null g is a zero gradient:
// m and v decay, and weight decay applies while the parameter is active.
// Every operation is rounded on its own (__fmul_rn and friends, no FMA
// contraction), in the order of the TPU kernel and of the plain version
// (ops/fused_adam.py::fused_adam_reference).
//
// What bounds it: memory bandwidth. An element reads g, m, v, p and writes
// m, v, p: 28 bytes for some 12 FLOPs, far below the ~20 FLOP/byte at which
// fp32 arithmetic would be the limit. 220,128,936 parameters move 6.16 GB,
// 1.84 ms at 3.35 TB/s.
//
// Design: the TPU launches one pallas_call per leaf (395 per update at full
// width). Here one launch covers every parameter: the caller passes a table
// of rows (g, m, v, p, numel, index, first_chunk, unused), 8 x 64 bits
// each, and the grid has one block per chunk of kChunk elements of every
// row in turn; row t owns blocks first_chunk[t] .. first_chunk[t + 1] - 1,
// and a block finds its row by binary search. The table lives on the
// device (the caller copies it without a synchronisation, since the
// gradient pointers change every update). Loads and stores are float4
// where all four pointers are 16-byte aligned, with a scalar tail for a
// length that is not a multiple of 4 (sizes 1 and 7 exist); otherwise the
// block goes element by element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 32768;  // elements per block; a multiple of 4

struct AdamRow {  // one row of the table: 8 x 64 bits
  const float* g;  // null: a zero gradient
  float* m;
  float* v;
  float* p;
  long long numel;
  long long index;        // entry of lr_eff
  long long first_chunk;  // first block of this row
  long long unused;
};
static_assert(sizeof(AdamRow) == 64, "the table's rows are 8 x 64 bits");

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

__device__ __forceinline__ void adam(float g, float& m, float& v, float& p,
                                     float c, float lr, const Hyper& h) {
  const float gs = __fmul_rn(g, c);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, gs));
  v = __fadd_rn(__fmul_rn(h.b2, v),
                __fmul_rn(__fmul_rn(h.one_minus_b2, gs), gs));
  float u = __fdiv_rn(m, __fadd_rn(__fsqrt_rn(v), h.eps));
  if (h.wd > 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, u));
}

__global__ void __launch_bounds__(kThreads)
bert_adam_kernel(const AdamRow* __restrict__ table, int rows,
                 const float* __restrict__ clip_scale,
                 const float* __restrict__ lr_eff, Hyper h) {
  // the last row whose first chunk is at or before this block
  const long long block = blockIdx.x;
  int lo = 0, hi = rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].first_chunk <= block) lo = mid;
    else hi = mid - 1;
  }
  const AdamRow t = table[lo];
  const float c = *clip_scale;
  const float lr = lr_eff[t.index];
  const long long begin = (block - t.first_chunk) * kChunk;
  const long long end = min(begin + kChunk, t.numel);

  long long tail = begin;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(t.g) |
                         reinterpret_cast<uintptr_t>(t.m) |
                         reinterpret_cast<uintptr_t>(t.v) |
                         reinterpret_cast<uintptr_t>(t.p);
  if ((addr & 15) == 0) {
    const long long nvec = (end - begin) >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(t.g + begin);
    float4* m4 = reinterpret_cast<float4*>(t.m + begin);
    float4* v4 = reinterpret_cast<float4*>(t.v + begin);
    float4* p4 = reinterpret_cast<float4*>(t.p + begin);
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      const float4 g = t.g ? g4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 m = m4[i], v = v4[i], p = p4[i];
      adam(g.x, m.x, v.x, p.x, c, lr, h);
      adam(g.y, m.y, v.y, p.y, c, lr, h);
      adam(g.z, m.z, v.z, p.z, c, lr, h);
      adam(g.w, m.w, v.w, p.w, c, lr, h);
      m4[i] = m;
      v4[i] = v;
      p4[i] = p;
    }
    tail = begin + (nvec << 2);
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    const float g = t.g ? t.g[i] : 0.f;
    float m = t.m[i], v = t.v[i], p = t.p[i];
    adam(g, m, v, p, c, lr, h);
    t.m[i] = m;
    t.v[i] = v;
    t.p[i] = p;
  }
}

}  // namespace

extern "C" {

// `table`: `rows` rows of AdamRow on the device, every numel > 0, the rows'
// first_chunk the running sum of ceil(numel / chunk) from 0, `chunks` the
// total; clip_scale one fp32 and lr_eff fp32 [max index + 1] on the device.
// The hyperparameters come as doubles and are rounded to fp32 here, 1 - b1
// and 1 - b2 after the subtraction in double, as a Python float scalar is
// rounded when it meets an fp32 tensor. Returns cudaGetLastError() after
// the launch.
int xggm_bert_adam(const void* table, int rows, int chunks,
                   const void* clip_scale, const void* lr_eff, double b1,
                   double b2, double eps, double wd, void* stream) {
  if (rows <= 0 || chunks < rows) return (int)cudaErrorInvalidValue;
  const Hyper h{(float)b1, (float)(1.0 - b1), (float)b2, (float)(1.0 - b2),
                (float)eps, (float)wd};
  bert_adam_kernel<<<chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AdamRow*>(table), rows,
      static_cast<const float*>(clip_scale),
      static_cast<const float*>(lr_eff), h);
  return (int)cudaGetLastError();
}

int xggm_bert_adam_chunk() { return (int)kChunk; }

const char* xggm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
