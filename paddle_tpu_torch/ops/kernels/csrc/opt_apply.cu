// Fused optimizer apply over a flat f32 ZeRO shard for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces: paddle_tpu/ops/pallas/opt_apply.py:117
// `_opt_apply_kernel` (launched by `opt_apply_pallas`): one sgd, momentum
// or adam update of a rank's contiguous shard of the global parameter
// vector, reading p, g and the moment slots once and writing p' and the
// slots once.  The elastic data plane runs it once per step per rank
// (paddle_tpu_torch/distributed/fleet/dist_step.py fused_optimizer_apply).
//
// What bounds it on this card: bytes.  Per element it reads p, g and 0-2
// slots and writes p' and the slots, (3 + 2 * slots) * 4 bytes (28 for
// adam), against at most 14 f32 operations: at 3.35 TB/s an adam step over
// the Llama proxy's 536 M parameters moves 15 GB and takes at least 4.5 ms;
// the f32 units would need 0.1 ms.  At the elastic bench's shard (200,000
// elements) the launch, not the bytes, sets the time.
//
// What the design does about it: one grid-stride elementwise pass with
// 16-byte vector loads and stores (float4) where every pointer is 16-byte
// aligned, and a scalar loop for the tail (and for unaligned views), so the
// loads of neighbouring threads coalesce.  The kind is a template
// parameter; the nine hyper values travel by value as kernel arguments, so
// a step copies nothing from the host.  Out of place, as the reference
// returns new arrays.  Every operation is an explicit round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn) in the
// reference's expression order, so nvcc cannot contract a multiply-add
// into an FMA, divisions and the square root are correctly rounded, and
// (built without -ftz or --use_fast_math) no denormal is flushed: the
// result is bitwise the plain PyTorch version's and the host numpy
// engine's.  The update is strictly elementwise, so a shard's update is
// bitwise the same slice of the full vector's.  The reference's (256, 128)
// tiling and zero padding were VMEM artefacts and are not needed here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Hyper {
  float lr, b1, b2, eps, c1, c2, mu, omb1, omb2;
};

enum { SGD = 0, MOMENTUM = 1, ADAM = 2 };

// One element: the reference's expressions
//   sgd:      p - lr * g
//   momentum: u' = mu * u + g;  p - lr * u'
//   adam:     m' = b1 * m + omb1 * g;  v' = b2 * v + (omb2 * g) * g;
//             p - (lr * (m' / c1)) / (sqrt(v' / c2) + eps)
template <int KIND>
__device__ __forceinline__ float update(float p, float g, float& s0,
                                        float& s1, const Hyper& h) {
  if (KIND == SGD) return __fsub_rn(p, __fmul_rn(h.lr, g));
  if (KIND == MOMENTUM) {
    s0 = __fadd_rn(__fmul_rn(h.mu, s0), g);
    return __fsub_rn(p, __fmul_rn(h.lr, s0));
  }
  s0 = __fadd_rn(__fmul_rn(h.b1, s0), __fmul_rn(h.omb1, g));
  s1 = __fadd_rn(__fmul_rn(h.b2, s1), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float mhat = __fdiv_rn(s0, h.c1);
  const float vhat = __fdiv_rn(s1, h.c2);
  return __fsub_rn(p, __fdiv_rn(__fmul_rn(h.lr, mhat),
                                __fadd_rn(__fsqrt_rn(vhat), h.eps)));
}

template <int KIND>
__global__ void opt_apply_kernel(const float* __restrict__ p,
                                 const float* __restrict__ g,
                                 const float* __restrict__ s0,
                                 const float* __restrict__ s1,
                                 float* __restrict__ po,
                                 float* __restrict__ s0o,
                                 float* __restrict__ s1o, long long n,
                                 long long nvec, Hyper h) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // nvec float4 groups (0 when a pointer is not 16-byte aligned)
  for (long long i = tid; i < nvec; i += stride) {
    const float4 pv = reinterpret_cast<const float4*>(p)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a, out;
    if (KIND != SGD) a = reinterpret_cast<const float4*>(s0)[i];
    if (KIND == ADAM) b = reinterpret_cast<const float4*>(s1)[i];
    out.x = update<KIND>(pv.x, gv.x, a.x, b.x, h);
    out.y = update<KIND>(pv.y, gv.y, a.y, b.y, h);
    out.z = update<KIND>(pv.z, gv.z, a.z, b.z, h);
    out.w = update<KIND>(pv.w, gv.w, a.w, b.w, h);
    reinterpret_cast<float4*>(po)[i] = out;
    if (KIND != SGD) reinterpret_cast<float4*>(s0o)[i] = a;
    if (KIND == ADAM) reinterpret_cast<float4*>(s1o)[i] = b;
  }
  for (long long i = nvec * 4 + tid; i < n; i += stride) {
    float a = KIND != SGD ? s0[i] : 0.f;
    float b = KIND == ADAM ? s1[i] : 0.f;
    po[i] = update<KIND>(p[i], g[i], a, b, h);
    if (KIND != SGD) s0o[i] = a;
    if (KIND == ADAM) s1o[i] = b;
  }
}

inline bool aligned16(const void* ptr) {
  return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// kind: 0 sgd, 1 momentum, 2 adam.  p, g, po: [n] f32 contiguous; s0/s0o
// (momentum's u, adam's m) and s1/s1o (adam's v): [n] f32 or null when the
// kind has no such slot.  Returns the CUDA error of the launch (0 on
// success).
int opt_apply_f32(int kind, const void* p, const void* g, const void* s0,
                  const void* s1, void* po, void* s0o, void* s1o,
                  long long n, float lr, float b1, float b2, float eps,
                  float c1, float c2, float mu, float omb1, float omb2,
                  void* stream) {
  if (n <= 0 || kind < SGD || kind > ADAM) return (int)cudaErrorInvalidValue;
  const Hyper h{lr, b1, b2, eps, c1, c2, mu, omb1, omb2};
  const bool vec = aligned16(p) && aligned16(g) && aligned16(s0) &&
                   aligned16(s1) && aligned16(po) && aligned16(s0o) &&
                   aligned16(s1o);
  const long long nvec = vec ? n / 4 : 0;
  const long long work = nvec > 0 ? nvec : n;
  const int threads = 256;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;   // grid-stride beyond this
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fp = static_cast<const float*>(p);
  const float* fg = static_cast<const float*>(g);
  const float* f0 = static_cast<const float*>(s0);
  const float* f1 = static_cast<const float*>(s1);
  float* op = static_cast<float*>(po);
  float* o0 = static_cast<float*>(s0o);
  float* o1 = static_cast<float*>(s1o);
  if (kind == SGD)
    opt_apply_kernel<SGD><<<(unsigned)blocks, threads, 0, st>>>(
        fp, fg, f0, f1, op, o0, o1, n, nvec, h);
  else if (kind == MOMENTUM)
    opt_apply_kernel<MOMENTUM><<<(unsigned)blocks, threads, 0, st>>>(
        fp, fg, f0, f1, op, o0, o1, n, nvec, h);
  else
    opt_apply_kernel<ADAM><<<(unsigned)blocks, threads, 0, st>>>(
        fp, fg, f0, f1, op, o0, o1, n, nvec, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
