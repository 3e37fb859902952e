// Fused PGD sign step, with an optional L-inf projection, for sm_90a.
//
// Replaces the Pallas TPU kernels `afan/ops/kernels/pgd_step.py`
// `_update_kernel` and `_update_clip_kernel` (launched by
// `pgd_update_pallas`), for float32 and for bfloat16 tensors. The function,
// elementwise over n floats:
//   out = x + gamma * sign(g)                                   clip = 0
//   out = minimum(maximum(x + gamma * sign(g), c - eps), c + eps)   clip = 1
// with the semantics of the eager PyTorch chain on the card
// (`afan_torch/ops/pgd_step.py:pgd_update_plain`), bit for bit:
//   - sign(g) = (g > 0) - (g < 0): +0 for +-0 and for NaN, +-1 for denormals;
//   - the product and the sum are each rounded once in f32 (the product is
//     exact, 0 or +-gamma, so a contraction could not change it either);
//   - c - eps and c + eps are f32 roundings with the f32 eps;
//   - maximum / minimum return their first operand if it is NaN, else the
//     second if that is NaN, else fmaxf / fminf of the two, as torch's
//     elementwise maximum and minimum do.
// The build passes -fmad=false and no fast-math or flush-to-zero flag.
//
// bfloat16 (`afan`'s ascent under --bf16 keeps x's dtype): each element is
// widened to f32 exactly, and the result of each op that `afan` runs in
// bf16 is rounded to bf16 (round to nearest even) before the next:
//   t = bf16(x + gamma * s);  out = minimum(maximum(t, bf16(c - eps)),
//                                           bf16(c + eps))
// with gamma and eps already bf16 values (the wrapper rounds them on the
// host, as JAX rounds a Python scalar that meets a bf16 array). The product
// is exact (0 or +-gamma) and the f32 sum of two bf16 values rounds to the
// same bf16 as the exact sum, so each line has one rounding, as in `afan`
// and in the plain version's bf16 ops.
//
// What bounds it on this card: bytes. Each element reads x and g (and c)
// once and writes out once, 12 (16) bytes for 3 (7) f32 operations (half
// the bytes in bf16), far below the ~20 f32 operations per HBM byte where
// the card turns compute-bound. The unfused chain (sign, mul, add; then sub, add, maximum,
// minimum for the clip) writes and reads back an intermediate per op: 3
// launches and 28 bytes per element, 7 launches and 68 bytes with the clip.
//
// Design: a 1-D grid-stride pass. When every pointer is 16-byte aligned,
// each thread moves 16 bytes per operand at a time (a float4, or 8 bf16 in
// a uint4), and the elements past the last whole vector go to the first
// threads as scalars; a misaligned view takes the scalar loop throughout.
// No shared memory, no reduction: every output element depends on its own
// inputs alone, so the result does not depend on the launch shape.
//
// Device step size (`afan_pgd_step_dev`, `afan_pgd_step_bf16_dev`): the
// same kernels read gamma from a one-element buffer on the card (f32, or
// the bf16 word already rounded) as they start, instead of taking it by
// value, so a step size drawn on the card (`--pgd_random_steps`) needs no
// trip to the host and a replayed CUDA graph reads each replay's draw. The
// buffer adds one 4- (2-) byte load per thread; the update is unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ float torch_maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float torch_minimum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

template <bool kClip>
__device__ __forceinline__ float update(float x, float g, float c, float gamma,
                                        float eps) {
  const float s = (float)((g > 0.0f) - (g < 0.0f));
  const float t = x + gamma * s;
  if (!kClip) return t;
  return torch_minimum(torch_maximum(t, c - eps), c + eps);
}

// The f32 value of a bf16 held in the low 16 bits (exact).
__device__ __forceinline__ float bf16_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One bf16 element as the bf16 ops compute it: each input widened exactly,
// each result rounded to bf16; returns the result's bits.
template <bool kClip>
__device__ __forceinline__ uint32_t update_bf16(uint32_t x, uint32_t g,
                                                uint32_t c, float gamma,
                                                float eps) {
  const float gf = bf16_float(g);
  const float s = (float)((gf > 0.0f) - (gf < 0.0f));
  float t = round_bf16(bf16_float(x) + gamma * s);
  if (kClip) {
    const float cf = bf16_float(c);
    t = torch_minimum(torch_maximum(t, round_bf16(cf - eps)),
                      round_bf16(cf + eps));
  }
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(t));
}

// Two bf16 elements packed in a 32-bit word, the first in the low half.
template <bool kClip>
__device__ __forceinline__ uint32_t update_pair(uint32_t x, uint32_t g,
                                                uint32_t c, float gamma,
                                                float eps) {
  const uint32_t lo = update_bf16<kClip>(x & 0xffffu, g & 0xffffu,
                                         c & 0xffffu, gamma, eps);
  const uint32_t hi = update_bf16<kClip>(x >> 16, g >> 16, c >> 16, gamma,
                                         eps);
  return lo | (hi << 16);
}

template <bool kClip, bool kDevGamma>
__global__ void pgd_step_vec4(const float4* __restrict__ x,
                              const float4* __restrict__ g,
                              const float4* __restrict__ c,
                              float4* __restrict__ out, int64_t n4,
                              const float* __restrict__ xs,
                              const float* __restrict__ gs,
                              const float* __restrict__ cs,
                              float* __restrict__ outs, int64_t n,
                              float gamma, const float* __restrict__ gamma_dev,
                              float eps) {
  if (kDevGamma) gamma = *gamma_dev;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < n4; i += stride) {
    const float4 xv = x[i], gv = g[i];
    const float4 cv = kClip ? c[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 o;
    o.x = update<kClip>(xv.x, gv.x, cv.x, gamma, eps);
    o.y = update<kClip>(xv.y, gv.y, cv.y, gamma, eps);
    o.z = update<kClip>(xv.z, gv.z, cv.z, gamma, eps);
    o.w = update<kClip>(xv.w, gv.w, cv.w, gamma, eps);
    out[i] = o;
  }
  const int64_t k = 4 * n4 + tid;   // the n % 4 tail, one element a thread
  if (k < n) {
    outs[k] = update<kClip>(xs[k], gs[k], kClip ? cs[k] : 0.0f, gamma, eps);
  }
}

template <bool kClip, bool kDevGamma>
__global__ void pgd_step_scalar(const float* __restrict__ x,
                                const float* __restrict__ g,
                                const float* __restrict__ c,
                                float* __restrict__ out, int64_t n,
                                float gamma,
                                const float* __restrict__ gamma_dev,
                                float eps) {
  if (kDevGamma) gamma = *gamma_dev;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = update<kClip>(x[i], g[i], kClip ? c[i] : 0.0f, gamma, eps);
  }
}

template <bool kClip, bool kDevGamma>
__global__ void pgd_step_bf16_vec8(const uint4* __restrict__ x,
                                   const uint4* __restrict__ g,
                                   const uint4* __restrict__ c,
                                   uint4* __restrict__ out, int64_t n8,
                                   const uint16_t* __restrict__ xs,
                                   const uint16_t* __restrict__ gs,
                                   const uint16_t* __restrict__ cs,
                                   uint16_t* __restrict__ outs, int64_t n,
                                   float gamma,
                                   const uint16_t* __restrict__ gamma_dev,
                                   float eps) {
  if (kDevGamma) gamma = bf16_float(*gamma_dev);
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < n8; i += stride) {
    const uint4 xv = x[i], gv = g[i];
    const uint4 cv = kClip ? c[i] : make_uint4(0u, 0u, 0u, 0u);
    uint4 o;
    o.x = update_pair<kClip>(xv.x, gv.x, cv.x, gamma, eps);
    o.y = update_pair<kClip>(xv.y, gv.y, cv.y, gamma, eps);
    o.z = update_pair<kClip>(xv.z, gv.z, cv.z, gamma, eps);
    o.w = update_pair<kClip>(xv.w, gv.w, cv.w, gamma, eps);
    out[i] = o;
  }
  const int64_t k = 8 * n8 + tid;   // the n % 8 tail, one element a thread
  if (k < n) {
    outs[k] = (uint16_t)update_bf16<kClip>(xs[k], gs[k], kClip ? cs[k] : 0u,
                                           gamma, eps);
  }
}

template <bool kClip, bool kDevGamma>
__global__ void pgd_step_bf16_scalar(const uint16_t* __restrict__ x,
                                     const uint16_t* __restrict__ g,
                                     const uint16_t* __restrict__ c,
                                     uint16_t* __restrict__ out, int64_t n,
                                     float gamma,
                                     const uint16_t* __restrict__ gamma_dev,
                                     float eps) {
  if (kDevGamma) gamma = bf16_float(*gamma_dev);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = (uint16_t)update_bf16<kClip>(x[i], g[i], kClip ? c[i] : 0u,
                                          gamma, eps);
  }
}

int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <bool kClip, bool kDevGamma>
void launch(const float* x, const float* g, const float* c, float* out,
            int64_t n, float gamma, const float* gamma_dev, float eps,
            cudaStream_t s) {
  const uintptr_t bits = (uintptr_t)x | (uintptr_t)g | (uintptr_t)out |
                         (kClip ? (uintptr_t)c : 0);
  if (bits % 16 == 0) {
    const int64_t n4 = n / 4;
    pgd_step_vec4<kClip, kDevGamma>
        <<<blocks_for(n4 > 0 ? n4 : 1), kThreads, 0, s>>>(
            reinterpret_cast<const float4*>(x),
            reinterpret_cast<const float4*>(g),
            reinterpret_cast<const float4*>(c),
            reinterpret_cast<float4*>(out), n4, x, g, c, out, n, gamma,
            gamma_dev, eps);
  } else {
    pgd_step_scalar<kClip, kDevGamma><<<blocks_for(n), kThreads, 0, s>>>(
        x, g, c, out, n, gamma, gamma_dev, eps);
  }
}

template <bool kClip, bool kDevGamma>
void launch_bf16(const uint16_t* x, const uint16_t* g, const uint16_t* c,
                 uint16_t* out, int64_t n, float gamma,
                 const uint16_t* gamma_dev, float eps, cudaStream_t s) {
  const uintptr_t bits = (uintptr_t)x | (uintptr_t)g | (uintptr_t)out |
                         (kClip ? (uintptr_t)c : 0);
  if (bits % 16 == 0) {
    const int64_t n8 = n / 8;
    pgd_step_bf16_vec8<kClip, kDevGamma>
        <<<blocks_for(n8 > 0 ? n8 : 1), kThreads, 0, s>>>(
            reinterpret_cast<const uint4*>(x),
            reinterpret_cast<const uint4*>(g),
            reinterpret_cast<const uint4*>(c), reinterpret_cast<uint4*>(out),
            n8, x, g, c, out, n, gamma, gamma_dev, eps);
  } else {
    pgd_step_bf16_scalar<kClip, kDevGamma><<<blocks_for(n), kThreads, 0, s>>>(
        x, g, c, out, n, gamma, gamma_dev, eps);
  }
}

}  // namespace

extern "C" {

// x, g, out (and c when clip != 0): n contiguous f32 each; out must not
// alias the inputs. One launch on `stream`; returns cudaGetLastError().
int afan_pgd_step(const float* x, const float* g, const float* c, float* out,
                  int64_t n, float gamma, float eps, int clip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clip) {
    launch<true, false>(x, g, c, out, n, gamma, nullptr, eps, s);
  } else {
    launch<false, false>(x, g, c, out, n, gamma, nullptr, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same on bf16 tensors (raw 16-bit words); gamma and eps must already
// be bf16 values.
int afan_pgd_step_bf16(const uint16_t* x, const uint16_t* g,
                       const uint16_t* c, uint16_t* out, int64_t n,
                       float gamma, float eps, int clip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clip) {
    launch_bf16<true, false>(x, g, c, out, n, gamma, nullptr, eps, s);
  } else {
    launch_bf16<false, false>(x, g, c, out, n, gamma, nullptr, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// afan_pgd_step with gamma read on the card from `gamma` (one f32).
int afan_pgd_step_dev(const float* x, const float* g, const float* c,
                      float* out, int64_t n, const float* gamma, float eps,
                      int clip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clip) {
    launch<true, true>(x, g, c, out, n, 0.0f, gamma, eps, s);
  } else {
    launch<false, true>(x, g, c, out, n, 0.0f, gamma, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// afan_pgd_step_bf16 with gamma read on the card from `gamma` (one bf16
// word); eps must already be a bf16 value.
int afan_pgd_step_bf16_dev(const uint16_t* x, const uint16_t* g,
                           const uint16_t* c, uint16_t* out, int64_t n,
                           const uint16_t* gamma, float eps, int clip,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clip) {
    launch_bf16<true, true>(x, g, c, out, n, 0.0f, gamma, eps, s);
  } else {
    launch_bf16<false, true>(x, g, c, out, n, 0.0f, gamma, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
