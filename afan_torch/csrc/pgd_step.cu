// Fused PGD sign step, with an optional L-inf projection, for sm_90a.
//
// Replaces the Pallas TPU kernels `afan/ops/kernels/pgd_step.py`
// `_update_kernel` and `_update_clip_kernel` (launched by
// `pgd_update_pallas`). The function, elementwise over n floats:
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
// What bounds it on this card: bytes. Each element reads x and g (and c)
// once and writes out once, 12 (16) bytes for 3 (7) f32 operations, far
// below the ~20 f32 operations per HBM byte where the card turns
// compute-bound. The unfused chain (sign, mul, add; then sub, add, maximum,
// minimum for the clip) writes and reads back an intermediate per op: 3
// launches and 28 bytes per element, 7 launches and 68 bytes with the clip.
//
// Design: a 1-D grid-stride pass. When every pointer is 16-byte aligned,
// each thread moves float4s (one 16-byte load per operand), and the n % 4
// elements past the last float4 go to the first threads as scalars; a
// misaligned view takes the scalar loop throughout. No shared memory, no
// reduction: every output element depends on its own inputs alone, so the
// result does not depend on the launch shape.

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

template <bool kClip>
__global__ void pgd_step_vec4(const float4* __restrict__ x,
                              const float4* __restrict__ g,
                              const float4* __restrict__ c,
                              float4* __restrict__ out, int64_t n4,
                              const float* __restrict__ xs,
                              const float* __restrict__ gs,
                              const float* __restrict__ cs,
                              float* __restrict__ outs, int64_t n,
                              float gamma, float eps) {
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

template <bool kClip>
__global__ void pgd_step_scalar(const float* __restrict__ x,
                                const float* __restrict__ g,
                                const float* __restrict__ c,
                                float* __restrict__ out, int64_t n,
                                float gamma, float eps) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = update<kClip>(x[i], g[i], kClip ? c[i] : 0.0f, gamma, eps);
  }
}

int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <bool kClip>
void launch(const float* x, const float* g, const float* c, float* out,
            int64_t n, float gamma, float eps, cudaStream_t s) {
  const uintptr_t bits = (uintptr_t)x | (uintptr_t)g | (uintptr_t)out |
                         (kClip ? (uintptr_t)c : 0);
  if (bits % 16 == 0) {
    const int64_t n4 = n / 4;
    pgd_step_vec4<kClip><<<blocks_for(n4 > 0 ? n4 : 1), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(g),
        reinterpret_cast<const float4*>(c), reinterpret_cast<float4*>(out), n4,
        x, g, c, out, n, gamma, eps);
  } else {
    pgd_step_scalar<kClip><<<blocks_for(n), kThreads, 0, s>>>(
        x, g, c, out, n, gamma, eps);
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
    launch<true>(x, g, c, out, n, gamma, eps, s);
  } else {
    launch<false>(x, g, c, out, n, gamma, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
