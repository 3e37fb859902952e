// Fused bilinear upsample + masked cross-entropy, forward and backward, for
// sm_90a.
//
// Replaces the Pallas TPU kernels `afan/ops/kernels/resize_ce_kernel.py`
// `_fwd_kernel` (launched by `_pallas_sums`) and `_bwd_kernel` (launched by
// `_pallas_grad`), the two halves of the custom-VJP `fused_resize_nll_sums`.
// The function: logits lo (B, C, h, w) are upsampled to (H, W) with
// align_corners=False bilinear weights (torch's `F.interpolate` rule: source
// index max(scale * (i + 0.5) - 0.5, 0) with scale = h / H, the upper tap
// clamped at the edge), and each batch entry gets the sum over its pixels
// with label != 255 of the cross-entropy ce = logsumexp_c(z) - z[label], or
// of the focal term alpha * (1 - exp(-ce))^gamma * ce. The (B, C, H, W)
// upsampled logits and their cotangent never exist in memory.
//
// What bounds it on this card: neither bytes nor operations at the
// slice's shapes (B = 4, C = 19, 192 -> 768: 11 MB of logits and 9.4 MB of
// labels, ~0.5 GFLOP of interpolation and exp) come near the card's limits;
// the kernels are bound by the latency of their load/exp chains and by the
// recomputation they choose (below), which keeps every intermediate on chip.
//
// Design.
//   forward (resize_ce_fwd_rows): one block per (output row i, entry b).
//     Each thread takes output pixels j of the row; for each it forms the C
//     logits from the 2 x 2 low-res taps (read through the read-only cache;
//     the two low-res rows a block touches stay in L1), takes the max, then
//     the sum of exp, and picks the labelled logit. The block reduces its
//     pixels in a fixed order to one partial sum per (b, i); sum_rows then
//     adds the H partials of each entry in a fixed order. No float atomics:
//     two runs agree bit for bit.
//   backward (resize_ce_bwd_rows): one block per (low-res row y, entry b),
//     so that the block owns its (C, w) slice of dlo and needs no atomics.
//     It walks the output rows i whose two taps include y (about 2 H / h of
//     them; each output row is therefore recomputed by two blocks). For
//     each such row it recomputes the logits, writes
//     g_b * wy * mask * (softmax - onehot) (times d focal / d ce for focal)
//     for the whole (C, W) row into shared memory, then each thread gathers,
//     for its (c, x) pairs, the row's output columns whose taps include x
//     with their W weights, and adds the result into the (C, w) accumulator
//     in shared memory. After the last row the accumulator is dlo[b, :, y].
//     The TPU kernel's H-pad to 8 rows and its replicated (8, 128) output
//     tile were Mosaic workarounds and have no counterpart here.
//
// Precision: everything is f32 with IEEE exp/log (no fast math) and no
// tensor cores. The build passes -fmad=false; the one contraction that
// torch's own upsample makes, in the source index, is written as fmaf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIgnore = 255;

struct Tap {
  int i0, i1;     // the two source indices (equal at the upper edge)
  float l0, l1;   // their weights
};

// torch's align_corners=False linear source taps of output index `dst`.
// The source index is one fused multiply-add, as torch's CUDA upsample
// computes it (nvcc contracts its `scale * (dst + 0.5) - 0.5`): at a scale
// like 129 / 513 the two roundings of an unfused form move the tap weights
// by up to 1.5e-5.
__device__ __forceinline__ Tap source_tap(int dst, float scale, int n_in) {
  float src = fmaf(scale, (float)dst + 0.5f, -0.5f);
  src = src < 0.0f ? 0.0f : src;
  Tap t;
  t.i0 = min((int)src, n_in - 1);
  t.i1 = t.i0 < n_in - 1 ? t.i0 + 1 : t.i0;
  t.l1 = src - (float)t.i0;
  t.l0 = 1.0f - t.l1;
  return t;
}

// The weight that output index `dst` gives source index `s`.
__device__ __forceinline__ float tap_weight(const Tap& t, int s) {
  return (t.i0 == s ? t.l0 : 0.0f) + (t.i1 == s ? t.l1 : 0.0f);
}

// One upsampled logit from channel plane `plane` (h x w, row stride w), in
// the order torch's upsample_bilinear2d uses: W first, then H.
__device__ __forceinline__ float logit(const float* __restrict__ plane, int w,
                                      const Tap& ty, const Tap& tx) {
  const float* r0 = plane + (size_t)ty.i0 * w;
  const float* r1 = plane + (size_t)ty.i1 * w;
  return ty.l0 * (tx.l0 * __ldg(r0 + tx.i0) + tx.l1 * __ldg(r0 + tx.i1)) +
         ty.l1 * (tx.l0 * __ldg(r1 + tx.i0) + tx.l1 * __ldg(r1 + tx.i1));
}

// logsumexp over the C logits of one output pixel, and the logit at `lab`
// (0 when lab is outside [0, C), as in the TPU kernel's select-sum).
__device__ __forceinline__ void pixel_lse(const float* __restrict__ lo_b,
                                          int C, size_t plane, int w,
                                          const Tap& ty, const Tap& tx,
                                          int lab, float* lse, float* picked) {
  float m = -INFINITY;
  for (int c = 0; c < C; ++c) m = fmaxf(m, logit(lo_b + c * plane, w, ty, tx));
  float s = 0.0f, p = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float z = logit(lo_b + c * plane, w, ty, tx);
    s += expf(z - m);
    if (c == lab) p = z;
  }
  *lse = m + logf(s);
  *picked = p;
}

// Sum of `v` over the block, in a fixed order. Every thread must call it;
// thread 0 gets the result.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float out = 0.0f;
  if (threadIdx.x == 0) {
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) out += warp_sums[k];
  }
  return out;
}

__global__ void resize_ce_fwd_rows(const float* __restrict__ lo,
                                   const int32_t* __restrict__ labels, int C,
                                   int h, int w, int H, int W, float sy,
                                   float sx, int focal, float alpha,
                                   float gamma, float* __restrict__ partial) {
  const int i = blockIdx.x, b = blockIdx.y;
  const size_t plane = (size_t)h * w;
  const float* lo_b = lo + (size_t)b * C * plane;
  const int32_t* lab_row = labels + ((size_t)b * H + i) * W;
  const Tap ty = source_tap(i, sy, h);
  float acc = 0.0f;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int lab = lab_row[j];
    if (lab == kIgnore) continue;
    const Tap tx = source_tap(j, sx, w);
    float lse, picked;
    pixel_lse(lo_b, C, plane, w, ty, tx, lab, &lse, &picked);
    float ce = lse - picked;
    if (focal) ce = alpha * powf(1.0f - expf(-ce), gamma) * ce;
    acc += ce;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[(size_t)b * H + i] = acc;
}

__global__ void sum_rows(const float* __restrict__ partial, int H,
                         float* __restrict__ out) {
  const int b = blockIdx.x;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) acc += partial[(size_t)b * H + i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[b] = acc;
}

__global__ void resize_ce_bwd_rows(const float* __restrict__ lo,
                                   const int32_t* __restrict__ labels,
                                   const float* __restrict__ gout, int C,
                                   int h, int w, int H, int W, float sy,
                                   float sx, float inv_sy, float inv_sx,
                                   int focal, float alpha, float gamma,
                                   float* __restrict__ dlo) {
  extern __shared__ float smem[];
  float* ghi = smem;              // (C, W): the row's logit cotangent
  float* acc = smem + C * W;      // (C, w): dlo[b, :, y, :]
  const int y = blockIdx.x, b = blockIdx.y;
  const size_t plane = (size_t)h * w;
  const float* lo_b = lo + (size_t)b * C * plane;
  const float g = gout[b];
  for (int k = threadIdx.x; k < C * w; k += blockDim.x) acc[k] = 0.0f;

  // Output rows whose taps can include y: src(i) in [y - 1, y + 1), with a
  // row of margin each side; tap_weight filters them exactly.
  const int i_lo = max(0, (int)floorf(((float)y - 0.5f) * inv_sy - 0.5f) - 1);
  const int i_hi =
      min(H - 1, (int)ceilf(((float)y + 1.5f) * inv_sy - 0.5f) + 1);
  for (int i = i_lo; i <= i_hi; ++i) {
    const Tap ty = source_tap(i, sy, h);
    const float wy = tap_weight(ty, y);
    if (wy == 0.0f) continue;     // the same in every thread
    const int32_t* lab_row = labels + ((size_t)b * H + i) * W;
    __syncthreads();              // the previous row's gather is done
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      const int lab = lab_row[j];
      if (lab == kIgnore) {
        for (int c = 0; c < C; ++c) ghi[c * W + j] = 0.0f;
        continue;
      }
      const Tap tx = source_tap(j, sx, w);
      float lse, picked;
      pixel_lse(lo_b, C, plane, w, ty, tx, lab, &lse, &picked);
      float coef = g * wy;
      if (focal) {
        const float ce = lse - picked;
        const float e = expf(-ce);
        const float ome = 1.0f - e;
        coef *= alpha * (powf(ome, gamma) +
                         ce * gamma * powf(ome, gamma - 1.0f) * e);
      }
      for (int c = 0; c < C; ++c) {
        const float z = logit(lo_b + c * plane, w, ty, tx);
        ghi[c * W + j] = coef * (expf(z - lse) - (c == lab ? 1.0f : 0.0f));
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < C * w; k += blockDim.x) {
      const int c = k / w, x = k - c * w;
      const int j_lo =
          max(0, (int)floorf(((float)x - 0.5f) * inv_sx - 0.5f) - 1);
      const int j_hi =
          min(W - 1, (int)ceilf(((float)x + 1.5f) * inv_sx - 0.5f) + 1);
      const float* grow = ghi + c * W;
      float s = 0.0f;
      for (int j = j_lo; j <= j_hi; ++j) {
        const float wx = tap_weight(source_tap(j, sx, w), x);
        if (wx != 0.0f) s += wx * grow[j];
      }
      acc[k] += s;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < C * w; k += blockDim.x) {
    const int c = k / w, x = k - c * w;
    dlo[(((size_t)b * C + c) * h + y) * w + x] = acc[k];
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) one backward block needs.
int afan_resize_ce_bwd_smem(int C, int w, int W) {
  return (int)((size_t)C * (W + w) * sizeof(float));
}

// lo (B, C, h, w) f32 and labels (B, H, W) int32, both contiguous; partial
// scratch of B * H floats; out (B,) f32. Launches on `stream` and returns
// cudaGetLastError().
int afan_resize_ce_forward(const float* lo, const int32_t* labels, int B,
                           int C, int h, int w, int H, int W, int focal,
                           float alpha, float gamma, float* partial,
                           float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sy = (float)h / (float)H, sx = (float)w / (float)W;
  resize_ce_fwd_rows<<<dim3(H, B), kThreads, 0, s>>>(
      lo, labels, C, h, w, H, W, sy, sx, focal, alpha, gamma, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_rows<<<B, kThreads, 0, s>>>(partial, H, out);
  return static_cast<int>(cudaGetLastError());
}

// gout (B,) f32 is the cotangent of the forward's sums; dlo (B, C, h, w) f32
// receives d(sum_b gout[b] * sums[b]) / d lo. Every element of dlo is
// written.
int afan_resize_ce_backward(const float* lo, const int32_t* labels,
                            const float* gout, int B, int C, int h, int w,
                            int H, int W, int focal, float alpha, float gamma,
                            float* dlo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = afan_resize_ce_bwd_smem(C, w, W);
  cudaError_t err = cudaFuncSetAttribute(
      resize_ce_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float sy = (float)h / (float)H, sx = (float)w / (float)W;
  const float inv_sy = (float)H / (float)h, inv_sx = (float)W / (float)w;
  resize_ce_bwd_rows<<<dim3(h, B), kThreads, smem, s>>>(
      lo, labels, gout, C, h, w, H, W, sy, sx, inv_sy, inv_sx, focal, alpha,
      gamma, dlo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
