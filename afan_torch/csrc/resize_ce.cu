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
// the kernels are bound by instruction issue: the exp of every (pixel,
// class) and the loads and lerps that build each logit, which they keep on
// chip instead of storing the upsampled logits.
//
// Design.
//   forward (resize_ce_fwd): one block per (kFwdRows = 3 output rows,
//     entry b). The upsample is separable, and the block runs it H first, as
//     the TPU kernel does: (1) the H pass, v_i[x][c] = l0 * lo[b, c, i0, x] +
//     l1 * lo[b, c, i1, x] for each of its rows i and the row's two low-res
//     taps, into shared memory (loads coalesced along x; the block's rows
//     share most of their taps, so L2 serves each low-res value about once
//     per block and L1 the repeats); (2) per output pixel j of a row, one
//     thread forms its column taps once and each of its C logits once,
//     z_k = l0 * v_i[x0][k] + l1 * v_i[x1][k]: two shared loads and three
//     operations. With the class count known at compile time
//     (19 and 21, the trainers' datasets) the logits stay in registers and
//     every class's offset is an immediate; otherwise (kC = 0) the thread
//     reads v twice, for the max and for the sum. v keeps each low-res
//     column's C values together, columns an odd number of words apart (C,
//     or C + 1 when C is even): the writes of (1), and the reads of (2),
//     where a warp's 32 pixels share about 8 columns, each fall on distinct
//     banks or one broadcast word. Then max, one exp per logit, one log and
//     the picked logit; labels 255 add nothing. The block reduces each row's
//     pixels in a fixed order to one partial sum per (b, i); sum_rows then
//     adds the H partials of each entry in a fixed order. No float atomics:
//     two runs agree bit for bit. One block per output row spent about half
//     its time in (1), fetching each low-res row from L2 eight times;
//     three rows per block cut that, and more rows cost more in occupancy
//     (shared memory) than they save.
//   backward (resize_ce_bwd_bands): one block per (band of a few low-res
//     rows, range of low-res columns, entry b). The band plan
//     (afan_torch/ops/kernels/resize_ce.py:band_plan) gives each block the
//     rows [y_a, y_b) and columns [x_a, x_b) it owns and the
//     output rows [i_lo, i_hi) and columns [j_lo, j_hi) whose taps may touch
//     them; the block owns dlo[b, :, y_a:y_b, x_a:x_b], writes it once and
//     needs no atomics. At block start it tabulates in shared memory the
//     column tap weights of its output columns and, for each owned column,
//     the range of output columns that feed it. Then, for each output row
//     with a non-zero weight on the band: (1) each pixel's thread forms the
//     pixel's C logits (in registers when C is 19 or 21, the class counts
//     of the trainers' datasets), takes one exp per logit and writes
//     g_b * (softmax - onehot) (times d focal / d ce for focal) into the
//     row's segment in shared memory, zero where the label is 255; (2) each
//     thread contracts W for an owned column and four classes from the tap
//     table and adds the result, times the row's H weights, into the <= 2
//     owned accumulator rows. Rows are taken in output order and columns in
//     segment order, so the sums have a fixed order. With m rows per band an
//     output row is computed by (m + 1) / m blocks on average, where one
//     block per low-res row computed it twice. What bounds it at the
//     slice's shapes is instruction issue in (1) (four loads and the 2 x 2
//     lerp per logit, an exp, the softmax) and shared-memory traffic in
//     (2), not bytes.
//   The TPU kernel's H-pad to 8 rows and its replicated (8, 128) output tile
//   were Mosaic workarounds and have no counterpart here.
//   A row window (a row-sharded step, afan_torch/parallel/spatial.py): lo
//   holds the rows [y0, y0 + h) of a map of hg rows, and the labels the
//   output rows [Y0, Y0 + H) of the resize to Hg rows. Each output row's
//   taps are those of its global row, computed and clamped globally
//   (row_tap), then offset by y0. With y0 = Y0 = 0, hg = h and Hg = H both
//   kernels are the whole-map kernels, bit for bit.
//
// Precision: everything is f32 with IEEE exp/log (no fast math) and no
// tensor cores. The build passes -fmad=false; the one contraction that
// torch's own upsample makes, in the source index, is written as fmaf.
//
// bfloat16 logits (`afan`'s segmentation step under --bf16): both kernels
// take lo as float or __nv_bfloat16 (template parameter T) and widen each
// value to f32 as they load it (exact), so every operation above is the
// same f32 arithmetic on the same values as the f32 kernels on lo.float();
// the sums stay f32, and the backward rounds each dlo entry to bf16 once,
// at its store (`afan`'s `dlo.astype(lo.dtype)`,
// resize_ce_kernel.py:256-258). The bf16 gradient is therefore the f32
// kernel's gradient on lo.float() rounded to bf16, bit for bit, and the
// logits are read once, without a widened copy.

#include <cuda_bf16.h>
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

// The row taps of output row `i` of a window: global row Y0 + i of a resize
// from hg rows (scale sy = hg / Hg), in the rows of the window from y0.
__device__ __forceinline__ Tap row_tap(int i, float sy, int hg, int y0,
                                       int Y0) {
  Tap t = source_tap(i + Y0, sy, hg);
  t.i0 -= y0;
  t.i1 -= y0;
  return t;
}

// The weight that output index `dst` gives source index `s`.
__device__ __forceinline__ float tap_weight(const Tap& t, int s) {
  return (t.i0 == s ? t.l0 : 0.0f) + (t.i1 == s ? t.l1 : 0.0f);
}

// A logit as f32, read through the read-only cache: bf16 widens exactly.
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// A gradient entry in the logits' dtype: bf16 rounds to nearest even.
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One upsampled logit from channel plane `plane` (h x w, row stride w), in
// the order torch's upsample_bilinear2d uses: W first, then H.
template <typename T>
__device__ __forceinline__ float logit(const T* __restrict__ plane, int w,
                                      const Tap& ty, const Tap& tx) {
  const T* r0 = plane + (size_t)ty.i0 * w;
  const T* r1 = plane + (size_t)ty.i1 * w;
  return ty.l0 * (tx.l0 * load(r0 + tx.i0) + tx.l1 * load(r0 + tx.i1)) +
         ty.l1 * (tx.l0 * load(r1 + tx.i0) + tx.l1 * load(r1 + tx.i1));
}

// Sums over the block of each of the N values `v`, each in a fixed order
// (within warps, then warp by warp), with one barrier. Every thread must
// call it; thread 0 gets the sums in `v`.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N]) {
  __shared__ float warp_sums[N][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    for (int off = 16; off > 0; off >>= 1)
      v[r] += __shfl_down_sync(0xffffffffu, v[r], off);
    if (lane == 0) warp_sums[r][warp] = v[r];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      v[r] = 0.0f;
      for (int k = 0; k < (int)(blockDim.x >> 5); ++k)
        v[r] += warp_sums[r][k];
    }
  }
}

// Advances the flattened index (c, r) of a (C, n) grid by `step`.
__device__ __forceinline__ void advance(int& c, int& r, int n, int step) {
  r += step;
  while (r >= n) {
    r -= n;
    ++c;
  }
}

// Words between two low-res columns of the forward's row buffer: C made
// odd, so that columns 1..31 apart fall on distinct banks.
__host__ __device__ __forceinline__ int fwd_stride(int C) { return C | 1; }

// Output rows per forward block. The rows of a block share most of their
// low-res taps: L2 serves each low-res value about once per block, and L1
// the repeated loads of its other rows.
constexpr int kFwdRows = 3;

// Elements of the H pass each thread loads before it stores them, so that
// several loads are in flight.
constexpr int kFwdBatch = 4;

template <int kC, typename T>
__global__ void __launch_bounds__(kThreads)
resize_ce_fwd(const T* __restrict__ lo,
              const int32_t* __restrict__ labels, int C, int h, int w,
              int H, int W, int hg, int y0, int Y0, float sy, float sx,
              int focal, float alpha, float gamma,
              float* __restrict__ partial) {
  extern __shared__ float v[];   // (kFwdRows, w, stride): rows before W
  const int i_first = blockIdx.x * kFwdRows, b = blockIdx.y;
  const int rows = min(kFwdRows, H - i_first);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int S = fwd_stride(C);
  const size_t plane = (size_t)h * w;
  const T* lo_b = lo + (size_t)b * C * plane;
  Tap ty[kFwdRows];
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r)
    ty[r] = row_tap(min(i_first + r, H - 1), sy, hg, y0, Y0);

  // (1) the H pass of each row over the (C, w) grid, flattened along x
  int c = tid / w, x = tid - c * w;
  while (c < C) {
    float a0[kFwdBatch][kFwdRows], a1[kFwdBatch][kFwdRows];
    int at[kFwdBatch];
    int cc = c, xx = x;
#pragma unroll
    for (int u = 0; u < kFwdBatch; ++u) {
      at[u] = cc < C ? xx * S + cc : -1;
      if (cc < C) {
        const T* col = lo_b + cc * plane + xx;
#pragma unroll
        for (int r = 0; r < kFwdRows; ++r) {
          a0[u][r] = load(col + (size_t)ty[r].i0 * w);
          a1[u][r] = load(col + (size_t)ty[r].i1 * w);
        }
      }
      advance(cc, xx, w, nt);
    }
#pragma unroll
    for (int u = 0; u < kFwdBatch; ++u) {
      if (at[u] < 0) continue;
#pragma unroll
      for (int r = 0; r < kFwdRows; ++r)
        v[r * w * S + at[u]] = ty[r].l0 * a0[u][r] + ty[r].l1 * a1[u][r];
    }
    c = cc;
    x = xx;
  }
  __syncthreads();

  // (2) per output pixel: C logits (W pass), logsumexp, the picked logit
  float acc[kFwdRows];
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r) {
    acc[r] = 0.0f;
    if (r >= rows) continue;
    const float* vr = v + r * w * S;
    const int32_t* lab_row = labels + ((size_t)b * H + i_first + r) * W;
    for (int j = tid; j < W; j += nt) {
      const int lab = lab_row[j];
      if (lab == kIgnore) continue;
      const Tap tx = source_tap(j, sx, w);
      const float* v0 = vr + tx.i0 * S;
      const float* v1 = vr + tx.i1 * S;
      float m = -INFINITY, s = 0.0f;
      if constexpr (kC > 0) {
        float z[kC];
#pragma unroll
        for (int k = 0; k < kC; ++k) {
          z[k] = tx.l0 * v0[k] + tx.l1 * v1[k];
          m = fmaxf(m, z[k]);
        }
#pragma unroll
        for (int k = 0; k < kC; ++k) s += expf(z[k] - m);
      } else {
        for (int k = 0; k < C; ++k)
          m = fmaxf(m, tx.l0 * v0[k] + tx.l1 * v1[k]);
        for (int k = 0; k < C; ++k)
          s += expf(tx.l0 * v0[k] + tx.l1 * v1[k] - m);
      }
      // the labelled logit, 0 when lab is outside [0, C) (the TPU kernel's
      // select-sum)
      const float picked =
          lab >= 0 && lab < C ? tx.l0 * v0[lab] + tx.l1 * v1[lab] : 0.0f;
      float ce = (m + logf(s)) - picked;
      if (focal) ce = alpha * powf(1.0f - expf(-ce), gamma) * ce;
      acc[r] += ce;
    }
  }
  // one partial per output row
  block_sums(acc);
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r)
      if (r < rows) partial[(size_t)b * H + i_first + r] = acc[r];
  }
}

__global__ void sum_rows(const float* __restrict__ partial, int H,
                         float* __restrict__ out) {
  const int b = blockIdx.x;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) acc += partial[(size_t)b * H + i];
  float sum[1] = {acc};
  block_sums(sum);
  if (threadIdx.x == 0) out[b] = sum[0];
}

constexpr int kPlanCols = 8;      // y_a, y_b, i_lo, i_hi, x_a, x_b, j_lo, j_hi
constexpr int kBandMinBlocks = 3; // blocks per SM the band kernel is built for

// Where segment column q lives in a shared per-column array: grouped by
// q mod 4, each group in column order, Q words apart. In the contraction a
// warp's threads take neighbouring owned columns, whose feeding segment
// columns are W / w apart, 4 at every site of the path (the decoder's logits
// are at a quarter of the crop): in column order their 32 reads would share 8
// banks, grouped they take 32. With Q = 8 mod 32 the 32 consecutive columns
// that a warp takes in the per-pixel pass fall on 32 banks as well.
__device__ __forceinline__ int seg_index(int q, int Q) {
  return (q & 3) * Q + (q >> 2);
}

__host__ __device__ __forceinline__ int seg_quarter(int seg) {
  const int Q = (seg + 3) >> 2;
  return Q + (40 - Q % 32) % 32;
}

// Shared memory (4-byte words) of one band block: the accumulator
// (C, rows, cols), the row's segment (C, 4 Q), the upper tap weight of each
// segment column (4 Q) and the feeding ranges of each owned column (3, cols).
// At the slice's shapes three blocks take 3 x 62.1 KB, within the SM's
// 196 KB carve-out, which leaves 60 KB of L1 for the low-res rows.
__host__ __device__ __forceinline__ int band_smem_words(int C, int rows,
                                                        int cols, int seg) {
  return C * rows * cols + (C + 1) * 4 * seg_quarter(seg) + 3 * cols;
}

// The factor of d loss / d logits for one pixel: g, or for focal loss g
// times d focal / d ce at ce = m + log(s) - picked.
__device__ __forceinline__ float pixel_coef(float g, float m, float s,
                                            float picked, int focal,
                                            float alpha, float gamma) {
  if (!focal) return g;
  const float ce = m + logf(s) - picked;
  const float e = expf(-ce);
  const float ome = 1.0f - e;
  return g * (alpha * (powf(ome, gamma) +
                       ce * gamma * powf(ome, gamma - 1.0f) * e));
}

// One labelled pixel of the segment: its C logits (W first, then H, as
// torch's upsample), then g * (softmax - onehot) (times the focal factor)
// into z[k * stride], one exp per logit. With the class count kC known at
// compile time the logits stay in registers; otherwise (kC = 0) they pass
// through z.
template <int kC, typename T>
__device__ __forceinline__ void pixel_cotangent(
    const T* __restrict__ lo_b, int C, size_t plane, int w,
    const Tap& ty, const Tap& tx, int lab, float g, int focal, float alpha,
    float gamma, float* z, int stride) {
  float m = -INFINITY, s = 0.0f, picked = 0.0f;
  if constexpr (kC > 0) {
    float e[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      e[k] = logit(lo_b + k * plane, w, ty, tx);
      m = fmaxf(m, e[k]);
    }
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      if (k == lab) picked = e[k];
      e[k] = expf(e[k] - m);
      s += e[k];
    }
    const float coef = pixel_coef(g, m, s, picked, focal, alpha, gamma);
    const float inv = 1.0f / s;
#pragma unroll
    for (int k = 0; k < kC; ++k)
      z[k * stride] = coef * (e[k] * inv - (k == lab ? 1.0f : 0.0f));
  } else {
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      const float zk = logit(lo_b + k * plane, w, ty, tx);
      z[k * stride] = zk;
      m = fmaxf(m, zk);
    }
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      const float zk = z[k * stride];
      if (k == lab) picked = zk;
      const float ek = expf(zk - m);
      z[k * stride] = ek;
      s += ek;
    }
    const float coef = pixel_coef(g, m, s, picked, focal, alpha, gamma);
    const float inv = 1.0f / s;
#pragma unroll 4
    for (int k = 0; k < C; ++k)
      z[k * stride] = coef * (z[k * stride] * inv - (k == lab ? 1.0f : 0.0f));
  }
}

template <int kC, typename T>
__global__ void __launch_bounds__(kThreads, kBandMinBlocks)
resize_ce_bwd_bands(const T* __restrict__ lo,
                    const int32_t* __restrict__ labels,
                    const float* __restrict__ gout,
                    const int32_t* __restrict__ plan, int C, int h, int w,
                    int H, int W, int hg, int y0, int Y0, float sy,
                    float sx, int rows_max,
                    int cols_max, int seg_max, int focal, float alpha,
                    float gamma, T* __restrict__ dlo) {
  const int32_t* p = plan + (size_t)blockIdx.x * kPlanCols;
  const int ya = p[0], yb = p[1], i_lo = p[2], i_hi = p[3];
  const int xa = p[4], xb = p[5], j_lo = p[6], j_hi = p[7];
  const int nx = xb - xa, nj = j_hi - j_lo;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Q = seg_quarter(seg_max), S = 4 * Q;
  extern __shared__ float smem[];
  float* acc = smem;                          // (C, rows_max, cols_max)
  float* seg = acc + C * rows_max * cols_max; // (C, S): the row's segment
  float* tl1 = seg + C * S;                   // upper tap weight; l0 = 1 - l1
  int* feed = reinterpret_cast<int*>(tl1 + S); // (3, cols_max)
  const size_t plane = (size_t)h * w;
  const T* lo_b = lo + (size_t)b * C * plane;
  const float g = gout[b];
  const int groups = (C + 3) >> 2;

  for (int k = tid; k < C * rows_max * cols_max; k += nt) acc[k] = 0.0f;
  for (int q = tid; q < nj; q += nt)
    tl1[seg_index(q, Q)] = source_tap(j_lo + q, sx, w).l1;
  // The lower tap is nondecreasing in j. Owned column x takes the upper
  // weight of the segment columns [feed0, feed1) (lower tap x - 1) and the
  // lower weight of [feed1, feed2) (lower tap x); feed_k is the first column
  // whose lower tap is at least x - 1 + k.
  for (int xx = tid; xx < nx; xx += nt) {
    for (int k = 0; k < 3; ++k) {
      int a = 0, e = nj;
      while (a < e) {
        const int mid = (a + e) >> 1;
        if (source_tap(j_lo + mid, sx, w).i0 < xa + xx - 1 + k) a = mid + 1;
        else e = mid;
      }
      feed[k * cols_max + xx] = a;
    }
  }

  const int32_t* lab_b = labels + (size_t)b * H * W + j_lo;
  for (int i = i_lo; i < i_hi; ++i) {
    const Tap ty = row_tap(i, sy, hg, y0, Y0);
    // the row's H weights on the band's rows (the same in every thread)
    const float wy0 = ty.i0 >= ya && ty.i0 < yb ? tap_weight(ty, ty.i0) : 0.0f;
    const float wy1 =
        ty.i1 != ty.i0 && ty.i1 >= ya && ty.i1 < yb ? ty.l1 : 0.0f;
    if (wy0 == 0.0f && wy1 == 0.0f) continue;
    __syncthreads();              // the previous row's contraction is done

    // (1) per pixel of the segment, in place: g * (softmax - onehot), times
    // the focal factor; zero where the label is ignored
    const int32_t* lab_row = lab_b + (size_t)i * W;
    for (int q = tid; q < nj; q += nt) {
      float* z = seg + seg_index(q, Q);
      const int lab = lab_row[q];
      if (lab == kIgnore) {
        for (int k = 0; k < C; ++k) z[k * S] = 0.0f;
      } else {
        pixel_cotangent<kC>(lo_b, C, plane, w, ty,
                            source_tap(j_lo + q, sx, w), lab, g, focal,
                            alpha, gamma, z, S);
      }
    }
    __syncthreads();

    // (2) W contraction of each owned column in segment order, four
    // classes at a time so that each tap weight is read once for four; H
    // into the band's rows
    int cg = tid / nx, xx = tid - cg * nx;
    for (; cg < groups; advance(cg, xx, nx, nt)) {
      const int c0 = 4 * cg, nc = min(4, C - c0);
      const float* srow = seg + c0 * S;
      const int f0 = feed[xx], f1 = feed[cols_max + xx];
      const int f2 = feed[2 * cols_max + xx];
      const bool last = xa + xx == w - 1;   // both taps on the last column
      float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int q = f0; q < f2; ++q) {
        const int at = seg_index(q, Q);
        const float l1 = tl1[at];
        const float wx = q < f1 ? l1 : last ? (1.0f - l1) + l1 : 1.0f - l1;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < nc) r[u] += wx * srow[u * S + at];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u >= nc) break;
        float* a = acc + (c0 + u) * rows_max * cols_max + xx;
        if (wy0 != 0.0f) a[(ty.i0 - ya) * cols_max] += wy0 * r[u];
        if (wy1 != 0.0f) a[(ty.i1 - ya) * cols_max] += wy1 * r[u];
      }
    }
  }
  __syncthreads();
  const int ny = yb - ya;
  for (int k = tid; k < C * ny * nx; k += nt) {
    const int c = k / (ny * nx), rem = k - c * ny * nx;
    const int yy = rem / nx, xx = rem - yy * nx;
    store(dlo + (((size_t)b * C + c) * h + ya + yy) * w + xa + xx,
          acc[(c * rows_max + yy) * cols_max + xx]);
  }
}

// The forward and band kernels for C classes and the logits' dtype: the two
// class counts of the trainers' datasets (19 Cityscapes, 21 VOC) keep each
// pixel's logits in registers.
template <typename T>
const void* fwd_kernel_t(int C) {
  if (C == 19) return (const void*)resize_ce_fwd<19, T>;
  if (C == 21) return (const void*)resize_ce_fwd<21, T>;
  return (const void*)resize_ce_fwd<0, T>;
}

template <typename T>
const void* band_kernel_t(int C) {
  if (C == 19) return (const void*)resize_ce_bwd_bands<19, T>;
  if (C == 21) return (const void*)resize_ce_bwd_bands<21, T>;
  return (const void*)resize_ce_bwd_bands<0, T>;
}

const void* fwd_kernel(int C, int bf16) {
  return bf16 ? fwd_kernel_t<__nv_bfloat16>(C) : fwd_kernel_t<float>(C);
}

const void* band_kernel(int C, int bf16) {
  return bf16 ? band_kernel_t<__nv_bfloat16>(C) : band_kernel_t<float>(C);
}

// Above the default 48 KB a kernel's dynamic shared memory needs an opt-in.
cudaError_t allow_smem(const void* fn, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of the band backward needs, for at most
// `rows` owned rows, `cols` owned columns and `seg` visited output columns.
int afan_resize_ce_bwd_bands_smem(int C, int rows, int cols, int seg) {
  return band_smem_words(C, rows, cols, seg) * 4;
}

// Shared memory (bytes) one block of the forward needs: its rows' buffer.
int afan_resize_ce_fwd_smem(int C, int w) {
  return (int)((size_t)kFwdRows * fwd_stride(C) * w * sizeof(float));
}

// lo (B, C, h, w) f32 (bf16 = 0) or bf16 (bf16 = 1) and labels (B, H, W)
// int32, both contiguous; partial scratch of B * H floats; out (B,) f32.
// lo holds the rows [y0, y0 + h) of a map of hg rows and the labels the
// output rows [Y0, Y0 + H) of its resize to Hg rows (the whole map: hg = h,
// Hg = H, y0 = Y0 = 0). Launches on `stream` and returns the launches'
// error.
int afan_resize_ce_forward(const void* lo, const int32_t* labels, int bf16,
                           int B, int C, int h, int w, int H, int W, int hg,
                           int Hg, int y0, int Y0, int focal, float alpha,
                           float gamma, float* partial, float* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = fwd_kernel(C, bf16);
  const int smem = afan_resize_ce_fwd_smem(C, w);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float sy = (float)hg / (float)Hg, sx = (float)w / (float)W;
  void* args[] = {&lo, &labels, &C, &h, &w, &H, &W, &hg, &y0, &Y0, &sy, &sx,
                  &focal, &alpha, &gamma, &partial};
  err = cudaLaunchKernel(fn, dim3((H + kFwdRows - 1) / kFwdRows, B), kThreads,
                         args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_rows<<<B, kThreads, 0, s>>>(partial, H, out);
  return static_cast<int>(cudaGetLastError());
}

// gout (B,) f32 is the cotangent of the forward's sums; dlo (B, C, h, w), in
// lo's dtype (f32 or bf16, as `bf16` says), receives
// d(sum_b gout[b] * sums[b]) / d lo. `plan` holds n_plan rows of 8
// int32 (y_a, y_b, i_lo, i_hi, x_a, x_b, j_lo, j_hi), one block each, whose
// owned ranges tile [0, h) x [0, w); rows, cols and seg are the largest
// y_b - y_a, x_b - x_a and j_hi - j_lo among them. The row window (hg, Hg,
// y0, Y0) is the forward's, and the plan's rows are the window's. Every
// element of dlo is written.
int afan_resize_ce_backward(const void* lo, const int32_t* labels,
                            const float* gout, const int32_t* plan,
                            int n_plan, int bf16, int B, int C, int h, int w,
                            int H, int W, int hg, int Hg, int y0, int Y0,
                            int rows, int cols, int seg, int focal,
                            float alpha, float gamma, void* dlo,
                            void* stream) {
  const void* fn = band_kernel(C, bf16);
  const int smem = afan_resize_ce_bwd_bands_smem(C, rows, cols, seg);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float sy = (float)hg / (float)Hg, sx = (float)w / (float)W;
  void* args[] = {&lo, &labels, &gout, &plan, &C, &h, &w, &H, &W, &hg, &y0,
                  &Y0, &sy, &sx, &rows, &cols, &seg, &focal, &alpha, &gamma,
                  &dlo};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(n_plan, B), kThreads,
                                           args, smem,
                                           static_cast<cudaStream_t>(stream)));
}

// What the card made of a kernel (kind 0: the forward, 1: the band
// backward) for C classes and f32 (bf16 = 0) or bf16 logits at `smem` bytes
// of dynamic shared memory: out[0] registers per thread, out[1] local
// memory (spill) bytes per thread, out[2] static shared bytes, out[3]
// resident blocks per SM.
int afan_resize_ce_kernel_info(int kind, int C, int bf16, int smem,
                               int* out) {
  const void* fn = kind == 0 ? fwd_kernel(C, bf16) : band_kernel(C, bf16);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = blocks;
  return 0;
}

}  // extern "C"
