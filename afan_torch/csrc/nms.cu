// Exact greedy NMS over score-sorted boxes, batched over groups, for sm_90a.
//
// Replaces the Pallas TPU kernel `afan/ops/kernels/nms_kernel.py:_nms_kernel`
// (launched by `nms_sorted_mask_pallas`). It computes the same function: the
// greedy keep mask of G groups of N score-sorted xyxy boxes with a validity
// mask, where box j is suppressed by an earlier kept box i when
// iou(i, j) >= threshold.
//
// What bounds it on this card: not the IoU arithmetic (N^2/2 pairs of ~16
// float operations is microseconds of the card's f32 rate) but the bytes of
// the suppression bitmask, written by pass 1 and read back by pass 2
// (G * N * ceil(N/64) * 8 bytes, about 4.5 MB per image at N = 6000), and the
// length of the sequential scan in pass 2 (N steps, one block per group).
//
// Design. The TPU kernel resolved tiles by convergence rounds on a grid that
// runs in order; blocks here run in no order, so the work splits in two:
//   pass 1 (nms_mask_kernel): grid (column block, row block, group), 64
//     threads. A block stages 64 column boxes and their areas in shared
//     memory; thread t takes row box i = 64 * row_block + t and sets bit k of
//     one 64-bit word when column j = 64 * col_block + k is later than i and
//     iou(i, j) >= threshold. Blocks below the diagonal exit, so only the
//     upper triangle of the mask is computed and written.
//   pass 2 (nms_scan_kernel): one block per group walks i = 0..N-1 over a
//     "removed" bit array in shared memory that starts as ~valid (invalid
//     slots start suppressed and so never suppress anything). When bit i is
//     clear, box i is kept and the threads OR row i's words (from word i/64
//     on) into the array. No host-side scan and no host sync.
//
// Arithmetic is bitwise that of `pairwise_iou` (afan_torch/ops/nms.py):
// area = (x2-x1+off)*(y2-y1+off); inter = max(min(x2)-max(x1)+off, 0) *
// max(min(y2)-max(y1)+off, 0); iou = inter / max((area_a+area_b)-inter,
// 1e-12) with an IEEE division, compared >= a float threshold. The build
// passes -fmad=false so that no multiply-add is contracted into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // boxes per mask word

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2, float off) {
  return (x2 - x1 + off) * (y2 - y1 + off);
}

__device__ __forceinline__ bool over(const float* a, float area_a,
                                     const float* b, float area_b, float thr,
                                     float off) {
  const float w = fmaxf(fminf(a[2], b[2]) - fmaxf(a[0], b[0]) + off, 0.0f);
  const float h = fmaxf(fminf(a[3], b[3]) - fmaxf(a[1], b[1]) + off, 0.0f);
  const float inter = w * h;
  const float uni = (area_a + area_b) - inter;
  return inter / fmaxf(uni, 1e-12f) >= thr;
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int words, float thr, float off,
                                unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  if (row_block > col_block) return;
  const int g = blockIdx.z;
  const float* gb = boxes + (size_t)g * n * 4;
  const int row_size = min(n - row_block * kTile, kTile);
  const int col_size = min(n - col_block * kTile, kTile);

  __shared__ float cols[kTile * 4];
  __shared__ float col_area[kTile];
  const int t = threadIdx.x;
  if (t < col_size) {
    const float* src = gb + (size_t)(col_block * kTile + t) * 4;
    cols[t * 4 + 0] = src[0];
    cols[t * 4 + 1] = src[1];
    cols[t * 4 + 2] = src[2];
    cols[t * 4 + 3] = src[3];
    col_area[t] = box_area(src[0], src[1], src[2], src[3], off);
  }
  __syncthreads();
  if (t >= row_size) return;

  const int i = row_block * kTile + t;
  const float row[4] = {gb[(size_t)i * 4 + 0], gb[(size_t)i * 4 + 1],
                        gb[(size_t)i * 4 + 2], gb[(size_t)i * 4 + 3]};
  const float row_area = box_area(row[0], row[1], row[2], row[3], off);
  unsigned long long bits = 0ULL;
  const int start = (row_block == col_block) ? t + 1 : 0;
  for (int k = start; k < col_size; ++k) {
    if (over(row, row_area, cols + k * 4, col_area[k], thr, off)) {
      bits |= 1ULL << k;
    }
  }
  mask[((size_t)g * n + i) * words + col_block] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid, int n,
                                int words, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int g = blockIdx.x;
  const uint8_t* gv = valid + (size_t)g * n;
  uint8_t* gk = keep + (size_t)g * n;
  const unsigned long long* gm = mask + (size_t)g * n * words;

  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    unsigned long long r = 0ULL;
    for (int k = 0; k < kTile; ++k) {
      const int j = w * kTile + k;
      if (j >= n || !gv[j]) r |= 1ULL << k;
    }
    removed[w] = r;
  }
  __syncthreads();

  for (int w = 0; w < words; ++w) {
    unsigned long long cur = removed[w];
    const int base = w * kTile;
    const int lim = min(n - base, kTile);
    for (int k = 0; k < lim; ++k) {
      const int i = base + k;
      // cur is the same in every thread, so every thread takes the same
      // branch and reaches the same barriers.
      const bool kept = !((cur >> k) & 1ULL);
      if (threadIdx.x == 0) gk[i] = kept ? 1 : 0;
      if (kept) {
        const unsigned long long* row = gm + (size_t)i * words;
        for (int j = w + threadIdx.x; j < words; j += blockDim.x) {
          removed[j] |= row[j];
        }
        __syncthreads();
        cur = removed[w];
        __syncthreads();
      }
    }
  }
}

}  // namespace

extern "C" {

// Words of mask one group needs per box: ceil(n / 64).
int afan_nms_words(int n) { return (n + kTile - 1) / kTile; }

// boxes (g, n, 4) f32 contiguous, valid (g, n) bool as bytes, mask scratch of
// g * n * afan_nms_words(n) u64 words, keep (g, n) bool as bytes. Launches on
// `stream` and returns cudaGetLastError().
int afan_nms_sorted_mask(const float* boxes, const uint8_t* valid, int g,
                         int n, float threshold, float off,
                         unsigned long long* mask, uint8_t* keep,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = afan_nms_words(n);
  dim3 grid1(words, words, g);
  nms_mask_kernel<<<grid1, kTile, 0, s>>>(boxes, n, words, threshold, off,
                                          mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)words * sizeof(unsigned long long);
  nms_scan_kernel<<<g, 32, smem, s>>>(mask, valid, n, words, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
