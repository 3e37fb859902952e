// Exact greedy NMS over score-sorted boxes, batched over groups, for sm_90a.
//
// Replaces the Pallas TPU kernel `afan/ops/kernels/nms_kernel.py:_nms_kernel`
// (launched by `nms_sorted_mask_pallas`). It computes the same function: the
// greedy keep mask of G groups of N score-sorted xyxy boxes with a validity
// mask, where box j is suppressed by an earlier kept box i when
// iou(i, j) >= threshold.
//
// What bounds it on this card: neither bytes nor arithmetic. The IoU tests
// are N^2/2 pairs per group, spread over the whole card (pass 1); what sets
// the time is the greedy recurrence, a chain that only one SM per group can
// walk (pass 2). The chain has one step per 64-box word (94 at N = 6000, 188
// at N = 12000), and a step costs the latency of shared memory, of the
// resolve (one trip per kept box) and of whatever the step has to wait for.
// So the design keeps global loads and the other warps off the chain.
//
//   pass 1 (nms_mask_kernel): grid (column block, row block, group), 64
//     threads. A block stages 64 column boxes and their areas in shared
//     memory; thread t takes row box i = 64 * row_block + t and tests all
//     64 columns in an unrolled loop, then keeps bit k of its 64-bit word
//     when column j = 64 * col_block + k is later than i (and below n) and
//     iou(i, j) >= threshold. Blocks below the diagonal exit, so only the
//     upper triangle of the mask is computed and written. A pair whose
//     intersection is 0 skips the division, which cannot change its result.
//   pass 2 (nms_scan_kernel): one block of 512 threads per group walks the
//     mask one word per step over a "removed" bit array in shared memory
//     that starts as ~valid (invalid slots start suppressed and so never
//     suppress anything). The warps are specialised:
//     - warp 0 is the chain. For word w it reads removed[w], ORs in what
//       words w - 1 and w - 2 removed there, and resolves the 64 boxes from
//       the word's diagonal words (row i's bits of the boxes after i in its
//       own word), held in its registers and read with shuffles: it takes
//       the kPick lowest boxes not removed, keeps each that an earlier kept
//       one does not remove, ORs the kept ones' diagonal words in, and
//       repeats: a trip per kPick kept boxes, none per suppressed one. It
//       publishes the kept bits, writes the word's keep bytes, and ORs the
//       kept rows' words of columns w + 1 and w + 2 into registers. Those
//       operands do not depend on what is kept, so they are loaded kAhead
//       words ahead and their L2 latency stays off the chain;
//     - warps 1-15 OR the kept rows' words of columns w + 3 onwards into
//       removed[]: each warp takes 32 neighbouring columns (coalesced) and a
//       share of the kept rows, with kLoads loads in flight per thread.
//     The two sides meet through flags in shared memory, not barriers: warp
//     0 starts word w once every OR warp is done with word w - 3, and the OR
//     warps start word w once warp 0 has published it. So warp 0 never waits
//     for the OR of the word it just resolved, as it would at a barrier per
//     word, and no step has a __syncthreads.
//
// Arithmetic is bitwise that of `pairwise_iou` (afan_torch/ops/nms.py):
// area = (x2-x1+off)*(y2-y1+off); inter = max(min(x2)-max(x1)+off, 0) *
// max(min(y2)-max(y1)+off, 0); iou = inter / max((area_a+area_b)-inter,
// 1e-12) with an IEEE division, compared >= a float threshold; every max
// and min passes a NaN on, as torch's do, so a pair with a NaN coordinate
// never suppresses. The build passes -fmad=false so that no multiply-add is
// contracted into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;          // boxes per mask word
constexpr int kScanThreads = 512;  // warp 0 resolves, warps 1-15 OR
constexpr int kLoads = 16;         // mask loads in flight per OR thread
constexpr int kAhead = 4;          // words whose operands warp 0 holds
constexpr int kPick = 4;           // candidates warp 0 decides per trip
constexpr int kRing = 4;           // published kept words in flight

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2, float off) {
  return (x2 - x1 + off) * (y2 - y1 + off);
}

// torch.maximum / torch.minimum and clamp_min: a NaN operand gives NaN, as
// in `pairwise_iou` and afan's jnp.maximum / jnp.minimum. fmaxf and fminf
// drop a NaN, so a box with a NaN coordinate would get a finite overlap.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// Bits lo..hi-1 of a word.
__device__ __forceinline__ u64 bit_range(int lo, int hi) {
  return (hi == kTile ? 0ULL : (1ULL << hi)) - (1ULL << lo);
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int words, float thr, float off,
                                u64* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  if (row_block > col_block) return;
  const int g = blockIdx.z;
  const float* gb = boxes + (size_t)g * n * 4;
  const int row_size = min(n - row_block * kTile, kTile);
  const int col_size = min(n - col_block * kTile, kTile);

  __shared__ float4 cols[kTile];
  __shared__ float col_area[kTile];
  const int t = threadIdx.x;
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (t < col_size) {
    const float* src = gb + (size_t)(col_block * kTile + t) * 4;
    c = make_float4(src[0], src[1], src[2], src[3]);
  }
  cols[t] = c;
  col_area[t] = box_area(c.x, c.y, c.z, c.w, off);
  __syncthreads();
  if (t >= row_size) return;

  const int i = row_block * kTile + t;
  const float* src = gb + (size_t)i * 4;
  const float4 r = make_float4(src[0], src[1], src[2], src[3]);
  const float row_area = box_area(r.x, r.y, r.z, r.w, off);
  const bool disjoint_over = 0.0f >= thr;
  u64 bits = 0ULL;
  // Every column is tested; the bits of columns past n and, on the
  // diagonal, of columns up to i are dropped below.
#pragma unroll 16
  for (int k = 0; k < kTile; ++k) {
    const float4 b = cols[k];
    const float w =
        max_nan(min_nan(r.z, b.z) - max_nan(r.x, b.x) + off, 0.0f);
    const float h =
        max_nan(min_nan(r.w, b.w) - max_nan(r.y, b.y) + off, 0.0f);
    const float inter = w * h;
    const float uni = (row_area + col_area[k]) - inter;
    // 0 / max_nan(uni, 1e-12) is 0 unless uni is NaN, so skipping the
    // division changes no result; a NaN inter still divides, and a NaN
    // IoU is never >= thr.
    bool o = disjoint_over && uni == uni;
    if (inter != 0.0f) {
      o = inter / max_nan(uni, 1e-12f) >= thr;
    }
    bits |= static_cast<u64>(o) << k;
  }
  u64 later = bit_range(0, col_size);
  if (row_block == col_block) later &= ~bit_range(0, t + 1);
  mask[((size_t)g * n + i) * words + col_block] = bits & later;
}

// An OR warp's share of word w: OR the words j >= first of the rows in
// `kept` (rows = row 64w of the group's mask) into removed[j]. A warp takes
// 32 neighbouring words; when the words need fewer warps than there are,
// the warps of one chunk split the 64 rows between them. The OR is atomic,
// since warp 0 may read removed[] meanwhile and chunks may share a word.
__device__ __forceinline__ void or_kept_rows(const u64* __restrict__ rows,
                                             int words, u64 kept, int first,
                                             u64* removed, int lane, int cw,
                                             int ncw) {
  const int chunks = (words - first + 31) / 32;
  const int slices = max(1, ncw / chunks);
  for (int item = cw; item < chunks * slices; item += ncw) {
    const int slice = item / chunks;
    const int j = first + (item % chunks) * 32 + lane;
    u64 todo = kept & bit_range(slice * kTile / slices,
                                (slice + 1) * kTile / slices);
    u64 acc = 0ULL;
    while (todo) {
      u64 v[kLoads];  // independent loads, issued back to back
#pragma unroll
      for (int b = 0; b < kLoads; ++b) {
        const int k = __ffsll(static_cast<long long>(todo)) - 1;
        todo &= todo - 1;
        v[b] = (k >= 0 && j < words) ? rows[(size_t)k * words + j] : 0ULL;
      }
#pragma unroll
      for (int b = 0; b < kLoads; ++b) acc |= v[b];
    }
    if (acc) {
      unsigned* half = reinterpret_cast<unsigned*>(removed + j);
      atomicOr(half, static_cast<unsigned>(acc));
      atomicOr(half + 1, static_cast<unsigned>(acc >> 32));
    }
  }
}

// The OR over warp 0's lanes of the words that lane l holds for rows l and
// l + 32 of a word, taken for the rows whose bit is set in `kept`.
__device__ __forceinline__ u64 or_rows(u64 kept, int lane, u64 lo, u64 hi) {
  const u64 x = (((kept >> lane) & 1ULL) ? lo : 0ULL) |
                (((kept >> (lane + 32)) & 1ULL) ? hi : 0ULL);
  return static_cast<u64>(__reduce_or_sync(~0u, static_cast<unsigned>(x))) |
         (static_cast<u64>(__reduce_or_sync(
              ~0u, static_cast<unsigned>(x >> 32))) << 32);
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ mask,
                const uint8_t* __restrict__ valid, int n, int words,
                uint8_t* __restrict__ keep) {
  extern __shared__ u64 smem[];
  u64* removed = smem;                            // [words]
  volatile u64* ring = smem + words;              // [kRing]: word w's kept
  int* flags = reinterpret_cast<int*>(smem + words + kRing);
  volatile int* published = flags;     // words warp 0 has resolved
  volatile int* progress = flags + 1;  // [ncw]: words each OR warp is done with
  const int g = blockIdx.x;
  const uint8_t* gv = valid + (size_t)g * n;
  uint8_t* gk = keep + (size_t)g * n;
  const u64* gm = mask + (size_t)g * n * words;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ncw = (blockDim.x >> 5) - 1;  // OR warps

  for (int w = warp; w < words; w += ncw + 1) {
    const int j = w * kTile + lane;
    const unsigned lo = __ballot_sync(~0u, j >= n || !gv[j]);
    const unsigned hi = __ballot_sync(~0u, j + 32 >= n || !gv[j + 32]);
    if (lane == 0) removed[w] = (static_cast<u64>(hi) << 32) | lo;
  }
  if (threadIdx.x <= ncw) flags[threadIdx.x] = 0;
  __syncthreads();

  if (warp != 0) {
    const int cw = warp - 1;
    for (int w = 0; w < words; ++w) {
      while (*published <= w) __nanosleep(20);
      __syncwarp();
      __threadfence_block();
      const u64 kept = ring[w % kRing];
      if (kept != 0ULL && w + 3 < words) {
        or_kept_rows(gm + (size_t)w * kTile * words, words, kept, w + 3,
                     removed, lane, cw, ncw);
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) progress[cw] = w + 1;
    }
    return;
  }

  // Warp 0. Lane l holds rows l and l + 32 of each of the kAhead words from
  // w on (slot s for word w with w % kAhead == s): their words of column w
  // (diag), w + 1 (next) and w + 2 (after).
  auto row_word = [&](int r, int c) -> u64 {  // 0 past the ends
    return (r < n && c < words) ? gm[(size_t)r * words + c] : 0ULL;
  };
  u64 diag_lo[kAhead], diag_hi[kAhead], next_lo[kAhead], next_hi[kAhead],
      after_lo[kAhead], after_hi[kAhead];
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    const int r = s * kTile + lane;
    diag_lo[s] = row_word(r, s);
    diag_hi[s] = row_word(r + 32, s);
    next_lo[s] = row_word(r, s + 1);
    next_hi[s] = row_word(r + 32, s + 1);
    after_lo[s] = row_word(r, s + 2);
    after_hi[s] = row_word(r + 32, s + 2);
  }
  u64 pending = 0ULL;  // word w's boxes removed by words w - 1 and w - 2
  u64 pending2 = 0ULL;  // word w + 1's boxes removed by word w - 1
  int seen = 0;         // words every OR warp is done with
  for (int w0 = 0; w0 < words; w0 += kAhead) {
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const int w = w0 + s;
      if (w >= words) break;
      const int base = w * kTile;
      // removed[w] holds the ORs of words up to w - 3 once every OR warp is
      // done with word w - 3.
      while (seen < w - 2) {
        seen = __reduce_min_sync(~0u, lane < ncw ? progress[lane] : words);
      }
      __threadfence_block();
      const u64 lim_mask = bit_range(0, min(n - base, kTile));
      u64 cur = removed[w] | pending;
      u64 kept = 0ULL;
      u64 avail = ~cur & lim_mask;
      while (avail) {
        // The kPick lowest boxes not removed, decided in order: each is
        // kept unless a kept box before it removes it (diagonal words only
        // hold later boxes). Every box up to the last of them is then
        // decided.
        int k[kPick];
        u64 d[kPick];
        u64 rest = avail;
#pragma unroll
        for (int i = 0; i < kPick; ++i) {
          k[i] = __ffsll(static_cast<long long>(rest)) - 1;  // -1: none
          rest &= rest - 1ULL;
        }
#pragma unroll
        for (int i = 0; i < kPick; ++i) {
          d[i] = __shfl_sync(~0u, k[i] < 32 ? diag_lo[s] : diag_hi[s],
                             k[i] & 31);
        }
        int last = k[0];
#pragma unroll
        for (int i = 0; i < kPick; ++i) {
          if (k[i] >= 0) {
            last = k[i];
            if (!((cur >> k[i]) & 1ULL)) {
              kept |= 1ULL << k[i];
              cur |= d[i];
            }
          }
        }
        avail = ~cur & lim_mask & ~((2ULL << last) - 1ULL);
      }
      if (lane == 0) {
        ring[w % kRing] = kept;
        __threadfence_block();
        *published = w + 1;
      }
      if (base + lane < n) {
        gk[base + lane] = static_cast<uint8_t>((kept >> lane) & 1ULL);
      }
      if (base + 32 + lane < n) {
        gk[base + 32 + lane] =
            static_cast<uint8_t>((kept >> (lane + 32)) & 1ULL);
      }
      u64 next = 0ULL, after = 0ULL;
      if (kept) {
        next = or_rows(kept, lane, next_lo[s], next_hi[s]);
        after = or_rows(kept, lane, after_lo[s], after_hi[s]);
      }
      pending = pending2 | next;
      pending2 = after;
      // word w + kAhead's operands; they do not depend on what is kept
      const int r = base + kAhead * kTile + lane;
      diag_lo[s] = row_word(r, w + kAhead);
      diag_hi[s] = row_word(r + 32, w + kAhead);
      next_lo[s] = row_word(r, w + kAhead + 1);
      next_hi[s] = row_word(r + 32, w + kAhead + 1);
      after_lo[s] = row_word(r, w + kAhead + 2);
      after_hi[s] = row_word(r + 32, w + kAhead + 2);
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
  const size_t smem = (size_t)(words + kRing) * sizeof(u64) +
                      (kScanThreads / 32) * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<g, kScanThreads, smem, s>>>(mask, valid, n, words, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
