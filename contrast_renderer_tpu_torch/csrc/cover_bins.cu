// cover_bins: the cover stage of binning (ops/coverage.py, make_prepare's
// "covers") in one launch: each cover draw's hull clipped at the near plane
// and turned into inward pixel lines, then each (tile, cover) pair's class
// and crossing bitmask.
//
// Replaces no TPU kernel.  Its counterpart in the JAX package is a section
// of XLA operations in make_prepare (contrast_renderer_tpu/ops/coverage.py,
// the cover draws from line 972), which the port first wrote as torch
// operations (ops/coverage.py, cover_bins_plain, still the CPU path and the
// tests' oracle).  There each of the H2 = h_max + 2 hull lines took some 25
// elementwise operations over (covers, tile rows, tile columns): about 560
// nodes of a frame's CUDA graph at ~1.2 us each, which paced two cells of
// the port's benchmark.
//
// What bounds it: launch latency, and one pass of int32 writes over
// (tiles x covers) with H2 line tests each.  At one cover, 510 tiles and
// H2 = 18 that is some 10^4 multiply-adds and 4 KB written: well under
// 10 us.
//
// Design.  A grid of (cover chunk, tile chunk) blocks, sized from the shape
// alone: up to 32 covers and 256 tiles a block, and at most 2,048 (tile,
// cover) pairs.  A
// block first computes its covers' lines into shared memory, one warp a
// cover and one lane a hull vertex: the transform, the Sutherland-Hodgman
// clip against w > eps with the kept and intersection vertices compacted in
// order by two ballots, the projection, the lines.  Recomputing them in
// every tile chunk costs less than a second launch would.  The blocks of
// the first tile chunk write hull_lines.  Then each thread takes (tile,
// cover) pairs, the cover fastest, so that neighbouring lanes write
// neighbouring words of cls and hbits, in their (n_tiles, covers) layout.
//
// Exactness: every output equals cover_bins_plain's on the card to the bit.
// The library builds with --fmad=false, every expression keeps the plain
// version's operation order, division is IEEE (torch.reciprocal behind
// 1.0 / w), min and max propagate NaN as torch.amin and torch.clamp do, and
// the one reduction, the hull's area over H2 terms, whose sign alone is
// used, is summed in the order of torch's CUDA sum over a contiguous last
// dimension of fewer than 128 elements (ATen/native/cuda/Reduce.cuh of
// PyTorch 2.11): P = the largest power of two <= H2 threads, thread j
// adding term j + P to term j, then a shuffle tree with offsets P/2, P/4,
// ..., 1.  Templated on float and double: prepare_in_float64 runs binning
// in double on the card.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// One int32 word of hull bits a pair.
constexpr int kMaxLines = 31;
constexpr int kCoverChunk = 32;
constexpr int kPairsPerBlock = 2048;

template <typename T>
struct Shared {
  T a[kCoverChunk][kMaxLines];
  T b[kCoverChunk][kMaxLines];
  T c[kCoverChunk][kMaxLines];
  T box[kCoverChunk][4];  // min x, max x, min y, max y
  int valid[kCoverChunk];
  T slot[kWarps][kMaxLines + 1][4];  // a warp's clipped vertices
};

struct Args {
  const long long* c_shape;
  const long long* c_row;
  int* cls;
  int* hbits;
  int n_covers, h_max, n_tiles, ntx, tile_w, tile_h;
  int covers_per_block, tiles_per_block;
  double half_w, half_h;
  float eps;
};

// torch.amin / amax: NaN wins.
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a > b || a != a) ? a : b;
}
// torch.abs, compared only: -0 may stay -0.
template <typename T>
__device__ __forceinline__ T abs_of(T x) {
  return x < T(0) ? -x : x;
}
// torch.clamp(x, max=0) / clamp(x, min=0): NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_max0(T x) {
  return (x < T(0) || x != x) ? x : T(0);
}
template <typename T>
__device__ __forceinline__ T clamp_min0(T x) {
  return (x > T(0) || x != x) ? x : T(0);
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int off = 16; off > 0; off >>= 1) v = min_nan(v, __shfl_xor_sync(kFull, v, off));
  return v;
}
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Cover r's hull lines into slot i of the block's shared memory (and into
// hull_lines where it is given), by the calling warp, one lane a vertex.
template <typename T>
__device__ void hull_setup(const Args& p, const T* __restrict__ hull,
                           const T* __restrict__ transforms, int r, int i,
                           Shared<T>& s, T* __restrict__ hull_lines) {
  const int lane = threadIdx.x & 31;
  const int hm = p.h_max, h2 = hm + 2;
  const T eps = static_cast<T>(p.eps);
  const T* m = transforms + p.c_row[r] * 16;
  const T* pt = hull + p.c_shape[r] * hm * 2;

  // _transform_points: ((x·m0 + y·m1) + 0·m2) + 1·m3 for each clip row.
  T v[4] = {T(0), T(0), T(0), T(0)};
  const bool live = lane < hm;
  if (live) {
    const T x = pt[2 * lane], y = pt[2 * lane + 1];
    const T zero = T(0), one = T(1);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = x * m[4 * k] + y * m[4 * k + 1] + zero * m[4 * k + 2] +
             one * m[4 * k + 3];
  }
  // The clip of edge lane -> lane + 1 (cyclic over hm).
  const int next = lane + 1 < hm ? lane + 1 : 0;
  T nv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) nv[k] = __shfl_sync(kFull, v[k], next);
  const T wa = v[3], wb = nv[3];
  const bool in_a = live && wa > eps;
  const bool cross = live && ((wa > eps) != (wb > eps));
  const T dw = wb - wa;
  const T t = (eps - wa) / (dw != T(0) ? dw : T(1));
  T inter[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) inter[k] = v[k] + t * (nv[k] - v[k]);
  // Kept vertex and intersection of each lane, in order (v0, i0, v1, ...):
  // ranks by ballot; ranks past H2 are dropped, as the plain scatter's dump.
  const unsigned kept = __ballot_sync(kFull, in_a);
  const unsigned crossed = __ballot_sync(kFull, cross);
  const unsigned below = (1u << lane) - 1u;
  const int rank = __popc(kept & below) + __popc(crossed & below);
  const int count = __popc(kept) + __popc(crossed);
  T(*slot)[4] = s.slot[threadIdx.x >> 5];
  if (in_a && rank < h2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) slot[rank][k] = v[k];
  }
  const int rank_i = rank + (in_a ? 1 : 0);
  if (cross && rank_i < h2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) slot[rank_i][k] = inter[k];
  }
  __syncwarp();
  // Unused slots repeat the first vertex (zeros where none was kept).
  const int used = min(count, h2);
  T q[4];
  const int src = lane < used ? lane : 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = count > 0 && lane < h2 ? slot[src][k] : T(0);
  __syncwarp();

  // Projection to pixels.
  const T hw = q[3];
  const T hiw = hw > T(0) ? T(1) / hw : T(0);
  const T half_w = static_cast<T>(p.half_w), half_h = static_cast<T>(p.half_h);
  const T hx = (q[0] * hiw + T(1)) * half_w;
  const T hy = (T(1) - q[1] * hiw) * half_h;
  const int nl = lane + 1 < h2 ? lane + 1 : 0;
  const T hxn = __shfl_sync(kFull, hx, nl);
  const T hyn = __shfl_sync(kFull, hy, nl);

  // The area's sign, summed in torch's CUDA order (the note at the top).
  const T term = lane < h2 ? hx * hyn - hxn * hy : T(0);
  int width = 1;
  while (width * 2 <= h2) width *= 2;
  const T upper = __shfl_sync(kFull, term, (lane + width) & 31);
  T acc = T(0) + term;
  if (lane + width < h2) acc = acc + (T(0) + upper);
  for (int off = width >> 1; off > 0; off >>= 1)
    acc = acc + __shfl_down_sync(kFull, acc, off);
  const T area = __shfl_sync(kFull, acc, 0);
  const T sign = area >= T(0) ? T(1) : T(-1);

  T a = -(hyn - hy) * sign;
  T b = (hxn - hx) * sign;
  // A hull clipped at the near plane takes each line's constant at its
  // nearer endpoint (coverage._nearer_endpoint); the others at the first.
  const T mag = max_nan(abs_of(hx), abs_of(hy));
  const T mag_n = __shfl_sync(kFull, mag, nl);
  const bool unclipped = kept == ((1u << hm) - 1u);
  T ax = hx, ay = hy;
  if (!unclipped &&
      ((mag_n < mag) || (mag_n == mag && (hxn < hx || (hxn == hx && hyn < hy))))) {
    ax = hxn;
    ay = hyn;
  }
  T c = -(a * ax + b * ay);
  if (a == T(0) && b == T(0)) {
    a = T(0);
    b = T(0);
    c = T(1);
  }

  // The hull's pixel box over its H2 vertices.
  const T hx0 = __shfl_sync(kFull, hx, 0), hy0 = __shfl_sync(kFull, hy, 0);
  const T bx = lane < h2 ? hx : hx0;
  const T by = lane < h2 ? hy : hy0;
  const T x_lo = warp_min(bx), x_hi = warp_max(bx);
  const T y_lo = warp_min(by), y_hi = warp_max(by);

  if (lane < h2) {
    s.a[i][lane] = a;
    s.b[i][lane] = b;
    s.c[i][lane] = c;
    if (hull_lines != nullptr) {
      T* row = hull_lines + (static_cast<long long>(r) * h2 + lane) * 4;
      row[0] = a;
      row[1] = b;
      row[2] = c;
      row[3] = T(0);
    }
  }
  if (lane == 0) {
    s.box[i][0] = x_lo;
    s.box[i][1] = x_hi;
    s.box[i][2] = y_lo;
    s.box[i][3] = y_hi;
    s.valid[i] = count >= 3;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cover_bins_kernel(Args p, const T* __restrict__ hull,
                      const T* __restrict__ transforms, T* __restrict__ hull_lines) {
  __shared__ Shared<T> s;
  const int c0 = blockIdx.x * p.covers_per_block;
  const int nc = min(p.covers_per_block, p.n_covers - c0);
  const int t0 = blockIdx.y * p.tiles_per_block;
  const int nt = min(p.tiles_per_block, p.n_tiles - t0);
  const int h2 = p.h_max + 2;

  for (int i = threadIdx.x >> 5; i < nc; i += kWarps)
    hull_setup(p, hull, transforms, c0 + i, i, s,
               blockIdx.y == 0 ? hull_lines : nullptr);
  __syncthreads();

  const float tw = static_cast<float>(p.tile_w), th = static_cast<float>(p.tile_h);
  const T twT = static_cast<T>(p.tile_w), thT = static_cast<T>(p.tile_h);
  for (int pair = threadIdx.x; pair < nc * nt; pair += kThreads) {
    const int i = pair % nc;
    const int tile = t0 + pair / nc;
    const int ty = tile / p.ntx, tx = tile - ty * p.ntx;
    // The tile's corner as the plain version's float32 tile_x0, tile_y0.
    const float fx0 = static_cast<float>(tx) * tw, fy0 = static_cast<float>(ty) * th;
    const T x0 = fx0, y0 = fy0, x1 = fx0 + tw, y1 = fy0 + th;
    const bool over = s.valid[i] && s.box[i][2] <= y1 && s.box[i][3] >= y0 &&
                      s.box[i][0] <= x1 && s.box[i][1] >= x0;
    bool reject = false, accept = true;
    int bits = 0;
    for (int h = 0; h < h2; ++h) {
      // _corner_min_max, in its operation order.
      const T a = s.a[i][h], b = s.b[i][h], c = s.c[i][h];
      const T base = a * x0 + b * y0 + c;
      const T dx = a * twT, dy = b * thT;
      const T lo = base + clamp_max0(dx) + clamp_max0(dy);
      const T hi = base + clamp_min0(dx) + clamp_min0(dy);
      reject = reject || hi < T(0);
      const bool inside = lo > T(0);
      accept = accept && inside;
      if (!inside) bits |= 1 << h;
    }
    const long long at = static_cast<long long>(tile) * p.n_covers + c0 + i;
    p.cls[at] = over ? (accept ? 2 : (reject ? 0 : 1)) : 0;
    p.hbits[at] = bits;
  }
}

}  // namespace

// Launch on `stream`: hull (n_shapes, h_max, 2) and transforms (R, 4, 4) of
// float (is_double 0) or double (1); c_shape, c_row (n_covers,) int64;
// writes hull_lines (n_covers, h_max + 2, 4) of the same type, cls and
// hbits (n_tiles, n_covers) int32.  Returns the launch's CUDA status.
extern "C" int cover_bins_launch(const void* hull, const void* transforms,
                                 const void* c_shape, const void* c_row,
                                 void* hull_lines, void* cls, void* hbits,
                                 int n_covers, int h_max, int ntx, int nty,
                                 int tile_w, int tile_h, double half_w,
                                 double half_h, float eps, int is_double,
                                 void* stream) {
  if (n_covers < 1 || h_max < 1 || h_max + 2 > kMaxLines || ntx < 1 || nty < 1)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.c_shape = static_cast<const long long*>(c_shape);
  p.c_row = static_cast<const long long*>(c_row);
  p.cls = static_cast<int*>(cls);
  p.hbits = static_cast<int*>(hbits);
  p.n_covers = n_covers;
  p.h_max = h_max;
  p.n_tiles = ntx * nty;
  p.ntx = ntx;
  p.tile_w = tile_w;
  p.tile_h = tile_h;
  p.half_w = half_w;
  p.half_h = half_h;
  p.eps = eps;
  p.covers_per_block = n_covers < kCoverChunk ? n_covers : kCoverChunk;
  // A pair a thread where covers are few (more blocks, each recomputing
  // its covers' lines); up to kPairsPerBlock a block where they are many.
  p.tiles_per_block = kPairsPerBlock / p.covers_per_block;
  if (p.tiles_per_block > kThreads) p.tiles_per_block = kThreads;
  if (p.tiles_per_block > p.n_tiles) p.tiles_per_block = p.n_tiles;
  const dim3 grid((n_covers + p.covers_per_block - 1) / p.covers_per_block,
                  (p.n_tiles + p.tiles_per_block - 1) / p.tiles_per_block);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    cover_bins_kernel<double><<<grid, kThreads, 0, s>>>(
        p, static_cast<const double*>(hull), static_cast<const double*>(transforms),
        static_cast<double*>(hull_lines));
  else
    cover_bins_kernel<float><<<grid, kThreads, 0, s>>>(
        p, static_cast<const float*>(hull), static_cast<const float*>(transforms),
        static_cast<float*>(hull_lines));
  return (int)cudaGetLastError();
}
