// coverage_raster: the fill-only coverage kernel, hand-written for Hopper
// (sm_90a).
//
// Replaces contrast_renderer_tpu/ops/coverage.py::make_rasterize.kernel,
// specialised to frames of filled paths with solid colour (no clip, no
// alpha groups, no depth, no strokes, no non-solid paints).  The bodies
// ported here:
//   - the per-tile walk: the empty-tile path (acount == 0 writes zeros), the
//     walk over the tile's active units (`aclist`), and the MSAA resolve to
//     float or to packed RGBA8 (one int32 per pixel);
//   - the fill stencil: solid, integral/rational quadratic (x^2 - yz <= 0)
//     and cubic (x^3 - yzw <= 0) entries, local then per-tile global, with
//     the top-left tie rule, and the per-(tile, command) bulk winding;
//   - the solid colour cover: the tile's cover class, the hull lines set in
//     `hbits`, the winding rule, the generic wgpu blend algebra (integer
//     factor and operation codes, blend constant from cmd_f columns 20:24),
//     and the winding reset of covered samples.
// The wrapper (ops/coverage.py::coverage_raster) refuses every frame that
// needs another body.
//
// What bounds it on this card: ALU work per binned entry over the tile's
// samples.  Each entry costs every pixel of its tile three edge functions,
// up to four interpolated curve weights and S sample tests (~40-120 float
// operations per pixel), against 96 bytes of entry row that the whole
// block shares; entry-row bandwidth is two orders of magnitude below the
// ALU time.
//
// What the design does about it:
//   - One thread owns one pixel for the whole command walk and keeps its S
//     windings and 4*S premultiplied colours in registers (20 registers at
//     4x MSAA).  A 32x128 tile's state at 4x MSAA is 320 KiB, more than a
//     block's shared memory, but the state never crosses pixels, so no
//     block needs it all: a block is a 256-pixel slab of a tile, on a grid
//     of (tiles, slabs).
//   - The block stages the entry rows it is about to walk into shared
//     memory in chunks, once for all its threads.
//   - Edge and curve functions are evaluated once at the pixel centre and
//     reached at each sample by a uniform shift, as the reference does.
//   - Control flow depends only on the tile and the unit, never on the
//     pixel, so the warps of a block never diverge on it.
//
// Rounding: built with --fmad=false, so every multiply and add rounds on
// its own, in the reference's order of operations; the results then match
// the plain torch version (rasterize_plain) bit for bit, edge ties
// included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;           // pixels (threads) per block
constexpr int CHUNK = 64;            // entry rows staged per pass
constexpr int ROW_F = 22;            // staged float columns: edges, 1/area, aux/w
constexpr int D_F = 32;
constexpr int D_I = 8;
constexpr int RF_INV_AREA = 9;
constexpr int RF_AW = 10;
constexpr int RI_CONTRIB = 1;
constexpr int RI_FLAGS = 3;
constexpr int OP_STENCIL = 0;
constexpr int OP_COLOR = 3;
constexpr int N_CLASSES = 9;
constexpr int CLS_FILL_SOLID = 6;
constexpr int CLS_FILL_QUAD = 7;
constexpr int CLS_FILL_CUBIC = 8;
constexpr int MAX_SAMPLES = 16;

// Blend factor and operation codes (ops/coverage.py BLEND_*_CODES).
constexpr int F_ZERO = 0, F_ONE = 1, F_SRC_ALPHA = 2, F_ONE_MINUS_SRC_ALPHA = 3,
              F_DST_ALPHA = 4, F_ONE_MINUS_DST_ALPHA = 5,
              F_SRC_ALPHA_SATURATED = 6, F_CONSTANT = 7,
              F_ONE_MINUS_CONSTANT = 8;
constexpr int B_ADD = 0, B_SUBTRACT = 1, B_MIN = 3, B_MAX = 4;

}  // namespace

// Mirrored field for field by ops/coverage.py::_RasterArgs.
struct RasterArgs {
  const int* cmd_i;      // (C, 4): op, clip depth, alpha layer, paint
  const float* cmd_f;    // (Rc, draw_cols): RGBA at columns 0:4
  const float* hull;     // (Rc, hull_rows, 4) inward pixel-space lines
  const int* unit_cmd;   // (U,)
  const int* unit_draw;  // (U,) cover draw, -1 for a stencil unit
  const int* acount;     // (n_tiles,)
  const int* aclist;     // (n_tiles, U)
  const int* off;        // (n_tiles, 9C+1) local entry ranges
  const int* g_off;      // (n_tiles, 9C+1) global entry ranges
  const int* bulk;       // (n_tiles, C)
  const int* cls;        // (n_tiles, Rc)
  const int* hbits;      // (n_tiles, Rc)
  const float* tri_f;    // (n_tiles, kp, 32)
  const int* tri_i;      // (n_tiles, kp, 8)
  const float* g_tri_f;  // (n_tiles, kgp, 32)
  const int* g_tri_i;    // (n_tiles, kgp, 8)
  void* out;             // f32 (n_tiles, 4, th, tw) or i32 (n_tiles, th, tw)
  int n_tiles, ntx, th, tw, strips, lw, lh;
  int n_commands, n_draws, n_units, hull_rows, draw_cols, kp, kgp;
  int samples, winding_mask, out_u8;
  int color_src, color_op, color_dst, alpha_src, alpha_op, alpha_dst;
  int uses_constant;
  float sample_x[MAX_SAMPLES];
  float sample_y[MAX_SAMPLES];
};

namespace {

__device__ __forceinline__ float blend_factor(int f, float ca, float da,
                                              int chan, const float* k) {
  switch (f) {
    case F_ONE: return 1.0f;
    case F_SRC_ALPHA: return ca;
    case F_ONE_MINUS_SRC_ALPHA: return 1.0f - ca;
    case F_DST_ALPHA: return da;
    case F_ONE_MINUS_DST_ALPHA: return 1.0f - da;
    case F_SRC_ALPHA_SATURATED: return chan < 3 ? fminf(ca, 1.0f - da) : 1.0f;
    case F_CONSTANT: return k[chan];
    case F_ONE_MINUS_CONSTANT: return 1.0f - k[chan];
    default: return 0.0f;
  }
}

// out = op(s * src_factor, d * dst_factor); min/max ignore the factors.
__device__ __forceinline__ float blend_channel(int sf, int op, int df, float s,
                                               float d, float ca, float da,
                                               int chan, const float* k) {
  if (op == B_MIN) return fminf(s, d);
  if (op == B_MAX) return fmaxf(s, d);
  const float st = sf == F_ZERO ? 0.0f : s * blend_factor(sf, ca, da, chan, k);
  const float dt = df == F_ZERO ? 0.0f : d * blend_factor(df, ca, da, chan, k);
  if (op == B_ADD) return st + dt;
  if (op == B_SUBTRACT) return st - dt;
  return dt - st;  // reverse subtract
}

// One fill entry against this thread's pixel: NCH = 0 solid, 3 quadratic,
// 4 cubic (the number of interpolated implicit-curve weights).
template <int S, int NCH>
__device__ __forceinline__ void fill_entry(const float* f, int contrib,
                                           int flags, float pxc, float pyc,
                                           const RasterArgs& a, int (&wind)[S]) {
  const float a0 = f[0], b0 = f[1], c0 = f[2];
  const float a1 = f[3], b1 = f[4], c1 = f[5];
  const float a2 = f[6], b2 = f[7], c2 = f[8];
  const float e0 = a0 * pxc + b0 * pyc + c0;
  const float e1 = a1 * pxc + b1 * pyc + c1;
  const float e2 = a2 * pxc + b2 * pyc + c2;
  const bool tl0 = (flags & 1) != 0;
  const bool tl1 = (flags & 2) != 0;
  const bool tl2 = (flags & 4) != 0;
  float ch[4], gx[4], gy[4];
  if (NCH > 0) {
    const float inv_area = f[RF_INV_AREA];
    const float l0 = e0 * inv_area;
    const float l1 = e1 * inv_area;
    const float l2 = e2 * inv_area;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      // aux/w of the vertex paired with edge 0, 1, 2 (RF_AW + 4*edge + k).
      const float w0 = f[RF_AW + k], w1 = f[RF_AW + 4 + k], w2 = f[RF_AW + 8 + k];
      ch[k] = l0 * w0 + l1 * w1 + l2 * w2;
      gx[k] = inv_area * (a0 * w0 + a1 * w1 + a2 * w2);
      gy[k] = inv_area * (b0 * w0 + b1 * w1 + b2 * w2);
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float dx = a.sample_x[s] - 0.5f;
    const float dy = a.sample_y[s] - 0.5f;
    const float nt0 = -(a0 * dx + b0 * dy);
    const float nt1 = -(a1 * dx + b1 * dy);
    const float nt2 = -(a2 * dx + b2 * dy);
    bool keep = (e0 > nt0 || (e0 == nt0 && tl0)) &&
                (e1 > nt1 || (e1 == nt1 && tl1)) &&
                (e2 > nt2 || (e2 == nt2 && tl2));
    if (NCH == 3) {
      const float xs = ch[0] + (gx[0] * dx + gy[0] * dy);
      const float ys = ch[1] + (gx[1] * dx + gy[1] * dy);
      const float zs = ch[2] + (gx[2] * dx + gy[2] * dy);
      keep = keep && (xs * xs - ys * zs <= 0.0f);
    } else if (NCH == 4) {
      const float xs = ch[0] + (gx[0] * dx + gy[0] * dy);
      const float ys = ch[1] + (gx[1] * dx + gy[1] * dy);
      const float zs = ch[2] + (gx[2] * dx + gy[2] * dy);
      const float ws = ch[3] + (gx[3] * dx + gy[3] * dy);
      keep = keep && (xs * xs * xs - ys * zs * ws <= 0.0f);
    }
    wind[s] += keep ? contrib : 0;
  }
}

// Entries [lo, hi) of one class from a tile's rows, staged through shared
// memory CHUNK rows at a time.  lo and hi are uniform over the block, so
// every thread reaches every barrier.
template <int S, int NCH>
__device__ void fill_range(const float* rows_f, const int* rows_i, int lo,
                           int hi, float pxc, float pyc, const RasterArgs& a,
                           int (&wind)[S], float* sf, int* si) {
  for (int base = lo; base < hi; base += CHUNK) {
    const int n = min(CHUNK, hi - base);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = threadIdx.x; i < n * ROW_F; i += BLOCK) {
      const int r = i / ROW_F;
      sf[i] = rows_f[(size_t)(base + r) * D_F + (i - r * ROW_F)];
    }
    for (int i = threadIdx.x; i < n; i += BLOCK) {
      si[2 * i] = rows_i[(size_t)(base + i) * D_I + RI_CONTRIB];
      si[2 * i + 1] = rows_i[(size_t)(base + i) * D_I + RI_FLAGS];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j)
      fill_entry<S, NCH>(sf + j * ROW_F, si[2 * j], si[2 * j + 1], pxc, pyc, a,
                         wind);
  }
}

template <int S, bool OUT_U8>
__global__ void __launch_bounds__(BLOCK)
    coverage_raster_kernel(const RasterArgs a) {
  __shared__ float sf[CHUNK * ROW_F];
  __shared__ int si[CHUNK * 2];
  const int t = blockIdx.x;
  const int n_px = a.th * a.tw;
  const int pix = blockIdx.y * BLOCK + threadIdx.x;  // lane-major in the tile
  const int r = pix / a.tw;
  const int l = pix - r * a.tw;
  const int n_active = a.acount[t];

  if (n_active == 0) {  // empty tile: transparent black
    if (OUT_U8) {
      static_cast<int*>(a.out)[(size_t)t * n_px + pix] = 0;
    } else {
#pragma unroll
      for (int chan = 0; chan < 4; ++chan)
        static_cast<float*>(a.out)[((size_t)t * 4 + chan) * n_px + pix] = 0.0f;
    }
    return;
  }

  // Strip layout: lane l of row r is screen pixel
  // (x0 + l % lw, y0 + (l / lw) * th + r).
  float col, row;
  if (a.strips == 1) {
    col = (float)l;
    row = (float)r;
  } else {
    col = (float)(l % a.lw);
    row = (float)((l / a.lw) * a.th + r);
  }
  const float bx = (float)(t % a.ntx) * (float)a.lw + col;
  const float by = (float)(t / a.ntx) * (float)a.lh + row;
  const float pxc = bx + 0.5f;
  const float pyc = by + 0.5f;

  int wind[S];
  float color[4][S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    wind[s] = 0;
#pragma unroll
    for (int chan = 0; chan < 4; ++chan) color[chan][s] = 0.0f;
  }

  const int n_ranges = N_CLASSES * a.n_commands + 1;
  const int* off = a.off + (size_t)t * n_ranges;
  const int* g_off = a.g_off + (size_t)t * n_ranges;
  const float* tri_f = a.tri_f + (size_t)t * a.kp * D_F;
  const int* tri_i = a.tri_i + (size_t)t * a.kp * D_I;
  const float* g_tri_f = a.g_tri_f + (size_t)t * a.kgp * D_F;
  const int* g_tri_i = a.g_tri_i + (size_t)t * a.kgp * D_I;

  for (int k = 0; k < n_active; ++k) {
    const int uid = a.aclist[(size_t)t * a.n_units + k];
    const int c = a.unit_cmd[uid];
    const int d = a.unit_draw[uid];
    const int op = a.cmd_i[c * 4];
    // Without clip commands the clip buffer is identically zero: commands
    // at a nonzero clip depth are no-ops.
    if (a.cmd_i[c * 4 + 1] != 0) continue;

    if (op == OP_STENCIL) {
      const int b = N_CLASSES * c;
      fill_range<S, 0>(tri_f, tri_i, off[b + CLS_FILL_SOLID],
                       off[b + CLS_FILL_SOLID + 1], pxc, pyc, a, wind, sf, si);
      fill_range<S, 0>(g_tri_f, g_tri_i, g_off[b + CLS_FILL_SOLID],
                       g_off[b + CLS_FILL_SOLID + 1], pxc, pyc, a, wind, sf, si);
      fill_range<S, 3>(tri_f, tri_i, off[b + CLS_FILL_QUAD],
                       off[b + CLS_FILL_QUAD + 1], pxc, pyc, a, wind, sf, si);
      fill_range<S, 3>(g_tri_f, g_tri_i, g_off[b + CLS_FILL_QUAD],
                       g_off[b + CLS_FILL_QUAD + 1], pxc, pyc, a, wind, sf, si);
      fill_range<S, 4>(tri_f, tri_i, off[b + CLS_FILL_CUBIC],
                       off[b + CLS_FILL_CUBIC + 1], pxc, pyc, a, wind, sf, si);
      fill_range<S, 4>(g_tri_f, g_tri_i, g_off[b + CLS_FILL_CUBIC],
                       g_off[b + CLS_FILL_CUBIC + 1], pxc, pyc, a, wind, sf,
                       si);
      const int bulk = a.bulk[(size_t)t * a.n_commands + c];
#pragma unroll
      for (int s = 0; s < S; ++s) wind[s] += bulk;
      continue;
    }

    const int cl = a.cls[(size_t)t * a.n_draws + d];
    if (cl == 0 || op != OP_COLOR) continue;
    bool in_hull[S];
#pragma unroll
    for (int s = 0; s < S; ++s) in_hull[s] = true;
    if (cl == 1) {  // boundary tile: only the hull lines crossing it
      const unsigned bits = (unsigned)a.hbits[(size_t)t * a.n_draws + d];
      const float* lines = a.hull + (size_t)d * a.hull_rows * 4;
      for (int h = 0; h < a.hull_rows; ++h) {
        if (((bits >> h) & 1u) == 0) continue;
        const float h0 = lines[4 * h], h1 = lines[4 * h + 1],
                    h2 = lines[4 * h + 2];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float he = h0 * (bx + a.sample_x[s]) + h1 * (by + a.sample_y[s]) + h2;
          in_hull[s] = in_hull[s] && he >= 0.0f;
        }
      }
    }
    const float* cf = a.cmd_f + (size_t)d * a.draw_cols;
    const float ca = cf[3];
    const float src[4] = {cf[0] * ca, cf[1] * ca, cf[2] * ca, ca};
    const float konst[4] = {
        a.uses_constant ? cf[20] : 0.0f, a.uses_constant ? cf[21] : 0.0f,
        a.uses_constant ? cf[22] : 0.0f, a.uses_constant ? cf[23] : 0.0f};
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (!in_hull[s] || (wind[s] & a.winding_mask) == 0) continue;
      const float da = color[3][s];
#pragma unroll
      for (int chan = 0; chan < 4; ++chan) {
        const bool alpha = chan == 3;
        color[chan][s] = blend_channel(
            alpha ? a.alpha_src : a.color_src, alpha ? a.alpha_op : a.color_op,
            alpha ? a.alpha_dst : a.color_dst, src[chan], color[chan][s], ca,
            da, chan, konst);
      }
      wind[s] = 0;
    }
  }

  // Resolve: the sample mean, summed in sample order.
  const float inv_s = 1.0f / (float)S;
  uint32_t packed = 0;
#pragma unroll
  for (int chan = 0; chan < 4; ++chan) {
    float v = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) v = v + color[chan][s];
    v = v * inv_s;
    if (OUT_U8) {
      // floor(clip(v) * 255 + 0.5), packed little-endian RGBA8 in uint32
      // (A << 24 would overflow an int32).
      const uint32_t q =
          (uint32_t)floorf(fminf(fmaxf(v, 0.0f), 1.0f) * 255.0f + 0.5f);
      packed |= q << (8 * chan);
    } else {
      static_cast<float*>(a.out)[((size_t)t * 4 + chan) * n_px + pix] = v;
    }
  }
  if (OUT_U8) static_cast<uint32_t*>(a.out)[(size_t)t * n_px + pix] = packed;
}

template <int S>
cudaError_t launch(const RasterArgs& a, cudaStream_t stream) {
  const dim3 grid(a.n_tiles, (a.th * a.tw) / BLOCK);
  if (a.out_u8)
    coverage_raster_kernel<S, true><<<grid, BLOCK, 0, stream>>>(a);
  else
    coverage_raster_kernel<S, false><<<grid, BLOCK, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int coverage_raster_block_size() { return BLOCK; }

// Launches on `stream`; allocates nothing and does not synchronise.
// Returns the cudaError_t of the launch: 0 if and only if the kernel was
// launched, so the caller counts a launch exactly when this returns 0.
extern "C" int coverage_raster_launch(const RasterArgs* args, void* stream) {
  const RasterArgs& a = *args;
  if (a.n_tiles <= 0 || (a.th * a.tw) % BLOCK != 0 ||
      a.th * a.tw / BLOCK > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.samples) {
    case 1: return (int)launch<1>(a, s);
    case 2: return (int)launch<2>(a, s);
    case 4: return (int)launch<4>(a, s);
    case 8: return (int)launch<8>(a, s);
    case 16: return (int)launch<16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
