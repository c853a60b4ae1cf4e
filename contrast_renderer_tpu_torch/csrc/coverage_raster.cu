// coverage_raster: the coverage kernel, hand-written for Hopper (sm_90a).
//
// Replaces contrast_renderer_tpu/ops/coverage.py::make_rasterize.kernel,
// every body of it:
//   - the per-tile walk: the empty-tile path (acount == 0 writes zeros), the
//     walk over the tile's active units (`aclist`), and the MSAA resolve to
//     float or to packed RGBA8 (one int32 per pixel), written at the
//     pixel's place in the frame;
//   - the stroke stencil: six classes (lines, joints; each solid,
//     single-interval dash, general dash), local then per-tile global,
//     before the fills: perspective-correct texcoords, the mitre / bevel /
//     round join predicate, the seven cap predicates, the dash pattern
//     (interval search, phase, caps), the reference's polynomial atan2 for
//     the joints' angle, and the stroke OR into the winding;
//   - the fill stencil: solid, integral/rational quadratic (x^2 - yz <= 0)
//     and cubic (x^3 - yzw <= 0) entries, with the top-left tie rule, and
//     the per-(tile, command) bulk winding;
//   - clip: the per-sample clip counter, set by clip ops and reset by
//     unclip ops, gating every stencil update, colour cover and alpha op;
//   - alpha groups: save, scale, save+scale and restore of frame alpha
//     through L per-sample layer slots;
//   - the colour cover: the tile's cover class, the hull lines set in
//     `hbits`, the winding rule, the wgpu blend algebra (the named states'
//     formulas, or integer factor and operation codes with the blend
//     constant from cmd_f columns 20:24), and the winding reset of covered
//     samples;
//   - depth: per sample the draw's NDC-z plane, one of the eight wgpu
//     compare functions against the pixel's S depth values (cleared to 1.0
//     per tile), joined into the cover mask, and the write of passing
//     samples; only the colour cover tests and writes depth;
//   - paints: solid colour, linear and radial gradients (t along the
//     projected paint points, a ramp of up to four stops, premultiplied),
//     and user paints, device functions that a generated compile unit
//     defines before it includes this file (`user_paint`, see
//     ops/coverage.py::_user_paint_unit).
//
// What bounds it on this card: ALU work per binned entry over the tile's
// samples.  A gradient cover adds per covered sample two or three divides,
// a square root for radial paints, and the ramp (~40 operations); depth
// adds three per sample for the plane and one compare.  A fill entry
// costs each pixel three edge functions, up to four interpolated curve
// weights and S sample tests (~40-120 float operations).  A stroke entry
// costs far more: per sample a divide, two or three texcoords and the
// cap, join and dash predicates (~60-250 operations, fmodf and the atan2
// polynomial included).  An entry covers few of its tile's 4,096 pixels
// (a stroke triangle is thin), so most of that work would end in a false
// edge test; staging and stepping over the entries that cannot cover a
// warp's pixels, one shared load and one vote at a time, took most of the
// rest (rasterize_plain's counts on config 2, config 3 and the 4K
// showcase, PERF.md: a block staged every row of its tile, 1.2-3.9 times
// the rows whose box meets it, and each warp stepped over every staged
// row, 1.3-9.4 times the pairs its box keeps).  Entry rows are read once
// per walking warp; their bandwidth is orders of magnitude below the ALU
// time.  Registers bound occupancy: per pixel the kernel holds S
// windings, 4*S colours, S clip counters and, with one alpha layer, S
// layer slots.
//
// What the design does about it:
//   - One thread owns one pixel for the whole command walk and keeps its
//     state in registers.  A 32x128 tile's state at 4x MSAA is 320 KiB,
//     more than a block's shared memory, but the state never crosses
//     pixels, so no block needs it all: a block is a 256-pixel slab of a
//     tile (4 rows x 64 lanes), on a grid of (tiles, slabs).
//   - One staged walk per (tile, command): the command's stencil rows, its
//     stroke rows then its fill rows (walk_runs), go through shared memory
//     CHUNK at a time, one barrier pair a chunk.  Warp 0 stages a chunk,
//     two rows a lane: each row's culling box (cull_box) is tested against
//     the block's rectangle of pixel centres, and only the rows that meet
//     it enter the chunk, in walk order (a ballot and __popc), as a box and
//     a meta (class, table, row).  A stroke's OR and a fill's add do not
//     commute, and the walk keeps the strokes first; each warp walks its
//     hits in staged order.
//   - Per-warp hit lists: after the barrier each warp tests the staged
//     boxes 32 at a time, lane j box j, against its own rectangle of pixel
//     centres, the least and greatest of its 32 pixels (a warp min and
//     max).  Where a strip is 8 pixels wide or more, the 8 x 4 pixels form
//     a product grid and every box is wider than a pixel, so the box meets
//     the rectangle exactly when it holds one of the warp's centres; in a
//     narrower strip the 8 lanes span several strips, th rows apart, and
//     the rectangle holds them all.  The warp writes its hits' metas into
//     its list in shared memory; it then walks the list.  Each listed
//     meta goes through a __reduce_or_sync, which leaves it in a uniform
//     register: the compiler knows the class switch and the row addresses
//     cannot diverge.  Branching on a per-thread value instead (a ballot mask
//     walked bit by bit, or one bit per (entry, warp) in shared memory)
//     raised the fill-only build from 63 to 79-126 registers.
//   - The stroke edge reject: a stroke row in a warp's box is listed only
//     if none of its three edge functions, at the corner of the warp's
//     sample footprint that maximises it, lies below minus its rounding
//     margin (edge_reject, below); a thin diagonal triangle's box meets
//     many warps that no edge of it admits.
//   - The warp vote.  stroke_cover runs the S edge tests first and ORs
//     the inside bits over the warp.  A warp where no lane has a sample
//     inside returns at once; otherwise only the samples that some lane
//     has inside run the divide, the texcoords and stroke_keep.  The
//     result is `inside & keep` per sample, so no bit changes.  A lane
//     with no inside sample still runs its warp's predicates: skipping
//     them would only mask it, since the warp issues them for the others.
//     Spreading the warp's inside (lane, sample) pairs over the lanes, 32
//     a round (a prefix sum by ballots, the owner's centre values by
//     shuffles, a ballot per round back), filled more of the lanes on
//     config 3 but gained nothing there and lost 17% on the
//     showcase under depth and on config 3 at 8x MSAA (the depth stroke
//     build went from 79 to 87 registers, three blocks an SM to two):
//     taken out (PERF.md).
//   - Fill rows through shuffles.  A fill row is read by one coalesced
//     load, lane j its float j, and each value taken by a shuffle
//     (WarpRow); a curve weight's offsets to the samples are the same for
//     every pixel, so lane k * S + s computes offset (k, s) once and the
//     pixels take it by a shuffle.  Neither holds the row or the 2 * NCH
//     slopes in every lane's registers, which keeps the capped fill build
//     at 64 registers without a spill.  A vote on a curve entry's edge
//     tests before its curve weights (52-61% of the curve pairs walked
//     have no sample inside) lost 21% on the showcase under depth and 10%
//     on config 3 at 8x MSAA (the depth stroke build went from 79 to 93
//     registers): taken out (PERF.md).
//   - Edge functions, curve weights, texcoord numerators and 1/w are
//     evaluated once at the pixel centre and reached at each sample by a
//     uniform shift, as the reference does.
//   - The six stroke classes are six template instantiations, each
//     branch-free in its class, selected by the uniform class switch.
//   - Alpha layers: one layer is held in registers (S floats per pixel, 4
//     for the showcase at S=4).  With more, each pixel's L*S slots live in
//     the block's dynamic shared memory at [j][s][thread], the reference's
//     per-grid-step (L, S, th, tw) layers: no bank conflicts, and a thread
//     touches only its own pixel's slots, so no barrier guards them.  The
//     kernel zeroes them per tile.  They fit beside the static shared
//     memory (3.4-4.5 KiB) in the 227 KiB a block may opt into up to L*S
//     = 222 (every L up to 27 at S <= 8, L <= 13 at S = 16).  Past that (256
//     slots at S=16, L=16) they go to a global scratch that the wrapper
//     allocates, one slice per block that can be resident at once on the
//     card, and the grid holds that many blocks, each walking (tile, slab)
//     items in a loop with its own slice: tens of MiB whatever the
//     frame's size (a scratch per pixel of the frame took 8.5 GB at
//     3840x2160).  No L is refused.
//   - Bracket gating (binning, renderer._gate_spans) drops a balanced clip
//     or alpha bracket from the tiles that no content touches; they take
//     the empty-tile path here.
//   - The clip vote.  Every stencil update, colour cover and alpha op of
//     a command masks each sample with clip[s] == its depth.  Before a
//     unit other than clip and unclip, each lane ORs that test over its
//     samples and the warp skips the unit when the __reduce_or_sync of it
//     is 0: it would change nothing there.  A stencil unit's walk stages
//     chunks behind block barriers, so such a warp still meets every
//     barrier, and walks no entry.  An alpha op is skipped, after the hull
//     test, where no lane has a sample inside its hull that passes the
//     clip test.
//   - Frames without clip or alpha ops compile both out (no clip registers)
//     and skip commands at a nonzero clip depth whole, and frames without
//     stroke rows compile the stroke classes out, as the reference's
//     static specialisation does: the stroke code would otherwise raise
//     the register count of fill-only frames.  That makes six
//     instantiations per build.  A build holds one sample count and one
//     feature set, chosen by the defines RASTER_SAMPLES, RASTER_DEPTH (the
//     S depth registers and the test) and RASTER_PAINT (0 solid only, 1
//     gradients, 2 gradients and user paints): a frame loads only the
//     build it needs, and the depth and paint bodies never enter the
//     registers of frames without them.  The compare function is a
//     runtime argument, uniform over the grid and switched outside the
//     sample loop, not a template parameter (eight times the builds).
//   - The frame's own layout.  The kernel writes each pixel at (by, bx) of
//     the frame, a float4 of (H, W, 4) float32 or an int32 of packed RGBA8,
//     and skips the padding of the last tile row and column; a warp row's
//     8 pixels are one 128-byte run of float4.  Tiles of (n_tiles, 4, th,
//     tw), as the reference's float output is laid out, needed a second
//     pass to de-tile them: at 4K a 266 MB copy after every frame, 0.13 ms
//     on the H100.
//   - The cover vote.  Paint, blend, winding reset and depth write all take
//     the cover mask (hull, winding rule, clip, depth), so after the mask
//     each lane ORs it over its samples and the warp skips them where the
//     __reduce_or_sync is 0: 74% of the 4K showcase's (warp, colour unit)
//     pairs, 87% of config 2's, 14% of the gradient card's
//     (rasterize_plain(work=...)'s "cover_skipped").
//   - The blend kinds.  The blend state is uniform over the grid.  The
//     named states (back to front, front to back, additive) run their
//     formulas, s + d * (1 - sa), s * (1 - da) + d and s + d, selected by one
//     switch per cover unit outside the sample loop; any other state runs
//     the generic blend_channel, which switches on the factor and operation
//     codes per channel and sample.  s * 1 is s, so each formula rounds as
//     the codes do.  One instantiation per kind would have multiplied the
//     build's 6 instantiations by 4.
//   - Gradient constants.  A gradient cover's per-draw terms (the stop
//     differences, the floored segment lengths, the axis and its floored
//     squared length) are computed once per unit, one value per lane, into
//     the warp's 32 floats of shared memory (gradient_constants), not at
//     every sample; the per-sample divides and square root stay IEEE.
//   - Control flow depends only on the tile, the unit and the warp-wide
//     reductions, never on the pixel alone, so no lane diverges from its
//     warp, and the staging loops and their barriers stay uniform over the
//     block (the warp reductions decide only what a warp does between
//     barriers); per-sample decisions are selects.  The one exception is the
//     general dash's cap types, which vary by sample: they take the
//     branch-free where-chain.
//
// Why culling by the box is exact.  The box is the min and max of the
// pixel-space vertices that the edge coefficients (a, b, c) were built
// from, so in exact arithmetic a sample that passes the three edge tests
// lies in the closed triangle, inside the box.  In float32 each test is
// off by at most 10u(X + 1)(|a| + |b|), with u = 2^-24 and X a bound on
// the coordinates of the vertices and the samples (rounding of the
// coefficients, of the edge function at the centre and of its shift to
// the sample).  A passing sample's barycentrics are then at least
// -eps_k / 2A, which puts it at most sum_k eps_k * w / 2A beyond the box
// in x (h in y, for a w x h box).  The stored 1/|area| is of the rounded
// area, which is off from the true 2A by at most 12u w h; so where
// 2^-20 w h inv_area < 1/2, 1/2A is at most 2.01 inv_area.  cull_box
// widens the box by one pixel plus k*w in x and k*h in y (and by the half
// pixel from a sample to its pixel's centre), with k = 2^-18
// X sum_k (|a_k| + |b_k|) inv_area, over three times that bound, and does
// not cull where the slack test fails.  The term needs no divide.  It is
// below 0.1 px for most entries and grows only along a sliver's long
// side.  A block's rectangle holds its warps' rectangles, so the block's
// test drops no row that a warp's would keep.
//
// Why the edge reject is exact.  A sample passes edge k when the computed
// e_k at its pixel's centre exceeds the computed nt_k = -(a dx + b dy)
// (or equals it, with the top-left flag).  With Q = (|a| + |b|) X + |c|,
// the computed e_k is within 3.01u Q of the exact a x + b y + c at the
// centre, nt_k within u(|a| + |b|) of its exact value, and the edge
// function at the footprint corner that maximises it within 3.01u Q; the
// exact function at any sample of the warp is at most its value at that
// corner.  So where the computed corner value lies below -7.1u Q, every
// computed e_k - nt_k of the warp is negative, and no sample passes.
// edge_reject's margin is 2^-20 Q = 16u Q (computed in float, off by a
// few u of itself), plus 2^-100 for products that underflow.
// tests/test_torch_cull.py and tests/test_torch_stencil_walk.py check on
// seven scenes, the near-plane orbit frame among them, that every (warp,
// entry) pair with a passing sample is staged, boxed and kept.
//
// Measured (chip_ab.py, one H100 80GB HBM3 at 700 W, against this kernel
// without the culling, the vote and the 4x8 warps, in one run; PERF.md):
// BASELINE config 3 (dashed strokes, 1080p) 2.04 -> 0.80 ms, as the vote
// skips 86% of its stroke sample evaluations; the 4K showcase frames
// 1.26-2.06 -> 0.87-1.72 ms, as the box test culls 73-83% of their (warp,
// entry) pairs; the fill-only and paint frames no slower.  Then, against
// this kernel without the bracket gating, the clip and alpha votes and the
// layers on chip: the 4K clip/alpha showcase 1.71 -> 1.33 ms with one
// alpha layer and 1.90 -> 1.38 ms with two; the other frames no slower.
// A block-wide vote (__syncthreads_or) before each stencil unit instead
// of the warp vote spilled 440-570 B in the stroke builds and ran that
// frame at 1.42 ms.  The profiling build then put 11-37% of the warp-cycles
// of the 4K showcase, showcase + depth and gradient-card frames in the
// blend; against this kernel with tiles de-tiled after it, the cover vote
// and the generic blend only, in one run (chip_ab.py): the showcase 0.88
// -> 0.65 ms, the gradient card 0.64 -> 0.36, config 2 0.19 -> 0.11,
// config 3 0.79 -> 0.69, the clip/alpha showcase 1.34 -> 1.15, most of it
// from the blend kinds; every image equal to the bit.
// Then the stencil walk above, against this kernel with a block that
// staged every row of its tile and warps that voted on each staged row,
// in one run (chip_ab.py): config 3 0.69 -> 0.38 ms (the edge reject
// alone 0.58 -> 0.39), the 4K showcase 0.64 -> 0.32, the clip/alpha
// showcase 1.16 -> 0.78, the showcase under depth 0.68 -> 0.34, config 3
// at 8x MSAA 1.11 -> 0.75, the other frames no slower; every image equal
// to the bit.

// Rounding: built with --fmad=false, so every multiply and add rounds on
// its own, in the reference's order of operations; divides and square
// roots are IEEE (no fast math), fmodf is exact, and atan2 is the
// reference's polynomial, op for op.  The results then match the plain
// torch version (rasterize_plain) bit for bit, edge and predicate ties
// included.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#ifndef RASTER_DEPTH
#define RASTER_DEPTH 0
#endif
#ifndef RASTER_PAINT
#define RASTER_PAINT 0
#endif
// The profiling build (RASTER_PROFILE=1): lane 0 of each warp reads
// clock64() at the boundaries of the bodies below and adds the cycles
// between them to the body's counter (shared per block, then
// RasterArgs::prof); its cover runs the paint and the blend as two sample
// loops, so that the boundary between them is warp-converged.  The
// subtractive build (RASTER_OMIT=body) leaves one body out, for timing
// alone.  Neither is loaded by a render (ops/coverage.py::coverage_raster's
// `profile` and `omit`).
#ifndef RASTER_PROFILE
#define RASTER_PROFILE 0
#endif
#ifndef RASTER_OMIT
#define RASTER_OMIT -1
#endif

namespace {

// Bodies of the profiling build, in ops/coverage.py::PROFILE_BODIES order:
// tile setup and the per-unit table loads; the stroke stencil; the fill
// stencil with the bulk winding; the cover's hull test; the cover's depth
// and mask; its paint; its blend, winding reset and depth write; clip and
// alpha ops; the resolve and write; empty tiles.
constexpr int BODY_SETUP = 0, BODY_STROKE = 1, BODY_FILL = 2, BODY_HULL = 3,
              BODY_DEPTH = 4, BODY_PAINT = 5, BODY_BLEND = 6,
              BODY_CLIP_ALPHA = 7, BODY_RESOLVE = 8, BODY_EMPTY = 9,
              N_BODIES = 10;
constexpr bool PROFILE = RASTER_PROFILE != 0;
constexpr int OMIT = RASTER_OMIT;

constexpr int BLOCK = 256;           // pixels (threads) per block
constexpr int CHUNK = 64;            // entry rows staged per pass
constexpr unsigned FULL = 0xffffffffu;
constexpr int D_F = 32;
constexpr int D_I = 8;
constexpr int DESC_F = 12;
constexpr int DESC_I = 16;
constexpr int RF_INV_AREA = 9;
constexpr int RF_AW = 10;
constexpr int RF_IW = 22;
constexpr int RF_END_Y = 25;
constexpr int RF_AABB = 26;  // 26..29: pixel-space min x, min y, max x, max y
constexpr int RI_CONTRIB = 1;
constexpr int RI_GROUP = 2;
constexpr int RI_FLAGS = 3;
constexpr int RI_CLASS = 6;
constexpr int FLAG_END_CAP = 8;
constexpr int FLAG_JOINT_TIP = 16;
constexpr int OP_STENCIL = 0;
constexpr int OP_CLIP = 1;
constexpr int OP_UNCLIP = 2;
constexpr int OP_COLOR = 3;
constexpr int OP_SAVE_ALPHA = 4;
constexpr int OP_SCALE_ALPHA = 5;
constexpr int OP_RESTORE_ALPHA = 6;
constexpr int OP_SAVE_SCALE = 7;
constexpr int N_CLASSES = 9;
constexpr int CLS_LINE_SOLID = 0;
constexpr int CLS_JOINT_SOLID = 3;
constexpr int CLS_FILL_SOLID = 6;
constexpr int CLS_FILL_QUAD = 7;
constexpr int CLS_FILL_CUBIC = 8;
constexpr int MAX_SAMPLES = 16;
constexpr int MAX_DASH_INTERVALS = 4;
constexpr int JOIN_BEVEL = 1, JOIN_ROUND = 2;
constexpr int CAP_SQUARE = 0, CAP_ROUND = 1, CAP_OUT = 2, CAP_IN = 3,
              CAP_RIGHT = 4, CAP_LEFT = 5, CAP_BUTT = 6;
// Python's math.pi and the reference's TAU = 2 pi, rounded to float as the
// reference rounds them (double, then float).
constexpr double PI = 3.141592653589793;
constexpr double TAU = 2.0 * PI;

// Blend factor and operation codes (ops/coverage.py BLEND_*_CODES).
constexpr int F_ZERO = 0, F_ONE = 1, F_SRC_ALPHA = 2, F_ONE_MINUS_SRC_ALPHA = 3,
              F_DST_ALPHA = 4, F_ONE_MINUS_DST_ALPHA = 5,
              F_SRC_ALPHA_SATURATED = 6, F_CONSTANT = 7,
              F_ONE_MINUS_CONSTANT = 8;
constexpr int B_ADD = 0, B_SUBTRACT = 1, B_MIN = 3, B_MAX = 4;
// Blend kinds (ops/coverage.py::blend_kind): the named states of
// _NAMED_BLEND, and any other state.
constexpr int BLEND_GENERIC = 0, BLEND_BACK_TO_FRONT = 1,
              BLEND_FRONT_TO_BACK = 2, BLEND_ADDITIVE = 3;
// Depth compare function codes (ops/coverage.py DEPTH_COMPARE_CODES).
constexpr int CMP_NEVER = 0, CMP_LESS = 1, CMP_EQUAL = 2, CMP_LESS_EQUAL = 3,
              CMP_GREATER = 4, CMP_NOT_EQUAL = 5, CMP_GREATER_EQUAL = 6;
constexpr int MAX_STOPS = 4;
constexpr int PAINT_LINEAR = 1, PAINT_RADIAL = 2;

}  // namespace

// Mirrored field for field by ops/coverage.py::_RasterArgs.
struct RasterArgs {
  const int* cmd_i;      // (C, 4): op, clip depth, alpha layer, paint code
  const float* cmd_f;    // (Rc, draw_cols): stop colours 0:16, offsets 16:20
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
  const float* desc_f;   // (n_groups, 12) dash gaps, phase
  const int* desc_i;     // (n_groups, 16) caps, last interval, join
  const float* paint_xy;  // (Rc, 4) paint points in pixels
  const float* zplane;    // (Rc, 3) NDC-z plane a, b, c
  // Layer mode 0 with alpha layers past shared memory: a scratch of
  // layer_blocks slices of (L, S, 256) floats, one per block; else null.
  float* layers;
  // The profiling build's warp-cycles per body (N_BODIES); else null.
  unsigned long long* prof;
  // The frame: f32 (height, width, 4), 16-byte aligned, or packed RGBA8
  // as i32 (height, width).
  void* out;
  int width, height;
  int n_tiles, ntx, th, tw, strips, lw, lh;
  int n_commands, n_draws, n_units, hull_rows, draw_cols, kp, kgp, n_groups;
  int samples, winding_mask, out_u8;
  int color_src, color_op, color_dst, alpha_src, alpha_op, alpha_dst;
  int blend_kind;  // a BLEND_* kind; the codes above serve BLEND_GENERIC
  // has_clip: the frame holds clip or unclip ops; has_alpha: alpha-group
  // ops.  layer_mode: -1, no clip or alpha ops; 1, one alpha layer in
  // registers; 0, layers in shared memory, or in `layers`.  has_strokes:
  // some stencil draw carries stroke rows.
  int has_clip, has_alpha, layer_mode, n_layers, layer_blocks, has_strokes;
  // depth_compare: a CMP_* code; depth_write: write passing samples.
  int depth_compare, depth_write;
  float sample_x[MAX_SAMPLES];
  float sample_y[MAX_SAMPLES];
};

namespace {

// The profiling build's clock: lap(body) charges the cycles since the
// previous lap to `body`.  Every lap sits where the warp is converged
// (control flow is warp-uniform there), so lane 0's clock is the warp's.
// Empty outside the profiling build.
struct Laps {
  unsigned long long* acc;  // the block's shared counters
  long long t;
  __device__ __forceinline__ void start() {
    if constexpr (PROFILE) t = clock64();
  }
  __device__ __forceinline__ void lap(int body) {
    if constexpr (PROFILE) {
      const long long now = clock64();
      if ((threadIdx.x & 31) == 0)
        atomicAdd(acc + body, (unsigned long long)(now - t));
      t = now;
    }
  }
};

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
// k is the blend constant, the draw's cmd_f columns 20:24: only the
// constant factors read it, and cmd_f has those columns when they occur.
// Read there, not held in registers: holding it raised the depth and
// user-paint build from 79 to 103 registers (ptxas, S=4).
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

// One channel of the blend, out = op(s * src_factor, d * dst_factor), as a
// function object of (channel, s, d, source alpha, destination alpha,
// blend constant).  The named states are their formulas in the plain
// version's order of operations (s * 1 is s): no code is selected per
// sample.  Any other state reads the frame's factor and operation codes.
struct BlendBackToFront {  // (one, add, one_minus_src_alpha)
  __device__ __forceinline__ float operator()(int, float s, float d, float sa,
                                              float, const float*) const {
    return s + d * (1.0f - sa);
  }
};
struct BlendFrontToBack {  // (one_minus_dst_alpha, add, one)
  __device__ __forceinline__ float operator()(int, float s, float d, float,
                                              float da, const float*) const {
    return s * (1.0f - da) + d;
  }
};
struct BlendAdditive {  // (one, add, one)
  __device__ __forceinline__ float operator()(int, float s, float d, float,
                                              float, const float*) const {
    return s + d;
  }
};
struct BlendGeneric {
  int color_src, color_op, color_dst, alpha_src, alpha_op, alpha_dst;
  __device__ __forceinline__ float operator()(int chan, float s, float d,
                                              float sa, float da,
                                              const float* k) const {
    const bool alpha = chan == 3;
    return blend_channel(alpha ? alpha_src : color_src, alpha ? alpha_op : color_op,
                         alpha ? alpha_dst : color_dst, s, d, sa, da, chan, k);
  }
};

// max and min that return NaN when either operand is NaN (jnp.maximum,
// torch.maximum), unlike fmaxf and fminf.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float clip01(float x) {
  return nan_min(nan_max(x, 0.0f), 1.0f);
}

// The depth test of one colour draw: bit s is set where the compare
// function passes for the sample's fragment depth z[s] against buf[s].
// cmp is uniform over the grid; the switch sits outside the sample loops.
template <int S>
__device__ __forceinline__ unsigned depth_pass(int cmp, const float (&z)[S],
                                               const float (&buf)[S]) {
  unsigned bits = 0u;
#define DEPTH_CASE(CODE, OP)                                     \
  case CODE:                                                     \
    _Pragma("unroll") for (int s = 0; s < S; ++s)                \
        bits |= (unsigned)(z[s] OP buf[s]) << s;                 \
    break;
  switch (cmp) {
    case CMP_NEVER: break;
    DEPTH_CASE(CMP_LESS, <)
    DEPTH_CASE(CMP_EQUAL, ==)
    DEPTH_CASE(CMP_LESS_EQUAL, <=)
    DEPTH_CASE(CMP_GREATER, >)
    DEPTH_CASE(CMP_NOT_EQUAL, !=)
    DEPTH_CASE(CMP_GREATER_EQUAL, >=)
    default: bits = ~0u;  // always
  }
#undef DEPTH_CASE
  return bits;
}

// A gradient draw's constants, computed once per cover unit into its
// warp's 32-float slot of shared memory, lane i the value at index i: the
// first stop's colour; for each ramp segment i, its four channels' stop
// differences and its offset; each segment's length floored at 1e-6 (a
// hard stop); the anchor, the axis (end minus start, or rim minus centre)
// and its squared length floored at 1e-12.  The same operations on the
// same values as per sample, so the paint rounds as before.
constexpr int GC_BASE = 0, GC_DIFF = 4, GC_OFF = 16, GC_LEN = 19,
              GC_ANCHOR = 22, GC_AXIS = 24, GC_DEN = 26;
__device__ __forceinline__ void gradient_constants(const float* cf,
                                                   const float* pxy, int lane,
                                                   float* g) {
  float v = 0.0f;
  if (lane < GC_DIFF) {
    v = cf[lane];
  } else if (lane < GC_OFF) {
    const int i = (lane - GC_DIFF) >> 2, ch = (lane - GC_DIFF) & 3;
    v = cf[4 * (i + 1) + ch] - cf[4 * i + ch];
  } else if (lane < GC_LEN) {
    v = cf[lane];  // offsets, cmd_f columns 16:19
  } else if (lane < GC_ANCHOR) {
    const int i = lane - GC_LEN;
    v = nan_max(cf[17 + i] - cf[16 + i], (float)1e-6);
  } else if (lane < GC_AXIS) {
    v = pxy[lane - GC_ANCHOR];
  } else if (lane < GC_DEN) {
    v = pxy[lane - GC_AXIS + 2] - pxy[lane - GC_AXIS];
  } else if (lane == GC_DEN) {
    const float pdx = pxy[2] - pxy[0], pdy = pxy[3] - pxy[1];
    v = nan_max(pdx * pdx + pdy * pdy, (float)1e-12);
  }
  g[lane] = v;
}

// Gradient paint (reference _gradient_cover), straight RGBA at (px, py): t
// along the draw's projected paint points (linear: start to end; radial:
// centre to rim) clipped to [0, 1], then the piecewise-linear ramp of the
// MAX_STOPS stops of its cmd_f row.  Op for op as the reference, IEEE
// divide and sqrt; `g` holds the draw's gradient_constants.
__device__ __forceinline__ void gradient_paint(const float* g, bool radial,
                                               float px, float py,
                                               float (&rgba)[4]) {
  const float rel_x = px - g[GC_ANCHOR], rel_y = py - g[GC_ANCHOR + 1];
  const float pden = g[GC_DEN];
  const float t = clip01(radial ? sqrtf((rel_x * rel_x + rel_y * rel_y) / pden)
                                : (rel_x * g[GC_AXIS] + rel_y * g[GC_AXIS + 1]) / pden);
  float fs[MAX_STOPS - 1];
#pragma unroll
  for (int i = 0; i < MAX_STOPS - 1; ++i)
    fs[i] = clip01((t - g[GC_OFF + i]) / g[GC_LEN + i]);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    float v = g[GC_BASE + ch];
#pragma unroll
    for (int i = 0; i < MAX_STOPS - 1; ++i)
      v = v + g[GC_DIFF + 4 * i + ch] * fs[i];
    rgba[ch] = v;
  }
}

// The rounding term of the cull margin (see the note at the head):
// 2^-18 = 64u and 2^-20 = 16u, with u = 2^-24 the unit roundoff.
constexpr float CULL_EPS = 3.814697265625e-06f;
constexpr float CULL_AREA_EPS = 9.5367431640625e-07f;

// The box that entry row f is culled by, (min x, min y, max x, max y): its
// RF_AABB widened by one pixel plus the rounding term, and by the half
// pixel from a pixel's centre to its samples, so that a warp tests it
// against its pixels' centres.  `coord` bounds every pixel coordinate of
// the grid (its width plus its height plus one).  A NaN anywhere keeps the
// entry.  ops/coverage.py::_cull_boxes is the same arithmetic in torch.
__device__ __forceinline__ float4 cull_box(const float* f, float coord) {
  const float x0 = f[RF_AABB], y0 = f[RF_AABB + 1];
  const float x1 = f[RF_AABB + 2], y1 = f[RF_AABB + 3];
  const float w = x1 - x0, h = y1 - y0;
  // sum_k |a_k| + |b_k|, the entry's edge normals.
  const float norm = ((fabsf(f[0]) + fabsf(f[1])) + (fabsf(f[3]) + fabsf(f[4]))) +
                     (fabsf(f[6]) + fabsf(f[7]));
  const float xm =
      fmaxf(fmaxf(fabsf(x0), fabsf(x1)), fmaxf(fabsf(y0), fabsf(y1))) + coord;
  // Below 1/2, 1/(true |area|) is at most twice the stored 1/|area|.
  const float inv_area = f[RF_INV_AREA];
  const float slack = CULL_AREA_EPS * (w * h) * inv_area;
  const float k = (slack < 0.5f) & (inv_area > 0.0f)
                      ? CULL_EPS * xm * norm * inv_area
                      : CUDART_INF_F;
  const float mx = 1.5f + k * w, my = 1.5f + k * h;
  return make_float4(x0 - mx, y0 - my, x1 + mx, y1 + my);
}

// The edge reject's margin (see the note at the head): 2^-20 = 16u of
// the edge function's magnitude, and 2^-100 for underflow.
constexpr float EDGE_EPS = 0x1p-20f;
constexpr float EDGE_TINY = 0x1p-100f;

// Whether no sample of the warp whose rectangle of pixel centres is r
// (min x, min y, max x, max y) can pass one of entry row f's three edge
// tests: its sample footprint is [r.x - 1/2, r.z + 1/2] x [r.y - 1/2, r.w
// + 1/2] (every corner exact), and an edge function's largest value on
// it, at the corner its (a, b) points to, lies below minus the rounding
// margin.  A NaN rejects nothing.  ops/coverage.py::_edge_reject is the
// same arithmetic in torch.
__device__ __forceinline__ bool edge_reject(const float* f, const float4 r,
                                            float coord) {
  bool out = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ea = f[3 * k], eb = f[3 * k + 1], ec = f[3 * k + 2];
    const float x = ea > 0.0f ? r.z + 0.5f : r.x - 0.5f;
    const float y = eb > 0.0f ? r.w + 0.5f : r.y - 0.5f;
    const float e = ea * x + eb * y + ec;
    const float margin =
        EDGE_EPS * ((fabsf(ea) + fabsf(eb)) * coord + fabsf(ec)) + EDGE_TINY;
    out = out | (e < -margin);
  }
  return out;
}

// Whether box b meets the rectangle r of pixel centres (min x, min y,
// max x, max y); a NaN keeps the box.
__device__ __forceinline__ bool box_meets(const float4 b, const float4 r) {
  return !((b.z < r.x) | (b.x > r.z) | (b.w < r.y) | (b.y > r.w));
}

// jnp.remainder: the truncated remainder moved into the sign of b.
__device__ __forceinline__ float py_remainder(float a, float b) {
  const float m = fmodf(a, b);
  return (m != 0.0f && ((m < 0.0f) != (b < 0.0f))) ? m + b : m;
}

// The reference's atan2 (ops/coverage.py::_atan2): minimax polynomial on
// [0, 1] and an octant reduction, op for op.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = nan_max(ax, ay), lo = nan_min(ax, ay);
  const float a = lo / nan_max(hi, (float)1e-30);
  const float s = a * a;
  float r = s * (float)2.90188402868554e-3 - (float)1.62907683983662e-2;
  r = r * s + (float)4.30330487210615e-2;
  r = r * s - (float)7.53012846110272e-2;
  r = r * s + (float)1.06614349190831e-1;
  r = r * s - (float)1.42070654521002e-1;
  r = r * s + (float)1.99934912843697e-1;
  r = r * s - (float)3.33331017859204e-1;
  r = r * s * a + a;
  r = ay > ax ? (float)(0.5 * PI) - r : r;
  r = x < 0.0f ? (float)PI - r : r;
  return y < 0.0f ? -r : r;
}

// Cap predicates (shaders.wgsl:165-189) for a cap type uniform over the
// block: one case.
__device__ __forceinline__ bool cap_mask(int cap, float x, float y) {
  switch (cap) {
    case CAP_SQUARE: return y <= 0.5f;
    case CAP_ROUND: return x * x + y * y < 0.25f;
    case CAP_OUT: return 0.5f - y > fabsf(x);
    case CAP_IN: return y < fabsf(x);
    case CAP_RIGHT: return 0.5f - y > x;
    case CAP_LEFT: return y - 0.5f < x;
    case CAP_BUTT: return y < 0.0f;
    default: return false;
  }
}

// The same predicates for a cap type that varies by sample, branch-free.
__device__ __forceinline__ bool cap_mask_select(int cap, float x, float y) {
  const float ax = fabsf(x);
  return ((cap == CAP_BUTT) & (y < 0.0f)) |
         ((cap == CAP_SQUARE) & (y <= 0.5f)) |
         ((cap == CAP_ROUND) & (x * x + y * y < 0.25f)) |
         ((cap == CAP_OUT) & (0.5f - y > ax)) |
         ((cap == CAP_IN) & (y < ax)) |
         ((cap == CAP_RIGHT) & (0.5f - y > x)) |
         ((cap == CAP_LEFT) & (y - 0.5f < x));
}

// Dashed coverage at pattern position y, side x: DASH 1 is a
// single-interval pattern, 2 the general one (shaders.wgsl:205-231).  df
// and di are the entry's staged descriptor (desc_f[0:9], desc_i[0:13]).
template <int DASH>
__device__ __forceinline__ bool dash_mask(const float* df, const int* di,
                                          float x, float y) {
  if constexpr (DASH == 1) {
    const float pattern_len = df[4];
    const float position = py_remainder(y - df[8], pattern_len);
    const float past = position - df[0];
    return (past <= 0.0f) | cap_mask(di[0], x, past) |
           cap_mask(di[4], x, pattern_len - position);
  } else {
    const int last = di[8];
    float pattern_len = df[4];
#pragma unroll
    for (int i = 1; i < MAX_DASH_INTERVALS; ++i)
      pattern_len = last == i ? df[4 + i] : pattern_len;
    const float position = py_remainder(y - df[8], pattern_len);
    int interval = last;
#pragma unroll
    for (int i = MAX_DASH_INTERVALS - 1; i >= 0; --i) {
      const bool hit = (df[4 + i] - position >= 0.0f) & (i <= last);
      interval = hit ? i : interval;
    }
    float g_s = 0.0f, g_e = 0.0f;
    int e_cap = 0, s_cap = 0;
#pragma unroll
    for (int i = 0; i < MAX_DASH_INTERVALS; ++i) {
      const bool sel = interval == i;
      g_s = sel ? df[i] : g_s;
      g_e = sel ? df[4 + i] : g_e;
      e_cap = sel ? di[i] : e_cap;
      s_cap = sel ? di[4 + i] : s_cap;
    }
    const float past = position - g_s;
    return (past <= 0.0f) | cap_mask_select(e_cap, x, past) |
           cap_mask_select(s_cap, x, g_e - position);
  }
}

// Whether one sample's texcoords lie on the stroke (reference
// process_stroke_batch.entry_keep): f the entry's row, df and di its
// group's descriptor rows (desc_f, desc_i).
template <bool JOINT, int DASH>
__device__ __forceinline__ bool stroke_keep(const float* f, int flags,
                                            const float* df, const int* di,
                                            const float* tex) {
  if constexpr (JOINT) {
    const float radius = sqrtf(tex[0] * tex[0] + tex[1] * tex[1]);
    const int join = di[10];
    const bool is_tip = (flags & FLAG_JOINT_TIP) != 0;
    const bool is_bevel = join == JOIN_BEVEL, is_round = join == JOIN_ROUND;
    // Mitre keeps everything, bevel drops tip triangles, round keeps the
    // half-width disc (shaders.wgsl:191-203).
    bool keep = (((!is_bevel) & (!is_round)) & (radius >= 0.0f)) |
                ((is_bevel & (!is_tip)) & (radius >= 0.0f)) |
                (is_round & (radius <= 0.5f));
    if constexpr (DASH != 0) {
      const float angle = atan2_poly(tex[1], tex[0]) * (float)(1.0 / TAU);
      keep = keep & dash_mask<DASH>(df, di, radius, tex[2] + angle);
    }
    return keep;
  } else if constexpr (DASH != 0) {
    return dash_mask<DASH>(df, di, tex[0], tex[1]);
  } else {
    const bool end_cap = cap_mask(di[12], tex[0], tex[1] - f[RF_END_Y]);
    const bool start_cap = cap_mask(di[11], tex[0], -tex[1]);
    const bool end_flag = (flags & FLAG_END_CAP) != 0;
    return (end_flag & end_cap) |
           ((!end_flag) & ((tex[1] >= 0.0f) | start_cap));
  }
}

// The lanes below this one's, as a mask.
__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// One stroke entry against this thread's pixel: bit s of the result is set
// when the entry covers sample s.  The edge tests come first, for all S
// samples; a sample's predicates run only where some lane of the warp has
// it inside (the warp vote), and a warp with no inside sample returns at
// once.  The result is `inside & keep` per sample either way.  The
// predicates' loop stays rolled (offsets from shared memory), so their code
// does not grow with S.  All 32 lanes must call it together.
template <bool JOINT, int DASH, int S>
__device__ __forceinline__ unsigned stroke_cover(const float* f, int flags,
                                                 const float* df, const int* di,
                                                 float pxc, float pyc,
                                                 const float* sdx,
                                                 const float* sdy) {
  constexpr int NCH = JOINT ? 3 : 2;
  const float a0 = f[0], b0 = f[1], c0 = f[2];
  const float a1 = f[3], b1 = f[4], c1 = f[5];
  const float a2 = f[6], b2 = f[7], c2 = f[8];
  const float e0 = a0 * pxc + b0 * pyc + c0;
  const float e1 = a1 * pxc + b1 * pyc + c1;
  const float e2 = a2 * pxc + b2 * pyc + c2;
  const bool tl0 = (flags & 1) != 0;
  const bool tl1 = (flags & 2) != 0;
  const bool tl2 = (flags & 4) != 0;
  unsigned in_bits = 0u;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float dx = sdx[s], dy = sdy[s];
    const float nt0 = -(a0 * dx + b0 * dy);
    const float nt1 = -(a1 * dx + b1 * dy);
    const float nt2 = -(a2 * dx + b2 * dy);
    const bool inside = ((e0 > nt0) | ((e0 == nt0) & tl0)) &
                        ((e1 > nt1) | ((e1 == nt1) & tl1)) &
                        ((e2 > nt2) | ((e2 == nt2) & tl2));
    in_bits |= (unsigned)inside << s;
  }
  // The samples that some lane of the warp has inside.
  const unsigned warp_in = __reduce_or_sync(FULL, in_bits);
  if (warp_in == 0u) return 0u;
  const float inv_a = f[RF_INV_AREA];
  const float l0 = e0 * inv_a, l1 = e1 * inv_a, l2 = e2 * inv_a;
  float ch[NCH], gx[NCH], gy[NCH];
#pragma unroll
  for (int cc = 0; cc < NCH; ++cc) {
    // aux/w of the vertex paired with edge 0, 1, 2 (RF_AW + 4*edge + cc).
    const float w0 = f[RF_AW + cc], w1 = f[RF_AW + 4 + cc],
                w2 = f[RF_AW + 8 + cc];
    ch[cc] = l0 * w0 + l1 * w1 + l2 * w2;
    gx[cc] = inv_a * (a0 * w0 + a1 * w1 + a2 * w2);
    gy[cc] = inv_a * (b0 * w0 + b1 * w1 + b2 * w2);
  }
  const float i0 = f[RF_IW], i1 = f[RF_IW + 1], i2 = f[RF_IW + 2];
  const float iw_c = l0 * i0 + l1 * i1 + l2 * i2;
  const float gxw = inv_a * (a0 * i0 + a1 * i1 + a2 * i2);
  const float gyw = inv_a * (b0 * i0 + b1 * i1 + b2 * i2);
  unsigned bits = 0u;
#pragma unroll 1
  for (unsigned m = warp_in; m != 0u; m &= m - 1u) {
    const int s = __ffs(m) - 1;
    const float dx = sdx[s], dy = sdy[s];
    const float iws = iw_c + (gxw * dx + gyw * dy);
    const float inv = 1.0f / (iws != 0.0f ? iws : 1.0f);
    float tex[NCH];
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
      tex[cc] = (ch[cc] + (gx[cc] * dx + gy[cc] * dy)) * inv;
    const bool inside = ((in_bits >> s) & 1u) != 0u;
    const bool cov = inside & stroke_keep<JOINT, DASH>(f, flags, df, di, tex);
    bits |= (unsigned)cov << s;
  }
  return bits;
}

// An entry row held across the warp's lanes, lane j its float j (a row
// is D_F = 32 floats, one coalesced load); f[k] broadcasts float k by a
// shuffle.  A fill entry reads its row so: 22 row values held in
// registers, or 22 addresses' worth of loads in flight, would push the
// capped fill build past its 64 registers.  All 32 lanes must use it
// together.
struct WarpRow {
  float v;
  // Float k; k may differ from lane to lane.
  __device__ __forceinline__ float operator[](int k) const {
    return __shfl_sync(FULL, v, k);
  }
};

// One fill entry against this thread's pixel: NCH = 0 solid, 3 quadratic,
// 4 cubic (the number of interpolated implicit-curve weights); the S edge
// tests, then the curve tests.  All 32 lanes must call it together.
template <int S, bool CA, int NCH>
__device__ __forceinline__ void fill_entry(const WarpRow& f, int contrib,
                                           int flags, float pxc, float pyc,
                                           const RasterArgs& a, int (&wind)[S],
                                           const int (&clip)[CA ? S : 1],
                                           int depth) {
  const float a0 = f[0], b0 = f[1], c0 = f[2];
  const float a1 = f[3], b1 = f[4], c1 = f[5];
  const float a2 = f[6], b2 = f[7], c2 = f[8];
  const float e0 = a0 * pxc + b0 * pyc + c0;
  const float e1 = a1 * pxc + b1 * pyc + c1;
  const float e2 = a2 * pxc + b2 * pyc + c2;
  const bool tl0 = (flags & 1) != 0;
  const bool tl1 = (flags & 2) != 0;
  const bool tl2 = (flags & 4) != 0;
  unsigned keep = 0u;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float dx = a.sample_x[s] - 0.5f;
    const float dy = a.sample_y[s] - 0.5f;
    const float nt0 = -(a0 * dx + b0 * dy);
    const float nt1 = -(a1 * dx + b1 * dy);
    const float nt2 = -(a2 * dx + b2 * dy);
    const bool inside = (e0 > nt0 || (e0 == nt0 && tl0)) &&
                        (e1 > nt1 || (e1 == nt1 && tl1)) &&
                        (e2 > nt2 || (e2 == nt2 && tl2));
    keep |= (unsigned)inside << s;
  }
  if constexpr (NCH > 0) {
    const float inv_area = f[RF_INV_AREA];
    const float l0 = e0 * inv_area;
    const float l1 = e1 * inv_area;
    const float l2 = e2 * inv_area;
    // Each weight at the pixel centre, ch[k], and its offset to each
    // sample, gx[k] * dx + gy[k] * dy.  The offsets are the same for
    // every pixel: with NCH * S <= 32 lane k * S + s computes offset
    // (k, s) alone, and each pixel takes it by a shuffle, so no lane
    // holds the 2 * NCH slopes (the capped fill build's registers).
    float ch[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      // aux/w of the vertex paired with edge 0, 1, 2 (RF_AW + 4*edge + k).
      const float w0 = f[RF_AW + k], w1 = f[RF_AW + 4 + k], w2 = f[RF_AW + 8 + k];
      ch[k] = l0 * w0 + l1 * w1 + l2 * w2;
    }
    float offset = 0.0f;
    float gx[NCH * S <= 32 ? 1 : NCH], gy[NCH * S <= 32 ? 1 : NCH];
    if constexpr (NCH * S <= 32) {
      const int lane = threadIdx.x & 31;
      const int k = min(lane / S, NCH - 1), s = lane % S;
      const float w0 = f[RF_AW + k], w1 = f[RF_AW + 4 + k], w2 = f[RF_AW + 8 + k];
      const float gxk = inv_area * (a0 * w0 + a1 * w1 + a2 * w2);
      const float gyk = inv_area * (b0 * w0 + b1 * w1 + b2 * w2);
      offset = gxk * (a.sample_x[s] - 0.5f) + gyk * (a.sample_y[s] - 0.5f);
    } else {
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const float w0 = f[RF_AW + k], w1 = f[RF_AW + 4 + k], w2 = f[RF_AW + 8 + k];
        gx[k] = inv_area * (a0 * w0 + a1 * w1 + a2 * w2);
        gy[k] = inv_area * (b0 * w0 + b1 * w1 + b2 * w2);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float v[NCH];  // the weights at sample s
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        if constexpr (NCH * S <= 32) {
          v[k] = ch[k] + __shfl_sync(FULL, offset, k * S + s);
        } else {
          const float dx = a.sample_x[s] - 0.5f;
          const float dy = a.sample_y[s] - 0.5f;
          v[k] = ch[k] + (gx[k] * dx + gy[k] * dy);
        }
      }
      bool curve;
      if constexpr (NCH == 3) {
        curve = v[0] * v[0] - v[1] * v[2] <= 0.0f;
      } else {
        curve = v[0] * v[0] * v[0] - v[1] * v[2] * v[3] <= 0.0f;
      }
      keep &= ~((unsigned)!curve << s);
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    bool k = ((keep >> s) & 1u) != 0u;
    if constexpr (CA) k = k && clip[s] == depth;
    wind[s] += k ? contrib : 0;
  }
}

__device__ __forceinline__ int group_of(const int* ii, int n_groups) {
  return min(max(ii[RI_GROUP], 0), n_groups - 1);
}

// A staged row: its class (bits 28-31), whether it is a global row (bit
// 27) and its index in its table (bits 0-26).
constexpr int META_CLASS = 28;
constexpr unsigned META_GLOBAL = 1u << 27;
constexpr unsigned META_ROW = META_GLOBAL - 1u;

// A command's stencil rows of one tile, in the order the block walks
// them: the local stroke rows, the global stroke rows, the local fill
// rows, the global fill rows (each a contiguous run of the tile's
// per-(command, class) ranges, from class range b).  Strokes must precede
// fills: the stroke OR does not commute with a fill's add; within each,
// the order is free.  The stroke runs are empty where `strokes` is false,
// the fill runs where `fills` is.
struct WalkRuns {
  int lo0, lo1, lo2, lo3;      // each run's first row in its table
  int end0, end1, end2, end3;  // the runs' cumulative lengths
};

__device__ __forceinline__ WalkRuns walk_runs(const RasterArgs& a, int t, int b,
                                              bool strokes, bool fills) {
  const size_t n_ranges = (size_t)N_CLASSES * a.n_commands + 1;
  const int* off = a.off + (size_t)t * n_ranges + b;
  const int* g_off = a.g_off + (size_t)t * n_ranges + b;
  WalkRuns w;
  w.lo0 = off[0];
  w.lo1 = g_off[0];
  w.lo2 = off[CLS_FILL_SOLID];
  w.lo3 = g_off[CLS_FILL_SOLID];
  w.end0 = strokes ? w.lo2 - w.lo0 : 0;
  w.end1 = w.end0 + (strokes ? w.lo3 - w.lo1 : 0);
  w.end2 = w.end1 + (fills ? off[N_CLASSES] - w.lo2 : 0);
  w.end3 = w.end2 + (fills ? g_off[N_CLASSES] - w.lo3 : 0);
  return w;
}

// Entry row `row` of tile t, local or global: its floats and its ints.
// The row's index in its table fits an int (a table of 2^31 rows would
// take 256 GiB); an index of 32 bits keeps the walk's registers down.
__device__ __forceinline__ const float* row_f(const RasterArgs& a, int t,
                                              bool global, int row) {
  return global ? a.g_tri_f + (size_t)(t * a.kgp + row) * D_F
                : a.tri_f + (size_t)(t * a.kp + row) * D_F;
}
__device__ __forceinline__ const int* row_i(const RasterArgs& a, int t,
                                            bool global, int row) {
  return global ? a.g_tri_i + (size_t)(t * a.kgp + row) * D_I
                : a.tri_i + (size_t)(t * a.kp + row) * D_I;
}

// The block's shared memory for the stencil walk: the block's and each
// warp's rectangle of pixel centres and the coordinate bound (raster_item
// writes them per item; read from here, they hold no register through
// the walk), each chunk's staged rows (their culling boxes and metas, and
// their count), and each warp's hit list.
struct WalkShared {
  float4 box[CHUNK];
  float4 slab;
  float4 wrect[BLOCK / 32];
  unsigned meta[CHUNK];
  unsigned hits[BLOCK / 32][CHUNK];
  float coord;
  int count;
};

// Stage virtual rows [base, base + CHUNK) of command range b's walk (warp
// 0 alone, two rows a lane): each row's culling box is tested against the
// block's rectangle of pixel centres, and the rows that meet it enter
// `sh` in the walk's order (a ballot and a prefix of __popc), with their
// boxes, classes and places.  Called between the chunk's two barriers.
__device__ __forceinline__ void stage_chunk(const RasterArgs& a, int t, int b,
                                            bool strokes, bool fills, int base,
                                            WalkShared& sh) {
  const WalkRuns w = walk_runs(a, t, b, strokes, fills);
  const float4 slab = sh.slab;
  const float coord = sh.coord;
  const int lane = threadIdx.x;
  int kept = 0;
#pragma unroll 1
  for (int half = 0; half < CHUNK / 32; ++half) {
    const int v = base + half * 32 + lane;
    bool keep = false;
    float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    unsigned meta = 0u;
    if (v < w.end3) {
      // Which run v lies in, and its row there.
      int lo = w.lo0, start = 0;
      bool global = false;
      if (v >= w.end0) { lo = w.lo1; start = w.end0; global = true; }
      if (v >= w.end1) { lo = w.lo2; start = w.end1; global = false; }
      if (v >= w.end2) { lo = w.lo3; start = w.end2; global = true; }
      const int row = lo + (v - start);
      box = cull_box(row_f(a, t, global, row), coord);
      keep = box_meets(box, slab);
      meta = ((unsigned)row_i(a, t, global, row)[RI_CLASS] << META_CLASS) |
             (global ? META_GLOBAL : 0u) | (unsigned)row;
    }
    const unsigned m = __ballot_sync(FULL, keep);
    if (keep) {
      const int at = kept + __popc(m & lanes_below());
      sh.box[at] = box;
      sh.meta[at] = meta;
    }
    kept += __popc(m);
  }
  if (lane == 0) sh.count = kept;
}

// One command's stencil walk on this block (tile t, command range b):
// its rows (walk_runs) staged CHUNK at a time and compacted per block
// (stage_chunk); then each warp tests the staged boxes 32 at a time, lane
// j box j, against its own rectangle of pixel centres (the bounds of its
// 32 pixels; and a stroke row against the edge reject), lists
// its hits in order, and walks the list: a stroke entry ORs into the
// winding (a covered sample whose winding is 0, and, with clip ops,
// whose clip counter equals the command's depth, ends at 1), a fill
// entry adds its contribution.  The runs are uniform over the block, so
// every thread meets every barrier; a warp that the clip vote ruled out
// (live false) walks no entry.
template <int S, bool CA, bool STROKES>
__device__ __forceinline__ void stencil_walk(const RasterArgs& a, int t, int b,
                                             bool strokes, bool fills, float pxc,
                                             float pyc, int (&wind)[S],
                                             const int (&clip)[CA ? S : 1],
                                             int depth, bool live,
                                             WalkShared& sh,
                                             const float* sdx, const float* sdy,
                                             Laps& laps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* hits = sh.hits[warp];
  const WalkRuns runs = walk_runs(a, t, b, strokes, fills);
  const int n_rows = runs.end3, n_strokes = runs.end1;
  for (int base = 0; base < n_rows; base += CHUNK) {
    __syncthreads();  // the previous chunk has been walked
    if (threadIdx.x < 32) stage_chunk(a, t, b, strokes, fills, base, sh);
    __syncthreads();
    const int body = base < n_strokes ? BODY_STROKE : BODY_FILL;
    if (!live) {
      laps.lap(body);
      continue;
    }
    // The warp's hit list.  n is uniform over the block; the OR leaves it
    // in a uniform register.
    const int n = (int)__reduce_or_sync(FULL, (unsigned)sh.count);
    const float4 wrect = sh.wrect[warp];
    int n_hits = 0;
    for (int k0 = 0; k0 < n; k0 += 32) {
      const int k = k0 + lane;
      bool hit = false;
      unsigned meta = 0u;
      if (k < n) {
        meta = sh.meta[k];
        hit = box_meets(sh.box[k], wrect);
        if constexpr (STROKES) {
          if (hit && (int)(meta >> META_CLASS) < CLS_FILL_SOLID) {
            hit = !edge_reject(
                row_f(a, t, (meta & META_GLOBAL) != 0u, (int)(meta & META_ROW)),
                wrect, sh.coord);
          }
        }
      }
      const unsigned m = __ballot_sync(FULL, hit);
      if (hit) hits[n_hits + __popc(m & lanes_below())] = meta;
      n_hits += __popc(m);
    }
    __syncwarp();
    laps.lap(body);
    for (int h = 0; h < n_hits; ++h) {
      // Uniform over the warp: the OR leaves it in a uniform register, so
      // the switch below never diverges.
      const unsigned meta = __reduce_or_sync(FULL, hits[h]);
      const int cls = (int)(meta >> META_CLASS);
      const bool global = (meta & META_GLOBAL) != 0u;
      const int row = (int)(meta & META_ROW);
      const float* f = row_f(a, t, global, row);
      const int* ii = row_i(a, t, global, row);
      if constexpr (STROKES) {
        if (cls < CLS_FILL_SOLID) {
          const int g = group_of(ii, a.n_groups);
          const float* df = a.desc_f + (size_t)g * DESC_F;
          const int* di = a.desc_i + (size_t)g * DESC_I;
          const int flags = ii[RI_FLAGS];
          unsigned bits = 0u;
          switch (cls) {
#define STROKE_CLASS(CODE, JOINT, DASH)                                        \
  case CODE:                                                                   \
    bits = stroke_cover<JOINT, DASH, S>(f, flags, df, di, pxc, pyc, sdx, sdy); \
    break;
            STROKE_CLASS(CLS_LINE_SOLID, false, 0)
            STROKE_CLASS(CLS_LINE_SOLID + 1, false, 1)
            STROKE_CLASS(CLS_LINE_SOLID + 2, false, 2)
            STROKE_CLASS(CLS_JOINT_SOLID, true, 0)
            STROKE_CLASS(CLS_JOINT_SOLID + 1, true, 1)
            STROKE_CLASS(CLS_JOINT_SOLID + 2, true, 2)
#undef STROKE_CLASS
            default: break;
          }
#pragma unroll
          for (int s = 0; s < S; ++s) {
            bool cov = ((bits >> s) & 1u) != 0;
            if constexpr (CA) cov = cov & (clip[s] == depth);
            wind[s] = (cov & (wind[s] == 0)) ? 1 : wind[s];
          }
          laps.lap(BODY_STROKE);
          continue;
        }
      }
      const int contrib = ii[RI_CONTRIB], flags = ii[RI_FLAGS];
      const WarpRow fr{f[lane]};
      switch (cls) {
        case CLS_FILL_SOLID:
          fill_entry<S, CA, 0>(fr, contrib, flags, pxc, pyc, a, wind, clip, depth);
          break;
        case CLS_FILL_QUAD:
          fill_entry<S, CA, 3>(fr, contrib, flags, pxc, pyc, a, wind, clip, depth);
          break;
        case CLS_FILL_CUBIC:
          fill_entry<S, CA, 4>(fr, contrib, flags, pxc, pyc, a, wind, clip, depth);
          break;
        default: break;
      }
      laps.lap(BODY_FILL);
    }
  }
}

// Whether some lane of the warp has a sample whose clip counter equals
// `depth`: the clip test that masks every stencil update, colour cover
// and alpha op of a command at that depth.  The OR over the warp
// (__reduce_or_sync) lies in a uniform register, so a branch on it never
// diverges.  All 32 lanes must call it together.
// The premultiplied source colour of a cover draw's paint at one sample
// (px, py): `solid` for paint code 0; else the gradient (1 linear, 2
// radial; `g` its gradient_constants) or user paint (3 + i; `pxy` its
// paint points) of the draw, premultiplied.
template <int PAINT>
__device__ __forceinline__ void paint_src(int pk, const float* g,
                                          const float* pxy,
                                          const float (&solid)[4], float px,
                                          float py, float (&src)[4]) {
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) src[ch] = solid[ch];
  if constexpr (PAINT > 0) {
    if (pk != 0) {
      // Straight RGBA of the paint at the sample, premultiplied.
      float rgba[4];
#if RASTER_PAINT == 2
      if (pk >= 3) {
        const float4 u = user_paint(pk - 3, px, py, pxy[0], pxy[1], pxy[2], pxy[3]);
        rgba[0] = u.x;
        rgba[1] = u.y;
        rgba[2] = u.z;
        rgba[3] = u.w;
      } else
#endif
        gradient_paint(g, pk == PAINT_RADIAL, px, py, rgba);
      src[0] = rgba[0] * rgba[3];
      src[1] = rgba[1] * rgba[3];
      src[2] = rgba[2] * rgba[3];
      src[3] = rgba[3];
    }
  }
}

// Blend `src` into sample s of the pixel's colour; k is the blend
// constant (cmd_f columns 20:24).
template <int S, class Blend>
__device__ __forceinline__ void blend_sample(const Blend& blend,
                                             const float (&src)[4],
                                             float (&color)[4][S], int s,
                                             const float* k) {
  const float da = color[3][s];
#pragma unroll
  for (int chan = 0; chan < 4; ++chan)
    color[chan][s] = blend(chan, src[chan], color[chan][s], src[3], da, k);
}

// The subtractive build skips body `body`: a condition true at run time
// there but unknown to the compiler (n_tiles > 0 is checked at launch),
// so the skipped body's code, and the state it reads, stay compiled.
__device__ __forceinline__ bool omitted(int body, const RasterArgs& a) {
  return OMIT == body && a.n_tiles > 0;
}

// Sample s of the pixel whose centre is (pxc, pyc): pxc + (sample_x[s]
// - 0.5), which rounds as the pixel's corner plus sample_x[s] does (both
// terms are exact).
__device__ __forceinline__ float sample_px(const RasterArgs& a, float pxc, int s) {
  return pxc + (a.sample_x[s] - 0.5f);
}
__device__ __forceinline__ float sample_py(const RasterArgs& a, float pyc, int s) {
  return pyc + (a.sample_y[s] - 0.5f);
}

// The index of pixel (ix, iy) in the frame's (height, width) pixels; -1
// on the padding past the frame's last column or row, which is walked but
// not written.  A warp's row is 8 neighbouring pixels of one frame row:
// one 128-byte run of float4, or 32 bytes of packed RGBA8.
__device__ __forceinline__ long long pixel_index(const RasterArgs& a, int ix,
                                                 int iy) {
  return ix < a.width && iy < a.height ? (long long)iy * a.width + ix : -1;
}

template <int S>
__device__ __forceinline__ bool warp_at_depth(const int (&clip)[S], int depth) {
  unsigned at = 0u;
#pragma unroll
  for (int s = 0; s < S; ++s) at |= (unsigned)(clip[s] == depth);
  return __reduce_or_sync(FULL, at) != 0u;
}

// The colour cover's sample loop, for the samples set in `cover`: the
// paint (premultiplied; `g` a gradient's constants), the blend, the
// winding reset and, with depth write, the depth write.  The profiling build runs the paint and the
// blend as two loops, with a lap after each.
template <int S, bool DEPTH, int PAINT, class Blend>
__device__ __forceinline__ void cover_samples(
    const RasterArgs& a, const Blend& blend, unsigned cover, int pk,
    const float* cf, const float* g, const float* pxy, const float (&solid)[4], float pxc,
    float pyc, float (&color)[4][S], int (&wind)[S], float (&zbuf)[DEPTH ? S : 1],
    const float (&zv)[DEPTH ? S : 1], Laps& laps) {
  if (omitted(BODY_PAINT, a)) pk = 0;
  if constexpr (PROFILE) {
    float src[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (((cover >> s) & 1u) == 0u) continue;
      paint_src<PAINT>(pk, g, pxy, solid, sample_px(a, pxc, s), sample_py(a, pyc, s),
                       src[s]);
    }
    laps.lap(BODY_PAINT);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (((cover >> s) & 1u) == 0u) continue;
      blend_sample<S>(blend, src[s], color, s, cf + 20);
      wind[s] = 0;
      if constexpr (DEPTH) {
        if (a.depth_write) zbuf[s] = zv[s];
      }
    }
    laps.lap(BODY_BLEND);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (((cover >> s) & 1u) == 0u) continue;
      float src[4];
      paint_src<PAINT>(pk, g, pxy, solid, sample_px(a, pxc, s), sample_py(a, pyc, s),
                       src);
      if (!omitted(BODY_BLEND, a)) blend_sample<S>(blend, src, color, s, cf + 20);
      wind[s] = 0;
      if constexpr (DEPTH) {
        if (a.depth_write) zbuf[s] = zv[s];
      }
    }
  }
}

// The work of one block on one item: tile t, and its slab (4 rows x 64
// lanes).  NL < 0: no clip or alpha ops in the frame; NL = 1: clip
// counters and one alpha layer in registers; NL = 0: clip counters, and
// alpha layers (if any) in `slots`, this thread's slot (j, s) at
// slots[(j * S + s) * BLOCK] (shared memory, or the block's slice of the
// global scratch; null without alpha ops).  STROKES: the frame has
// stroke rows (without, the stroke classes compile out and leave the
// fill path's registers alone).  DEPTH: the colour cover tests (and may
// write) S depth values per pixel.  PAINT: 0 solid colour only; 1
// gradients; 2 gradients and user paints.  Every thread of the block
// calls it with the same item.
template <int S, int NL, bool STROKES, bool DEPTH, int PAINT>
__device__ __forceinline__ void raster_item(const RasterArgs& a, int t, int slab_i,
                                            float* slots, WalkShared& sh,
                                            const float* sdx, const float* sdy,
                                            unsigned long long* sprof,
                                            float* sgrad) {
  constexpr bool CA = NL >= 0;
  Laps laps{sprof, 0};
  laps.start();
  // The slab's warp w is the 4 rows x 8 lanes from lane 8w
  // (ops/coverage.py::warp_pixels).
  const int q = threadIdx.x & 31, blocks_x = a.tw / 64;
  const int r0 = (slab_i / blocks_x) * 4, l0 = (slab_i % blocks_x) * 64;
  const int r = r0 + (q >> 3);
  const int l = l0 + (threadIdx.x >> 5) * 8 + (q & 7);
  // Strip layout: lane l of row r is screen pixel
  // (x0 + l % lw, y0 + (l / lw) * th + r).
  int ix, iy;
  if (a.strips == 1) {
    ix = l;
    iy = r;
  } else {
    ix = l % a.lw;
    iy = (l / a.lw) * a.th + r;
  }
  ix += (t % a.ntx) * a.lw;
  iy += (t / a.ntx) * a.lh;
  const int n_active = a.acount[t];
  if (n_active == 0) {  // empty tile: transparent black
    if (omitted(BODY_EMPTY, a)) return;
    const long long at = pixel_index(a, ix, iy);
    if (at >= 0) {
      if (a.out_u8)
        static_cast<uint32_t*>(a.out)[at] = 0u;
      else
        static_cast<float4*>(a.out)[at] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    laps.lap(BODY_EMPTY);
    return;
  }

  // The pixel's centre.  A sample's position is pxc + (sample_x - 0.5):
  // both terms are exact, so it rounds as (float)ix + sample_x does.  The
  // kernel keeps only the centre: every register the walk's fill entries
  // do not need is one the capped fill build does not spill.
  const float pxc = (float)ix + 0.5f;
  const float pyc = (float)iy + 0.5f;
  // The block's rectangle of pixel centres, which the stencil walk's
  // staging culls by (block_rects in ops/coverage.py; with strips
  // narrower than its 64 lanes, it spans several strips), and `coord`,
  // a bound on every pixel coordinate of the grid (cull_box, the edge
  // reject).  Thread 0 writes them, and lane 0 of each warp its warp's
  // rectangle; they are read after the walk's first barrier.
  if (threadIdx.x == 0) {
    const int tile_x = (t % a.ntx) * a.lw, tile_y = (t / a.ntx) * a.lh;
    const int slab_x = l0 % a.lw;
    sh.slab = make_float4(
        (float)(tile_x + slab_x) + 0.5f,
        (float)(tile_y + (l0 / a.lw) * a.th + r0) + 0.5f,
        (float)(tile_x + slab_x + min(a.lw, 64) - 1) + 0.5f,
        (float)(tile_y + ((l0 + 63) / a.lw) * a.th + r0 + 3) + 0.5f);
    sh.coord = (float)(a.ntx * a.lw + (a.n_tiles / a.ntx) * a.lh + 1);
  }
  // The warp's rectangle: the least and greatest of its pixels
  // (warp_rects in ops/coverage.py).  Where a strip is 8 or more pixels
  // wide they are 8 x 4 from lane 0's; in a narrower strip the warp's 8
  // lanes span several strips, th rows apart.
  {
    const int x_lo = __reduce_min_sync(FULL, ix), x_hi = __reduce_max_sync(FULL, ix);
    const int y_lo = __reduce_min_sync(FULL, iy), y_hi = __reduce_max_sync(FULL, iy);
    if (q == 0)
      sh.wrect[threadIdx.x >> 5] =
          make_float4((float)x_lo + 0.5f, (float)y_lo + 0.5f, (float)x_hi + 0.5f,
                      (float)y_hi + 0.5f);
  }

  int wind[S];
  float color[4][S];
  int clip[CA ? S : 1];
  float layer[NL > 0 ? NL : 1][S];
  // The reference render pass clears depth to 1.0.
  float zbuf[DEPTH ? S : 1];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    wind[s] = 0;
    if constexpr (DEPTH) zbuf[s] = 1.0f;
#pragma unroll
    for (int chan = 0; chan < 4; ++chan) color[chan][s] = 0.0f;
    if constexpr (CA) clip[s] = 0;
#pragma unroll
    for (int j = 0; j < (NL > 0 ? NL : 1); ++j) layer[j][s] = 0.0f;
  }
  // Layer slots (NL = 0), zeroed per tile as the reference's are per
  // grid step.
  if constexpr (NL == 0) {
    if (slots != nullptr) {
      for (int j = 0; j < a.n_layers; ++j)
#pragma unroll
        for (int s = 0; s < S; ++s) slots[(j * S + s) * BLOCK] = 0.0f;
    }
  }

  for (int k = 0; k < n_active; ++k) {
    const int uid = a.aclist[(size_t)t * a.n_units + k];
    const int c = a.unit_cmd[uid];
    const int d = a.unit_draw[uid];
    const int op = a.cmd_i[c * 4];
    const int depth = a.cmd_i[c * 4 + 1];
    // Without clip ops the clip counters are identically zero: commands
    // at a nonzero clip depth are no-ops.
    if (!a.has_clip && depth != 0) {
      laps.lap(BODY_SETUP);
      continue;
    }
    // The clip vote: every op but clip and unclip masks each sample with
    // clip[s] == depth, so a warp none of whose samples passes that test
    // has nothing to do for the unit.  Warp-uniform (see warp_at_depth).
    bool live = true;
    if constexpr (CA) {
      if (op != OP_CLIP && op != OP_UNCLIP) live = warp_at_depth<S>(clip, depth);
    }
    laps.lap(BODY_SETUP);

    if (op == OP_STENCIL) {
      // The stroke rows, then the fill rows, in one staged walk.  A warp
      // the clip vote ruled out still meets every barrier of the walk,
      // but walks no entry.
      const bool fills = !omitted(BODY_FILL, a);
      stencil_walk<S, CA, STROKES>(a, t, N_CLASSES * c,
                                   STROKES && !omitted(BODY_STROKE, a), fills,
                                   pxc, pyc, wind, clip, depth, live, sh, sdx,
                                   sdy, laps);
      if (!fills) continue;
      if (live) {
        const int bulk = a.bulk[(size_t)t * a.n_commands + c];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          bool ok = true;
          if constexpr (CA) ok = clip[s] == depth;
          wind[s] += ok ? bulk : 0;
        }
      }
      laps.lap(BODY_FILL);
      continue;
    }
    if (!live) continue;

    const int cl = a.cls[(size_t)t * a.n_draws + d];
    laps.lap(BODY_SETUP);
    if (cl == 0) continue;
    if (!CA && op != OP_COLOR) continue;
    bool in_hull[S];
#pragma unroll
    for (int s = 0; s < S; ++s) in_hull[s] = true;
    if (cl == 1 && !omitted(BODY_HULL, a)) {  // boundary tile: only the hull lines crossing it
      const unsigned bits = (unsigned)a.hbits[(size_t)t * a.n_draws + d];
      const float* lines = a.hull + (size_t)d * a.hull_rows * 4;
      for (int h = 0; h < a.hull_rows; ++h) {
        if (((bits >> h) & 1u) == 0) continue;
        const float h0 = lines[4 * h], h1 = lines[4 * h + 1],
                    h2 = lines[4 * h + 2];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float he = h0 * sample_px(a, pxc, s) + h1 * sample_py(a, pyc, s) + h2;
          in_hull[s] = in_hull[s] && he >= 0.0f;
        }
      }
    }
    const float* cf = a.cmd_f + (size_t)d * a.draw_cols;
    const float ca = cf[3];
    laps.lap(BODY_HULL);

    if (op == OP_COLOR) {
      // A solid colour (paint code 0) is premultiplied once per draw,
      // outside the sample loop (inside it, fill-only frames ran 3% slower);
      // other paints premultiply per sample.
      const float solid[4] = {cf[0] * ca, cf[1] * ca, cf[2] * ca, ca};
      // Fragment depth: the draw's plane at each sample, (a*px + b*py) + c;
      // the stencil pass op fires only where depth passes too, so the
      // winding reset below takes the combined mask (depth_fail_op Keep).
      float zv[DEPTH ? S : 1];
      unsigned zpass = ~0u;
      if constexpr (DEPTH) {
        const float* zp = a.zplane + (size_t)d * 3;
        const float za = zp[0], zb = zp[1], zc = zp[2];
#pragma unroll
        for (int s = 0; s < S; ++s)
          zv[s] = za * sample_px(a, pxc, s) + zb * sample_py(a, pyc, s) + zc;
        if (!omitted(BODY_DEPTH, a)) zpass = depth_pass<S>(a.depth_compare, zv, zbuf);
      }
      unsigned cover = 0u;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        bool mask = in_hull[s] && (wind[s] & a.winding_mask) != 0;
        if constexpr (CA) mask = mask && clip[s] == depth;
        if constexpr (DEPTH) mask = mask && ((zpass >> s) & 1u) != 0;
        cover |= (unsigned)mask << s;
      }
      laps.lap(BODY_DEPTH);
      // The cover vote: the paint, the blend, the winding reset and the
      // depth write all take this mask, so a warp in which no lane has a
      // sample that passes would change nothing and skips them.  The OR
      // lies in a uniform register (see stencil_walk).
      if (__reduce_or_sync(FULL, cover) == 0u) continue;
      // Paint code: 0 solid, 1 linear, 2 radial, 3 + i user paint i.
      const int pk = PAINT > 0 ? a.cmd_i[c * 4 + 3] : 0;
      const float* pxy = a.paint_xy + (size_t)d * 4;
      const float* g = nullptr;
      if constexpr (PAINT > 0) {
        if (pk == PAINT_LINEAR || pk == PAINT_RADIAL) {
          // The warp computes the draw's gradient constants once, a value
          // per lane, into its slot (the warp is converged here).
          float* slot = sgrad + (threadIdx.x & ~31);
          __syncwarp();  // the previous unit's reads are done
          gradient_constants(cf, pxy, threadIdx.x & 31, slot);
          __syncwarp();
          g = slot;
        }
      }
      // The blend state is uniform over the grid: one switch per unit,
      // outside the sample loop.
#define COVER(BLEND)                                                           \
  cover_samples<S, DEPTH, PAINT>(a, BLEND, cover, pk, cf, g, pxy, solid, pxc, pyc, \
                                 color, wind, zbuf, zv, laps)
      switch (a.blend_kind) {
        case BLEND_BACK_TO_FRONT: COVER(BlendBackToFront{}); break;
        case BLEND_FRONT_TO_BACK: COVER(BlendFrontToBack{}); break;
        case BLEND_ADDITIVE: COVER(BlendAdditive{}); break;
        default:
          COVER((BlendGeneric{a.color_src, a.color_op, a.color_dst, a.alpha_src,
                              a.alpha_op, a.alpha_dst}));
      }
#undef COVER
      continue;
    }

    if constexpr (CA) {
      if (omitted(BODY_CLIP_ALPHA, a)) continue;
      if (op == OP_CLIP || op == OP_UNCLIP) {
        // Clip promotes winding != 0 into the clip counter
        // (renderer.rs:692-710); unclip demotes deeper samples
        // (renderer.rs:711-729).  Neither is gated by the clip test.
        const bool promote = op == OP_CLIP;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const bool mask =
              in_hull[s] && (promote ? (wind[s] & a.winding_mask) != 0
                                     : clip[s] > depth);
          clip[s] = mask ? depth : clip[s];
          wind[s] = mask ? 0 : wind[s];
        }
        laps.lap(BODY_CLIP_ALPHA);
        continue;
      }
      if (op < OP_SAVE_ALPHA || op > OP_SAVE_SCALE) continue;
      // An alpha op changes only the samples inside its hull that pass
      // the clip test: a warp with none skips it, so that scale and
      // restore do not rewrite colour[3] with itself and a save to the
      // slots is not issued.  Warp-uniform, as the clip vote.
      unsigned hit = 0u;
#pragma unroll
      for (int s = 0; s < S; ++s) hit |= (unsigned)(in_hull[s] && clip[s] == depth);
      if (__reduce_or_sync(FULL, hit) == 0u) {
        laps.lap(BODY_CLIP_ALPHA);
        continue;
      }
      // Alpha-group ops on layer li (renderer.rs:756-861): save copies
      // frame alpha into the layer, scale sets (1 - g) + g * alpha,
      // restore subtracts (1 - saved) * (1 - g); save+scale is save then
      // scale over one mask.  _validate bounds the layer; the clamp keeps
      // an unvalidated one inside the state.
      const int li = min(max(a.cmd_i[c * 4 + 2], 0), a.n_layers - 1);
      const bool save = op == OP_SAVE_ALPHA || op == OP_SAVE_SCALE;
      const bool scale = op == OP_SCALE_ALPHA || op == OP_SAVE_SCALE;
      const bool restore = op == OP_RESTORE_ALPHA;
      float* layer_slots = NL == 0 ? slots + li * S * BLOCK : nullptr;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool mask = in_hull[s] && clip[s] == depth;
        const float a0 = color[3][s];
        if (save) {
          if constexpr (NL > 0) {
#pragma unroll
            for (int j = 0; j < NL; ++j)
              layer[j][s] = (mask && j == li) ? a0 : layer[j][s];
          } else if (mask) {
            layer_slots[s * BLOCK] = a0;
          }
        }
        if (scale) color[3][s] = mask ? (1.0f - ca) + ca * a0 : a0;
        if (restore) {
          float saved = 0.0f;
          if constexpr (NL > 0) {
#pragma unroll
            for (int j = 0; j < NL; ++j) saved = j == li ? layer[j][s] : saved;
          } else {
            saved = layer_slots[s * BLOCK];
          }
          color[3][s] = mask ? a0 - (1.0f - saved) * (1.0f - ca) : a0;
        }
      }
      laps.lap(BODY_CLIP_ALPHA);
    }
  }

  if (omitted(BODY_RESOLVE, a)) return;
  // Resolve: the sample mean, summed in sample order, written at the
  // pixel's place in the frame.
  const long long at = pixel_index(a, (int)(pxc - 0.5f), (int)(pyc - 0.5f));
  const float inv_s = 1.0f / (float)S;
  float mean[4];
#pragma unroll
  for (int chan = 0; chan < 4; ++chan) {
    float v = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) v = v + color[chan][s];
    mean[chan] = v * inv_s;
  }
  if (at >= 0) {
    if (a.out_u8) {
      // floor(clip(v) * 255 + 0.5), packed little-endian RGBA8 in uint32
      // (A << 24 would overflow an int32).
      uint32_t packed = 0;
#pragma unroll
      for (int chan = 0; chan < 4; ++chan)
        packed |= (uint32_t)floorf(fminf(fmaxf(mean[chan], 0.0f), 1.0f) * 255.0f + 0.5f)
                  << (8 * chan);
      static_cast<uint32_t*>(a.out)[at] = packed;
    } else {
      static_cast<float4*>(a.out)[at] = make_float4(mean[0], mean[1], mean[2], mean[3]);
    }
  }
  laps.lap(BODY_RESOLVE);
}

// The kernel's body.  NL, STROKES, DEPTH and PAINT as for raster_item.
// Layer modes -1 and 1 run on a (tiles, slabs) grid, one item per block.
// Layer mode 0 runs on a 1-D grid of (tile, slab) items, tile fastest
// (the order in which the 2-D grid's blocks are issued): with its alpha
// layers in dynamic shared memory (or without alpha ops) one item per
// block; with them in the global scratch (a.layers), a grid of the
// blocks that can be resident at once, each walking items in a loop with
// its own slice of the scratch.
template <int S, int NL, bool STROKES, bool DEPTH, int PAINT>
__device__ __forceinline__ void raster_blocks(const RasterArgs& a) {
  __shared__ WalkShared sh;
  __shared__ float sdx[MAX_SAMPLES], sdy[MAX_SAMPLES];
  // Sample offsets from the pixel centre, for the rolled stroke loops; the
  // first staging barrier orders these writes before any read.
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sdx[s] = a.sample_x[s] - 0.5f;
      sdy[s] = a.sample_y[s] - 0.5f;
    }
  }
  // Each warp's gradient constants (gradient_constants).
  __shared__ float sgrad[PAINT > 0 ? BLOCK : 1];
  // The profiling build's per-block body counters.
  __shared__ unsigned long long sprof[PROFILE ? N_BODIES : 1];
  if constexpr (PROFILE) {
    if (threadIdx.x < N_BODIES) sprof[threadIdx.x] = 0ull;
    __syncthreads();
  }
  if constexpr (NL == 0) {
    extern __shared__ float layer_smem[];
    float* slots = a.layers != nullptr
                       ? a.layers + (size_t)blockIdx.x * a.n_layers * S * BLOCK +
                             threadIdx.x
                   : a.has_alpha ? layer_smem + threadIdx.x
                                 : nullptr;
    const int n_items = a.n_tiles * (a.th * a.tw / BLOCK);
    for (int item = blockIdx.x; item < n_items; item += gridDim.x)
      raster_item<S, NL, STROKES, DEPTH, PAINT>(a, item % a.n_tiles,
                                                item / a.n_tiles, slots, sh,
                                                sdx, sdy, sprof, sgrad);
  } else {
    raster_item<S, NL, STROKES, DEPTH, PAINT>(a, blockIdx.x, blockIdx.y,
                                              nullptr, sh, sdx, sdy, sprof,
                                              sgrad);
  }
  if constexpr (PROFILE) {
    __syncthreads();
    if (threadIdx.x < N_BODIES) atomicAdd(a.prof + threadIdx.x, sprof[threadIdx.x]);
  }
}

// The blocks an SM each instantiation is built for: three at S <= 4
// without clip or alpha ops (at most 80 registers a thread), two up to
// S = 8 (128), one at S = 16.  Without a block count ptxas held this
// walk's S = 4 stroke builds to 80 registers and spilled up to 380 B;
// with two it spilled nothing, but put the stroke build with depth at
// 89 registers, two blocks an SM, and the showcase under depth ran at
// 0.41-0.43 ms; with three, at 78 registers, 0.34 ms (chip_ab.py, H100;
// PERF.md lists each build's registers).  Builds with user paints
// (PAINT 2) compile the caller's paint code into the cover, whose
// registers no measurement here bounds: they keep two blocks (128).
template <int S, int NL, bool STROKES, bool DEPTH, int PAINT>
__global__ void __launch_bounds__(BLOCK,
                                  (S <= 4 && NL < 0 && PAINT != 2 ? 3 : S <= 8 ? 2 : 1))
    coverage_raster_kernel(const RasterArgs a) {
  raster_blocks<S, NL, STROKES, DEPTH, PAINT>(a);
}

// Fill-only frames without clip, alpha or depth at S <= 4 (FILL_CAPPED):
// the same body held to 64 registers, so that four blocks (32 warps) fit
// an SM instead of three.  Left to itself, ptxas put this build at 64 or
// 79 registers from one edit of unrelated code to the next; at 79 the
// gradient card ran 9% slower than at 64 (chip_ab.py, H100, PERF.md).
// Since fill rows are read through shuffles (WarpRow) it spills
// nothing.  Builds with depth spilled more under it (188 B) and are
// not capped.
template <int S, int PAINT>
__global__ void __launch_bounds__(BLOCK, 4)
    coverage_raster_fill_kernel(const RasterArgs a) {
  raster_blocks<S, -1, false, false, PAINT>(a);
}

constexpr bool BUILD_DEPTH = RASTER_DEPTH != 0;
constexpr int BUILD_PAINT = RASTER_PAINT;

// Bytes of shared memory that layer mode 0 keeps its alpha layers in: L*S
// floats for each of the block's pixels.
size_t layer_smem_bytes(const RasterArgs& a) {
  return sizeof(float) * (size_t)a.n_layers * a.samples * BLOCK;
}

// The global scratch's block count for a frame whose alpha layers do
// not fit shared memory (layer mode 0 with alpha ops), else 0: the blocks
// of that instantiation that can be resident at once on the current
// device.
template <int S, bool STROKES>
cudaError_t layer_blocks(const RasterArgs& a, int* blocks) {
  *blocks = 0;
  if (a.layer_mode != 0 || !a.has_alpha) return cudaSuccess;
  auto* kernel = coverage_raster_kernel<S, 0, STROKES, BUILD_DEPTH, BUILD_PAINT>;
  cudaFuncAttributes attr;
  int dev, optin, sms, per_sm;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (attr.sharedSizeBytes + layer_smem_bytes(a) <= (size_t)optin) return cudaSuccess;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, 0);
  if (err != cudaSuccess) return err;
  *blocks = max(per_sm, 1) * sms;
  return cudaSuccess;
}

template <int S, bool STROKES>
cudaError_t launch_layers(const RasterArgs& a, cudaStream_t stream) {
  constexpr bool DEPTH = BUILD_DEPTH;
  constexpr int PAINT = BUILD_PAINT;
  constexpr bool FILL_CAPPED = S <= 4 && !STROKES && !DEPTH;
  const int slabs = (a.th * a.tw) / BLOCK;
  switch (a.layer_mode) {
    case -1:
      if constexpr (FILL_CAPPED) {
        coverage_raster_fill_kernel<S, PAINT>
            <<<dim3(a.n_tiles, slabs), BLOCK, 0, stream>>>(a);
      } else {
        coverage_raster_kernel<S, -1, STROKES, DEPTH, PAINT>
            <<<dim3(a.n_tiles, slabs), BLOCK, 0, stream>>>(a);
      }
      break;
    case 0: {
      int blocks = a.n_tiles * slabs;
      size_t smem = 0;
      if (a.layers != nullptr) {
        if (a.layer_blocks < 1) return cudaErrorInvalidValue;
        blocks = min(blocks, a.layer_blocks);
      } else if (a.has_alpha) {
        int need = 0;
        const cudaError_t err = layer_blocks<S, STROKES>(a, &need);
        if (err != cudaSuccess) return err;
        // Layers past shared memory need the wrapper's global scratch.
        if (need != 0) return cudaErrorInvalidValue;
        smem = layer_smem_bytes(a);
        // Past 48 KiB of static and dynamic shared memory together, a
        // launch needs the opt-in; set it for every launch with layers.
        const cudaError_t set = cudaFuncSetAttribute(
            coverage_raster_kernel<S, 0, STROKES, DEPTH, PAINT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (set != cudaSuccess) return set;
      }
      coverage_raster_kernel<S, 0, STROKES, DEPTH, PAINT>
          <<<blocks, BLOCK, smem, stream>>>(a);
      break;
    }
    case 1:
      coverage_raster_kernel<S, 1, STROKES, DEPTH, PAINT>
          <<<dim3(a.n_tiles, slabs), BLOCK, 0, stream>>>(a);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// One build holds the six instantiations (three layer modes, with and
// without strokes) of the sample count RASTER_SAMPLES and the feature set
// of RASTER_DEPTH and RASTER_PAINT; ops/coverage.py::build_kernel builds
// and loads one per feature set a frame needs.
#ifndef RASTER_SAMPLES
#error "build with -DRASTER_SAMPLES=S (1, 2, 4, 8 or 16)"
#endif

// Launches on `stream`; allocates nothing and does not synchronise.
// Returns the cudaError_t of the launch: 0 if and only if the kernel was
// launched, so the caller counts a launch exactly when this returns 0.
extern "C" int coverage_raster_launch(const RasterArgs* args, void* stream) {
  const RasterArgs& a = *args;
  // a.layers is null or a scratch of a.layer_blocks slices (see
  // coverage_raster_layer_blocks).
  if (a.n_tiles <= 0 || a.th % 4 != 0 || a.tw % 64 != 0 || a.width <= 0 ||
      a.height <= 0 || a.width > a.ntx * a.lw ||
      a.height > (a.n_tiles / a.ntx) * a.lh ||
      a.th * a.tw / BLOCK > 65535 || a.n_groups < 1 || a.n_layers < 1 ||
      (a.layer_mode > 0 && a.n_layers > a.layer_mode) ||
      a.samples != RASTER_SAMPLES || (PROFILE && a.prof == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a.has_strokes ? launch_layers<RASTER_SAMPLES, true>(a, s)
                             : launch_layers<RASTER_SAMPLES, false>(a, s));
}

// The number of blocks whose slices the global layer scratch of this
// frame needs (`a.layers`: blocks * L * S * 256 floats), into *blocks:
// 0 where the frame keeps its alpha layers in registers or in shared
// memory, or has none.  Returns the cudaError_t of the queries.
extern "C" int coverage_raster_layer_blocks(const RasterArgs* args, int* blocks) {
  const RasterArgs& a = *args;
  *blocks = 0;
  if (a.samples != RASTER_SAMPLES) return (int)cudaErrorInvalidValue;
  return (int)(a.has_strokes ? layer_blocks<RASTER_SAMPLES, true>(a, blocks)
                             : layer_blocks<RASTER_SAMPLES, false>(a, blocks));
}
