"""Tiled fill rasterization: triangle tables → per-sample winding.

The port's counterpart of ``contrast_renderer_tpu/ops/raster.py``, the
standalone replacement for the reference's stencil pass
(src/renderer.rs:571-690, src/shaders.wgsl:233-266).  The JAX module is
plain XLA with no Pallas kernel, and this one is plain torch, run
eagerly on the device of its inputs:

1. transform triangles by the instance matrix (explicit float32
   multiply-adds, never a TF32 matmul),
2. compute per-triangle edge and attribute-interpolation coefficients,
3. bin triangles to pixel tiles by AABB overlap,
4. accumulate, per tile, a per-sample winding count: each fill triangle
   contributes sign(NDC area) where the sample is inside and the
   implicit-curve predicate of its kind holds.

Everything is static-shaped: per-tile triangle lists have a fixed
capacity, and overflow is reported (``max_count``) for the host to
retry with a larger one.  Tiles are walked in chunks whose size follows
from the capacity (``tile_chunk``), so memory stays bounded at any
frame size.

Pixel space is y-down image coordinates; NDC is y-up;
``px = (ndc_x+1)/2·W``, ``py = (1-ndc_y)/2·H``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..vertex import (  # noqa: F401  (the JAX module's names)
    KIND_INTEGRAL_CUBIC,
    KIND_INTEGRAL_QUADRATIC,
    KIND_RATIONAL_CUBIC,
    KIND_RATIONAL_QUADRATIC,
    KIND_SOLID,
    KIND_STROKE_JOINT,
    KIND_STROKE_LINE,
)

#: Standard 4x MSAA sample offsets within a pixel (x, y), y-down
#: (matches oracle.MSAA4).
MSAA4 = np.array(
    [[0.375, 0.125], [0.875, 0.375], [0.125, 0.625], [0.625, 0.875]],
    dtype=np.float32,
)
MSAA1 = np.array([[0.5, 0.5]], dtype=np.float32)

#: Device memory one chunk of tiles may take: the per-(sample, slot)
#: temporaries of the winding pass, TILE_PAIR_BYTES each.
CHUNK_BYTES = 1 << 30
#: Bytes per (sample, triangle slot) pair live at once in a chunk: the
#: three barycentrics, four interpolated channels, an edge value and
#: the int32 contribution (nine 4-byte values), and three masks.
TILE_PAIR_BYTES = 9 * 4 + 3


class TriangleSetup(NamedTuple):
    """Per-triangle screen-space coefficients (all leading dim T), as
    tensors on one device.

    Edge/barycentric lines are stored origin-relative — evaluated as
    ``a*(px - ox) + b*(py - oy)`` with the origin at one of the edge's
    own endpoints — so float32 evaluation at large pixel coordinates
    stays well conditioned.
    """

    edge: torch.Tensor  # (T, 3, 4) oriented edges (a, b, ox, oy); e ≥ 0 inside
    edge_top_left: torch.Tensor  # (T, 3) bool: edge uses ≥ (top-left) vs >
    bary: torch.Tensor  # (T, 3, 4) barycentric edges (a, b, ox, oy) / area
    aux_w: torch.Tensor  # (T, 3, 4) per-vertex aux * inv_w
    inv_w: torch.Tensor  # (T, 3)
    kind: torch.Tensor  # (T,) int32
    contribution: torch.Tensor  # (T,) int32 winding increment (0 if degenerate)
    meta: torch.Tensor  # (T, 2) f32 stroke group/flags, end texcoord y
    aabb: torch.Tensor  # (T, 4) pixel-space min_x, min_y, max_x, max_y


def _tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def setup_triangles(xy, aux, kind, meta, transform, width, height):
    """Transform model-space triangles and compute screen coefficients,
    on the device of ``xy`` (the CPU for a numpy array).

    `transform` is a standard row-major 4x4; model vertices are lifted as
    (x, y, 0, 1).  Perspective-correct interpolation: aux/w and 1/w are
    interpolated linearly in screen space.
    """
    dev = xy.device if isinstance(xy, torch.Tensor) else torch.device("cpu")
    f32 = torch.float32
    xy = _tensor(xy, f32, dev)
    aux = _tensor(aux, f32, dev)
    kind = _tensor(kind, torch.int32, dev)
    meta = _tensor(meta, f32, dev)
    m = _tensor(transform, f32, dev)
    # The 4x4 product in full float32, one multiply and add at a time in
    # the order of the contraction (the JAX package runs its einsum at
    # Precision.HIGHEST: a ~1e-3 error flips the cancellation-sensitive
    # Loop-Blinn predicates along curve boundaries).
    x, y = xy[..., 0], xy[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    clip = torch.stack(
        [x * m[r, 0] + y * m[r, 1] + zero * m[r, 2] + one * m[r, 3]
         for r in range(4)],
        dim=-1,
    )
    w = clip[..., 3]
    inv_w = 1.0 / w
    ndc = clip[..., :2] * inv_w[..., None]
    px = (ndc[..., 0] + 1.0) * (0.5 * width)
    py = (1.0 - ndc[..., 1]) * (0.5 * height)
    pix = torch.stack([px, py], dim=-1)  # (T, 3, 2)

    v0, v1, v2 = pix[:, 0], pix[:, 1], pix[:, 2]
    area = (v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1]) - (
        v1[:, 1] - v0[:, 1]
    ) * (v2[:, 0] - v0[:, 0])
    orient = torch.sign(area)
    finite = torch.isfinite(pix).all(dim=2).all(dim=1) & torch.isfinite(area)
    # Only front-of-camera triangles are drawn; clipping against the near
    # plane is not needed for 2D scenes with well-behaved cameras.
    visible = finite & (area != 0.0) & (w > 0.0).all(dim=1)

    # Oriented edge lines with top-left fill rule (shared edges stay
    # watertight for winding accumulation).
    edges = []
    top_lefts = []
    forward = orient[:, None] > 0
    for a_idx, b_idx in ((0, 1), (1, 2), (2, 0)):
        a = pix[:, a_idx]
        b = pix[:, b_idx]
        # e(p) = (b.x-a.x)(p.y-a.y) - (b.y-a.y)(p.x-a.x), oriented by sign(area)
        ea = -(b[:, 1] - a[:, 1]) * orient
        eb = (b[:, 0] - a[:, 0]) * orient
        # Orientation-normalized endpoints for the top-left test.
        aa = torch.where(forward, a, b)
        bb = torch.where(forward, b, a)
        top_left = ((aa[:, 1] == bb[:, 1]) & (bb[:, 0] > aa[:, 0])) | (
            bb[:, 1] > aa[:, 1]
        )
        edges.append(torch.stack([ea, eb, a[:, 0], a[:, 1]], dim=-1))
        top_lefts.append(top_left)
    edge = torch.stack(edges, dim=1)  # (T, 3, 4)
    edge_top_left = torch.stack(top_lefts, dim=1)

    # Barycentric coordinate lines: λ0 opposes edge (v1,v2), etc.
    inv_area = torch.where(area != 0.0, 1.0 / area, torch.zeros_like(area))

    def bary_line(a, b):
        ea = -(b[:, 1] - a[:, 1]) * inv_area
        eb = (b[:, 0] - a[:, 0]) * inv_area
        return torch.stack([ea, eb, a[:, 0], a[:, 1]], dim=-1)

    bary = torch.stack(
        [bary_line(v1, v2), bary_line(v2, v0), bary_line(v0, v1)], dim=1
    )

    is_fill = kind <= KIND_RATIONAL_CUBIC
    # NDC-space orientation is the negation of pixel-space orientation
    # (the viewport flips y); NDC-CCW contributes +1 (fill.py winding
    # convention).
    zero_i = torch.zeros_like(kind)
    contribution = torch.where(
        visible & is_fill, -orient.to(torch.int32), zero_i
    )
    contribution = torch.where(
        visible & ~is_fill, torch.ones_like(kind), contribution
    )

    aabb = torch.cat([pix.amin(dim=1), pix.amax(dim=1)], dim=-1)
    aabb = torch.where(
        visible[:, None], aabb, torch.full_like(aabb, -1e9)
    )

    return TriangleSetup(
        edge=edge,
        edge_top_left=edge_top_left,
        bary=bary,
        aux_w=aux * inv_w[..., None],
        inv_w=inv_w,
        kind=kind,
        contribution=contribution,
        meta=meta,
        aabb=aabb,
    )


def bin_triangles(aabb, contribution, num_tiles_x, num_tiles_y, tile_size, capacity):
    """Assign triangles to tiles by AABB overlap.

    Returns (indices (Ntiles, K) int32, valid (Ntiles, K) bool,
    max_count () int32): for each tile, the indices of overlapping
    triangles in draw order, padded to capacity; `max_count` lets the
    host detect capacity overflow.  Nothing is read back to the host.
    """
    dev = aabb.device
    n_tiles = num_tiles_x * num_tiles_y
    tiles = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    tx = tiles % num_tiles_x
    ty = tiles // num_tiles_x
    tile_min_x = (tx * tile_size).to(torch.float32)
    tile_min_y = (ty * tile_size).to(torch.float32)
    tile_max_x = tile_min_x + tile_size
    tile_max_y = tile_min_y + tile_size
    live = contribution != 0
    overlap = (
        (aabb[None, :, 0] <= tile_max_x[:, None])
        & (aabb[None, :, 2] >= tile_min_x[:, None])
        & (aabb[None, :, 1] <= tile_max_y[:, None])
        & (aabb[None, :, 3] >= tile_min_y[:, None])
        & live[None, :]
    )
    n_triangles = aabb.shape[0]
    # Compaction by rank: the k-th overlapping triangle of a tile lands in
    # slot k (cumsum + scatter; draw order kept).  Slots past the capacity
    # go to one spare column, which is cut off: the JAX package's
    # scatter with mode="drop".
    rank = torch.cumsum(overlap, dim=1, dtype=torch.int32)
    slot = torch.where(
        overlap & (rank <= capacity), rank - 1, torch.full_like(rank, capacity)
    ).to(torch.int64)
    tri_index = torch.arange(
        n_triangles, dtype=torch.int32, device=dev
    )[None, :].expand(n_tiles, n_triangles)
    indices = torch.zeros(
        (n_tiles, capacity + 1), dtype=torch.int32, device=dev
    ).scatter_(1, slot, tri_index)[:, :capacity]
    counts = (
        rank[:, -1] if n_triangles
        else torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    )
    valid = (
        torch.arange(capacity, dtype=torch.int32, device=dev)[None, :]
        < counts[:, None]
    )
    return indices, valid, counts.max()


def interpolate_attributes(lam, aux_w):
    """Barycentric attribute interpolation as explicit multiply-adds.

    ``lam`` (..., K, 3), ``aux_w`` (K, 3, C) → (..., K, C), in the JAX
    package's order: (λ0·a0 + λ1·a1) + λ2·a2.
    """
    return (
        lam[..., 0, None] * aux_w[..., 0, :]
        + lam[..., 1, None] * aux_w[..., 1, :]
        + lam[..., 2, None] * aux_w[..., 2, :]
    )


def tile_chunk(tile_size: int, n_samples: int, capacity: int) -> int:
    """Tiles walked at once: as many as keep the winding pass's
    temporaries, TILE_PAIR_BYTES per (sample, slot) pair, within
    CHUNK_BYTES."""
    per_tile = tile_size * tile_size * n_samples * max(1, capacity)
    return max(1, CHUNK_BYTES // (per_tile * TILE_PAIR_BYTES))


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"make_fill_rasterizer(device={str(device)!r}): no CUDA device "
            f"is available"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return device


def _tile_winding(setup, indices, valid, tiles, local_flat, num_tiles_x,
                  tile_size):
    """Per-sample winding of the tiles ``tiles`` (B,): (B, P) int32."""
    f32 = torch.float32
    tx = (tiles % num_tiles_x).to(f32) * tile_size
    ty = (tiles // num_tiles_x).to(f32) * tile_size
    pos = local_flat[None] + torch.stack([tx, ty], dim=-1)[:, None, :]
    px = pos[:, :, 0, None]  # (B, P, 1)
    py = pos[:, :, 1, None]
    idx = indices[tiles].long()  # (B, K)
    tvalid = valid[tiles]
    edge = setup.edge[idx][:, None]  # (B, 1, K, 3, 4)
    top_left = setup.edge_top_left[idx][:, None]  # (B, 1, K, 3)
    bary = setup.bary[idx][:, None]
    aux_w = setup.aux_w[idx][:, None]  # (B, 1, K, 3, 4)
    tkind = setup.kind[idx]  # (B, K)
    contrib = setup.contribution[idx]

    # Edge values, origin-relative, one edge at a time: (B, P, K).
    inside = None
    for k in range(3):
        e = ((px - edge[..., k, 2]) * edge[..., k, 0]
             + (py - edge[..., k, 3]) * edge[..., k, 1])
        inside_k = (e > 0.0) | ((e == 0.0) & top_left[..., k])
        inside = inside_k if inside is None else inside & inside_k
    lam = [
        (px - bary[..., k, 2]) * bary[..., k, 0]
        + (py - bary[..., k, 3]) * bary[..., k, 1]
        for k in range(3)
    ]
    # The fill predicates are homogeneous in the channels, so the
    # perspective division by the (positive) interpolated 1/w is
    # skipped: evaluating on aux/w-premultiplied values keeps the sign.
    x, y, z, w = (
        lam[0] * aux_w[..., 0, c] + lam[1] * aux_w[..., 1, c]
        + lam[2] * aux_w[..., 2, c]
        for c in range(4)
    )
    del lam
    # Predicates by kind (shaders.wgsl:233-266): integral kinds carry a
    # constant-1 trailing channel, so quadratic and cubic kinds share the
    # homogeneous rational forms.
    k = torch.clamp(tkind, 0, 4)[:, None, :]
    quadratic = (k == KIND_INTEGRAL_QUADRATIC) | (k == KIND_RATIONAL_QUADRATIC)
    keep = torch.where(
        k == KIND_SOLID,
        True,
        torch.where(quadratic, x * x - y * z <= 0.0, x * x * x - y * z * w <= 0.0),
    )
    # This standalone rasterizer evaluates fill predicates only; stroke
    # kinds are masked out.
    is_fill = tkind <= KIND_RATIONAL_CUBIC
    active = inside & keep & (tvalid & is_fill)[:, None, :]
    return torch.where(active, contrib[:, None, :], 0).sum(
        dim=-1, dtype=torch.int32
    )


def make_fill_rasterizer(
    width,
    height,
    tile_size=32,
    capacity=256,
    sample_offsets=MSAA4,
    device="cuda",
):
    """Build a function mapping triangle tables + transform to a
    per-sample winding buffer on ``device``: ``rasterize(xy, aux, kind,
    meta, transform)`` returns ``(winding (H, W, S) int32, max_count
    0-d int32)``, both on the device, with nothing read back to the host
    (compare ``max_count`` with the capacity to detect overflow).

    ``device`` defaults to the card and raises where none is visible;
    ``"cpu"`` runs the same torch code on the host.  The tile lists hold
    ``min(capacity, T)`` triangles; tiles are walked ``tile_chunk`` at a
    time.
    """
    device = _device(device)
    num_tiles_x = -(-width // tile_size)
    num_tiles_y = -(-height // tile_size)
    f32 = torch.float32
    offsets = torch.as_tensor(np.asarray(sample_offsets), dtype=f32, device=device)
    n_samples = offsets.shape[0]

    # Per-tile sample positions relative to the tile origin: (P, 2) with
    # P = tile_size² * S.
    yy, xx = torch.meshgrid(
        torch.arange(tile_size, dtype=f32, device=device),
        torch.arange(tile_size, dtype=f32, device=device),
        indexing="ij",
    )
    base = torch.stack([xx, yy], dim=-1)  # (th, tw, 2)
    local = base[:, :, None, :] + offsets[None, None, :, :]  # (th, tw, S, 2)
    local_flat = local.reshape(-1, 2)
    n_tiles = num_tiles_x * num_tiles_y

    def rasterize(xy, aux, kind, meta, transform):
        setup = setup_triangles(
            _tensor(xy, f32, device), aux, kind, meta, transform, width, height
        )
        k = min(capacity, setup.kind.shape[0])
        indices, valid, max_count = bin_triangles(
            setup.aabb, setup.contribution, num_tiles_x, num_tiles_y,
            tile_size, k,
        )
        chunk = tile_chunk(tile_size, n_samples, k)
        tiles = torch.empty(
            (n_tiles, local_flat.shape[0]), dtype=torch.int32, device=device
        )
        order = torch.arange(n_tiles, dtype=torch.int32, device=device)
        for start in range(0, n_tiles, chunk):
            part = order[start:start + chunk]
            tiles[start:start + chunk] = _tile_winding(
                setup, indices, valid, part, local_flat, num_tiles_x,
                tile_size,
            )
        image = tiles.reshape(
            num_tiles_y, num_tiles_x, tile_size, tile_size, n_samples
        )
        image = image.permute(0, 2, 1, 3, 4).reshape(
            num_tiles_y * tile_size, num_tiles_x * tile_size, n_samples
        )
        return image[:height, :width], max_count

    return rasterize


def resolve_coverage(winding, winding_bits=4):
    """Winding rule: nonzero modulo 2**winding_bits
    (reference renderer.rs:399-402)."""
    return (winding % (1 << winding_bits)) != 0


def composite_color(coverage, color, background=None):
    """Premultiplied-alpha 'over' of a solid color through per-sample
    coverage, resolved by averaging the samples axis
    (reference shaders.wgsl:304-309 + MSAA resolve).

    `coverage` (H, W, S) bool, `color` (4,) straight RGBA; returns
    (H, W, 4) premultiplied RGBA on the device of ``coverage``.
    """
    dev = coverage.device
    color = _tensor(color, torch.float32, dev)
    src = torch.cat([color[:3] * color[3], color[3:4]])
    frac = coverage.to(torch.float32).mean(dim=-1)  # (H, W)
    layer = frac[..., None] * src[None, None, :]
    if background is None:
        return layer
    background = _tensor(background, torch.float32, dev)
    return layer + background * (1.0 - frac[..., None] * color[3])
