"""Sharded rendering across a mesh of torch devices.

The port's counterpart of ``contrast_renderer_tpu/parallel/mesh.py``.
Rendering is embarrassingly parallel over pixels once the geometry is
known, so the frame's output is split into a 1D grid of row bands or a
2D grid of row × column rects, and each rect is rendered on its device
with a *sub-rect-adjusted projection*: rendering rect (by, bx) of an
(ny, nx) grid at local size (H/ny, W/nx) equals rendering the full frame
with NDC remapped by ``x' = nx·x + (nx−1−2bx)·w`` and
``y' = ny·y + (1−ny+2by)·w``, row operations on the clip-space matrix,
so each rect runs the unmodified single-device frame step (binning and
the coverage kernel).

torch has no ``jax.sharding.Mesh`` and no ``shard_map``, so ``Mesh``
here is a small grid of ``torch.device``s with named axes, and the
mapped step is a loop: each rect is dispatched on its own device, in
turn, with no synchronise between devices, and the rects are then
gathered on the mesh's first device with ``torch.cat``.  A device may
repeat (several bands on one card, or on the CPU).
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..error import require_finite
from ..renderer import (
    FIT_FLOORS,
    Renderer,
    _FrameStep,
    _GraphPool,
    _copy_to_host_async,
    _fit_capacity,
    _optimize_commands,
    _rotated_probe_commands,
    _spec_paint,
)


class Mesh:
    """A grid of torch devices with named axes: the port's stand-in for
    ``jax.sharding.Mesh``.

    ``devices`` is anything ``np.array`` shapes into an (n,) or (ny, nx)
    grid of devices or device names (``"cuda:0"``, ``"cpu"``, ...), one
    axis name each.  A CUDA device raises where no card, or not that
    card, is visible."""

    def __init__(self, devices, axis_names: Sequence[str]):
        names = np.array(devices, dtype=object)
        axis_names = tuple(axis_names)
        if names.ndim != len(axis_names) or names.ndim not in (1, 2):
            raise ValueError(
                f"a mesh of shape {names.shape} needs {names.ndim} axis "
                f"names, and 1 or 2 axes; got {axis_names}"
            )
        if names.size == 0:
            raise ValueError("a mesh needs at least one device")
        grid = np.empty(names.shape, dtype=object)
        for index, name in np.ndenumerate(names):
            grid[index] = _checked_device(name)
        #: The devices, an object array of ``torch.device``.
        self.devices = grid
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size."""
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.devices.tolist()}, {self.axis_names})"


def _checked_device(name) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"Mesh device {str(device)!r}: no CUDA device is available"
            )
        index = torch.cuda.current_device() if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"Mesh device {str(device)!r}: {torch.cuda.device_count()} "
                f"CUDA device(s) visible"
            )
        return torch.device("cuda", index)
    if device.type != "cpu":
        raise ValueError(f"unsupported mesh device {str(device)!r}")
    return device


def band_adjusted_transform(transform, band, num_bands):
    """Remap a model→clip matrix (or an (..., 4, 4) stack) so the full
    frame's row band `band` fills the whole viewport of a
    1/num_bands-height render.  float32 numpy, rounded as the JAX
    package rounds it."""
    transform = np.array(transform, dtype=np.float32)
    n = np.float32(num_bands)
    offset = np.float32(1.0) - n + np.float32(2.0) * np.float32(band)
    transform[..., 1, :] = n * transform[..., 1, :] + offset * transform[..., 3, :]
    return transform


def rect_adjusted_transform(transform, by, ny, bx, nx):
    """Remap a model→clip matrix so grid rect (by, bx) of an (ny, nx)
    split fills the whole viewport of a (H/ny, W/nx) render."""
    transform = band_adjusted_transform(transform, by, ny)
    fx = np.float32(nx)
    offset = fx - np.float32(1.0) - np.float32(2.0) * np.float32(bx)
    transform[..., 0, :] = fx * transform[..., 0, :] + offset * transform[..., 3, :]
    return transform


class _Grid:
    """The rects of a sharded frame: their devices in row-major order, the
    grid's shape, and whether it is a 2D grid (rect transforms) or 1D
    row bands (band transforms)."""

    def __init__(self, devices: List[torch.device], ny: int, nx: int,
                 two_d: bool):
        self.devices = devices
        self.ny, self.nx = ny, nx
        self.two_d = two_d

    @classmethod
    def bands(cls, mesh: Mesh, axis: str) -> "_Grid":
        # Other mesh axes replicate the frame; their first index renders.
        along = mesh.axis_names.index(axis)
        column = np.moveaxis(mesh.devices, along, 0).reshape(
            mesh.devices.shape[along], -1
        )[:, 0]
        return cls(list(column), len(column), 1, False)

    @classmethod
    def rects(cls, mesh: Mesh, axes) -> "_Grid":
        ay, ax = axes
        grid = mesh.devices
        if mesh.axis_names.index(ay) > mesh.axis_names.index(ax):
            grid = grid.T
        return cls(list(grid.reshape(-1)), grid.shape[0], grid.shape[1], True)

    def adjust(self, transforms, cell: int):
        by, bx = divmod(cell, self.nx)
        if self.two_d:
            return rect_adjusted_transform(transforms, by, self.ny, bx, self.nx)
        return band_adjusted_transform(transforms, by, self.ny)

    def gather(self, images):
        """The full frame on the first device, from the rects' images."""
        home = self.devices[0]
        images = [image.to(home) for image in images]
        rows = [
            torch.cat(images[r * self.nx:(r + 1) * self.nx], dim=1)
            if self.nx > 1 else images[r]
            for r in range(self.ny)
        ]
        return torch.cat(rows, dim=0)


def _sub_renderer(renderer, grid: _Grid):
    """The renderer of one rect of ``grid``, on its first device."""
    height = renderer.height // grid.ny
    sub = Renderer(
        renderer.config,
        renderer.width // grid.nx,
        height,
        tile_size=(
            None if renderer.tile_h is None
            else min(renderer.tile_h, height)
        ),
        tile_capacity=renderer.tile_capacity,
        device=grid.devices[0],
    )
    # Inherit the outer renderer's (possibly pre-sized) binning
    # capacities: every overflow retry repacks the sharded frame.
    sub._global_capacity = renderer._global_capacity
    sub._tile_global_capacity = renderer._tile_global_capacity
    sub._clip_pool = renderer._clip_pool
    sub.blend_constant = renderer.blend_constant
    return sub


class _Pipeline:
    """``commands`` packed for the per-rect frame step: the rect's spec
    and executors, the command, descriptor and paint tables on the host,
    and their copies on each device that renders a rect (made on first
    use).  Like the JAX package's ``_packed_pipeline`` it walks the
    commands without auto-instancing.  ``keep_rows`` re-indexes
    caller-supplied transform stacks from the public
    one-row-per-(command, instance) layout into the optimized draw
    layout (SAVE+SCALE pairs fuse away one row each,
    renderer._optimize_commands), as FrameProgram does.
    ``out_uint8`` resolves each rect to packed RGBA8 inside the kernel.
    """

    def __init__(self, sub, commands, out_uint8=False):
        sub._validate(commands)
        commands, self.keep_rows = _optimize_commands(commands)
        shapes, shape_index = sub._unique_shapes(commands)
        _, self._scene = sub._scene_arrays(shapes)
        ops = tuple(int(c.operation) for c in commands)
        cmd_shape = tuple(
            Renderer._cmd_shape_entry(c, shape_index) for c in commands
        )
        inst = tuple(c.n_instances for c in commands)
        cmd_inst = inst if any(n != 1 for n in inst) else ()
        paints = tuple(_spec_paint(c.color) for c in commands)
        spec = sub._spec(
            ops, cmd_shape, cmd_inst, self._scene, paints, commands=commands
        )
        if out_uint8:
            spec = replace(spec, out_uint8=True)
        self.spec = spec
        self.prepare, self.rasterize = sub._get_executors(spec)
        cmd_i, cmd_f = Renderer._pack_commands_runtime(
            commands, sub._blend_constant_arg()
        )
        desc_f, desc_i = Renderer._pack_descriptors(shapes)
        desc_static = np.ascontiguousarray(desc_i[:, [9, 8]])
        paint_model = Renderer._pack_paints(commands)
        self._host = (desc_static, paint_model, cmd_i, cmd_f, desc_f, desc_i)
        #: The commands' own transforms, in the optimized draw layout.
        self.transform = Renderer._pack_transforms(commands)
        self._inputs = {}

    def inputs(self, device):
        """(scene arrays, desc_static, paints, cmd_i, cmd_f, desc_f,
        desc_i) on ``device``."""
        found = self._inputs.get(device)
        if found is None:
            scene = tuple(t.to(device) for t in self._scene.arrays)
            found = (scene,) + tuple(
                None if a is None else torch.as_tensor(a, device=device)
                for a in self._host
            )
            self._inputs[device] = found
        return found

    def runtime(self, device, transforms):
        """Bin one rect from its adjusted (R, 4, 4) transforms on
        ``device``: the raster executor's arguments."""
        scene, desc_static, paints, cmd_i, cmd_f, desc_f, desc_i = (
            self.inputs(device)
        )
        prepared = self.prepare(*scene, transforms, desc_static, paints)
        return prepared, cmd_i, cmd_f, desc_f, desc_i


def _gathered(grid: _Grid, images, overflows):
    """(the rects' frame on the first device, their worst overflow
    counters (4,) there): new tensors, whatever the rects wrote into."""
    home = grid.devices[0]
    worst = torch.stack([o.to(home) for o in overflows]).amax(dim=0)
    return grid.gather(images), worst


def _run_grid(pipeline, grid: _Grid, transforms):
    """Render every rect of ``grid`` from the full frame's (R, 4, 4)
    transforms in the optimized layout, eagerly: returns
    ``_gathered``'s (frame, worst overflow counters).

    Each device's adjusted stacks go up in one copy; every rect is then
    binned and rasterized on its own device, and nothing waits on
    another device until the gather."""
    transforms = np.asarray(transforms, np.float32)
    cells: Dict[torch.device, List[int]] = {}
    for cell, device in enumerate(grid.devices):
        cells.setdefault(device, []).append(cell)
    stacks = {}
    for device, members in cells.items():
        stack = torch.as_tensor(
            np.stack([grid.adjust(transforms, c) for c in members]),
            device=device,
        )
        for j, c in enumerate(members):
            stacks[c] = stack[j]
    images, overflows = [], []
    for cell, device in enumerate(grid.devices):
        runtime = pipeline.runtime(device, stacks[cell])
        images.append(pipeline.rasterize(*runtime))
        overflows.append(runtime[0].overflow)
    return _gathered(grid, images, overflows)


def _run_with_growth(sub, commands, run_once, outer=None, to_host=True):
    """Run a sharded frame, growing binning capacities on overflow (the
    same contract as Renderer.render's retry loop).  ``run_once`` takes
    the pipeline and returns (image, worst overflow).  Grown capacities
    are written back to ``outer`` (the caller's full-frame renderer) so
    later builds — e.g. a ShardedFrameProgram settling capacities — see
    the converged values.  ``to_host=False`` returns the device tensor
    instead of a numpy array (the settle path needs only the
    counters)."""
    try:
        for _attempt in range(4):
            image, overflow = run_once(_Pipeline(sub, commands))
            limits = (
                sub.tile_capacity,
                sub._global_capacity,
                sub._tile_global_capacity,
                sub._clip_pool,
            )
            worst = overflow.cpu().numpy()
            sub._last_binning_worst = worst  # for shrink-to-fit
            if not sub._grow_capacities(worst, limits):
                return image.cpu().numpy() if to_host else image
        raise RuntimeError("sharded tile binning capacity did not converge")
    finally:
        if outer is not None:
            outer.tile_capacity = max(outer.tile_capacity,
                                      sub.tile_capacity)
            outer._global_capacity = max(outer._global_capacity,
                                         sub._global_capacity)
            outer._tile_global_capacity = max(outer._tile_global_capacity,
                                              sub._tile_global_capacity)
            outer._clip_pool = max(outer._clip_pool, sub._clip_pool)


def _band_grid(renderer, mesh, axis):
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {axis!r}")
    grid = _Grid.bands(mesh, axis)
    if renderer.height % grid.ny:
        raise ValueError(
            f"height {renderer.height} does not divide into {grid.ny} bands"
        )
    return grid


def _rect_grid(renderer, mesh, axes):
    if len(axes) != 2 or mesh.devices.ndim != 2 or set(axes) != set(
        mesh.axis_names
    ):
        raise ValueError(f"axes {axes} do not name the 2D mesh {mesh}")
    grid = _Grid.rects(mesh, axes)
    if renderer.height % grid.ny or renderer.width % grid.nx:
        raise ValueError(
            f"{renderer.width}x{renderer.height} does not divide into "
            f"{grid.ny}x{grid.nx} rects"
        )
    return grid


def _render_grid(renderer, commands, grid: _Grid):
    return _run_with_growth(
        _sub_renderer(renderer, grid), commands,
        lambda pipeline: _run_grid(pipeline, grid, pipeline.transform),
        outer=renderer,
    )


def render_sharded(renderer, commands, mesh: Mesh, axis: str = "y"):
    """Render a frame with rows split over `mesh`'s `axis` (1D row
    bands).  `renderer` is sized to the FULL frame; its height must be
    divisible by the mesh axis size.  Returns the full (H, W, 4) image
    as a numpy array.  Binning capacities grown during the run are
    written back to `renderer`."""
    return _render_grid(renderer, commands, _band_grid(renderer, mesh, axis))


def render_sharded_2d(
    renderer, commands, mesh: Mesh, axes: tuple = ("y", "x")
):
    """Render a frame split over a 2D device mesh: rows over
    ``axes[0]``, columns over ``axes[1]``.  Returns the full (H, W, 4)
    image as a numpy array.  Grown capacities are written back to
    `renderer`."""
    return _render_grid(renderer, commands, _rect_grid(renderer, mesh, axes))


class _ShardedProgramBase:
    """A persistent sharded frame step: the commands are packed once, and
    each call feeds a new (R, 4, 4) transform stack.  Capacities settle
    at build on the program's own sub-renderer (a natural and a rotated
    probe frame, binned eagerly, then shrink-to-fit), and the
    deferred-growth contract is FrameProgram's: overflow counters copy
    to pinned host memory behind a CUDA event and are read on a later
    call (forced at OVERFLOW_MAX_LAG frames), and a scene that outgrows
    its buffers renders at most that many under-populated frames before
    the program rebuilds with grown capacities instead of raising.

    Each rect renders through a step of its own (``renderer._FrameStep``,
    binning and raster) on its device: on a CUDA device the rect's first
    frame warms it up on the device's side stream, its second captures
    it as a CUDA graph into the device's memory pool (the rects of one
    device share it), and every frame after that copies the rect's
    adjusted transforms in through pinned staging and replays it; on the
    CPU it runs eagerly.  The rects' frames and counters are gathered
    into new tensors, so a returned frame is the caller's to keep.  A
    rebuild drops every step.  ``stats`` holds the last call's host ms:
    ``rect_ms`` each rect's copies in and replay (or warm-up), and
    ``capture_ms`` each rect's capture, None where it did not capture."""

    #: Frames an unread overflow counter may age before the host waits
    #: on it (see renderer.FrameProgram.OVERFLOW_MAX_LAG).
    OVERFLOW_MAX_LAG = 16

    def __init__(self, renderer, commands, grid: _Grid, uint8_output):
        self._grid = grid
        self._sub = _sub_renderer(renderer, grid)
        self._commands = list(commands)
        #: Per-rect packed-RGBA8 resolve (see FrameProgram uint8_output).
        self._uint8 = bool(uint8_output)
        #: The side stream of the steps' warm-ups and captures, per CUDA
        #: device.
        self._sides = {
            d: torch.cuda.Stream(d) for d in grid.devices if d.type == "cuda"
        }
        self.stats = {}
        self._settle_and_build()

    def _settle_and_build(self):
        # Strict growth loop on self._sub: grown capacities must land on
        # the renderer _build reads.
        _run_with_growth(
            self._sub, self._commands, self._run_once, to_host=False
        )
        worst = self._sub._last_binning_worst
        # Second settle probe at a rotated orientation: axis-aligned
        # scenes bin optimistically (see renderer._rotated_probe_commands).
        _run_with_growth(
            self._sub, _rotated_probe_commands(self._commands),
            self._run_once, to_host=False,
        )
        worst = np.maximum(worst, self._sub._last_binning_worst)
        # Shrink-to-fit: the settle frames' worst per-rect counters size
        # the program's binning buffers at next-pow2(count · 1.5) instead
        # of the renderer's worst-case defaults; overflow past them
        # regrows through _sync's deferred rebuild.
        sub = self._sub
        sub.tile_capacity = _fit_capacity(
            worst[0], FIT_FLOORS[0], sub.tile_capacity
        )
        sub._global_capacity = _fit_capacity(
            worst[1], FIT_FLOORS[1], sub._global_capacity
        )
        sub._tile_global_capacity = _fit_capacity(
            worst[2], FIT_FLOORS[2], sub._tile_global_capacity
        )
        sub._clip_pool = _fit_capacity(
            worst[3], FIT_FLOORS[3], sub._clip_pool
        )
        self._pending = []
        self._frame = 0
        self._build()

    def _run_once(self, pipeline):
        return _run_grid(pipeline, self._grid, pipeline.transform)

    def _build(self):
        self._pipeline = _Pipeline(self._sub, self._commands, self._uint8)
        self._keep_rows = self._pipeline.keep_rows
        self._default_transform = self._pipeline.transform
        self._limits = (
            self._sub.tile_capacity,
            self._sub._global_capacity,
            self._sub._tile_global_capacity,
            self._sub._clip_pool,
        )
        #: cell -> its step, and one graph memory pool per CUDA device.
        self._steps = {}
        self._pools = {
            d: _GraphPool(d) for d in self._sides
        }

    def _rect_step(self, cell, device, transforms) -> _FrameStep:
        """The rect's step, made on first use with its adjusted
        transforms."""
        step = self._steps.get(cell)
        if step is None:
            p = self._pipeline
            scene, desc_static, paints, cmd_i, cmd_f, desc_f, desc_i = (
                p.inputs(device)
            )
            step = self._steps[cell] = _FrameStep(
                f"rect {cell} of a {type(self).__name__}", p.prepare, scene,
                transforms, desc_static, paints, self._pools.get(device),
                self._sides.get(device),
                raster=(p.spec, p.rasterize, (cmd_i, cmd_f, desc_f, desc_i)),
            )
        return step

    def _sync(self):
        """Read the overflow counters whose copy has landed (and those
        OVERFLOW_MAX_LAG frames old in any case), and rebuild with grown
        capacities when any overflowed."""
        grew = False
        keep = []
        for host, event, born in self._pending:
            if (
                event is None
                or event.query()
                or self._frame - born >= self.OVERFLOW_MAX_LAG
            ):
                if event is not None:
                    event.synchronize()
                grew |= self._sub._grow_capacities(host.numpy(), self._limits)
            else:
                keep.append((host, event, born))
        self._pending = keep
        if grew:
            self._build()

    def _rows(self, transforms):
        """A frame's stack in the optimized draw layout, validated (the
        commands' own for None)."""
        if transforms is None:
            transforms = self._default_transform
        else:
            transforms = np.ascontiguousarray(
                transforms, np.float32
            ).reshape(-1, 4, 4)
            # Validate against the PUBLIC (pre-fusion) layout before the
            # keep_rows gather: a too-long stack would otherwise index in
            # range and silently render with misattributed rows.
            expected = sum(c.n_instances for c in self._commands)
            if transforms.shape[0] != expected:
                raise ValueError(
                    f"expected {expected} transform rows (one per "
                    f"command instance, pre-fusion), got "
                    f"{transforms.shape[0]}"
                )
            if self._keep_rows is not None:
                transforms = transforms[self._keep_rows]
            require_finite(transforms, "frame transforms")
        return np.asarray(transforms, np.float32)

    def __call__(self, transforms=None):
        """Render one frame; returns the (H, W, 4) image on the mesh's
        first device, a new tensor each call.  ``transforms``: (R, 4, 4),
        one row per (command, instance) draw in the ORIGINAL command
        layout — rows of fused-away SAVE covers are dropped internally,
        exactly as renderer.FrameProgram does."""
        transforms = self._rows(transforms)
        self._frame += 1
        self._sync()
        grid = self._grid
        images, overflows, rect_ms, capture_ms = [], [], [], []
        for cell, device in enumerate(grid.devices):
            start = time.perf_counter()
            adjusted = grid.adjust(transforms, cell)
            step = self._rect_step(cell, device, adjusted)
            prepared, captured = step(adjusted)
            rect_ms.append((time.perf_counter() - start) * 1e3)
            capture_ms.append(captured)
            images.append(step.frame)
            overflows.append(prepared.overflow)
        image, overflow = _gathered(grid, images, overflows)
        self._pending.append((*_copy_to_host_async(overflow), self._frame))
        self.stats = {"rect_ms": rect_ms, "capture_ms": capture_ms}
        return image


class ShardedFrameProgram(_ShardedProgramBase):
    """A persistent band-sharded frame step: the multi-device analogue of
    renderer.FrameProgram (``render_sharded`` repacks the commands every
    call).  Like ``render_sharded`` it walks the commands without
    auto-instancing."""

    def __init__(self, renderer, commands, mesh: Mesh, axis: str = "y",
                 uint8_output: bool = False):
        super().__init__(renderer, commands, _band_grid(renderer, mesh, axis),
                         uint8_output)


class ShardedFrameProgram2D(_ShardedProgramBase):
    """2D tile-grid variant of :class:`ShardedFrameProgram` (rows over
    ``axes[0]``, columns over ``axes[1]``)."""

    def __init__(
        self, renderer, commands, mesh: Mesh, axes: tuple = ("y", "x"),
        uint8_output: bool = False,
    ):
        super().__init__(renderer, commands, _rect_grid(renderer, mesh, axes),
                         uint8_output)
