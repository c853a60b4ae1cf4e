"""The port's side of a cell: the names a scene builder uses and the
renderer a configuration asks for, from ``contrast_renderer_tpu_torch``.
The only harness file that imports the port, and only when a run builds
the port's side."""

from __future__ import annotations

import time
from types import SimpleNamespace


def lib():
    from contrast_renderer_tpu_torch import path, renderer, text

    return SimpleNamespace(
        Path=path.Path,
        LineSegment=path.LineSegment,
        IntegralQuadraticCurveSegment=path.IntegralQuadraticCurveSegment,
        IntegralCubicCurveSegment=path.IntegralCubicCurveSegment,
        StrokeOptions=path.StrokeOptions,
        CurveApproximation=path.CurveApproximation,
        DynamicStrokeOptions=path.DynamicStrokeOptions,
        DashInterval=path.DashInterval,
        Cap=path.Cap,
        Join=path.Join,
        Font=text.Font,
        Layout=text.Layout,
        Orientation=text.Orientation,
        Alignment=text.Alignment,
        paths_of_text=text.paths_of_text,
        Shape=renderer.Shape,
        DrawCommand=renderer.DrawCommand,
        RenderOperation=renderer.RenderOperation,
    )


def renderer(config, device):
    """``Renderer(Configuration(**config["configuration"]), width,
    height, device=device, **config["renderer"])``: every option a
    configuration file names is passed through as it stands."""
    from contrast_renderer_tpu_torch import renderer as api

    return api.Renderer(api.Configuration(**config.get("configuration", {})),
                        config["width"], config["height"], device=device,
                        **config.get("renderer", {}))


def load_native():
    """Seconds to load the port's native geometry library, which g++
    builds into the checkout on a checkout's first run."""
    from contrast_renderer_tpu_torch import native

    start = time.perf_counter()
    native.available()
    return time.perf_counter() - start


def nvcc_seconds():
    """Seconds that nvcc spent building kernel libraries in this process
    (none where the checkout's build directory holds them already)."""
    from contrast_renderer_tpu_torch import cuda_build

    return sum(seconds for seconds, _ in cuda_build.build_logs.values())
