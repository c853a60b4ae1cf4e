"""Clip and alpha bracket gating in the port, against the JAX package.

The port's ``_gate_spans`` returns the reference's spans on streams that
both packages build with the same command list; its binning drops the
bracket machinery from the same tiles as the reference's, run op by op;
a gated image equals the ungated one to the bit (with the plain
rasterizer), including where unequal opener and closer transforms turn
the gating off at run time; and on the 4K clip/alpha showcase the gated
frame leaves exactly the plain showcase's tiles empty.

The bracket scene is the reference's ``TestBracketGating`` scene
(tests/test_renderer.py, ``scenes.bracket_commands``): a full-viewport
clip and alpha group around a small circle in one corner, at 128²."""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_renderer_tpu import path as ref_path
from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu.models import showcase as ref_showcase
from contrast_renderer_tpu.ops import coverage as ref_cov
from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch import path as port_path
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.models import showcase as port_showcase
from contrast_renderer_tpu_torch.ops import coverage as port_cov

SIZE = 128
#: (renderer module, path module, showcase module) of each package.
PACKAGES = {
    "reference": (ref, ref_path, ref_showcase),
    "port": (port, port_path, port_showcase),
}


def shifted_unclip(api, g):
    """The bracket with its UNCLIP's transform moved: the row check
    turns the gating off at run time."""
    shifted = np.eye(4, dtype=np.float32)
    shifted[0, 3] = 0.25
    return scenes.bracket_commands(api, g, unclip_transform=shifted)


def unbalanced(api, g):
    return scenes.bracket_commands(api, g)[:-1]  # no closing UNCLIP


def restore_after_unclip(api, g):
    """RESTORE issued after the bracket's UNCLIP, at depth 0: its clip
    mask differs from its SAVE's, so the bracket is not identity."""
    commands = scenes.bracket_commands(api, g)
    restore, unclip = commands[6], commands[7]
    return commands[:6] + [unclip, dataclasses.replace(restore, clip_depth=0)]


def background(api, g):
    """A full-screen translucent background before the bracket: every
    tile holds content, so every tile keeps its machinery."""
    identity = np.eye(4, dtype=np.float32)
    op = api.RenderOperation
    bg = api.Shape([g.Path.from_rect((0.0, 0.0), (1.0, 1.0))])
    return [
        api.DrawCommand(op.STENCIL, bg, identity),
        api.DrawCommand(op.COLOR, bg, identity, color=(0.2, 0.3, 0.4, 0.37)),
    ] + scenes.bracket_commands(api, g)


def two_layers(api, g):
    """Group 0 (layer 0) around a circle and group 1 (layer 1) nested in
    it around a second circle; each group's save and scale fuse."""
    identity = np.eye(4, dtype=np.float32)
    op = api.RenderOperation
    cover = api.Shape([g.Path.from_rect((0.0, 0.0), (1.0, 1.0))])
    a = api.Shape([g.Path.from_circle((-0.6, 0.6), 0.2)])
    b = api.Shape([g.Path.from_circle((-0.5, 0.4), 0.15)])
    outer, inner = (0.0, 0.0, 0.0, 0.7), (0.0, 0.0, 0.0, 0.5)
    return [
        api.DrawCommand(op.SAVE_ALPHA_CONTEXT, cover, identity, alpha_layer=0),
        api.DrawCommand(op.SCALE_ALPHA_CONTEXT, cover, identity, color=outer),
        api.DrawCommand(op.STENCIL, a, identity),
        api.DrawCommand(op.COLOR, a, identity, color=(0.9, 0.4, 0.1, 1.0)),
        api.DrawCommand(op.SAVE_ALPHA_CONTEXT, cover, identity, alpha_layer=1),
        api.DrawCommand(op.SCALE_ALPHA_CONTEXT, cover, identity, alpha_layer=1,
                        color=inner),
        api.DrawCommand(op.STENCIL, b, identity),
        api.DrawCommand(op.COLOR, b, identity, color=(0.1, 0.7, 0.9, 0.8)),
        api.DrawCommand(op.RESTORE_ALPHA_CONTEXT, cover, identity,
                        alpha_layer=1, color=inner),
        api.DrawCommand(op.RESTORE_ALPHA_CONTEXT, cover, identity,
                        alpha_layer=0, color=outer),
    ]


def showcase_clip(api, g, showcase):
    shape = showcase.build_shape(with_text=False)
    return showcase.showcase_commands_clip_alpha(shape, SIZE, SIZE)


#: name: (builder, alpha layers, whether the stream gates).
STREAMS = {
    "bracket": (scenes.bracket_commands, 1, True),
    "shifted_unclip": (shifted_unclip, 1, True),
    "unbalanced": (unbalanced, 1, False),
    "restore_after_unclip": (restore_after_unclip, 1, False),
    "background": (background, 1, True),
    "two_layers": (two_layers, 2, True),
    "showcase_clip": (showcase_clip, 1, True),
}


def build(name, package):
    api, g, showcase = PACKAGES[package]
    builder = STREAMS[name][0]
    if builder is showcase_clip:
        return builder(api, g, showcase)
    return builder(api, g)


def renderer(package, layers):
    api = PACKAGES[package][0]
    config = api.Configuration(alpha_layer_count=layers, blending="front_to_back")
    if package == "reference":
        # Sequential commands, as the port walks them.
        return api.Renderer(config, SIZE, SIZE, interpret=True, auto_instance=False)
    return api.Renderer(config, SIZE, SIZE, device="cpu")


def spec_of(package, r, commands):
    """The optimised commands, the scene arrays and the FrameSpec that
    ``package``'s renderer derives for ``commands``, gate spans and
    all."""
    api = PACKAGES[package][0]
    opt, _ = api._optimize_commands(commands)
    shapes, index = r._unique_shapes(opt)
    _, scene = r._scene_arrays(shapes)
    inst = tuple(c.n_instances for c in opt)
    spec = r._spec(
        tuple(int(c.operation) for c in opt),
        tuple(r._cmd_shape_entry(c, index) for c in opt),
        inst if any(n != 1 for n in inst) else (),
        scene,
        tuple(api._spec_paint(c.color) for c in opt),
        commands=opt,
    )
    return opt, shapes, scene, spec


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_gate_spans_match_reference(name):
    """The same commands, each package's own types: equal spans (unit
    indices and transform row pairs), and spans exactly where the
    stream's brackets are balanced."""
    _, layers, gates = STREAMS[name]
    specs = {}
    for package in PACKAGES:
        r = renderer(package, layers)
        opt, _, _, specs[package] = spec_of(package, r, build(name, package))
        specs[package + " ops"] = tuple(int(c.operation) for c in opt)
    assert specs["port ops"] == specs["reference ops"]
    assert specs["port"].gate_spans == specs["reference"].gate_spans
    assert bool(specs["port"].gate_spans) == gates


@lru_cache(maxsize=None)
def bracket_binning():
    """The bracket scene binned by both packages from one set of inputs
    (the reference op by op, jax.disable_jit), and the port's binning
    without its gate spans."""
    r = renderer("reference", 1)
    opt, shapes, scene, spec = spec_of("reference", r, build("bracket", "reference"))
    transforms = r._pack_transforms(opt)
    _, desc_i = r._pack_descriptors(shapes)
    desc_static = np.ascontiguousarray(desc_i[:, [9, 8]])
    with jax.disable_jit():
        want = ref_cov.make_prepare(spec)(
            *scene.arrays, jnp.asarray(transforms), jnp.asarray(desc_static)
        )
    p = renderer("port", 1)
    _, _, pscene, pspec = spec_of("port", p, build("bracket", "port"))
    args = (*pscene.arrays, torch.as_tensor(transforms), torch.as_tensor(desc_static))
    got = port_cov.make_prepare(pspec)(*args)
    ungated = port_cov.make_prepare(dataclasses.replace(pspec, gate_spans=()))(*args)
    return spec, pspec, want, got, ungated


def test_gated_binning_matches_reference():
    """aclist and acount equal the reference's to the bit (and the
    other range and class tables with them), and the gating dropped the
    machinery from the tiles the content circle does not reach."""
    spec, pspec, want, got, ungated = bracket_binning()
    assert spec.gate_spans and pspec.gate_spans == spec.gate_spans
    for name in ("aclist", "acount", "off", "g_off", "bulk", "cls", "hbits"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    acount, full = got.acount.reshape(-1), ungated.acount.reshape(-1)
    assert int((acount == 0).sum()) > 0 and int((full == 0).sum()) == 0
    assert bool((acount <= full).all())


@pytest.mark.parametrize("name", ["bracket", "shifted_unclip", "background"])
def test_gated_image_equals_ungated(name, monkeypatch):
    """The plain rasterizer, packed RGBA8: the gated image equals the
    image rendered with the port's _gate_spans returning ()."""
    commands = build(name, "port")
    r = renderer("port", 1)
    spec, _, runtime = r._prepare(commands)
    assert spec.gate_spans
    gated = r.render(commands, as_uint8=True)
    monkeypatch.setattr(port, "_gate_spans", lambda commands, spec: ())
    plain = renderer("port", 1)
    ungated_spec, _, ungated_runtime = plain._prepare(commands)
    assert not ungated_spec.gate_spans
    ungated = plain.render(commands, as_uint8=True)
    assert np.array_equal(gated, ungated)
    assert gated[..., 3].any()
    acount = runtime[0].acount
    full = ungated_runtime[0].acount
    if name == "bracket":
        assert int(acount.sum()) < int(full.sum())
    else:
        # Unequal opener and closer rows (shifted_unclip), or content in
        # every tile (background): nothing is dropped.
        assert torch.equal(acount, full)


def test_4k_clip_alpha_empty_tiles_are_the_plain_showcases():
    """Binning alone, on the CPU: the gated 4K clip/alpha showcase leaves
    empty exactly the tiles that the plain showcase leaves empty."""
    width, height = 3840, 2160
    shape = port_showcase.build_shape(with_text=True)
    empty = {}
    for label, config, commands in (
        ("plain", port.Configuration(),
         port_showcase.showcase_commands(shape, width, height)),
        ("clip/alpha",
         port.Configuration(alpha_layer_count=1, blending="front_to_back"),
         port_showcase.showcase_commands_clip_alpha(shape, width, height)),
    ):
        r = port.Renderer(config, width, height, device="cpu")
        spec, _, runtime = r._prepare(commands)
        empty[label] = runtime[0].acount.reshape(-1) == 0
        if label == "clip/alpha":
            assert len(spec.gate_spans) == 1
    assert int(empty["plain"].sum()) == 750 and empty["plain"].numel() == 2040
    assert torch.equal(empty["clip/alpha"], empty["plain"])
