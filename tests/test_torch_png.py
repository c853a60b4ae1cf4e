"""The port's PNG writer and reader against the JAX package's: the same
bytes for the same image, the same decoding of every row filter."""

import struct
import zlib

import numpy as np
import pytest
import torch

from contrast_renderer_tpu.utils import png as ref_png
from contrast_renderer_tpu_torch.utils import png

SEED = 9


def _images():
    rng = np.random.default_rng(SEED)
    return {
        "float_rgba": rng.uniform(-0.2, 1.2, (7, 5, 4)).astype(np.float32),
        "uint8_rgba": rng.integers(0, 256, (6, 9, 4), dtype=np.uint8),
        "uint8_rgb": rng.integers(0, 256, (4, 3, 3), dtype=np.uint8),
        "float_grey": rng.uniform(0.0, 1.0, (5, 8)).astype(np.float32),
    }


@pytest.mark.parametrize("name", sorted(_images()))
def test_write_png_bytes_equal_the_reference(tmp_path, name):
    """Byte for byte, for numpy input and for the same image as a torch
    tensor."""
    image = _images()[name]
    ref_path, port_path, tensor_path = (
        tmp_path / "ref.png", tmp_path / "port.png", tmp_path / "tensor.png"
    )
    ref_png.write_png(str(ref_path), image)
    png.write_png(str(port_path), image)
    png.write_png(str(tensor_path), torch.from_numpy(image))
    assert port_path.read_bytes() == ref_path.read_bytes()
    assert tensor_path.read_bytes() == ref_path.read_bytes()
    back = png.read_png(str(port_path))
    assert np.array_equal(back, ref_png.read_png(str(ref_path)))
    assert back.shape == image.shape[:2] + (4,) and back.dtype == np.uint8


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _filtered_png(image):
    """An RGBA8 PNG whose rows cycle through the five row filters (None,
    Sub, Up, Average, Paeth), encoded here from the PNG specification."""
    height, width, _ = image.shape
    stride = width * 4
    rows = image.reshape(height, stride).astype(np.int64)
    raw = b""
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        kind = y % 5
        row = rows[y]
        out = np.empty(stride, np.int64)
        for x in range(stride):
            left = row[x - 4] if x >= 4 else 0
            up = prev[x]
            upleft = prev[x - 4] if x >= 4 else 0
            pred = (0, left, up, (left + up) >> 1, _paeth(left, up, upleft))[kind]
            out[x] = (row[x] - pred) & 0xFF
        raw += bytes([kind]) + out.astype(np.uint8).tobytes()
        prev = row

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 9))
            + chunk(b"IEND", b""))


def test_every_row_filter_reads_back(tmp_path):
    image = np.random.default_rng(SEED).integers(0, 256, (10, 7, 4), dtype=np.uint8)
    path = tmp_path / "filtered.png"
    path.write_bytes(_filtered_png(image))
    got = png.read_png(str(path))
    assert np.array_equal(got, image)
    assert np.array_equal(got, ref_png.read_png(str(path)))


def test_read_png_refuses_what_it_cannot_read(tmp_path):
    path = tmp_path / "not.png"
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(path))


def test_unpremultiply_equals_the_reference():
    rng = np.random.default_rng(SEED)
    image = rng.uniform(0.0, 1.0, (6, 6, 4)).astype(np.float32)
    image[..., :3] *= image[..., 3:4]
    image[0, :, 3] = 0.0
    got = png.unpremultiply(image)
    assert got.dtype == np.float32
    assert np.array_equal(got, ref_png.unpremultiply(image))
