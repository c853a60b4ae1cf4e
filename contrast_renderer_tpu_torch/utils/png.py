"""Minimal PNG writer and reader (pure Python, zlib only).

The port's copy of ``contrast_renderer_tpu/utils/png.py``: frames go to
RGBA PNG files, the offline stand-in for the reference's presentation
surface.  ``write_png`` also takes a torch tensor, which it brings to the
host first; its bytes equal the JAX package's for the same image."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, image) -> None:
    """Write an (H, W, 4) float [0,1] or uint8 RGBA image as PNG: a numpy
    array or a torch tensor on any device.  (H, W, 3) RGB and (H, W)
    grey images are written with alpha 255."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    if image.shape[-1] == 3:
        image = np.concatenate(
            [image, np.full(image.shape[:-1] + (1,), 255, np.uint8)], axis=-1
        )
    height, width = image.shape[:2]
    raw = b"".join(
        b"\x00" + image[y].tobytes() for y in range(height)
    )
    header = struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0)
    data = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as fh:
        fh.write(data)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGBA PNG (any of the five standard row filters) into
    a (H, W, 4) uint8 array."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    width = height = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            width, height, depth, color = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or color != 6:
                raise ValueError(f"{path}: only 8-bit RGBA is supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = width * 4
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    offset = 0
    for y in range(height):
        filter_type = raw[offset]
        row = np.frombuffer(
            raw, np.uint8, count=stride, offset=offset + 1
        ).astype(np.int32)
        offset += 1 + stride
        if filter_type == 1:  # Sub
            for x in range(4, stride):
                row[x] = (row[x] + row[x - 4]) & 0xFF
        elif filter_type == 2:  # Up
            row = (row + prev) & 0xFF
        elif filter_type == 3:  # Average
            for x in range(stride):
                left = row[x - 4] if x >= 4 else 0
                row[x] = (row[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif filter_type == 4:  # Paeth
            for x in range(stride):
                a = row[x - 4] if x >= 4 else 0
                b = prev[x]
                c = prev[x - 4] if x >= 4 else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (row[x] + pred) & 0xFF
        out[y] = row.astype(np.uint8)
        prev = row
    return out.reshape(height, width, 4)


def unpremultiply(image: np.ndarray) -> np.ndarray:
    """Convert premultiplied RGBA float to straight RGBA."""
    image = np.asarray(image, np.float32)
    alpha = image[..., 3:4]
    rgb = np.where(alpha > 0, image[..., :3] / np.maximum(alpha, 1e-6), 0.0)
    return np.concatenate([rgb, alpha], axis=-1)
