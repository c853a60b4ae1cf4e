"""Bundled assets (the equivalent of the reference's vendored example
font, reference examples/fonts/).

The repo bundles OpenSans-Regular.ttf (Apache-2.0, license alongside) so
text rendering, benchmarks, and tests are self-contained; the
``CONTRAST_FONT_PATH`` environment variable overrides it.
"""

from __future__ import annotations

import os

DEFAULT_FONT_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "data", "fonts", "OpenSans-Regular.ttf",
)


def font_path() -> str:
    """Path of the bundled default font (env-overridable)."""
    return os.environ.get("CONTRAST_FONT_PATH", DEFAULT_FONT_PATH)


def load_default_font():
    """The bundled OpenSans face as a :class:`~.text.Font`."""
    from .text import Font

    with open(font_path(), "rb") as fh:
        return Font("OpenSans", fh.read())
