"""Scene gallery of the port: prebuilt scenes mirroring the reference's
examples, built on the port's Shape and DrawCommand."""

from . import showcase  # noqa: F401
