"""The port's examples, run with ``python -m
contrast_renderer_tpu_torch.examples.<name>``: ``render_showcase``
(PNG frames of the showcase), ``orbit_camera`` (the showcase under a
pointer-driven orbit through ``FrameLoop``), ``gradients`` (the gradient
card) and ``viewer_server`` (an HTTP viewer).  Each renders on the card
unless given ``--device cpu``."""
