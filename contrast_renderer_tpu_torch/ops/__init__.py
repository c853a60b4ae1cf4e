"""Device operations of the PyTorch/CUDA port: tile binning in torch and
the coverage raster kernel in CUDA (``coverage``)."""
