"""The general harness: cells found by name (``cell``), the traffic
generator (``traffic``), the port's names and renderer (``port_lib``),
the wait for the card's fast mode (``settle``), the measured window
(``window``), the trace's reduction (``trace``), the raster roofline's
work and peaks (``roofline``), the comparison (``check``) and the
readings that its limits are set from (``readings``)."""
