"""setup_s: process start to the first timed frame (imports, the CUDA
context, the scene, kernel loads or builds, planning, warm-up and
captures), less the harness's wait for the card's fast mode
(harness/settle.py), which the result line's ``setup`` reports apart
with the builds (``nvcc_s``, ``native_load_s``)."""


def read(run):
    return run.setup_s
