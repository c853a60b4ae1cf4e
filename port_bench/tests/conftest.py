"""The benchmark's own tests put the checkout's root on the path, so that
``port_bench`` imports as a package wherever pytest starts."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
