"""The tests import ``bench`` from the checkout's root and the port from
``src``; run them with ``python -m pytest bench/tests``."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)
