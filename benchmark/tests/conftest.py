"""The benchmark's own tests: the checkout's root on the path (the
benchmark and the program are imported from it)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
