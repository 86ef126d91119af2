"""The benchmark's CPU tests import `benchmark` and the program from the
checkout's root."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
