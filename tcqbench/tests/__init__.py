"""CPU tests of the benchmark (collected from the root of the repository as
the package ``tcqbench.tests``); the program is imported from ``src``."""

import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
