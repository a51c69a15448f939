"""Puts the repository's root and the benchmark's folder on sys.path, as
`python3 benchmark/run.py` does."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
