"""The benchmark's CPU tests: `python -m pytest perfbench/tests -q` from the
checkout's root.  Tests marked `cuda` need the card and skip without one."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
