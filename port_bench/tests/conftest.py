"""CPU tests of the port's benchmark: ``python -m pytest port_bench/tests``.

Tests marked ``gpu`` need the card and skip here; a test decides that
inside itself, never while the module is imported."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
