"""The benchmark's tests: ``python -m pytest mvsbench/tests -q`` from the
repository root (CPU); ``-m gpu`` on the card."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
