"""CPU tests of the benchmark (``python -m pytest portbench/tests``).

Tests that need a CUDA card carry the ``chip`` marker and decide inside
the test whether a card is present; here they skip.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


#: a cell at a size the CPU holds: the configuration's widths (768), its
#: metric and dtype, fewer rows and components
TINY = {"config": {"corpus": {"rows": 16384, "components": 64,
                              "chunk_rows": 4096},
                   "settings": {"INDEX_CAPACITY": 16384}},
        "traffic": {"pool": 256, "callers": 2, "batch": 32}}
SEED = 2**33 + 12345  # wider than 32 bits, as the driver's seeds are


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture
def seed():
    return SEED
