"""CPU tests of the benchmark harness: run them with

    python -m pytest -q -p no:cacheprovider perfbench/tests

Each test drives a tiny configuration through the harness on the host (the
plain versions of the kernels), with its own copy of the harness's data
directories (``tiny.py``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "perfbench"), os.path.dirname(os.path.abspath(__file__))):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
