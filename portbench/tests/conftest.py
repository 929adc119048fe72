import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(Path(__file__).resolve().parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """The two cells at tiny size, laid out as the harness finds them."""
    import tiny

    tmp = tmp_path_factory.mktemp("tiny")
    return tmp, tiny.tiny_bench(tmp)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)
