"""The benchmark's own tests: the yardstick's copies, the metrics'
arithmetic, the reference against the port, the discovery of a cell from
files, the faults a check must catch, on the CPU; the control on the
card, where the tests marked ``card`` run and elsewhere skip.

    PYTHONPATH=src python -m pytest portbench/tests
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips "
                            "without one, decided in the cuda_device "
                            "fixture)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels are built by "
                    "nvcc and run only there")
    return torch.device("cuda")
