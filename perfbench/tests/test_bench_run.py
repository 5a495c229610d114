"""``perfbench.run`` refuses without the cards a cell asks for: non-zero,
and no result line."""

import subprocess
import sys

import pytest

from perfbench import spec


def test_without_a_card_exits_nonzero(card_absent):
    p = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "large-v3.serve.chunks", "--seed", str(2 ** 31 + 3), "--seconds",
         "2", "--trace", "0"], cwd=spec.REPO, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert "memory_peak_bytes" not in p.stdout
    assert "correct" not in p.stdout


@pytest.fixture
def card_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
