"""The port's quality scenario on the card (`gpu` marker; run there with
`python -m pytest -m gpu tests/test_torch_quality_card.py`): the card's
document equals the CPU's, the measured wave latencies aside, at portfolio 1
and 4. Without a card and without `device="cpu"` the scenario refuses to
run. This file imports no JAX, so it runs on a machine that has none.
"""

from __future__ import annotations

import pytest
import torch

from grove_tpu_torch import bench as p_bench


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; run `python -m pytest -m gpu "
                    "tests/test_torch_quality_card.py` on the card")
    return torch.device("cuda", 0)


def without_walls(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k not in p_bench.QUALITY_WALL_KEYS}


@pytest.mark.gpu
@pytest.mark.parametrize("portfolio", [1, 4])
def test_card_document_equals_cpu(cuda, portfolio):
    card = p_bench.run_quality_bench(portfolio, device=cuda)
    cpu = p_bench.run_quality_bench(portfolio, device="cpu")
    assert without_walls(card) == without_walls(cpu)


def test_quality_bench_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_bench.run_quality_bench()
