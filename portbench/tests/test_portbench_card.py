"""On the card: each one-card cell's whole run, a short window, comes out
correct with every reader's metric there. Run on the chip:
``python3 -m pytest portbench/tests -m cuda``."""

import pytest

from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in harness.names("cells", ".json") if harness.load("cells", c)["chips"] == 1])
def test_cell_on_the_card(card, cell):
    result = harness.run(cell, 2**31 + 77, 2.0, True, "cuda", log=lambda line: None)
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert {"train_mfu", "loader_wait_ms", "device_idle_pct", "conv_ms_per_step", "flash_roofline_pct"} <= set(
        result["metrics"])
