"""The frozen arithmetic equals the program's, and the K2 bounds of the
port's kernel table."""

import numpy as np
import pytest

from benchmark.lib import cost


@pytest.mark.parametrize("preset", ["tiny", "base"])
def test_score_flops_equal_the_programs(preset):
    from memvul_tpu_torch.models.bert import BertConfig
    from memvul_tpu_torch.telemetry.programs import score_cost

    bc = getattr(BertConfig, preset)()
    cfg = {"hidden_size": bc.hidden_size, "intermediate_size": bc.intermediate_size,
           "num_hidden_layers": bc.num_layers, "header_dim": 32, "num_classes": 2}
    lengths = np.random.default_rng(0).integers(1, 128, size=24).tolist()
    for anchors in (0, 129):
        mine = cost.score_flops(cfg, 24 * 128, lengths, 24, anchors)
        theirs, _ = score_cost(bc, 24 * 128, lengths, 24, anchors, header_dim=32, num_classes=2)
        assert mine == pytest.approx(theirs, rel=1e-12)


def test_useful_flops_count_real_lengths():
    cfg = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 1, "header_dim": 2,
           "num_classes": 2}
    assert cost.useful_flops(cfg, [3, 5], 7) == cost.score_flops(cfg, 8, [3, 5], 2, 7)


def test_k2_bounds_match_the_kernel_table():
    # PERF.md's table: [64, 4096, 12, 64] 3.335 ms (ops), [1024, 256] 0.481 ms (bytes)
    assert cost.roofline_seconds(*cost.attention_launch(64, 4096, 12, 64)) * 1e3 == \
        pytest.approx(3.335, abs=1e-3)
    flops, nbytes = cost.attention_launch(1024, 256, 12, 64)
    assert nbytes / cost.PEAK_HBM_BYTES_PER_S > flops / cost.PEAK_BF16_FLOPS
    assert cost.roofline_seconds(flops, nbytes) * 1e3 == pytest.approx(0.481, abs=2e-3)
