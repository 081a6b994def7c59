"""The frozen hand bounds give the figures ``PERF.md`` recorded for them
at the recorded shapes, and the per-call bounds are sane."""

from __future__ import annotations

import pytest

from cardbench import bounds, spec, weights

TRAIN_MS = {"hymba-1.5b": 295.1, "h2o-danube-1.8b": 397.8}
PREFILL_MS = {"hymba-1.5b": (4096, 47.550), "h2o-danube-1.8b": (5120, 81.564)}


def _cell(config: str, traffic: str):
    return spec.load_cell(f"{config}.{traffic}")


@pytest.mark.parametrize("config", sorted(TRAIN_MS))
def test_train_bound(config):
    m = spec.model(spec.read_json(
        spec.HERE / "configs" / f"{config}.json")["model"])
    assert round(1e3 * bounds.train_bound(m, 8, 4096)[0], 1) \
        == TRAIN_MS[config]


@pytest.mark.parametrize("config", sorted(PREFILL_MS))
def test_prefill_bound(config):
    cell = _cell(config, "prefill-long")
    length, want = PREFILL_MS[config]
    census = weights.census(weights.layout(cell))
    # PERF.md gives the figures to 3 decimals (hymba's 47.5495 as 47.550)
    assert 1e3 * bounds.prefill_bound(cell.model, census, 4, length)[0] \
        == pytest.approx(want, abs=6e-4)


def test_visible_pairs_and_scan_flops():
    assert bounds.visible_pairs(4, None) == 10
    assert bounds.visible_pairs(4, 8) == 10
    assert bounds.visible_pairs(5, 2) == 3 + 3 * 2
    assert bounds.mamba_flops(10, 3, 16) == (122 * 30, 239 * 30)


def test_kinds():
    assert bounds.kind_of("nvjet_tst_128x256") == "GEMM (cuBLAS)"
    assert bounds.kind_of("void at::native::vectorized_elementwise_kernel"
                          ) == "elementwise and copies"
    assert bounds.kind_of("void at::native::reduce_kernel<512, 1>") \
        == "reductions"
    assert bounds.kind_of("mamba_scan_chunked") == "Mamba scan kernel"
    assert bounds.kind_of("something_else") == "other"


def test_call_bounds_count_each_operand_once():
    # hymba's training attention call: B=4, S=4096, 25/5 heads of 64
    q, k = [4, 4096, 25, 64], [4, 4096, 5, 64]
    fwd = bounds.attention_call_bound("train", [q, k, k], [2, 2, 2], 1024)
    bwd = bounds.attention_call_bound("backward", [q, k, k, q, [4, 25, 4096],
                                                   q], [2] * 6, 1024)
    pairs = 1024 * 1025 // 2 + 3072 * 1024
    assert fwd == pytest.approx(4 * 4 * 25 * 64 * pairs / 989e12)
    assert bwd == pytest.approx(2 * fwd)
    # the scan's serving call at hymba's prefill shape is bound by bytes
    scan = [[4, 4096, 1600], [1600], [4, 4096, 16], [4, 4096, 16],
            [4, 4096, 1600], [4, 4096, 1600], [1600, 16], [1600],
            [4, 1600, 16], []]
    t = bounds.scan_call_bound("forward", scan, [2, 4, 2, 2, 2, 2, 4, 4, 4])
    assert t == pytest.approx(max(
        (4 * 4 * 4096 * 1600 * 2 + 2 * 4 * 4096 * 16 * 2 + 1600 * 8
         + 1600 * 16 * 4 + 2 * 4 * 1600 * 16 * 4) / 3.35e12,
        (7 * 16 + 10) * 1600 * 4 * 4096 / 67e12))
