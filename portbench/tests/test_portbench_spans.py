"""The readers of the port's program spans (``spans.py`` and the metrics
over it) on synthetic traced windows: known spans and device intervals give
known ms and %, spans are clipped to the window, and a window without the
spans gives None. On the card, a traced ``glass80.pt`` window: no device
record carries a span's name, the witness launches recorded equal the
program's counters, and the tempering cell's span metrics read a number."""

import pytest

from portbench import core, spans, tracing
from portbench.tracing import TraceView

STATES = "states_host_ms_per_call.updates"
NEW = ("states_host_ms_per_call.updates", "states_host_ms_per_call.scan", "key_tables_ms_per_call.pt",
       "idle_key_tables_pct.pt", "samples_host_ms_per_call.pt")


def read(metric, view):
    return core.load_module("metrics", metric).read(view)


def view(host, device=(), window=(0.0, 1000.0), calls=2):
    return TraceView(list(device), list(host), window, calls, {"sweeps": 10}, {}, {})


def test_states_ms_sum_every_span_over_the_calls():
    host = [(tracing.CALL, 0, 500), ("pmc.lattice.states", 100, 250), (tracing.CALL, 500, 1000),
            ("pmc.lattice.states", 600, 700), ("pmc.lattice.setup", 0, 100)]
    v = view(host)
    assert read(STATES, v) == pytest.approx((150 + 100) * 1e-3 / 2)
    assert read("states_host_ms_per_call.scan", v) == read(STATES, v)


def test_spans_clipped_to_the_window():
    host = [("pmc.tempering.key_tables", -300, 200), ("pmc.tempering.key_tables", 900, 1500),
            ("pmc.tempering.samples", 1200, 1300), ("pmc.tempering.samples", 400, 500)]
    v = view(host, calls=1)
    assert spans.intervals(v, "pmc.tempering.key_tables") == [(0.0, 200), (900, 1000.0)]
    assert read("key_tables_ms_per_call.pt", v) == pytest.approx(0.3)
    assert read("samples_host_ms_per_call.pt", v) == pytest.approx(0.1)


def test_idle_key_tables_is_span_time_without_device_work():
    host = [("pmc.tempering.key_tables", 0, 200), ("pmc.tempering.key_tables", 500, 600)]
    # busy inside the first span: 50..80 and 70..120 (union 70) and 190..260 (10 inside); none in the second
    device = [("k", 50, 80), ("copy", 70, 120), ("k", 190, 260), ("k", 300, 400)]
    v = view(host, device)
    assert spans.idle_us(v, "pmc.tempering.key_tables") == pytest.approx(200 - 80 + 100)
    assert read("idle_key_tables_pct.pt", v) == pytest.approx(100 * 220 / 1000)


@pytest.mark.parametrize("metric", NEW)
def test_a_window_without_spans_reads_none(metric):
    host = [(tracing.CALL, 0, 1000), ("aten::copy_", 10, 20), ("pmc.lattice.states", 1200, 1300)]
    assert read(metric, view(host, [("k", 0, 900)])) is None
    assert read(metric, view([], [], (0.0, 0.0), 0)) is None


@pytest.mark.card
def test_traced_glass_window_on_the_card(card):
    cell = core.Cell("glass80.pt")
    driver = cell.driver(2**31 + 17, "cuda")
    driver.warm()
    v = tracing.trace_window(driver, int(cell.spec["trace_calls"]))
    driver.release()
    assert v.failed == 0 and v.calls >= 1
    assert not [n for n, _, _ in v.device if n.startswith("pmc.")]
    assert v.recorded[0] == v.recorded[1] > 0
    assert any(n == "pmc.tempering.qmc_timesteps_sample" for n, _, _ in v.host)
    for m in core.per_layer_metrics(cell.bench, "glass80.pt"):
        if m["name"] in NEW:
            assert read(m["name"], v) > 0, m["name"]
