"""The traced sub-window's arithmetic on a synthetic trace, and the
per-layer readers on a synthetic run."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import harness, trace


def ev(name, a, b, device=True, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b), is_user_annotation=annotation,
                           device_type=DeviceType.CUDA if device else DeviceType.CPU)


START_NS = 1_700_000_000_000_000_000  # the trace's start on the host's clock
# the window opens 40 us after the trace starts (event times are us after it)
WINDOW_NS = (START_NS + 40_000, START_NS + 1_040_000)
SPANS_NS = [(START_NS + 40_000, START_NS + 540_000, "step"),
            (START_NS + 540_000, START_NS + 1_040_000, "chunk_boundary")]


def synthetic():
    # a 1000 us window from 40 us; device work 140-440 (two overlapping
    # kernels), a gap 440-640 during a chunk boundary, then 640-990
    return [
        ev("void flash_fwd_kernel<64>", 140, 340),
        ev("elementwise_kernel", 290, 440),
        ev("time_attn_kernel", 640, 740),
        ev("Memcpy HtoD", 740, 990),
        ev("before", 0, 30),
        ev("after", 1240, 1340),
        ev("aten::mm", 150, 160, device=False),
        # the device side of a record_function range is no work
        ev("some_range", 40, 1040, annotation=True),
    ]


def reduce(events):
    return trace.reduce_events(events, START_NS, WINDOW_NS, SPANS_NS)


def test_union_and_gaps():
    total, gaps = trace.union_length([(0, 2), (1, 3), (5, 6)])
    assert total == 4 and gaps == [(3, 5)]


def test_reduce_events():
    tw = reduce(synthetic())
    assert tw.window_s == pytest.approx(1e-3)
    assert tw.busy_s == pytest.approx(650e-6)
    assert tw.idle_share == pytest.approx(0.35)
    assert tw.class_s[trace.K1] == pytest.approx(200e-6) and tw.class_s[trace.K2] == pytest.approx(100e-6)
    assert tw.class_s[trace.ELTWISE] == pytest.approx(400e-6)
    # gaps: 40-140 (step), 440-640 (step, open at 440), 990-1040 (chunk_boundary)
    assert tw.idle_gaps == [("step", pytest.approx(200e-6)), ("step", pytest.approx(100e-6)),
                            ("chunk_boundary", pytest.approx(50e-6))]


def test_reduce_events_refuses_a_trace_without_device_work():
    with pytest.raises(RuntimeError, match="no device work"):
        reduce([e for e in synthetic() if e.device_type == DeviceType.CPU])


def run_data():
    run = harness.RunData(step_ms=[500.0, 500.0, 1700.0, 500.0], boundary_after=[False, False, True, False])
    run.traced = reduce(synthetic())
    run.traced_steps = 2
    run.step_flops, run.step_k1_bound_s, run.step_k2_bound_s = 0.2 * 989e9, 50e-6, 20e-6
    return run


READINGS = {"chunk_gap_s": 1.2, "mfu": 100.0 * 0.2 * 989e9 * 2 / 1e-3 / 989e12, "eltwise_ms": 0.2,
            "k1_roofline": 50.0, "k2_roofline": 40.0, "device_idle": 35.0}
RENDER = [f"{m}.{cell}" for cell in ("render", "pass1") for m in READINGS]


@pytest.mark.parametrize("metric", RENDER)
def test_render_layer_readers(metric):
    assert harness.layer_reader(metric)(run_data()) == pytest.approx(READINGS[metric.split(".")[0]])


def test_train_layer_readers():
    run = run_data()
    run.extra = {"batch_wait_ms": 12.5, "k1_bwd_bound_s": 30e-6}
    run.traced.class_s.update({trace.K1_DKV: 40e-6, trace.K1_DQ: 20e-6})
    assert harness.layer_reader("batch_wait_ms.train")(run) == 12.5
    assert harness.layer_reader("k1_bwd_roofline.train")(run) == pytest.approx(100.0)
    assert harness.layer_reader("mfu.train")(run) == pytest.approx(READINGS["mfu"])
    assert harness.layer_reader("device_idle.train")(run) == pytest.approx(35.0)
    assert harness.layer_reader("eltwise_ms.train")(run) == pytest.approx(0.2)


@pytest.mark.parametrize("metric", RENDER + ["batch_wait_ms.train", "mfu.train", "eltwise_ms.train",
                                             "k1_bwd_roofline.train", "device_idle.train"])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    assert harness.layer_reader(metric)(harness.RunData()) is None
