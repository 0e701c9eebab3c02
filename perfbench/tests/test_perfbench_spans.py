"""perfbench/spans.py: the idle gaps split by the program's spans on a
synthetic trace, the readers on synthetic spans, and the recorder over a
window opened through the harness."""

import threading
import time

import pytest

from perfbench import harness, spans, trace
from perfbench.tests.test_perfbench_trace import SPANS_NS, START_NS, WINDOW_NS, synthetic
from stable_virtual_camera_tpu_torch.utils.profiling import Span

MAIN, OTHER = 1, 2


def at(us_a, us_b, name, thread=MAIN, i=0):
    return Span(name, START_NS + us_a * 1000, START_NS + us_b * 1000, thread, i, None, None)


PROGRAM = [at(40, 90, "sample.step"), at(450, 600, "renderer.prepare"), at(500, 550, "renderer.anchors"),
           at(980, 1040, "data.batch", OTHER)]


def test_device_gaps_are_reduce_events_gaps():
    gaps = spans.device_gaps(synthetic(), START_NS, WINDOW_NS)
    assert gaps == [(40, 140), (440, 640), (990, 1040)]
    tw = trace.reduce_events(synthetic(), START_NS, WINDOW_NS, SPANS_NS)
    assert sum(b - a for a, b in gaps) / 1e6 == pytest.approx(tw.window_s - tw.busy_s)


def test_split_idle_names_each_piece_by_the_innermost_program_span():
    """The 440-640 us gap, named `step` where it starts, crosses the
    program's prepare > anchors nesting; the last gap lies under another
    thread's span alone. Each benchmark span keeps its idle total."""
    gaps = spans.device_gaps(synthetic(), START_NS, WINDOW_NS)
    pieces = spans.split_idle(gaps, START_NS, SPANS_NS, PROGRAM, MAIN)
    got = sorted((n, round(s * 1e6)) for n, s in pieces)
    assert got == sorted([
        ("step/sample.step", 50), ("step", 50), ("step", 10), ("step/renderer.prepare", 50),
        ("step/renderer.anchors", 50), ("step/renderer.prepare", 50), ("step", 40),
        ("chunk_boundary/data.batch", 50)])
    assert sum(s for _, s in pieces) == pytest.approx(sum(b - a for a, b in gaps) / 1e6)
    by_name, named = spans.idle_summary(pieces)
    assert by_name["step"] == pytest.approx(100e-6) and by_name["step/renderer.prepare"] == pytest.approx(100e-6)
    assert named == {"step": pytest.approx(200 / 300), "chunk_boundary": pytest.approx(1.0)}
    tw = trace.reduce_events(synthetic(), START_NS, WINDOW_NS, SPANS_NS)
    for where in ("step", "chunk_boundary"):
        assert sum(s for n, s in pieces if n.split("/")[0] == where) == pytest.approx(
            sum(s for n, s in tw.idle_gaps if n == where))
    # with no program spans, one piece a gap, named as reduce_events names it
    plain = spans.split_idle(gaps, START_NS, SPANS_NS, [], MAIN)
    tw = trace.reduce_events(synthetic(), START_NS, WINDOW_NS, SPANS_NS)
    assert [(n, pytest.approx(s)) for n, s in plain] == tw.idle_gaps


def test_readers_read_their_cells_spans_and_nothing_else():
    recorded = [at(0, 2000, "renderer.prepare"), at(0, 4000, "renderer.prepare"), at(0, 500, "prepare_images"),
                at(0, 30, "sample.step")]
    counts = {"engine.frames_transformed": 81, "engine.frames_blank": 80}
    got = spans.readings("basic-768x576-pass1", recorded, counts)
    assert got == {"plan_ms.pass1": {"value": pytest.approx(3.0), "unit": "ms"},
                   "prepare_images_ms.pass1": {"value": pytest.approx(0.5), "unit": "ms"},
                   "blank_frames.pass1": {"value": pytest.approx(100 * 80 / 81), "unit": "%"}}
    assert spans.readings("basic-768x576-pass2", recorded, counts) == {
        "step_host_ms.render": {"value": pytest.approx(0.03), "unit": "ms"}}
    assert spans.readings("finetune-576-t21", recorded, counts) == {}
    for cell in ("basic-768x576-pass1", "basic-768x576-pass2", "finetune-576-t21"):
        assert spans.readings(cell, [], {}) == {}


def test_recorded_records_the_window_and_splits_the_traced_gaps():
    """Inside `recorded`, a driver's window (`harness.window_memory`) runs
    under a program recording, and the traced reduction returns what
    trace.reduce_events returns while it also splits the gaps by program
    span; the harness is as before once the block ends. Spans made outside
    the window are not recorded."""
    from stable_virtual_camera_tpu_torch.utils import profiling

    before = harness.window_memory, trace.reduce_events
    run, state = harness.RunData(), {}
    thread = threading.get_ident()
    with spans.recorded(state):
        with profiling.span("renderer.prepare"):
            pass  # set-up: before the window
        with harness.window_memory("cpu", run):
            for request in range(2):
                with profiling.request(), profiling.span("renderer.prepare"):
                    time.sleep(0.002)
                with profiling.span("prepare_images"):
                    profiling.count("engine.frames_transformed", 81)
                    profiling.count("engine.frames_blank", 80)
        program = [at(450, 600, "renderer.prepare", thread)]
        state["recording"].spans.extend(program)  # one at the synthetic trace's times
        tw = trace.reduce_events(synthetic(), START_NS, WINDOW_NS, SPANS_NS)
    assert (harness.window_memory, trace.reduce_events) == before
    assert tw == before[1](synthetic(), START_NS, WINDOW_NS, SPANS_NS)
    assert run.end_to_end["peak_mem_gib"] == 0.0  # the harness's own window still ran
    result = spans.program_result("basic-768x576-pass1", state)
    assert set(result["metrics"]) == {"plan_ms.pass1", "prepare_images_ms.pass1", "blank_frames.pass1"}
    assert result["metrics"]["blank_frames.pass1"]["value"] == pytest.approx(100 * 80 / 81)
    assert result["counts"] == {"engine.frames_transformed": 162, "engine.frames_blank": 160}
    assert {name: row[0] for name, row in result["spans"].items()} == {"renderer.prepare": 3, "prepare_images": 2}
    assert result["idle_split"]["step/renderer.prepare"] == pytest.approx(150e-6)
    assert result["idle_named"]["step"] == pytest.approx(150 / 300)
