"""utils/profiling.py's spans, counters and recordings, and the spans the
port's layers open: the renderer's and engine's over a tiny two-pass render,
the sampler's steps, and training's step, optimizer and data pipeline."""

import concurrent.futures
import itertools
import sys
import threading

import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch.utils import profiling
from stable_virtual_camera_tpu_torch.utils.profiling import Span
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse)


def test_span_and_count_do_nothing_without_a_recording(monkeypatch):
    """No recording and no trace open: no clock is read, one shared context
    serves every span, and the helpers hand their arguments back."""

    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr("time.time_ns", no_clock)
    monkeypatch.setattr("time.perf_counter", no_clock)
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"), profiling.span("b"):
        profiling.count("c", 3)
    with profiling.request() as rid:
        assert rid is None
    assert not profiling.enabled()

    def fn():
        return 1

    gen = iter([1, 2])
    assert profiling.carry(fn) is fn and profiling.in_request(gen, None) is gen


def test_spans_nest_and_carry_their_request_to_a_worker():
    """Parents on one thread, the submitting span as a worker's parent, one
    request id for the request's spans, counts summed, and each sink called
    with the recording when it closes."""
    got = []
    with profiling.recording(got.append) as rec:
        with profiling.span("outside"):
            pass
        with profiling.request() as rid, profiling.span("outer"):
            with profiling.span("inner"):
                profiling.count("things", 2)
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                def work():
                    with profiling.span("worker"):
                        profiling.count("things")
                        return threading.get_ident()

                worker_thread = pool.submit(profiling.carry(work)).result()
    assert got == [rec]
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"outside", "outer", "inner", "worker"}
    assert by["outside"].request is None and by["outside"].parent is None
    assert by["outer"].request == by["inner"].request == by["worker"].request == rid is not None
    assert by["inner"].parent == by["outer"].id and by["worker"].parent == by["outer"].id
    assert by["worker"].thread == worker_thread != by["outer"].thread
    assert all(s.start_ns <= s.end_ns for s in rec.spans)
    assert by["outer"].start_ns <= by["inner"].start_ns and by["inner"].end_ns <= by["outer"].end_ns
    assert rec.counts() == {"things": 3}
    # closed: nothing more is recorded
    with profiling.span("late"):
        profiling.count("things")
    assert "late" not in {s.name for s in rec.spans} and rec.counts() == {"things": 3}


def test_nested_recordings_and_a_sink_on_error():
    """Two recordings open at once both get the spans made while both are
    open; a block that raises still hands its recording to the sinks."""
    seen = []
    with pytest.raises(RuntimeError, match="stop"):
        with profiling.recording(lambda r: seen.append([s.name for s in r.spans])) as outer:
            with profiling.span("a"):
                pass
            with profiling.recording() as inner:
                with profiling.span("b"):
                    pass
            raise RuntimeError("stop")
    assert [s.name for s in outer.spans] == ["a", "b"] and [s.name for s in inner.spans] == ["b"]
    assert seen == [["a", "b"]]
    assert not profiling.enabled()


def test_in_request_resumes_each_generator_under_its_own_request():
    """Two generators driven in turns from one thread: each one's spans
    take its own request, and the caller's between resumptions keep none."""

    def gen(name):
        for i in range(2):
            with profiling.span(f"{name}{i}"):
                pass
            yield i

    with profiling.recording() as rec:
        with profiling.request() as ra, profiling.request() as rb:
            pass
        a, b = profiling.in_request(gen("a"), ra), profiling.in_request(gen("b"), rb)
        next(a)
        next(b)
        with profiling.span("caller"):
            pass
        next(a)
        b.close()
    req = {s.name: s.request for s in rec.spans}
    assert req == {"a0": ra, "b0": rb, "caller": None, "a1": ra} and ra != rb


def test_summary_gives_calls_total_and_self_time():
    """Self time is the duration less the union of the children's
    intervals, clipped to the span, on any thread."""
    spans = [
        Span("step", 0, 100, 1, 1, None, 7),
        Span("loss", 10, 40, 1, 2, 1, 7),
        Span("backward", 30, 70, 1, 3, 1, 7),  # overlaps loss: counted once
        Span("worker", 90, 150, 2, 4, 1, 7),  # outlives its parent: clipped
        Span("step", 200, 250, 1, 5, None, 8),
    ]
    table = profiling.summary(spans)
    assert list(table) == ["step", "worker", "backward", "loss"]
    calls, total, own = table["step"]
    assert calls == 2 and total == pytest.approx(150e-9) and own == pytest.approx((100 - 60 - 10 + 50) * 1e-9)
    assert table["loss"] == (1, pytest.approx(30e-9), pytest.approx(30e-9))


def test_concurrent_spans_lose_no_record():
    """More threads than cores, switching often, each opening nested spans
    while recordings open and close: every span made while a recording is
    open is in it once, and every parent is a span of the same thread."""
    n_threads, n_spans = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            def work():
                for _ in range(n_spans):
                    with profiling.span("outer"):
                        with profiling.span("inner"):
                            profiling.count("n")

            def churn(stop):
                while not stop.is_set():
                    profiling.recording().close()

            stop = threading.Event()
            churner = threading.Thread(target=churn, args=(stop,))
            churner.start()
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            stop.set()
            churner.join(timeout=60)
            assert not churner.is_alive() and not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(rec.spans) == 2 * n_threads * n_spans and rec.counts() == {"n": n_threads * n_spans}
    ids = {s.id: s for s in rec.spans}
    assert len(ids) == len(rec.spans)
    for s in rec.spans:
        if s.name == "inner":
            assert ids[s.parent].name == "outer" and ids[s.parent].thread == s.thread
        else:
            assert s.parent is None


def _tiny_renderer():
    from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer
    from stable_virtual_camera_tpu_torch.config import VersionConfig
    from stable_virtual_camera_tpu_torch.models.io import random_bundle

    bundle = random_bundle(device="cpu", generator=torch.Generator().manual_seed(0))
    renderer = HeadlessRenderer(bundle, work_dir=None)
    renderer.version = VersionConfig(H=64, W=64, T=4)
    return renderer


def test_two_pass_render_records_every_layer_and_changes_nothing():
    """A tiny two-pass Basic render under a recording: the renderer's
    planning spans, every engine stage but the grouped second pass's, the
    teardown, one `sample.step` a step of every chunk, the frame counters,
    all under the plan's request; the flushes on their worker with the
    same request. The frames are those of the render without a recording."""
    from stable_virtual_camera_tpu_torch.apps.renderer import preprocess_basic
    from stable_virtual_camera_tpu_torch.engine.runner import STAGES

    renderer = _tiny_renderer()
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    pre = preprocess_basic(img, shorter=64)
    kw = dict(preset_traj="orbit", num_frames=3, num_steps=2, seed=23)
    plain = list(renderer.run(renderer.prepare(pre, **kw)))
    with profiling.recording() as rec:
        plan = renderer.prepare(pre, **kw)
        recorded = list(renderer.run(plan))
    for a, b in zip(plain, recorded):
        np.testing.assert_array_equal(a, b)

    names = {s.name for s in rec.spans}
    assert names == (STAGES - {"second_pass_sample_many"}) | {
        "renderer.prepare", "renderer.anchors", "renderer.chunk_counts", "renderer.frames",
        "engine.split_frames", "engine.teardown", "sample.step"}
    rid = plan["request"]
    assert rid is not None and all(s.request == rid for s in rec.spans)
    table = profiling.summary(rec.spans)
    chunks = plan["first_pass_chunks"] + plan["second_pass_chunks"]
    assert table["sample.step"][0] == 2 * chunks
    by_id = {s.id: s for s in rec.spans}
    prepare = next(s for s in rec.spans if s.name == "renderer.prepare")
    for name in ("renderer.anchors", "renderer.chunk_counts", "renderer.frames"):
        assert next(s for s in rec.spans if s.name == name).parent == prepare.id
    assert {by_id[s.parent].name for s in rec.spans if s.name == "sample.step"} == {
        "first_pass_sample", "second_pass_sample"}
    main = prepare.thread
    assert {s.thread != main for s in rec.spans if s.name == "second_pass_flush"} == {True}
    assert rec.counts() == {"engine.frames_transformed": 4, "engine.frames_blank": 3}


def test_blank_frames_of_an_80_target_plan():
    """`_prepare_images` on an 80-target Basic plan transforms 81 frames,
    80 of them blank."""
    from stable_virtual_camera_tpu_torch.apps.renderer import preprocess_basic
    from stable_virtual_camera_tpu_torch.engine.runner import SceneEngine

    renderer = _tiny_renderer()
    img = np.random.default_rng(1).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    plan = renderer.prepare(preprocess_basic(img, shorter=64), preset_traj="orbit", num_frames=80, num_steps=2)
    engine = SceneEngine(renderer.bundle, plan["version"], plan["options"])
    camera_cond = dict(plan["camera_cond"], K=[np.asarray(k) for k in plan["camera_cond"]["K"]])
    with profiling.recording() as rec:
        with profiling.span("prepare_images"):
            engine._prepare_images(plan["image_cond"], camera_cond)
    assert rec.counts() == {"engine.frames_transformed": 81, "engine.frames_blank": 80}


def test_training_records_step_optimizer_and_data_spans():
    """Two steps of `make_train_step` fed by `device_prefetch` under a
    recording: `train.step` holds `train.loss`, `train.backward` and
    `train.optimizer`, one request a step; `data.wait` on the caller,
    `data.batch` on the producer thread. The losses are those of the
    same steps without a recording."""
    from stable_virtual_camera_tpu_torch.data import Dataset, DirectParser
    from stable_virtual_camera_tpu_torch.models.io import random_bundle
    from stable_virtual_camera_tpu_torch.training.data import SceneChunkSampler, device_prefetch
    from stable_virtual_camera_tpu_torch.training.optim import AdamW
    from stable_virtual_camera_tpu_torch.training.train_step import make_train_step, torch_draw

    from conftest import random_c2ws

    rng = np.random.default_rng(3)
    imgs = list(rng.integers(0, 256, size=(6, 64, 64, 3), dtype=np.uint8))
    c2ws = random_c2ws(rng, 6).astype(np.float32)[:, :3]
    Ks = np.repeat(np.array([[1.2, 0.0, 0.5], [0.0, 1.2, 0.5], [0.0, 0.0, 1.0]], np.float32)[None], 6, 0)
    sampler = SceneChunkSampler(Dataset(DirectParser(imgs, c2ws, Ks)), 3, 1, (64, 64))

    def steps(record: bool):
        bundle = random_bundle(device="cpu", generator=torch.Generator().manual_seed(0))
        step = make_train_step(bundle.unet, AdamW(list(bundle.unet.parameters()), 1e-3), 3)
        draw = torch_draw(torch.Generator().manual_seed(4))
        # two batches: the producer thread ends with the stream
        batches = device_prefetch(itertools.islice(sampler.batches(bundle.vae, bundle.clip, seed=5), 2), "cpu",
                                  size=2)
        rec = profiling.recording() if record else None
        try:
            losses = []
            for _ in range(2):
                with profiling.request():
                    losses.append(float(step(next(batches), draw)))
            assert next(batches, None) is None  # the producer is done
        finally:
            if rec is not None:
                rec.close()
        return losses, rec

    plain, _ = steps(False)
    losses, rec = steps(True)
    assert losses == plain
    by_id = {s.id: s for s in rec.spans}
    table = profiling.summary(rec.spans)
    for name in ("train.step", "train.loss", "train.backward", "train.optimizer"):
        assert table[name][0] == 2, name
    # two batches, then the end of the stream
    assert table["data.wait"][0] == table["data.batch"][0] == 3
    step_spans = [s for s in rec.spans if s.name == "train.step"]
    assert len({s.request for s in step_spans}) == 2 and None not in {s.request for s in step_spans}
    for name in ("train.loss", "train.backward", "train.optimizer"):
        assert {by_id[s.parent].name for s in rec.spans if s.name == name} == {"train.step"}
    main = step_spans[0].thread
    assert {s.thread for s in rec.spans if s.name == "data.wait"} == {main}
    assert main not in {s.thread for s in rec.spans if s.name == "data.batch"}


def test_trace_opens_spans_as_ranges_in_its_trace_alone(tmp_path):
    """Inside `trace`, a span is a named range in the profiler's events
    even with no recording open; after it, a span does nothing again."""
    x = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("ranged"):
            (x @ x).sum()
    assert any(e.key == "ranged" for e in prof.key_averages())
    assert profiling.span("after") is profiling.span("again")


def test_stage_timer_takes_spans_as_host_seconds():
    timer = profiling.StageTimer()
    timer.add([Span("final_save", 0, 250_000_000, 1, 1, None, None),
               Span("final_save", 0, 500_000_000, 1, 2, None, None)])
    assert timer.totals == {"final_save": pytest.approx(0.75)} and timer.counts == {"final_save": 2}
    assert timer.report().splitlines()[1].split() == ["final_save", "0.750", "2", "375.00"]


def test_request_ids_are_unique_across_threads():
    def ids(_):
        out = []
        for _ in range(500):
            with profiling.request() as rid:
                out.append(rid)
        return out

    with profiling.recording():
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            got = list(pool.map(ids, range(8)))
    flat = [i for ids in got for i in ids]
    assert len(set(flat)) == len(flat) == 4000
