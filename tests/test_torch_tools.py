"""The port's utilities against the JAX package's: utils/video.py,
utils/profiling.py (StageTimer's report, `trace` on torch.profiler, and the
engine's stage timer) and utils/trace_analysis.py (the Chrome-trace reader
and the kernel classifier)."""

import gzip
import json
import os.path as osp
import re

import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch.utils import profiling, trace_analysis
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse)

JAX_RUNNER = osp.join(osp.dirname(__file__), "..", "stable_virtual_camera_tpu", "engine", "runner.py")


def _smooth_frames():
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    frames = np.stack([
        np.stack([(xx + 3 * i) % 64 / 64, yy / 48, np.full_like(xx, 0.5)], -1) for i in range(6)
    ])
    return (frames * 255).astype(np.uint8)


def test_video_roundtrip_read_by_both(tmp_path):
    from stable_virtual_camera_tpu.utils.video import read_video as jax_read_video
    from stable_virtual_camera_tpu_torch.utils.video import read_video, write_video

    frames = _smooth_frames()
    path = str(tmp_path / "v.mp4")
    write_video(path, frames, fps=5)
    back = read_video(path)
    assert back.shape == frames.shape and back.dtype == np.uint8
    assert np.abs(back.astype(int) - frames.astype(int)).mean() < 12  # mp4 is lossy
    np.testing.assert_array_equal(back, jax_read_video(path))
    with pytest.raises(IOError):
        read_video(str(tmp_path / "missing.mp4"))
    with pytest.raises(ValueError):
        write_video(path, frames[..., :2], fps=5)


def test_engine_saving_has_one_write_video():
    from stable_virtual_camera_tpu_torch.engine import saving
    from stable_virtual_camera_tpu_torch.utils import video

    assert saving.write_video is video.write_video


def test_stage_timer_report_matches_jax(monkeypatch):
    """The same stages, calls and (fake) clock readings give the same report."""
    from stable_virtual_camera_tpu.utils.profiling import StageTimer as JaxStageTimer

    def run(timer_cls):
        clock = iter(np.cumsum([0.0, 0.25, 0.5, 0.125, 1.5, 0.03125, 2.0, 0.75, 0.0625]))
        monkeypatch.setattr("time.perf_counter", lambda: float(next(clock)))
        timer = timer_cls()
        for name in ("prepare_images", "first_pass_sample", "first_pass_sample", "final_save"):
            with timer.stage(name):
                pass
        return timer.report()

    ours = run(profiling.StageTimer)
    assert ours == run(JaxStageTimer)
    assert ours.splitlines()[0].startswith("stage") and len(ours.splitlines()) == 4


def _kineto_trace(path):
    """A Chrome trace in torch.profiler's layout: a CPU process, and a GPU
    process (pid 0) with two streams, its kernel, memcpy and memset events,
    and a GPU-side annotation range that is not device work."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 4242, "tid": 0, "args": {"labels": "CPU"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242, "tid": 1, "ts": 0, "dur": 900},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel(CUtensorMap, CUtensorMap)", "pid": 0,
         "tid": 7, "ts": 10, "dur": 300, "args": {"grid": [54, 5, 42], "block": [384, 1, 1]}},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel(CUtensorMap, CUtensorMap)", "pid": 0,
         "tid": 7, "ts": 400, "dur": 100, "args": {"grid": [14, 10, 42], "block": [384, 1, 1]}},
        {"ph": "X", "cat": "kernel", "name": "void time_attn_kernel<21>(CUtensorMap)", "pid": 0,
         "tid": 7, "ts": 600, "dur": 50, "args": {"grid": [132, 1, 1], "block": [256, 1, 1]}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "pid": 0,
         "tid": 8, "ts": 700, "dur": 20},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 8, "ts": 730,
         "dur": 5},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "forward", "pid": 0, "tid": 7, "ts": 0,
         "dur": 800},
    ]
    with gzip.open(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


def test_trace_analysis_reads_a_kineto_trace(tmp_path):
    _kineto_trace(tmp_path / "host_1.1.pt.trace.json.gz")
    dev = trace_analysis.device_events(trace_analysis.load_trace(str(tmp_path)))
    assert len(dev) == 5  # no CPU op, no annotation range
    totals = trace_analysis.class_totals(str(tmp_path))
    assert totals == {"K1 flash attention": 0.4, "K2 temporal attention": 0.05,
                      "elementwise and copies": 0.025}
    text = trace_analysis.summarize(str(tmp_path))
    assert "0.40  K1 flash attention" in text and "-- top ops (ms) --" in text
    top = trace_analysis.top_fusion_details(str(tmp_path), top=1)
    assert "flash_fwd_kernel" in top and "grid [54, 5, 42]" in top
    inst = trace_analysis.instances(str(tmp_path), name_filter="flash_fwd")
    assert inst.count("flash_fwd_kernel") == 2 and "grid [14, 10, 42]" in inst


def test_trace_on_the_cpu_writes_what_summarize_reads(tmp_path):
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("matmul"):
            (x @ x).sum()
    assert any(e.key == "matmul" for e in prof.key_averages())
    events = trace_analysis.load_trace(str(tmp_path))
    assert any(e.get("name") == "matmul" for e in events)
    # no card here: the trace holds no device work, and says so by reading empty
    assert trace_analysis.device_events(events) == []
    assert trace_analysis.summarize(str(tmp_path)).splitlines() == [
        "-- by category (ms) --", "-- top ops (ms) --"]


# kernel names as torch.profiler reported them on the H100 (PERF.md section 5:
# chip_smoke.py's profile_trace, train_profile and quant_path, cut where the
# script cuts them), each with its class. K3, K4 and K5 were not profiled by
# name; theirs are written in the form the card gives K1's and K2's.
KERNEL_NAMES = [
    ("(anonymous namespace)::flash_fwd_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "svc::sm90::FwdOut, int, int, float)", "K1 flash attention"),
    ("(anonymous namespace)::flash_bwd_dkv_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st",
     "K1-dKV"),
    ("(anonymous namespace)::flash_bwd_dq_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st,",
     "K1-dQ"),
    ("void (anonymous namespace)::time_attn_kernel<21>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::Operands, int, int, int, int, long long, int, int, "
     "int, bool, float)", "K2 temporal attention"),
    ("(anonymous namespace)::flash_blhd_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "svc::sm90::FwdOut, int, int, float)", "K3 flash attention"),
    ("(anonymous namespace)::flash_packed_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "svc::sm90::FwdOut, int, int, float)", "K4 flash attention"),
    ("void (anonymous namespace)::layer_norm_kernel<__nv_bfloat16>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, long long, int, int, int, float)",
     "K5 layer norm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16>(cutlass_8",
     "int8 GEMM (cuBLASLt)"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", "GEMM (cuBLAS)"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x64x32_"
     "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn", "convolution (cuDNN)"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous n",
     "optimizer"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<float, "
     "float, float, float>, unsigned int, float, 4, 4> >(at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, floa", "reductions"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::"
     "BinaryFunctor<float, float, float, at::native::binary_internal::MulFunctor<float> > >"
     "(at::TensorIteratorBase&, at::native::BinaryFunctor<float, float", "elementwise and copies"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::Tenso",
     "elementwise and copies"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous namespa",
     "elementwise and copies"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, float, 9, false, false>(float*, "
     "float const*, int, int, int, bool const*, int, bool)", "other"),
]


@pytest.mark.parametrize("name,cls", KERNEL_NAMES, ids=[f"{i}-{c}" for i, (_, c) in enumerate(KERNEL_NAMES)])
def test_categorize_gives_one_class_each(name, cls):
    assert trace_analysis.categorize(name) == cls
    matches = [c for c, rx in trace_analysis.KERNEL_CLASSES if re.search(rx, name)]
    assert (matches or ["other"])[0] == cls  # the first class whose pattern matches


def test_busy_time_counts_overlapping_streams_once():
    """chip_smoke.busy_intervals: the device's busy time is the union of its
    kernels' intervals over every stream, so rank streams whose kernels
    overlap count that time once; each stream's is its own union; host
    events and empty intervals are no device time."""
    import importlib.util
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    def event(start, end, stream, device=DeviceType.CUDA):
        return SimpleNamespace(device_type=device, device_resource_id=stream,
                               time_range=SimpleNamespace(start=start, end=end))

    events = [event(0, 1000, 7), event(500, 2000, 8), event(200, 400, 7), event(3000, 4000, 7),
              event(5000, 5000, 8), event(0, 9000, 0, DeviceType.CPU)]
    busy, streams = chip_smoke.busy_intervals(SimpleNamespace(events=lambda: events))
    assert busy == 3.0 and streams == {7: 2.0, 8: 1.5}


def _jax_stage_names() -> set[str]:
    with open(JAX_RUNNER) as f:
        return set(re.findall(r'stage\("([a-z_]+)"\)', f.read()))


def test_run_one_scene_timer_reports_jax_stage_names():
    """A two-pass tiny render with a StageTimer: every stage the port times
    carries the JAX engine's name for it. The JAX engine's cache priming
    (`second_pass_prime`) is part of the port's `second_pass_conditioning`,
    which times the serial second pass's prefetch window as JAX's does;
    the second pass's flushes run on a worker thread and are joined under
    `second_pass_flush_join`, as in JAX; its grouped second pass
    (`second_pass_sample_many`) runs only on a mesh's data axis or with
    `chunk_batch`, so not here."""
    from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer, preprocess_basic
    from stable_virtual_camera_tpu_torch.config import VersionConfig
    from stable_virtual_camera_tpu_torch.models.io import random_bundle

    bundle = random_bundle(device="cpu", generator=torch.Generator().manual_seed(0))
    renderer = HeadlessRenderer(bundle, work_dir=None)
    renderer.version = VersionConfig(H=64, W=64, T=4)
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    plan = renderer.prepare(preprocess_basic(img, shorter=64), preset_traj="orbit", num_frames=3,
                            num_steps=2, seed=23)
    timer = profiling.StageTimer()
    anchors, frames = list(renderer.run(plan, timer=timer))
    untimed = list(renderer.run(plan))

    assert set(timer.totals) == {
        "prepare_images", "first_pass_build", "first_pass_sample", "first_pass_decode_extend",
        "first_pass_save", "second_pass_plan", "second_pass_build", "second_pass_conditioning",
        "second_pass_sample", "second_pass_flush", "second_pass_flush_join", "final_save",
    }
    assert set(timer.totals) <= _jax_stage_names()
    assert timer.counts["first_pass_sample"] == plan["first_pass_chunks"]
    assert timer.counts["second_pass_sample"] == plan["second_pass_chunks"]
    # the timer changes nothing the render computes
    np.testing.assert_array_equal(anchors, untimed[0])
    np.testing.assert_array_equal(frames, untimed[1])


def test_cli_engine_timing_prints_jax_stage_names(tmp_path, capsys):
    """`cli.main(..., engine_timing=True)` on the golden scene with the tiny
    bundle prints an `[engine timing]` report per scene, whose stages carry
    the JAX engine's names and cover both passes."""
    from stable_virtual_camera_tpu_torch.apps import cli

    golden = osp.join(osp.dirname(__file__), "..", "assets", "golden_scene")
    (out_dir,) = cli.main(golden, task="img2trajvid", use_traj_prior=True, random_model=True,
                          device="cpu", num_steps=2, guider_types=[1, 2], cfg=[2.0, 2.0],
                          sampler_verbose=False, engine_timing=True, work_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert osp.exists(osp.join(out_dir, "samples-rgb.mp4"))
    report = out.split("[engine timing]\n", 1)[1].split("[cli] scene done:", 1)[0].strip().splitlines()
    assert report[0].split() == ["stage", "total_s", "calls", "mean_ms"]
    names = {line.split()[0] for line in report[1:]}
    assert {"prepare_images", "first_pass_sample", "second_pass_sample", "final_save"} <= names
    assert names <= _jax_stage_names()
