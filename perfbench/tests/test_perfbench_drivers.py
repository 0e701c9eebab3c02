"""The drivers' whole runs at tiny size on the CPU, called directly (the look
for a card skipped): a sound run comes out correct, and the timed path
broken underneath comes out not correct, once for each fault the cell can
have (one card: no exchange between chips to leave out). A control run (the
reference one precision down in the program's place) comes out not correct
too, through the same result line."""

import dataclasses
import time

import pytest
import torch

from perfbench import faults, harness
from perfbench.drivers import finetune, render

# pass 1 sends requests until the deadline; pass 2's whole second pass at
# tiny size (5 chunks of 4 steps) takes some 10-15 s here, so its window is
# shorter than that, and still holds the first chunk and its decode
WINDOW_S = {1: 15.0, 2: 6.0}
SEED = 2**31 + 11


def tiny_cell(pass_id: int) -> harness.Cell:
    from stable_virtual_camera_tpu_torch.config import SevaSpec
    from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec

    cfg = harness.load_json(harness.HERE / "configs" / "seva-bf16.json")
    cfg["unet"] = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(SevaSpec.tiny()).items()}
    cfg["clip"] = dataclasses.asdict(ClipVisionSpec.tiny())
    cfg["dtype"] = "float32"
    cfg["sampler"]["num_steps"] = 4
    name = f"basic-768x576-pass{pass_id}"
    tr = harness.load_json(harness.HERE / "traffic" / f"basic-orbit80-768x576-pass{pass_id}.json")
    tr.update(image_hw=[64, 64], shorter=64, capture_step=1)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return harness.Cell(name, 1, cfg, tr, harness.load_json(harness.HERE / "limits" / f"{name}.json"),
                        e2e, [])


def drive(pass_id: int, control: bool = False) -> harness.Context:
    torch.manual_seed(0)
    ctx = harness.Context(tiny_cell(pass_id), SEED, WINDOW_S[pass_id], False, time.perf_counter(), device="cpu",
                          control=control)
    render.run(ctx)
    return ctx


def correct(ctx) -> bool:
    out, lines = harness.result_line(ctx)
    assert len(lines) == out["attempted"] == len(ctx.cell.limits)
    assert list(out)[-1] == "checks"
    return out["correct"]


@pytest.mark.parametrize("pass_id", [1, 2])
def test_a_sound_run_is_correct(pass_id):
    ctx = drive(pass_id)
    assert correct(ctx)
    run = ctx.run
    metric = ctx.cell.traffic["step_metric"]
    assert run.steps > 4 and run.end_to_end[metric] == pytest.approx(run.window_s / run.steps)
    assert run.window_s >= WINDOW_S[pass_id] and run.end_to_end["setup_s"] > 0
    assert run.step_flops > 0 and run.step_k1_bound_s == 0  # tiny: head dim 16, no K1 site


def within(readings: dict, limits: dict) -> bool:
    return all(v <= limits[k] for k, v in readings.items())


def test_the_control_fails_the_cells_limits():
    ctx = drive(1, control=True)
    assert not correct(ctx)
    # the control's readings took the program's place, and the program's own pass
    assert set(ctx.run.control) < set(ctx.run.checks) and within(ctx.run.program, ctx.cell.limits)
    assert all(ctx.run.checks[k][0] == v for k, v in ctx.run.control.items())


@pytest.mark.parametrize("fault", faults.faults_of("render"))
def test_a_broken_render_is_not_correct(fault):
    with faults.plant(fault, "render"):
        assert not correct(drive(1))


def tiny_finetune_cell() -> harness.Cell:
    from stable_virtual_camera_tpu_torch.config import SevaSpec
    from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec

    name = "finetune-576-t21"
    cfg = harness.load_json(harness.HERE / "configs" / "seva-bf16-finetune.json")
    cfg["unet"] = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(SevaSpec.tiny()).items()}
    cfg["unet"]["num_frames"] = 21
    cfg["clip"] = dataclasses.asdict(ClipVisionSpec.tiny())
    cfg["dtype"] = "float32"
    tr = harness.load_json(harness.HERE / "traffic" / "finetune-orbit32-576-t21.json")
    tr.update(image_hw=[64, 64], num_views=8, trace_steps=[1, 2])
    return harness.Cell(name, 1, cfg, tr, harness.load_json(harness.HERE / "limits" / f"{name}.json"),
                        [], [])


def drive_finetune(control: bool = False) -> harness.Context:
    torch.manual_seed(0)
    ctx = harness.Context(tiny_finetune_cell(), SEED, 2.0, False, time.perf_counter(), device="cpu", control=control)
    finetune.run(ctx)
    return ctx


def test_a_sound_fine_tune_is_correct_and_its_control_is_not():
    ctx = drive_finetune(control=True)
    assert not correct(ctx)
    assert within(ctx.run.program, ctx.cell.limits)
    assert all(ctx.run.checks[k][0] == v for k, v in ctx.run.control.items())
    assert ctx.run.steps >= 1 and ctx.run.end_to_end["train_step_s"] > 0
    assert ctx.run.extra["batch_wait_ms"] >= 0


@pytest.mark.parametrize("fault", faults.faults_of("finetune"))
def test_a_broken_fine_tune_is_not_correct(fault):
    with faults.plant(fault, "finetune"):
        assert not correct(drive_finetune())
