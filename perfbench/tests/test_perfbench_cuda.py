"""On the card: the weights are the same for a seed run after run, the
profiler sees the device's work through the benchmark's sub-window, and
the reference's blocked attention agrees with its unblocked form."""

import time

import pytest
import torch

from perfbench import harness, trace, weights
from perfbench.reference.precision import Precision, attention, strict_fp32

pytestmark = pytest.mark.cuda


def test_weights_repeat_for_a_seed(card):
    cfg = harness.load_json(harness.HERE / "configs" / "seva-bf16.json")
    model = weights.reference_models(cfg)[1]  # the VAE: 84M parameters
    a = weights.make(model, torch.Generator(card).manual_seed(3), torch.bfloat16, card)
    b = weights.make(model, torch.Generator(card).manual_seed(3), torch.bfloat16, card)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_the_sub_window_sees_device_work(card):
    """Device-bound steps read busy nearly all the window, on the host's
    clock, and a host pause between two of them reads as an idle gap in the
    span that was open."""
    strict_fp32()
    sub = harness.SubWindow(True, 1, 4, card)
    sub.warm()
    x = torch.randn(4096, 4096, device=card)
    for step in range(1, 6):
        for _ in range(8):
            x = (x @ x).tanh()
        if step == 3:
            sub.span("chunk_boundary")  # opened while the card is still busy
            torch.cuda.synchronize(card)
            time.sleep(0.05)
        sub.at_step(step, "step")
    run = harness.RunData()
    sub.reduce(run)
    tw = run.traced
    assert run.traced_steps == 3 and 0 < tw.busy_s <= tw.window_s
    assert tw.window_s - tw.busy_s == pytest.approx(0.05, abs=0.01)
    assert tw.idle_gaps[0][0] == "chunk_boundary" and tw.idle_gaps[0][1] == pytest.approx(0.05, abs=0.01)


def test_blocked_attention_on_the_card(card):
    strict_fp32()
    g = torch.Generator(card).manual_seed(0)
    q, k, v = (torch.randn((2, 4, 3000, 64), generator=g, device=card) for _ in range(3))
    full = torch.softmax(q @ k.transpose(-1, -2) * 0.125, -1) @ v
    torch.testing.assert_close(attention(Precision(), q, k, v, budget_bytes=1 << 22), full)
