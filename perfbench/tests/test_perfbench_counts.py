"""perfbench/counts: the reference's count against torch's FlopCounterMode
over the port's UNet, and its attention sites against the calls the port's
UNet makes."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.counts import peaks
from perfbench.counts import unet as counts

# (frames, T, h, w) of the cells: the second pass's 42-frame CFG forward at
# 768x576, the first pass's 14-frame one, and a training chunk at 576^2
SHAPES = [(42, 21, 72, 96), (14, 7, 72, 96), (21, 21, 72, 72)]
TFLOP = {(42, 21, 72, 96): 107.850107419648, (14, 7, 72, 96): 30.866571498496,
         (21, 21, 72, 72): 37.034301648032}


def spec_dict(spec):
    return {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(spec).items()}


@pytest.fixture(scope="module")
def full():
    from stable_virtual_camera_tpu_torch.config import SevaSpec
    from stable_virtual_camera_tpu_torch.models.unet import SevaUNet

    with torch.device("meta"):
        return SevaUNet(SevaSpec(), attention="plain"), spec_dict(SevaSpec())


def meta_inputs(B, h, w, ctx=1024):
    return (torch.empty(B, h, w, 11, device="meta"), torch.zeros(B, dtype=torch.long, device="meta"),
            torch.empty(B, 1, ctx, device="meta"), torch.empty(B, h, w, 6, device="meta"))


@pytest.fixture(scope="module")
def counted(full):
    _unet, spec = full
    return {shape: counts.count(spec, *shape) for shape in SHAPES}


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_flops_equal_flop_counter(full, counted, shape):
    """The reference does the port's work: the same products, bar the port's
    resize of the Plucker map to each level, which the port makes two small
    matrix products and the reference an interpolation (not counted)."""
    unet, _spec = full
    B, T, h, w = shape
    with FlopCounterMode(display=False) as fc:
        unet(*meta_inputs(B, h, w), T)
    port = fc.get_total_flops()
    assert abs(port / 1e12 - TFLOP[shape]) < 1e-9
    assert 0 <= port - counted[shape].flops <= 1e-4 * port


@pytest.mark.parametrize("shape", SHAPES)
def test_attention_sites_match_the_unets_calls(full, counted, shape, monkeypatch):
    from stable_virtual_camera_tpu_torch.models import unet as port_unet

    unet, spec = full
    B, T, h, w = shape
    k1, k2 = [], []
    plain_k1, plain_k2 = port_unet.flash_attention_plain, port_unet.time_attention_plain

    def rec_k1(q, k, v):
        k1.append(tuple(q.shape))  # (B, H, L, D)
        return plain_k1(q, k, v)

    def rec_k2(q, k, v, frames):
        k2.append((q.shape[0] // frames * q.shape[3], frames, q.shape[1], q.shape[2]))
        return plain_k2(q, k, v, frames)

    monkeypatch.setattr(port_unet, "flash_attention_plain", rec_k1)
    monkeypatch.setattr(port_unet, "time_attention_plain", rec_k2)
    unet(*meta_inputs(B, h, w), T)
    assert k1 == [(s.sequences, s.H, s.L, s.D) for s in counted[shape].k1_sites]
    assert k2 == [(s.sequences, s.L, s.H, s.D) for s in counted[shape].k2_sites]


def test_bounds_are_the_larger_of_operations_and_bytes(counted):
    assert peaks.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    site = counts.Site("spatial", 2, 36288, 10, 64)
    assert site.flops == 4.0 * 2 * 10 * 36288**2 * 64
    assert site.bytes_bf16 == 4.0 * 2 * 10 * 36288 * 64 * 2
    # at 768x576 every K1 site is bound by its operations
    fwd = counted[(42, 21, 72, 96)]
    assert fwd.k1_bound_s() == pytest.approx(sum(s.flops for s in fwd.k1_sites) / 989e12)
