"""Typed configuration: the UNet spec, the resolution/window config and the
engine options, with the names and defaults of the JAX package's
stable_virtual_camera_tpu/config.py (which the port does not import)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class SevaSpec:
    """Architecture hyperparameters of the multiview diffusion UNet.
    `in_channels=11` = 4 latent + 1 input-mask + 6 Plücker channels."""

    in_channels: int = 11
    model_channels: int = 320
    out_channels: int = 4
    num_frames: int = 21
    num_res_blocks: int = 2
    attention_resolutions: tuple[int, ...] = (4, 2, 1)
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: tuple[int, ...] = (1, 1, 1, 1)
    context_dim: int = 1024
    dense_in_channels: int = 6
    dropout: float = 0.0
    unflatten_names: tuple[str, ...] = ("middle_ds8", "output_ds4", "output_ds2")

    def __post_init__(self) -> None:
        assert len(self.channel_mult) == len(self.transformer_depth)

    @staticmethod
    def tiny() -> "SevaSpec":
        """A topology-complete but tiny spec for tests."""
        return SevaSpec(model_channels=32, num_frames=3, num_head_channels=16, context_dim=64)


@dataclass
class VersionConfig:
    """Resolution and context window. `T` may be an int or a [T_first,
    T_second] pair; anchor planning (engine/prior.py) rewrites it."""

    H: int = 576
    W: int = 576
    T: int | list[int] = 21
    C: int = 4
    f: int = 8


@dataclass
class EngineOptions:
    """The engine's options, read through `get` like the reference's options
    dict. Unknown keys land in `extras`."""

    chunk_strategy: str = "nearest-gt"
    chunk_strategy_first_pass: str = "gt-nearest"
    video_save_fps: float = 30.0
    beta_linear_start: float = 5e-6
    beta_linear_end: float = 0.012
    log_snr_shift: float | None = 2.4
    guider_types: int | list[int] = 1
    cfg: float | list[float] = 2.0
    cfg_min: float = 1.2
    camera_scale: float = 2.0
    num_steps: int = 50
    encoding_t: int = 1
    decoding_t: int = 1
    num_inputs: int | str | None = None
    seed: int = 23
    num_targets: int | None = None
    traj_prior: str | None = None
    num_prior_frames: int = 0
    num_prior_frames_ratio: float = 1.0
    num_input_semi_dense: int = 9
    pseudo_num_ratio: float = 0.33
    pseudo_num_max: int = 10000
    t_padding_mode: str = "last"
    transform_input: str = "crop"
    transform_target: str = "crop"
    transform_scale: float = 1.0
    L_short: int = -1
    ltr_first_pass: bool = False
    sampler_verbose: bool = True
    save_input: bool = True
    save_first_pass: bool = True
    save_second_pass: bool = False
    replace_or_include_input: bool = False
    skip_saved: bool = False
    # False keeps the first-pass anchor count near its feasibility minimum
    # with dense placement (engine/prior.plan_dense_anchors); True fills the
    # first-pass window to T - 1 anchors as the reference does
    min_anchor_fill: bool = False
    # targets whose pose and K equal a first-pass anchor's are delivered from
    # the first pass instead of denoised again; None = on exactly when the
    # dense anchor placement is used (engine/prior.resolve_anchors)
    deliver_anchors: bool | None = None

    extras: dict[str, Any] = field(default_factory=dict)

    def get(self, key: str, default: Any = None) -> Any:
        if hasattr(self, key) and key != "extras":
            return getattr(self, key)
        return self.extras.get(key, default)

    def set(self, key: str, value: Any) -> None:
        if hasattr(self, key) and key != "extras":
            setattr(self, key, value)
        else:
            self.extras[key] = value

    def update(self, other: dict[str, Any]) -> "EngineOptions":
        for k, v in other.items():
            self.set(k, v)
        return self
