"""Anchor ("prior") frame planning for two-pass sampling.

A copy of stable_virtual_camera_tpu/engine/prior.py without its
SVC_TFIRST_BUCKETS knob (reference seva/eval.py:344-490): how many
first-pass anchors to generate, where to place them, and the index maps the
CLI's tasks use. Pure numpy on the host.
"""

from __future__ import annotations

import math

import numpy as np


def infer_prior_stats(
    T: int | list[int] | tuple[int, int],
    num_input_frames: int,
    num_total_frames: int,
    version_config,
    options,
) -> int:
    """How many anchor frames the first pass generates. Rewrites
    `version_config.T` in place where the first-pass window changes, as the
    reference rewrites `version_dict["T"]` (seva/eval.py:387,420)."""
    chunk_strategy = options.get("chunk_strategy", "nearest")
    T_first_pass = T[0] if isinstance(T, (list, tuple)) else T
    T_second_pass = T[1] if isinstance(T, (list, tuple)) else T

    if chunk_strategy.startswith("interp"):
        if num_input_frames >= options.get("num_input_semi_dense", 9):
            num_prior_frames = (
                math.ceil(
                    num_total_frames / (T_second_pass - 2) * options.get("num_prior_frames_ratio", 1.0)
                )
                + 1
            )
            if num_prior_frames + num_input_frames < T_first_pass:
                num_prior_frames = T_first_pass - num_input_frames
            num_prior_frames = max(num_prior_frames, options.get("num_prior_frames", 0))
            T_first_pass = num_prior_frames + num_input_frames
            if "gt" in chunk_strategy:
                T_second_pass = T_second_pass + num_input_frames
            version_config.T = [T_first_pass, T_second_pass]
        else:
            num_prior_frames = (
                math.ceil(
                    num_total_frames
                    / (T_second_pass - 2 - (num_input_frames if "gt" in chunk_strategy else 0))
                    * options.get("num_prior_frames_ratio", 1.0)
                )
                + 1
            )
            economy = False
            if num_prior_frames + num_input_frames < T_first_pass:
                if options.get("min_anchor_fill", True):
                    num_prior_frames = T_first_pass - num_input_frames
                else:
                    # keep the anchor count near the feasibility minimum (one
                    # slack anchor: round(linspace) placement can overfill one
                    # gap by a target) and shrink the first-pass window to it
                    economy = True
                    num_prior_frames += 1
            num_prior_frames = max(num_prior_frames, options.get("num_prior_frames", 0))
            if economy:
                T_first_pass = min(num_prior_frames + num_input_frames, T_first_pass)
                version_config.T = [T_first_pass, T_second_pass]
    else:
        num_prior_frames = max(T_first_pass - num_input_frames, options.get("num_prior_frames", 0))
        if num_input_frames >= options.get("num_input_semi_dense", 9):
            T_first_pass = num_prior_frames + num_input_frames
            version_config.T = [T_first_pass, T_second_pass]

    return num_prior_frames


def plan_dense_anchors(
    num_targets: int,
    T_second: int,
    num_gt_inputs: int,
    deliver: bool = False,
) -> list[int]:
    """Anchors at exact target indices, in the fewest balanced gaps of at
    most `cap = T_second - 2 - num_gt_inputs` sampled targets each, so every
    second-pass interp chunk packs densely. With `deliver`, the target at an
    anchor is delivered from the first pass, so a gap of width g samples
    g - 1 targets. Returns sorted positions in [0, num_targets - 1] that
    include both ends."""
    cap = T_second - 2 - num_gt_inputs
    assert cap >= 1, f"no target slots: T_second={T_second} with {num_gt_inputs} gt inputs"
    if not deliver and cap < 2 and num_targets > 2:
        # without delivery the last gap samples its width plus the final
        # target, at least 2, so no anchor count fits (JAX loops forever)
        raise ValueError(
            f"plan_dense_anchors: T_second={T_second} with num_gt_inputs={num_gt_inputs} leaves "
            f"{cap} target slot a chunk, and without delivery (deliver={deliver}) the last gap "
            "needs 2; deliver the anchors or widen the window"
        )
    if num_targets <= 2:
        return list(range(num_targets))
    stride = cap + 1 if deliver else cap
    k = max(1, math.ceil((num_targets - 1) / stride))
    while True:
        pos = sorted({round(i * (num_targets - 1) / k) for i in range(k + 1)})
        widths = [b - a for a, b in zip(pos, pos[1:])]
        # the final target sits at the last anchor and joins the last gap
        sampled = [w - 1 if deliver else w for w in widths]
        if not deliver:
            sampled[-1] += 1
        if all(s <= cap for s in sampled):
            return pos
        k += 1  # balanced rounding overfilled a gap; one more anchor fixes it


def resolve_anchors(
    T: int | list[int] | tuple[int, int],
    num_input_frames: int,
    num_total_frames: int,
    version_config,
    options,
) -> tuple[list[float], bool]:
    """Anchor count and placement: dense placement (`plan_dense_anchors`)
    when `min_anchor_fill` is off, the strategy is interp and the inputs are
    sparse; else the reference's `infer_prior_stats` count with linspace
    placement. Returns (anchor positions relative to the ordered targets,
    whether dense placement was used) and rewrites `version_config.T`.
    Sets `options.deliver_anchors` when it is None (AUTO), and turns it off
    when the placement is not dense: delivery needs anchors at exact target
    positions. Callers hand it their own copy of the options."""
    chunk_strategy = options.get("chunk_strategy", "nearest")
    T_first = T[0] if isinstance(T, (list, tuple)) else T
    T_second = T[1] if isinstance(T, (list, tuple)) else T
    use_dense = (
        not options.get("min_anchor_fill", True)
        and chunk_strategy.startswith("interp")
        and num_input_frames < options.get("num_input_semi_dense", 9)
    )
    if use_dense:
        if options.get("deliver_anchors", None) is None:
            options.set("deliver_anchors", True)
        rel = plan_dense_anchors(
            num_total_frames,
            T_second,
            num_input_frames if "gt" in chunk_strategy else 0,
            deliver=bool(options.get("deliver_anchors", False)),
        )
        version_config.T = [min(len(rel) + num_input_frames, T_first), T_second]
        return [float(r) for r in rel], True
    if options.get("deliver_anchors", None) is not False:
        options.set("deliver_anchors", False)
    n = infer_prior_stats(T, num_input_frames, num_total_frames, version_config, options)
    return np.linspace(0, num_total_frames - 1, n).tolist(), False


def infer_prior_inds(
    c2ws: np.ndarray,
    num_prior_frames: int,
    input_frame_indices,
    options,
) -> np.ndarray:
    """Pick anchor indices among targets: equally spaced (interp) or greedy
    farthest-from-covered (reference seva/eval.py:425-453)."""
    chunk_strategy = options.get("chunk_strategy", "nearest")
    if chunk_strategy.startswith("interp"):
        prior_frame_indices = np.array(
            [i for i in range(c2ws.shape[0]) if i not in input_frame_indices]
        )
        prior_frame_indices = prior_frame_indices[
            np.ceil(
                np.linspace(
                    0, prior_frame_indices.shape[0] - 1, num_prior_frames, endpoint=True
                )
            ).astype(int)
        ]
    else:
        prior_frame_indices: list[int] = []
        while len(prior_frame_indices) < num_prior_frames:
            closest_distance = np.abs(
                np.arange(c2ws.shape[0])[None]
                - np.concatenate(
                    [np.array(input_frame_indices), np.array(prior_frame_indices)]
                )[:, None]
            ).min(0)
            prior_frame_indices.append(int(np.argsort(closest_distance)[-1]))
    return np.sort(prior_frame_indices)


def compute_relative_inds(source_inds: np.ndarray, target_inds: np.ndarray) -> list:
    """Map absolute ids into (fractional) positions relative to a sampled
    sequence (reference seva/eval.py:456-490)."""
    assert len(source_inds) > 2
    relative_inds = []
    for ind in target_inds:
        if ind in source_inds:
            relative_ind = int(np.where(source_inds == ind)[0][0])
        elif ind < source_inds[0]:
            relative_ind = -((source_inds[0] - ind) / (source_inds[1] - source_inds[0]))
        elif ind > source_inds[-1]:
            relative_ind = len(source_inds) + (
                (ind - source_inds[-1]) / (source_inds[-1] - source_inds[-2])
            )
        else:
            lower_inds = source_inds[source_inds < ind]
            upper_inds = source_inds[source_inds > ind]
            if len(lower_inds) > 0 and len(upper_inds) > 0:
                lower_ind = lower_inds[-1]
                upper_ind = upper_inds[0]
                relative_lower_ind = int(np.where(source_inds == lower_ind)[0][0])
                relative_upper_ind = int(np.where(source_inds == upper_ind)[0][0])
                relative_ind = relative_lower_ind + (ind - lower_ind) / (
                    upper_ind - lower_ind
                ) * (relative_upper_ind - relative_lower_ind)
            else:
                relative_inds.append(float("nan"))
                continue
        relative_inds.append(relative_ind)
    return relative_inds
