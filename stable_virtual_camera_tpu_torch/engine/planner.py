"""The procedural chunking planner.

Splits M input views + N target views into forward passes of exactly T frame
slots, emitting a symbolic schedule ("!i" = input view i, ">j" = target view
j, "NULL" = padding). Three strategy families — `gt[-nearest|-ltr]`,
`nearest[-N]`, `interp[-gt]` — with semantics matched step-for-step to
reference seva/eval.py:504-852 (`chunk_input_and_test`) plus the slot
pad/scatter helpers at seva/eval.py:44-96 (`pad_indices`, `assemble`).

Host-side pure numpy: schedules are tiny and deterministic given poses and
options. A copy of stable_virtual_camera_tpu/engine/planner.py.
"""

from __future__ import annotations

import collections
import math
import re
from dataclasses import dataclass

import numpy as np

from stable_virtual_camera_tpu_torch.core.camera import get_camera_dist


def find_nearest_source_inds(
    source_c2ws: np.ndarray,
    target_c2ws: np.ndarray,
    nearest_num: int = 1,
    mode: str = "translation",
) -> np.ndarray:
    """Per-target indices of the `nearest_num` closest source views
    (reference seva/eval.py:493-501). Returns (N_target, nearest_num)."""
    dists = get_camera_dist(source_c2ws, target_c2ws, mode=mode)
    sorted_inds = np.argsort(dists, axis=0, kind="stable").T
    return sorted_inds[:, :nearest_num]


def pad_indices(
    input_indices: list[int],
    test_indices: list[int],
    T: int,
    padding_mode: str = "last",
) -> tuple[list[int], list[int], np.ndarray, np.ndarray]:
    """Pad a chunk's slot selections to exactly T slots (repeat-last padding).

    Returns (input_indices, test_indices, input_maps, test_maps) where the
    maps are length-T arrays giving, per slot, the index into the chunk's
    input/test stream (-1 elsewhere). Exact port of reference
    seva/eval.py:44-82 semantics.
    """
    assert padding_mode in ("last", "none"), "`first` padding is not supported yet."
    if padding_mode == "last":
        padded_indices = [i for i in range(T) if i not in (input_indices + test_indices)]
    else:
        padded_indices = []
    input_selects = list(range(len(input_indices)))
    test_selects = list(range(len(test_indices)))
    if max(input_indices) > max(test_indices):
        input_selects += [input_selects[-1]] * len(padded_indices)
        input_indices = input_indices + padded_indices
        sorted_inds = np.argsort(input_indices, kind="stable")
        input_indices = [input_indices[ind] for ind in sorted_inds]
        input_selects = [input_selects[ind] for ind in sorted_inds]
    else:
        test_selects += [test_selects[-1]] * len(padded_indices)
        test_indices = test_indices + padded_indices
        sorted_inds = np.argsort(test_indices, kind="stable")
        test_indices = [test_indices[ind] for ind in sorted_inds]
        test_selects = [test_selects[ind] for ind in sorted_inds]

    if padding_mode == "last":
        input_maps = np.full(T, -1)
        test_maps = np.full(T, -1)
    else:
        n = len(input_indices) + len(test_indices)
        input_maps = np.full(n, -1)
        test_maps = np.full(n, -1)
    input_maps[input_indices] = input_selects
    test_maps[test_indices] = test_selects
    return input_indices, test_indices, input_maps, test_maps


def assemble(
    input: np.ndarray,
    test: np.ndarray,
    input_maps: np.ndarray,
    test_maps: np.ndarray,
) -> np.ndarray:
    """Scatter input/test frames into a T-length array per the slot maps
    (reference seva/eval.py:85-96)."""
    T = len(input_maps)
    assembled = np.zeros((T,) + test.shape[1:], dtype=test.dtype)
    assembled[input_maps != -1] = input[input_maps[input_maps != -1]]
    assembled[test_maps != -1] = test[test_maps[test_maps != -1]]
    assert np.logical_xor(input_maps != -1, test_maps != -1).all()
    return assembled


def _print_schedule(chunks: list[list[str]]) -> None:
    """Colorized schedule printout: red = input slots, green = target slots
    (reference seva/eval.py:833-844)."""
    try:
        from colorama import Fore, Style

        def colorize(item: str) -> str:
            if item.startswith("!"):
                return f"{Fore.RED}{item}{Style.RESET_ALL}"
            if item.startswith(">"):
                return f"{Fore.GREEN}{item}{Style.RESET_ALL}"
            return item
    except ImportError:  # pragma: no cover
        def colorize(item: str) -> str:
            return item

    print("\nchunks:")
    for chunk in chunks:
        print(", ".join(colorize(item) for item in chunk))


@dataclass
class ChunkPlan:
    """A full chunk schedule: symbolic chunks plus per-chunk index lists."""

    chunks: list[list[str]]
    input_inds_per_chunk: list[list[int]]  # index into the raw input sequence
    input_sels_per_chunk: list[list[int]]  # slot position within the T-window
    test_inds_per_chunk: list[list[int]]  # index into the raw test sequence
    test_sels_per_chunk: list[list[int]]  # slot position within the T-window

    def __iter__(self):
        return iter(
            (
                self.chunks,
                self.input_inds_per_chunk,
                self.input_sels_per_chunk,
                self.test_inds_per_chunk,
                self.test_sels_per_chunk,
            )
        )


def chunk_input_and_test(
    T: int,
    input_c2ws: np.ndarray,
    test_c2ws: np.ndarray,
    input_ords: list | None,
    test_ords: list | None,
    options,
    task: str = "img2img",
    chunk_strategy: str = "gt",
    gt_input_inds: list | None = None,
    verbose: bool | None = None,
) -> ChunkPlan:
    """Plan the T-slot forward passes. See module docstring.

    `options` is anything with a `.get(key, default)` (EngineOptions or dict).
    """
    gt_input_inds = gt_input_inds or []
    M, N = input_c2ws.shape[0], test_c2ws.shape[0]

    chunks: list[list[str]] = []
    if chunk_strategy.startswith("gt"):
        chunks = _plan_gt(
            T, test_c2ws, N, options, chunk_strategy, gt_input_inds
        )
    elif chunk_strategy.startswith("nearest"):
        chunks = _plan_nearest(
            T, input_c2ws, test_c2ws, M, N, chunk_strategy, gt_input_inds
        )
    elif chunk_strategy.startswith("interp"):
        chunks = _plan_interp(
            T, input_c2ws, M, N, input_ords, test_ords, task, chunk_strategy,
            gt_input_inds,
        )
    else:
        raise NotImplementedError(f"Unknown chunk strategy {chunk_strategy}.")

    input_inds_per_chunk, input_sels_per_chunk = [], []
    test_inds_per_chunk, test_sels_per_chunk = [], []
    for chunk in chunks:
        input_inds_per_chunk.append(
            [int(img.removeprefix("!")) for img in chunk if img.startswith("!")]
        )
        input_sels_per_chunk.append(
            [chunk.index(img) for img in chunk if img.startswith("!")]
        )
        test_inds_per_chunk.append(
            [int(img.removeprefix(">")) for img in chunk if img.startswith(">")]
        )
        test_sels_per_chunk.append(
            [chunk.index(img) for img in chunk if img.startswith(">")]
        )

    if verbose if verbose is not None else options.get("sampler_verbose", True):
        _print_schedule(chunks)

    return ChunkPlan(
        chunks,
        input_inds_per_chunk,
        input_sels_per_chunk,
        test_inds_per_chunk,
        test_sels_per_chunk,
    )


def _plan_gt(T, test_c2ws, N, options, chunk_strategy, gt_input_inds):
    """`gt[-nearest|-ltr]`: every chunk conditions on ALL ground-truth inputs;
    after the first chunk, optionally add pseudo-GT from already-generated
    targets (reference seva/eval.py:518-631)."""
    assert len(gt_input_inds) < T, (
        f"`gt` chunking needs the {len(gt_input_inds)} ground-truth inputs "
        f"to fit a {T}-frame chunk with room for at least one target"
    )
    M = len(gt_input_inds)
    assert list(range(M)) == gt_input_inds, (
        "`gt` chunking requires the ground-truth inputs to be the first "
        "input_c2ws entries (indices 0..M-1)"
    )

    chunks = []
    num_test_seen = 0
    while num_test_seen < N:
        chunk = [f"!{i:03d}" for i in gt_input_inds]
        if chunk_strategy != "gt" and num_test_seen > 0:
            pseudo_num_ratio = options.get("pseudo_num_ratio", 0.33)
            if (N - num_test_seen) >= math.floor(
                (T - len(gt_input_inds)) * pseudo_num_ratio
            ):
                pseudo_num = math.ceil((T - len(gt_input_inds)) * pseudo_num_ratio)
            else:
                pseudo_num = (T - len(gt_input_inds)) - (N - num_test_seen)
            pseudo_num = min(pseudo_num, options.get("pseudo_num_max", 10000))

            if "ltr" in chunk_strategy:
                chunk.extend(
                    f"!{i + len(gt_input_inds):03d}"
                    for i in range(num_test_seen - pseudo_num, num_test_seen)
                )
            elif "nearest" in chunk_strategy:
                source_inds = np.concatenate(
                    [
                        find_nearest_source_inds(
                            test_c2ws[:num_test_seen],
                            test_c2ws[num_test_seen:],
                            nearest_num=1,
                            mode="rotation",
                        ),
                        find_nearest_source_inds(
                            test_c2ws[:num_test_seen],
                            test_c2ws[num_test_seen:],
                            nearest_num=1,
                            mode="translation",
                        ),
                    ],
                    axis=1,
                )
                # Iterate until the pseudo count stabilizes: the vote pool size
                # depends on pseudo_num itself (reference seva/eval.py:565-599).
                temp_pseudo_num = pseudo_num
                while True:
                    votes = [
                        item
                        for item in source_inds[
                            : T - len(gt_input_inds) - temp_pseudo_num
                        ]
                        .flatten()
                        .tolist()
                        if item != (num_test_seen - 1)  # last one always kept below
                    ]
                    nearest_source_inds = np.concatenate(
                        [
                            np.sort(
                                [
                                    ind
                                    for (ind, _) in collections.Counter(votes)
                                    .most_common(pseudo_num - 1)
                                ]
                            ).astype(int),
                            [num_test_seen - 1],
                        ]
                    )
                    if len(nearest_source_inds) >= temp_pseudo_num:
                        break
                    temp_pseudo_num = len(nearest_source_inds)
                pseudo_num = len(nearest_source_inds)
                chunk.extend(
                    f"!{i + len(gt_input_inds):03d}" for i in nearest_source_inds
                )
            else:
                raise NotImplementedError(
                    f"Chunking strategy {chunk_strategy} for the first pass is "
                    "not implemented."
                )
            chunk.extend(
                f">{i:03d}"
                for i in range(
                    num_test_seen,
                    min(num_test_seen + T - len(gt_input_inds) - pseudo_num, N),
                )
            )
        else:
            chunk.extend(
                f">{i:03d}"
                for i in range(
                    num_test_seen, min(num_test_seen + T - len(gt_input_inds), N)
                )
            )

        num_test_seen += sum(1 for c in chunk if c.startswith(">"))
        if len(chunk) < T:
            chunk.extend(["NULL"] * (T - len(chunk)))
        chunks.append(chunk)
    return chunks


def _plan_nearest(T, input_c2ws, test_c2ws, M, N, chunk_strategy, gt_input_inds):
    """`nearest[-N]` / `nearest-gt`: condition each chunk on the nearest input
    views, greedily packing targets per input (reference seva/eval.py:633-724)."""
    input_imgs = np.array([f"!{i:03d}" for i in range(M)])
    test_imgs = np.array([f">{i:03d}" for i in range(N)])
    chunks = []

    match = re.match(r"^nearest-(\d+)$", chunk_strategy)
    if match:
        nearest_num = int(match.group(1))
        assert nearest_num < T, (
            f"nearest-{nearest_num} conditioning cannot fill a {T}-frame "
            f"chunk (need nearest_num < T)"
        )
        source_inds = find_nearest_source_inds(
            input_c2ws, test_c2ws, nearest_num=nearest_num, mode="translation"
        )
        for i in range(0, N, T - nearest_num):
            nearest_source_inds = np.sort(
                [
                    ind
                    for (ind, _) in collections.Counter(
                        source_inds[i : i + T - nearest_num].flatten().tolist()
                    ).most_common(nearest_num)
                ]
            )
            chunk = (
                input_imgs[nearest_source_inds].tolist()
                + test_imgs[i : i + T - nearest_num].tolist()
            )
            chunks.append(chunk + ["NULL"] * (T - len(chunk)))
        return chunks

    # `nearest` / `nearest-gt`: greedy packing by per-input target assignment.
    if "gt" not in chunk_strategy:
        gt_input_inds = []

    source_inds = find_nearest_source_inds(
        input_c2ws, test_c2ws, nearest_num=1, mode="translation"
    )[:, 0]

    test_inds_per_input: dict[int, list[int]] = {}
    for test_idx, input_idx in enumerate(source_inds):
        test_inds_per_input.setdefault(int(input_idx), []).append(test_idx)

    num_test_seen = 0
    chunk = input_imgs[gt_input_inds].tolist()
    candidate_input_inds = sorted(test_inds_per_input.keys())

    while num_test_seen < N:
        input_idx = candidate_input_inds[0]
        test_inds = test_inds_per_input[input_idx]
        input_is_cond = input_idx in gt_input_inds
        prefix_inds = [] if input_is_cond else [input_idx]

        if len(chunk) == T - len(prefix_inds) or not candidate_input_inds:
            if chunk:
                chunk += ["NULL"] * (T - len(chunk))
                chunks.append(chunk)
                chunk = input_imgs[gt_input_inds].tolist()
            if num_test_seen >= N:
                break
            continue

        candidate_chunk = (
            input_imgs[prefix_inds].tolist() + test_imgs[test_inds].tolist()
        )

        space_left = T - len(chunk)
        if len(candidate_chunk) <= space_left:
            chunk.extend(candidate_chunk)
            num_test_seen += len(test_inds)
            candidate_input_inds.pop(0)
        else:
            chunk.extend(candidate_chunk[:space_left])
            num_input_idx = 0 if input_is_cond else 1
            num_test_seen += space_left - num_input_idx
            test_inds_per_input[input_idx] = test_inds[space_left - num_input_idx :]

        if len(chunk) == T:
            chunks.append(chunk)
            chunk = input_imgs[gt_input_inds].tolist()

    if chunk and chunk != input_imgs[gt_input_inds].tolist():
        chunks.append(chunk + ["NULL"] * (T - len(chunk)))
    return chunks


def _plan_interp(
    T, input_c2ws, M, N, input_ords, test_ords, task, chunk_strategy, gt_input_inds
):
    """`interp[-gt]`: targets bracketed between consecutive ordered anchors
    (reference seva/eval.py:726-805)."""
    assert input_ords is not None and test_ords is not None, (
        "`interp` chunking requires input_ords and test_ords (the relative "
        "ordering of input and target frames along the trajectory)"
    )

    # For img2trajvid* the GT input views have unknown order w.r.t. targets;
    # drop them from the anchor set (reference seva/eval.py:735-745).
    if "img2trajvid" in task:
        assert list(range(len(gt_input_inds))) == gt_input_inds, (
            "`img2trajvid` task should put `gt_input_inds` in start."
        )
        keep = [ind for ind in range(M) if ind not in gt_input_inds]
        input_c2ws = input_c2ws[keep]
        input_ords = [input_ords[ind] for ind in keep]
        M = input_c2ws.shape[0]

    input_ords = [0] + list(input_ords)  # account for tests before first anchor
    input_ords[-1] += 0.01  # ensure the last test stop is included when equal
    input_ords = np.array(input_ords)[:, None]
    input_ords_ = np.concatenate([input_ords[1:], np.full((1, 1), np.inf)])
    test_ords = np.array(test_ords)[None]

    in_stop_ranges = np.logical_and(
        np.repeat(input_ords, N, axis=1) <= np.repeat(test_ords, M + 1, axis=0),
        np.repeat(input_ords_, N, axis=1) > np.repeat(test_ords, M + 1, axis=0),
    )  # (M+1, N)
    assert (in_stop_ranges.sum(1) <= T - 2).all(), (
        "More anchor frames need to be sampled during the first pass to ensure "
        f"#target frames during each forward in the second pass will not exceed {T - 2}."
    )
    if input_ords[1, 0] <= test_ords[0, 0]:
        assert not in_stop_ranges[0].any()
    if input_ords[-1, 0] >= test_ords[0, -1]:
        assert not in_stop_ranges[-1].any()

    gt_chunk = [f"!{i:03d}" for i in gt_input_inds] if "gt" in chunk_strategy else []
    chunks = []
    chunk = gt_chunk + []
    # tests before the first anchor
    if in_stop_ranges[0].any():
        for j, in_range in enumerate(in_stop_ranges[0]):
            if in_range:
                chunk.append(f">{j:03d}")
    in_stop_ranges = in_stop_ranges[1:]

    i = 0
    base_i = len(gt_input_inds) if "img2trajvid" in task else 0
    chunk.append(f"!{i + base_i:03d}")
    while i < len(in_stop_ranges):
        in_stop_range = in_stop_ranges[i]
        if not in_stop_range.any():
            i += 1
            continue

        input_left = i + 1 < M
        space_left = T - len(chunk)
        if sum(in_stop_range) + input_left <= space_left:
            for j, in_range in enumerate(in_stop_range):
                if in_range:
                    chunk.append(f">{j:03d}")
            i += 1
            if input_left:
                chunk.append(f"!{i + base_i:03d}")
        else:
            # feasibility guard: a freshly reset chunk means this gap's tests
            # can never fit in T - |gt_chunk| - 1 slots. The reference asserts
            # tests-per-gap <= T-2 (eval.py:759-762) but misses the gt-chunk
            # reduction, so its loop never terminates in this regime; we fail
            # loudly instead.
            assert len(chunk) > len(gt_chunk) + 1, (
                f"interp chunking infeasible: {int(in_stop_range.sum())} tests in "
                f"one anchor gap but only {T - len(gt_chunk) - 2} fit "
                f"(T={T}, {len(gt_chunk)} gt inputs); use a larger T, more "
                f"anchors, or a non-gt interp strategy"
            )
            chunk += ["NULL"] * space_left
            chunks.append(chunk)
            chunk = gt_chunk + [f"!{i + base_i:03d}"]

    if len(chunk) > 1:
        chunk += ["NULL"] * (T - len(chunk))
        chunks.append(chunk)
    return chunks
