"""Command-line app with the reference demo's flag surface.

Counterpart of stable_virtual_camera_tpu/apps/cli.py (reference
demo.py:68-404): the four tasks (img2img, img2vid, img2trajvid,
img2trajvid_s-prob), reconfusion split resolution, anchor synthesis
(spiral / interpolated / orbit / presets), the per-scene loop with
skip_saved, and the OpenCV -> OpenGL transforms.json export.

Model loading: --checkpoint_dir loads a directory holding the converted
cache (apps/convert_weights.py) or the released `model.safetensors`,
`vae.safetensors` and `clip.safetensors`, in bf16 (models/io.load_bundle);
--random_model True runs the tiny fp32 bundle at 64x64, --random_model
full the full-width bf16 one at 576x576. --quant w8a8 | w8a8-static | 0
sets the UNet's W8A8 serving mode (ops/quant.py; the static form calibrates
on the first chunk it renders).

Multi-device sampling (parallel/): --mesh_view N shards every chunk whose
T divides N over N ranks (a chunk of any other T runs unsharded, with a
warning), --mesh_data M fans the second pass's chunks out over M rows of
ranks; the mesh takes one CUDA device a rank (more ranks than devices
raise), or with --device cpu repeats the CPU. --mesh_model K > 1 adds a
"model" axis (a data x view x model mesh): every chunk's UNet weights
shard over K ranks (parallel/tensor_parallel.py), with the frames still
over the view axis; the second pass's data-parallel groups run whole
weights, as in JAX. --platform cpu | gpu picks the device as --device does
(tpu raises: the TPU build is the JAX package).

The port's own flags: --device (default cuda) and --attention, the
self-attention backend ("upstream", kernel K1; "flash", kernel K3;
"packed", kernel K4 where W % 128 == 0, else K3; "plain", no kernel),
which takes the place of the JAX package's SVC_UPSTREAM_FLASH /
SVC_PACKED_ATTENTION environment knobs. Left unset it is "upstream"; the
kernels take bf16 and fp32, so the tiny fp32 bundle runs them on the card
too. --engine_timing
True prints each scene's engine stages (utils/profiling.StageTimer: host
seconds a stage, with no device synchronize, so the render is the one run
untimed), which takes the place of the JAX package's SVC_ENGINE_TIMING.

Invocation (fire-style `--key value` or `--key=value` flags):
  python -m stable_virtual_camera_tpu_torch.apps.cli --data_path ... --task img2img
"""

from __future__ import annotations

import copy
import glob as globlib
import os.path as osp
import sys

import numpy as np
import torch

from stable_virtual_camera_tpu_torch.config import EngineOptions, VersionConfig
from stable_virtual_camera_tpu_torch.core.camera import get_default_intrinsics
from stable_virtual_camera_tpu_torch.core.trajectories import (
    generate_interpolated_path,
    generate_spiral_path,
    get_arc_horizontal_w2cs,
    get_lookat,
    get_preset_pose_fov,
)
from stable_virtual_camera_tpu_torch.data.parsers import get_parser
from stable_virtual_camera_tpu_torch.engine.prior import (
    compute_relative_inds,
    infer_prior_inds,
    infer_prior_stats,
    resolve_anchors,
)
from stable_virtual_camera_tpu_torch.engine.runner import SceneEngine
from stable_virtual_camera_tpu_torch.engine.saving import create_transforms_simple
from stable_virtual_camera_tpu_torch.ops.quant import serving_mode
from stable_virtual_camera_tpu_torch.sampling.sampler import torch_noise
from stable_virtual_camera_tpu_torch.utils.profiling import StageTimer

WORK_DIR = "work_dirs/demo"


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _image_wh(path: str) -> tuple[int, int]:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"Could not read image {path}")
    return img.shape[1], img.shape[0]


def parse_task(task, scene, num_inputs, T, version: VersionConfig, options: EngineOptions):
    """Resolve a task into (paths, indices, poses, Ks, anchors)
    (reference demo.py:68-271)."""
    anchor_indices = None
    anchor_c2ws = None
    anchor_Ks = None

    if task == "img2trajvid_s-prob":
        if num_inputs is not None:
            assert num_inputs == 1, "Task `img2trajvid_s-prob` only supports 1-view conditioning."
        else:
            num_inputs = 1
        T_ = T[0] if isinstance(T, (list, tuple)) else T
        num_targets = options.get("num_targets", None) or T_ - 1
        num_anchors = infer_prior_stats(T, num_inputs, num_targets, version, options)

        input_indices = [0]
        anchor_indices = np.linspace(1, num_targets, num_anchors).tolist()
        all_imgs_path = [scene] + [None] * num_targets

        c2ws, fovs = get_preset_pose_fov(
            option=options.get("traj_prior", None) or "orbit",
            num_frames=num_targets + 1,
            start_w2c=np.eye(4),
            look_at=np.array([0.0, 0.0, 10.0]),
        )
        W, H = _image_wh(scene)
        Ks = get_default_intrinsics(fovs, aspect_ratio=W / H).astype(np.float64)
        Ks[:, :2] *= np.array([W, H], dtype=np.float64).reshape(1, 2, 1)  # unnormalized

        anchor_c2ws = c2ws[[round(ind) for ind in anchor_indices]]
        anchor_Ks = Ks[[round(ind) for ind in anchor_indices]]
    else:
        parser = get_parser("reconfusion", data_dir=scene, normalize=False)
        all_imgs_path = parser.image_paths
        c2ws = parser.camtoworlds
        Ks = np.concatenate([parser.Ks_dict[cam_id][None] for cam_id in parser.camera_ids], 0)

        if num_inputs is None:
            assert len(parser.splits_per_num_input_frames.keys()) == 1
            num_inputs = list(parser.splits_per_num_input_frames.keys())[0]
            split_dict = parser.splits_per_num_input_frames[num_inputs]
        elif isinstance(num_inputs, str):
            split_dict = parser.splits_per_num_input_frames[num_inputs]
            num_inputs = int(num_inputs.split("-")[0])
        else:
            split_dict = parser.splits_per_num_input_frames[num_inputs]

        num_targets = len(split_dict["test_ids"])

        if task == "img2img":
            num_anchors = infer_prior_stats(T, num_inputs, num_targets, version, options)
            sampled_indices = np.sort(np.array(split_dict["train_ids"] + split_dict["test_ids"]))
            traj_prior = options.get("traj_prior", None)
            if traj_prior == "spiral":
                assert parser.bounds is not None
                flip = np.diag([1.0, -1.0, -1.0, 1.0])
                anchor_c2ws = generate_spiral_path(
                    c2ws[sampled_indices] @ flip,
                    parser.bounds[sampled_indices],
                    n_frames=num_anchors + 1,
                    n_rots=2,
                    zrate=0.5,
                    endpoint=False,
                )[1:] @ flip
            elif traj_prior == "interpolated":
                assert num_inputs > 1
                anchor_c2ws = generate_interpolated_path(
                    c2ws[split_dict["train_ids"], :3],
                    round((num_anchors + 1) / (num_inputs - 1)),
                    endpoint=False,
                )[1 : num_anchors + 1]
            elif traj_prior == "orbit":
                lookat = get_lookat(c2ws[sampled_indices, :3, 3], c2ws[sampled_indices, :3, 2])
                anchor_c2ws = np.linalg.inv(
                    get_arc_horizontal_w2cs(
                        np.linalg.inv(c2ws[split_dict["train_ids"][0]]),
                        lookat,
                        -_normalize(c2ws[split_dict["train_ids"]][:, :3, 1].mean(0)),
                        num_frames=num_anchors + 1,
                        endpoint=False,
                    )
                )[1:, :3]
            else:
                anchor_c2ws = None

            all_imgs_path = [all_imgs_path[i] for i in sampled_indices]
            c2ws = c2ws[sampled_indices]
            Ks = Ks[sampled_indices]
            input_indices = compute_relative_inds(sampled_indices, np.array(split_dict["train_ids"]))
            anchor_indices = np.arange(
                sampled_indices.shape[0], sampled_indices.shape[0] + num_anchors
            ).tolist()

        elif task == "img2vid":
            num_targets = len(all_imgs_path) - num_inputs
            num_anchors = infer_prior_stats(T, num_inputs, num_targets, version, options)
            input_indices = split_dict["train_ids"]
            anchor_indices = infer_prior_inds(
                c2ws, num_prior_frames=num_anchors, input_frame_indices=input_indices, options=options,
            ).tolist()
            num_anchors = len(anchor_indices)
            anchor_c2ws = c2ws[anchor_indices, :3]
            anchor_Ks = Ks[anchor_indices]

        elif task == "img2trajvid":
            # dense economy placement (+ optional anchor delivery) when
            # min_anchor_fill=False; the reference's linspace otherwise
            rel, _dense = resolve_anchors(T, num_inputs, num_targets, version, options)
            num_anchors = len(rel)
            target_c2ws = c2ws[split_dict["test_ids"], :3]
            target_Ks = Ks[split_dict["test_ids"]]
            sel = np.round(np.asarray(rel)).astype(np.int64)
            anchor_c2ws = target_c2ws[sel]
            anchor_Ks = target_Ks[sel]

            sampled_indices = split_dict["train_ids"] + split_dict["test_ids"]
            all_imgs_path = [all_imgs_path[i] for i in sampled_indices]
            c2ws = c2ws[sampled_indices]
            Ks = Ks[sampled_indices]
            input_indices = np.arange(num_inputs).tolist()
            anchor_indices = [num_inputs + r for r in rel]
        else:
            raise ValueError(f"Unknown task: {task}")

    return (
        all_imgs_path,
        num_inputs,
        num_targets,
        input_indices,
        anchor_indices,
        np.asarray(c2ws)[:, :3].astype(np.float32),
        np.asarray(Ks).astype(np.float32),
        (np.asarray(anchor_c2ws)[:, :3].astype(np.float32) if anchor_c2ws is not None else None),
        (np.asarray(anchor_Ks).astype(np.float32) if anchor_Ks is not None else None),
    )


def _default_options() -> EngineOptions:
    """The demo's option defaults (reference demo.py:292-306), with the VAE
    run on a chunk's frames in one batch (0 = unchunked), as the JAX CLI
    runs it."""
    return EngineOptions(
        chunk_strategy="nearest-gt",
        video_save_fps=30.0,
        beta_linear_start=5e-6,
        log_snr_shift=2.4,
        guider_types=1,
        cfg=2.0,
        camera_scale=2.0,
        num_steps=50,
        cfg_min=1.2,
        encoding_t=0,
        decoding_t=0,
        num_inputs=None,
        seed=23,
    )


PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}


def platform_device(platform, device):
    """The device `--platform` names (JAX's cpu | gpu | tpu), else `device`."""
    if platform is None:
        return device
    if str(platform) not in PLATFORMS:
        raise ValueError(f"--platform {platform!r}: the port runs on 'gpu' (CUDA) or 'cpu'; "
                         "the TPU build is the JAX package")
    return PLATFORMS[str(platform)]


def build_mesh(mesh_view=None, mesh_data=None, mesh_model=None, device="cuda"):
    """The ("data", "view") mesh of --mesh_data and --mesh_view, with
    --mesh_model > 1 the ("data", "view", "model") one, or None when all
    are 1 or unset: one CUDA device a rank on the card (more ranks than
    devices raise), the CPU repeated off it."""
    n_view = int(mesh_view) if mesh_view else 1
    n_data = int(mesh_data) if mesh_data else 1
    n_model = int(mesh_model) if mesh_model else 1
    if n_view == 1 and n_data == 1 and n_model == 1:
        return None
    from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh, make_mesh_tp

    dev = torch.device(device)
    devices = None if dev.type == "cuda" else [dev] * (n_data * n_view * n_model)
    if n_model > 1:
        mesh = make_mesh_tp(n_data, n_view, n_model, devices=devices)
        print(f"[cli] mesh sampling: data={n_data} x view={n_view} x model={n_model} ranks on {mesh.devices}")
        return mesh
    mesh = make_mesh(n_data, n_view, devices=devices)
    print(f"[cli] mesh sampling: data={n_data} x view={n_view} ranks on {mesh.devices}")
    return mesh


def _build_bundle(checkpoint_dir, random_model, device="cuda", attention=None, quant=None, mesh=None):
    """(bundle, is_tiny): the tiny fp32 random bundle for
    `--random_model True`, the full-width bf16 one for `--random_model full`,
    else the weights in `checkpoint_dir`; `quant` is the UNet's W8A8 mode,
    `mesh` (build_mesh) shards its sampling."""
    from stable_virtual_camera_tpu_torch.models import io as mio

    if random_model:
        generator = torch.Generator(device=device).manual_seed(0)
        if str(random_model).lower() == "full":
            # full-width bf16 random weights: the real compute path (the
            # kernels, bf16, full shapes) without the released checkpoint
            print("[cli] --random_model full: full-scale bf16 random bundle")
            from stable_virtual_camera_tpu_torch.config import SevaSpec
            from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec

            bundle = mio.random_bundle(SevaSpec(), ClipVisionSpec(), dtype=torch.bfloat16,
                                       device=device, generator=generator, attention=attention,
                                       quant=quant, mesh=mesh)
            return bundle, False
        print("[cli] --random_model: tiny randomly initialized bundle (smoke mode)")
        return mio.random_bundle(device=device, generator=generator, attention=attention,
                                 quant=quant, mesh=mesh), True
    if checkpoint_dir is None:
        raise SystemExit(
            "Provide --checkpoint_dir with converted weights or --random_model for a smoke run."
        )
    return mio.load_bundle(checkpoint_dir, device=device, attention=attention, quant=quant,
                           mesh=mesh), False


def main(
    data_path,
    data_items=None,
    task="img2img",
    save_subdir="",
    H=None,
    W=None,
    T=None,
    use_traj_prior=False,
    checkpoint_dir=None,
    random_model=False,
    work_dir=WORK_DIR,
    mesh_view=None,
    mesh_data=None,
    mesh_model=None,
    platform=None,
    quant=None,
    device="cuda",
    attention=None,
    engine_timing=False,
    **overwrite_options,
):
    """Render every scene under `data_path` (or the `data_items` among
    them) for `task`; returns the scenes' output directories."""
    try:
        quant = serving_mode(quant)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    device = platform_device(platform, device)
    mesh = build_mesh(mesh_view, mesh_data, mesh_model, device)
    bundle, is_tiny = _build_bundle(checkpoint_dir, random_model, device, attention, quant, mesh)
    version = VersionConfig()
    if is_tiny:
        version = VersionConfig(H=64, W=64, T=bundle.spec.num_frames)
    if H is not None:
        version.H = int(H)
    if W is not None:
        version.W = int(W)
    if T is not None:
        version.T = [int(t) for t in str(T).split(",")] if "," in str(T) else int(T)

    options = _default_options()
    options.update(overwrite_options)
    num_inputs = options.get("num_inputs", None)
    seed = int(options.get("seed", 23))

    if data_items is not None:
        if not isinstance(data_items, (list, tuple)):
            data_items = str(data_items).split(",")
        scenes = [osp.join(data_path, item) for item in data_items]
    else:
        scenes = sorted(globlib.glob(osp.join(data_path, "*")))

    done = []
    for scene in scenes:
        save_path_scene = osp.join(work_dir, task, save_subdir, osp.splitext(osp.basename(scene))[0])
        if options.get("skip_saved", False) and osp.exists(osp.join(save_path_scene, "transforms.json")):
            print(f"Skipping {scene} as it is already sampled.")
            continue
        timer = StageTimer() if engine_timing else None
        render_one_scene(
            bundle, version, options, task, scene, save_path_scene,
            use_traj_prior=use_traj_prior, seed=seed, num_inputs=num_inputs, timer=timer,
        )
        if timer is not None:
            print("[engine timing]\n" + timer.report())
        print(f"[cli] scene done: {save_path_scene}")
        done.append(save_path_scene)
    return done


def render_one_scene(
    bundle,
    version,
    options,
    task,
    scene,
    save_path_scene,
    *,
    use_traj_prior=False,
    seed=23,
    num_inputs=None,
    abort_event=None,
    first_pass_pbar=None,
    second_pass_pbar=None,
    noise_fn=torch_noise,
    timer=None,
):
    """Render ONE scene end-to-end: parse_task -> SceneEngine.run_one_scene ->
    OpenCV -> OpenGL transforms.json export (reference demo.py:274-404 loop
    body). `noise_fn` is the engine's (sampling/sampler.py); `timer`
    (utils/profiling.StageTimer) gets the engine's stages' host seconds. Returns
    save_path_scene, or None when aborted.

    The scene runs on its own deep copies of `version` and `options`:
    anchor planning rewrites `version.T` and `options.deliver_anchors` in
    place (engine/prior.py), so a shared object would hand one scene's
    first-pass window and delivery to the next (the JAX CLI keeps that
    leak)."""
    version, options = copy.deepcopy(version), copy.deepcopy(options)
    (
        all_imgs_path,
        n_inputs,
        num_targets,
        input_indices,
        anchor_indices,
        c2ws,
        Ks,
        anchor_c2ws,
        anchor_Ks,
    ) = parse_task(task, scene, num_inputs, version.T, version, options)
    assert n_inputs is not None
    image_cond = {
        "img": all_imgs_path,
        "input_indices": input_indices,
        "prior_indices": anchor_indices,
    }
    camera_cond = {
        "c2w": c2ws.copy(),
        "K": [k for k in Ks.copy()],
        "input_indices": list(range(n_inputs + num_targets)),
    }
    engine = SceneEngine(bundle, version, options, noise_fn=noise_fn)
    for _ in engine.run_one_scene(
        task,
        image_cond,
        camera_cond,
        save_path=save_path_scene,
        use_traj_prior=use_traj_prior,
        traj_prior_Ks=anchor_Ks,
        traj_prior_c2ws=anchor_c2ws,
        seed=seed,
        abort_event=abort_event,
        first_pass_pbar=first_pass_pbar,
        second_pass_pbar=second_pass_pbar,
        timer=timer,
    ):
        if abort_event is not None and abort_event.is_set():
            return None
    if abort_event is not None and abort_event.is_set():
        return None  # aborted inside the last chunk: outputs are incomplete

    # OpenCV -> OpenGL for the exported transforms.json (reference demo.py:378-403)
    c2ws_gl = np.concatenate(
        [c2ws, np.repeat(np.array([[[0.0, 0, 0, 1]]]), len(c2ws), 0)], axis=1
    ) @ np.diag([1.0, -1.0, -1.0, 1.0])
    img_paths = sorted(globlib.glob(osp.join(save_path_scene, "samples-rgb", "*.png")))
    if len(img_paths) != len(c2ws_gl):
        input_img_paths = sorted(globlib.glob(osp.join(save_path_scene, "input", "*.png")))
        assert len(img_paths) == num_targets
        assert len(input_img_paths) == n_inputs
        target_indices = [i for i in range(len(c2ws_gl)) if i not in input_indices]
        img_paths = [
            input_img_paths[input_indices.index(i)]
            if i in input_indices
            else img_paths[target_indices.index(i)]
            for i in range(len(c2ws_gl))
        ]
    create_transforms_simple(
        save_path=save_path_scene,
        img_paths=img_paths,
        img_whs=np.array([version.W, version.H])[None].repeat(n_inputs + num_targets, 0),
        c2ws=c2ws_gl,
        Ks=Ks,
    )
    return save_path_scene


def _parse_argv(argv):
    """fire-style flag parsing: --key value / --key=value, literals eval'd."""
    import ast

    kwargs = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        assert arg.startswith("--"), f"Unexpected positional arg {arg}"
        if "=" in arg:
            key, val = arg[2:].split("=", 1)
            i += 1
        else:
            key = arg[2:]
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                val = argv[i + 1]
                i += 2
            else:
                val = "True"
                i += 1
        try:
            kwargs[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            kwargs[key] = val
    return kwargs


def _main():
    main(**_parse_argv(sys.argv[1:]))


if __name__ == "__main__":
    _main()
