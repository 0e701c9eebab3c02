"""Gradio web app: Basic (one unposed image + a preset trajectory) and
Advanced (unposed images -> DUSt3R -> the viser keyframe editor) modes.

Counterpart of stable_virtual_camera_tpu/apps/gradio_app.py (reference
demo_gr.py:852-1264), with the same widget tree, labels and defaults:
  * a viser server and an abort event per session, the server embedded in
    the page as an iframe (demo_gr.py:739-804, 752-777);
  * preprocess -> 3D scene view (camera frustums + point cloud,
    demo_gr.py:247-355) -> keyframe editor -> render;
  * progress sized by the plan's chunk x step counts (demo_gr.py:576-627);
  * the first-pass video streamed to the page as the engine yields it,
    before the second pass runs (demo_gr.py:664-701);
  * more than 10 input views force the `interp` strategy (applied in
    HeadlessRenderer.prepare);
  * one render at a time on the card (`concurrency_id="gpu_queue"`,
    demo_gr.py:906-907).

Where it differs from the JAX app: the DUSt3R pipeline of the Advanced
mode is an argument (`build_app(dust3r=...)`; `main` builds
NativeDust3rPipeline from `dust3r_weights`) instead of the SVC_DUST3R_CKPT
environment variable, and without one the Advanced tab is left out. The
external `Dust3rPipeline` is not ported. The heavy logic lives in
apps/renderer.py, apps/scene_viz.py and apps/trajectory.py; this file is the
widget wiring, and needs gradio (and viser for the scene view).

Run on the card: python -m stable_virtual_camera_tpu_torch.apps.gradio_app
    --checkpoint_dir ckpt/ --dust3r_weights dust3r_cache/
(--random_model True|full for random weights, --device cpu off the card).
"""

from __future__ import annotations

import threading

import numpy as np

WORK_DIR = "work_dirs/demo_gr"
MAX_SESSIONS = 1


def build_app(bundle, renderer=None, num_steps: int = 50, dust3r=None):
    """Assemble the Gradio Blocks app.

    `renderer` (HeadlessRenderer) and `num_steps` can be injected for tests
    and smoke runs with small models; the defaults match the reference app
    (50 steps, demo_gr.py:569-570). `dust3r` is the Advanced mode's pipeline
    (apps/preprocessor.NativeDust3rPipeline); the Advanced tab is built
    only when one is given (JAX's `advanced` flag has no caller here)."""
    import gradio as gr

    from stable_virtual_camera_tpu_torch.apps.renderer import (
        HeadlessRenderer,
        preprocess_advanced,
        preprocess_basic,
    )
    from stable_virtual_camera_tpu_torch.apps.scene_viz import (
        build_scene_viz,
        populate_viser_scene,
        viser_iframe_html,
    )
    from stable_virtual_camera_tpu_torch.apps.ui_manifest import check_gradio, check_viser
    from stable_virtual_camera_tpu_torch.apps.viser_gui import define_gui

    # fail loudly at startup if the installed gradio drifted from the pinned
    # surface the app is written against
    check_gradio(gr)

    renderer = renderer or HeadlessRenderer(bundle, work_dir=WORK_DIR)
    abort_events: dict[str, threading.Event] = {}
    servers: dict[str, object] = {}
    gui_states: dict[str, object] = {}  # session -> viser editor GuiState

    def start_session(request: "gr.Request"):
        abort_events[request.session_hash] = threading.Event()
        html = ""
        try:
            import viser
        except ImportError:  # no scene view without viser, as in the reference
            return request.session_hash, html
        server = viser.ViserServer()
        check_viser(viser, server)
        servers[request.session_hash] = server
        html = viser_iframe_html(server)  # demo_gr.py:752-777
        return request.session_hash, html

    def end_session(request: "gr.Request"):
        ev = abort_events.pop(request.session_hash, None)
        if ev is not None:
            ev.set()
        gui_states.pop(request.session_hash, None)
        server = servers.pop(request.session_hash, None)
        if server is not None:
            server.stop()

    def show_scene(preprocessed, session_hash):
        """Frustums + point cloud into the session's viser scene, then the
        keyframe editor on the same server (reference demo_gr.py:247-355
        `visualize_scene`, which ends in `define_gui`, demo_gr.py:350-355)."""
        server = servers.get(session_hash)
        if server is not None and preprocessed is not None:
            populate_viser_scene(server, build_scene_viz(preprocessed))
            gui_state, _ = define_gui(
                server,
                img_wh=tuple(preprocessed["input_wh"]),
                scene_scale=float(preprocessed["scene_scale"]),
            )
            gui_states[session_hash] = gui_state
        return preprocessed

    def do_preprocess_basic(img, session_hash):
        # Basic mode resizes the shorter side to the model's native resolution
        # (the reference hardcodes 576, demo_gr.py:140-177)
        shorter = min(renderer.version.H, renderer.version.W)
        return show_scene(preprocess_basic(np.asarray(img), shorter=shorter), session_hash)

    def do_preprocess_advanced(files, session_hash):
        if dust3r is None:
            raise gr.Error("dust3r unavailable: Advanced mode disabled")
        return show_scene(preprocess_advanced([f.name for f in files], dust3r), session_hash)

    def _do_render(preprocessed, session_hash, seed, chunk_strategy, cfg, camera_scale, progress,
                   **target_kwargs):
        """Generator: streams the first-pass video as soon as the engine
        yields it (reference demo_gr.py:664-701), progress sized by
        chunk x step counts (demo_gr.py:576-627)."""
        abort_event = abort_events.get(session_hash)
        if abort_event is not None:
            abort_event.clear()

        plan = renderer.prepare(
            preprocessed,
            seed=int(seed),
            chunk_strategy=chunk_strategy,
            cfg=float(cfg),
            camera_scale=float(camera_scale),
            num_steps=num_steps,
            **target_kwargs,
        )
        totals = (plan["first_pass_steps"], plan["second_pass_steps"])
        done = [0, 0]

        def make_pbar(pass_idx: int, desc: str):
            def pbar(i, num_steps):  # called (step_i, steps_per_chunk) per step
                done[pass_idx] += 1
                progress(
                    (done[pass_idx] / max(totals[pass_idx], 1), None),
                    desc=f"{desc} {done[pass_idx]}/{totals[pass_idx]} steps",
                )

            return pbar

        gen = renderer.run(
            plan,
            abort_event=abort_event,
            first_pass_pbar=make_pbar(0, "First pass (anchors)"),
            second_pass_pbar=make_pbar(1, "Second pass (interpolation)"),
        )
        first = None
        for video in gen:
            if first is None:
                first = video
                yield first, None  # stream the first pass immediately
            else:
                yield first, video
        if abort_event is not None and abort_event.is_set():
            gr.Info("Render aborted.")

    def do_render(preprocessed, session_hash, seed, chunk_strategy, cfg, preset_traj, num_frames,
                  zoom_factor, camera_scale, progress=gr.Progress()):
        """Basic mode: targets from the preset trajectory."""
        yield from _do_render(
            preprocessed, session_hash, seed, chunk_strategy, cfg, camera_scale, progress,
            preset_traj=preset_traj,
            num_frames=int(num_frames) if num_frames else None,
            zoom_factor=zoom_factor,
        )

    def do_render_advanced(preprocessed, session_hash, seed, chunk_strategy, cfg, camera_scale,
                           progress=gr.Progress()):
        """Advanced mode: targets from the viser keyframe editor's serialized
        spline, the reference's `get_target_c2ws_and_Ks_from_gui` path
        (demo_gr.py:357-372, 501-502; set by seva/gui.py:860-901)."""
        gui_state = gui_states.get(session_hash)
        if gui_state is None or gui_state.camera_traj_list is None:
            raise gr.Error(
                "Set a camera trajectory first (keyframe editor -> 'Set camera trajectory')."
            )
        yield from _do_render(
            preprocessed, session_hash, seed, chunk_strategy, cfg, camera_scale, progress,
            camera_traj_list=gui_state.camera_traj_list,
        )

    def do_abort(session_hash):
        ev = abort_events.get(session_hash)
        if ev is not None:
            ev.set()

    with gr.Blocks() as app:
        session = gr.State()
        preprocessed = gr.State()
        viser_html = gr.HTML(label="3D scene")
        seed = gr.Number(value=23, label="Seed")
        chunk_strategy = gr.Dropdown(
            ["interp", "interp-gt", "nearest", "nearest-gt", "gt-nearest"],
            value="interp-gt",
            label="Chunk strategy",
        )
        cfg = gr.Slider(1.0, 8.0, value=4.0, step=0.1, label="CFG")
        camera_scale = gr.Slider(0.1, 10.0, value=2.0, step=0.1, label="Camera scale")
        first_video = gr.Video(label="First pass")
        final_video = gr.Video(label="Final video")
        abort_btn = gr.Button("Abort")

        with gr.Tab("Basic"):
            img_in = gr.Image(label="Input image")
            preset = gr.Dropdown(
                [
                    "orbit", "spiral", "lemniscate", "zoom-in", "zoom-out",
                    "dolly zoom-in", "dolly zoom-out", "move-forward",
                    "move-backward", "move-up", "move-down", "move-left",
                    "move-right", "roll",
                ],
                value="orbit",
                label="Preset trajectory",
            )
            num_frames = gr.Slider(10, 200, value=80, step=1, label="#frames")
            zoom = gr.Slider(0.1, 2.0, value=0.5, step=0.05, label="Zoom factor")
            pre_btn = gr.Button("Preprocess")
            pre_btn.click(do_preprocess_basic, [img_in, session], [preprocessed])
            render_btn = gr.Button("Render video", variant="primary")
            render_btn.click(
                do_render,
                [preprocessed, session, seed, chunk_strategy, cfg, preset, num_frames, zoom,
                 camera_scale],
                [first_video, final_video],
                concurrency_id="gpu_queue",
                concurrency_limit=MAX_SESSIONS,
            )
        if dust3r is not None:
            with gr.Tab("Advanced"):
                files_in = gr.File(file_count="multiple", label="Input images")
                pre_btn2 = gr.Button("Preprocess (DUSt3R)")
                pre_btn2.click(do_preprocess_advanced, [files_in, session], [preprocessed])
                # targets come from the viser keyframe editor (set via its
                # green "Set camera trajectory" button), not a preset
                render_btn2 = gr.Button("Render video", variant="primary")
                render_btn2.click(
                    do_render_advanced,
                    [preprocessed, session, seed, chunk_strategy, cfg, camera_scale],
                    [first_video, final_video],
                    concurrency_id="gpu_queue",
                    concurrency_limit=MAX_SESSIONS,
                )

        abort_btn.click(do_abort, [session])
        app.load(start_session, None, [session, viser_html])
        app.unload(end_session)
    # session registries, exposed for headless tests and debugging
    app.svc_sessions = {
        "servers": servers,
        "abort_events": abort_events,
        "gui_states": gui_states,
    }
    return app


def main(checkpoint_dir: str | None = None, random_model=False, share: bool = False,
         dust3r_weights: str | None = None, device: str = "cuda"):
    """Serve the app: the bundle from `checkpoint_dir` (or random weights,
    `random_model` True for the tiny model, "full" for the full width) on
    `device`, and the Advanced tab when `dust3r_weights` (the released
    DUSt3R checkpoint or its converted cache) is given."""
    try:
        import gradio  # noqa: F401
    except ImportError as e:
        raise ImportError("the GUI needs the `gradio` package (and `viser` for its scene "
                          "view); neither is installed") from e
    from stable_virtual_camera_tpu_torch.apps.cli import _build_bundle
    from stable_virtual_camera_tpu_torch.apps.preprocessor import NativeDust3rPipeline
    from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer
    from stable_virtual_camera_tpu_torch.config import VersionConfig

    bundle, is_tiny = _build_bundle(checkpoint_dir, random_model, device)
    renderer = HeadlessRenderer(bundle, work_dir=WORK_DIR)
    if is_tiny:
        renderer.version = VersionConfig(H=64, W=64, T=bundle.spec.num_frames)
    dust3r = None
    if dust3r_weights is not None:
        dust3r = NativeDust3rPipeline(weight_path=dust3r_weights, device=device)
    app = build_app(bundle, renderer=renderer, dust3r=dust3r)
    app.queue(max_size=5).launch(share=share)


if __name__ == "__main__":
    import sys

    from stable_virtual_camera_tpu_torch.apps.cli import _parse_argv

    main(**_parse_argv(sys.argv[1:]))
