"""Viser 3D keyframe editor over the trajectory core.

Counterpart of stable_virtual_camera_tpu/apps/viser_gui.py, with the same
widgets, labels and callbacks (reference seva/gui.py:511-975 `define_gui`):
the preset-trajectory folder, FPS, duration and transition controls,
keyframe add and edit, play, the render-preview camera takeover, and "Set
camera trajectory", which serializes `camera_traj_list` ({w2c, K, img_wh}
per frame) from `CameraTrajectoryCore`. The trajectory math lives in
apps/trajectory.py; this module only wires widgets. `viser` is imported
inside `define_gui`, so importing this module does not need it.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from stable_virtual_camera_tpu_torch.apps.scene_viz import build_scene_viz, populate_viser_scene
from stable_virtual_camera_tpu_torch.apps.trajectory import (
    CameraTrajectoryCore,
    Keyframe,
    RenderPreviewController,
    SavedCamera,
)
from stable_virtual_camera_tpu_torch.core.kb_splines import quat_from_matrix, quat_normalize
from stable_virtual_camera_tpu_torch.core.trajectories import get_preset_pose_fov

GUI_PRESETS = ["orbit", "spiral", "lemniscate", "zoom-out", "dolly zoom-out"]


@dataclasses.dataclass
class GuiState:
    preview_render: bool
    preview_fov: float
    preview_aspect: float
    camera_traj_list: list | None
    active_input_index: int


def define_gui(
    server,
    init_fov: float = 75.0,
    img_wh: tuple[int, int] = (576, 576),
    scene_scale: float = 1.0,
    scene_node_prefix: str = "/",
):
    """Build the editor UI on a viser server; returns (GuiState, core)."""
    import viser

    gui_state = GuiState(
        preview_render=False,
        preview_fov=0.0,
        preview_aspect=1.0,
        camera_traj_list=None,
        active_input_index=0,
    )
    core = CameraTrajectoryCore(scene_scale=scene_scale)
    core.default_fov = init_fov / 180.0 * np.pi

    frustum_handles: list = []

    def open_keyframe_modal(client, index: int) -> None:
        """Per-keyframe edit modal (reference seva/gui.py:90-229): FOV
        override, transition override, go-to, delete."""
        kf = core.keyframes[index]
        with client.gui.add_modal(f"Keyframe {index}") as modal:
            override_fov = client.gui.add_checkbox(
                "Override FOV", initial_value=kf.override_fov_enabled
            )
            fov_deg = client.gui.add_slider(
                "FOV (deg)", min=20.0, max=120.0, step=1.0,
                initial_value=np.rad2deg(
                    kf.override_fov_rad if kf.override_fov_enabled else core.default_fov
                ),
                disabled=not kf.override_fov_enabled,
            )
            override_trans = client.gui.add_checkbox(
                "Override transition", initial_value=kf.override_transition_enabled
            )
            trans_sec = client.gui.add_number(
                "Transition (sec)", min=0.01, max=30.0, step=0.1,
                initial_value=kf.override_transition_sec
                or core.default_transition_sec,
                disabled=not kf.override_transition_enabled,
            )
            goto_btn = client.gui.add_button("Go to")
            delete_btn = client.gui.add_button("Delete", color="red")
            close_btn = client.gui.add_button("Close")

            @override_fov.on_update
            def _(_) -> None:
                core.set_keyframe_fov_override(
                    index, override_fov.value, np.deg2rad(fov_deg.value)
                )
                fov_deg.disabled = not override_fov.value
                redraw_keyframes()

            @fov_deg.on_update
            def _(_) -> None:
                if override_fov.value:
                    core.set_keyframe_fov_override(
                        index, True, np.deg2rad(fov_deg.value)
                    )
                    redraw_keyframes()

            @override_trans.on_update
            def _(_) -> None:
                core.set_keyframe_transition_override(
                    index, override_trans.value, trans_sec.value
                )
                trans_sec.disabled = not override_trans.value
                duration_number.value = core.compute_duration()

            @trans_sec.on_update
            def _(_) -> None:
                if override_trans.value:
                    core.set_keyframe_transition_override(index, True, trans_sec.value)
                    duration_number.value = core.compute_duration()

            @goto_btn.on_click
            def _(_) -> None:
                client.camera.wxyz = kf.wxyz
                client.camera.position = kf.position

            @delete_btn.on_click
            def _(_) -> None:
                core.remove_keyframe(index)
                modal.close()
                redraw_keyframes()
                duration_number.value = core.compute_duration()

            @close_btn.on_click
            def _(_) -> None:
                modal.close()

    def redraw_keyframes():
        for h in frustum_handles:
            h.remove()
        frustum_handles.clear()
        for i, kf in enumerate(core.keyframes):
            handle = server.scene.add_camera_frustum(
                f"{scene_node_prefix}cameras/{i}",
                fov=kf.override_fov_rad if kf.override_fov_enabled else core.default_fov,
                aspect=kf.aspect,
                scale=0.1 * core.scene_scale,
                color=(200, 10, 30),
                wxyz=quat_normalize(kf.wxyz),
                position=kf.position,
            )

            @handle.on_click
            def _(event, _i=i) -> None:  # click frustum -> edit modal
                open_keyframe_modal(event.client, _i)

            frustum_handles.append(handle)
        redraw_spline()

    spline_nodes: list = []

    def redraw_spline():
        for n in spline_nodes:
            n.remove()
        spline_nodes.clear()
        if len(core.keyframes) < 2:
            return
        num = int(core.compute_duration() * core.framerate)
        if num <= 0:
            return
        pts = core.spline_positions(num)
        spline_nodes.append(
            server.scene.add_spline_catmull_rom(
                f"{scene_node_prefix}camera_spline",
                positions=pts,
                color=(220, 220, 220),
                closed=core.loop,
                line_width=1.0,
                segments=pts.shape[0] + 1,
            )
        )

    with server.gui.add_folder("Preset camera trajectories", expand_by_default=False):
        preset_dropdown = server.gui.add_dropdown(
            "Options", GUI_PRESETS, initial_value="orbit"
        )
        preset_duration = server.gui.add_number(
            "Duration (sec)", min=1.0, max=60.0, step=0.5, initial_value=2.0
        )
        preset_submit = server.gui.add_button("Submit", icon=viser.Icon.PICK)

        @preset_submit.on_click
        def _(event) -> None:
            core.reset()
            gui_state.camera_traj_list = None
            num_frames = int(preset_duration.value * core.framerate)
            poses, fovs = get_preset_pose_fov(
                preset_dropdown.value,
                num_frames,
                np.eye(4),
                np.array([0.0, 0.0, 10.0]),
            )
            core.default_transition_sec = preset_duration.value / max(num_frames, 1)
            core.set_keyframes_from_poses(
                poses, fovs, aspect=img_wh[0] / img_wh[1]
            )
            redraw_keyframes()
            duration_number.value = core.compute_duration()

    with server.gui.add_folder("Keyframes"):
        add_button = server.gui.add_button("Add keyframe", icon=viser.Icon.PLUS)
        clear_button = server.gui.add_button("Clear keyframes", icon=viser.Icon.TRASH)

        @add_button.on_click
        def _(event) -> None:
            camera = event.client.camera
            core.add_keyframe(
                Keyframe(
                    position=np.array(camera.position),
                    wxyz=np.array(camera.wxyz),
                    override_fov_rad=camera.fov,
                    aspect=img_wh[0] / img_wh[1],
                )
            )
            redraw_keyframes()
            duration_number.value = core.compute_duration()

        @clear_button.on_click
        def _(event) -> None:
            core.reset()
            redraw_keyframes()

    fov_slider = server.gui.add_slider(
        "Default FOV (deg)", min=20.0, max=120.0, step=1.0, initial_value=init_fov
    )

    @fov_slider.on_update
    def _(_) -> None:
        core.default_fov = fov_slider.value / 180.0 * np.pi
        redraw_keyframes()

    framerate_number = server.gui.add_number(
        "FPS", min=1.0, max=60.0, step=1.0, initial_value=30.0
    )
    transition_number = server.gui.add_number(
        "Transition (sec)", min=0.1, max=30.0, step=0.1, initial_value=2.0
    )
    duration_number = server.gui.add_number(
        "Duration (sec)", min=0.0, max=600.0, step=0.1, initial_value=0.0, disabled=True
    )

    @framerate_number.on_update
    def _(_) -> None:
        core.framerate = framerate_number.value

    @transition_number.on_update
    def _(_) -> None:
        core.default_transition_sec = transition_number.value
        duration_number.value = core.compute_duration()

    play_button = server.gui.add_button("Play", icon=viser.Icon.PLAYER_PLAY)

    @play_button.on_click
    def _(event) -> None:
        def play() -> None:
            while len(core.keyframes) >= 2:
                dur = core.compute_duration()
                num = int(dur * core.framerate)
                for i in range(max(num, 1)):
                    result = core.interpolate_pose_and_fov_rad(i / max(num, 1))
                    if result is None:
                        break
                    c2w, fov = result
                    for client in server.get_clients().values():
                        client.camera.wxyz = quat_from_matrix(c2w[:3, :3])
                        client.camera.position = c2w[:3, 3]
                    time.sleep(1.0 / core.framerate)
                break

        threading.Thread(target=play, daemon=True).start()

    # ---- render-preview camera takeover (reference seva/gui.py:742-813) ----
    preview = RenderPreviewController(core)
    preview_slider = server.gui.add_slider(
        "Preview frame", min=0.0, max=1.0, step=0.005, initial_value=0.0
    )
    preview_btn = server.gui.add_button(
        "Preview render", icon=viser.Icon.CAMERA_CHECK
    )
    exit_preview_btn = server.gui.add_button(
        "Exit render preview", visible=False
    )

    def _apply_preview(frame) -> None:
        for client in server.get_clients().values():
            client.camera.wxyz = quat_from_matrix(frame.c2w[:3, :3])
            client.camera.position = frame.c2w[:3, 3]
            client.camera.fov = frame.fov_rad  # aspect is locked by the UI

    @preview_btn.on_click
    def _(event) -> None:
        cameras = {
            cid: SavedCamera(
                wxyz=np.array(c.camera.wxyz),
                position=np.array(c.camera.position),
                fov_rad=float(c.camera.fov),
            )
            for cid, c in server.get_clients().items()
        }
        frame = preview.enter(cameras, preview_slider.value)
        if frame is None:
            return
        gui_state.preview_render = True
        gui_state.preview_fov = frame.fov_rad
        gui_state.preview_aspect = frame.aspect
        preview_btn.visible = False
        exit_preview_btn.visible = True
        _apply_preview(frame)

    @preview_slider.on_update
    def _(_) -> None:
        if preview.preview_on:
            frame = preview.frame(preview_slider.value)
            if frame is not None:
                _apply_preview(frame)

    @exit_preview_btn.on_click
    def _(event) -> None:
        saved = preview.exit()
        gui_state.preview_render = False
        preview_btn.visible = True
        exit_preview_btn.visible = False
        for cid, client in server.get_clients().items():
            cam = saved.get(cid)
            if cam is not None:
                client.camera.wxyz = cam.wxyz
                client.camera.position = cam.position
                client.camera.fov = cam.fov_rad

    set_traj_button = server.gui.add_button(
        "Set camera trajectory", color="green", icon=viser.Icon.CHECK
    )

    @set_traj_button.on_click
    def _(event) -> None:
        gui_state.camera_traj_list = core.get_camera_traj_list(img_wh)

    return gui_state, core


def visualize_scene(
    server,
    input_imgs: np.ndarray,  # (N, H, W, 3) in [0, 1]
    input_Ks: np.ndarray,  # (N, 3, 3) normalized
    input_c2ws: np.ndarray,  # (N, 4, 4)
    points: list[np.ndarray],
    point_colors: list[np.ndarray],
    scene_scale: float = 1.0,
    scene_node_prefix: str = "/scene_assets",
):
    """Input-camera frustums (with image thumbnails) + per-view point clouds
    (reference demo_gr.py:247-355 `visualize_scene`); geometry computed by the
    tested headless builder (apps/scene_viz.py)."""
    H, W = np.asarray(input_imgs[0]).shape[:2]
    viz = build_scene_viz(
        {
            "input_imgs": input_imgs,
            "input_Ks": input_Ks,
            "input_c2ws": input_c2ws,
            "input_wh": (W, H),
            "points": points,
            "point_colors": point_colors,
            "scene_scale": scene_scale,
        }
    )
    populate_viser_scene(server, viz)
