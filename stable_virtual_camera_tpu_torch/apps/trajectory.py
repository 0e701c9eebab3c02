"""Keyframe camera-trajectory core of the GUI's Advanced mode, without a GUI.

A copy of stable_virtual_camera_tpu/apps/trajectory.py (numpy): keyframes
with per-keyframe FOV and transition overrides, Kochanek-Bartels splines
for position, orientation and FOV, PCHIP time parameterization, the
`camera_traj_list` ({w2c, K, img_wh} per frame) that
`apps/renderer.HeadlessRenderer.prepare` takes, and the render-preview
state machine (`SavedCamera`, `PreviewCamera`, `RenderPreviewController`)
whose states the viser editor (apps/viser_gui.py) applies to its clients.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from stable_virtual_camera_tpu_torch.core.kb_splines import (
    KochanekBartels,
    KochanekBartelsQuaternion,
    pchip_time_parameterization,
    quat_from_matrix,
    quat_to_matrix,
)


@dataclasses.dataclass
class Keyframe:
    position: np.ndarray
    wxyz: np.ndarray
    override_fov_enabled: bool = False
    override_fov_rad: float = 0.0
    aspect: float = 1.0
    override_transition_enabled: bool = False
    override_transition_sec: float | None = None

    @staticmethod
    def from_c2w(c2w: np.ndarray, fov: float, aspect: float) -> "Keyframe":
        c2w = np.asarray(c2w, dtype=np.float64)
        return Keyframe(
            position=c2w[:3, 3].copy(),
            wxyz=quat_from_matrix(c2w[:3, :3]),
            override_fov_rad=fov,
            aspect=aspect,
        )


def get_intrinsics(W: int, H: int, fov_rad: float) -> np.ndarray:
    """Pixel K from a vertical FOV."""
    focal = 0.5 * H / np.tan(0.5 * fov_rad)
    return np.array([[focal, 0.0, 0.5 * W], [0.0, focal, 0.5 * H], [0.0, 0.0, 1.0]])


class CameraTrajectoryCore:
    """Keyframed trajectory with TCB spline interpolation."""

    def __init__(self, scene_scale: float = 1.0):
        self.scene_scale = scene_scale
        self.keyframes: list[Keyframe] = []
        self.loop: bool = False
        self.framerate: float = 30.0
        self.tension: float = 0.0
        self.default_fov: float = 0.0
        self.default_transition_sec: float = 2.0

    # ---- keyframe management ----

    def add_keyframe(self, keyframe: Keyframe, index: int | None = None) -> int:
        if index is None:
            self.keyframes.append(keyframe)
            return len(self.keyframes) - 1
        self.keyframes[index] = keyframe
        return index

    def remove_keyframe(self, index: int) -> None:
        self.keyframes.pop(index)

    def reset(self) -> None:
        self.keyframes.clear()

    def get_aspect(self) -> float:
        assert self.keyframes
        return self.keyframes[0].aspect

    # ---- timing ----

    def _transition_sec(self, keyframe: Keyframe) -> float:
        if keyframe.override_transition_enabled and (
            keyframe.override_transition_sec is not None
        ):
            return keyframe.override_transition_sec
        return self.default_transition_sec

    def compute_duration(self) -> float:
        total = 0.0
        for i, keyframe in enumerate(self.keyframes):
            if i == 0 and not self.loop:
                continue
            total += self._transition_sec(keyframe)
        return total

    def compute_transition_times_cumsum(self) -> np.ndarray:
        total, out = 0.0, [0.0]
        for i, keyframe in enumerate(self.keyframes):
            if i == 0:
                continue
            total += self._transition_sec(keyframe)
            out.append(total)
        if self.loop:
            total += self._transition_sec(self.keyframes[0])
            out.append(total)
        return np.array(out)

    def spline_t_from_t_sec(self, time) -> np.ndarray:
        mapping = pchip_time_parameterization(
            self.compute_transition_times_cumsum(), loop=self.loop
        )
        return mapping(time)

    # ---- interpolation ----

    def _splines(self):
        end = "closed" if self.loop else "natural"
        tcb = (self.tension, 0.0, 0.0)
        orientation = KochanekBartelsQuaternion(
            [k.wxyz for k in self.keyframes], tcb=tcb, endconditions=end
        )
        position = KochanekBartels(
            [k.position for k in self.keyframes], tcb=tcb, endconditions=end
        )
        fov = KochanekBartels(
            [
                k.override_fov_rad if k.override_fov_enabled else self.default_fov
                for k in self.keyframes
            ],
            tcb=tcb,
            endconditions=end,
        )
        return orientation, position, fov

    def interpolate_pose_and_fov_rad(
        self, normalized_t: float
    ) -> tuple[np.ndarray, float] | None:
        """Returns (c2w 4x4, fov_rad) at normalized trajectory time [0, 1]."""
        if len(self.keyframes) < 2:
            return None
        orientation, position, fov = self._splines()
        max_t = self.compute_duration()
        spline_t = float(self.spline_t_from_t_sec(np.array(max_t * normalized_t)))
        quat = orientation.evaluate(spline_t)
        c2w = np.eye(4)
        c2w[:3, :3] = quat_to_matrix(quat)
        c2w[:3, 3] = position.evaluate(spline_t)
        return c2w, float(fov.evaluate(spline_t))

    def spline_positions(self, num_points: int) -> np.ndarray:
        """Positions along the spline for visualization."""
        _, position, _ = self._splines()
        cumsum = self.compute_transition_times_cumsum()
        ts = self.spline_t_from_t_sec(np.linspace(0, cumsum[-1], num_points))
        return position.evaluate(ts)

    # ---- serialization ----

    def get_camera_traj_list(
        self, img_wh: tuple[int, int], num_frames: int | None = None
    ) -> list[dict] | None:
        if num_frames is None:
            num_frames = int(self.framerate * self.compute_duration())
        if num_frames <= 0:
            return None
        W, H = img_wh
        out = []
        for i in range(num_frames):
            result = self.interpolate_pose_and_fov_rad(i / num_frames)
            if result is None:
                return None
            c2w, fov_rad = result
            K = get_intrinsics(W, H, fov_rad)
            w2c = np.linalg.inv(c2w)
            out.append(
                {
                    "w2c": w2c.flatten().tolist(),
                    "K": K.flatten().tolist(),
                    "img_wh": (W, H),
                }
            )
        return out

    def set_keyframes_from_poses(
        self, c2ws: np.ndarray, fovs: np.ndarray, aspect: float
    ) -> None:
        """Load a sequence of poses as keyframes."""
        self.reset()
        for c2w, fov in zip(np.asarray(c2ws), np.asarray(fovs)):
            self.add_keyframe(Keyframe.from_c2w(c2w, float(fov), aspect))

    # ---- per-keyframe editing ----

    def set_keyframe_fov_override(
        self, index: int, enabled: bool, fov_rad: float | None = None
    ) -> None:
        kf = self.keyframes[index]
        kf.override_fov_enabled = enabled
        if fov_rad is not None:
            kf.override_fov_rad = fov_rad

    def set_keyframe_transition_override(
        self, index: int, enabled: bool, transition_sec: float | None = None
    ) -> None:
        kf = self.keyframes[index]
        kf.override_transition_enabled = enabled
        if transition_sec is not None:
            kf.override_transition_sec = transition_sec


@dataclasses.dataclass
class SavedCamera:
    """A client camera state captured before the preview takeover."""

    wxyz: np.ndarray
    position: np.ndarray
    fov_rad: float


@dataclasses.dataclass
class PreviewCamera:
    """What the client cameras should be set to while previewing."""

    c2w: np.ndarray
    fov_rad: float
    aspect: float


class RenderPreviewController:
    """Render-preview camera takeover (reference seva/gui.py:742-813):
    entering preview saves every connected client's camera and drives them
    along the trajectory with the render FOV/aspect locked; exiting restores
    the saved cameras. Pure state machine — the viser shell applies the
    returned states to real clients."""

    def __init__(self, core: CameraTrajectoryCore):
        self.core = core
        self.preview_on = False
        self._saved: dict[int, SavedCamera] = {}

    def frame(self, normalized_t: float) -> PreviewCamera | None:
        result = self.core.interpolate_pose_and_fov_rad(normalized_t)
        if result is None:
            return None
        c2w, fov = result
        return PreviewCamera(c2w=c2w, fov_rad=fov, aspect=self.core.get_aspect())

    def enter(
        self, client_cameras: dict[int, SavedCamera], normalized_t: float = 0.0
    ) -> PreviewCamera | None:
        """Save client cameras; returns the first preview frame (None and
        no-op with <2 keyframes)."""
        preview = self.frame(normalized_t)
        if preview is None:
            return None
        self._saved = dict(client_cameras)
        self.preview_on = True
        return preview

    def exit(self) -> dict[int, SavedCamera]:
        """Returns the saved cameras for the shell to restore."""
        self.preview_on = False
        saved, self._saved = self._saved, {}
        return saved
