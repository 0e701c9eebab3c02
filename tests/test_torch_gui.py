"""The port's GUI demo against the JAX package's: the scene view
(apps/scene_viz.py), the render-preview state machine
(apps/trajectory.py), the viser keyframe editor (apps/viser_gui.py) and the
Gradio app (apps/gradio_app.py).

gradio and viser are not installed here; as the JAX package's own tests
do, both shells run on the fakes of tests/test_app_shims.py (imported,
unchanged), which satisfy the pinned manifest (apps/ui_manifest.py). The
app drives the tiny model on the CPU at 64x64, T=5, 2 steps, and its
renders are held bit-equal to direct HeadlessRenderer runs, which
tests/test_torch_engine.py holds against the JAX renderer.
"""

import glob
import os.path as osp
import sys
import types

import cv2
import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu.apps import scene_viz as jax_scene_viz
from stable_virtual_camera_tpu.apps import trajectory as jax_trajectory
from stable_virtual_camera_tpu.apps import ui_manifest as jax_ui_manifest
from stable_virtual_camera_tpu.apps import viser_gui as jax_viser_gui
from stable_virtual_camera_tpu_torch.apps import scene_viz, trajectory, ui_manifest, viser_gui
from stable_virtual_camera_tpu_torch.core.trajectories import get_preset_pose_fov
from conftest import random_c2ws
from test_app_shims import (
    _FakeGui,
    _FakeRequest,
    _find_button,
    make_fake_gradio,
    make_fake_viser,
    run_event,
)
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-12
T, RES, STEPS = 5, 64, 2


def _preprocessed(seed=0, n_views=3, n_points=700):
    rng = np.random.default_rng(seed)
    H, W = 48, 80
    Ks = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1.0]]), (n_views, 1, 1))
    return {
        "input_imgs": rng.uniform(size=(n_views, H, W, 3)).astype(np.float32),
        "input_Ks": Ks,
        "input_c2ws": random_c2ws(rng, n_views),
        "input_wh": (W, H),
        "points": [rng.normal(size=(n_points, 3)) for _ in range(n_views)],
        "point_colors": [rng.uniform(size=(n_points, 3)) for _ in range(n_views)],
        "scene_scale": 1.7,
    }


def _rotations():
    """Rotations that take each branch of Shepperd's method."""
    c, s = np.cos(2.8), np.sin(2.8)
    return [
        np.eye(3),
        np.array([[1, 0, 0], [0, c, -s], [0, s, c]]),  # trace < 0, R00 largest
        np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]),  # R11 largest
        np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]),  # R22 largest
    ]


def test_rotmat_to_wxyz_and_fov_match_jax():
    for R in _rotations() + list(random_c2ws(np.random.default_rng(1), 4)[:, :3, :3]):
        np.testing.assert_allclose(scene_viz.rotmat_to_wxyz(R), jax_scene_viz.rotmat_to_wxyz(R),
                                   rtol=0, atol=ATOL)
    K = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]])
    assert scene_viz.fov_from_K(K, (640, 480)) == jax_scene_viz.fov_from_K(K, (640, 480))


@pytest.mark.parametrize("max_points", [200_000, 1000])
def test_scene_viz_matches_jax(max_points):
    pre = _preprocessed()
    ours = scene_viz.build_scene_viz(pre, max_points=max_points)
    theirs = jax_scene_viz.build_scene_viz(pre, max_points=max_points)
    assert len(ours.frustums) == len(theirs.frustums) == 3
    for a, b in zip(ours.frustums, theirs.frustums):
        assert (a.name, a.aspect) == (b.name, b.aspect)
        for key in ("fov_rad", "scale", "wxyz", "position"):
            np.testing.assert_allclose(getattr(a, key), getattr(b, key), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(a.image, b.image)
    np.testing.assert_allclose(ours.points, theirs.points, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ours.point_colors, theirs.point_colors)
    assert ours.point_size == theirs.point_size
    assert len(ours.points) == min(max_points, 2100)

    servers = [make_fake_viser().ViserServer() for _ in range(2)]
    scene_viz.populate_viser_scene(servers[0], ours)
    jax_scene_viz.populate_viser_scene(servers[1], theirs)
    assert list(servers[0].scene.nodes) == list(servers[1].scene.nodes)
    assert scene_viz.viser_iframe_html(servers[0]) == jax_scene_viz.viser_iframe_html(servers[1])


def test_render_preview_controller_matches_jax():
    poses, fovs = get_preset_pose_fov("orbit", 6, np.eye(4), np.array([0.0, 0.0, 10.0]))
    ctrls = []
    for mod in (trajectory, jax_trajectory):
        core = mod.CameraTrajectoryCore()
        core.default_fov = float(fovs[0])
        ctrl = mod.RenderPreviewController(core)
        assert ctrl.enter({}, 0.0) is None and not ctrl.preview_on  # < 2 keyframes
        core.set_keyframes_from_poses(poses, fovs, aspect=1.5)
        ctrls.append((mod, ctrl))

    def saved(mod):
        return {7: mod.SavedCamera(wxyz=np.array([1.0, 0, 0, 0]), position=np.zeros(3), fov_rad=0.8)}

    (pm, ours), (jm, theirs) = ctrls
    frames = [(ours.enter(saved(pm), 0.25), theirs.enter(saved(jm), 0.25))]
    frames += [(ours.frame(t), theirs.frame(t)) for t in (0.0, 0.5, 0.9)]
    for a, b in frames:
        np.testing.assert_allclose(a.c2w, b.c2w, rtol=0, atol=ATOL)
        assert abs(a.fov_rad - b.fov_rad) <= ATOL and a.aspect == b.aspect
    assert ours.preview_on and theirs.preview_on
    out_a, out_b = ours.exit(), theirs.exit()
    assert not ours.preview_on and out_a.keys() == out_b.keys() == {7}
    assert out_a[7].fov_rad == out_b[7].fov_rad
    assert ours.exit() == {}


class _FakeModal:
    def __init__(self):
        self.closed = False

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def close(self):
        self.closed = True


class _FakeClientGui(_FakeGui):
    """A client's gui: the server gui's widgets plus the keyframe modal."""

    def add_modal(self, title):
        return _FakeModal()


def _fake_client():
    return types.SimpleNamespace(
        gui=_FakeClientGui(),
        camera=types.SimpleNamespace(position=np.array([0.3, -0.2, 4.0]),
                                     wxyz=np.array([0.98, 0.1, -0.15, 0.05]), fov=0.9),
    )


def _drive_editor(mod, monkeypatch):
    """The same event sequence on a fresh fake server: orbit preset (0.2 s)
    and Submit, add a keyframe, edit its FOV and transition overrides in its
    modal, toggle loop, then "Set camera trajectory"."""
    monkeypatch.setitem(sys.modules, "viser", make_fake_viser())
    server = make_fake_viser().ViserServer()
    gui_state, core = mod.define_gui(server, init_fov=60.0, img_wh=(96, 64), scene_scale=1.3)
    gui = server.gui
    gui.find("Options").value = "orbit"
    gui.find("Duration (sec)", 0).value = 0.2
    gui.find("Submit").fire()
    client = _fake_client()
    gui.find("Add keyframe").fire(types.SimpleNamespace(client=client))
    last = len(core.keyframes) - 1
    handle = server.scene.nodes[f"/cameras/{last}"]
    for fn in handle._clicks:
        fn(types.SimpleNamespace(client=client))
    modal = client.gui
    modal.find("Override FOV").value = True
    modal.find("Override FOV").fire()
    modal.find("FOV (deg)").value = 50.0
    modal.find("FOV (deg)").fire()
    modal.find("Override transition").value = True
    modal.find("Override transition").fire()
    modal.find("Transition (sec)").value = 0.05
    modal.find("Transition (sec)").fire()
    core.loop = True
    gui.find("Set camera trajectory").fire()
    return server, gui_state, core


def test_define_gui_matches_jax(monkeypatch):
    s_ours, ours, core_ours = _drive_editor(viser_gui, monkeypatch)
    s_theirs, theirs, core_theirs = _drive_editor(jax_viser_gui, monkeypatch)
    assert ours.camera_traj_list is not None
    assert len(ours.camera_traj_list) == len(theirs.camera_traj_list) > 0
    for a, b in zip(ours.camera_traj_list, theirs.camera_traj_list):
        assert a.keys() == b.keys() and tuple(a["img_wh"]) == tuple(b["img_wh"]) == (96, 64)
        np.testing.assert_allclose(a["w2c"], b["w2c"], rtol=0, atol=ATOL)
        np.testing.assert_allclose(a["K"], b["K"], rtol=0, atol=ATOL)
    assert list(s_ours.scene.nodes) == list(s_theirs.scene.nodes)
    assert [w.label for w in s_ours.gui.widgets] == [w.label for w in s_theirs.gui.widgets]
    kf = core_ours.keyframes[-1]
    assert kf.override_fov_enabled and kf.override_transition_sec == 0.05
    assert abs(kf.override_fov_rad - np.deg2rad(50.0)) < ATOL


def test_define_gui_needs_viser(monkeypatch):
    monkeypatch.setitem(sys.modules, "viser", None)
    with pytest.raises(ImportError):
        viser_gui.define_gui(make_fake_viser().ViserServer())


def test_fakes_satisfy_the_ports_ui_manifest():
    assert ui_manifest.GRADIO_SYMBOLS == jax_ui_manifest.GRADIO_SYMBOLS
    assert ui_manifest.VISER_GUI_METHODS == jax_ui_manifest.VISER_GUI_METHODS
    gr = make_fake_gradio()
    ui_manifest.check_gradio(gr)
    viser = make_fake_viser()
    ui_manifest.check_viser(viser, viser.ViserServer())
    with pytest.raises(ui_manifest.UiApiDrift, match="missing"):
        ui_manifest.check_gradio(types.ModuleType("gradio"))


# ---------------------------------------------------------------------------
# the app on the fakes, with the tiny model on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundle():
    from stable_virtual_camera_tpu_torch.models.io import random_bundle

    return random_bundle(device="cpu", generator=torch.Generator().manual_seed(0))


def _renderer(bundle, work_dir):
    from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer
    from stable_virtual_camera_tpu_torch.config import VersionConfig

    r = HeadlessRenderer(bundle, work_dir=work_dir)
    r.version = VersionConfig(H=RES, W=RES, T=T)
    return r


@pytest.fixture()
def app(bundle, tmp_path, monkeypatch):
    """(app, fake gradio, info messages): the app with a session started and
    the Basic image preprocessed."""
    from stable_virtual_camera_tpu_torch.apps.gradio_app import build_app

    gr = make_fake_gradio()
    infos = []
    gr.Info = infos.append
    monkeypatch.setitem(sys.modules, "gradio", gr)
    monkeypatch.setitem(sys.modules, "viser", make_fake_viser())
    app = build_app(bundle, renderer=_renderer(bundle, str(tmp_path / "app")), num_steps=STEPS,
                    dust3r=object())  # the Advanced tab needs a pipeline; no test here calls it
    fn, inputs, outputs = app.load_handlers[0]
    run_event(fn, inputs, outputs, extra_args=(_FakeRequest("sess"),))
    assert outputs[0].value == "sess" and "iframe" in outputs[1].value
    img_in = next(w for w in gr._created if w.kind == "Image")
    img_in.value = np.random.default_rng(0).integers(0, 256, (RES, RES, 3), dtype=np.uint8)
    pre_btn = _find_button(gr, "Preprocess")
    run_event(*pre_btn.events[0])
    assert pre_btn.events[0][2][0].value is not None
    return app, gr, infos


def _widget(gr, kind, label):
    return next(w for w in gr._created if w.kind == kind and w.label == label)


def _read_pngs(directory):
    paths = sorted(glob.glob(osp.join(directory, "*.png")))
    return np.stack([cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in paths])


def test_app_defaults_and_wiring(app):
    app, gr, _ = app
    assert _widget(gr, "Number", "Seed").value == 23
    assert _widget(gr, "Dropdown", "Chunk strategy").value == "interp-gt"
    assert _widget(gr, "Slider", "CFG").value == 4.0
    assert _widget(gr, "Slider", "Camera scale").value == 2.0
    assert _widget(gr, "Slider", "#frames").value == 80
    assert _widget(gr, "Slider", "Zoom factor").value == 0.5
    assert len(_widget(gr, "Dropdown", "Preset trajectory").args[0]) == 14
    server = app.svc_sessions["servers"]["sess"]
    assert server.scene.nodes and app.svc_sessions["gui_states"]["sess"] is not None
    assert server.gui.find("Set camera trajectory") is not None
    _find_button(gr, "Preprocess (DUSt3R)")


def test_app_without_a_pipeline_has_no_advanced_tab(bundle, tmp_path, monkeypatch):
    from stable_virtual_camera_tpu_torch.apps.gradio_app import build_app

    gr = make_fake_gradio()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    build_app(bundle, renderer=_renderer(bundle, str(tmp_path)), num_steps=STEPS)
    assert not [w for w in gr._created if w.kind == "Button" and w.text == "Preprocess (DUSt3R)"]


def test_main_names_gradio_when_it_is_missing(monkeypatch):
    from stable_virtual_camera_tpu_torch.apps import gradio_app

    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        gradio_app.main(random_model=True, device="cpu")


def test_main_builds_the_app_and_launches_it(tmp_path, monkeypatch):
    """`main` on the fakes, down to `launch` (the fake raises): the tiny
    random bundle on the CPU at 64x64, a DUSt3R pipeline loaded from
    `dust3r_weights` (a synthetic released-layout checkpoint of the tiny
    network, since `main` builds the full-size spec) and an app with its
    Advanced tab."""
    from stable_virtual_camera_tpu_torch.apps import gradio_app, preprocessor
    from stable_virtual_camera_tpu_torch.models.dust3r import Dust3rSpec
    from test_torch_dust3r import save_checkpoint, synthetic_state

    gr = make_fake_gradio()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    monkeypatch.setitem(sys.modules, "viser", make_fake_viser())
    monkeypatch.setattr(gradio_app, "WORK_DIR", str(tmp_path / "demo_gr"))
    pipeline, built = preprocessor.NativeDust3rPipeline, []

    def tiny_pipeline(**kw):
        built.append(pipeline(spec=Dust3rSpec.tiny(), **kw))
        return built[-1]

    monkeypatch.setattr(preprocessor, "NativeDust3rPipeline", tiny_pipeline)
    apps, build_app = [], gradio_app.build_app

    def keep(*a, **kw):
        apps.append((a, kw))
        return build_app(*a, **kw)

    monkeypatch.setattr(gradio_app, "build_app", keep)
    path = save_checkpoint(tmp_path / "dust3r.pth", synthetic_state(seed=5))
    with pytest.raises(RuntimeError, match="launch"):
        gradio_app.main(random_model=True, device="cpu", dust3r_weights=path, share=False)
    (bundle,), kw = apps[0]
    assert kw["dust3r"] is built[0] and built[0].device == torch.device("cpu")
    assert (kw["renderer"].version.H, kw["renderer"].version.W) == (64, 64)
    assert next(bundle.unet.parameters()).device == torch.device("cpu")
    _find_button(gr, "Preprocess (DUSt3R)")


def test_basic_render_streams_and_matches_the_renderer(app, bundle):
    from stable_virtual_camera_tpu_torch.apps.renderer import preprocess_basic

    app, gr, _ = app
    _widget(gr, "Slider", "#frames").value = 3
    render_btn = _find_button(gr, "Render video", fn_name="do_render")
    progress = render_btn.events[0][0].__defaults__[-1]
    _, yields = run_event(*render_btn.events[0])
    assert len(yields) == 2 and yields[0][1] is None
    first, final = yields[1]
    assert first == yields[0][0] and osp.exists(first) and osp.exists(final)

    direct = _renderer(bundle, None)
    img = next(w for w in gr._created if w.kind == "Image").value
    plan = direct.prepare(preprocess_basic(img, shorter=RES), seed=23, chunk_strategy="interp-gt",
                          cfg=4.0, camera_scale=2.0, num_steps=STEPS, preset_traj="orbit",
                          num_frames=3, zoom_factor=0.5)
    anchors, frames = list(direct.run(plan))
    np.testing.assert_array_equal(_read_pngs(osp.join(osp.dirname(first), "samples-rgb")), anchors)
    np.testing.assert_array_equal(_read_pngs(osp.join(osp.dirname(final), "samples-rgb")), frames)
    # each pass's progress reaches its total
    descs = [kw["desc"] for _, kw in progress.calls]
    for name, total in (("First pass", plan["first_pass_steps"]),
                        ("Second pass", plan["second_pass_steps"])):
        assert [d for d in descs if d.startswith(name)][-1].endswith(f" {total}/{total} steps")


def test_advanced_render_takes_the_editors_trajectory(app):
    app, gr, _ = app
    server = app.svc_sessions["servers"]["sess"]
    adv_btn = _find_button(gr, "Render video", fn_name="do_render_advanced")
    with pytest.raises(Exception, match="Set a camera trajectory"):
        run_event(*adv_btn.events[0])

    server.gui.find("Options").value = "orbit"
    server.gui.find("Duration (sec)", 0).value = 0.2
    server.gui.find("Submit").fire()
    server.gui.find("Set camera trajectory").fire()
    traj = app.svc_sessions["gui_states"]["sess"].camera_traj_list
    assert traj is not None
    _widget(gr, "Dropdown", "Chunk strategy").value = "interp"
    _, yields = run_event(*adv_btn.events[0])
    first, final = yields[-1]
    assert first is not None and osp.exists(final)
    n = len(glob.glob(osp.join(osp.dirname(final), "samples-rgb", "*.png")))
    assert n == len(traj) != 80


def test_abort_stops_the_render_after_its_first_step(app):
    app, gr, infos = app
    render_btn = _find_button(gr, "Render video", fn_name="do_render")
    abort_btn = next(w for w in gr._created if w.kind == "Button" and w.text == "Abort")
    fn, inputs, _ = render_btn.events[0]
    ticks = []

    def progress(*a, **kw):
        ticks.append(kw["desc"])
        if len(ticks) == 1:
            run_event(*abort_btn.events[0])

    yields = list(fn(*[w.value for w in inputs], progress=progress))
    assert yields == [] and len(ticks) == 1
    assert infos == ["Render aborted."]
    assert app.svc_sessions["abort_events"]["sess"].is_set()
