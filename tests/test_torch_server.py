"""The port's HTTP render service (apps/server.py): the counterparts of
tests/test_server.py's eight tests (job lifecycle, queue order, error
isolation, abort, the JSON API, warmup buckets, output identical to the CLI,
a real tiny render through HTTP), on the CPU with the tiny bundle; and the
static-W8A8 warmup, which must leave calibration to the first job."""

import glob
import http.client
import json
import os.path as osp
import threading
import time

import pytest
import torch

from stable_virtual_camera_tpu_torch.apps import cli
from stable_virtual_camera_tpu_torch.apps import server
from stable_virtual_camera_tpu_torch.apps.server import RenderService, build_http_server, engine_runner
from stable_virtual_camera_tpu_torch.config import SevaSpec, VersionConfig
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

GOLDEN = osp.join(osp.dirname(__file__), "..", "assets", "golden_scene")


def _wait(pred, timeout=10.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_job_lifecycle_and_order():
    ran = []
    gate = threading.Event()

    def runner(spec, job, abort):
        gate.wait(5)
        ran.append(spec["data_path"])
        return [spec["data_path"] + "/out"]

    svc = RenderService(runner)
    try:
        a = svc.submit({"data_path": "/a"})
        b = svc.submit({"data_path": "/b"})
        assert svc.get(a)["status"] in ("queued", "running")  # single flight
        assert svc.get(b)["status"] == "queued"
        gate.set()
        assert _wait(lambda: svc.get(b)["status"] == "done")
        assert svc.get(a)["status"] == "done"
        assert ran == ["/a", "/b"]  # FIFO
        assert svc.get(a)["outputs"] == ["/a/out"]
        assert svc.get("nope") is None
    finally:
        svc.shutdown()


def test_error_isolation():
    def runner(spec, job, abort):
        if spec["data_path"] == "/bad":
            raise RuntimeError("boom")
        return []

    svc = RenderService(runner)
    try:
        bad = svc.submit({"data_path": "/bad"})
        good = svc.submit({"data_path": "/good"})
        assert _wait(lambda: svc.get(good)["status"] == "done")
        rec = svc.get(bad)
        assert rec["status"] == "error" and "boom" in rec["error"]
    finally:
        svc.shutdown()


def test_abort_queued_and_running():
    started = threading.Event()

    def runner(spec, job, abort):
        started.set()
        for _ in range(500):  # cooperative poll, as the sampler does after each step
            if abort.is_set():
                return []
            time.sleep(0.01)
        return ["never"]

    svc = RenderService(runner)
    try:
        running = svc.submit({"data_path": "/x"})
        queued = svc.submit({"data_path": "/y"})
        assert started.wait(5)
        assert svc.abort(queued)
        assert svc.get(queued)["status"] == "aborted"
        assert svc.abort(running)
        assert _wait(lambda: svc.get(running)["status"] == "aborted")
        assert not svc.abort("nope")
    finally:
        svc.shutdown()


def test_submit_validation():
    svc = RenderService(lambda s, j, a: [])
    try:
        with pytest.raises(ValueError):
            svc.submit({"no_data_path": 1})
        with pytest.raises(ValueError):
            svc.submit("not a dict")
    finally:
        svc.shutdown()


@pytest.fixture()
def http_stack():
    gate = threading.Event()

    def runner(spec, job, abort):
        job.progress.update({"step": 3, "total": 5})
        gate.wait(5)
        return ["/out/scene0"]

    svc = RenderService(runner)
    httpd = build_http_server(svc, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    conn = http.client.HTTPConnection(*httpd.server_address)
    yield conn, gate, svc
    conn.close()
    httpd.shutdown()
    svc.shutdown()


def _req(conn, method, path, body=None):
    conn.request(method, path, body=json.dumps(body) if body else None)
    r = conn.getresponse()
    return r.status, json.loads(r.read() or b"{}")


def test_http_api_roundtrip(http_stack):
    conn, gate, svc = http_stack
    code, health = _req(conn, "GET", "/v1/health")
    assert code == 200 and health["status"] == "ok"
    code, out = _req(conn, "POST", "/v1/jobs", {"data_path": "/tmp/scenes"})
    assert code == 201
    jid = out["id"]
    code, rec = _req(conn, "GET", f"/v1/jobs/{jid}")
    assert code == 200 and rec["status"] in ("queued", "running")
    code, lst = _req(conn, "GET", "/v1/jobs")
    assert code == 200 and [j["id"] for j in lst["jobs"]] == [jid]
    gate.set()
    assert _wait(lambda: _req(conn, "GET", f"/v1/jobs/{jid}")[1]["status"] == "done")
    code, rec = _req(conn, "GET", f"/v1/jobs/{jid}")
    assert rec["outputs"] == ["/out/scene0"]
    assert rec["progress"] == {"step": 3, "total": 5}
    assert _req(conn, "GET", "/v1/jobs/zzz")[0] == 404
    assert _req(conn, "GET", "/v1/nope")[0] == 404
    assert _req(conn, "POST", "/v1/jobs", {"bad": 1})[0] == 400
    conn.request("POST", "/v1/jobs", body=b"{not json")
    r = conn.getresponse()
    r.read()
    assert r.status == 400
    assert _req(conn, "DELETE", "/v1/jobs/zzz")[0] == 404
    assert _req(conn, "DELETE", f"/v1/jobs/{jid}")[0] == 202  # finished: still acknowledged


def test_warmup_buckets_covers_each_T_once():
    """One zero-conditioned sample per distinct T (the duplicate [3, 3] runs
    once) at the version's latent size, with the CFG-doubled shapes the
    engine gives the network."""
    calls = []

    class FakeBundle:
        spec = SevaSpec.tiny()
        device = "cpu"
        unet = None

        def network(self, x, concat, t_vec, crossattn, dense, T):
            calls.append((x.shape, concat.shape, crossattn.shape, dense.shape, T))
            return torch.zeros(x.shape)

    server.warmup_buckets(FakeBundle(), VersionConfig(H=64, W=64, T=[3, 3]), num_steps=4)
    assert len(calls) == 4  # one sample of 4 steps
    sp = FakeBundle.spec
    assert set(calls) == {((6, 8, 8, 4), (6, 8, 8, sp.in_channels - 4), (6, 1, sp.context_dim),
                           (6, 8, 8, sp.dense_in_channels), 3)}


def _tiny_runner(bundle, work_dir):
    return engine_runner(bundle, lambda: VersionConfig(H=64, W=64, T=bundle.spec.num_frames),
                         cli._default_options, str(work_dir))


class _Job:  # the runner touches only .progress
    def __init__(self):
        self.progress = {}


OPTS = dict(task="img2trajvid", use_traj_prior=True, num_steps=2, guider_types=[1, 2],
            cfg=[2.0, 2.0], sampler_verbose=False)


def test_server_output_identical_to_cli(tmp_path):
    """The service renders through the CLI's render_one_scene: the same
    scene with the same seed and weights gives byte-identical PNGs."""
    (cli_dir,) = cli.main(data_path=GOLDEN, random_model=True, device="cpu",
                          work_dir=str(tmp_path / "w_cli"), **OPTS)
    bundle, _ = cli._build_bundle(None, random_model=True, device="cpu")
    job = _Job()
    outs = _tiny_runner(bundle, tmp_path / "w_srv")({"data_path": GOLDEN, **OPTS}, job,
                                                    threading.Event())
    assert len(outs) == 1
    cli_pngs = sorted(glob.glob(osp.join(cli_dir, "samples-rgb", "*.png")))
    srv_pngs = sorted(glob.glob(osp.join(outs[0], "samples-rgb", "*.png")))
    assert len(cli_pngs) == len(srv_pngs) > 0
    for a, b in zip(cli_pngs, srv_pngs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), (a, b)
    assert job.progress["pass"] == 2 and job.progress["step"] == job.progress["total"] == 2


def test_server_end_to_end_tiny_scene(tmp_path):
    """A real tiny render submitted and polled over HTTP."""
    bundle, _ = cli._build_bundle(None, random_model=True, device="cpu")
    svc = RenderService(_tiny_runner(bundle, tmp_path / "work"))
    httpd = build_http_server(svc, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    conn = http.client.HTTPConnection(*httpd.server_address)
    try:
        code, out = _req(conn, "POST", "/v1/jobs", {"data_path": GOLDEN, **OPTS})
        assert code == 201
        jid = out["id"]
        assert _wait(lambda: _req(conn, "GET", f"/v1/jobs/{jid}")[1]["status"] in ("done", "error"),
                     timeout=600)
        rec = _req(conn, "GET", f"/v1/jobs/{jid}")[1]
        assert rec["status"] == "done", rec.get("error")
        assert len(rec["outputs"]) == 1
        assert osp.exists(osp.join(rec["outputs"][0], "transforms.json"))
        assert osp.exists(osp.join(rec["outputs"][0], "samples-rgb.mp4"))
        assert rec["progress"].get("total", 0) >= 1
    finally:
        conn.close()
        httpd.shutdown()
        svc.shutdown()


def test_static_warmup_leaves_calibration_to_the_first_job(tmp_path):
    """Under w8a8-static, warmup_buckets runs the exact network and leaves
    the bundle uncalibrated; the first job then calibrates on its own scene,
    to the same state as a bundle that was never warmed (JAX's warmup would
    have calibrated on the zero-conditioned warmup chunk instead)."""
    spec = dict(data_path=GOLDEN, task="img2img", num_steps=2, use_traj_prior=False)
    states = []
    for warm in (True, False):
        bundle, _ = cli._build_bundle(None, random_model=True, device="cpu", quant="w8a8-static")
        if warm:
            server.warmup_buckets(bundle, VersionConfig(H=64, W=64, T=bundle.spec.num_frames),
                                  num_steps=2)
            assert bundle.unet.quant == "w8a8-static" and not bundle.unet.quant_calibrated
        outs = _tiny_runner(bundle, tmp_path / f"w{warm}")(spec, _Job(), threading.Event())
        assert len(outs) == 1 and bundle.unet.quant_calibrated
        states.append({k: v.clone() for k, v in bundle.unet.named_buffers()})
    assert states[0].keys() == states[1].keys() and states[0]
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


@pytest.mark.parametrize("flag,item", [("mesh_view", "item 4"), ("mesh_data", "item 4")])
def test_server_main_refuses_what_is_not_ported(flag, item, monkeypatch):
    """The mesh flags are ported (ROADMAP queue 1, item 4's serving part):
    `main` serves a bundle on a 2-rank CPU mesh along that axis (stopped
    where it would start listening). A W8A8 mode it does not know still
    exits."""
    served = {}

    class Stop(Exception):
        pass

    def build_http_server(service, host, port):
        served["service"] = service
        raise Stop

    monkeypatch.setattr(server, "build_http_server", build_http_server)
    monkeypatch.setattr(server, "engine_runner", lambda bundle, *a: served.setdefault("bundle", bundle))
    with pytest.raises(Stop):
        server.main(random_model=True, device="cpu", **{flag: 2})
    served["service"].shutdown()
    assert served["bundle"].mesh.shape == {"data": 2 if flag == "mesh_data" else 1,
                                           "view": 2 if flag == "mesh_view" else 1}
    with pytest.raises(SystemExit, match="--quant must be"):
        server.main(random_model=True, device="cpu", quant="w4a4")


def test_shut_down_server_releases_its_service():
    """Once shut down and dropped, the HTTP server and the service free the
    runner (and the model it holds) without waiting for the cyclic
    collector: the handler reaches the service through the server object."""
    import gc
    import weakref

    class Model:
        pass

    model = Model()
    ref = weakref.ref(model)

    def runner(spec, job, abort, _model=model):
        return []

    gc.disable()
    try:
        svc = RenderService(runner)
        httpd = build_http_server(svc, port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        conn = http.client.HTTPConnection(*httpd.server_address)
        assert _req(conn, "GET", "/v1/health")[0] == 200
        conn.close()
        httpd.shutdown()
        httpd.server_close()
        thread.join(5)
        svc.shutdown()
        del svc, httpd, thread, runner, model, conn
        assert ref() is None
    finally:
        gc.enable()
