"""Dependency-free HTTP render service: the production serving entry point.

Counterpart of stable_virtual_camera_tpu/apps/server.py: a standard-library
JSON-over-HTTP job API in front of the engine the CLI drives
(apps/cli.render_one_scene), with
  * a single-flight device worker (one render runs on the card at a time;
    queued jobs wait in FIFO order),
  * per-job progress (scene, and pass/step from the engine's hooks),
  * cooperative abort (the threading.Event the sampler polls after every
    step), and error isolation (a failing job does not stop the worker),
  * one model bundle loaded at startup and reused by every job; `warmup`
    runs one zero-conditioned sample per chunk size and the VAE/CLIP calls
    before the first request, so the first job does not pay for building
    the kernels and growing the allocator.

API (all JSON):
  GET    /v1/health            -> {"status": "ok", "queue_depth": N}
  POST   /v1/jobs              -> {"id": ...}; body = render spec (below)
  GET    /v1/jobs              -> {"jobs": [summary, ...]}
  GET    /v1/jobs/<id>         -> full job record incl. progress/outputs
  DELETE /v1/jobs/<id>         -> request abort (or drop a queued job)

Render spec keys mirror the CLI flags: data_path (required), data_items,
task, use_traj_prior, save_subdir, H, W, T, seed, plus any EngineOptions
overrides (num_steps, cfg, guider_types, chunk_strategy, ...).

Run:  python -m stable_virtual_camera_tpu_torch.apps.server \\
          --checkpoint_dir ... [--port 8000] [--work_dir ...] [--quant w8a8-static]
          [--artifact_dir artifacts/]
      (--random_model True serves the tiny bundle, --random_model full the
      full-width random one; --device cpu or --platform cpu runs off the
      card; --mesh_view / --mesh_data shard the jobs' sampling as in the
      CLI, apps/cli.build_mesh.)

With `--artifact_dir` (written by apps/export_artifacts.py) the chunks of
a loaded (T, h, w, steps) bucket run the exported step program
(models/export.py) instead of the live network; the loader refuses a model
whose topology or W8A8 mode is not the exported one, so `--quant` and
`--artifact_dir` do not go together.

On a mesh, a chunk whose bucket has an exported program runs that program
unsharded on the bundle's device, as JAX's `UNetDenoiser` runs an artifact
whatever its mesh; every other chunk is sharded (engine/runner.py).

Under `--quant w8a8-static` the bundle calibrates on the first chunk of the
first job, never in `warmup_buckets`: the warmup's chunks are zeros, and
scales calibrated on them would not be the scene's (JAX's warmup does
calibrate there).
"""

from __future__ import annotations

import contextlib
import glob as globlib
import json
import os.path as osp
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


@dataclass
class RenderJob:
    id: str
    spec: dict
    status: str = "queued"  # queued | running | done | error | aborted
    progress: dict = field(default_factory=dict)  # pass/scene/step/total
    outputs: list = field(default_factory=list)  # save paths of done scenes
    error: str | None = None
    created_at: float = 0.0
    started_at: float | None = None
    finished_at: float | None = None

    def summary(self) -> dict:
        return {"id": self.id, "status": self.status, "progress": self.progress}


class RenderService:
    """Job store and one worker thread draining a FIFO queue.

    `runner(spec, job, abort_event) -> list[str]` performs one job and
    returns the produced scene save paths; `engine_runner` builds the one
    that drives the engine. Tests inject fakes.
    """

    def __init__(self, runner, clock=time.time):
        self._runner = runner
        self._clock = clock
        self._jobs: dict[str, RenderJob] = {}
        self._order: list[str] = []
        self._aborts: dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stopping = False
        self._worker = threading.Thread(target=self._drain, name="render-worker", daemon=True)
        self._worker.start()

    # -- client surface ----------------------------------------------------
    def submit(self, spec: dict) -> str:
        if not isinstance(spec, dict) or not spec.get("data_path"):
            raise ValueError("spec must be an object with a 'data_path'")
        job = RenderJob(id=uuid.uuid4().hex[:12], spec=spec, created_at=self._clock())
        with self._wake:
            self._jobs[job.id] = job
            self._order.append(job.id)
            self._aborts[job.id] = threading.Event()
            self._wake.notify_all()
        return job.id

    def get(self, job_id: str) -> dict | None:
        with self._lock:
            job = self._jobs.get(job_id)
            return asdict(job) if job else None

    def list(self) -> list[dict]:
        with self._lock:
            return [self._jobs[i].summary() for i in self._order]

    def abort(self, job_id: str) -> bool:
        """Request cancellation. A queued job drops at once; a running job's
        event is polled by the engine after every sampling step."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return False
            if job.status == "queued":
                job.status = "aborted"
                job.finished_at = self._clock()
            elif job.status == "running":
                self._aborts[job_id].set()
            return True

    def queue_depth(self) -> int:
        with self._lock:
            return sum(1 for j in self._jobs.values() if j.status in ("queued", "running"))

    def shutdown(self) -> None:
        with self._wake:
            self._stopping = True
            self._wake.notify_all()
        self._worker.join(timeout=5)

    # -- worker ------------------------------------------------------------
    def _next_queued(self) -> RenderJob | None:
        for jid in self._order:
            if self._jobs[jid].status == "queued":
                return self._jobs[jid]
        return None

    def _drain(self) -> None:
        while True:
            with self._wake:
                job = self._next_queued()
                while job is None and not self._stopping:
                    self._wake.wait(timeout=1.0)
                    job = self._next_queued()
                if self._stopping:
                    return
                job.status = "running"
                job.started_at = self._clock()
                abort = self._aborts[job.id]
            try:
                outputs = self._runner(job.spec, job, abort)
                with self._lock:
                    if abort.is_set():
                        job.status = "aborted"
                    else:
                        job.status = "done"
                        job.outputs = list(outputs or [])
            except Exception as exc:  # noqa: BLE001 - job isolation
                with self._lock:
                    job.status = "error"
                    job.error = f"{type(exc).__name__}: {exc}"
            finally:
                with self._lock:
                    job.finished_at = self._clock()


def engine_runner(bundle, version_factory, default_options, work_dir):
    """The runner that drives the engine: one job is the CLI's loop over the
    spec's scenes (apps/cli.render_one_scene per scene), with its progress
    and abort wired into the job record."""
    from stable_virtual_camera_tpu_torch.apps.cli import render_one_scene

    def run(spec: dict, job: RenderJob, abort_event) -> list[str]:
        version = version_factory()
        for k in ("H", "W"):
            if spec.get(k) is not None:
                setattr(version, k, int(spec[k]))
        if spec.get("T") is not None:
            t = spec["T"]
            version.T = [int(x) for x in t] if isinstance(t, list) else int(t)

        options = default_options()
        reserved = {"data_path", "data_items", "task", "save_subdir", "use_traj_prior", "H", "W",
                    "T", "seed"}
        options.update({k: v for k, v in spec.items() if k not in reserved})

        task = spec.get("task", "img2trajvid")
        data_items = spec.get("data_items")
        if data_items is not None:
            if not isinstance(data_items, list):
                data_items = str(data_items).split(",")
            scenes = [osp.join(spec["data_path"], i) for i in data_items]
        else:
            scenes = sorted(globlib.glob(osp.join(spec["data_path"], "*")))
        if not scenes:
            raise ValueError(f"no scenes under {spec['data_path']!r}")

        def pbar(which):
            def cb(i, num_steps):  # (sampling step, steps) per chunk
                job.progress.update({"pass": which, "step": int(i), "total": int(num_steps)})
            return cb

        outputs = []
        for si, scene in enumerate(scenes):
            if abort_event.is_set():
                break
            job.progress.update({"scene": si, "scenes": len(scenes)})
            save_path_scene = osp.join(work_dir, task, str(spec.get("save_subdir", "")),
                                       osp.splitext(osp.basename(scene))[0])
            done = render_one_scene(
                bundle, version, options, task, scene, save_path_scene,
                use_traj_prior=bool(spec.get("use_traj_prior", False)),
                seed=int(spec.get("seed", 23)),
                num_inputs=options.get("num_inputs", None),
                abort_event=abort_event,
                first_pass_pbar=pbar(1),
                second_pass_pbar=pbar(2),
            )
            if done is not None:
                outputs.append(done)
        return outputs

    return run


def warmup_buckets(bundle, version, num_steps=50):
    """Run, before serving, what the first request would otherwise pay for:
    one zero-conditioned sample per chunk size T of `version` (the UNet's
    kernels built, cuDNN's and cuBLAS's plans chosen, the allocator grown),
    through the exported step program where the bundle has the bucket, then
    the VAE decode of T frames (fp32 and uint8, as the first and second
    passes decode) and the VAE encode and CLIP embed of T frames.

    Under w8a8-static the sample runs the exact network when the bundle is
    not calibrated yet, so that the calibration happens on the first real
    chunk and not on these zeros; a calibrated bundle warms its int8 path."""
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch.engine.runner import sample_latents
    from stable_virtual_camera_tpu_torch.sampling.discretization import DDPMDiscretization
    from stable_virtual_camera_tpu_torch.sampling.sampler import ChunkConditioning, make_sampling_plan

    spec = bundle.spec
    h, w = version.H // version.f, version.W // version.f
    plan = make_sampling_plan(DDPMDiscretization(), num_steps)
    Ts = version.T if isinstance(version.T, (list, tuple)) else [version.T]
    dev = torch.device(bundle.device)
    unet = getattr(bundle, "unet", None)
    exact = getattr(unet, "quant", "0") == "w8a8-static" and not unet.quant_calibrated

    def z(*s):
        return torch.zeros(s, dtype=torch.float32, device=dev)

    for T in dict.fromkeys(int(t) for t in Ts):
        cond = ChunkConditioning(
            crossattn=z(2 * T, 1, spec.context_dim),
            concat=z(2 * T, h, w, spec.in_channels - 4),
            dense=z(2 * T, h, w, spec.dense_in_channels),
            replace=z(2 * T, h, w, 5),
            scale=torch.full((T,), 2.0, dtype=torch.float32, device=dev),
        )
        t0 = time.time()
        with unet.quant_mode("0") if exact else contextlib.nullcontext():
            out = sample_latents(bundle, z(T, h, w, 4), plan, cond,
                                 step_noise=lambda i, _T=T: z(_T, h, w, 4))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        pinned = (T, h, w, num_steps) in getattr(bundle, "artifacts", {})
        print(f"[server] warmed T={T} {h}x{w} steps={num_steps} ({time.time() - t0:.1f}s)"
              + (" (exported program)" if pinned else "")
              + (" (exact: w8a8-static calibrates on the first job)" if exact else ""))
        del out
    if getattr(bundle, "vae", None) is not None:
        n = max(int(t) for t in Ts)
        t0 = time.time()
        for u8 in (False, True):
            bundle.vae.decode(z(n, h, w, 4), None, uint8=u8)
        print(f"[server] warmed VAE decode n={n} ({time.time() - t0:.1f}s)")
        t0 = time.time()
        imgs = np.zeros((n, h * version.f, w * version.f, 3), np.float32)
        bundle.vae.encode(imgs, 0)
        if getattr(bundle, "clip", None) is not None:
            bundle.clip.embed(imgs)
        print(f"[server] warmed VAE encode / CLIP embed n={n} ({time.time() - t0:.1f}s)")


def attach_artifacts(bundle, artifact_dir: str) -> None:
    """Load the exported denoise buckets of `artifact_dir` that were made for
    the bundle's device type into `bundle.artifacts`, refusing a UNet whose
    parameters or W8A8 mode do not match the export (models/export.py)."""
    from stable_virtual_camera_tpu_torch.models.export import load_denoise_artifacts, unet_state

    bundle.artifacts.update(load_denoise_artifacts(
        artifact_dir, params=unet_state(bundle.unet), device=bundle.device, quant=bundle.unet.quant))
    print(f"[server] loaded {len(bundle.artifacts)} AOT denoise bucket(s) from {artifact_dir}")


def build_http_server(service: RenderService, host="127.0.0.1", port=0):
    """A standard-library ThreadingHTTPServer speaking the /v1 JSON API. The
    handler reaches the service through `server.service`, so nothing but
    the server object holds it (a class made here lives until the cyclic
    collector runs, and would keep the service and its model alive)."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            service = self.server.service
            if self.path == "/v1/health":
                return self._send(200, {"status": "ok", "queue_depth": service.queue_depth()})
            if self.path == "/v1/jobs":
                return self._send(200, {"jobs": service.list()})
            if self.path.startswith("/v1/jobs/"):
                job = service.get(self.path.rsplit("/", 1)[1])
                if job is None:
                    return self._send(404, {"error": "no such job"})
                return self._send(200, job)
            return self._send(404, {"error": "unknown route"})

        def do_POST(self):
            if self.path != "/v1/jobs":
                return self._send(404, {"error": "unknown route"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                spec = json.loads(self.rfile.read(n) or b"{}")
                job_id = self.server.service.submit(spec)
            except (ValueError, json.JSONDecodeError) as exc:
                return self._send(400, {"error": str(exc)})
            return self._send(201, {"id": job_id})

        def do_DELETE(self):
            if not self.path.startswith("/v1/jobs/"):
                return self._send(404, {"error": "unknown route"})
            ok = self.server.service.abort(self.path.rsplit("/", 1)[1])
            code, msg = (202, "abort requested") if ok else (404, "no such job")
            return self._send(code, {"status" if ok else "error": msg})

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.service = service
    return httpd


def main(
    checkpoint_dir=None,
    random_model=False,
    host="127.0.0.1",
    port=8000,
    work_dir="work_dirs/serve",
    mesh_view=None,
    mesh_data=None,
    quant=None,
    warmup=False,
    warmup_steps=50,
    artifact_dir=None,
    device="cuda",
    attention=None,
    platform=None,
):
    """Load the bundle once (on the card unless `device` or `platform` says
    otherwise, on a mesh with `mesh_view` / `mesh_data`), optionally warm
    it, then serve /v1 until interrupted."""
    from stable_virtual_camera_tpu_torch.apps.cli import (
        _build_bundle,
        _default_options,
        build_mesh,
        platform_device,
    )
    from stable_virtual_camera_tpu_torch.config import VersionConfig
    from stable_virtual_camera_tpu_torch.ops.quant import serving_mode

    try:
        quant = serving_mode(quant)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    device = platform_device(platform, device)
    mesh = build_mesh(mesh_view, mesh_data, device=device)
    bundle, is_tiny = _build_bundle(checkpoint_dir, random_model, device, attention, quant, mesh)
    if artifact_dir is not None:
        attach_artifacts(bundle, artifact_dir)

    def version_factory():
        if is_tiny:
            return VersionConfig(H=64, W=64, T=bundle.spec.num_frames)
        return VersionConfig()

    if warmup:
        warmup_buckets(bundle, version_factory(), num_steps=int(warmup_steps))

    service = RenderService(engine_runner(bundle, version_factory, _default_options, work_dir))
    httpd = build_http_server(service, host, port)
    print(f"[server] listening on http://{host}:{httpd.server_address[1]}/v1")
    try:
        httpd.serve_forever()
    finally:
        service.shutdown()


if __name__ == "__main__":
    import sys

    from stable_virtual_camera_tpu_torch.apps.cli import _parse_argv

    main(**_parse_argv(sys.argv[1:]))
