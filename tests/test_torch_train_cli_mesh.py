"""The train CLI's --mesh_view and --platform (apps/train_cli.py) on the
CPU: the tiny random model (T=3) on a (1, 3) mesh of the CPU against the
unsharded CLI, checkpoints resumed across sharding, and the refusals JAX's
CLI makes.
"""

import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch.training.checkpoint import restore_train_state
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)


def test_train_cli_mesh_view_on_the_cpu(tmp_path, monkeypatch):
    """--mesh_view 3 --platform cpu trains the tiny model (T=3) on a (1, 3)
    mesh of the CPU, each loss within 1e-5 of the unsharded CLI's and its
    checkpoint bit-equal to the live weights; each run's checkpoint resumes the other kind (a
    resumed run re-seeds its draws and batches, as JAX's does, so the two
    resumed runs are held to each other). --mesh_view 2 raises where JAX
    raises (T % 2), and so does --lora_rank with a mesh."""
    import shutil

    from test_torch_data import _reconfusion_scene

    from stable_virtual_camera_tpu_torch.apps import train_cli
    from stable_virtual_camera_tpu_torch.apps.train_cli import main

    made = []
    make = train_cli.random_model_bundle
    monkeypatch.setattr(train_cli, "random_model_bundle", lambda device: made.append(make(device)) or made[-1])
    scene = _reconfusion_scene(tmp_path / "scene")
    kw = dict(data_path=scene, random_model=True, platform="cpu", lr=1e-4, warmup_steps=1, log_every=1)
    with pytest.raises(ValueError, match="--lora_rank does not combine with --mesh_view"):
        main(work_dir=str(tmp_path / "lora"), num_steps=1, mesh_view=3, lora_rank=2, **kw)
    with pytest.raises(ValueError, match="must divide --mesh_view 2"):
        main(work_dir=str(tmp_path / "two"), num_steps=1, mesh_view=2, **kw)
    plain = main(work_dir=str(tmp_path / "plain"), num_steps=2, **kw)
    mesh = main(work_dir=str(tmp_path / "mesh"), num_steps=2, mesh_view=3, **kw)
    np.testing.assert_allclose(mesh["losses"], plain["losses"], rtol=1e-5)
    live = dict(made[-1][0].unet.named_parameters())
    for name, t in restore_train_state(mesh["ckpt_path"])[0].items():
        assert torch.equal(t, live[name].detach()), name
    for src, dst in (("plain", "mesh_from_plain"), ("mesh", "plain_from_mesh")):
        shutil.copytree(tmp_path / src, tmp_path / dst)
    on_mesh = main(work_dir=str(tmp_path / "mesh_from_plain"), num_steps=3, mesh_view=3, **kw)
    unsharded = main(work_dir=str(tmp_path / "plain_from_mesh"), num_steps=3, **kw)
    assert len(on_mesh["losses"]) == len(unsharded["losses"]) == 1
    np.testing.assert_allclose(on_mesh["losses"], unsharded["losses"], rtol=1e-5)
    params, _, n, _ = restore_train_state(on_mesh["ckpt_path"])
    ref, _, _, _ = restore_train_state(unsharded["ckpt_path"])
    assert n == 3
    for name, t in ref.items():
        np.testing.assert_allclose(params[name].numpy(), t.numpy(), atol=2e-3, err_msg=name)
