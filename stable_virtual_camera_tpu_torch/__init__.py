"""stable_virtual_camera_tpu_torch — the PyTorch/CUDA port for NVIDIA Hopper.

A second package beside the JAX reference `stable_virtual_camera_tpu`, with
the same module paths and function names. It imports torch and nothing of
jax or of the JAX package: the host code it shares with the reference
(config, camera and trajectory math, the chunk planner, anchor planning,
per-chunk values) is copied here. The TPU's Pallas kernels on the main path
are hand-written CUDA C++ for sm_90a (csrc/, built and bound by
_kernels.py), each beside a plain PyTorch version of the same math that CPU
tensors use.

Layers, entry point first:
  apps/      headless renderer (Basic mode)
  engine/    two-pass scene engine, chunk planner, anchors, VAE/CLIP
             appliers, writers
  sampling/  Euler-EDM loop, sigma schedule, CFG scale rules
  models/    Seva UNet, SD2.1 VAE, CLIP tower, weight bridge, random bundles
  ops/       attention (K1 flash, K2 temporal), norms, resizes
  core/      camera math, preset trajectories, Plücker rays, image transforms
"""

__version__ = "0.1.0"
