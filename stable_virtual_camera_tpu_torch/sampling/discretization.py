"""EDM/DDPM noise-level discretization (host-side numpy, float64).

A copy of stable_virtual_camera_tpu/sampling/discretization.py: that module
is numpy-only, but importing it runs the JAX package's sampling/__init__.py,
which imports jax.

Capability parity with reference seva/sampling.py:28-102
(`make_betas`, `DDPMDiscretization`) and the EpsScaling preconditioner
coefficients (seva/sampling.py:46-54): sqrt-linear beta schedule, sigma =
sqrt((1-abar)/abar) shifted by exp(log_snr_shift), descending with appended 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def make_betas(
    num_timesteps: int, linear_start: float = 1e-4, linear_end: float = 2e-2
) -> np.ndarray:
    return (
        np.linspace(linear_start**0.5, linear_end**0.5, num_timesteps, dtype=np.float64)
        ** 2
    )


def equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    """Roughly equally spaced discrete timesteps (reference seva/sampling.py:40-43)."""
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


@dataclass(frozen=True)
class DDPMDiscretization:
    linear_start: float = 5e-6
    linear_end: float = 0.012
    num_timesteps: int = 1000
    log_snr_shift: float | None = 2.4

    @property
    def alphas_cumprod(self) -> np.ndarray:
        betas = make_betas(self.num_timesteps, self.linear_start, self.linear_end)
        return np.cumprod(1.0 - betas, axis=0)

    def get_sigmas(self, n: int) -> np.ndarray:
        """Descending sigmas for an n-step schedule (float32)."""
        if n < self.num_timesteps:
            timesteps = equally_spaced_steps(n, self.num_timesteps)
            alphas_cumprod = self.alphas_cumprod[timesteps]
        elif n == self.num_timesteps:
            alphas_cumprod = self.alphas_cumprod
        else:
            raise ValueError(f"Expected n <= {self.num_timesteps}, but got n = {n}.")
        sigmas = ((1 - alphas_cumprod) / alphas_cumprod) ** 0.5
        if self.log_snr_shift is not None:
            sigmas = sigmas * np.exp(self.log_snr_shift)
        return sigmas[::-1].astype(np.float32)  # descending

    def __call__(
        self, n: int, do_append_zero: bool = True, flip: bool = False
    ) -> np.ndarray:
        sigmas = self.get_sigmas(n)
        if do_append_zero:
            sigmas = np.concatenate([sigmas, np.zeros((1,), dtype=sigmas.dtype)])
        return sigmas[::-1].copy() if flip else sigmas

    def registered_sigmas(self) -> np.ndarray:
        """The 1000 ascending sigmas the discrete denoiser quantizes against
        (reference seva/sampling.py:121-124)."""
        return self(self.num_timesteps, do_append_zero=False, flip=True)


def sigma_to_idx(sigma: np.ndarray, registered: np.ndarray) -> np.ndarray:
    """Nearest discrete timestep index for each sigma
    (reference seva/sampling.py:126-128)."""
    dists = np.abs(sigma[..., None] - registered[None])
    return np.argmin(dists, axis=-1)
