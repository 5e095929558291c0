"""Euler discrete scheduler with EDM v-prediction (SVD semantics).

Port of ``unigeo_tpu/models/depthcrafter/scheduler.py``: the sigma and
timestep tables are the same numpy code (Karras ramp, rho 7, between the
config's sigma_max 700 and sigma_min 0.002, terminated by 0; continuous
c_noise = 0.25 ln sigma); the per-step arithmetic works on tensors or floats.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class EulerDiscreteConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    timestep_spacing: str = "leading"  # linspace | leading | trailing
    steps_offset: int = 1
    use_karras_sigmas: bool = True
    sigma_min: Optional[float] = 0.002
    sigma_max: Optional[float] = 700.0
    timestep_type: str = "continuous"  # "discrete" | "continuous"
    karras_rho: float = 7.0


class EulerDiscreteScheduler:
    def __init__(self, config: EulerDiscreteConfig = EulerDiscreteConfig()):
        self.config = config
        betas = (
            np.linspace(
                config.beta_start**0.5,
                config.beta_end**0.5,
                config.num_train_timesteps,
                dtype=np.float64,
            )
            ** 2
        )
        alphas_cumprod = np.cumprod(1.0 - betas)
        self.train_sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)

    def _spaced_timesteps(self, num_inference_steps: int) -> np.ndarray:
        n_train = self.config.num_train_timesteps
        spacing = self.config.timestep_spacing
        if spacing == "linspace":
            return np.linspace(0, n_train - 1, num_inference_steps, dtype=np.float64)[::-1]
        if spacing == "leading":
            step = n_train // num_inference_steps
            ts = (np.arange(num_inference_steps) * step).round()[::-1].astype(np.float64)
            return ts + self.config.steps_offset
        if spacing == "trailing":
            step = n_train / num_inference_steps
            return np.arange(n_train, 0, -step).round().astype(np.float64) - 1
        raise ValueError(f"unknown timestep_spacing {spacing!r}")

    def _karras_sigmas(self, in_sigmas: np.ndarray, n: int) -> np.ndarray:
        cfg = self.config
        sigma_min = cfg.sigma_min if cfg.sigma_min is not None else float(in_sigmas[-1])
        sigma_max = cfg.sigma_max if cfg.sigma_max is not None else float(in_sigmas[0])
        rho = cfg.karras_rho
        ramp = np.linspace(0, 1, n, dtype=np.float64)
        min_inv_rho = sigma_min ** (1 / rho)
        max_inv_rho = sigma_max ** (1 / rho)
        return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho

    def inference_sigmas(self, num_inference_steps: int) -> np.ndarray:
        """[num_steps+1] descending sigmas, last = 0 (float32)."""
        timesteps = self._spaced_timesteps(num_inference_steps)
        sigmas = np.interp(
            timesteps, np.arange(self.config.num_train_timesteps), self.train_sigmas
        )
        if self.config.use_karras_sigmas:
            sigmas = self._karras_sigmas(sigmas, num_inference_steps)
        return np.concatenate([sigmas, [0.0]]).astype(np.float32)

    def timesteps_for_sigmas(self, sigmas: np.ndarray) -> np.ndarray:
        if self.config.timestep_type == "continuous":
            return (0.25 * np.log(np.asarray(sigmas, np.float64))).astype(np.float32)
        return np.interp(
            sigmas, self.train_sigmas, np.arange(self.config.num_train_timesteps)
        ).astype(np.float32)

    @staticmethod
    def scale_model_input(sample, sigma: float):
        return sample / math.sqrt(sigma**2 + 1.0)

    @staticmethod
    def denoised_from_v(sample, v_pred, sigma: float):
        """EDM v-prediction preconditioning: c_out*v + c_skip*x."""
        c_out = -sigma / math.sqrt(sigma**2 + 1.0)
        c_skip = 1.0 / (sigma**2 + 1.0)
        return v_pred * c_out + sample * c_skip

    @staticmethod
    def euler_step(sample, denoised, sigma: float, sigma_next: float):
        derivative = (sample - denoised) / sigma
        return sample + derivative * (sigma_next - sigma)
