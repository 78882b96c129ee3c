"""Flow-matching Euler scheduler for FLUX.2.

The sigma schedule is host numpy math copied from
``flux2_tpu/ops/scheduler.py``: that module imports ``jax.numpy``, so the
port carries its own copy. Both compute in float64 and store float32, so the
two schedules are equal bit for bit (the tests check it). ``set_custom_sigmas``
(Turbo-LoRA style schedules) and img2img's ``scale_noise`` are copied too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

NUM_TRAIN_TIMESTEPS = 1000


def compute_empirical_mu(image_seq_len: int, num_steps: int) -> float:
    """FLUX.2 empirical time-shift parameter mu (diffusers' pipeline_flux2 fit)."""
    a1, b1 = 8.73809524e-05, 1.89833333
    a2, b2 = 0.00016927, 0.45666666

    if image_seq_len > 4300:
        return a2 * image_seq_len + b2

    m_200 = a2 * image_seq_len + b2
    m_10 = a1 * image_seq_len + b1
    a = (m_200 - m_10) / 190.0
    b = m_200 - 200.0 * a
    return a * num_steps + b


def time_shift_exponential(mu: float, sigma: float, t: np.ndarray) -> np.ndarray:
    """Exponential time shift: exp(mu) / (exp(mu) + (1/t - 1)**sigma)."""
    exp_mu = math.exp(mu)
    return exp_mu / (exp_mu + (1.0 / t - 1.0) ** sigma)


@dataclasses.dataclass(frozen=True)
class SigmaSchedule:
    """``sigmas`` has n + 1 float32 entries ending in 0.0; step i goes
    from sigmas[i] to sigmas[i+1]. ``t_start`` is the strength skip (0 for T2I)."""

    sigmas: np.ndarray
    t_start: int
    mu: float

    @property
    def num_steps(self) -> int:
        return len(self.sigmas) - 1

    @property
    def initial_sigma(self) -> float:
        return float(self.sigmas[0]) if len(self.sigmas) else 1.0

    @property
    def timesteps(self) -> np.ndarray:
        """Timesteps in the [0, 1000] convention (sigma * num_train_timesteps)."""
        return self.sigmas * NUM_TRAIN_TIMESTEPS

    def sigma_pairs(self) -> np.ndarray:
        """[n, 2] float32 array of (sigma, sigma_next) per step."""
        return np.stack([self.sigmas[:-1], self.sigmas[1:]], axis=-1)


def set_timesteps(
    num_inference_steps: int,
    image_seq_len: Optional[int] = None,
    strength: float = 1.0,
    mu: Optional[float] = None,
) -> SigmaSchedule:
    """linspace(1, 1/N) -> exponential time shift by the empirical mu ->
    terminal 0.0 appended -> strength-based prefix skip."""
    if mu is None:
        seq_len = image_seq_len if image_seq_len is not None else 4096
        mu = compute_empirical_mu(seq_len, num_inference_steps)

    raw = 1.0 - np.arange(num_inference_steps, dtype=np.float64) / num_inference_steps
    shifted = time_shift_exponential(mu, 1.0, raw)
    sigmas = np.concatenate([shifted, [0.0]]).astype(np.float32)

    clamped = min(max(strength, 0.01), 1.0)
    t_start = max(0, num_inference_steps - int(num_inference_steps * clamped))
    return SigmaSchedule(sigmas=sigmas[t_start:], t_start=t_start, mu=mu)


def set_custom_sigmas(custom_sigmas: Sequence[float]) -> SigmaSchedule:
    """Schedule from an explicit sigma list; a terminal 0.0 is appended when
    absent, so N sigmas always give N steps."""
    sig = list(float(s) for s in custom_sigmas)
    if not sig:
        raise ValueError("custom sigmas must be non-empty")
    if sig[-1] != 0.0:
        sig.append(0.0)
    return SigmaSchedule(sigmas=np.asarray(sig, dtype=np.float32), t_start=0, mu=float("nan"))


def euler_step(
    sample: torch.Tensor, velocity: torch.Tensor, sigma: float, sigma_next: float
) -> torch.Tensor:
    """x_next = x + (sigma_next - sigma) * v, with dt rounded to float32 as in JAX."""
    dt = float(np.float32(sigma_next) - np.float32(sigma))
    return sample + dt * velocity.to(sample.dtype)


def scale_noise(sample: torch.Tensor, sigma: float, noise: torch.Tensor) -> torch.Tensor:
    """Flow-matching forward interpolation in the sample's dtype (img2img's
    start): x_t = (1 - sigma) * x0 + sigma * noise."""
    sigma = torch.tensor(sigma, dtype=sample.dtype, device=sample.device)
    return (1.0 - sigma) * sample + sigma * noise.to(sample.dtype)


def get_velocity(sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Rectified-flow velocity target: v = noise - sample."""
    return noise - sample
