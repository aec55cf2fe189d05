"""Masked-diffusion noise schedules: sigma(t) and d sigma(t)/dt.

Port of the five schedules of ``esmdiff_tpu/diffusion/noise.py``
(LogLinear — the MDLM default and the one the sampler uses — Cosine,
CosineSqr, Linear, Geometric), as stateless functions of a float32 tensor,
with ``sigma_min``/``sigma_max`` and the importance-sampling transforms of
LogLinear and Linear that the training loss uses; and the BERT-style MLM
corruption (``sample_mask_rate``, ``get_inputs_for_mlm``), whose draws come
from an explicit generator (``MlmDraws``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from esmdiff_tpu_torch.core.constants import (STRUCTURE_MASK_TOKEN,
                                            VQVAE_CODEBOOK_SIZE)


@dataclasses.dataclass(frozen=True)
class Noise:
    """Base schedule.  ``__call__(t) -> (total_noise sigma(t), rate)``."""

    def total_noise(self, t):
        raise NotImplementedError

    def rate_noise(self, t):
        raise NotImplementedError

    def __call__(self, t):
        t = torch.as_tensor(t, dtype=torch.float32)
        return self.total_noise(t), self.rate_noise(t)

    @property
    def sigma_min(self):
        return self.total_noise(torch.tensor(0.0))

    @property
    def sigma_max(self):
        return self.total_noise(torch.tensor(1.0))


@dataclasses.dataclass(frozen=True)
class LogLinearNoise(Noise):
    """sigma(t) = -log1p(-(1-eps) t); move chance 1-exp(-sigma) = (1-eps) t."""

    eps: float = 1e-3

    def total_noise(self, t):
        return -torch.log1p(-(1 - self.eps) * t)

    def rate_noise(self, t):
        return (1 - self.eps) / (1 - (1 - self.eps) * t)

    def importance_sampling_transformation(self, t):
        f_T = torch.log1p(-torch.exp(-self.sigma_max.to(t.device)))
        f_0 = torch.log1p(-torch.exp(-torch.tensor(self.eps, device=t.device)))
        sigma_t = -torch.log1p(-torch.exp(t * f_T + (1 - t) * f_0))
        return -torch.expm1(-sigma_t) / (1 - self.eps)


@dataclasses.dataclass(frozen=True)
class CosineNoise(Noise):
    eps: float = 1e-3

    def total_noise(self, t):
        cos = torch.cos(t * math.pi / 2)
        return -torch.log(self.eps + (1 - self.eps) * cos)

    def rate_noise(self, t):
        cos = (1 - self.eps) * torch.cos(t * math.pi / 2)
        sin = (1 - self.eps) * torch.sin(t * math.pi / 2)
        return (math.pi / 2) * sin / (cos + self.eps)


@dataclasses.dataclass(frozen=True)
class CosineSqrNoise(Noise):
    eps: float = 1e-3

    def total_noise(self, t):
        cos = torch.cos(t * math.pi / 2) ** 2
        return -torch.log(self.eps + (1 - self.eps) * cos)

    def rate_noise(self, t):
        cos = (1 - self.eps) * torch.cos(t * math.pi / 2) ** 2
        sin = (1 - self.eps) * torch.sin(t * math.pi)
        return (math.pi / 2) * sin / (cos + self.eps)


@dataclasses.dataclass(frozen=True)
class LinearNoise(Noise):
    sigma_min_v: float = 0.0
    sigma_max_v: float = 10.0

    def total_noise(self, t):
        return self.sigma_min_v + t * (self.sigma_max_v - self.sigma_min_v)

    def rate_noise(self, t):
        return torch.full_like(t, self.sigma_max_v - self.sigma_min_v)

    def importance_sampling_transformation(self, t):
        f_T = torch.log1p(-torch.exp(-self.sigma_max.to(t.device)))
        f_0 = torch.log1p(-torch.exp(-self.sigma_min.to(t.device)))
        sigma_t = -torch.log1p(-torch.exp(t * f_T + (1 - t) * f_0))
        return ((sigma_t - self.sigma_min_v)
                / (self.sigma_max_v - self.sigma_min_v))


@dataclasses.dataclass(frozen=True)
class GeometricNoise(Noise):
    sigma_min_v: float = 1e-3
    sigma_max_v: float = 1.0

    def total_noise(self, t):
        return self.sigma_min_v ** (1 - t) * self.sigma_max_v ** t

    def rate_noise(self, t):
        return self.total_noise(t) * (
            math.log(self.sigma_max_v) - math.log(self.sigma_min_v))


NOISE_REGISTRY = {
    "loglinear": LogLinearNoise,
    "cosine": CosineNoise,
    "cosinesqr": CosineSqrNoise,
    "linear": LinearNoise,
    "geometric": GeometricNoise,
}


def get_noise(name: str, **kwargs) -> Noise:
    return NOISE_REGISTRY[name](**kwargs)


# ---------------------------------------------------------------------------
# BERT-style MLM corruption (reference get_inputs_for_mlm, noise_utils.py:38-63)
# ---------------------------------------------------------------------------

class MlmDraws:
    """Draw source of ``sample_mask_rate`` and ``get_inputs_for_mlm``: one
    explicit ``torch.Generator`` on ``device``, each call the next values.
    A test injects another source with the same methods (JAX's draws)."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def uniform(self, shape=()):
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32)

    def beta(self, a: int, b: int):
        """A Beta(a, b) scalar for integer a, b: the a-th smallest of
        a + b - 1 uniforms."""
        if int(a) != a or int(b) != b or a < 1 or b < 1:
            raise ValueError(f"Beta({a}, {b}): integer parameters >= 1 only")
        u = self.uniform((int(a) + int(b) - 1,))
        return torch.sort(u).values[int(a) - 1]

    def codes(self, shape):
        """Uniform structure codes in [0, VQVAE_CODEBOOK_SIZE)."""
        return torch.randint(0, VQVAE_CODEBOOK_SIZE, tuple(shape),
                             generator=self.generator, device=self.device)


def sample_mask_rate(draws, schedule: str = "beta"):
    """Scalar mask-rate sampler matching the reference schedules."""
    if schedule == "beta":
        return draws.beta(3, 9) * 0.80 + draws.uniform() * 0.20
    if schedule == "linear":
        return draws.uniform()
    if schedule == "cosine":
        return torch.cos(draws.uniform() * math.pi * 0.5)
    if schedule == "constant":
        return torch.tensor(0.15, dtype=torch.float32)
    raise ValueError(f"Unknown mask-rate schedule: {schedule}")


def get_inputs_for_mlm(draws, inputs, mask_rate):
    """80/10/10 BERT corruption over structure tokens; specials shielded.

    Returns (corrupted_inputs, labels (-100 on uncounted), masked_indices).
    """
    special = inputs >= VQVAE_CODEBOOK_SIZE
    rate = torch.as_tensor(mask_rate, dtype=torch.float32,
                           device=inputs.device)
    prob = torch.where(special, torch.zeros_like(rate), rate)
    masked = draws.uniform(inputs.shape).to(inputs.device) < prob
    labels = torch.where(masked, inputs, -100)
    replaced = (draws.uniform(inputs.shape).to(inputs.device) < 0.8) & masked
    out = torch.where(replaced, STRUCTURE_MASK_TOKEN, inputs)
    randomized = ((draws.uniform(inputs.shape).to(inputs.device) < 0.5)
                  & masked & ~replaced)
    rand_tokens = draws.codes(inputs.shape).to(inputs.device, inputs.dtype)
    out = torch.where(randomized, rand_tokens, out)
    return out, labels, masked
