"""Masked-diffusion noise schedules: sigma(t) and d sigma(t)/dt.

Port of the five schedules of ``esmdiff_tpu/diffusion/noise.py``
(LogLinear — the MDLM default and the one the sampler uses — Cosine,
CosineSqr, Linear, Geometric), as stateless functions of a float32 tensor,
with ``sigma_min``/``sigma_max`` and the importance-sampling transforms of
LogLinear and Linear that the training loss uses.
"""

from __future__ import annotations

import dataclasses
import math

import torch


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
