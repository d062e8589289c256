"""BRDF evaluation: glTF metallic-roughness GGX + Lambertian diffuse.

Port of the JAX package's ``ops/brdf.py`` (reference src/rendering.rs:
129-184): Schlick Fresnel, GGX NDF with alpha = roughness^2, separable
Smith G1 in its numerically safe form, and ``lerp(dielectric, metal,
metallic)``. DIFFUSE evaluates plain Lambertian ``color / pi``.
"""

from __future__ import annotations

import math

import torch

from ..scene.types import DIFFUSE
from .vec import Vec3, lerp3, true_div, where3

PI = math.pi
_SAFE = 1e-12


def fresnel(f0: Vec3, f90: Vec3, h_dot_l: torch.Tensor) -> Vec3:
    w = torch.pow(torch.clamp(1.0 - torch.abs(h_dot_l), 0.0, 1.0), 5.0)
    return f0 + (f90 - f0) * w


def ggx_d(h_dot_n: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a2 = alpha * alpha
    denom = PI * torch.square((a2 - 1.0) * h_dot_n * h_dot_n + 1.0)
    chi = torch.where(h_dot_n > 0.0, 1.0, 0.0)
    return a2 * chi / torch.clamp(denom, min=_SAFE)


def smith_g1(n_dot_x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """G1 = 2 / (1 + sqrt(1 + alpha^2 tan^2 theta)); 0 below the horizon."""
    c2 = torch.clamp(n_dot_x * n_dot_x, _SAFE, 1.0)
    tan2 = (1.0 - c2) / c2
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))
    return torch.where(n_dot_x > 0.0, g1, 0.0)


def specular_brdf(l_dot_n, v_dot_n, h_dot_n, alpha) -> torch.Tensor:
    d = ggx_d(h_dot_n, alpha)
    g = smith_g1(l_dot_n, alpha) * smith_g1(v_dot_n, alpha)
    denom = 4.0 * l_dot_n * v_dot_n
    return d * g / torch.where(torch.abs(denom) > _SAFE, denom, _SAFE)


def eval_brdf(l: Vec3, n: Vec3, v: Vec3, color: Vec3, metallic: torch.Tensor,
              roughness: torch.Tensor, mkind: torch.Tensor) -> Vec3:
    """BRDF of the sampled-lobe materials (DIFFUSE and PBR); delta materials
    never reach it."""
    h = (l + v).normalize()
    diffuse = Vec3(true_div(color.x, PI), true_div(color.y, PI), true_div(color.z, PI))

    alpha = roughness * roughness
    spec = specular_brdf(l.dot(n), v.dot(n), h.dot(n), alpha)
    h_dot_l = h.dot(l)
    one = Vec3(1.0, 1.0, 1.0)
    metal = Vec3(spec, spec, spec).mul(fresnel(color, one, h_dot_l))
    f_diel = fresnel(Vec3(0.04, 0.04, 0.04), one, h_dot_l)
    dielectric = Vec3(spec, spec, spec).mul(f_diel) + diffuse.mul(one - f_diel)
    pbr = lerp3(dielectric, metal, metallic)
    return where3(mkind == DIFFUSE, diffuse, pbr)
