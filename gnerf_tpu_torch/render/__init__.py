"""Volume rendering: rays, depth sampling, tri-plane lookups, compositing."""

from .importance import sample_importance, sample_pdf, sample_stratified, smooth_weights
from .math_utils import get_ray_limits_box, linspace_batched, normalize_vecs
from .ray_marcher import march_rays
from .ray_sampler import sample_rays
from .renderer import (project_onto_planes, render_rays, run_model, sample_from_planes,
                       unify_samples)

__all__ = [
    "get_ray_limits_box", "linspace_batched", "march_rays", "normalize_vecs",
    "project_onto_planes", "render_rays", "run_model", "sample_from_planes",
    "sample_importance", "sample_pdf", "sample_rays", "sample_stratified",
    "smooth_weights", "unify_samples",
]
