"""Model sanity checks (counterpart of ``alifmm_tpu/utils/validate.py``)."""

from __future__ import annotations

import torch

from .. import grid as gridlib
from .. import materials as mats

__all__ = ["min_max_vel"]


def min_max_vel(model: gridlib.Model):
    """Minimum and maximum group velocity over the model: stiffness cells
    sample the Christoffel group velocity at 0, 45, 90 and 135 degrees,
    table cells scale their column's extremes by ``vel_map``."""
    tab_min = model.group_tab.min(dim=0).values
    tab_max = model.group_tab.max(dim=0).values
    m = model.velpn.to(torch.int64)
    v_min = model.vel_map * tab_min[m]
    v_max = model.vel_map * tab_max[m]
    if model.has_stif:
        cols = [model.stif[..., c] for c in range(5)]
        v_st = torch.stack([
            mats.group_velocity_christoffel(
                torch.full_like(model.vel_map, ang), *cols, model.vel_map)
            for ang in (0.0, 45.0, 90.0, 135.0)])
        use_tab = m != 0
        v_min = torch.where(use_tab, v_min, v_st.min(dim=0).values)
        v_max = torch.where(use_tab, v_max, v_st.max(dim=0).values)
    return float(v_min.min()), float(v_max.max())
