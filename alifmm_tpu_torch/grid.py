"""Model container and nearest-neighbour grid refinement in PyTorch.

Counterpart of ``alifmm_tpu/grid.py``.  ``Model`` is a frozen dataclass of
tensors on one device; its static metadata (``has_stif`` and the column
summaries) are plain Python fields.  A model may carry a leading source
batch dimension on its per-cell fields -- the solver's per-source patch
models do -- and every function here broadcasts over it.

``make_model``'s precompute: the ray tracer's unified curve tables are
host numpy, as in the JAX package; the fallback slowness planes are host
numpy for a CPU build and K6 (``ops/cuda_planes``, one launch on the
uploaded fields) for a build on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import materials as mat
from .ops import cuda_planes
from .utils.profiling import span, spanned

__all__ = ["Model", "make_model", "model_from_numpy", "resolve_device",
           "refine_nearest", "refine_nearest_3d", "refine_model",
           "phase_velocity_at", "group_velocity_at"]

# Tensor fields of Model, in declaration order.
TENSOR_FIELDS = ("veln", "velpn", "vel_map", "stif", "group_tab", "phase_tab",
                 "fallback_slowness", "dnx", "ray_curves", "ray_curve_idx",
                 "ray_skew")
_INT_FIELDS = ("velpn", "ray_curve_idx")


@dataclasses.dataclass(frozen=True)
class Model:
    """Material model on a regular grid plus precomputed per-point planes.

    ``veln``/``velpn``/``vel_map``: (..., Z, X); ``stif``: (..., Z, X, 5)
    (c22, c23, c33, c44, rho) in MPa; ``fallback_slowness``: (..., 4, Z, X)
    group slownesses at the FD fallback's fixed wave angles; ``dnx``: 0-d
    tensor in the model dtype.  ``ray_*`` are None on patch models.
    """

    veln: torch.Tensor
    velpn: torch.Tensor
    vel_map: torch.Tensor
    stif: torch.Tensor
    group_tab: torch.Tensor
    phase_tab: torch.Tensor
    fallback_slowness: torch.Tensor
    dnx: torch.Tensor
    ray_curves: torch.Tensor | None
    ray_curve_idx: torch.Tensor | None
    ray_skew: torch.Tensor | None
    has_stif: bool
    phase_info: tuple | None = None
    group_info: tuple | None = None
    ray_info: tuple | None = None
    skew_info: tuple | None = None

    @property
    def shape(self):
        return tuple(self.veln.shape[-2:])

    @property
    def dtype(self):
        return self.vel_map.dtype

    @property
    def device(self):
        return self.vel_map.device


def _nearest_index(n_coarse: int, scale: int, device=None) -> torch.Tensor:
    n_fine = scale * (n_coarse - 1) + 1
    k = torch.arange(n_fine, device=device)
    # round(k / scale) with scale odd: ties cannot occur
    return torch.clamp((k + scale // 2) // scale, 0, n_coarse - 1)


def refine_nearest(arr, scale: int, dtype=None):
    """Nearest-neighbour upsample of the last two axes by odd ``scale``
    (output ``scale * (n - 1) + 1``).  ``dtype=torch.int32`` replicates the
    reference's truncation of the orientation field."""
    if scale == 1:
        return arr if dtype is None else arr.to(dtype)
    iz = _nearest_index(arr.shape[-2], scale, arr.device)
    ix = _nearest_index(arr.shape[-1], scale, arr.device)
    out = arr[..., iz, :][..., ix]
    return out if dtype is None else out.to(dtype)


def refine_nearest_3d(arr, scale: int):
    """Nearest-neighbour upsample of a (..., Z, X, C) material array."""
    if scale == 1:
        return arr
    iz = _nearest_index(arr.shape[-3], scale, arr.device)
    ix = _nearest_index(arr.shape[-2], scale, arr.device)
    return arr[..., iz, :, :][..., ix, :]


def refine_model(model: Model, scale: int) -> Model:
    """Nearest-neighbour refinement of a whole model by odd ``scale``, on
    its device, with the reference's dtype quirks: ``veln`` through int32,
    ``velpn`` int; ``dnx / scale``; the fallback slowness planes rebuilt
    on the refined fields, the curve indices refined, the curve tables
    kept."""
    if scale == 1:
        return model
    veln = refine_nearest(model.veln, scale, torch.int32).to(model.dtype)
    velpn = refine_nearest(model.velpn, scale, torch.int32)
    vel_map = refine_nearest(model.vel_map, scale)
    stif = refine_nearest_3d(model.stif, scale)
    fb = _fallback_slowness_planes(veln, velpn, vel_map, stif,
                                   model.group_tab, model.has_stif)
    curve_idx = (refine_nearest(model.ray_curve_idx, scale)
                 if model.ray_curve_idx is not None else None)
    return dataclasses.replace(
        model, veln=veln, velpn=velpn, vel_map=vel_map, stif=stif,
        fallback_slowness=fb, dnx=model.dnx / scale, ray_curve_idx=curve_idx)


def _stif_cols(stif):
    return [stif[..., c] for c in range(5)]


def group_velocity_at(model: Model, eff_angle_deg):
    """Group velocity at per-point effective angle: table interpolation for
    ``velpn != 0``, the runtime Christoffel solve otherwise."""
    eff = torch.remainder(eff_angle_deg, 180.0)
    v_tab = mat.interp_table(model.group_tab, eff, model.velpn, model.vel_map,
                             info=model.group_info)
    if not model.has_stif:
        return v_tab
    v_chr = mat.group_velocity_christoffel(eff, *_stif_cols(model.stif),
                                           model.vel_map)
    return torch.where(model.velpn != 0, v_tab, v_chr)


def phase_velocity_at(model: Model, eff_angle_deg, velpn=None, vel_map=None,
                      stif=None):
    """Phase velocity at per-point effective angle (the ALI update's
    velocity).  Optional overrides evaluate at sliced material planes."""
    velpn = model.velpn if velpn is None else velpn
    vel_map = model.vel_map if vel_map is None else vel_map
    stif = model.stif if stif is None else stif
    eff = torch.remainder(eff_angle_deg, 180.0)
    v_tab = mat.interp_table(model.phase_tab, eff, velpn, vel_map,
                             info=model.phase_info)
    if not model.has_stif:
        return v_tab
    v_chr = mat.phase_velocity_christoffel(eff, *_stif_cols(stif), vel_map)
    return torch.where(velpn != 0, v_tab, v_chr)


def _fallback_slowness_planes(veln, velpn, vel_map, stif, group_tab,
                              has_stif):
    """Per-point group slowness at the four fixed FD-fallback wave angles,
    stacked as (..., 4, Z, X).  Effective angles: axis ``-veln``, diagonal
    ``round(45 - veln)``, knights ``-27 - veln`` and ``27 - veln``, all
    mod 180."""
    effs = [
        torch.remainder(0.0 - veln, 180.0),
        torch.round(torch.remainder(45.0 - veln, 180.0)),
        torch.remainder(-27.0 - veln, 180.0),
        torch.remainder(27.0 - veln, 180.0),
    ]
    planes = []
    for eff in effs:
        v = mat.interp_table_gather(group_tab, eff, velpn, vel_map)
        if has_stif:
            v_chr = mat.group_velocity_christoffel(eff, *_stif_cols(stif),
                                                   vel_map)
            v = torch.where(velpn != 0, v, v_chr)
        planes.append(1.0 / v)
    return torch.stack(planes, dim=-3)


# --------------------------------------------------------------------- #
# Host-side numpy precompute (the same mirrors as the JAX package's
# grid.py, float64, cast by the caller).
# --------------------------------------------------------------------- #


def _np_group_velocity_christoffel(angle_deg, c22, c23, c33, c44, rho,
                                   vel_scale=1.0):
    angle = np.mod(angle_deg, 180.0)
    m90 = np.mod(angle, 90.0)
    near_axis = (m90 < 0.01) | (m90 > 90.0 - 0.01)
    near_90 = np.abs(angle - 90.0) < 1.0
    lam_axis = np.where(near_90, c33, c22)
    v_axis = 1000.0 * vel_scale * np.sqrt(lam_axis / rho)
    ang_safe = np.where(near_axis, 45.0, angle)
    tan_ang = np.tan(np.radians(ang_safe))
    A = c22 + c33 - 2.0 * c44
    B = (c23 + c44) * (tan_ang - 1.0 / tan_ang)
    C = c22 - c33
    disc = np.sqrt(np.maximum(B * B + A * A - C * C, 0.0))
    denom = C - A
    denom = np.where(denom == 0.0, np.finfo(np.float64).tiny, denom)
    sign = np.where(ang_safe < 90.0, -1.0, 1.0)
    phase_ang = np.mod(np.arctan((-B + sign * disc) / denom), np.pi)
    lam = 0.5 * (
        np.cos(2.0 * phase_ang) * (c22 - c44)
        + np.sin(2.0 * phase_ang) * (c23 + c44) * tan_ang
        + c22
        + c44
    )
    v_gen = (
        1000.0
        * vel_scale
        * np.sqrt(np.maximum(lam, 0.0) / rho)
        / np.cos(np.radians(ang_safe) - phase_ang)
    )
    return np.where(near_axis, v_axis, v_gen)


def _np_phase_velocity_christoffel(angle_deg, c22, c23, c33, c44, rho,
                                   vel_scale=1.0):
    ca = np.cos(np.radians(angle_deg))
    sa = np.sin(np.radians(angle_deg))
    A = ca * ca * c22 + sa * sa * c44
    B = ca * sa * (c23 + c44)
    C = ca * ca * c44 + sa * sa * c33
    lam = 0.5 * (A + C + np.sqrt((A - C) ** 2 + 4.0 * B * B))
    return 1000.0 * vel_scale * np.sqrt(lam / rho)


def _np_interp_table(table, eff, mat_idx, vel_map):
    eff = np.mod(eff, 180.0)
    a1 = np.clip(np.floor(eff).astype(np.int64), 0, 179)
    a2 = np.mod(a1 + 1, 180)
    w = eff - a1
    m = np.asarray(mat_idx, dtype=np.int64)
    return vel_map * ((1.0 - w) * table[a1, m] + w * table[a2, m])


def _np_fallback_slowness_planes(veln, velpn, vel_map, stif, group_tab,
                                 has_stif):
    effs = [
        np.mod(0.0 - veln, 180.0),
        np.round(np.mod(45.0 - veln, 180.0)),
        np.mod(-27.0 - veln, 180.0),
        np.mod(27.0 - veln, 180.0),
    ]
    planes = []
    for eff in effs:
        v = _np_interp_table(group_tab, eff, velpn, vel_map)
        if has_stif:
            v_chr = _np_group_velocity_christoffel(
                eff, stif[..., 0], stif[..., 1], stif[..., 2],
                stif[..., 3], stif[..., 4], vel_map,
            )
            v = np.where(velpn != 0, v, v_chr)
        planes.append(1.0 / v)
    return np.stack(planes)


def _unique_rows(rows):
    """The sorted unique rows of a 2-D array and each row's index among
    them: ``np.unique(rows, axis=0, return_inverse=True)``, by a lexsort
    of the columns, which takes a fraction of its time at 200,000 rows."""
    order = np.lexsort(rows.T[::-1])
    srt = rows[order]
    first = np.ones(len(srt), dtype=bool)
    first[1:] = np.any(srt[1:] != srt[:-1], axis=1)
    inv = np.empty(len(srt), dtype=np.intp)
    inv[order] = np.cumsum(first) - 1
    return srt[first], inv


def _ray_curve_tables(velpn_np, stif_np, group_tab_np, phase_tab_np,
                      has_stif):
    """Unified per-cell-class curve tables of the ray tracer: returns
    (curves (181, M+U), skew (181, M+U), curve_idx (Z, X) int32).  Table
    material m keeps its group curve; each unique stiffness row gets its
    closed-form Christoffel group curve sampled at 1 degree."""
    M = group_tab_np.shape[1]
    curves = [np.asarray(group_tab_np[:181], dtype=np.float64)]
    phase_cols = [np.asarray(phase_tab_np[:181], dtype=np.float64)]
    idx = np.asarray(velpn_np, dtype=np.int32).copy()
    if has_stif:
        flat = np.asarray(stif_np, dtype=np.float64).reshape(-1, 5)
        uniq, inv = _unique_rows(flat)
        ang = np.arange(181.0)[:, None]
        ucurves = _np_group_velocity_christoffel(
            ang, uniq[None, :, 0], uniq[None, :, 1], uniq[None, :, 2],
            uniq[None, :, 3], uniq[None, :, 4],
        )
        upcurves = _np_phase_velocity_christoffel(
            ang, uniq[None, :, 0], uniq[None, :, 1], uniq[None, :, 2],
            uniq[None, :, 3], uniq[None, :, 4],
        )
        curves.append(ucurves)
        phase_cols.append(upcurves)
        stif_id = (M + inv.reshape(idx.shape)).astype(np.int32)
        idx = np.where(idx != 0, idx, stif_id).astype(np.int32)
    group = np.concatenate(curves, axis=1)
    phase = np.concatenate(phase_cols, axis=1)
    # d(v_p)/d(phi) per radian by 180-periodic central differences; column
    # 0 (the angle ramp) gets zero skew
    dv = np.empty_like(phase)
    dv[1:180] = (phase[2:181] - phase[0:179]) * (0.5 * 180.0 / np.pi)
    dv[0] = (phase[1] - phase[179]) * (0.5 * 180.0 / np.pi)
    dv[180] = dv[0]
    skew = np.degrees(np.arctan2(dv, phase))
    skew[:, 0] = 0.0
    return group, skew, idx


def resolve_device(device=None) -> torch.device:
    """The device a model is built on: ``None`` means the CUDA card, and a
    host without one raises rather than building on the CPU.  The CPU is
    used only when the caller asks for it (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: models are built on the card by default; pass "
            "device='cpu' to build on the CPU")
    return torch.device("cuda")


@spanned("build.upload")
def model_from_numpy(fields: dict, has_stif, phase_info=None, group_info=None,
                     ray_info=None, device=None, dtype=torch.float32,
                     skew_info=None) -> Model:
    """Model from a dict of host arrays keyed by field name (missing or None
    ray fields stay None).  Float fields are cast to ``dtype``; ``velpn``
    and ``ray_curve_idx`` become int32.  Carrying a JAX ``Model`` across
    field by field gives both packages the same state.  ``device``: see
    ``resolve_device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    kw = {}
    for name in TENSOR_FIELDS:
        a = fields.get(name)
        if a is None:
            kw[name] = None
            continue
        t = torch.from_numpy(np.array(a))
        t = t.to(torch.int32) if name in _INT_FIELDS else t.to(dtype)
        kw[name] = t.to(device)
    return Model(has_stif=bool(has_stif), phase_info=phase_info,
                 group_info=group_info, ray_info=ray_info,
                 skew_info=skew_info, **kw)


@spanned("build")
def make_model(veln, velpn, vel_map=None, stif_den=None, group_tab=None,
               phase_tab=None, dnx=1e-3, dtype=torch.float32,
               device=None) -> Model:
    """Assemble a Model from host arrays.  The ray curve tables are
    precomputed on the host in numpy; the fallback slowness planes too for
    a CPU build, while a build on the card uploads the fields and computes
    the planes there with K6 (``cuda_planes.fallback_planes``, float64
    arithmetic).  ``device``: the card by default, ``"cpu"`` on request
    (see ``resolve_device``).  Under a profiler the build is the range
    ``alifmm.build``, with ``alifmm.build.planes`` (on the card the host
    side of one launch), ``.tables`` and ``.upload`` inside it."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    npdt = torch.empty((), dtype=dtype).numpy().dtype
    # C order whatever the input's: K6 takes contiguous fields
    veln_np = np.asarray(veln).astype(npdt, order="C")
    velpn_np = np.asarray(velpn).astype(np.int32, order="C")
    if vel_map is None:
        vel_map_np = np.ones(veln_np.shape, dtype=npdt)
    else:
        vel_map_np = np.asarray(vel_map).astype(npdt, order="C")
    has_stif = stif_den is not None
    if has_stif:
        stif_np = np.asarray(stif_den).astype(npdt, order="C")
    else:
        stif_np = np.zeros(veln_np.shape + (5,), dtype=npdt)
    if group_tab is None or phase_tab is None:
        g, p = mat.default_tables()
        group_tab = g if group_tab is None else group_tab
        phase_tab = p if phase_tab is None else phase_tab
    group_tab_np = np.asarray(group_tab).astype(npdt, order="C")
    phase_tab_np = np.asarray(phase_tab).astype(npdt, order="C")
    fb = None
    if not on_card:
        with span("build.planes"):
            fb = _np_fallback_slowness_planes(
                veln_np, velpn_np, vel_map_np, stif_np, group_tab_np, has_stif
            ).astype(npdt)
    with span("build.tables"):
        curves, skew, curve_idx = _ray_curve_tables(
            velpn_np, stif_np, group_tab_np, phase_tab_np, has_stif
        )
        used = np.unique(velpn_np)
        used = used[used > 0]
        classes = np.unique(curve_idx)
        info = dict(phase_info=mat.column_info(phase_tab_np, used),
                    group_info=mat.column_info(group_tab_np, used),
                    ray_info=mat.column_info(curves, classes),
                    skew_info=mat.column_info(skew, classes))
    fields = dict(
        veln=veln_np, velpn=velpn_np, vel_map=vel_map_np, stif=stif_np,
        group_tab=group_tab_np, phase_tab=phase_tab_np, fallback_slowness=fb,
        dnx=np.asarray(dnx, dtype=npdt), ray_curves=curves,
        ray_curve_idx=curve_idx, ray_skew=skew,
    )
    model = model_from_numpy(fields, has_stif, device=device, dtype=dtype,
                             **info)
    if on_card:
        with span("build.planes"):
            fb = cuda_planes.fallback_planes(model.veln, model.velpn,
                                             model.vel_map, model.stif,
                                             model.group_tab, has_stif)
        model = dataclasses.replace(model, fallback_slowness=fb)
    return model
