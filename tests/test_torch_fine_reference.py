"""PyTorch port, the fine path (``subgrid_size=9``) in float32 against the
benchmark's plain float64 reference (``benchmark/reference``: PyTorch and
numpy, importing nothing of the port or of the JAX package), on the CPU.

The case is a crop of the seeded weld of ``benchmark/configs/
weld_fine_qp.json``: the 3 x 3 model cells around element 12 of the bottom
row (x = 205), with the bottom-left domain turned to 48 degrees, an
orientation at which the reference's 9x deployment met negative times.
The solve's schedule is cut so that the plain twin runs in seconds: a 9x
patch of half 4 and a 3x patch of half 7 (the fine path's are 22 and 49)
with the fine path's seed side (40 points at 9x), so that the seed's edge
still lies inside the 9x patch, and one-pass budgets.

- ``test_fine_fields_match_reference``: the field has no bad point (the
  reference's count: unknown, not finite, not positive away from the
  element), the reference's local update moves it little outside the 3x
  patch's window, and the points the seed fixes (within 3 fine cells of
  the element) are the straight-ray times of the reference's closed-form
  group velocity at ``veln - angle``.  The parent's float32 seed had a
  negative group velocity at effective angles of 179.97-179.99 degrees (57
  negative points in this field) and the mirrored orientation ``veln +
  angle``.
- ``test_near_vertical_segment_matches_reference``: a segment one model
  cell long whose fine x coordinates are one float32 ulp apart and one
  float32 once divided by s: its float32 time against the reference's
  float64 integral along the same path (the parent took it as horizontal).

The kernels' side of the second case (K2's exact integrator and K3's ray
times against their twins) is ``chip_smoke.check_near_vertical``, run by
``test_near_vertical_segment_matches_plain_twin`` on a card."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import rays as trays
from alifmm_tpu_torch import solver as tsolver
from benchmark.lib import harness, weld
from benchmark.reference import check as chk
from benchmark.reference.model import RefModel, group_velocity_np
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 9
ELEMENT_X = 205
CROP_X = slice(ELEMENT_X - 1, ELEMENT_X + 2)
ROWS = 3
DOMAIN_DEG = 48
STAGES = ((4, 9), (7, 3))
BUDGET = dict(patch_max_passes=1, polish_passes=0, final_max_passes=2,
              final_polish_passes=1)
# No bad point: the reference's rule is exact.
# The residual's 90th percentile outside the 3x patch's window (7 fine
# points): the crop is all near-source field, whose points the cut budget
# leaves where the ALI update still moves them, 2.56e-3 on the change; the
# parent's field with its negative times reads 7.28e-3.
RESIDUAL_P90 = 5e-3
# The seed's straight-ray times, worked out in float64 and rounded to
# float32: half an ulp (6e-8) and the float32 dnx / 81 of the 9x patch
# (2 ulps), with room; the parent's mirrored orientation is 1e-2 to 1e-1
# off, and its negative times more.
SEED_RTOL = 1e-6
SEED_RADIUS = 3
# The reference's float64 integral along the returned path: the float32
# time reads 1e-8 to 1e-7 off it; the limit of the benchmark's ray times
# (``benchmark/limits/weld_qp.chain.json``); the parent reads 2.7e-2.
SEGMENT_RTOL = 1e-5
CROSS = 13


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "weld_fine_qp.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def crop():
    """The crop's maps (veln, velpn, vel_map, stif), the tables, dnx and the
    element's position (metres)."""
    cfg = _config()
    w = weld.weld_maps(cfg["weld_seed"], cfg)
    angles = w.angles.copy()
    angles[2, 0] = DOMAIN_DEG
    w = w.turned(angles)
    Z = cfg["shape"][0]
    maps = [a[Z - ROWS:Z, CROP_X] for a in (w.veln, w.velpn, w.vel_map,
                                            w.stif)]
    assert np.all(maps[0] == DOMAIN_DEG) and np.all(maps[1] == 0)
    dnx = cfg["dnx"]
    return dict(maps=maps, tabs=harness.default_tables(), dnx=dnx,
                scx=np.array([1 * dnx]), scz=np.array([(ROWS - 1) * dnx]))


def _model(crop, dtype=torch.float32):
    return tgrid.make_model(*crop["maps"], *crop["tabs"], crop["dnx"],
                            dtype=dtype, device="cpu")


def test_fine_fields_match_reference(crop, monkeypatch):
    side = tsolver.fine_stage_params(S)[1]
    monkeypatch.setattr(tsolver, "fine_stage_params",
                        lambda s: (STAGES, side))
    fields = tsolver.solve_ttf(_model(crop), crop["scx"], crop["scz"], S,
                               tsolver.SolveConfig(**BUDGET))
    assert fields.shape == (1, (ROWS - 1) * S + 1, 2 * S + 1)
    ref = RefModel(*crop["maps"], *crop["tabs"], crop["dnx"], "cpu",
                   scale=S)
    rows, cols = chk.source_points(crop["scx"], crop["scz"], crop["dnx"], S)
    bad, _, p90 = chk.field_numbers(ref, fields, rows, cols, [0],
                                    STAGES[1][0])
    assert bad == 0
    assert p90 <= RESIDUAL_P90

    f = fields[0].double().numpy()
    r0, c0 = int(rows[0]), int(cols[0])
    dz, dx = np.meshgrid(np.arange(-SEED_RADIUS, 1),
                         np.arange(-SEED_RADIUS, SEED_RADIUS + 1),
                         indexing="ij")
    r = np.hypot(dz, dx)
    near = (r > 0) & (r <= SEED_RADIUS)
    dz, dx, r = dz[near], dx[near], r[near]
    angle = np.where(dx == 0, 90.0,
                     np.degrees(np.arctan(dz / np.where(dx == 0, 1, dx))))
    stif = crop["maps"][3][-1, 1].astype(np.float64)
    v = group_velocity_np(DOMAIN_DEG - angle, *stif)
    want = crop["dnx"] / S * r / v
    got = f[r0 + dz, c0 + dx]
    np.testing.assert_allclose(got, want, rtol=SEED_RTOL, atol=0)


def test_near_vertical_segment_matches_reference(crop):
    x1, y1, x2, y2 = chip_smoke.near_vertical_segment(S, 1.0, S)
    sd = torch.tensor(float(S))
    a, b = torch.tensor([x1, x2])
    assert a != b and a / sd == b / sd
    model = _model(crop)
    got = trays.segment_time(model, trays._material_flat(model),
                             *(torch.tensor([v]) for v in (x1, y1, x2, y2)),
                             S, CROSS)
    ref = RefModel(*crop["maps"], *crop["tabs"], crop["dnx"], "cpu",
                   planes=False)
    # the path as the facade returns it: float32 fine points, float64 / s
    px = np.array([[x1, x2]]) / S
    py = np.array([[y1, y2]]) / S
    want = float(chk.path_time(ref, px, py, np.array([2]), CROSS)[0])
    assert abs(float(got[0]) - want) / want <= SEGMENT_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_near_vertical_segment_matches_plain_twin(dtype):
    if not torch.cuda.is_available():
        pytest.skip("K2 and K3 are CUDA kernels and need a CUDA device")
    chip_smoke.check_near_vertical(dtype, torch.device("cuda", 0))
