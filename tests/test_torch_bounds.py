"""The ray march's bound in chip_smoke.py counts the walk scorer's material
samples from each candidate's geometry (``chip_smoke.walk_crossings``):
the cell boundaries crossed on each axis plus the step to the end, capped
at the crossing budget.  Here that count is held to the walk's own control
flow (``rays._segment_time_walk``: a step is live until both axes are
done) on seeded segments, with exact equality."""

import pytest
import torch

import chip_smoke
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def walk_steps_taken(x1, y1, x2, y2, s, max_cross):
    """The steps of ``rays._segment_time_walk`` that are not done yet,
    counted by running its crossing logic without the material terms."""
    x1, x2, y1, y2 = x1 / s, x2 / s, y1 / s, y2 / s
    dx_zero = x2 == x1
    m = torch.where(dx_zero, 0.0,
                    (y2 - y1) / torch.where(dx_zero, 1.0, x2 - x1))
    c = y1 - m * x1
    dir_x = torch.where(x1 < x2, 1.0, -1.0).to(x1.dtype)
    dir_y = torch.where(y1 < y2, 1.0, -1.0).to(x1.dtype)
    m_zero = m == 0
    m_safe = torch.where(m_zero, 1.0, m)
    next_x = torch.round(x1) + dir_x * 0.5
    next_y = torch.round(y1) + dir_y * 0.5
    fin_x = torch.zeros_like(dx_zero)
    fin_y = torch.zeros_like(dx_zero)
    taken = torch.zeros(x1.shape, dtype=torch.int64)
    for _ in range(max_cross):
        done = fin_x & fin_y
        taken += (~done).to(torch.int64)
        past_x = (((next_x > x2) & (dir_x == 1))
                  | ((next_x < x2) & (dir_x == -1))) & ~fin_x
        next_x = torch.where(past_x, x2, next_x)
        past_y = (((next_y > y2) & (dir_y == 1))
                  | ((next_y < y2) & (dir_y == -1))) & ~fin_y
        next_y = torch.where(past_y, y2, next_y)
        d_x = (x1 - next_x) ** 2 + (y1 - (m * next_x + c)) ** 2
        d_y = (x1 - (next_y - c) / m_safe) ** 2 + (y1 - next_y) ** 2
        take_x = ~dx_zero & (m_zero | (d_x < d_y))
        next_x = torch.where(take_x, next_x + dir_x, next_x)
        next_y = torch.where(~take_x, next_y + dir_y, next_y)
        fin_x = fin_x | (past_x & ~done)
        fin_y = fin_y | (past_y & ~done)
    return taken


@pytest.mark.parametrize("cross", [16, 26])
@pytest.mark.parametrize("s", [9, 3])
def test_walk_crossings_count_the_walks_steps(s, cross):
    pts = chip_smoke.seeded_segments((48, 56), s, 4096, 17 + s,
                                     torch.float64, "cpu")
    want = walk_steps_taken(*pts, s, cross)
    got = chip_smoke.walk_crossings(*pts, s, cross)
    assert torch.equal(got.to(torch.int64), want)
    # the seeded segments reach the budget (the 40-cell block) and stop
    # after one step (the zero-length block)
    assert int(want.max()) == cross and int(want.min()) == 1
