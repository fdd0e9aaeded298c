"""PyTorch port, the examples: ``examples/tutorial_torch.ipynb`` executed
cell by cell, and ``examples/plot_rays_torch.py`` rendering saved rays.

The notebook runs on the CPU with its sizes cut (a source-text
substitution, as ``test_tutorial_notebook.py`` does for the JAX one):
``device = "cpu"``, n = 21 with the transducers moved inside, rays at
``subgrid_size=3``, the facades built with ``test_torch_api.py``'s cut
pass budget, and a first injected cell that sets the cut stage schedule
(one 3x patch stage, seed side 4), one intra-op thread and inference
mode: a solve then takes seconds, and the notebook's five solves run in
about a minute.  No cell may raise.  The facade's
numbers are held to the JAX package by ``test_torch_api.py``; here the
tutorial's calls must run, and the cut model must still give fields and
times of the right shape and sign."""

import os
import re

import nbformat
import numpy as np
from nbclient import NotebookClient

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.abspath(os.path.join(HERE, ".."))
NB_PATH = os.path.join(REPO, "examples", "tutorial_torch.ipynb")

SETUP = """\
import os
os.environ['MPLBACKEND'] = 'Agg'
import torch
torch.set_num_threads(1)
torch.inference_mode().__enter__()
import alifmm_tpu_torch
from alifmm_tpu_torch import solver
alifmm_tpu_torch.tqdm_disable = True
solver._COARSE_STAGES = ((2, 3),)
solver._COARSE_SEED_SIDE = 4
CUT_BUDGET = dict(patch_max_passes=3, final_max_passes=6, polish_passes=2)
"""

CHECKS = """\
assert fields.shape == (3, n, n) and np.isfinite(fields).all()
assert (fields[:, 1:] > 0).all()
assert (some[1] == 0).all() and (some[[0, 2]] > 0).any()
for t in (times, times_s):
    assert t.shape == (3, 3)
    assert (t[np.triu_indices(3, 1)] > 0).all(), t
assert np.isfinite(fields_a).all()
"""


def _shrink(src: str) -> str:
    """The notebook's size constants and device, cut for the CPU."""
    src = src.replace('device = "cuda"', 'device = "cpu"')
    src = re.sub(r"^n = 201$", "n = 21", src, flags=re.M)
    src = src.replace("subgrid_size=9", "subgrid_size=3")
    src = src.replace("dnx=dnx, device=device)",
                      "dnx=dnx, device=device, solve_opts=CUT_BUDGET)")
    return src.replace("np.array([40.0, 100.0, 160.0])",
                       "np.array([4.0, 10.0, 16.0])")


def test_tutorial_notebook_executes(monkeypatch):
    nb = nbformat.read(NB_PATH, as_version=4)
    code = [c for c in nb.cells if c.cell_type == "code"]
    assert len(code) >= 8, "tutorial lost its code cells?"
    assert sum('device=device' in c.source for c in code) == 2
    for cell in code:
        cell.source = _shrink(cell.source)
    assert any('device = "cpu"' in c.source for c in code)
    assert sum("solve_opts=CUT_BUDGET" in c.source for c in code) == 2
    nb.cells.insert(0, nbformat.v4.new_code_cell(SETUP))
    nb.cells.append(nbformat.v4.new_code_cell(CHECKS))

    monkeypatch.setenv("MPLBACKEND", "Agg")
    prev = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH",
                       REPO + (os.pathsep + prev if prev else ""))
    client = NotebookClient(
        nb, timeout=600, kernel_name="python3",
        resources={"metadata": {"path": os.path.dirname(NB_PATH)}},
    )
    client.execute()

    for cell in nb.cells:
        if cell.cell_type != "code":
            continue
        for out in cell.get("outputs", []):
            assert out.get("output_type") != "error", out


def _ray_files(tmp_path, veln_shape):
    """Seeded ray buffers of three transducers written by save_rays: pair
    (0, 1) a full ray, (0, 2) half of one, (1, 2) a full one."""
    from alifmm_tpu_torch.utils import io

    rng = np.random.default_rng(0)
    n, L = 3, 16
    Z, X = veln_shape
    ray_x = np.sort(rng.uniform(0, X - 1, (n, n, L)), axis=-1)
    ray_y = rng.uniform(0, Z - 1, (n, n, L))
    ray_len = np.zeros((n, n), dtype=int)
    ray_len[0, 1] = L
    ray_len[0, 2] = L // 2
    ray_len[1, 2] = L
    in_dir = tmp_path / "rays"
    io.save_rays(str(in_dir), rng.uniform(1e-5, 2e-5, (n, n)), ray_x, ray_y,
                 ray_len)
    return in_dir


def test_plot_rays_torch_renders(tmp_path):
    """plot_rays_torch.main renders one PNG per source that has rays, over
    the seeded weld's orientation map, with the rays in black ink."""
    import importlib.util

    import matplotlib.image as mpimg

    from alifmm_tpu_torch import weld_data

    spec = importlib.util.spec_from_file_location(
        "plot_rays_torch_example",
        os.path.join(REPO, "examples", "plot_rays_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    in_dir = _ray_files(tmp_path, weld_data.SHAPE)
    out = tmp_path / "png"
    out.mkdir()
    mod.main(in_dir=str(in_dir), save_to=str(out))
    assert sorted(p.name for p in out.iterdir()) == ["rays_src0.png",
                                                     "rays_src1.png"]
    for name in ("rays_src0.png", "rays_src1.png"):
        rgb = np.asarray(mpimg.imread(out / name), dtype=float)[..., :3]
        lum = rgb.mean(axis=-1)
        ink = lum < 0.95
        assert 0.05 < ink.mean() < 0.9, (name, ink.mean())
        # the orientation map in colour, the rays near black
        assert (rgb.max(-1) - rgb.min(-1) > 0.3).mean() > 0.05, name
        assert (lum < 0.1).sum() > 100, name
    # one source alone
    alone = tmp_path / "alone"
    alone.mkdir()
    mod.main(in_dir=str(in_dir), source_index=1, save_to=str(alone))
    assert [p.name for p in alone.iterdir()] == ["rays_src1.png"]
