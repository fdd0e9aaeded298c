"""Plot saved ray paths over the weld orientation map, on the PyTorch
port's files: one figure per source showing its rays over ``veln % 90``,
with the isotropic parent metal masked out.

The counterpart of ``plot_rays.py``.  The weld maps are the seeded
procedural weld of ``alifmm_tpu_torch/weld_data.py`` and the rays are the
files that ``examples/weld_rays_torch.py`` saves (``utils/io.save_rays``'s
layout), read with ``utils/io.load_rays``.  It needs matplotlib and no
GPU::

    python examples/weld_rays_torch.py out_dir
    python examples/plot_rays_torch.py out_dir [source_index]
        [--save-to png_dir] [--seed N]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from alifmm_tpu_torch import weld_data  # noqa: E402
from alifmm_tpu_torch.utils import io  # noqa: E402


def main(in_dir=".", source_index=None, save_to=None, seed=0):
    import matplotlib

    if save_to:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    veln, velpn, _, _ = weld_data.weld_model_arrays(seed)
    _, ray_x, ray_y, ray_len = io.load_rays(in_dir)

    plot_veln = np.where(velpn == 1, np.nan, veln % 90)

    sources = (
        [source_index]
        if source_index is not None
        else range(ray_len.shape[0])
    )
    for i in sources:
        if ray_len[i].max() == 0:
            continue
        plt.figure(figsize=(8, 7))
        plt.imshow(
            plot_veln, vmin=0, vmax=90, cmap="hsv", interpolation="nearest"
        )
        plt.gca().invert_yaxis()
        for j in range(ray_len.shape[1]):
            n = ray_len[i, j]
            if n > 0:
                plt.plot(ray_x[i, j, :n], ray_y[i, j, :n], "k", lw=0.7)
        plt.title(f"rays from source {i}")
        if save_to:
            plt.savefig(os.path.join(save_to, f"rays_src{i}.png"), dpi=120)
            plt.close()
        else:
            plt.show()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("in_dir", nargs="?", default=".")
    parser.add_argument("source_index", nargs="?", type=int, default=None)
    parser.add_argument("--save-to", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    main(args.in_dir, args.source_index, args.save_to, args.seed)
