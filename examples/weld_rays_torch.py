"""Weld example on the PyTorch port: 62-transducer array, 31 receiver
travel-time fields, 961 ray paths, through ``alifmm_tpu_torch.ALI_FMM``.

The counterpart of ``weld_rays.py``.  It runs on the seeded procedural
weld of ``alifmm_tpu_torch/weld_data.py`` (424 x 500, dnx = 2e-4 m) and
saves trav_times.npy, ray_paths_x.npy, ray_paths_y.npy and ray_len.npy
with the same shapes and meaning.  Run it from anywhere::

    python examples/weld_rays_torch.py [out_dir] [--device cpu]
        [--reference-knobs] [--seed N]

It needs a CUDA device (the kernels are built with nvcc at first use)
unless ``--device cpu`` is given; on the CPU the plain PyTorch twins run,
which takes hours at this size.  The default knobs are the production
budgets and march knobs; ``--reference-knobs`` runs the facade's own
defaults (one cell per step, crossing-walk scoring) instead.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from alifmm_tpu_torch import ALI_FMM, weld_data  # noqa: E402

# production budgets and march knobs of the weld workload
SOLVE_KW = dict(final_rel_tol=3e-3, final_polish_passes=2,
                patch_max_passes=8, polish_passes=4)
RAY_OPTS = dict(max_cross=8, step_scale=9, plane_dist=5, quad_vel=3,
                relax_iters=1, relax_quad=3, max_steps=115, cand_stride=7.0)


def main(out_dir=".", device=None, reference_knobs=False, seed=0):
    veln, velpn, vel_map, stif_density, sx, sy, trans_pairs, dnx = (
        weld_data.workload(seed)
    )
    fm = ALI_FMM(
        veln, velpn, vel_map, sx, sy, stif_den=stif_density, dnx=dnx,
        ray_opts=None if reference_knobs else RAY_OPTS,
        solve_opts=None if reference_knobs else SOLVE_KW,
        device=device,
    )
    t0 = time.time()
    trav_times = fm.find_all_TTF_rays_parallel(
        veln, velpn, vel_map, stif_den=stif_density, n_threads=8,
        trans_pairs=trans_pairs,
    )
    wall = time.time() - t0
    print(f"31 TTFs + 961 rays in {wall:.3f}s")

    max_len = np.max(fm.ray_len)
    np.save(os.path.join(out_dir, "trav_times.npy"), trav_times)
    np.save(
        os.path.join(out_dir, "ray_paths_x.npy"),
        fm.ray_paths_x[:, :, :max_len],
    )
    np.save(
        os.path.join(out_dir, "ray_paths_y.npy"),
        fm.ray_paths_y[:, :, :max_len],
    )
    np.save(os.path.join(out_dir, "ray_len.npy"), fm.ray_len)
    return wall


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_dir", nargs="?", default=".")
    parser.add_argument("--device", default=None)
    parser.add_argument("--reference-knobs", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    main(args.out_dir, args.device, args.reference_knobs, args.seed)
