"""Full-matrix-capture (FMC) weld example on the PyTorch port: every pair
of the 62-transducer array, through ``alifmm_tpu_torch.ALI_FMM``.

The counterpart of ``fmc_rays.py``.  It runs on the seeded procedural weld
of ``alifmm_tpu_torch/weld_data.py`` (424 x 500, dnx = 2e-4 m) with the
facade's default pairing (the upper triangle i < j): 61 receiver
travel-time fields and 1891 rays in one batch.  It prints the first call's
time (kernel builds included, unless built already) and a warm call's, on
a second instance whose sources are shifted by 1e-9 cells, and saves
fmc_trav_times.npy, fmc_ray_len.npy, fmc_ray_paths_x.npy and
fmc_ray_paths_y.npy.  Run it from anywhere::

    python examples/fmc_rays_torch.py [out_dir] [--tracer search|descent|auto]
        [--device cpu] [--seed N]

It needs a CUDA device (the kernels are built with nvcc at first use)
unless ``--device cpu`` is given; on the CPU the plain PyTorch twins run,
which takes hours at this size.  The march knobs are those of
``fmc_rays.py``; the descent tracer drops the plane search's
``quad_vel`` and ``cand_stride`` with a warning, and ``auto`` passes each
knob to the tracer that takes it.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from alifmm_tpu_torch import ALI_FMM, weld_data  # noqa: E402

# production budgets and march knobs of fmc_rays.py
SOLVE_OPTS = dict(final_rel_tol=2e-3, final_polish_passes=3, sweep_block=4)
RAY_OPTS = dict(max_cross=8, step_scale=6, quad_vel=True, relax_iters=1,
                relax_quad=3, max_steps=170, cand_stride=6.0)


def _run(workload, sx, subgrid_size, tracer, device):
    veln, velpn, vel_map, stif_density, _, sy, _, dnx = workload
    fm = ALI_FMM(
        veln, velpn, vel_map, sx, sy, stif_den=stif_density, dnx=dnx,
        ttf_mode="interp", solve_opts=SOLVE_OPTS,
        ray_opts=dict(RAY_OPTS, tracer=tracer), device=device,
    )
    t0 = time.time()
    trav_times = fm.find_all_TTF_rays_parallel(
        veln, velpn, vel_map, stif_den=stif_density, n_threads=8,
        subgrid_size=subgrid_size,
    )
    return fm, trav_times, time.time() - t0


def main(out_dir=".", tracer="search", device=None, seed=0, subgrid_size=9):
    """Run the FMC workload twice (first and warm call) and save the four
    npy files; returns the warm call's seconds."""
    workload = weld_data.workload(seed)
    sx, dnx = workload[4], workload[7]
    n = len(sx)
    n_rays = n * (n - 1) // 2
    fm, trav_times, t_first = _run(workload, sx, subgrid_size, tracer,
                                   device)
    print(f"FMC ({tracer}): {n - 1} TTFs + {n_rays} rays in {t_first:.3f}s "
          "(first call; includes the kernel builds unless built already)")
    _, _, t_warm = _run(workload, sx + 1e-9 * dnx, subgrid_size, tracer,
                        device)
    print(f"FMC ({tracer}) warm: {n - 1} TTFs + {n_rays} rays in "
          f"{t_warm:.3f}s")

    max_len = np.max(fm.ray_len)
    np.save(os.path.join(out_dir, "fmc_trav_times.npy"), trav_times)
    np.save(os.path.join(out_dir, "fmc_ray_len.npy"), fm.ray_len)
    np.save(os.path.join(out_dir, "fmc_ray_paths_x.npy"),
            fm.ray_paths_x[:, :, :max_len])
    np.save(os.path.join(out_dir, "fmc_ray_paths_y.npy"),
            fm.ray_paths_y[:, :, :max_len])
    return t_warm


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_dir", nargs="?", default=".")
    parser.add_argument("--tracer", default="search",
                        choices=("search", "descent", "auto"))
    parser.add_argument("--device", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    main(args.out_dir, args.tracer, args.device, args.seed)
