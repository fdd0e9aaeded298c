"""One process of tests/test_torch_parallel.py's two-process test: joins a
gloo group through parallel/multihost.init and runs
parallel/shard.solve_ttf_sharded on a small seeded model, the sources
split across the group's processes.

    python tests/_torch_gloo_worker.py tcp://127.0.0.1:PORT WORLD RANK OUT.npy

writes the all-gathered (n_src, Z, X) fields to OUT.npy.  The port only:
no JAX here.
"""

import sys

import numpy as np
import torch

from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import solver as tsolver
from alifmm_tpu_torch.parallel import multihost, shard

# the parent kills a process that has not finished by then
JOIN_TIMEOUT_S = 150
SHAPE = (14, 16)
DNX = 1e-3
# three sources: padded to four, two a process
SCX = DNX * np.array([3.0, 12.0, 8.0])
SCZ = DNX * np.array([2.0, 11.0, 0.0])
STAGES = ((1, 9), (2, 3))
SEED_SIDE = 4
CFG = tsolver.SolveConfig(patch_max_passes=2, final_max_passes=3,
                          polish_passes=1)


def model():
    rng = np.random.default_rng(5)
    veln = np.round(rng.uniform(0, 180, SHAPE))
    vel_map = 3000.0 + 500.0 * np.round(rng.uniform(0, 1, SHAPE))
    return tgrid.make_model(veln, np.ones(SHAPE, dtype=int), vel_map, None,
                            None, None, DNX, dtype=torch.float64,
                            device="cpu")


def unsharded():
    return tsolver._staged_solve(model(), torch.from_numpy(SCX),
                                 torch.from_numpy(SCZ), STAGES, SEED_SIDE,
                                 -1.0, CFG)


@torch.inference_mode()
def main(addr, world, rank, out):
    torch.set_num_threads(1)
    multihost.TIMEOUT_S = 60
    assert multihost.init(addr, int(world), int(rank))
    try:
        mesh = multihost.hybrid_mesh(devices=[torch.device("cpu")])
        got = shard.solve_ttf_sharded(model(), SCX, SCZ, mesh, cfg=CFG,
                                      stages=STAGES, seed_side=SEED_SIDE)
        np.save(out, got.numpy())
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
