"""One rank of the tests' four-rank gloo group (no JAX in this process).

    python tests/torch_parallel_worker.py RANK WORLD INIT_FILE INPUTS OUT \
        [PARTS]

Joins the group through ``file://INIT_FILE``, converts the pickled numpy
inputs (JAX's inits) with ``models/weights.from_jax``, runs
``tools/dryrun_multichip.run_cases`` on ``PARTS`` (comma-separated, of
"train" and "serve"; default both) and, on rank 0, writes the results to
the ``OUT`` .npz (strings as 0-d arrays).
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from interactive_vit_tpu_torch.models.weights import from_jax  # noqa: E402
from interactive_vit_tpu_torch.tools import dryrun_multichip  # noqa: E402

PARAM_KEYS = ("vit", "deit", "teacher", "mae", "moe", "tome", "swin",
              "convnext")


def main(rank: int, world: int, init_file: str, inputs: str, out: str,
         parts: str = ",".join(dryrun_multichip.PARTS)):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    with open(inputs, "rb") as f:
        raw = pickle.load(f)
    data = {k: (from_jax(v) if k in PARAM_KEYS else v)
            for k, v in raw.items()}
    res = dryrun_multichip.run_cases(data, "cpu",
                                     ckpt_dir=os.path.dirname(out),
                                     parts=tuple(parts.split(",")))
    if rank == 0:
        np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
