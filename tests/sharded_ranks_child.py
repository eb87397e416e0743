"""One rank of a gloo clients group for tests/test_torch_sharded_ranks.py.

    python tests/sharded_ranks_child.py RANK WORLD PORT OUT_DIR CASES

Runs the port's ``ShardedFLRun`` on the CPU for each case named in CASES
(comma-separated keys of ``CASES`` in the test file) over a process group
of WORLD gloo ranks at ``tcp://127.0.0.1:PORT``, from the initial params
in ``OUT_DIR/init.npz``, with the JAX key-path backend (the numbers
``jax.random`` draws), and saves what the test compares to
``OUT_DIR/<world>_<rank>_<case>.pt``: the global params, the history, the
cohorts, the host population rows and the error rows.
"""
import os
import sys

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")

import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_keys import jax_keys  # noqa: E402
from test_torch_sharded_ranks import CASES, make_port_run  # noqa: E402

import torch.distributed as dist  # noqa: E402
from repro_torch.launch.mesh import init_process_group  # noqa: E402
from repro_torch.models.module import tree_map  # noqa: E402


def main():
    rank, world, port = (int(x) for x in sys.argv[1:4])
    out, cases = sys.argv[4], sys.argv[5].split(",")
    init_process_group("cpu", f"tcp://127.0.0.1:{port}", rank, world)
    init = dict(np.load(os.path.join(out, "init.npz")))
    for case in cases:
        with jax_keys():
            run = make_port_run(case, init)
            run.run_sync(CASES[case][2])
        err = run._err_store._rows if run.compression != "none" else {}
        torch.save({"params": run.global_params, "history": run.history,
                    "cohorts": run.cohort_log,
                    "pop": tree_map(torch.from_numpy, run._pop_state),
                    "err": err, "shards": run._group.shards,
                    "kpad": run._kpad},
                   os.path.join(out, f"{world}_{rank}_{case}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
