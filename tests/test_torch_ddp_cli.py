"""The port's training CLI under 4 gloo ranks on the CPU, as torchrun
would start it (RANK, WORLD_SIZE, MASTER_ADDR in the environment;
`init_distributed` brings the group up), with `--ray_shards 2`: a
(data=2, rays=2) mesh, each data shard feeding 2 rows of the global batch
of 4. Each objective runs 2 ticks of one step at the tiny widths of
tests/test_torch_train_cli.py; only rank 0 writes the run directory; then
every rank resumes from rank 0's full-state checkpoint and takes one step
more."""

import json
import os

import numpy as np
import pytest

import _torch_ddp_workers as W
from _torch_dist import run_ranks
from _torch_port import one_torch_thread  # noqa: F401
from _torch_state import saved_state


@pytest.mark.parametrize("objective", ["gnerf", "eg3d"])
def test_four_ranks_with_ray_shards_write_once_and_resume(tmp_path, objective,
                                                           monkeypatch):
    out = str(tmp_path / "runs")
    kw = dict(outdir=out, dataset_name="synthetic", batch=4, tick=0.004, snap=1, z_dim=32,
              w_dim=32, device="cpu", ray_shards=2, objective=objective)
    first = os.path.join(out, "00000-synthetic")
    runs = [dict(kw, kimg=0.008),
            dict(kw, kimg=0.012, resume=os.path.join(first, "training-state-latest.npz"))]
    returned = run_ranks(W.cli_case, 4, runs, timeout=420, init=False)
    second = os.path.join(out, "00001-synthetic")
    assert returned[0] == [first, second]
    assert all(r == [None, None] for r in returned[1:])
    assert sorted(os.listdir(out)) == ["00000-synthetic", "00001-synthetic"]

    names = set(os.listdir(first))
    want = {"training_options.json", "log.txt", "stats.jsonl", "network-snapshot-latest.npz",
            "network-snapshot-final.npz", "training-state-latest.npz"}
    if objective == "gnerf":
        want |= {"id_images.png", "network-snapshot-best.npz"}
    assert want <= names, sorted(want - names)
    with open(os.path.join(first, "training_options.json")) as fh:
        options = json.load(fh)
    assert (options["num_processes"], options["num_devices"], options["ray_shards"]) == (4, 4, 2)
    for run, kimgs in ((first, [0.004, 0.008]), (second, [0.012])):
        with open(os.path.join(run, "stats.jsonl")) as fh:
            stats = [json.loads(line) for line in fh]
        assert [s["kimg"] for s in stats] == kimgs
        loss = "Loss/G/total"
        assert all(np.isfinite(s[loss]["mean"]) for s in stats)

    W.shrink_networks(monkeypatch.setattr)
    assert int(saved_state(second, objective)[0]["cur_nimg"]) == 12
