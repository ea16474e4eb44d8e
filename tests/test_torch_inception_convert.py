"""The port's Inception converter (`python -m
gnerf_tpu_torch.tools.convert_inception`, run with JAX unimportable) vs the
JAX package's `tools/convert_inception.py`: one random state dict under
torchvision `inception_v3_google` names (aux head and `fc` included, which
both drop) gives the same npz, member for member and byte for byte, which
`training.inception.load_inception` reads.
"""

import os
import subprocess
import sys

import numpy as np
import torch

import _torch_ingest as ingest
from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu_torch.training.inception import load_inception
from test_torch_convert import assert_npz_identical


def test_inception_tool_matches_jax_tool(tmp_path):
    pt = str(tmp_path / "inception_v3_google.pth")
    state = ingest.random_inception_state(seed=0)
    torch.save(state, pt)
    want = str(tmp_path / "jax.npz")
    proc = subprocess.run([sys.executable, os.path.join(ingest.ROOT, "tools/convert_inception.py"),
                           "--pt", pt, "--out", want], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = str(tmp_path / "port.npz")
    out = ingest.run_without_jax("gnerf_tpu_torch.tools.convert_inception", "--pt", pt,
                                 "--out", got).stdout
    assert out.replace(got, want) == proc.stdout
    assert assert_npz_identical(got, want) == 5 * 94 + 1  # conv + 4 BN tensors per layer, config
    loaded = load_inception(got, device="cpu").state_dict()
    assert len(loaded) == 5 * 94
    for k, v in loaded.items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy(), err_msg=k)
