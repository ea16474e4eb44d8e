"""Shared helpers for the gnerf_tpu_torch parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages;
parameters are made with the JAX `init` and bridged into the port with
`load_jax_params`. Everything runs on the CPU in fp32.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Six xdist workers share the host: one intra-op thread each while a
    port test module runs (imported by each tests/test_torch_*.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny_gen_cfg(depth=6, **overrides):
    """The tiny G of tests/test_models.py, with the 8XDC SR module fed at
    16^2 (so the SR output is 64^2)."""
    from gnerf_tpu.models.triplane import DEFAULT_RENDERING_KWARGS

    cfg = dict(
        z_dim=32, c_dim=25, w_dim=32, img_resolution=512,
        plane_resolution=16, plane_channels=32, channel_base=512,
        channel_max=64, mapping_layers=2, neural_rendering_resolution=8,
        rendering_kwargs=dict(
            DEFAULT_RENDERING_KWARGS,
            superresolution_module="SuperresolutionHybrid8XDC",
            sr_input_resolution=16,
            depth_resolution=depth, depth_resolution_importance=depth,
        ),
    )
    cfg.update(overrides)
    return cfg


def with_noise_strength(params, value=0.5):
    """Copy of a JAX param tree with every `noise_strength` leaf set, so that
    noise_mode='const' actually adds the constant noise."""
    if isinstance(params, dict):
        return {k: (np.float32(value) if k == "noise_strength"
                    else with_noise_strength(v, value)) for k, v in params.items()}
    return params


def load_native_loader(monkeypatch):
    """Build `native/libgnerf_loader.so` as tests/test_native_loader.py does
    and load it into both packages' native_loader modules, whichever was
    imported before the library existed. Another worker may be building it
    at the same moment: a failed load builds and loads again."""
    import os
    import subprocess
    import time

    import gnerf_tpu.utils.native_loader as jnative
    import gnerf_tpu_torch.utils.native_loader as tnative

    native = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
    for attempt in range(5):
        subprocess.run(["make", "-C", native], check=False, capture_output=True)
        libs = jnative._load_lib(), tnative._load_lib()
        if all(lib is not None for lib in libs):
            break
        time.sleep(1 + attempt)
    assert all(lib is not None for lib in libs), "libgnerf_loader.so failed to build/load"
    monkeypatch.setattr(jnative, "_LIB", libs[0])
    monkeypatch.setattr(tnative, "_LIB", libs[1])


def to_np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def t(x):
    """numpy -> fp32 CPU tensor."""
    return torch.from_numpy(np.array(x, dtype=np.float32))


# Leaves drawn by `uniform`, equal bit for bit: the encoder's projection
# (and, by name, StyleGAN3's Fourier phases).
ENC_UNIFORM = ("fc/weight", "fc/bias")


def assert_init_matches(module, jax_tree, uniform=()):
    """A port module built from a key against the JAX `init` tree of the
    same key, leaf by leaf (tests/test_torch_init.py): constant and uniform
    leaves equal, normal leaves within atol 1e-6 times the leaf's standard
    deviation (its init scale) and rtol 2e-6."""
    from gnerf_tpu_torch.utils.checkpoint import flatten_tree, module_params

    want = flatten_tree(jax_tree)
    got = module_params(module)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[path]
        assert g.shape == w.shape, path
        if (w.size == 0 or path in uniform or path.endswith("phases")
                or np.all(w == w.flat[0])):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-6 * float(w.std()),
                                       err_msg=path)
