"""The port's serving runtime (gnerf_tpu_torch/infer/server.py), mirroring
tests/test_server.py: identity cache, micro-batching, backpressure and the
HTTP API on a loopback socket with a tiny model; and its frames and orbits
vs the JAX GNerfService within +-1 per uint8 pixel, for the same z through
`_register` (fp32, CPU, JAX parameters bridged)."""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread, with_noise_strength  # noqa: F401
from gnerf_tpu.infer import server as jserver
from gnerf_tpu.models import ResNeXt50Encoder as JEncoder
from gnerf_tpu.models import TriPlaneGenerator as JGen
from gnerf_tpu.models.triplane import DEFAULT_RENDERING_KWARGS
from gnerf_tpu.utils import checkpoint as jckpt
from gnerf_tpu_torch.infer.server import (GNerfService, MicroBatcher, ServiceOverloaded,
                                          load_service, make_handler)
from gnerf_tpu_torch.models import ResNeXt50Encoder, TriPlaneGenerator
from gnerf_tpu_torch.utils import camera
from gnerf_tpu_torch.utils.checkpoint import load_jax_params

CFG = dict(z_dim=16, w_dim=16, img_resolution=128, plane_resolution=16, channel_base=256,
           channel_max=32, mapping_layers=2, neural_rendering_resolution=16,
           rendering_kwargs=dict(DEFAULT_RENDERING_KWARGS,
                                 superresolution_module="SuperresolutionHybrid2X",
                                 depth_resolution=4, depth_resolution_importance=4))
ENC_LAYERS = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def nets():
    """(JAX G, its params, JAX E, its params and state, port G, port E)."""
    jg = JGen(**CFG)
    params_g = with_noise_strength(jg.init(jax.random.PRNGKey(0)))
    jenc = JEncoder(out_dim=16, layers=ENC_LAYERS, groups_as_dense=False)
    params_e, state_e = jenc.init(jax.random.PRNGKey(1))
    g = load_jax_params(TriPlaneGenerator(**CFG, device="meta"), params_g, device="cpu")
    enc = load_jax_params(ResNeXt50Encoder(out_dim=16, layers=ENC_LAYERS, device="meta"),
                          params_e, state_e, device="cpu")
    for net in (g, enc):
        net.requires_grad_(False).eval()
    return jg, params_g, jenc, params_e, state_e, g, enc


@pytest.fixture
def service(nets):
    svc = GNerfService(nets[5], nets[6], max_identities=2, dtype=torch.float32, device="cpu")
    yield svc
    svc.close()


def test_service_encode_render_and_lru(service):
    s = service
    a = s.encode_seed(0)
    frame = s.render_frame(a, yaw=np.pi / 2 + 0.3)
    assert frame.shape == (32, 32, 3) and frame.dtype == np.uint8

    img = np.random.RandomState(0).randint(0, 255, (3, 32, 32), np.uint8)
    b = s.encode_image(img)
    assert s.num_identities == 2
    assert not np.array_equal(s.render_frame(a), s.render_frame(b))

    # LRU: a third identity evicts the least-recently-used one.
    s.render_frame(a)  # touch a
    c = s.encode_seed(7)
    assert s.num_identities == 2
    fa = s.render_frame(a)
    s.render_frame(c)
    with pytest.raises(KeyError):
        s.render_frame(b)
    orbit = s.render_orbit(a, frames=3)
    assert len(orbit) == 3 and orbit[0].shape == (32, 32, 3)
    assert s.render_frame(a, fov=18.837).shape == (32, 32, 3)
    # A seed names the same identity every time.
    np.testing.assert_array_equal(s.render_frame(s.encode_seed(0)), fa)


def _label(yaw, pitch):
    return camera.pose_to_label(camera.lookat_sample(yaw, pitch, radius=2.7),
                                camera.FFHQ_INTRINSICS)


def test_microbatch_matches_direct(service):
    """A micro-batch stacks different identities' planes into one render;
    each frame equals its identity's un-batched render (fp32 on the CPU:
    bit for bit). Concurrent callers get the same frames."""
    s = service
    ids = [s.encode_seed(100), s.encode_seed(101)]
    poses = [(np.pi / 2 + 0.2, np.pi / 2), (np.pi / 2 - 0.3, np.pi / 2 + 0.1)]
    items = [(*s._get(i), _label(*p)) for i, p in zip(ids, poses)]
    want = [s._run_frame_batch([it])[0] for it in items]
    got = s._run_frame_batch(items)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_, w)

    got = [None, None]
    errs = []

    def worker(k):
        try:
            got[k] = s.render_frame(ids[k], yaw=poses[k][0], pitch=poses[k][1])
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    assert not errs
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_, w)
    assert s.batch_sizes[2] >= 1


def test_microbatcher_backpressure_and_error_fanout():
    release = threading.Event()

    def slow_batch(items):
        release.wait(timeout=5)
        if items[0] == "boom":
            raise ValueError("boom")
        return [x * 2 for x in items]

    mb = MicroBatcher(slow_batch, batch_size=1, window_ms=0.0, max_queue=1)
    try:
        results = []
        t1 = threading.Thread(target=lambda: results.append(mb.submit(1)))
        t1.start()
        time.sleep(0.2)  # worker now blocked in slow_batch
        t2 = threading.Thread(target=lambda: results.append(mb.submit(2)))
        t2.start()
        time.sleep(0.2)  # queue holds item 2
        with pytest.raises(ServiceOverloaded):
            mb.submit(3)
        release.set()
        t1.join(timeout=5)
        t2.join(timeout=5)
        assert sorted(results) == [2, 4]
        with pytest.raises(ValueError, match="boom"):
            mb.submit("boom")
    finally:
        release.set()
        mb.close()


def test_microbatcher_close_drains_queued_requests():
    release = threading.Event()

    def slow_batch(items):
        release.wait(timeout=5)
        return list(items)

    mb = MicroBatcher(slow_batch, batch_size=1, window_ms=0.0, max_queue=4)
    outcomes = []

    def submit_and_record(x):
        try:
            outcomes.append(("ok", mb.submit(x)))
        except ServiceOverloaded as e:
            outcomes.append(("overloaded", str(e)))

    t1 = threading.Thread(target=submit_and_record, args=(1,))
    t1.start()
    time.sleep(0.2)
    t2 = threading.Thread(target=submit_and_record, args=(2,))
    t2.start()
    time.sleep(0.2)
    mb._stop = True   # stop the collector before it can dequeue item 2
    release.set()
    mb.close()
    t1.join(timeout=5)
    t2.join(timeout=5)
    assert not t1.is_alive() and not t2.is_alive()
    assert sorted(k for k, _ in outcomes) == ["ok", "overloaded"]


def test_microbatcher_submit_after_close_and_dead_collector():
    mb = MicroBatcher(lambda items: list(items), batch_size=1, window_ms=0.0)
    assert mb.submit(7) == 7
    mb.close()
    with pytest.raises(ServiceOverloaded):
        mb.submit(8)

    mb2 = MicroBatcher(lambda items: list(items), batch_size=1, window_ms=0.0)
    mb2._stop = True
    mb2.thread.join(timeout=5)
    assert not mb2.thread.is_alive()
    mb2._stop = False
    with pytest.raises(ServiceOverloaded):
        mb2.submit(9)


def test_http_api_end_to_end(service):
    from http.server import ThreadingHTTPServer

    from PIL import Image

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=120)

    def status(path, payload):
        try:
            post(path, payload)
        except urllib.error.HTTPError as err:
            return err.code
        return 200

    def png(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["ok"] is True
        with post("/encode", {"seed": 3}) as r:
            ident = json.loads(r.read())["identity"]
        arr = np.random.RandomState(1).randint(0, 255, (32, 32, 3), np.uint8)
        with post("/encode", {"image": png(arr)}) as r:
            ident2 = json.loads(r.read())["identity"]
        assert ident2 != ident

        with post("/render", {"identity": ident, "yaw": 1.8}) as r:
            assert r.headers["Content-Type"] == "image/png"
            frame = np.asarray(Image.open(io.BytesIO(r.read())))
        assert frame.shape == (32, 32, 3)
        np.testing.assert_array_equal(frame, service.render_frame(ident, yaw=1.8))

        with post("/orbit", {"identity": ident, "frames": 2}) as r:
            avi = r.read()
        assert avi[:4] == b"RIFF" and b"MJPG" in avi
        assert status("/orbit", {"identity": ident, "frames": 100000}) == 400
        assert status("/render", {"identity": "nope"}) == 404
        assert status("/nothing", {}) == 404

        # Raw photo + landmarks: FFHQ-aligned before E. Last: with
        # max_identities=2 this evicts `ident`.
        big = np.random.RandomState(2).randint(0, 255, (128, 128, 3), np.uint8)
        lm = np.zeros((68, 2))
        lm[36:42] = [52, 56]
        lm[42:48] = [76, 56]
        lm[48], lm[54] = [56, 80], [72, 80]
        with post("/encode", {"image": png(big), "landmarks": lm.tolist(),
                              "align_size": 32}) as r:
            ident3 = json.loads(r.read())["identity"]
        assert ident3 not in (ident, ident2)
    finally:
        httpd.shutdown()
        httpd.server_close()


def _jax_service(nets, **kw):
    jg, params_g, jenc, params_e, state_e, *_ = nets
    return jserver.GNerfService(jg, params_g, jenc, params_e, state_e, dtype=jnp.float32, **kw)


@pytest.mark.parametrize("path", ["frame", "orbit"])
def test_frames_match_jax_service(nets, path):
    """The same z through `_register` on both sides: single frames (direct
    and micro-batched) and a 17-frame orbit (a 15-frame chunk sharing one
    identity's planes, then a tail) within +-1 per uint8 pixel."""
    z = np.random.RandomState(5).randn(2, 16).astype(np.float32)
    jsvc = _jax_service(nets, max_identities=4)
    svc = GNerfService(nets[5], nets[6], max_identities=4, dtype=torch.float32, device="cpu")
    try:
        jids = [jsvc._register(jnp.asarray(z[i:i + 1])) for i in range(2)]
        ids = [svc._register(torch.from_numpy(z[i:i + 1])) for i in range(2)]
        if path == "frame":
            poses = [(np.pi / 2 + 0.25, np.pi / 2 - 0.1), (np.pi / 2 - 0.3, np.pi / 2 + 0.1)]
            want = [jsvc.render_frame(j, yaw=y, pitch=p) for j, (y, p) in zip(jids, poses)]
            got = [svc.render_frame(i, yaw=y, pitch=p) for i, (y, p) in zip(ids, poses)]
            got_batched = svc._run_frame_batch(
                [(*svc._get(i), _label(y, p)) for i, (y, p) in zip(ids, poses)])
            want.append(jsvc.render_frame(jids[0], fov=14.0))
            got.append(svc.render_frame(ids[0], fov=14.0))
            pairs = list(zip(got + got_batched, want + want[:2]))
        else:
            want = jsvc.render_orbit(jids[1], frames=17)
            got = svc.render_orbit(ids[1], frames=17)
            assert len(got) == len(want) == 17
            pairs = list(zip(got, want))
        for g_, w in pairs:
            assert g_.shape == w.shape == (32, 32, 3) and g_.dtype == np.uint8
            assert np.abs(g_.astype(int) - w.astype(int)).max() <= 1
            assert g_.std() > 0
        img = np.random.RandomState(6).randint(0, 255, (3, 32, 32), np.uint8)
        np.testing.assert_allclose(  # ws of an encoded photo
            svc._identities[svc.encode_image(img)][0].numpy(),
            np.asarray(jsvc._identities[jsvc.encode_image(img)][0]), rtol=1e-4, atol=1e-4)
    finally:
        svc.close()
        jsvc.close()


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_encode_seed_matches_jax_service(nets, seed):
    """A seed names the same identity in both packages: z from PRNGKey(seed)
    within 1e-6, then ws and planes within this file's tolerance."""
    from gnerf_tpu_torch.utils import prng

    np.testing.assert_allclose(
        prng.normal(prng.PRNGKey(seed), (1, 16)).numpy(),
        np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 16))), rtol=0, atol=1e-6)
    jsvc = _jax_service(nets, microbatch=0)
    svc = GNerfService(nets[5], nets[6], dtype=torch.float32, device="cpu", microbatch=0)
    try:
        jws = jsvc._identities[jsvc.encode_seed(seed)][0]
        want = (jws, nets[0].backbone_planes(nets[1], jws, noise_mode="const"))
        got = svc._identities[svc.encode_seed(seed)]
        for g_, w in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    finally:
        svc.close()
        jsvc.close()


def test_orbit_auto_ray_limits_over_two_replicas(nets):
    """With 'auto' ray limits (ShapeNet's box, a far camera whose corner
    rays miss it), each replica's part of a chunk takes the limits'
    extremes over the whole chunk: the orbit over two replicas equals one
    device's and is within +-1 of the JAX server's."""
    jg, params_g, *_ = nets
    rk = dict(CFG["rendering_kwargs"], ray_start="auto", ray_end="auto", box_warp=1.6,
              avg_camera_radius=1.7, avg_camera_pivot=(0, 0, 0), white_back=True)
    jsvc = jserver.GNerfService(JGen(**dict(CFG, rendering_kwargs=rk)), params_g,
                                dtype=jnp.float32, microbatch=0)
    g = TriPlaneGenerator(**dict(CFG, rendering_kwargs=rk), device="meta")
    load_jax_params(g, params_g, device="cpu").requires_grad_(False).eval()
    z = np.random.RandomState(8).randn(1, 16).astype(np.float32)
    try:
        want = np.stack(jsvc.render_orbit(jsvc._register(jnp.asarray(z)), frames=2, radius=16.0))
        orbits = []
        for devices in (["cpu"], ["cpu", "cpu"]):
            svc = GNerfService(g, None, dtype=torch.float32, devices=devices, microbatch=0)
            try:
                orbits.append(np.stack(svc.render_orbit(svc._register(torch.from_numpy(z)),
                                                        frames=2, radius=16.0)))
            finally:
                svc.close()
    finally:
        jsvc.close()
    assert orbits[0].shape == want.shape == (2, 32, 32, 3) and orbits[0].std() > 0
    np.testing.assert_array_equal(orbits[1], orbits[0])
    assert np.abs(orbits[1].astype(int) - want.astype(int)).max() <= 1


def test_load_service_from_jax_checkpoint(nets, tmp_path):
    jg, params_g, *_ = nets
    path = str(tmp_path / "net.npz")
    config = {"generator": dict(CFG, rendering_kwargs={
        k: (list(v) if isinstance(v, tuple) else v) for k, v in jg.rendering_kwargs.items()})}
    jckpt.save_checkpoint(path, {"G_ema": params_g}, config=config)
    svc = load_service(path, device="cpu", dtype=torch.float32)
    svc_fast = load_service(path, double_sampling=False, device="cpu")
    jsvc = jserver.load_service(path)
    try:
        # Samples per ray doubled at load unless double_sampling=False.
        assert svc.g.rendering_kwargs == dict(jsvc.g.rendering_kwargs)
        assert svc.g.rendering_kwargs["depth_resolution"] == 8
        assert svc_fast.g.rendering_kwargs["depth_resolution"] == 4
        assert svc.enc is None
        with pytest.raises(ValueError, match="encoder"):
            svc.encode_image(np.zeros((3, 32, 32), np.uint8))
        assert svc.render_frame(svc.encode_seed(0)).shape == (32, 32, 3)
    finally:
        for s in (svc, svc_fast, jsvc):
            s.close()
