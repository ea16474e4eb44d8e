"""Serving runtime: a resident model + identity cache behind HTTP.

Port of `gnerf_tpu/infer/server.py`: one process that owns one or more
cards. A checkpoint is loaded once; each identity's prepared state (ws +
tri-planes, the expensive reusable part) stays on the device in an LRU
cache, and frames are served over a minimal stdlib HTTP API:

    POST /encode   {"image": <base64 png/jpg>[, "landmarks": 68x[x,y],
                    "align_size": 512]} | {"seed": int}
                   -> {"identity": "<id>"}           (runs E + backbone once;
                   with "landmarks", the raw photo is FFHQ-aligned first)
    POST /render   {"identity": "...", "yaw": float, "pitch": float,
                    "radius": 2.7, "fov": null}
                   -> image/png frame (512^2)
    POST /orbit    {"identity": "...", "frames": int}
                   -> video/avi (MJPEG, video_io.MJPEGWriter)
    GET  /healthz  -> {"ok": true, "identities": N}

Device work runs on two long-lived threads: the micro-batch collector
(single frames) and one device worker (encodes, orbits); the HTTP handler
threads, one per request, only wait for them. cuDNN keeps its execution
plans per thread, so device work on a fresh thread re-plans every
convolution: identity prep takes ~100 ms on a fresh thread on an H100 host,
against ~10 ms on a thread that already has them (the H100 reading in CHANGES.md).
Each worker enters `torch.inference_mode` itself (the mode is thread-local). Single-frame requests from concurrent clients are
micro-batched: the collector drains a bounded queue into one render whose
batch stacks the identities' planes ([n, 3, 32, 256, 256]) at its real size
n. The bounded queue is the backpressure valve: when it is full the HTTP
layer answers 503. An orbit renders 15 frames per chunk with the identity's
planes shared by the chunk's cameras (one tri-plane lookup and one decoder
launch per pass for all 15).

Several cards (`devices`, by default every visible card): G has one replica
per device, an identity's (ws, planes) is copied to each when it is
prepared, and an orbit chunk of 2 frames per device (the JAX server's
frame-sharded chunk) is split evenly over the replicas, each part launched
from the device worker, then all copied to the host. Encodes, single
frames and micro-batches stay on the first device, as the JAX server's
unsharded programs do.

`encode_seed` draws z from `PRNGKey(seed)` (`utils.prng`), as the JAX
server does, so a seed names the same identity in both packages. With
'auto' ray limits every replica's part of an orbit chunk takes the limits'
extremes over the whole chunk, as the JAX server's frame-sharded chunk does.

    python -m gnerf_tpu_torch.infer.server --network g.npz --port 8000 [--device cuda]
"""

from __future__ import annotations

import base64
import copy
import io
import json
import math
import queue
import threading
import time
from collections import Counter, OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..render.ray_sampler import sample_rays
from ..render.renderer import auto_ray_extremes
from ..utils import camera, prng
from ..utils.device import module_device, resolve_device
from ..utils.profiling import profiled_function, span

# Upper bound on client-requested orbit length (10 s at 30 fps).
MAX_ORBIT_FRAMES = 300


class ServiceOverloaded(RuntimeError):
    """Raised when the request queue is full — the HTTP layer maps this to
    503 so callers get immediate backpressure instead of unbounded queueing."""


class _Slot:
    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None


class MicroBatcher:
    """Batches concurrent single-item requests into one device call.

    Requests land in a bounded queue and a collector thread drains up to
    `batch_size` of them per call (waiting at most `window_ms` for
    stragglers after the first). `run_batch(items)` must return one result
    per item; errors fan out to every request in the failed batch. The
    bounded queue is the backpressure valve: `submit` raises
    ServiceOverloaded when it is full.
    """

    def __init__(self, run_batch, batch_size: int = 4, window_ms: float = 4.0,
                 max_queue: int = 64):
        self.run_batch = run_batch
        self.batch_size = batch_size
        self.window = window_ms / 1e3
        self.queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = False
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, item):
        if self._stop:
            raise ServiceOverloaded("service shut down")
        slot = _Slot()
        try:
            self.queue.put_nowait((item, slot))
        except queue.Full:
            raise ServiceOverloaded(
                f"request queue full ({self.queue.maxsize}); retry later"
            ) from None
        # Timed wait: a submit racing close() can enqueue AFTER the shutdown
        # drain swept the queue, and the collector thread can die on a
        # re-raised SystemExit/KeyboardInterrupt — in either case no one
        # will ever set this slot's event, so poll the liveness conditions
        # instead of blocking forever.
        while not slot.event.wait(timeout=0.5):
            if self._stop or not self.thread.is_alive():
                raise ServiceOverloaded("service shut down")
        if slot.error is not None:
            raise slot.error
        return slot.result

    def close(self):
        self._stop = True
        self.thread.join(timeout=2)
        # Drain anything still queued (or enqueued during shutdown) so no
        # submit() blocks forever on a slot the collector will never serve.
        while True:
            try:
                _, slot = self.queue.get_nowait()
            except queue.Empty:
                break
            slot.error = ServiceOverloaded("service shut down")
            slot.event.set()

    def _loop(self):
        while not self._stop:
            try:
                batch = [self.queue.get(timeout=0.1)]
            except queue.Empty:
                continue
            deadline = time.perf_counter() + self.window
            while len(batch) < self.batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            # BaseException too: a SystemExit/KeyboardInterrupt escaping
            # run_batch must not strand every queued waiter.
            try:
                results = self.run_batch([item for item, _ in batch])
                for (_, slot), result in zip(batch, results):
                    slot.result = result
                    slot.event.set()
            except BaseException as err:  # noqa: BLE001 — fan the error out
                wrapped = err if isinstance(err, Exception) else RuntimeError(
                    f"batch collector died: {err!r}")
                for _, slot in batch:
                    slot.error = wrapped
                    slot.event.set()
                if not isinstance(err, Exception):
                    raise


def _to_u8(image: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW -> uint8 NHWC: `(x + 1) * 127.5`, clip, truncating cast."""
    return ((image.float() + 1) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


class GNerfService:
    """Device-resident renderer with an LRU identity cache.

    G (and E, when given) must already live on `device`: CUDA unless the
    caller passes another device. `devices` lists the devices of G's
    replicas, the first G's own; by default every visible card (G's device
    alone off CUDA). A device may repeat: each entry gets a replica.
    `batch_sizes` counts the micro-batches served, by size."""

    def __init__(self, g, enc=None, max_identities: int = 16, dtype=torch.bfloat16,
                 microbatch: int = 4, microbatch_window_ms: float = 4.0,
                 max_queue: int = 64, device=None, devices=None):
        self.device = module_device(g, device if devices is None else devices[0])
        if devices is None:
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" else [self.device])
        devices = [torch.device(d) for d in devices]
        if devices[0] != self.device:
            raise ValueError(f"devices[0] is {devices[0]}, but G lives on {self.device}")
        self.devices = devices
        self.replicas = [g] + [copy.deepcopy(g).to(d).requires_grad_(False).eval()
                               for d in devices[1:]]
        self.g = g
        self.enc = enc
        self.dtype = dtype
        self.frames_per_chunk = 15 if len(devices) == 1 else 2 * len(devices)
        self.batch_sizes: Counter = Counter()
        self._identities: OrderedDict[str, tuple] = OrderedDict()
        self._copies: dict[str, list] = {}  # the replicas' (ws, planes), devices[1:]
        self._max = max_identities
        self._lock = threading.Lock()
        self._counter = 0
        # Encodes and orbits run here: a long-lived thread keeps cuDNN's plans.
        self._device_worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="gnerf-device")
        self._batcher = (
            MicroBatcher(self._run_frame_batch, batch_size=microbatch,
                         window_ms=microbatch_window_ms, max_queue=max_queue)
            if microbatch and microbatch > 1 else None
        )

    def _render(self, g, planes, ws, c, rendering_kwargs=None) -> torch.Tensor:
        """Planes [1 or N, ...], ws [N, ...], labels [N, 25] -> uint8 [N, H, W, 3]
        on the device of G's replica `g`."""
        out = g.render_planes(planes, c, ws, noise_mode="const", dtype=self.dtype,
                              rendering_kwargs=rendering_kwargs)
        return _to_u8(out["image"])

    def _chunk_extremes(self, cs: torch.Tensor) -> Optional[torch.Tensor]:
        """With 'auto' ray limits, their extremes over all the rays of an
        orbit chunk (labels [F, 25]), which every replica's part takes, as
        the JAX server's frame-sharded chunk does; else None."""
        rk = self.g.rendering_kwargs
        if not rk["ray_start"] == rk["ray_end"] == "auto":
            return None
        cs = cs.to(self.device)
        origins, dirs = sample_rays(cs[:, :16].reshape(-1, 4, 4), cs[:, 16:25].reshape(-1, 3, 3),
                                    self.g.neural_rendering_resolution)
        return auto_ray_extremes(origins, dirs, rk["box_warp"])

    @torch.inference_mode()
    def _run_frame_batch(self, items):
        """items: list of (ws [1, ...], planes [1, ...], label [1, 25]) ->
        list of [H, W, 3] uint8 frames, from one render of batch len(items)."""
        ws, planes, cs = (torch.cat(parts, dim=0) for parts in zip(*items))
        imgs = self._render(self.g, planes, ws, cs).cpu().numpy()
        with self._lock:
            self.batch_sizes[len(items)] += 1
        return list(imgs)

    def _on_device_worker(self, fn, *args):
        return self._device_worker.submit(fn, *args).result()

    def close(self):
        if self._batcher is not None:
            self._batcher.close()
        self._device_worker.shutdown(cancel_futures=True)

    # -- identities ---------------------------------------------------------

    def encode_image(self, image_chw_uint8: np.ndarray) -> str:
        """Identity from a reference image via the encoder E."""
        if self.enc is None:
            raise ValueError("service has no encoder loaded")
        return self._on_device_worker(self._encode_image, image_chw_uint8)

    @torch.inference_mode()
    @profiled_function("identity.encode")
    def _encode_image(self, image_chw_uint8: np.ndarray) -> str:
        x = torch.tensor(image_chw_uint8[None], device=self.device).float() / 127.5 - 1.0
        return self._prepare(self.enc.apply(x, train=False))

    def encode_seed(self, seed: int) -> str:
        """Identity from z = normal(PRNGKey(seed), (1, z_dim)), the JAX
        server's draw: a seed names the same identity in both packages."""
        return self._register(prng.normal(prng.PRNGKey(seed), (1, self.g.z_dim)))

    def _register(self, z) -> str:
        """Identity from a latent z [1, z_dim] (numpy or tensor)."""
        return self._on_device_worker(self._prepare, z)

    @torch.inference_mode()
    @profiled_function("identity.prepare")
    def _prepare(self, z) -> str:
        z = torch.as_tensor(z, dtype=torch.float32).to(self.device)
        c0 = camera.pose_to_label(camera.lookat_sample(math.pi / 2, math.pi / 2, radius=2.7),
                                  camera.FFHQ_INTRINSICS).to(self.device)
        ws = self.g.mapping(z, c0)
        planes = self.g.backbone_planes(ws, noise_mode="const", dtype=self.dtype)
        copies = [(ws.to(d), planes.to(d)) for d in self.devices[1:]]  # one per replica
        for d in set(self.devices):
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()
        with self._lock:
            self._counter += 1
            ident = f"id{self._counter:06d}"
            self._identities[ident] = (ws, planes)
            self._copies[ident] = copies
            while len(self._identities) > self._max:
                evicted, _ = self._identities.popitem(last=False)  # LRU eviction
                del self._copies[evicted]
        return ident

    def _get(self, identity: str):
        with self._lock:
            if identity not in self._identities:
                raise KeyError(identity)
            self._identities.move_to_end(identity)
            return self._identities[identity]

    # -- rendering ----------------------------------------------------------

    def render_frame(self, identity: str, yaw: float = math.pi / 2,
                     pitch: float = math.pi / 2, radius: float = 2.7,
                     fov: Optional[float] = None) -> np.ndarray:
        """One [H, W, 3] uint8 frame at the given orbit pose."""
        ws, planes = self._get(identity)
        intr = camera.fov_to_intrinsics(fov) if fov is not None else camera.FFHQ_INTRINSICS
        c = camera.pose_to_label(camera.lookat_sample(yaw, pitch, radius=radius),
                                 intr).to(self.device)
        if self._batcher is not None:
            return self._batcher.submit((ws, planes, c))
        return self._on_device_worker(self._run_frame_batch, [(ws, planes, c)])[0]

    def render_orbit(self, identity: str, frames: int = 30,
                     radius: float = 2.7) -> list[np.ndarray]:
        """The orbit in chunks of `frames_per_chunk` frames; each chunk shares
        the identity's planes across its cameras and is split evenly over
        the replicas."""
        first = self._get(identity)
        with self._lock:
            states = [first] + self._copies[identity]
        return self._on_device_worker(self._render_orbit, states, frames, radius)

    @torch.inference_mode()
    def _render_orbit(self, states, frames: int, radius: float) -> list[np.ndarray]:
        with span("orbit.poses"):
            labels = torch.cat([
                camera.pose_to_label(
                    camera.lookat_sample(
                        math.pi / 2 + 0.7 * math.sin(2 * math.pi * i / frames),
                        math.pi / 2 - 0.05 + 0.3 * math.cos(2 * math.pi * i / frames),
                        radius=radius),
                    camera.FFHQ_INTRINSICS)
                for i in range(frames)])
        out: list[np.ndarray] = []
        for start in range(0, frames, self.frames_per_chunk):
            cs = labels[start:start + self.frames_per_chunk]
            with span("orbit.render"):
                ext = self._chunk_extremes(cs) if len(self.replicas) > 1 else None
                # Launch every replica's part before the first copy to the host.
                parts = [self._render(g, planes, ws.expand(c.shape[0], -1, -1), c.to(d),
                                      None if ext is None else {"auto_extremes": ext.to(d)})
                         for c, d, g, (ws, planes) in zip(cs.tensor_split(len(self.replicas)),
                                                          self.devices, self.replicas, states)
                         if c.shape[0]]
            with span("orbit.to_host"):
                for imgs in parts:
                    out.extend(imgs.cpu().numpy())
        return out

    @property
    def num_identities(self) -> int:
        with self._lock:
            return len(self._identities)


def load_service(network: str, max_identities: int = 16, double_sampling: bool = True,
                 device=None, **service_kwargs) -> GNerfService:
    """A service from an npz checkpoint (the JAX package's format), on CUDA
    unless `device` names another device. `double_sampling` doubles the
    samples per ray at load, the reference's inference convention; disable
    it for ~2x renderer throughput at training-time quality."""
    from .gen_videos import load_networks

    device = resolve_device(device)
    g, enc = load_networks(network, device=device, double_sampling=double_sampling)
    return GNerfService(g, enc, max_identities=max_identities, device=device, **service_kwargs)


# ---------------------------------------------------------------------------
# HTTP layer (stdlib only)


def make_handler(service: GNerfService):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self._bytes(code, body, "application/json")

        def _bytes(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "identities": service.num_identities})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            from PIL import Image

            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/encode":
                    if "seed" in req:
                        ident = service.encode_seed(int(req["seed"]))
                    else:
                        raw = base64.b64decode(req["image"])
                        img = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
                        if "landmarks" in req:
                            # Raw photo + 68 landmarks -> the FFHQ-aligned
                            # crop E was trained on.
                            from ..utils.alignment import align_face

                            lm = np.asarray(req["landmarks"], np.float64)
                            img = align_face(img, lm, output_size=int(req.get("align_size", 512)))
                        ident = service.encode_image(img.transpose(2, 0, 1))
                    self._json(200, {"identity": ident})
                elif self.path == "/render":
                    frame = service.render_frame(
                        req["identity"],
                        yaw=float(req.get("yaw", math.pi / 2)),
                        pitch=float(req.get("pitch", math.pi / 2)),
                        radius=float(req.get("radius", 2.7)),
                        fov=req.get("fov"),
                    )
                    buf = io.BytesIO()
                    # zlib level 1: the same pixels as PIL's default level 6
                    # in ~1/4 of the time (~22 ms vs ~90 ms for a 512^2
                    # frame on an H100 host, CHANGES.md), for a
                    # slightly larger file.
                    Image.fromarray(frame).save(buf, format="PNG", compress_level=1)
                    self._bytes(200, buf.getvalue(), "image/png")
                elif self.path == "/orbit":
                    from .video_io import MJPEGWriter

                    n_frames = int(req.get("frames", 30))
                    # An unbounded frame count would tie the device (and
                    # host RAM for the buffered JPEGs) up arbitrarily long.
                    if not 1 <= n_frames <= MAX_ORBIT_FRAMES:
                        self._json(400, {"error": f"frames must be in [1, {MAX_ORBIT_FRAMES}], "
                                                  f"got {n_frames}"})
                        return
                    w = MJPEGWriter(fps=30)
                    for fr in service.render_orbit(req["identity"], frames=n_frames):
                        w.append_data(fr)
                    self._bytes(200, w.to_bytes(), "video/avi")
                else:
                    self._json(404, {"error": "not found"})
            except KeyError as err:
                self._json(404, {"error": f"unknown identity {err}"})
            except ServiceOverloaded as err:
                self._json(503, {"error": str(err)})
            except Exception as err:  # noqa: BLE001 — serving boundary
                self._json(500, {"error": str(err)})

    return Handler


def serve(service: GNerfService, port: int = 8000, host: str = "127.0.0.1"):
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    print(f"gnerf_tpu_torch serving on http://{host}:{port} "
          f"(identities cached: {service.num_identities})")
    httpd.serve_forever()


def main(argv=None):
    import click

    @click.command()
    @click.option("--network", required=True)
    @click.option("--port", type=int, default=8000)
    @click.option("--host", default="127.0.0.1")
    @click.option("--max-identities", type=int, default=16)
    @click.option("--double-sampling", type=bool, default=True,
                  help="double samples/ray at load (the reference's inference "
                       "convention); false = ~2x renderer throughput at "
                       "training-time quality")
    @click.option("--device", default=None, help="Device to run on (default: cuda)")
    def _main(network, port, host, max_identities, double_sampling, device):
        serve(load_service(network, max_identities=max_identities,
                           double_sampling=double_sampling, device=device),
              port=port, host=host)

    _main(args=argv)


if __name__ == "__main__":
    main()
