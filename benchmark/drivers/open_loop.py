"""Open loop: requests to `GNerfService` at a fixed Poisson rate.

The schedule is drawn from the seed: exactly round(rate x seconds) requests,
each kind in its share of them, render poses uniform in the orbit's range.
The gaps between arrivals are those of one Poisson process given its count,
drawn once for that count and the window's length, and every seed takes
the same gaps in another order: the seed reorders the load and does not
change it (with gaps of its own, a seed's bursts set the p95). A dispatcher sends each request when it is due to a pool of
client threads, whatever is still in flight; a request is timed from when it
was due to its frame (or identity) on the host. After the window the run
waits up to `drain_s` for what is still in flight; a request refused by the
service (`ServiceOverloaded`), failed, or not back by then is missing, and
counts in the p95 with its wait until the run stopped waiting.

Kinds: "render" (`render_frame` of a resident identity at a random pose),
"encode" (`encode_image` of the next photo; the service evicts by LRU),
"encode_render" (`encode_image`, then `render_frame` of it at the front
pose: a new user's first frame). A render picks its identity uniformly
among those the service holds; one evicted before its frame is made is
refused by the service and counts as missing. Mix parameters
(traffic/<mix>.json): rate_per_s, mix, identities, yaw, pitch, photos,
clients, check_requests, drain_s, trace_seconds.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np

from benchmark import gnerf_infer, harness, roofline, trace


def schedule(seed: int, traffic: dict, seconds: float) -> list:
    """[(due s, kind, yaw, pitch, u)] sorted by due time; u picks the identity."""
    n = max(1, round(traffic["rate_per_s"] * seconds))
    arrivals = np.sort(np.random.default_rng([n, 7]).uniform(0.0, seconds, n))
    rng = np.random.default_rng([seed, 11])
    due = np.cumsum(rng.permutation(np.diff(arrivals, prepend=0.0)))
    kinds: list = []
    for kind, share in traffic["mix"].items():
        kinds += [kind] * round(share * n)
    kinds = (kinds + [next(iter(traffic["mix"]))] * n)[:n]
    kinds = [kinds[i] for i in rng.permutation(n)]
    (y0, dy), (p0, dp) = traffic["yaw"], traffic["pitch"]
    yaw = y0 + rng.uniform(-dy, dy, n)
    pitch = p0 + rng.uniform(-dp, dp, n)
    u = rng.uniform(0.0, 1.0, n)
    return [(float(due[i]), kinds[i], float(yaw[i]), float(pitch[i]), float(u[i]))
            for i in range(n)]


class Driver:
    def __init__(self, cell, log):
        self.cell, self.log = cell, log
        self.t = cell.traffic
        self.attempted = self.failed = 0
        self.setup_parts: dict = {}
        self.counters: dict = {}
        self.flops: dict = {}
        self.kept: list = []
        self._lock = threading.Lock()
        self._next_photo = 0

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        self.s = gnerf_infer.Setup(self.cell, {})
        self.setup_parts = self.s.parts
        t = time.perf_counter()
        self.photo_of: dict = {}   # identity -> photo index
        for _ in range(int(self.t.get("identities", 0))):
            self._encode()
        self._warm()
        self.setup_parts["warmup_s"] = time.perf_counter() - t
        if self.cell.trace:
            gnerf_infer.wrap_spans(self.s.svc)
            trace.wrap(self.s.svc._batcher, "run_batch", "batch")

    def _warm(self) -> None:
        """Every micro-batch size the collector can form, on its own thread,
        and each kind of the mix, a few times."""
        svc = self.s.svc
        ident = self._encode()[0]
        target = getattr(svc._batcher, "batch_size", 1)
        for size in range(1, target + 1):
            for _ in range(3):
                barrier = threading.Barrier(size)

                def one():
                    barrier.wait()
                    svc.render_frame(ident, *gnerf_infer.front_pose())

                threads = [threading.Thread(target=one) for _ in range(size)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
        for kind in self.t["mix"]:
            for _ in range(3):
                self._request(kind, *gnerf_infer.front_pose(), 0.0, keep=False)
        svc.batch_sizes.clear()

    # -- requests -------------------------------------------------------------

    def _encode(self):
        with self._lock:
            p = self._next_photo % len(self.s.photos)
            self._next_photo += 1
        ident = self.s.svc.encode_image(self.s.photos[p])
        with self._lock:
            self.photo_of[ident] = p
        return ident, p

    def _pick(self, u: float):
        """An identity uniform over those the service holds whose encode has
        returned."""
        svc = self.s.svc
        with svc._lock:
            held = list(svc._identities)
        with self._lock:  # an identity whose encode has not returned yet is not known
            pool = [i for i in held if i in self.photo_of]
            ident = pool[min(int(u * len(pool)), len(pool) - 1)]
            return ident, self.photo_of[ident]

    def _request(self, kind, yaw, pitch, u, keep):
        svc = self.s.svc
        if kind == "render":
            ident, p = self._pick(u)
            frame = svc.render_frame(ident, yaw, pitch)
        elif kind == "encode":
            self._encode()
            return None
        elif kind == "encode_render":
            ident, p = self._encode()
            yaw, pitch = gnerf_infer.front_pose()
            frame = svc.render_frame(ident, yaw, pitch)
        else:
            raise ValueError(f"unknown request kind {kind!r}")
        return (p, yaw, pitch, frame) if keep else None

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        plan = schedule(self.cell.seed, self.t, seconds)
        frames = [i for i, r in enumerate(plan) if r[1] != "encode"]
        keep = set(gnerf_infer.sample_indices(self.cell.seed, len(frames),
                                              3 * int(self.t["check_requests"])))
        keep = {frames[i] for i in keep}
        n = len(plan)
        done = [None] * n
        sent = [0.0] * n
        results: list = [None] * n
        before = self._batches()

        def job(i, t0):
            _, kind, yaw, pitch, u = plan[i]
            try:
                results[i] = self._request(kind, yaw, pitch, u, keep=i in keep)
                done[i] = time.perf_counter() - t0
            except Exception as err:  # noqa: BLE001 - a refused or failed request is missing
                results[i] = err

        pool = ThreadPoolExecutor(max_workers=int(self.t.get("clients", 64)),
                                  thread_name_prefix="bench-client")
        t0 = time.perf_counter()
        futures = []
        for i, (due, *_rest) in enumerate(plan):
            delay = due - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            sent[i] = time.perf_counter() - t0
            futures.append(pool.submit(job, i, t0))
        wait(futures, timeout=max(0.0, seconds + float(self.t.get("drain_s", 60))
                                  - (time.perf_counter() - t0)))
        stopped = time.perf_counter() - t0
        pool.shutdown(wait=False, cancel_futures=True)
        after = self._batches()
        lat = [done[i] - plan[i][0] for i in range(n) if done[i] is not None]
        missing = [stopped - plan[i][0] for i in range(n) if done[i] is None]
        errors = sorted({type(r).__name__ for r in results if isinstance(r, Exception)})
        self.attempted, self.failed = n, len(missing)
        self.latencies = [(plan[i][0], None if done[i] is None else done[i] - plan[i][0])
                          for i in range(n)]
        self.kept = [results[i] for i in sorted(keep)
                     if done[i] is not None and results[i] is not None][:int(self.t["check_requests"])]
        batches = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        n_batches = sum(batches.values())
        self.counters = {"requests": n, "served": len(lat),
                         "encodes": sum(1 for r in plan if r[1] != "render"),
                         "batch_mean": (sum(k * v for k, v in batches.items()) / n_batches
                                        if n_batches else None)}
        late = max(s - r[0] for s, r in zip(sent, plan))
        by_kind = {}
        for kind in sorted({r[1] for r in plan}):
            ks = [done[i] - plan[i][0] for i in range(n) if plan[i][1] == kind and done[i] is not None]
            if ks:
                by_kind[kind] = [round(1e3 * harness.percentile(ks, q), 1) for q in (0.5, 0.9, 0.95, 0.99)]
        self.log(f"p50/p90/p95/p99 ms by kind {by_kind}; all p90 "
                 f"{1e3 * harness.percentile(lat + missing, 0.9):.1f} p99 "
                 f"{1e3 * harness.percentile(lat + missing, 0.99):.1f}; over 200 ms "
                 f"{sum(1 for x in lat if x > 0.2) + len(missing)}" if lat else "")
        self.log(f"window {seconds:.3f} s: {n} requests at {self.t['rate_per_s']}/s, "
                 f"{len(lat)} served, {len(missing)} missing {errors}, dispatch late by "
                 f"up to {1e3 * late:.1f} ms, p50 {1e3 * harness.percentile(lat, 0.5):.2f} ms, "
                 f"batches {dict(sorted(batches.items()))}" if lat else "no request served")
        return {"latency_p95_ms": harness.latency_p95_ms(lat, missing)}

    def _batches(self) -> dict:
        with self.s.svc._lock:
            return dict(self.s.svc.batch_sizes)

    def release(self) -> None:
        self.s.release()

    def samples(self) -> list:
        return list(self.kept)

    def check(self) -> list:
        checks = gnerf_infer.check_frames(self.cell, self.s.host, self.s.photos, self.samples(),
                                          self.log)
        if self.cell.trace:
            self.flops = gnerf_infer.flops(self.cell, self.s.host, self.s.photos[0])
        return checks

    def reading(self, tr: trace.Trace) -> dict:
        return {"trace": tr, "counters": self.counters, "flops": self.flops,
                "peak_flops": roofline.PEAK_FLOPS["bf16"]}

