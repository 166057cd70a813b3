"""Serving full-volume contrast correction over HTTP (counterpart of
``contrast_gan_3d_tpu/serving.py``).

A warm corrector (``eval/corrector.CCTAContrastCorrector`` with its
generator on the card, or a loaded artifact of ``eval/export.py``) sits
behind a small stdlib HTTP daemon:

- ``POST /correct``: the body is a ``.npy`` serialization of an int16 or
  float (W, H, D) HU volume; the reply is the ``.npy`` f32 corrected
  volume. The header ``X-Response-Dtype: int16`` rounds and clips the reply
  to int16 on the device before the fetch (``eval/utils.device_int16``),
  half the bytes.
- ``GET /healthz``: liveness and the corrector's torch device, JSON.
- ``GET /stats``: request count, latency aggregates and the shapes
  dispatched so far, JSON.

Requests reach the device one at a time through a lock, on the default
stream: one volume fills the card, and ``ThreadingHTTPServer`` overlaps the
other requests' I/O and (de)serialization with it. The payload is one
``np.save`` blob each way, so a client is a few lines of numpy and urllib
(:func:`correct_remote`).
"""

import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.eval.utils import device_int16
from contrast_gan_3d_tpu_torch.utils.device import full_f32

logger = logging.getLogger(__name__)

# largest accepted request body: a (1024, 1024, 1024) int16 volume (2 GiB)
# plus npy header slack; protects the warm daemon from a huge or forged
# Content-Length when it listens beyond the loopback
MAX_BODY_BYTES = 2 * 1024**3 + 4096


def _host(corrected) -> np.ndarray:
    """A correction's result (a tensor on any device, or an array) on the
    host."""
    return corrected.cpu().numpy() if isinstance(corrected, torch.Tensor) else np.asarray(corrected)


class CorrectionService:
    """Wraps a corrector with warmup, device serialization and stats. Its
    device work runs in full f32 (``utils/device.full_f32``), whatever
    corrector it wraps."""

    def __init__(self, corrector, warmup_shape: Optional[Tuple[int, ...]] = None):
        self.corrector = corrector
        self._device_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._n = 0
        self._total_s = 0.0
        self._max_s = 0.0
        zb = getattr(corrector, "z_bucket", 0)
        if zb:
            logger.info(
                "z_bucket=%d: z extents pad up (edge values) to the next multiple before correcting; 3D outputs "
                "differ from the unpadded blend grid (the padded extent changes the Gaussian patch grid)", zb)
        else:
            logger.warning(
                "z_bucket=0: every distinct z extent is corrected on its own grid; a mixed-z cohort shows one "
                "dispatched shape per extent (serve defaults --z-bucket 64)")
        if warmup_shape is not None:
            self.warmup(warmup_shape)

    def warmup(self, shape: Tuple[int, ...]):
        """Correct zeros of ``shape`` once so the first request does not pay
        the first call's set-up (kernel loads, cuDNN's algorithm search, the
        allocator's growth). Bypasses the request stats."""
        t0 = time.perf_counter()
        dummy = np.zeros(shape, np.int16)
        with self._device_lock, full_f32():
            _host(self.corrector(dummy))
        logger.info("Warmed up %s in %.1f s", shape, time.perf_counter() - t0)

    def correct(self, volume: np.ndarray, int16: bool = False) -> np.ndarray:
        """``int16=True`` rounds and clips on the device before the fetch:
        the conversion ``CCTAContrastCorrector.save`` applies on the host."""
        t0 = time.perf_counter()
        with self._device_lock, full_f32():
            out = self.corrector(volume)
            if int16:
                out = device_int16(torch.as_tensor(out))
            out = _host(out)
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self._n += 1
            self._total_s += dt
            self._max_s = max(self._max_s, dt)
        return out

    def stats(self) -> dict:
        with self._stats_lock:
            n = self._n
            return {
                "requests": n,
                "mean_latency_s": round(self._total_s / n, 4) if n else None,
                "max_latency_s": round(self._max_s, 4) if n else None,
                # one entry per distinct dispatched shape: growth on a warm
                # daemon means the z-bucket policy is not bounding the cohort
                "compiled_shapes": sorted(list(s) for s in self._dispatched_shapes_snapshot()),
            }

    def _dispatched_shapes_snapshot(self) -> set:
        """Copy the corrector's shape record under its lock: /correct threads
        add to the set mid-request, and iterating a live set raises."""
        shapes = getattr(self.corrector, "dispatched_shapes", None)
        if shapes is None:
            return set()
        lock = getattr(self.corrector, "_shapes_lock", None)
        if lock is None:
            return set(shapes)
        with lock:
            return set(shapes)

    def device_info(self) -> dict:
        """The corrector's torch device: ``platform`` "cuda" or "cpu", and
        the card's name on the card."""
        dev = torch.device(getattr(self.corrector, "device", "cpu"))
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
        return {"platform": dev.type, "device": name}


def _make_handler(service: CorrectionService, max_inflight: int = 4):
    # Bounds host memory, not just the size of one request: the server
    # accepts any number of connections and only device compute is
    # serialized. The slot is held through compute and the response, so
    # at most ``max_inflight`` decoded volumes are resident; requests
    # beyond the cap block before reading their body (the bytes wait in
    # the kernel's socket buffers). A client that reads its response slowly
    # holds its slot for the download, which then holds only the response.
    if max_inflight < 1:
        # BoundedSemaphore(0) would block every /correct forever; there is
        # no "unlimited" setting (the cap is the host-memory bound)
        raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
    ingest_slots = threading.BoundedSemaphore(max_inflight)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # half-open uploads must not pin handler threads forever
        timeout = 300

        def log_message(self, fmt, *args):
            logger.debug("%s " + fmt, self.client_address[0], *args)

        def _json(self, code: int, payload: dict, close: bool = False):
            if close:
                # the request body was not (fully) read: a keep-alive client
                # would have its unread bytes parsed as the next request line
                self.close_connection = True
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            if close:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if not self.server.request_began():
                return self._json(503, {"error": "server shutting down"}, close=True)
            try:
                self._do_GET()
            finally:
                self.server.request_finished()

        def _do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", **service.device_info()})
            elif self.path == "/stats":
                self._json(200, service.stats())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            # the in-flight count brackets the whole request (parse,
            # compute, response write): stop() drains on it
            if not self.server.request_began():
                return self._json(503, {"error": "server shutting down"}, close=True)
            try:
                self._do_POST()
            finally:
                self.server.request_finished()

        def _do_POST(self):
            if self.path != "/correct":
                return self._json(404, {"error": f"unknown path {self.path}"}, close=True)
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                length = 0
            if length <= 0:
                # a negative length would make rfile.read(-1) block until
                # the client's EOF
                return self._json(400, {"error": "missing/invalid Content-Length"}, close=True)
            if length > MAX_BODY_BYTES:
                return self._json(413, {"error": f"body {length} B > {MAX_BODY_BYTES} B cap"}, close=True)
            with ingest_slots:
                try:
                    volume = np.load(io.BytesIO(self.rfile.read(length)))
                except Exception as e:  # a malformed payload must not kill the server
                    logger.exception("bad /correct payload")
                    return self._json(400, {"error": str(e)}, close=True)
                responded = False
                try:
                    corrected = service.correct(volume, int16=self.headers.get("X-Response-Dtype") == "int16")
                    del volume  # the slot is held through the response
                    buf = io.BytesIO()
                    np.save(buf, corrected)
                    blob = buf.getvalue()
                    del corrected, buf
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(blob)))
                    self.end_headers()
                    responded = True
                    self.wfile.write(blob)
                except Exception as e:
                    logger.exception("correct failed")
                    if responded:
                        # the 200 status line is out: a second one would
                        # corrupt the stream, so drop the connection
                        self.close_connection = True
                        return
                    self._json(500, {"error": str(e)}, close=True)

    return Handler


class _DrainingHTTPServer(ThreadingHTTPServer):
    """Graceful drain by counting the requests in flight.

    Handler threads are daemons, and ``stop()`` waits for the number of
    requests being processed (parse, compute, response write, bracketed by
    :meth:`request_began` / :meth:`request_finished`) to reach zero: the
    responses in flight finish, idle keep-alive connections do not hold the
    drain, and requests arriving during it get 503 and close.
    """

    daemon_threads = True
    block_on_close = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._inflight = 0
        self._draining = False
        self._inflight_cv = threading.Condition()

    def request_began(self) -> bool:
        """Count a request in; False once draining (the handler answers 503)."""
        with self._inflight_cv:
            if self._draining:
                return False
            self._inflight += 1
            return True

    def request_finished(self):
        with self._inflight_cv:
            self._inflight -= 1
            self._inflight_cv.notify_all()

    def drain(self, timeout: float) -> int:
        """Refuse new requests and wait for those in flight; returns the
        number still running at the deadline (0: a clean drain)."""
        deadline = time.monotonic() + timeout
        with self._inflight_cv:
            self._draining = True
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return self._inflight
                self._inflight_cv.wait(left)
        return 0


class CorrectionServer:
    """Threaded HTTP server around a :class:`CorrectionService`."""

    def __init__(self, corrector, host: str = "127.0.0.1", port: int = 0,
                 warmup_shape: Optional[Tuple[int, ...]] = None, max_inflight: int = 4):
        if max_inflight < 1:  # fail before the warmup
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.service = CorrectionService(corrector, warmup_shape)
        self.httpd = _DrainingHTTPServer((host, port), _make_handler(self.service, max_inflight=max_inflight))
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self, background: bool = True):
        logger.info("Serving on http://%s:%d", *self.address)
        if background:
            self._thread = threading.Thread(target=self.httpd.serve_forever, name="correction-server", daemon=True)
            self._thread.start()
        else:
            self.httpd.serve_forever()

    def serve_until_signaled(self, signums=None, drain_timeout: float = 600.0):
        """Serve in the foreground until SIGTERM or SIGINT, then drain the
        requests in flight and return; a second signal escalates
        (KeyboardInterrupt) out of a drain wedged on a client. The accept
        loop runs on a background thread and the main thread waits on an
        event the signal handler sets (``shutdown()`` from a handler would
        deadlock). Main thread only (``signal.signal``)."""
        import signal as _signal

        from contrast_gan_3d_tpu_torch.utils.signals import install_graceful_stop

        signums = signums or (_signal.SIGTERM, _signal.SIGINT)
        stop_evt = threading.Event()

        def _on_stop(name):
            logger.warning("%s received — draining in-flight requests and shutting down (send again to abort the "
                           "drain)", name)
            stop_evt.set()

        previous = install_graceful_stop(_on_stop, stop_evt.is_set, signums)
        if previous is None:
            raise RuntimeError("serve_until_signaled needs the main thread (signal.signal); use "
                               "start(background=True) + stop() when embedding")
        try:
            self.start(background=True)
            # a timed wait: an untimed Event.wait can park the main thread
            # where pending signal handlers do not run
            while not stop_evt.wait(timeout=1.0):
                pass
            try:
                self.stop(drain_timeout=drain_timeout)
            except KeyboardInterrupt:
                # the second signal escalated out of a wedged drain: still
                # release the port and reap the serve thread
                self.httpd.server_close()
                if self._thread is not None:
                    self._thread.join(timeout=10)
                    self._thread = None
                raise
        finally:
            for signum, handler in previous.items():
                _signal.signal(signum, handler)

    def stop(self, drain_timeout: float = 600.0):
        self.httpd.shutdown()  # stop the accept loop
        # close the listening socket before the drain: a new connection made
        # mid-drain is then refused at once instead of waiting in the
        # backlog; requests in flight keep their own sockets
        self.httpd.server_close()
        left = self.httpd.drain(drain_timeout)
        if left:
            logger.warning("drain timed out after %.0f s with %d request(s) still in flight — their connections "
                           "will be cut", drain_timeout, left)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


def correct_remote(url: str, volume: np.ndarray, int16: bool = False, timeout: float = 600.0) -> np.ndarray:
    """Minimal client: POST a volume to a running server. ``timeout`` bounds
    the whole request."""
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, volume)
    req = urllib.request.Request(
        url.rstrip("/") + "/correct", data=buf.getvalue(),
        headers={"X-Response-Dtype": "int16"} if int16 else {}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return np.load(io.BytesIO(resp.read()))
