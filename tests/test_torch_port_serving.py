"""The port's serving daemon (``contrast_gan_3d_tpu_torch/serving.py``, the
``serve`` command) and its corrector's ``z_bucket`` on the CPU, against the
JAX package: the ``tests/test_serving.py`` generator (1 resnet block, 1
up/down, 2 channels, 16^3 patches), weights carried by ``utils/weights.py``,
volumes from a numpy seed.

Tolerances: a corrected volume within 0.1 HU of JAX's (the port's
correction tests' bound); an int16 reply within 1 HU (one rounding step of
values that already agree to 0.1 HU). Status codes and JSON keys equal.
Every HTTP call has a timeout; every server is stopped in a fixture or a
``finally``.
"""

import copy
import http.client
import io
import json
import signal
import socket
import threading
import time
from functools import partial

import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.eval.corrector import CCTAContrastCorrector as JaxCorrector
from contrast_gan_3d_tpu.serving import CorrectionServer as JaxServer
from contrast_gan_3d_tpu_torch import serve
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.serving import MAX_BODY_BYTES, CorrectionServer, correct_remote
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer
from tests.test_torch_port_models import carried_generator

SERVE_GEN = dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=2)
PATCH = (16, 16, 16)
SHAPE = (20, 20, 18)
Z_BUCKET = 8
HU_TOL = 0.1
TIMEOUT = 60


def _vol(seed, shape=SHAPE):
    return np.random.default_rng(seed).integers(-1024, 1500, shape).astype(np.int16)


@pytest.fixture(scope="module")
def carried():
    return carried_generator(SERVE_GEN, 21)


@pytest.fixture(scope="module")
def carried_2d():
    return carried_generator(SERVE_GEN, 22, shape=(1, 16, 16, 1), ndim=2)


def _pair(carried, **kw):
    """(JAX corrector, port corrector) with the same weights and arguments."""
    jgen, variables, tgen = carried
    kw = dict(dict(inference_patch_size=PATCH, batch_size=2), **kw)
    return (JaxCorrector(jgen, variables["params"], variables["batch_stats"], **kw),
            CCTAContrastCorrector(tgen, device="cpu", **kw))


@pytest.fixture(scope="module")
def bucketed(carried):
    return _pair(carried, z_bucket=Z_BUCKET)


@pytest.mark.parametrize("family", ["packed", "direct", "2d"])
def test_z_bucket_matches_jax(carried, carried_2d, bucketed, family):
    """``z_bucket=8`` edge-pads z 18 -> 24 (2D: 6 -> 8), corrects and crops:
    within 0.1 HU of JAX's bucketed corrector. In 3D the padded grid is
    another function (more than 0.1 HU from the port's ``z_bucket=0``); in
    2D the result is the unbucketed one."""
    if family == "packed":
        jcorr, corr = bucketed
    elif family == "direct":
        jcorr, corr = _pair(carried, z_bucket=Z_BUCKET, layout="direct")
    else:
        jcorr, corr = _pair(carried_2d, z_bucket=Z_BUCKET, inference_patch_size=(16, 16), batch_size=4)
    assert corr.packed == (family == "packed")
    vol = _vol(1, (16, 16, 6) if family == "2d" else SHAPE)
    got = corr(vol).numpy()
    assert got.shape == vol.shape
    assert np.abs(got - np.asarray(jcorr(vol))).max() <= HU_TOL
    exact = CCTAContrastCorrector(corr.generator, device="cpu", inference_patch_size=corr.inference_patch_size,
                                  batch_size=corr.batch_size, layout="packed" if corr.packed else "direct")
    if family == "2d":
        np.testing.assert_array_equal(got, exact(vol).numpy())
    else:
        assert np.abs(got - exact(vol).numpy()).max() > HU_TOL


def test_dispatched_shapes_match_jax(bucketed):
    """Over a mixed-z cohort the post-bucketing shapes recorded equal JAX's
    exactly (one per bucket), and a volume on a bucket boundary is not
    padded."""
    jcorr, corr = bucketed
    for z in (18, 9, 16, 24, 20):
        vol = _vol(z, (20, 20, z))
        corr(vol)
        jcorr(vol)
    assert corr.dispatched_shapes == jcorr.dispatched_shapes == {(20, 20, 16), (20, 20, 24)}


# --- the daemon against JAX's ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers(bucketed):
    """(JAX server, port server) around the bucketed correctors."""
    jcorr, corr = bucketed
    pair = (JaxServer(jcorr, warmup_shape=SHAPE), CorrectionServer(corr, warmup_shape=SHAPE))
    for srv in pair:
        srv.start()
    yield pair
    for srv in pair:
        srv.stop(drain_timeout=TIMEOUT)


def _npy(array) -> bytes:
    buf = io.BytesIO()
    np.save(buf, array)
    return buf.getvalue()


def _reply(address, method, path, body=None, headers=None):
    """(status, the server closes the connection, JSON dict or array)."""
    conn = http.client.HTTPConnection(*address, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        payload = json.loads(data) if resp.getheader("Content-Type") == "application/json" else \
            np.load(io.BytesIO(data))
        return resp.status, resp.will_close, payload
    finally:
        conn.close()


def _keepalive_after_404(address):
    """A keep-alive POST of a full body to a mistyped path, then a request
    on the same client: the 404 closes the link and the client reconnects."""
    conn = http.client.HTTPConnection(*address, timeout=TIMEOUT)
    try:
        conn.request("POST", "/corect", body=_npy(_vol(3)))
        resp = conn.getresponse()
        first = (resp.status, resp.will_close, json.loads(resp.read()))
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        return first, (resp.status, sorted(json.loads(resp.read())))
    finally:
        conn.close()


CASES = {
    "f32": ("POST", "/correct", _npy(_vol(4)), {}),
    "int16": ("POST", "/correct", _npy(_vol(5)), {"X-Response-Dtype": "int16"}),
    "float_body": ("POST", "/correct", _npy(_vol(6).astype(np.float32)), {}),
    "bad_npy_400": ("POST", "/correct", b"not-an-npy", {}),
    "no_length_400": ("POST", "/correct", None, {"Content-Length": "0"}),
    "too_large_413": ("POST", "/correct", None, {"Content-Length": str(MAX_BODY_BYTES + 1)}),
    "get_404": ("GET", "/nope", None, {}),
    "healthz": ("GET", "/healthz", None, {}),
    "stats": ("GET", "/stats", None, {}),
}


@pytest.mark.parametrize("case", [*CASES, "keepalive_after_404", "drain_503"])
def test_daemon_matches_jax(servers, bucketed, case):
    """The same request to JAX's daemon and the port's: the same status, the
    same connection handling and JSON keys; corrected volumes within 0.1 HU
    (int16 replies 1 HU)."""
    jsrv, psrv = servers
    if case == "keepalive_after_404":
        want, got = _keepalive_after_404(jsrv.address), _keepalive_after_404(psrv.address)
        assert got == want and got[0][:2] == (404, True) and got[1][0] == 200
        return
    if case == "drain_503":
        # a draining daemon of each kind answers 503 and closes
        jcorr, corr = bucketed
        fresh = (JaxServer(jcorr), CorrectionServer(corr))
        replies = []
        for srv in fresh:
            srv.start()
            try:
                assert srv.httpd.drain(0.1) == 0
                replies.append(_reply(srv.address, "GET", "/healthz"))
            finally:
                srv.stop(drain_timeout=TIMEOUT)
        (js, jc, jp), (ps, pc, pp) = replies
        assert (ps, pc, sorted(pp)) == (js, jc, sorted(jp)) == (503, True, ["error"])
        return
    want, got = (_reply(srv.address, *CASES[case]) for srv in servers)
    assert got[:2] == want[:2]
    if isinstance(want[2], dict):
        assert sorted(got[2]) == sorted(want[2])
        if case == "healthz":
            assert got[2]["platform"] == "cpu" and got[2]["status"] == "ok"
        if case == "stats":
            assert got[2]["compiled_shapes"] == want[2]["compiled_shapes"]
            assert got[2]["requests"] == want[2]["requests"] > 0
        return
    assert got[0] == 200 and got[2].shape == want[2].shape == SHAPE and got[2].dtype == want[2].dtype
    tol = 1 if case == "int16" else HU_TOL
    assert np.abs(got[2].astype(np.float32) - want[2].astype(np.float32)).max() <= tol


# --- the port's daemon: lifecycle (as tests/test_serving.py) ------------------------------------------------------


class Identity:
    """A corrector stand-in: f32 of the volume, after an optional gate."""

    def __init__(self, gate=None, sleep=0.0):
        self.gate, self.sleep = gate, sleep

    def __call__(self, volume):
        if self.gate is not None:
            self.gate.wait(timeout=30)
        time.sleep(self.sleep)
        return torch.as_tensor(np.asarray(volume, np.float32))


def _url(srv):
    host, port = srv.address
    return f"http://{host}:{port}"


def test_requests_beyond_inflight_cap_queue_not_fail(bucketed):
    """Three concurrent requests against ``max_inflight=1``: they queue
    before reading their bodies and all succeed, each equal to the
    in-process correction."""
    _, corr = bucketed
    srv = CorrectionServer(corr, max_inflight=1)
    srv.start()
    try:
        vols = [_vol(10 + i) for i in range(3)]
        results = [None] * 3

        def worker(i):
            results[i] = correct_remote(_url(srv), vols[i], timeout=TIMEOUT)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        for v, r in zip(vols, results):
            np.testing.assert_array_equal(r, corr(v).numpy())
    finally:
        srv.stop(drain_timeout=TIMEOUT)


def test_stop_releases_port():
    srv = CorrectionServer(Identity())
    srv.start()
    host, port = srv.address
    srv.stop()
    srv2 = CorrectionServer(Identity(), host=host, port=port)  # the same port again
    srv2.start()
    try:
        assert srv2.address[1] == port
    finally:
        srv2.stop()


def test_stop_drains_inflight_requests():
    """A request mid-compute when ``stop()`` is called still gets its whole
    reply."""
    srv = CorrectionServer(Identity(sleep=1.5))
    srv.start()
    vol = _vol(7, (8, 8, 6))
    result = {}
    t = threading.Thread(target=lambda: result.update(out=correct_remote(_url(srv), vol, timeout=TIMEOUT)))
    t.start()
    time.sleep(0.4)
    srv.stop(drain_timeout=TIMEOUT)
    t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    np.testing.assert_array_equal(result["out"], vol.astype(np.float32))


def test_serve_until_signaled_returns_on_sigterm():
    """SIGTERM drains and returns, restores the previous handler and
    releases the port."""
    srv = CorrectionServer(Identity())
    before = signal.getsignal(signal.SIGTERM)
    timer = threading.Timer(1.0, lambda: signal.raise_signal(signal.SIGTERM))
    timer.start()
    try:
        srv.serve_until_signaled(drain_timeout=TIMEOUT)
    finally:
        timer.cancel()
    assert signal.getsignal(signal.SIGTERM) is before
    srv2 = CorrectionServer(Identity(), *srv.address)
    srv2.start()
    srv2.stop()


def test_idle_keepalive_connection_does_not_block_stop():
    srv = CorrectionServer(Identity())
    srv.start()
    sock = socket.create_connection(srv.address, timeout=10)
    try:
        sock.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        buf = b""
        while b"}" not in buf:
            buf += sock.recv(4096)
        assert b"200" in buf and b'"platform": "cpu"' in buf
        t0 = time.perf_counter()
        srv.stop(drain_timeout=TIMEOUT)
        assert time.perf_counter() - t0 < 30, "stop() waited on an idle connection"
    finally:
        sock.close()


def test_new_connections_refused_fast_mid_drain():
    """While ``stop()`` drains a request in flight, a new TCP connection is
    refused at once; the drain ends when the request does."""
    release = threading.Event()
    srv = CorrectionServer(Identity(gate=release))
    srv.start()
    host, port = srv.address
    client = threading.Thread(target=lambda: correct_remote(_url(srv), np.zeros((4, 4, 4), np.int16),
                                                            timeout=TIMEOUT))
    client.start()
    deadline = time.monotonic() + 10
    while srv.httpd._inflight == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert srv.httpd._inflight == 1
    stopper = threading.Thread(target=partial(srv.stop, drain_timeout=TIMEOUT))
    stopper.start()
    try:
        deadline = time.monotonic() + 10
        while not srv.httpd._draining and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.httpd._draining
        t0 = time.monotonic()
        with pytest.raises(OSError):
            socket.create_connection((host, port), timeout=5.0).close()
        assert time.monotonic() - t0 < 2.0
        assert stopper.is_alive()
    finally:
        release.set()
        stopper.join(timeout=TIMEOUT)
        client.join(timeout=TIMEOUT)
    assert not stopper.is_alive() and not client.is_alive()


def test_max_inflight_zero_is_rejected():
    with pytest.raises(ValueError, match="max_inflight"):
        CorrectionServer(Identity(), max_inflight=0)


# --- the serve command --------------------------------------------------------------------------------------------


def test_serve_cli_round_trip(carried, tmp_path):
    """``serve <run dir>`` with the JAX command's arguments: a warm daemon
    whose replies equal its corrector's; ``--device`` defaults to the card
    (and raises without one); ``--dp-devices`` (a usage error until the
    sharded corrector was ported) shards the patch grid, with JAX's usage
    errors: not with ``--artifact``, not 2D, at least 1."""
    _, _, tgen = carried
    tx = partial(make_optimizer, "adam", lr=1e-3)
    trainer = Trainer(copy.deepcopy(tgen), PatchGANDiscriminator(init_channels_out=2, discriminator_depth=1), tx, tx, device="cpu")
    ckpt_lib.save_checkpoint(trainer.state, tmp_path, meta=trainer._ckpt_meta)
    argv = [str(tmp_path), "--patch", "16", "16", "16", "--batch", "2", "--port", "0", "--host", "127.0.0.1",
            "--dtype", "float32", "--z-bucket", str(Z_BUCKET), "--warmup-shape", *map(str, SHAPE)]
    assert serve.parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.build_server(serve.parse_args(argv))
    for bad in (["--dp-devices", "0"], ["--dp-devices", "2", "--artifact"],
                ["--dp-devices", "2", "--patch", "16", "16"]):
        with pytest.raises(SystemExit):
            serve.parse_args(argv + bad)
    sharded = serve.build_server(serve.parse_args(argv + ["--device", "cpu", "--dp-devices", "2"]))
    assert sharded.service.corrector.devices == [torch.device("cpu")] * 2
    srv = serve.build_server(serve.parse_args(argv + ["--device", "cpu"]))
    srv.start()
    try:
        corr = srv.service.corrector
        assert corr.z_bucket == Z_BUCKET and corr.packed and corr.batch_size == 2
        vol = _vol(8)
        np.testing.assert_array_equal(correct_remote(_url(srv), vol, timeout=TIMEOUT), corr(vol).numpy())
        assert srv.service.stats()["compiled_shapes"] == [[20, 20, 24]]
        np.testing.assert_allclose(sharded.service.corrector(vol).numpy(), corr(vol).numpy(), rtol=1e-4, atol=5e-2)
    finally:
        srv.stop(drain_timeout=TIMEOUT)
