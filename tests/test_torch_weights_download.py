"""The port's ``resolve_params`` downloads a released ``.pth`` when
``Settings.offline`` is False, as the JAX package does: from a local
``ThreadingHTTPServer`` serving seeded bytes (the registry URL patched;
nothing leaves the machine), converted to the same ``.npz`` JAX writes;
a failed download logs an error and serves random init; offline opens
no socket."""

import io
import logging
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from s2sr_tpu.models import registry as jreg
from s2sr_tpu.models import weights as jweights
from s2sr_tpu_torch.models import registry as preg
from s2sr_tpu_torch.models import weights as pweights

NAME = "tiny_download_x4"
ENTRY = {"family": "rrdbnet", "scale": 4, "channels": 64, "blocks": 1,
         "growth": 32, "num_in_ch": 3}


def pth_bytes() -> bytes:
    sd = pweights.init_state_dict(num_block=1, seed=11)
    g = torch.Generator().manual_seed(12)
    sd = {k: v + 0.01 * torch.randn(v.shape, generator=g)
          for k, v in sd.items()}
    buf = io.BytesIO()
    torch.save({"params_ema": sd}, buf)
    return buf.getvalue()


class Handler(BaseHTTPRequestHandler):
    body = b""
    agents: list = []

    def do_GET(self):
        Handler.agents.append(self.headers.get("User-Agent"))
        if self.path != "/RealESRGAN_tiny.pth":
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(self.body)))
        self.end_headers()
        self.wfile.write(self.body)

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def server():
    Handler.body = pth_bytes()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


@pytest.fixture
def registered(monkeypatch, server):
    monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")

    def register(path):
        entry = dict(ENTRY, url=server + path)
        monkeypatch.setitem(preg.MODELS, NAME, entry)
        monkeypatch.setitem(jreg.MODELS, NAME, dict(entry))
    return register


def test_download_serves_jax_npz(tmp_path, registered):
    registered("/RealESRGAN_tiny.pth")
    Handler.agents.clear()
    sd, pre = pweights.resolve_params(NAME, tmp_path / "port",
                                      allow_download=True)
    assert pre and Handler.agents == ["s2sr-tpu/2.0"]
    assert not list((tmp_path / "port").glob("*.partial"))
    assert (tmp_path / "port" / f"{NAME}.pth").read_bytes() == Handler.body
    jparams, jpre = jweights.resolve_params(NAME, tmp_path / "jax",
                                            allow_download=True)
    assert jpre
    with np.load(tmp_path / "port" / f"{NAME}.npz") as got, \
            np.load(tmp_path / "jax" / f"{NAME}.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in got.files:
            np.testing.assert_array_equal(got[k], want[k])
    for k, v in pweights.params_from_jax(jparams).items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    # cached: a second resolve reads the .npz, no request
    Handler.agents.clear()
    pweights.resolve_params(NAME, tmp_path / "port", allow_download=True)
    assert Handler.agents == []


def test_download_failure_logs_and_random_init(tmp_path, registered, caplog):
    registered("/missing.pth")
    with caplog.at_level(logging.ERROR, logger="s2sr_tpu_torch.weights"):
        sd, pre = pweights.resolve_params(NAME, tmp_path, allow_download=True)
    assert not pre
    assert "weight download failed" in caplog.text and "404" in caplog.text
    want = pweights.init_state_dict(num_block=1)
    for k, v in want.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    assert not list(tmp_path.glob(f"{NAME}.*"))


def test_offline_opens_no_socket(tmp_path, registered, monkeypatch):
    """``offline=True`` (the default settings) never connects; neither
    does a SwinIR model, which never downloads."""
    from s2sr_tpu_torch import config as pconfig

    registered("/RealESRGAN_tiny.pth")

    def refuse(*args, **kwargs):
        raise AssertionError("a socket was opened")

    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(pconfig, "get_settings",
                        lambda: pconfig.Settings(offline=True))
    sd, pre = pweights.resolve_params(NAME, tmp_path)
    assert not pre and not list(tmp_path.iterdir())
    monkeypatch.setattr(pconfig, "get_settings",
                        lambda: pconfig.Settings(offline=False))
    monkeypatch.setitem(preg.MODELS, "swinir_tiny_dl", {
        "family": "swinir", "scale": 2, "embed_dim": 12, "depths": [2],
        "num_heads": [2], "window_size": 4, "url": "http://127.0.0.1:9/x"})
    _, pre = pweights.resolve_params("swinir_tiny_dl", tmp_path)
    assert not pre
