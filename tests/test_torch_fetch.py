"""The port's scene acquisition (``geo/cog.py``, ``fetch/client.py``,
``fetch/smart_fetch.py``, ``fetch/multiband.py``, ``utils/retry.py``),
the ESRGAN tile pipeline and the five CLIs, against the JAX package on
the CPU.

Every endpoint is a local ``ThreadingHTTPServer`` on 127.0.0.1 serving
canned STAC, COG (with ``Range``) and UP42 replies made from seeded
numpy; nothing reaches the network. The JAX package is pointed at the
same server (its ``requests`` over the local socket) and is the oracle:

- COG windows byte-equal (local files and over the socket, with the
  same range requests), the ignored-``Range`` reply sliced;
- the AOI clip (a 1024² or 256² bilinear warp from EPSG:32636 to
  EPSG:4326) byte-equal to JAX's run eagerly (``jax.disable_jit``), to
  which the port's warps are bit-equal, and within
  ``test_torch_tiles.assert_bytes_close`` of JAX's jitted warp (XLA's fma
  contraction moved 0.04% of the 256² clip's bytes by 1 when measured);
- the fetch ladder's choice and metadata equal over the same replies;
- multiband's SCL exactly equal (nearest), red and NIR equal too (JAX
  eager);
- UP42's requests, retries, polls and result equal, with a fake clock;
- the ESRGAN tiles within ``test_torch_tiles.assert_bytes_close`` of
  JAX's (lanczos against jitted JAX).
"""

import json
import re
import threading
import types
import urllib.parse
from datetime import datetime, timedelta, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest

import s2sr_tpu.fetch.client as jclient
import s2sr_tpu.fetch.multiband as jmultiband
import s2sr_tpu.fetch.smart_fetch as jsmart
import s2sr_tpu.utils.retry as jretry
from s2sr_tpu.config import Settings as JaxSettings
from s2sr_tpu.geo import Affine as JaxAffine
from s2sr_tpu.geo import CRS as JaxCRS
from s2sr_tpu.geo import GeoTiff as JaxGeoTiff
from s2sr_tpu.geo import cog as jcog
from s2sr_tpu.geo import read_geotiff as jax_read_geotiff
from s2sr_tpu.geo import write_geotiff as jax_write_geotiff
import s2sr_tpu_torch.fetch.client as client
import s2sr_tpu_torch.fetch.multiband as multiband
import s2sr_tpu_torch.fetch.smart_fetch as smart
import s2sr_tpu_torch.utils.retry as retry
from s2sr_tpu_torch.config import Settings
from s2sr_tpu_torch.geo import CRS, Affine, GeoTiff, cog, read_geotiff
from s2sr_tpu_torch.geo.crs import lonlat_to_utm
from s2sr_tpu_torch.tiles.png import decode_png

from test_torch_tiles import assert_bytes_close

AOI_BOUNDS = (35.01, 32.01, 35.03, 32.03)        # ~1.9 × 2.2 km
W, S, E, N = AOI_BOUNDS
AOI = {"type": "Polygon", "coordinates": [[[W, S], [E, S], [E, N], [W, N],
                                           [W, S]]]}


# --- a local server --------------------------------------------------------

class Handler(BaseHTTPRequestHandler):
    """Answers from ``server.routes``: path → ``fn(handler, body)`` giving
    (status, headers, bytes); logs (method, path, query, body) to
    ``server.log``."""

    def log_message(self, *a):
        pass

    def _serve(self, method):
        url = urllib.parse.urlsplit(self.path)
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        self.server.log.append((method, url.path, url.query, body,
                                self.headers.get("Authorization")))
        fn = self.server.routes.get(url.path)
        status, headers, out = fn(self, body) if fn else (404, {}, b"{}")
        self.send_response(status)
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def do_GET(self):
        self._serve("GET")

    def do_POST(self):
        self._serve("POST")


@pytest.fixture(scope="module")
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    srv.routes, srv.log = {}, []
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    srv.base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(10)


@pytest.fixture
def srv(server, monkeypatch):
    monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")
    server.routes, server.log = {}, []
    return server


def blob_route(blob: bytes, honour_range: bool = True):
    def fn(handler, _body):
        rng = handler.headers.get("Range")
        if rng and honour_range:
            a, b = rng.split("=")[1].split("-")
            start, end = int(a), min(int(b), len(blob) - 1)
            return 206, {"Content-Range": f"bytes {start}-{end}/{len(blob)}"}, \
                blob[start:end + 1]
        return 200, {}, blob
    return fn


def json_route(obj, status: int = 200):
    return lambda h, b: (status, {"Content-Type": "application/json"},
                         json.dumps(obj).encode())


def fail_once(fn, status: int = 500):
    calls = []

    def wrapped(h, b):
        calls.append(1)
        return (status, {}, b"{}") if len(calls) == 1 else fn(h, b)
    return wrapped


def jax_affine(tr) -> JaxAffine:
    return JaxAffine(tr.a, tr.b, tr.c, tr.d, tr.e, tr.f)


def tiff_bytes(data: np.ndarray, transform, epsg: int, **kw) -> bytes:
    """``data`` as the JAX package's GeoTIFF writer writes it."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "a.tif"
        jax_write_geotiff(JaxGeoTiff(data, transform=jax_affine(transform),
                                     crs=JaxCRS(epsg)), p, **kw)
        return p.read_bytes()


def tiled_tiff_bytes(data: np.ndarray, tile: int, compress: bool) -> bytes:
    """A minimal tiled, chunky TIFF of ``data`` (the COG layout): edge
    tiles padded to ``tile``², deflate or uncompressed, no georeference."""
    import struct
    import zlib

    h, w, spp = data.shape
    bits = data.dtype.itemsize * 8
    chunks = []
    for ty in range(0, h, tile):
        for tx in range(0, w, tile):
            block = np.zeros((tile, tile, spp), data.dtype)
            part = data[ty:ty + tile, tx:tx + tile]
            block[:part.shape[0], :part.shape[1]] = part
            raw = block.astype(block.dtype.newbyteorder("<")).tobytes()
            chunks.append(zlib.compress(raw) if compress else raw)
    n = len(chunks)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [8 if compress else 1]), 262: (3, [2 if spp >= 3 else 1]),
            277: (3, [spp]), 284: (3, [1]), 322: (3, [tile]), 323: (3, [tile]),
            324: (4, [0] * n), 325: (4, [len(c) for c in chunks]),
            339: (3, [1] * spp)}
    ifd_at = 8
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    extra, entries = bytearray(), []
    data_at = extra_at + sum(len(v) * (2 if t == 3 else 4)
                             for t, v in tags.values()
                             if len(v) * (2 if t == 3 else 4) > 4)
    offsets, pos = [], data_at
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    tags[324] = (4, offsets)
    for tag, (typ, vals) in sorted(tags.items()):
        payload = struct.pack("<" + ("H" if typ == 3 else "I") * len(vals), *vals)
        if len(payload) > 4:
            entries.append(struct.pack("<HHII", tag, typ, len(vals),
                                       extra_at + len(extra)))
            extra += payload
        else:
            entries.append(struct.pack("<HHI", tag, typ, len(vals))
                           + payload.ljust(4, b"\0"))
    return (b"II*\x00" + struct.pack("<I", ifd_at)
            + struct.pack("<H", len(entries)) + b"".join(entries)
            + b"\0\0\0\0" + bytes(extra) + b"".join(chunks))


def utm_grid(side: int, res: float = 10.0):
    """An EPSG:32636 transform of a ``side``² grid at ``res`` m centred
    on the AOI."""
    cx, cy = lonlat_to_utm(np.array([(W + E) / 2]), np.array([(S + N) / 2]),
                           36, True)
    x0 = float(np.floor(cx[0] / res) * res - side // 2 * res)
    y0 = float(np.floor(cy[0] / res) * res + side // 2 * res)
    return Affine(res, 0.0, x0, 0.0, -res, y0)


def visual_pixels(rng, side: int) -> np.ndarray:
    """An RGB scene: 8-px parcels of random colour with ±4 of texture."""
    base = rng.integers(0, 256, (side // 8, side // 8, 3))
    visual = np.repeat(np.repeat(base, 8, 0), 8, 1)
    return (visual + rng.integers(0, 9, visual.shape) - 4).clip(0, 255
                                                               ).astype(np.uint8)


def scene_assets(seed: int, side: int = 512):
    """Canned COGs: the visual RGB uint8 asset and the red, green, blue,
    nir (uint16) and scl (class codes) bands on one 10 m UTM grid."""
    rng = np.random.default_rng(seed)
    tr = utm_grid(side)
    visual = visual_pixels(rng, side)
    bands = {"visual": tiff_bytes(visual, tr, 32636)}
    for k, key in enumerate(("red", "green", "blue", "nir")):
        band = (visual[:, :, k % 3].astype(np.uint16) * 12
                + rng.integers(0, 40, (side, side))).astype(np.uint16)
        bands[key] = tiff_bytes(band[:, :, None], tr, 32636)
    scl = np.array([4, 5, 8, 9, 3], np.uint16)[
        np.repeat(np.repeat(rng.integers(0, 5, (side // 16, side // 16)),
                            16, 0), 16, 1)]
    bands["scl"] = tiff_bytes(scl[:, :, None], tr, 32636)
    return bands


def stac_feature(base: str, scene_id: str, cloud: float, age_days: float,
                 assets=("visual", "red", "green", "blue", "nir", "scl")):
    acq = datetime.now(timezone.utc) - timedelta(days=age_days)
    return {"id": scene_id, "type": "Feature",
            "properties": {"datetime": acq.strftime("%Y-%m-%dT%H:%M:%SZ"),
                           "eo:cloud_cover": cloud},
            "assets": {k: {"href": f"{base}/{scene_id}/{k}.tif"}
                       for k in assets}}


def serve_scene(srv, scene_id: str, seed: int, missing=()):
    for key, blob in scene_assets(seed).items():
        if key not in missing:
            srv.routes[f"/{scene_id}/{key}.tif"] = blob_route(blob)


# --- the COG reader --------------------------------------------------------

LAYOUTS = {
    "strips_deflate_u16": (np.uint16, 3, dict(rows_per_strip=16)),
    "strips_raw_u8": (np.uint8, 1, dict(rows_per_strip=8, compress="none")),
    "one_strip_u8": (np.uint8, 3, dict(predictor=False)),
    "tiles_deflate_u8": (np.uint8, 3, dict(tile=64, compress=True)),
    "tiles_raw_u16": (np.uint16, 1, dict(tile=48, compress=False)),
}
WINDOWS = [(37, 95, 50, 60), (0, 0, 200, 300), (-10, 280, 30, 40),
           (190, -5, 20, 20), (-20, -20, 10, 10), (250, 350, 4, 4)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cog_reader_windows_match_jax(tmp_path, layout):
    """Windows inside, across and outside the raster (zero-filled), on
    strips and on tiles (a COG's layout): byte-equal to JAX's
    ``CogReader``, with the same shifted transform."""
    dtype, bands, kw = LAYOUTS[layout]
    data = np.random.default_rng(1).integers(
        0, np.iinfo(dtype).max, (200, 300, bands)).astype(dtype)
    p = tmp_path / "cog.tif"
    if "tile" in kw:
        p.write_bytes(tiled_tiff_bytes(data, **kw))
    else:
        p.write_bytes(tiff_bytes(
            data, Affine.from_origin(35.0, 32.0, 1e-3, 1e-3), 4326, **kw))
    r, jr = cog.CogReader(p), jcog.CogReader(p)
    try:
        for win in WINDOWS:
            got, want = r.read_window(*win), jr.read_window(*win)
            assert got.dtype == want.dtype and np.array_equal(got, want), win
            g, w = r.window_geotiff(*win), jr.window_geotiff(*win)
            assert tuple(g.transform) == tuple(w.transform)
        assert np.array_equal(r.read_window(37, 95, 50, 60),
                              data[37:87, 95:155])
    finally:
        r.close()
        jr.close()


def test_http_range_reads_match_jax(srv):
    """Over the socket: the same windows, the same range requests (one
    256 KiB block at a time), far fewer bytes than the file."""
    data = np.random.default_rng(2).integers(0, 255, (1024, 1024, 3)
                                             ).astype(np.uint8)
    blob = tiff_bytes(data, Affine.from_origin(35.0, 32.0, 1e-4, 1e-4), 4326,
                      rows_per_strip=16, compress="none")
    srv.routes["/served.tif"] = blob_route(blob)
    url = srv.base + "/served.tif"
    logs = []
    for mod in (cog, jcog):
        srv.log = []
        f = mod.HttpRangeFile(url, block_size=64 * 1024)
        r = mod.CogReader(f)
        win = r.read_window(500, 300, 64, 96)
        assert np.array_equal(win, data[500:564, 300:396])
        logs.append(([e[:3] for e in srv.log], f.requests_made))
        if mod is cog:
            assert f.bytes_fetched == f.requests_made * 64 * 1024
            assert f.bytes_fetched < len(blob) // 8
    assert logs[0] == logs[1] and logs[0][1] == len(logs[0][0])


def test_http_range_file_server_ignores_range(srv):
    """A 200 full-body reply is sliced to the requested span, not cached
    as a block at the wrong offset."""
    body = bytes(range(256)) * 40
    srv.routes["/test.tif"] = blob_route(body, honour_range=False)
    for mod in (cog, jcog):
        f = mod.HttpRangeFile(srv.base + "/test.tif", block_size=1024)
        f.seek(4096)
        assert f.read(512) == body[4096:4608]
        assert f.size() == len(body)


def test_cog_reader_closes_fd_on_bad_file(tmp_path):
    bad = tmp_path / "not_a.tif"
    bad.write_bytes(b"PNG\x00" + b"x" * 64)
    fd_dir = Path("/proc/self/fd")
    before = len(list(fd_dir.iterdir()))
    for _ in range(5):
        with pytest.raises(ValueError):
            cog.CogReader(bad)
    assert len(list(fd_dir.iterdir())) <= before + 1


def test_http_errors_raise(srv):
    """A 404 raises from ``urlopen`` as ``raise_for_status`` raises."""
    import urllib.error

    with pytest.raises(urllib.error.HTTPError):
        cog.CogReader(srv.base + "/missing.tif")


# --- the AOI clip ----------------------------------------------------------

def test_clip_to_aoi_matches_jax():
    """A 512² EPSG:32636 scene clipped to 256² in EPSG:4326: the control
    grid (UTM → 4326) equal, the clip bytes equal to JAX's eager warp and
    within ``assert_bytes_close`` of its jitted one (measured: 7.6e-5 of
    the bytes off by 1 on this scene; on uniform noise, the worst case
    for a .5 tie, 6.2e-4 — the reference's own jit-vs-eager spread)."""
    from s2sr_tpu.geo.warp import control_grid as jax_control_grid
    from s2sr_tpu_torch.geo.warp import control_grid

    data = visual_pixels(np.random.default_rng(3), 512)
    tr = utm_grid(512)
    r = GeoTiff(data, transform=tr, crs=CRS(32636))
    jr = JaxGeoTiff(data, transform=jax_affine(tr),
                    crs=JaxCRS(32636))
    dst = Affine.from_bounds(W, S, E, N, 256, 256)
    ctrl = control_grid(dst, CRS(4326), tr, CRS(32636), 256, 256)
    jctrl = jax_control_grid(jax_affine(dst), JaxCRS(4326),
                             jr.transform, JaxCRS(32636), 256, 256)
    assert np.array_equal(ctrl, jctrl)
    got = client.PublicSentinel2Client(Settings(), device="cpu")._clip_to_aoi(
        r, AOI, out_size=256)
    jax_client = jclient.PublicSentinel2Client(JaxSettings())
    with jax.disable_jit():
        want = jax_client._clip_to_aoi(jr, AOI, out_size=256)
    assert got.data.dtype == np.uint8 and got.data.shape == (256, 256, 3)
    assert got.data.any(-1).all()                # inside the raster
    assert np.array_equal(got.data, want.data)
    assert_bytes_close(got.data, jax_client._clip_to_aoi(jr, AOI,
                                                         out_size=256).data)
    assert tuple(got.transform) == tuple(want.transform)
    assert got.crs.epsg == want.crs.epsg == 4326


# --- the fetch ladder ------------------------------------------------------

LADDER = {
    # name: (local (id, cloud, age) or None, remote (id, cloud, age) or
    #        "down" / "empty", missing assets, force)
    "no_local_fetches": (None, ("S2_A", 5.0, 1), (), False),
    "better_cloud_fetches": (("L_1", 20.0, 1), ("S2_A", 10.0, 1), (), False),
    "close_cloud_keeps_local": (("L_1", 12.0, 1), ("S2_A", 10.0, 1), (), False),
    "newer_fetches": (("L_1", 10.0, 10), ("S2_A", 10.0, 1), (), False),
    "same_scene_keeps_local": (("S2_A", 20.0, 2), ("S2_A", 18.0, 1), (),
                               False),
    "force_fetches": (("L_1", 5.0, 0), ("S2_A", 20.0, 1), (), True),
    "rgb_merge": (None, ("S2_A", 5.0, 1), ("visual",), False),
    "fetch_fails_local": (("L_1", 20.0, 1), ("S2_A", 10.0, 1),
                          ("visual", "red"), False),
    "fetch_fails_synthetic": (None, ("S2_A", 10.0, 1), ("visual", "blue"),
                              False),
    "catalog_down_synthetic": (None, "down", (), False),
    "catalog_empty_local": (("L_1", 25.0, 1), "empty", (), False),
}


def local_scene(d: Path, scene_id: str, cloud: float, age: float,
                now: datetime) -> None:
    from s2sr_tpu.fetch.synthetic import synthetic_scene
    from s2sr_tpu.utils import write_json

    d.mkdir(parents=True, exist_ok=True)
    synthetic_scene(path=d / f"{scene_id}.tif", size=(32, 32))
    acq = now - timedelta(days=age)
    write_json({"scene_id": scene_id, "acquisition_date": acq.isoformat() + "Z",
                "cloud_cover_pct": cloud, "source": "aws_earth_search"},
               d / f"{scene_id}.json")


@pytest.mark.parametrize("case", list(LADDER))
def test_smart_fetch_ladder_matches_jax(srv, tmp_path, monkeypatch, case):
    """The same canned catalog and assets through JAX's (eager) and the
    port's ``smart_fetch``: the same rung (fetched, local, synthetic),
    the same metadata, the same requests, and a fetched clip byte-equal."""
    local, remote, missing, force = LADDER[case]
    if remote == "down":
        srv.routes["/search"] = json_route({"detail": "down"}, 500)
    elif remote == "empty":
        srv.routes["/search"] = json_route({"features": []})
    else:
        feat = stac_feature(srv.base, *remote)
        srv.routes["/search"] = json_route({"features": [feat]})
        serve_scene(srv, remote[0], seed=4, missing=missing)
    monkeypatch.setattr(jsmart, "STAC_URL", srv.base + "/search")
    monkeypatch.setattr(smart, "STAC_URL", srv.base + "/search")
    monkeypatch.setattr(jsmart, "get_settings",
                        lambda: JaxSettings(offline=False))
    results = {}
    now = datetime.now(timezone.utc).replace(tzinfo=None)

    def jax_run(d):
        with jax.disable_jit():
            return jsmart.smart_fetch(AOI, d, force_fetch=force)

    for name, run in (
            ("jax", jax_run),
            ("torch", lambda d: smart.smart_fetch(
                AOI, d, force_fetch=force, settings=Settings(offline=False),
                device="cpu"))):
        d = tmp_path / name
        if local is not None:
            local_scene(d, *local, now)
        srv.log = []
        path, meta = run(d)
        results[name] = (Path(path), meta, [e[:3] for e in srv.log])
    (jpath, jmeta, jlog), (path, meta, log) = results["jax"], results["torch"]
    assert log == jlog
    assert sorted(meta) == sorted(jmeta)
    skip = {"file_path", "scene_id", "acquisition_date"}
    assert {k: v for k, v in meta.items() if k not in skip} == \
        {k: v for k, v in jmeta.items() if k not in skip}
    if meta.get("source") == "synthetic_fallback":
        assert path.name.startswith("synthetic_") and jpath.name.startswith(
            "synthetic_")
        return
    assert meta["scene_id"] == jmeta["scene_id"]
    assert meta["acquisition_date"] == jmeta["acquisition_date"]
    if meta.get("source") == "aws_earth_search" and local is None or \
            path.name.endswith("_sentinel2.tif"):
        assert path.name.endswith("_sentinel2.tif") and \
            jpath.name.endswith("_sentinel2.tif")
        got, want = read_geotiff(path), jax_read_geotiff(jpath)
        assert got.data.shape == (1024, 1024, 3) and got.data.all(-1).mean() > 0.99
        assert np.array_equal(got.data, want.data)
        assert tuple(got.transform) == tuple(want.transform)
        assert json.loads(path.with_suffix(".json").read_text())[
            "scene_id"] == remote[0]
    else:
        assert path.name == jpath.name


def test_check_remote_catalog_matches_jax(srv, monkeypatch):
    """The payload JAX posts and the scene it returns, null datetime
    included; offline skips the request."""
    feats = [stac_feature(srv.base, "S2_B", 3.5, 2),
             stac_feature(srv.base, "S2_C", 9.0, 1)]
    feats[0]["properties"]["datetime"] = None
    srv.routes["/search"] = json_route({"features": feats})
    monkeypatch.setattr(jsmart, "STAC_URL", srv.base + "/search")
    monkeypatch.setattr(smart, "STAC_URL", srv.base + "/search")
    monkeypatch.setattr(jsmart, "get_settings",
                        lambda: JaxSettings(offline=False))
    want = jsmart.check_remote_catalog(AOI, 20, 15.0)
    got = smart.check_remote_catalog(AOI, 20, 15.0,
                                     settings=Settings(offline=False))
    bodies = [json.loads(e[3]) for e in srv.log]
    assert len(bodies) == 2 and bodies[0] == bodies[1]
    assert bodies[0]["limit"] == 10 and bodies[0]["intersects"] == AOI
    assert got["scene_id"] == want["scene_id"] == "S2_B"
    assert got["feature"] == want["feature"]
    assert got["cloud_cover"] == want["cloud_cover"]
    assert abs(got["acquisition_date"] - want["acquisition_date"]) < \
        timedelta(seconds=5)
    assert smart.check_remote_catalog(AOI, settings=Settings()) is None
    assert len(srv.log) == 2


def test_fetch_best_scene_band_merge_and_search(srv, tmp_path, monkeypatch):
    """Without a chosen scene the client searches (JAX's payload, limit
    10); the RGB merge ×255/3000 equals JAX's; a scene missing a band
    raises, never substituting data."""
    feat = stac_feature(srv.base, "S2_M", 2.0, 1)
    srv.routes["/search"] = json_route({"features": [feat]})
    serve_scene(srv, "S2_M", seed=6, missing=("visual",))
    monkeypatch.setattr(jclient, "EARTH_SEARCH", srv.base + "/search")
    monkeypatch.setattr(client, "EARTH_SEARCH", srv.base + "/search")
    with jax.disable_jit():
        jp, jm = jclient.PublicSentinel2Client(JaxSettings(offline=False)
                                               ).fetch_best_scene(AOI,
                                                                  tmp_path / "j")
    p, m = client.PublicSentinel2Client(Settings(offline=False), device="cpu"
                                        ).fetch_best_scene(AOI, tmp_path / "t")
    assert np.array_equal(read_geotiff(p).data, jax_read_geotiff(jp).data)
    assert {k: v for k, v in m.items() if k != "file_path"} == \
        {k: v for k, v in jm.items() if k != "file_path"}
    del srv.routes["/S2_M/green.tif"]
    with pytest.raises(Exception):
        client.PublicSentinel2Client(Settings(offline=False), device="cpu"
                                     ).fetch_best_scene(AOI, tmp_path / "x")
    assert not list((tmp_path / "x").glob("*.tif"))


# --- multiband -------------------------------------------------------------

def test_multiband_matches_jax(srv, tmp_path, monkeypatch):
    """B04/B08/SCL warped onto one 4326 grid: SCL (nearest) exactly JAX's
    and only its class codes; red and NIR (bilinear) equal."""
    feat = stac_feature(srv.base, "S2_MB", 6.0, 1)
    srv.routes["/search"] = json_route({"features": [feat]})
    serve_scene(srv, "S2_MB", seed=8)
    monkeypatch.setattr(jmultiband, "EARTH_SEARCH", srv.base + "/search")
    monkeypatch.setattr(multiband, "EARTH_SEARCH", srv.base + "/search")
    monkeypatch.setattr(jmultiband, "get_settings",
                        lambda: JaxSettings(offline=False))
    with jax.disable_jit():
        jp, jm = jmultiband.fetch_and_stack_multiband(
            AOI, tmp_path / "j", jmultiband.FetchConfig(out_size=160))
    jlog = [e[:3] for e in srv.log]
    srv.log = []
    p, m = multiband.fetch_and_stack_multiband(
        AOI, tmp_path / "t", multiband.FetchConfig(out_size=160),
        settings=Settings(offline=False), device="cpu")
    assert [e[:3] for e in srv.log] == jlog
    got, want = read_geotiff(p).data, jax_read_geotiff(jp).data
    assert got.dtype == np.uint16 and got.shape == (160, 160, 3)
    assert np.array_equal(got[..., 2], want[..., 2])
    assert set(np.unique(got[..., 2])) <= {4, 5, 8, 9, 3}
    assert np.array_equal(got[..., :2], want[..., :2])
    assert {k: v for k, v in m.items() if k != "file_path"} == \
        {k: v for k, v in jm.items() if k != "file_path"}
    # offline: the synthetic fixture, as JAX writes it
    monkeypatch.setattr(jmultiband, "get_settings", lambda: JaxSettings())
    jp, jm = jmultiband.fetch_and_stack_multiband(
        AOI, tmp_path / "jo", jmultiband.FetchConfig(out_size=64))
    p, m = multiband.fetch_and_stack_multiband(
        AOI, tmp_path / "to", multiband.FetchConfig(out_size=64),
        settings=Settings(), device="cpu")
    assert np.array_equal(read_geotiff(p).data, jax_read_geotiff(jp).data)
    assert m["source"] == jm["source"] == "synthetic_fallback"


# --- UP42 ------------------------------------------------------------------

def up42_scenes(srv) -> list:
    """The catalog's two scenes, stamped once: both clients must be
    served the same bytes, and ``stac_feature`` stamps ``datetime.now``
    to the second."""
    return [stac_feature(srv.base, "UP_A", 12.0, 1),
            stac_feature(srv.base, "UP_B", 3.0, 2)]


def up42_routes(srv, reuse: bool, scenes: list):
    polls = []

    def order_status(h, b):
        polls.append(1)
        status = "RUNNING" if len(polls) == 1 else "FULFILLED"
        return json_route({"id": "ord-9", "status": status, "assets": [
            {"url": srv.base + "/asset.tif"}]})(h, b)

    orders = [{"id": "ord-0", "params": {"id": "UP_X"}}]
    if reuse:
        orders.append({"id": "ord-9", "params": {"id": "UP_B"}})
    srv.routes.update({
        "/auth": json_route({"access_token": "tok-1", "expires_in": 3600}),
        "/catalog": fail_once(json_route({"features": scenes})),
        "/api/orders": lambda h, b: (
            json_route({"id": "ord-9"}) if b else
            json_route({"content": orders}))(h, b),
        "/api/orders/ord-9": order_status,
        "/asset.tif": blob_route(b"GEOTIFF" * 100),
    })


def fake_clock(monkeypatch, modules) -> list:
    import time as _time

    sleeps: list = []
    clock = types.SimpleNamespace(time=_time.time, sleep=sleeps.append)
    for mod in modules:
        monkeypatch.setattr(mod, "time", clock)
    return sleeps


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "create"])
def test_up42_fetch_best_scene_matches_jax(srv, tmp_path, monkeypatch, reuse):
    """OAuth2 password flow → catalog (failing once: one retry) → an
    existing order or a new one → a poll that finds it RUNNING, then
    FULFILLED → the download: the same requests, bodies, sleeps and
    result as JAX's client."""
    urls = dict(up42_auth_url=srv.base + "/auth",
                up42_api_base=srv.base + "/api",
                up42_catalog_url=srv.base + "/catalog",
                up42_username="user", up42_password="pw", offline=False)
    runs = {}
    scenes = up42_scenes(srv)
    for name, mods, make in (
            ("jax", (jclient, jretry), lambda: jclient.UP42Client(
                JaxSettings(**urls))),
            ("torch", (client, retry), lambda: client.UP42Client(
                Settings(**urls)))):
        up42_routes(srv, reuse, scenes)
        srv.log = []
        sleeps = fake_clock(monkeypatch, mods)
        path, meta = make().fetch_best_scene(AOI, tmp_path / name)
        runs[name] = (Path(path), meta, list(srv.log), sleeps)
    (jpath, jmeta, jlog, jsleeps), (path, meta, log, sleeps) = \
        runs["jax"], runs["torch"]
    assert sleeps == jsleeps == [1.0, 30]
    assert path.read_bytes() == jpath.read_bytes() == b"GEOTIFF" * 100
    assert {k: v for k, v in meta.items() if k != "file_path"} == \
        {k: v for k, v in jmeta.items() if k != "file_path"}
    assert meta["scene_id"] == "UP_B" and meta["order_id"] == "ord-9"

    def parsed(entries):
        out = []
        for method, p, query, body, auth in entries:
            if body[:1] == b"{":
                body = json.loads(body)
                body.pop("datetime", None)
            else:
                body = urllib.parse.parse_qs(body.decode())
            out.append((method, p, urllib.parse.parse_qs(query), body, auth))
        return out

    assert parsed(log) == parsed(jlog)
    assert log[0][1] == "/auth" and all(e[4] == "Bearer tok-1"
                                        for e in log[1:])
    created = ("POST", "/api/orders") in {e[:2] for e in log}
    assert created == (not reuse)


def test_up42_refuses_offline_and_without_credentials():
    with pytest.raises(RuntimeError, match="offline"):
        client.UP42Client(Settings()).fetch_best_scene(AOI, Path("."))
    with pytest.raises(RuntimeError, match="credentials"):
        client.UP42Client(Settings(offline=False)).fetch_best_scene(
            AOI, Path("."))


@pytest.mark.parametrize("fails,kw", [
    (2, {}), (4, {}), (5, dict(max_retries=5, base_delay=0.5,
                               backoff_factor=3.0, max_delay=10.0)),
    (1, dict(exceptions=(KeyError,)))])
def test_retry_with_backoff_delays_match_jax(monkeypatch, fails, kw):
    """Delays min(base·factor^k, max) on a fake clock; the last failure
    re-raises; an exception outside ``exceptions`` is not retried."""
    results = []
    for mod in (jretry, retry):
        sleeps = fake_clock(monkeypatch, [mod])
        calls = []

        @mod.retry_with_backoff(**kw)
        def flaky():
            calls.append(1)
            if len(calls) <= fails:
                raise ValueError(f"fail {len(calls)}")
            return "ok"

        try:
            out = flaky()
        except ValueError as exc:
            out = str(exc)
        results.append((out, len(calls), sleeps, flaky.__name__))
    assert results[0] == results[1]


# --- ESRGAN tiles ----------------------------------------------------------

@pytest.fixture
def tiny_x4(tmp_path, monkeypatch):
    """``realesrgan_x4`` as a one-block model with shared seeded weights in
    both packages, float32, engines cached only for this test."""
    from s2sr_tpu.models import engine as jengine
    from s2sr_tpu.models import registry as jregistry
    from s2sr_tpu.models.weights import save_params
    from s2sr_tpu_torch.models import engine
    from s2sr_tpu_torch.models import registry

    from test_torch_engine import TINY, jax_tree_one_block

    wdir = tmp_path / "w"
    save_params(jax_tree_one_block(np.random.default_rng(7)),
                wdir / "realesrgan_x4.npz")
    for reg in (jregistry, registry):
        monkeypatch.setitem(reg.MODELS, "realesrgan_x4", dict(TINY))
    for eng in (jengine, engine):
        monkeypatch.setattr(eng, "_ENGINE_CACHE", {})
    monkeypatch.setenv("SR_DTYPE", "float32")
    monkeypatch.setenv("SR_PAD_PROBE", "false")
    _clear_settings()
    yield wdir
    _clear_settings()


def _clear_settings():
    from s2sr_tpu.config import settings as jsettings
    from s2sr_tpu_torch.config import settings

    for mod in (jsettings, settings):
        mod.get_settings.cache_clear()


def test_run_esrgan_and_tiles_matches_jax(tmp_path, tiny_x4):
    """A 32² scene through WOW SR and one lanczos zoom level: the same
    tile set, tileset.json and result keys; tiles from the same SR raster
    (the ``skip_sr`` resume) within the tile tolerance of JAX's."""
    from s2sr_tpu.fetch.synthetic import synthetic_scene
    from s2sr_tpu.pipelines.esrgan_tiles import run_esrgan_and_tiles as jrun
    from s2sr_tpu_torch.pipelines.esrgan_tiles import run_esrgan_and_tiles

    synthetic_scene(tmp_path / "scene.tif", size=(32, 32), seed=5)
    kw = dict(min_zoom=13, max_zoom=13, weights_dir=tiny_x4)
    want = jrun(tmp_path / "scene.tif", tmp_path / "jax", **kw)
    got = run_esrgan_and_tiles(tmp_path / "scene.tif", tmp_path / "torch",
                               device="cpu", **kw)
    assert sorted(got) == sorted(want)
    assert got["tile_count"] == want["tile_count"] > 0
    assert got["zoom_range"] == want["zoom_range"] == [13, 13]
    sr = read_geotiff(got["sr_output"]).data
    assert sr.shape == jax_read_geotiff(want["sr_output"]).data.shape == \
        (128, 128, 3)
    again = run_esrgan_and_tiles(
        tmp_path / "scene.tif", tmp_path / "resume", device="cpu",
        skip_sr=True, sr_output=want["sr_output"], **kw)
    assert again["sr_output"] == want["sr_output"]
    jt, t = Path(want["tiles_dir"]), Path(again["tiles_dir"])
    names = sorted(p.relative_to(jt) for p in jt.glob("*/*/*.png"))
    assert names == sorted(p.relative_to(t) for p in t.glob("*/*/*.png"))
    assert names == sorted(p.relative_to(Path(got["tiles_dir"]))
                           for p in Path(got["tiles_dir"]).glob("*/*/*.png"))
    assert (t / "tileset.json").read_bytes() == (jt / "tileset.json").read_bytes()
    assert_bytes_close(
        np.stack([decode_png((t / n).read_bytes()) for n in names]),
        np.stack([decode_png((jt / n).read_bytes()) for n in names]))


# --- the CLIs --------------------------------------------------------------

@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    from s2sr_tpu.utils import write_json

    monkeypatch.chdir(tmp_path)
    write_json({"type": "Feature", "geometry": AOI}, tmp_path / "aoi.geojson")
    monkeypatch.setenv("AOI_PATH", str(tmp_path / "aoi.geojson"))
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _clear_settings()
    yield tmp_path
    _clear_settings()


def test_cli_fetch_and_multiband_offline(cli_env, monkeypatch, capsys):
    """Offline: ``cli.fetch`` lands on the synthetic fixture and
    ``cli.multiband`` writes JAX's synthetic stack."""
    import sys

    from s2sr_tpu.cli import multiband as jcli_multiband
    from s2sr_tpu_torch.cli import fetch, multiband as cli_multiband

    fetch.main(["--device", "cpu"])
    out = [line for line in capsys.readouterr().out.splitlines()
           if " | " not in line]                 # the log's own lines
    assert out[0].startswith("Best image: ") and "synthetic_" in out[0]
    assert [line.split(":")[0] for line in out[1:]] == [
        "  Scene ID", "  Date", "  Cloud"]
    cli_multiband.main(["-o", "mb_t", "--size", "48", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["multiband", "-o", "mb_j", "--size",
                                      "48"])
    jcli_multiband.main()
    got = next((cli_env / "mb_t").glob("*.tif"))
    want = next((cli_env / "mb_j").glob("*.tif"))
    assert np.array_equal(read_geotiff(got).data, jax_read_geotiff(want).data)


def test_cli_fetch_scene_online_cutline(cli_env, srv, monkeypatch, capsys):
    """``cli.fetch_scene --cutline`` online against the local catalog: the
    fetched clip and its cutline (alpha outside the AOI polygon, here a
    triangle) equal JAX's ``apply_cutline`` on the same raster."""
    from s2sr_tpu.cli.fetch_scene import apply_cutline as jax_cutline
    from s2sr_tpu.utils import write_json
    from s2sr_tpu_torch.cli import fetch_scene

    tri = {"type": "Polygon", "coordinates": [[[W, S], [E, S], [W, N],
                                               [W, S]]]}
    write_json(tri, cli_env / "aoi.geojson")
    feat = stac_feature(srv.base, "S2_CLI", 4.0, 1)
    srv.routes["/search"] = json_route({"features": [feat]})
    serve_scene(srv, "S2_CLI", seed=9)
    monkeypatch.setattr(client, "EARTH_SEARCH", srv.base + "/search")
    monkeypatch.setenv("OFFLINE", "false")
    _clear_settings()
    fetch_scene.main(["-o", "out", "--cutline", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "cutline clip -> " in out and "scene: S2_CLI" in out
    cut = next((cli_env / "out").glob("*_cutline.tif"))
    src = cut.with_name(cut.name.replace("_cutline", ""))
    got = read_geotiff(cut).data
    want = jax_cutline(jax_read_geotiff(src), tri).data
    assert got.shape == (1024, 1024, 4) and np.array_equal(got, want)
    assert 0 < (got[..., 3] > 0).mean() < 1


def test_cli_tile_and_esrgan_tiles(cli_env, tiny_x4, capsys):
    """``cli.tile`` writes JAX's tile set and tileset.json; ``cli.esrgan_tiles``
    runs SR and its pyramid, then resumes with ``--skip-sr``."""
    from s2sr_tpu.fetch.synthetic import synthetic_scene
    from s2sr_tpu.tiles import process_raster_to_tiles as jax_tiles
    from s2sr_tpu_torch.cli import esrgan_tiles, tile

    synthetic_scene(cli_env / "s.tif", size=(32, 32), seed=2)
    tile.main([str(cli_env / "s.tif"), "-o", "t", "--min-zoom", "12",
               "--max-zoom", "13", "--device", "cpu"])
    assert "Tileset: {" in capsys.readouterr().out
    jax_tiles(cli_env / "s.tif", cli_env / "j", min_zoom=12, max_zoom=13)
    names = sorted(p.relative_to(cli_env / "j")
                   for p in (cli_env / "j").glob("*/*/*.png"))
    assert names and names == sorted(p.relative_to(cli_env / "t")
                                     for p in (cli_env / "t").glob("*/*/*.png"))
    assert (cli_env / "t" / "tileset.json").read_bytes() == \
        (cli_env / "j" / "tileset.json").read_bytes()
    esrgan_tiles.main([str(cli_env / "s.tif"), "-o", "e", "--min-zoom", "12",
                       "--max-zoom", "12", "--weights-dir", str(tiny_x4),
                       "--device", "cpu"])
    first = capsys.readouterr().out
    sr = cli_env / "e" / "esrgan_sr.tif"
    esrgan_tiles.main([str(cli_env / "s.tif"), "-o", "e2", "--min-zoom", "12",
                       "--max-zoom", "12", "--skip-sr", "--sr-output", str(sr),
                       "--device", "cpu"])
    second = capsys.readouterr().out
    counts = [re.findall(r"^(\d+) tiles -> ", out, re.M) for out in (first, second)]
    assert counts[0] == counts[1] and len(counts[0]) == 1 and counts[0] != ["0"]
    assert sr.exists() and not (cli_env / "e2" / "esrgan_sr.tif").exists()
