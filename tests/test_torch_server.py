"""The port's HTTP app (``s2sr_tpu_torch.server.app``) against the JAX
package's, on the CPU, through ``App.dispatch`` and one live socket.

Both apps serve one-block ``realesrgan_x4`` models (the ``TINY`` config
of ``test_torch_engine.py``, re-registered in both registries for this
module only, one shared ``.npz``) in float32, on their own data
directories holding the same seeded 64² scene. The module's scenario
runs the four job routes once in each app (``/api/wow``, ``/api/sr`` at
scales 4 and 2, ``/api/enhance`` as a coalesced batch with one bad
upload, ``/api/pipeline``); the tests compare what came out: job
records, status sequences, messages, pixels, tiles, ``tileset.json``,
``/api/metadata`` and ``/metrics``.

Bounds: SR pixels as ``test_torch_wow.py`` (≤ 1% of pixels touched;
0 measured here); every tile tree as ``test_torch_tiles.py`` (bytes
equal on ≥ 99.99% of values, ≤ 1 elsewhere: 2 of 1,572,864 values of
the original tiles differed when measured, none of the SR tiles).
"""

import asyncio
import dataclasses
import json
import re
import threading
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

from s2sr_tpu.config import settings as jax_settings_mod
from s2sr_tpu.config.settings import Settings as JaxSettings
from s2sr_tpu.fetch.synthetic import synthetic_scene
from s2sr_tpu.geo import read_geotiff as jax_read_geotiff
from s2sr_tpu.models import engine as jax_engine_mod
from s2sr_tpu.models import registry as jax_registry
from s2sr_tpu.models.weights import save_params
from s2sr_tpu.server import app as jax_app_mod
from s2sr_tpu.server.http import Request as JaxRequest
from s2sr_tpu_torch.config import settings as settings_mod
from s2sr_tpu_torch.config.settings import Settings
from s2sr_tpu_torch.geo import read_geotiff
from s2sr_tpu_torch.models import engine as engine_mod
from s2sr_tpu_torch.models import registry
from s2sr_tpu_torch.server import app as app_mod
from s2sr_tpu_torch.server.http import Request, serve
from s2sr_tpu_torch.tiles.png import decode_png, encode_png
from s2sr_tpu_torch.utils import write_json
from s2sr_tpu_torch.utils import validation

from test_torch_engine import TINY, jax_tree_one_block
from torch_threads import one_torch_thread  # noqa: F401

def call(app, method, path, json_body=None, body=b"", headers=None,
         run_background=True):
    """Dispatch one request; run its background tasks (the runner
    submit) like the transport does."""
    if json_body is not None:
        body = json.dumps(json_body).encode()
    req_cls = JaxRequest if app.title.endswith("(TPU)") else Request
    response, background = asyncio.run(app.dispatch(req_cls(
        method=method, path=path, query={}, headers=headers or {},
        body=body)))
    if background and run_background:
        for fn, args, kwargs in background.tasks:
            fn(*args, **kwargs)
    payload = None
    if response.media_type == "application/json" and response.body:
        payload = json.loads(response.body)
    return response, payload


def multipart(fields: dict, image: bytes | None, boundary: str = "bnd"):
    parts = b""
    for name, value in fields.items():
        parts += (f"--{boundary}\r\nContent-Disposition: form-data; "
                  f'name="{name}"\r\n\r\n{value}\r\n').encode()
    if image is not None:
        parts += (f"--{boundary}\r\nContent-Disposition: form-data; "
                  f'name="image"; filename="up.png"\r\n'
                  f"Content-Type: image/png\r\n\r\n").encode() + image
        parts += b"\r\n"
    parts += f"--{boundary}--\r\n".encode()
    return parts, {"content-type": f"multipart/form-data; boundary={boundary}"}


def upload_png(seed: int) -> bytes:
    img = np.random.default_rng(seed).integers(0, 256, (64, 64, 3))
    return encode_png(img.astype(np.uint8))


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """(jax_app, torch_app, weights dir): the TINY model as
    realesrgan_x4 in both registries, float32 engines, pad probe off."""
    d = tmp_path_factory.mktemp("server")
    weights = d / "weights"
    save_params(jax_tree_one_block(np.random.default_rng(11)),
                weights / "realesrgan_x4.npz")
    aoi = d / "aoi.geojson"
    write_json({"type": "Feature", "geometry": {
        "type": "Polygon", "coordinates": [[
            [35.0, 32.0], [35.02, 32.0], [35.02, 32.02], [35.0, 32.02],
            [35.0, 32.0]]]}}, aoi)
    saved = (jax_registry.MODELS["realesrgan_x4"],
             registry.MODELS["realesrgan_x4"])
    jax_registry.MODELS["realesrgan_x4"] = dict(TINY)
    registry.MODELS["realesrgan_x4"] = dict(TINY)
    mp = pytest.MonkeyPatch()
    # engine knobs come from the process settings in both packages
    mp.setenv("SR_DTYPE", "float32")
    mp.setenv("SR_PAD_PROBE", "false")
    jax_settings_mod.get_settings.cache_clear()
    settings_mod.get_settings.cache_clear()
    common = dict(aoi_path=str(aoi), offline=True, weights_dir=str(weights),
                  tile_min_zoom=12, tile_max_zoom=13, max_upload_mb=1)
    out = []
    # one stamp for both apps: a second boundary between them would give
    # the two sidecars different dates
    acq = datetime.now(timezone.utc) - timedelta(days=1)
    for name, make in (("jax", lambda s: jax_app_mod.create_app(
            JaxSettings(**s))), ("torch", lambda s: app_mod.create_app(
                Settings(**s), device="cpu"))):
        data = d / name / "data"
        scene = data / "source" / "scene.tif"
        synthetic_scene(scene, size=(64, 64), seed=4)
        write_json({"scene_id": "fixture", "cloud_cover_pct": 1.0,
                    "acquisition_date": acq.strftime("%Y-%m-%dT%H:%M:%SZ")},
                   scene.with_suffix(".json"))
        out.append(make(dict(common, data_dir=str(data))))
    yield out[0], out[1], weights
    for a in out:
        a.runner.stop()
    for cache in (jax_engine_mod._ENGINE_CACHE, engine_mod._ENGINE_CACHE):
        for key in [k for k in cache if k[0] == "realesrgan_x4"
                    and str(weights) in str(k)]:
            del cache[key]
    jax_registry.MODELS["realesrgan_x4"], registry.MODELS["realesrgan_x4"] = saved
    mp.undo()
    jax_settings_mod.get_settings.cache_clear()
    settings_mod.get_settings.cache_clear()


def data_dir(app) -> Path:
    return Path(app.settings.data_dir)


# --- routes and probes ---------------------------------------------------

def test_route_table_is_jax_minus_unported(apps):
    """Since the decode route is ported, the port registers the JAX
    server's whole route table, in order (nothing is left unported)."""
    jax_app, app, _ = apps
    want = [(r.method, r.raw_path) for r in jax_app.routes]
    assert [(r.method, r.raw_path) for r in app.routes] == want
    assert ("POST", "/api/decode") in want
    assert not hasattr(app_mod, "NOT_PORTED_ROUTES")


def qr_png(text: str = "SN-KBTX-1234567") -> bytes:
    from s2sr_tpu_torch.decode.qr_encode import encode_qr, render

    return encode_png(np.stack([render(encode_qr(text, level="M"))] * 3, -1))


def plate_png() -> bytes:
    """A small, low-quality serial plate (the JAX OCR test's): no QR, a
    weak OCR read, so the scan asks for the SR retry."""
    from test_ocr import render

    return encode_png(render("KQ4Z-77812X0", size=13, pad=8))


def _probe_requests(scene: str):
    big = upload_png(1) * 300           # > the 1 MB upload limit
    return {
        # verify skill's "Probes that should hold" and test_server.py's
        "sr_scale_7": ("POST", "/api/sr", {"json_body": {"scale": 7,
                                                         "input_file": scene}}),
        "sr_bad_model": ("POST", "/api/sr", {"json_body": {
            "model": "bogus", "input_file": scene}}),
        "sr_missing_input": ("POST", "/api/sr", {"json_body": {
            "input_file": "/nonexistent/scene.tif"}}),
        "bad_json": ("POST", "/api/sr", {"body": b"{not json"}),
        "json_array": ("POST", "/api/sr", {"body": b"[1,2]"}),
        "json_string": ("POST", "/api/pipeline", {"body": b'"text"'}),
        "json_number": ("POST", "/api/wow", {"body": b"5"}),
        "tile_404": ("GET", "/tiles/5/1/1.png", {}),
        "sr_tile_404": ("GET", "/tiles_sr/5/1/1.png", {}),
        "wow_tile_404": ("GET", "/tiles_wow/5/1/1.png", {}),
        "tile_422": ("GET", "/tiles/abc/1/2.png", {}),
        "enhance_no_image": ("POST", "/api/enhance", dict(zip(
            ("body", "headers"), multipart({"model": "realesrgan_x4"},
                                           None)))),
        "enhance_bad_model": ("POST", "/api/enhance", dict(zip(
            ("body", "headers"), multipart({"model": "weird"}, None)))),
        "enhance_bad_precision": ("POST", "/api/enhance", dict(zip(
            ("body", "headers"), multipart({"precision": "fp8"},
                                           upload_png(0))))),
        "enhance_too_large": ("POST", "/api/enhance", dict(zip(
            ("body", "headers"), multipart({}, big)))),
        "enhance_no_boundary": ("POST", "/api/enhance", {
            "body": b"x", "headers": {"content-type": "multipart/form-data"}}),
        "wow_bad_precision": ("POST", "/api/wow", {"json_body": {
            "input_file": scene, "precision": "fp8"}}),
        "wow_missing_input": ("POST", "/api/wow", {"json_body": {
            "input_file": "/nonexistent/scene.tif"}}),
        "pipeline_bad_zoom": ("POST", "/api/pipeline", {"json_body": {
            "min_zoom": 4.5}}),
        "health_post_405": ("POST", "/health", {}),
        "sr_status_404": ("GET", "/api/sr/nope", {}),
        "pipeline_status_404": ("GET", "/api/pipeline/nope", {}),
        "download_unknown_job": ("GET", "/api/sr/download/nope/x.tif", {}),
        "download_no_output_dir": ("GET",
                                   "/api/sr/download/probe_nodir/x.tif", {}),
        "download_traversal": (
            "GET", "/api/sr/download/probe_dir/..%2f..%2f..%2fetc%2fpasswd",
            {}),
        "health": ("GET", "/health", {}),
        "config": ("GET", "/api/config", {}),
        "spa_fallback": ("GET", "/some/client/route", {}),
        "spa_traversal": ("GET", "/../../../../../../etc/passwd", {}),
        "spa_static_file": ("GET", "/enhance.html", {}),
        "vectors_fields_404": ("GET", "/vectors/fields.geojson", {}),
        "vectors_zones_404": ("GET", "/vectors/zones.geojson", {}),
        "vectors_metadata_empty": ("GET", "/api/vectors/metadata", {}),
        "vectors_status_404": ("GET", "/api/vectors/nope", {}),
        "vectors_aoi_404": ("POST", "/api/vectors", {"json_body": {
            "aoi_path": "/nonexistent/aoi.geojson"}}),
        "vectors_json_array": ("POST", "/api/vectors", {"body": b"[1]"}),
        "vectors_get_405": ("GET", "/api/vectors", {}),
        # the QR/serial scan (no job; the SR retry off or not needed)
        "decode_qr": ("POST", "/api/decode", dict(zip(
            ("body", "headers"), multipart({}, qr_png())))),
        "decode_plate_no_retry": ("POST", "/api/decode", dict(zip(
            ("body", "headers"), multipart({"enhance_retry": "false"},
                                           plate_png())))),
        "decode_qr_no_retry": ("POST", "/api/decode", dict(zip(
            ("body", "headers"), multipart({"enhance_retry": "FALSE"},
                                           qr_png("AB12"))))),
        "decode_non_image": ("POST", "/api/decode", dict(zip(
            ("body", "headers"), multipart({}, b"not an image at all")))),
        "decode_no_image": ("POST", "/api/decode", dict(zip(
            ("body", "headers"), multipart({"enhance_retry": "false"},
                                           None)))),
        "decode_too_large": ("POST", "/api/decode", dict(zip(
            ("body", "headers"), multipart({}, big)))),
        "decode_over_16mpix": ("POST", "/api/decode", dict(zip(
            ("body", "headers"), multipart({}, encode_png(
                np.full((4001, 4001), 200, np.uint8)))))),
        "decode_get_405": ("GET", "/api/decode", {}),
    }


PROBES = sorted(_probe_requests("x"))


@pytest.mark.parametrize("probe", PROBES)
def test_probe_status_and_detail_match_jax(apps, probe):
    """Status code, ``detail`` (or the whole body) and the Allow header
    equal for every probe; none of them creates a job."""
    results = []
    for app in apps[:2]:
        scene = str(data_dir(app).parent.parent / "jax" / "data" / "source"
                    / "scene.tif")
        app.jobs.create("probe_nodir", status="completed", message="done")
        app.jobs.create("probe_dir", status="completed",
                        output_dir=str(data_dir(app)))
        method, path, kw = _probe_requests(scene)[probe]
        n_jobs = len(app.jobs.all())
        resp, payload = call(app, method, path, **kw)
        assert len(app.jobs.all()) == n_jobs
        results.append((resp, payload))
    (jresp, jpay), (resp, pay) = results
    assert resp.status_code == jresp.status_code, (pay, jpay)
    assert resp.headers.get("Allow") == jresp.headers.get("Allow")
    assert b"root:" not in resp.body
    if resp.status_code == 422 and isinstance(jpay["detail"], str) \
            and "validation error" in jpay["detail"]:
        # pydantic's wording differs; the field at fault is named
        assert "min_zoom" in pay["detail"] and "min_zoom" in jpay["detail"]
    elif jpay is not None:
        assert pay == jpay
    else:
        assert resp.body == jresp.body and resp.media_type == jresp.media_type


# --- the pydantic coercion table ------------------------------------------

# (spec, field, value) -> coerced value, or REJECT (a 422): pinned from
# the JAX server's pydantic 2.12 models (test_coercion_table_is_pydantics
# checks them against the installed pydantic).
REJECT = "reject"
COERCION = [
    ("SRRequest", "scale", "4", 4), ("SRRequest", "scale", 4.0, 4),
    ("SRRequest", "scale", 4.5, REJECT), ("SRRequest", "scale", True, 1),
    ("SRRequest", "scale", "4.0", 4), ("SRRequest", "scale", " 4 ", 4),
    ("SRRequest", "scale", "1_000", 1000), ("SRRequest", "scale", "+3", 3),
    ("SRRequest", "scale", None, REJECT), ("SRRequest", "scale", "x", REJECT),
    ("SRRequest", "scale", [4], REJECT), ("SRRequest", "scale", "1e1", REJECT),
    ("SRRequest", "scale", "4.", REJECT), ("SRRequest", "scale", "_4", REJECT),
    ("SRRequest", "scale", "4.5", REJECT), ("SRRequest", "scale", 1e19, REJECT),
    ("SRRequest", "scale", 9.2e18, 9200000000000000000),
    ("SRRequest", "scale", "99999999999999999999", 99999999999999999999),
    ("SRRequest", "model", "espcn", "espcn"), ("SRRequest", "model", 4, REJECT),
    ("SRRequest", "model", None, REJECT), ("SRRequest", "model", True, REJECT),
    ("SRRequest", "input_file", None, None),
    ("SRRequest", "input_file", 3, REJECT),
    ("WowRequest", "enhance_crops", "true", True),
    ("WowRequest", "enhance_crops", "TRUE", True),
    ("WowRequest", "enhance_crops", "yes", True),
    ("WowRequest", "enhance_crops", "on", True),
    ("WowRequest", "enhance_crops", "t", True),
    ("WowRequest", "enhance_crops", "1", True),
    ("WowRequest", "enhance_crops", 1, True),
    ("WowRequest", "enhance_crops", 1.0, True),
    ("WowRequest", "enhance_crops", "off", False),
    ("WowRequest", "enhance_crops", "n", False),
    ("WowRequest", "enhance_crops", 0, False),
    ("WowRequest", "enhance_crops", 0.0, False),
    ("WowRequest", "enhance_crops", 2, REJECT),
    ("WowRequest", "enhance_crops", 0.5, REJECT),
    ("WowRequest", "enhance_crops", "maybe", REJECT),
    ("WowRequest", "enhance_crops", " true ", REJECT),
    ("WowRequest", "enhance_crops", "1.0", REJECT),
    ("WowRequest", "enhance_crops", None, REJECT),
    ("WowRequest", "max_cloud_cover", "30", 30.0),
    ("WowRequest", "max_cloud_cover", 30, 30.0),
    ("WowRequest", "max_cloud_cover", True, 1.0),
    ("WowRequest", "max_cloud_cover", "1e2", 100.0),
    ("WowRequest", "max_cloud_cover", " 5 ", 5.0),
    ("WowRequest", "max_cloud_cover", "inf", float("inf")),
    ("WowRequest", "max_cloud_cover", "1_0", 10.0),
    ("WowRequest", "max_cloud_cover", "", REJECT),
    ("WowRequest", "max_cloud_cover", "0x1p3", REJECT),
    ("WowRequest", "max_cloud_cover", None, REJECT),
    ("WowRequest", "max_cloud_cover", 10 ** 400, REJECT),
    ("WowRequest", "precision", 1, REJECT),
    ("WowRequest", "max_age_days", "7", 7),
    ("PipelineRequest", "min_zoom", "12", 12),
    ("PipelineRequest", "max_zoom", 13.0, 13),
    ("PipelineRequest", "run_sr", "false", False),
    ("PipelineRequest", "sr_type", "farm", "farm"),
    ("PipelineRequest", "generate_original_tiles", "no", False),
    ("VectorRequest", "ndvi_threshold", "0.4", 0.4),
    ("VectorRequest", "min_area_ha", True, 1.0),
    ("VectorRequest", "max_area_ha", 100, 100.0),
    ("VectorRequest", "simplify_tolerance_m", "x", REJECT),
    ("VectorRequest", "raster_path", None, None),
    ("VectorRequest", "raster_path", 3, REJECT),
    ("VectorRequest", "aoi_path", "a.geojson", "a.geojson"),
]


def _jax_parse(spec: str, body: dict):
    from pydantic import ValidationError

    try:
        return getattr(jax_app_mod, spec)(**body)
    except ValidationError:
        return REJECT


def _port_parse(spec: str, body: dict):
    try:
        return validation.parse(getattr(app_mod, spec), body)
    except validation.ValidationError:
        return REJECT


def _same(a, b):
    return a == b and type(a) is type(b)


def test_coercion_table_is_pydantics():
    for spec, name, value, want in COERCION:
        got = _jax_parse(spec, {name: value})
        got = got if got == REJECT else getattr(got, name)
        assert _same(got, want), (spec, name, value, got)


@pytest.mark.parametrize("spec", ["SRRequest", "WowRequest",
                                  "PipelineRequest", "VectorRequest"])
def test_port_coercion_matches_table(spec):
    for s, name, value, want in COERCION:
        if s != spec:
            continue
        got = _port_parse(spec, {name: value})
        got = got if got == REJECT else getattr(got, name)
        assert _same(got, want), (spec, name, value, got)
    # defaults, field order and extra keys ignored: as the JAX model
    jax_model = getattr(jax_app_mod, spec)(unknown_key=1)
    port = _port_parse(spec, {"unknown_key": 1})
    assert dataclasses.asdict(port) == jax_model.model_dump()
    assert list(dataclasses.asdict(port)) == list(jax_model.model_dump())


def test_validation_detail_names_every_field(apps):
    _, app, _ = apps
    resp, payload = call(app, "POST", "/api/sr",
                         json_body={"scale": "x", "model": 3})
    assert resp.status_code == 422
    detail = payload["detail"]
    assert detail.startswith("2 validation errors for SRRequest")
    assert re.search(r"^scale$", detail, re.M)
    assert re.search(r"^model$", detail, re.M)


# --- the job scenario -----------------------------------------------------

def _recorder(store, log: list):
    update, update_if = store.update, store.update_if

    def rec_update(job_id, **fields):
        applied = update(job_id, **fields)
        if applied and "status" in fields:
            log.append((job_id, fields["status"], fields.get("message")))
        return applied

    def rec_update_if(job_id, expected, **fields):
        applied = update_if(job_id, expected, **fields)
        if applied and "status" in fields:
            log.append((job_id, fields["status"], fields.get("message")))
        return applied

    store.update, store.update_if = rec_update, rec_update_if


ROUTES = ("wow", "sr4", "sr2", "pipeline", "enhance0", "enhance_bad",
          "enhance1")


def run_scenario(app) -> dict:
    """The four job routes, queued behind a held runner so the enhance
    uploads coalesce; returns route → job id, and the status log."""
    log: list = []
    _recorder(app.jobs, log)
    scene = str(data_dir(app) / "source" / "scene.tif")
    gate = threading.Event()
    app.runner.submit("hold", lambda: gate.wait(120))
    ids = {}
    for route, path, body in (
            ("wow", "/api/wow", {"input_file": scene, "enhance_crops": True}),
            ("sr4", "/api/sr", {"input_file": scene, "scale": 4}),
            ("sr2", "/api/sr", {"input_file": scene, "scale": "2"}),
            ("pipeline", "/api/pipeline", {"min_zoom": 12, "max_zoom": 13})):
        resp, payload = call(app, "POST", path, json_body=body)
        assert resp.status_code == 200, payload
        ids[route] = payload["job_id"]
    for route, image in (("enhance0", upload_png(2)),
                         ("enhance_bad", b"this is not an image"),
                         ("enhance1", upload_png(3))):
        body, headers = multipart({"model": "realesrgan_x4"}, image)
        resp, payload = call(app, "POST", "/api/enhance", body=body,
                             headers=headers)
        assert resp.status_code == 200, payload
        assert payload["status"] == "queued"
        ids[route] = payload["job_id"]
    gate.set()
    app.runner.join(600)
    return {"ids": ids, "log": log}


@pytest.fixture(scope="module")
def scenario(apps):
    jax_app, app, _ = apps
    return run_scenario(jax_app), run_scenario(app)


def normalize(obj, app, ids: dict):
    """Drop wall-clock fields; replace the app's data dir and job ids."""
    root = str(data_dir(app))
    if isinstance(obj, dict):
        return {k: normalize(v, app, ids) for k, v in obj.items()
                if k not in ("created_at", "completed_at", "timestamp",
                             "timing")}
    if isinstance(obj, list):
        return [normalize(v, app, ids) for v in obj]
    if isinstance(obj, str):
        obj = obj.replace(root, "<data>")
        for route, job_id in ids.items():
            obj = obj.replace(job_id, f"<{route}>")
    return obj


def statuses(run, route):
    job_id = run["ids"][route]
    return [(s, m) for j, s, m in run["log"] if j == job_id]


@pytest.mark.parametrize("route", ROUTES)
def test_job_status_sequence_matches_jax(apps, scenario, route):
    jrun, run = scenario
    want, got = statuses(jrun, route), statuses(run, route)
    if route == "enhance_bad":
        # PIL's decode error (JAX) and the port's PNG decoder's differ
        want, got = [s for s, _ in want], [s for s, _ in got]
        assert got == want and got[-1] == "failed"
        return
    assert got == want
    final = {"sr2": "failed"}.get(route, "completed")
    assert got[-1][0] == final


@pytest.mark.parametrize("route", ROUTES)
def test_job_record_matches_jax(apps, scenario, route):
    jax_app, app, _ = apps
    jrun, run = scenario
    want = normalize(jax_app.jobs.get(jrun["ids"][route]), jax_app,
                     jrun["ids"])
    got = normalize(app.jobs.get(run["ids"][route]), app, run["ids"])
    assert sorted(got) == sorted(want)
    if route == "enhance_bad":
        want.pop("message"), got.pop("message")
    if route == "sr2":
        assert got["message"].startswith("Unknown model: realesrgan_x2")
    for rec in (want, got):
        md = rec.get("result", {}).get("sr_metadata", {})
        md.pop("precision_note", None)
    assert got == want


def test_enhance_jobs_coalesced(apps, scenario):
    _, app, _ = apps
    _, run = scenario
    for route in ("enhance0", "enhance_bad", "enhance1"):
        assert app.jobs.get(run["ids"][route])["coalesced"] == 3


SR_ROUTES = ("wow", "sr4", "pipeline", "enhance0", "enhance1")


def _sr_output(app, run, route) -> np.ndarray:
    job = app.jobs.get(run["ids"][route])
    if route == "pipeline":
        path = job["steps"][2]["details"]["output"]
    else:
        outputs = job["result"]["outputs"]
        path = outputs["sr_tif"] or outputs["sr_png"]
    if path.endswith(".png"):
        return decode_png(Path(path).read_bytes())
    reader = (jax_read_geotiff if app.title.endswith("(TPU)")
              else read_geotiff)
    return reader(path).data


@pytest.mark.parametrize("route", SR_ROUTES)
def test_sr_pixels_match_jax(apps, scenario, route):
    jax_app, app, _ = apps
    jrun, run = scenario
    want, got = _sr_output(jax_app, jrun, route), _sr_output(app, run, route)
    assert got.shape == want.shape == (256, 256, 3)
    assert got.dtype == want.dtype == np.uint8
    assert np.any(got != want, axis=-1).mean() <= 0.01


TILE_TREES = ("tiles", "tiles_wow", "tiles_sr")


def _tiles(app, tree):
    base = data_dir(app) / tree
    return {p.relative_to(base).as_posix(): decode_png(p.read_bytes())
            for p in sorted(base.glob("*/*/*.png"))}


@pytest.mark.parametrize("tree", TILE_TREES)
def test_tiles_match_jax(apps, scenario, tree):
    jax_app, app, _ = apps
    want, got = _tiles(jax_app, tree), _tiles(app, tree)
    assert want and sorted(got) == sorted(want)
    zooms = {int(k.split("/")[0]) for k in got}
    assert zooms == ({12, 13} if tree == "tiles" else {12, 13, 14, 15})
    a = np.stack([want[k] for k in sorted(want)]).astype(np.int16)
    b = np.stack([got[k] for k in sorted(got)]).astype(np.int16)
    diff = np.abs(a - b)
    # the warp's bound; the SR trees' sources were byte-equal when
    # measured (float32 engines), so they are held to it too
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    jts = (data_dir(jax_app) / tree / "tileset.json").read_bytes()
    assert (data_dir(app) / tree / "tileset.json").read_bytes() == jts


def test_metadata_matches_jax(apps, scenario):
    jax_app, app, _ = apps
    _, want = call(jax_app, "GET", "/api/metadata")
    _, got = call(app, "GET", "/api/metadata")
    assert list(got) == list(want)
    for key in ("tileset", "tilesAvailable", "srTilesAvailable",
                "wowTilesAvailable", "tileEndpoints", "vectorsAvailable",
                "zonesAvailable", "source"):
        assert got[key] == want[key], key
    assert got["models"]["realesrgan_x4"] == want["models"]["realesrgan_x4"]


def test_metrics_and_runtime_match_jax(apps, scenario):
    jax_app, app, _ = apps

    def lines(a):
        resp, _ = call(a, "GET", "/metrics")
        assert resp.media_type == "text/plain; version=0.0.4"
        return [re.sub(r"^(s2sr_uptime_seconds) .*", r"\1", line)
                for line in resp.body.decode().splitlines()]

    assert lines(app) == lines(jax_app)
    _, jrt = call(jax_app, "GET", "/api/runtime")
    _, rt = call(app, "GET", "/api/runtime")
    # the port adds the PNG encoder in use and why (native.png_encoder)
    encoder = ("png_encoder", "png_encoder_reason")
    assert [k for k in rt if k not in encoder] == list(jrt)
    assert rt["png_encoder"] in ("native", "pure") and rt["png_encoder_reason"]
    assert set(rt["devices"][0]) == set(jrt["devices"][0]) == {
        "id", "platform", "kind"}
    for key in ("jobs_total", "jobs_by_status", "runner_active",
                "runner_queued", "max_concurrent"):
        assert rt[key] == jrt[key], key


def test_listings_and_download(apps, scenario):
    jax_app, app, _ = apps
    jrun, run = scenario
    for a, r in ((jax_app, jrun), (app, run)):
        _, listing = call(a, "GET", "/api/pipelines")
        assert listing["count"] == 1
        assert list(listing["jobs"]) == [r["ids"]["pipeline"]]
        _, sr = call(a, "GET", "/api/sr")
        assert r["ids"]["wow"] in sr["jobs"]
        job = a.jobs.get(r["ids"]["wow"])
        name = Path(job["result"]["outputs"]["sr_png"]).name
        resp, _ = call(a, "GET", f"/api/sr/download/{r['ids']['wow']}/{name}")
        assert resp.status_code == 200
        assert resp.body[:8] == b"\x89PNG\r\n\x1a\n"
        _, status = call(a, "GET", f"/api/sr/{r['ids']['enhance0']}")
        assert status["status"] == "completed"
        one = next((data_dir(a) / "tiles_wow").glob("*/*/*.png"))
        resp, _ = call(a, "GET", "/tiles_wow/" + "/".join(one.parts[-3:]))
        assert resp.status_code == 200
        assert resp.headers["Cache-Control"] == "public, max-age=86400"


def test_turbo_precision_completes(apps, scenario):
    """``precision="turbo"`` (→ "int8") completes on ``/api/wow`` and on a
    coalesced ``/api/enhance`` pair in the port's app, on the int8-mixed
    trunk: the jobs and their metadata say "int8", ``/api/metadata`` lists
    the int8 engine beside the float one, and the pair equals each upload
    served alone through the WOW chain."""
    import torch

    from s2sr_tpu_torch.ops.enhance import enhance_for_crops

    _, app, _ = apps
    scene = str(data_dir(app) / "source" / "scene.tif")
    resp, payload = call(app, "POST", "/api/wow", json_body={
        "input_file": scene, "precision": "turbo"})
    assert resp.status_code == 200
    gate = threading.Event()
    app.runner.submit("hold", lambda: gate.wait(120))
    ids = []
    for seed in (7, 8):
        body, headers = multipart({"model": "realesrgan_x4",
                                   "precision": "turbo"}, upload_png(seed))
        resp, enh = call(app, "POST", "/api/enhance", body=body,
                         headers=headers)
        assert resp.status_code == 200, enh
        ids.append(enh["job_id"])
    gate.set()
    app.runner.join(120)
    job = app.jobs.get(payload["job_id"])
    assert job["precision"] == "int8" and job["status"] == "completed", job
    meta = job["result"]["sr_metadata"]
    assert meta["precision"] == "int8" and "int8" in meta["precision_note"]
    engine = next(e for e in engine_mod.loaded_engines() if e.quantized)
    for job_id, seed in zip(ids, (7, 8)):
        rec = app.jobs.get(job_id)
        assert rec["status"] == "completed" and rec.get("coalesced") == 2, rec
        png = decode_png(Path(rec["result"]["outputs"]["sr_png"]).read_bytes())
        alone = engine.enhance_serving(decode_png(upload_png(seed)))
        assert np.array_equal(png, enhance_for_crops(
            torch.from_numpy(alone)).numpy()), job_id
    _, md = call(app, "GET", "/api/metadata")
    assert md["models"]["realesrgan_x4:int8"]["precision"] == "int8"
    assert md["models"]["realesrgan_x4"]["precision"] == "float32"


@pytest.mark.parametrize("fixture", ["upload_420.jpg",
                                     "upload_progressive_422_restart.jpg",
                                     "upload_rgb16_adam7.png",
                                     "upload_palette4_trns.png",
                                     "upload_rle8.bmp",
                                     "upload_animated.gif",
                                     "upload_lossy_alpha.webp",
                                     "upload_gray16.tiff_upload",
                                     "upload_arithmetic_progressive.jpg"])
def test_jpeg_and_png_uploads_complete(apps, scenario, fixture):
    """An upload on ``/api/enhance`` in any format PIL opens (JPEG and its
    arithmetic variant, non-8-bit PNG, BMP, GIF, WebP, a TIFF without
    its suffix) completes in the port's app (JAX opens it with PIL), and
    its SR output is the engine's on PIL's decode of the file through the
    WOW chain, byte for byte."""
    import io

    import torch
    from PIL import Image

    from s2sr_tpu_torch.ops.enhance import enhance_for_crops

    _, app, _ = apps
    data = (Path(__file__).parent / "fixtures_torch" / fixture).read_bytes()
    body, headers = multipart({"model": "realesrgan_x4"}, data)
    resp, payload = call(app, "POST", "/api/enhance", body=body,
                         headers=headers)
    assert resp.status_code == 200, payload
    app.runner.join(120)
    rec = app.jobs.get(payload["job_id"])
    assert rec["status"] == "completed", rec
    png = decode_png(Path(rec["result"]["outputs"]["sr_png"]).read_bytes())
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    engine = next(e for e in engine_mod.loaded_engines()
                  if e.model_name == "realesrgan_x4" and not e.quantized)
    want = enhance_for_crops(torch.from_numpy(engine.enhance_serving(pil)))
    assert np.array_equal(png, want.numpy())


def test_create_app_refuses_missing_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app_mod.create_app(Settings(data_dir=str(tmp_path)))


def test_live_socket_round_trip(apps, tmp_path):
    """A real TCP round trip through ``serve`` on a fresh app, and a clean
    shutdown that runs the hooks: the runner refuses new work after."""
    import urllib.error
    import urllib.request

    import socket

    app = app_mod.create_app(Settings(data_dir=str(tmp_path / "data")),
                             device="cpu")
    with socket.socket() as s:          # a free port for the server
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    loop = asyncio.new_event_loop()
    started = threading.Event()

    async def main_on(port_):
        app.stop_event = asyncio.Event()
        ready = asyncio.Event()
        task = asyncio.ensure_future(serve(app, host="127.0.0.1", port=port_,
                                           stop=app.stop_event, ready=ready))
        await ready.wait()
        started.set()
        await task

    thread = threading.Thread(
        target=lambda: loop.run_until_complete(main_on(free)), daemon=True)
    thread.start()
    assert started.wait(10), "server did not start"
    base = f"http://127.0.0.1:{free}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=5) as r:
            assert json.loads(r.read())["status"] == "healthy"
        req = urllib.request.Request(base + "/api/sr", data=b'{"scale": 7}',
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=5)
        assert err.value.code == 404           # no source scene yet
        assert json.loads(err.value.read())["detail"].startswith(
            "No GeoTIFF files found")
    finally:
        loop.call_soon_threadsafe(app.stop_event.set)
        thread.join(timeout=10)
        loop.close()
    assert not thread.is_alive(), "server did not shut down"
    with pytest.raises(RuntimeError):
        app.runner.submit("post-shutdown", lambda: None)


def test_decode_retry_runs_on_the_runner_unjournaled(apps, scenario):
    """A low-quality plate on ``/api/decode`` asks for the SR retry in
    both apps: it runs ``realesrgan_x4``'s ``enhance_serving`` through the
    runner (``run_sync`` label ``decode_sr``) and rescans the ×4 image;
    the runner's ``_sync_decode_sr_*`` pseudo-job never reaches the
    journal. The rescan reads an SR output, where the two engines may
    differ by an LSB, so the stages and the retry flag are compared, not
    the text."""
    body, headers = multipart({}, plate_png())
    out = []
    for app in apps[:2]:
        labels = []
        run_sync = app.runner.run_sync

        def spy(fn, timeout=300.0, label="inline", _run=run_sync, _l=labels):
            _l.append((label, timeout))
            return _run(fn, timeout=timeout, label=label)

        app.runner.run_sync = spy
        try:
            resp, payload = call(app, "POST", "/api/decode", body=body,
                                 headers=headers)
        finally:
            del app.runner.run_sync
        assert resp.status_code == 200, payload
        assert labels == [("decode_sr", 240.0)]
        assert payload["retried_with_enhancement"] is True
        assert payload["filename"] == "up.png"
        out.append([a["stage"] for a in payload["attempts"]])
        journal = (data_dir(app) / "jobs.jsonl").read_text()
        assert "_sync_" not in journal
    assert out[0] == out[1] == ["original", "enhanced"]


def test_durable_store_never_journals_unknown_ids(tmp_path):
    """JAX's ``test_server.py`` rule on the port's store: updates for ids
    that were never created (the runner's ``_sync_*`` pseudo-jobs) are
    refused and never come back after a reopen."""
    from s2sr_tpu_torch.server.persistence import DurableJobStore

    journal = tmp_path / "j.jsonl"
    store = DurableJobStore(journal)
    store.create("real", status="queued")
    assert store.update("_sync_decode_sr_1", status="failed") is False
    assert store.update("real", status="completed") is True
    store.close()
    store2 = DurableJobStore(journal)
    assert store2.get("_sync_decode_sr_1") is None
    assert set(store2.all()) == {"real"}
    assert store2.get("real")["status"] == "completed"


# --- offline scene selection (fetch/smart_fetch.py) -----------------------

def _scene_with_sidecar(path, seed, sidecar):
    synthetic_scene(path, size=(16, 16), seed=seed)
    if sidecar is not None:
        write_json(sidecar, path.with_suffix(".json"))


def test_local_selection_matches_jax(tmp_path):
    from s2sr_tpu.fetch import smart_fetch as jsf
    from s2sr_tpu_torch.fetch import smart_fetch as sf

    now = datetime.now(timezone.utc)
    day = lambda n: (now - timedelta(days=n)).strftime("%Y-%m-%dT%H:%M:%SZ")
    src = tmp_path / "source"
    _scene_with_sidecar(src / "a.tif", 1, {"scene_id": "a",
                                           "cloud_cover_pct": 12.0,
                                           "acquisition_date": day(2)})
    _scene_with_sidecar(src / "b.tif", 2, {"scene_id": "b",
                                           "cloud_cover_pct": 3.0,
                                           "acquisition_date": day(20)})
    _scene_with_sidecar(src / "c.tif", 3, {"scene_id": "c",
                                           "cloud_cover_pct": 3.0,
                                           "acquisition_date": day(5)})
    _scene_with_sidecar(src / "old.tif", 4, {"scene_id": "old",
                                             "cloud_cover_pct": 0.0,
                                             "acquisition_date": day(90)})
    _scene_with_sidecar(src / "synthetic_x.tif", 5, {
        "scene_id": "s", "cloud_cover_pct": 0.0, "acquisition_date": day(0),
        "source": "synthetic_fallback"})
    _scene_with_sidecar(src / "bare.tif", 6, None)
    for age, cloud in ((30, 30.0), (10, 30.0), (30, 2.0), (1, 50.0)):
        want = jsf.select_best_local_image(src, age, cloud)
        got = sf.select_best_local_image(src, age, cloud)
        assert (got is None) == (want is None)
        if got is not None:
            assert {k: v for k, v in got.items()} == \
                {k: v for k, v in want.items()}
    assert [i["scene_id"] for i in sf.get_local_images(src)] == \
        [i["scene_id"] for i in jsf.get_local_images(src)]


def test_synthetic_fallback_matches_jax(tmp_path):
    from s2sr_tpu.fetch import smart_fetch as jsf
    from s2sr_tpu_torch.fetch import smart_fetch as sf

    aoi = {"type": "FeatureCollection", "features": [{
        "type": "Feature", "geometry": {"type": "Polygon", "coordinates": [[
            [35.0, 32.0], [35.02, 32.0], [35.02, 32.02], [35.0, 32.02],
            [35.0, 32.0]]]}}]}
    write_json(aoi, tmp_path / "aoi.geojson")
    geom = sf.load_aoi_geometry(tmp_path / "aoi.geojson")
    assert geom == jsf.load_aoi_geometry(tmp_path / "aoi.geojson")
    want_path, want_meta = jsf.smart_fetch(geom, tmp_path / "jax")
    settings = Settings(aoi_path=str(tmp_path / "aoi.geojson"), offline=True,
                        data_dir=str(tmp_path / "data"))
    got_path, got_meta = sf.ensure_best_image(settings=settings)
    assert got_path.parent == tmp_path / "data" / "source"
    assert sorted(got_meta) == sorted(want_meta)
    assert got_meta["source"] == want_meta["source"] == "synthetic_fallback"
    a, b = jax_read_geotiff(want_path), read_geotiff(got_path)
    assert np.array_equal(b.data, a.data) and b.data.shape == (512, 512, 3)
    assert tuple(b.transform) == tuple(a.transform)
    # the fixture is reused, never re-synthesized, and never outranks
    again, meta = sf.ensure_best_image(settings=settings)
    assert again == got_path and meta == got_meta


def test_online_fetch_is_not_ported(tmp_path, monkeypatch):
    """The online fetch is ported (``fetch/client.py``): with
    ``offline=False`` and the catalog unreachable (a closed local port),
    ``ensure_best_image`` no longer raises "not ported" but walks JAX's
    ladder down to the synthetic fixture. (The fetch itself is held to
    the JAX package in ``tests/test_torch_fetch.py``.)"""
    import socket

    from s2sr_tpu_torch.fetch import smart_fetch as sf

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setattr(sf, "STAC_URL", f"http://127.0.0.1:{port}/search")
    monkeypatch.setenv("no_proxy", "127.0.0.1")
    settings = Settings(offline=False, data_dir=str(tmp_path),
                        aoi_path=str(tmp_path / "missing.geojson"))
    path, meta = sf.ensure_best_image(settings=settings, device="cpu")
    assert meta["source"] == "synthetic_fallback"
    assert list((tmp_path / "source").glob("*.tif")) == [path]


# --- the engine cache /api/metadata reads ---------------------------------

def test_halo_probe_sidecar_and_loaded_engines(tmp_path, monkeypatch):
    """The probe's margin is kept in the port's own sidecar
    (``$S2SR_TORCH_CACHE/halo_probe.json``) and read back by a later
    engine instead of probing again."""
    registry.MODELS["rrdb_probe"] = dict(TINY)
    monkeypatch.setenv("S2SR_TORCH_CACHE", str(tmp_path / "cache"))
    save_params(jax_tree_one_block(np.random.default_rng(3)),
                tmp_path / "w" / "rrdb_probe.npz")
    kw = dict(weights_dir=tmp_path / "w", tile_size=32, dtype="float32",
              pad_probe=True, device="cpu")
    try:
        eng = engine_mod.SREngine("rrdb_probe", **kw)
        store = json.loads((tmp_path / "cache" / "halo_probe.json").read_text())
        assert list(store.values()) == [eng.halo_margin_lsb]
        engine_mod._PROBE_MEMO.clear()

        def no_probe(*args, **kwargs):
            raise AssertionError("probed again despite the sidecar")

        monkeypatch.setattr(engine_mod, "probe_halo_margin", no_probe)
        again = engine_mod.SREngine("rrdb_probe", **kw)
        assert again.halo_margin_lsb == eng.halo_margin_lsb
        cached = engine_mod.get_engine("rrdb_probe", **kw)
        assert cached in engine_mod.loaded_engines()
    finally:
        registry.MODELS.pop("rrdb_probe", None)
        for key in [k for k in engine_mod._ENGINE_CACHE if k[0] == "rrdb_probe"]:
            del engine_mod._ENGINE_CACHE[key]


# --- the vector job ---------------------------------------------------------

@pytest.fixture(scope="module")
def vector_runs(apps, scenario, tmp_path_factory):
    """Per app: a job on a planted 128² raster (one shared path), the
    geojson and metadata it leaves, then a job with no raster_path,
    which finds the newest raster under data/wow (wow > sr > source):
    the same planted scene written there for both apps, since earlier
    tests leave the two apps' WOW outputs different."""
    import shutil

    from s2sr_tpu_torch.vectors.synthetic import write_planted_scene

    tif, aoi = write_planted_scene(tmp_path_factory.mktemp("planted"), 128, 0)
    runs = []
    for app in apps[:2]:
        newest = data_dir(app) / "wow" / "vectors_probe" / "planted_wow.tif"
        newest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(tif, newest)
        out = {"ids": {}}
        resp, payload = call(app, "POST", "/api/vectors", json_body={
            "raster_path": str(tif), "aoi_path": str(aoi),
            "min_area_ha": "0.1"})
        assert resp.status_code == 200, payload
        out["queued"] = payload
        out["ids"]["planted"] = payload["job_id"]
        app.runner.join(300)
        out["fields"] = call(app, "GET", "/vectors/fields.geojson")
        out["metadata"] = call(app, "GET", "/api/vectors/metadata")[1]
        resp, payload = call(app, "POST", "/api/vectors", json_body={})
        assert resp.status_code == 200, payload
        out["ids"]["found"] = payload["job_id"]
        out["found_queued"] = payload
        app.runner.join(300)
        out["status"] = {k: call(app, "GET", f"/api/vectors/{v}")[1]
                         for k, v in out["ids"].items()}
        runs.append(out)
    return runs


def _geojson(resp) -> dict:
    g = json.loads(resp.body)
    g["properties"].pop("generated_at")
    for f in g["features"]:
        f["properties"].pop("created_at")
    return g


@pytest.mark.parametrize("job", ["planted", "found"])
def test_vector_job_record_matches_jax(apps, scenario, vector_runs, job):
    """Through both apps on the same data: equal job records (wall-clock
    fields dropped, data dir and ids normalised); the planted raster
    yields fields, the raster search finds the WOW output."""
    (jax_app, app, _), (jrun, run) = apps, vector_runs
    jids = {**scenario[0]["ids"], **jrun["ids"]}
    ids = {**scenario[1]["ids"], **run["ids"]}
    want = normalize(jrun["status"][job], jax_app, jids)
    got = normalize(run["status"][job], app, ids)
    assert got == want and got["status"] == "completed"
    if job == "planted":
        assert got["result"]["feature_count"] > 0
    else:
        assert got["raster_paths"] == ["<data>/wow/vectors_probe/planted_wow.tif"]
        assert (normalize(run["found_queued"], app, ids)
                == normalize(jrun["found_queued"], jax_app, jids))


def test_vector_geojson_and_metadata_match_jax(apps, vector_runs):
    (jax_app, app, _), (jrun, run) = apps, vector_runs
    (jresp, _), (resp, _) = jrun["fields"], run["fields"]
    assert resp.status_code == jresp.status_code == 200
    assert resp.headers == jresp.headers
    assert resp.headers["Content-Type"] == "application/geo+json"
    got, want = _geojson(resp), _geojson(jresp)
    assert got == want and got["properties"]["feature_count"] > 0
    strip = [normalize(r["metadata"], a, r["ids"])
             for a, r in ((app, run), (jax_app, jrun))]
    for m in strip:
        m["metadata"].pop("stage_timings_s")
        m["properties"].pop("generated_at")
    assert strip[0] == strip[1]
