"""The HTTP API application: the port of ``s2sr_tpu/server/app.py``.

The same routes, request fields, status codes, ``detail`` strings, job
messages and job-record fields as the JAX server; jobs run on the
lock-guarded store and the device-owning FIFO runner
(:mod:`.jobs`, :mod:`.persistence`). Request bodies are validated by
hand-written dataclass specs with pydantic's lax coercions
(:mod:`..utils.validation`: the card's machine has no pydantic); a 422's
``detail`` names the field at fault.

The job routes run the port's SR (``realesrgan_x4``: every residual
dense block in ``csrc/rdb.cu``), the WOW and farm chains and the tile
pyramid on ``device`` (``cuda`` unless the caller passes ``"cpu"``).
Handlers never touch the device; the runner thread does, and builds the
first engine there.

The pipeline's fetch (STAC search, COG range reads, the AOI clip on
``device``; ``fetch/``) runs on the runner too. The vector job segments
on ``device`` (``vectors/``), on the same runner thread. The QR/serial scan (``/api/decode``, ``decode/``)
binarizes on ``device`` in the handler's worker thread, and its SR
retry runs the ``realesrgan_x4`` engine on the runner.

Routes: /health /metrics /api/runtime /api/config /api/metadata
/tiles* /api/sr* /api/wow /api/enhance /api/decode /api/pipeline*
/vectors/* /api/vectors* + SPA fallback: the JAX server's table, whole
and in order.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Optional
from uuid import uuid4

import numpy as np

from .. import native
from ..config import Settings, get_settings
from ..fetch.smart_fetch import ensure_best_image
from ..models.engine import get_engine, loaded_engines, resolve_device
from ..pipelines.farm_sr import process_farm_sr
from ..pipelines.io import decode_upload, load_rgb
from ..pipelines.wow_sr import MODEL_DISPLAY, process_wow_sr
from ..tiles import process_raster_to_tiles
from ..utils import find_latest_metadata, read_json, setup_logging
from ..utils.validation import ValidationError, VectorRequest, parse
from .http import (
    App,
    BackgroundTasks,
    HTTPException,
    Request,
    Response,
    file_response,
    json_response,
)
from .jobs import JobRunner
from .persistence import DurableJobStore

logger = setup_logging("s2sr_tpu_torch.server")


def _new_job_id(prefix: str = "") -> str:
    """Timestamp-prefixed (clients expect it) + uniqueness suffix so two
    requests in the same second cannot collide on one job record."""
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    return f"{prefix}{ts}_{uuid4().hex[:6]}"


TILE_HEADERS = {
    "Cache-Control": "public, max-age=86400",
    "Access-Control-Allow-Origin": "*",
}

GEOJSON_HEADERS = {
    "Cache-Control": "public, max-age=3600",
    "Access-Control-Allow-Origin": "*",
}


# --- request specs (the JAX server's pydantic models) ------------------

@dataclass
class SRRequest:
    input_file: Optional[str] = None
    scale: int = 4
    model: str = "edsr"


@dataclass
class WowRequest:
    input_file: Optional[str] = None
    enhance_crops: bool = True
    auto_fetch: bool = True
    max_age_days: int = 30
    max_cloud_cover: float = 30.0
    force_fetch: bool = False
    # "default" follows Settings.sr_dtype; "bfloat16"/"float32" pin the
    # engine dtype; "int8"/"turbo" select the int8-mixed trunk
    precision: str = "default"


VALID_PRECISIONS = ("default", "bfloat16", "float32", "int8", "turbo")


def _normalize_precision(precision: str) -> str:
    if precision not in VALID_PRECISIONS:
        raise HTTPException(
            400, f"Invalid precision. Choose from: {list(VALID_PRECISIONS)}")
    return "int8" if precision == "turbo" else precision


@dataclass
class PipelineRequest:
    max_age_days: int = 30
    max_cloud_cover: float = 30.0
    force_fetch: bool = False
    generate_original_tiles: bool = True
    min_zoom: int = 10
    max_zoom: int = 16
    run_sr: bool = True
    sr_type: str = "wow"
    enhance_crops: bool = True


def _validate(spec, request: Request):
    body = request.json() or {}
    if not isinstance(body, dict):
        # a JSON array/string/number parses fine but cannot populate a
        # request spec: 422 like FastAPI, not a TypeError-driven 500
        raise HTTPException(
            422, f"body must be a JSON object, got {type(body).__name__}")
    try:
        return parse(spec, body)
    except ValidationError as exc:
        raise HTTPException(422, str(exc))


def create_app(settings: Optional[Settings] = None,
               static_dir: Optional[Path] = None,
               device: str = "cuda"):
    """The app over ``settings`` (default :func:`get_settings`); its jobs
    run on ``device``, which must exist (no fallback to the CPU)."""
    settings = settings or get_settings()
    device = str(resolve_device(device))
    app = App(title="Sentinel-2 Super-Resolution (PyTorch)", version="2.0.0")

    data_dir = Path(settings.data_dir)
    tiles_dir = data_dir / "tiles"
    source_dir = data_dir / "source"
    vectors_dir = data_dir / "vectors"
    if static_dir is None:
        static_dir = Path("static")
        if not static_dir.exists():
            # fall back to the client bundled next to the package
            static_dir = Path(__file__).resolve().parent.parent.parent / "static"

    jobs = DurableJobStore(data_dir / "jobs.jsonl")
    runner = JobRunner(jobs, max_concurrent=settings.max_concurrent_enhance)
    app.jobs = jobs          # exposed for tests / introspection
    app.runner = runner
    app.settings = settings
    app.on_shutdown(runner.stop)   # mark queued jobs, drain workers
    app.on_shutdown(jobs.close)

    # ------------------------------------------------------------------
    # basics
    # ------------------------------------------------------------------

    @app.get("/health")
    async def health_check():
        return {"status": "healthy", "service": "up42-sentinel-poc"}

    _device_cache: list = []

    @app.get("/api/runtime")
    async def get_runtime():
        """Runtime surface: device inventory, job counts, queue depth, and
        the PNG encoder in use (``native`` or ``pure``, with the reason)."""

        def _list_devices():
            if not device.startswith("cuda"):
                return [{"id": 0, "platform": "cpu", "kind": "cpu"}]
            import torch

            try:
                return [{"id": i, "platform": "gpu",
                         "kind": torch.cuda.get_device_name(i)}
                        for i in range(torch.cuda.device_count())]
            except (RuntimeError, AssertionError) as exc:
                return [{"error": str(exc)}]

        # naming the devices initialises CUDA: never on the event loop;
        # the inventory is immutable, cache it
        if not _device_cache:
            devices = await asyncio.to_thread(_list_devices)
            if not any("error" in d for d in devices):
                _device_cache.append(devices)
        else:
            devices = _device_cache[0]
        # the first call may build the encoder: off the event loop
        encoder = await asyncio.to_thread(native.png_encoder)
        by_status = jobs.count_by_status()
        return {
            "devices": devices,
            **encoder,
            "jobs_total": sum(by_status.values()),
            "jobs_by_status": by_status,
            "runner_active": runner.active_count,
            "runner_queued": runner.queued_count,
            "max_concurrent": runner.max_concurrent,
        }

    _started_at = time.monotonic()

    @app.get("/metrics")
    async def get_metrics():
        """Prometheus text-format scrape endpoint. Gauges only, derived
        from the durable job store and runner; no extra bookkeeping on
        the hot path."""
        by_status = jobs.count_by_status()
        lines = [
            "# HELP s2sr_uptime_seconds Server uptime.",
            "# TYPE s2sr_uptime_seconds gauge",
            f"s2sr_uptime_seconds {time.monotonic() - _started_at:.1f}",
            "# HELP s2sr_jobs Jobs in the durable store by status.",
            "# TYPE s2sr_jobs gauge",
        ]
        lines += [
            f's2sr_jobs{{status="{s}"}} {n}'
            for s, n in sorted(by_status.items())
        ]
        lines += [
            "# HELP s2sr_runner_active Jobs currently executing.",
            "# TYPE s2sr_runner_active gauge",
            f"s2sr_runner_active {runner.active_count}",
            "# HELP s2sr_runner_queued Jobs waiting for a device slot.",
            "# TYPE s2sr_runner_queued gauge",
            f"s2sr_runner_queued {runner.queued_count}",
            "# HELP s2sr_runner_max_concurrent Device slots.",
            "# TYPE s2sr_runner_max_concurrent gauge",
            f"s2sr_runner_max_concurrent {runner.max_concurrent}",
        ]
        return Response(body=("\n".join(lines) + "\n").encode(),
                        media_type="text/plain; version=0.0.4")

    @app.get("/api/config")
    async def get_config():
        return {
            "mapboxAccessToken": settings.mapbox_access_token,
            "tileMinZoom": settings.tile_min_zoom,
            "tileMaxZoom": settings.tile_max_zoom,
            "defaultCenter": [-121.487, 36.836],
            "defaultZoom": 12,
        }

    @app.get("/api/metadata")
    async def get_metadata():
        result: dict = {}
        tileset_path = tiles_dir / "tileset.json"
        result["tileset"] = read_json(tileset_path) if tileset_path.exists() else None
        result["source"] = find_latest_metadata(source_dir)
        result["tilesAvailable"] = (
            tileset_path.exists() and any(tiles_dir.glob("*/*/*.png"))
            if tiles_dir.exists() else False
        )
        sr_tiles = data_dir / "tiles_sr"
        result["srTilesAvailable"] = sr_tiles.exists() and any(sr_tiles.glob("*/*/*.png"))
        wow_tiles = data_dir / "tiles_wow"
        result["wowTilesAvailable"] = wow_tiles.exists() and any(wow_tiles.glob("*/*/*.png"))
        result["tileEndpoints"] = {
            "original": "/tiles/{z}/{x}/{y}.png",
            "sr": "/tiles_sr/{z}/{x}/{y}.png",
            "wow": "/tiles_wow/{z}/{x}/{y}.png",
        }
        fields_path = vectors_dir / "fields.geojson"
        zones_path = vectors_dir / "zones.geojson"
        result["vectorsAvailable"] = fields_path.exists()
        result["zonesAvailable"] = zones_path.exists()
        if result["vectorsAvailable"]:
            result["vectorEndpoints"] = {"fields": "/vectors/fields.geojson"}
            if result["zonesAvailable"]:
                result["vectorEndpoints"]["zones"] = "/vectors/zones.geojson"
        # degraded-mode visibility: models on random init (weights
        # absent) are exposed, not just logged
        models: dict = {}
        for e in loaded_engines():
            entry = {
                "pretrained": e.pretrained, "scale": e.scale,
                # the halo-exactness probe's outcome: the effective pad and
                # the tiled-vs-whole float margin in output LSBs (null =
                # probe not applicable)
                "tile_pad": e.tile_pad,
                "halo_margin_lsb": e.halo_margin_lsb,
                "precision": e.precision,
            }
            # one model can be resident at several precisions at once:
            # suffix-key the extras, never clobber
            key = e.model_name
            if key in models:
                key = f"{key}:{entry['precision']}"
            models[key] = entry
        result["models"] = models
        return result

    def _serve_tile(base: Path, z: int, x: int, y: int, kind: str) -> Response:
        tile_path = base / str(z) / str(x) / f"{y}.png"
        if not tile_path.exists():
            raise HTTPException(404, f"{kind} not found")
        return file_response(tile_path, media_type="image/png",
                             headers=TILE_HEADERS)

    @app.get("/tiles/{z}/{x}/{y}.png")
    async def get_tile(z: int, x: int, y: int):
        return _serve_tile(tiles_dir, z, x, y, "Tile")

    @app.get("/tiles_sr/{z}/{x}/{y}.png")
    async def get_sr_tile(z: int, x: int, y: int):
        return _serve_tile(data_dir / "tiles_sr", z, x, y, "SR tile")

    @app.get("/tiles_wow/{z}/{x}/{y}.png")
    async def get_wow_tile(z: int, x: int, y: int):
        return _serve_tile(data_dir / "tiles_wow", z, x, y, "WOW tile")

    # ------------------------------------------------------------------
    # job bodies
    # ------------------------------------------------------------------

    def run_sr_job(job_id: str, input_file: Path, scale: int, model: str,
                   output_dir: Path) -> None:
        try:
            jobs.update(job_id, status="processing",
                        message=f"Applying {model.upper()} x{scale} super-resolution...")
            result = process_farm_sr(
                input_tif=input_file, output_dir=output_dir, scale=scale,
                weights_dir=settings.weights_dir, device=device,
            )
            jobs.update(job_id, status="tiling",
                        message="Generating tiles from SR image...")
            sr_tif = result["outputs"].get("sr_tif")
            if sr_tif and Path(sr_tif).exists():
                sr_tiles_dir = data_dir / "tiles_sr"
                process_raster_to_tiles(
                    input_path=Path(sr_tif), tiles_dir=sr_tiles_dir,
                    min_zoom=settings.tile_min_zoom,
                    max_zoom=min(settings.tile_max_zoom + 2, 20),
                    device=device,
                )
                result["tiles_dir"] = str(sr_tiles_dir)
            jobs.update(job_id, status="completed",
                        message="Super-resolution complete!", result=result)
        except Exception as exc:
            logger.error("SR job %s failed: %s", job_id, exc)
            jobs.update(job_id, status="failed", message=str(exc))

    def run_wow_job(job_id: str, input_file: Optional[Path], output_dir: Path,
                    enhance_crops: bool, auto_fetch: bool = True,
                    max_age_days: int = 30, max_cloud_cover: float = 30.0,
                    force_fetch: bool = False,
                    model: str = "realesrgan_x4",
                    precomputed_sr=None,
                    precision: str = "default") -> None:
        try:
            if input_file is None and auto_fetch:
                jobs.update(job_id, status="fetching",
                            message=f"🔍 Finding best image (last {max_age_days} "
                                    f"days, cloud ≤{max_cloud_cover}%)...")
                input_file, fetch_metadata = ensure_best_image(
                    source_dir=source_dir, max_age_days=max_age_days,
                    max_cloud_cover=max_cloud_cover, force_fetch=force_fetch,
                    settings=settings, device=device,
                )
                jobs.update(
                    job_id, input_file=str(input_file),
                    fetch_metadata=fetch_metadata,
                    message=f"✅ Using: {input_file.name} "
                            f"(cloud: {fetch_metadata.get('cloud_cover_pct', 'N/A')}%)")

            model_display = MODEL_DISPLAY.get(model, model)
            jobs.update(job_id, status="processing",
                        message=f"Stage 1/2: {model_display} (GAN upscaling)...")
            result = process_wow_sr(
                input_tif=input_file, output_dir=output_dir,
                enhance_crops=enhance_crops, model=model,
                weights_dir=settings.weights_dir,
                precomputed_sr=precomputed_sr,
                precision=precision, device=device,
            )
            jobs.update(job_id, status="tiling",
                        message="Generating tiles from WOW SR image...")
            sr_tif = result["outputs"].get("sr_tif")
            if sr_tif and Path(sr_tif).exists():
                wow_tiles_dir = data_dir / "tiles_wow"
                process_raster_to_tiles(
                    input_path=Path(sr_tif), tiles_dir=wow_tiles_dir,
                    min_zoom=settings.tile_min_zoom,
                    max_zoom=min(settings.tile_max_zoom + 2, 20),
                    device=device,
                )
                result["tiles_dir"] = str(wow_tiles_dir)
            jobs.update(job_id, status="completed",
                        message="WOW Super-resolution complete! 🌟",
                        result=result)
        except Exception as exc:
            logger.error("WOW job %s failed: %s", job_id, exc)
            jobs.update(job_id, status="failed", message=str(exc))

    def run_wow_jobs_coalesced(items: list) -> None:
        """Batch-coalesced enhance jobs: the runner hands us N queued
        same-model uploads; the SR stage runs as ONE pooled window batch
        on the device, then each job finishes independently (enhancement
        chain, artifacts, tiles, status)."""
        model = items[0][1]["model"]
        precision = items[0][1].get("precision", "default")
        engine_kwargs = ({"dtype": precision}
                         if precision != "default" else {})
        loaded = {}
        # one bad upload must fail ONLY its own job: load per job,
        # coalesce the rest
        good = []
        for job_id, p in items:
            jobs.update(job_id, status="processing",
                        coalesced=len(items),
                        message=f"Stage 1/2: batched GAN upscaling "
                                f"({len(items)} jobs coalesced)...")
            try:
                loaded[job_id] = load_rgb(p["input_file"])[0]
                good.append((job_id, p))
            except Exception as exc:
                logger.error("coalesced job %s: bad input: %s", job_id, exc)
                jobs.update(job_id, status="failed", message=str(exc))
        if not good:
            return
        srs = {}
        try:
            engine = get_engine(model, weights_dir=settings.weights_dir,
                                device=device, **engine_kwargs)
            imgs = [np.asarray(loaded[j]) for j, _ in good]
            outs = engine.enhance_serving_many(imgs)
            if len(outs) != len(good):  # defensive: never mis-pair jobs
                raise RuntimeError(
                    f"batch returned {len(outs)} outputs for {len(good)} jobs")
            srs = {j: o for (j, _), o in zip(good, outs)}
        except Exception as exc:
            logger.error("coalesced SR stage failed: %s", exc)
            for job_id, _ in good:
                jobs.update(job_id, status="failed", message=str(exc))
            return
        for job_id, p in good:
            run_wow_job(job_id, Path(p["input_file"]), Path(p["output_dir"]),
                        True, auto_fetch=False, model=model,
                        precomputed_sr=srs[job_id], precision=precision)

    # ------------------------------------------------------------------
    # SR routes
    # ------------------------------------------------------------------

    @app.post("/api/sr")
    async def start_super_resolution(request: Request,
                                     background_tasks: BackgroundTasks):
        body = _validate(SRRequest, request)
        if body.input_file:
            input_file = Path(body.input_file)
        else:
            tifs = sorted(source_dir.glob("*.tif"),
                          key=lambda x: x.stat().st_mtime, reverse=True)
            if not tifs:
                raise HTTPException(404, "No GeoTIFF files found. Run fetch first.")
            input_file = tifs[0]
        if not input_file.exists():
            raise HTTPException(404, f"Input file not found: {input_file}")
        if body.scale not in (2, 3, 4):
            raise HTTPException(400, "Scale must be 2, 3, or 4")
        if body.model not in ("edsr", "espcn", "lapsrn"):
            raise HTTPException(400, "Model must be edsr, espcn, or lapsrn")

        job_id = _new_job_id()
        output_dir = data_dir / "sr" / job_id
        output_dir.mkdir(parents=True, exist_ok=True)
        jobs.create(job_id, status="queued", message="Job queued",
                    input_file=str(input_file), scale=body.scale,
                    model=body.model, output_dir=str(output_dir))
        background_tasks.add_task(
            runner.submit, job_id,
            lambda: run_sr_job(job_id, input_file, body.scale, body.model,
                               output_dir))
        return {"job_id": job_id, "status": "queued",
                "message": f"SR job started: {input_file.name} → x{body.scale}"}

    @app.get("/api/sr/download/{job_id}/{filename}")
    async def download_sr_file(job_id: str, filename: str):
        job = jobs.get(job_id)
        if job is None:
            raise HTTPException(404, "Job not found")
        if not job.get("output_dir"):
            # pipeline/vector jobs (and restored journal records) carry
            # no download dir — that's a 404, not a KeyError 500
            raise HTTPException(404, "Job has no downloadable files")
        out_dir = Path(job["output_dir"]).resolve()
        file_path = (out_dir / filename).resolve()
        # containment check: the route pattern already refuses path
        # separators, but never trust a stored/joined path for serving
        if out_dir not in file_path.parents:
            raise HTTPException(404, "File not found")
        if not file_path.is_file():
            raise HTTPException(404, "File not found")
        return file_response(file_path)

    @app.get("/api/sr/{job_id}")
    async def get_sr_status(job_id: str):
        job = jobs.get(job_id)
        if job is None:
            raise HTTPException(404, "Job not found")
        return job

    @app.get("/api/sr")
    async def list_sr_jobs():
        return {"jobs": jobs.all()}

    # ------------------------------------------------------------------
    # WOW + enhance
    # ------------------------------------------------------------------

    @app.post("/api/wow")
    async def start_wow_sr(request: Request, background_tasks: BackgroundTasks):
        body = _validate(WowRequest, request)
        precision = _normalize_precision(body.precision)
        input_file: Optional[Path] = None
        if body.input_file:
            input_file = Path(body.input_file)
            if not input_file.exists():
                raise HTTPException(404, f"Input file not found: {input_file}")
        elif not body.auto_fetch:
            tifs = sorted(source_dir.glob("*.tif"),
                          key=lambda x: x.stat().st_mtime, reverse=True)
            if not tifs:
                raise HTTPException(
                    404, "No GeoTIFF files found. Enable auto_fetch=true or "
                         "run fetch first.")
            input_file = tifs[0]

        job_id = _new_job_id("wow_")
        output_dir = data_dir / "wow" / job_id
        output_dir.mkdir(parents=True, exist_ok=True)
        jobs.create(
            job_id, status="queued",
            message="WOW job queued (Real-ESRGAN x4 + Enhanced)",
            input_file=str(input_file) if input_file else "auto_fetch",
            pipeline="RealESRGAN_x4 + Enhanced", scale=4,
            enhance_crops=body.enhance_crops, auto_fetch=body.auto_fetch,
            max_age_days=body.max_age_days,
            max_cloud_cover=body.max_cloud_cover,
            precision=precision,
            output_dir=str(output_dir))
        background_tasks.add_task(
            runner.submit, job_id,
            lambda: run_wow_job(job_id, input_file, output_dir,
                                body.enhance_crops, body.auto_fetch,
                                body.max_age_days, body.max_cloud_cover,
                                body.force_fetch,
                                precision=precision))
        if input_file:
            msg = f"🌟 WOW SR started: {input_file.name} → Real-ESRGAN x4 + Enhanced"
        else:
            msg = (f"🌟 WOW SR started: auto-fetching best image "
                   f"(last {body.max_age_days}d, cloud ≤{body.max_cloud_cover}%)")
        return {"job_id": job_id, "status": "queued", "message": msg}

    @app.post("/api/enhance")
    async def enhance_image_upload(request: Request):
        fields, files = request.multipart()
        model = fields.get("model", "realesrgan_x4")
        valid_models = ["realesrgan_x4", "realesrgan_anime"]
        if model not in valid_models:
            raise HTTPException(400, f"Invalid model. Choose from: {valid_models}")
        precision = _normalize_precision(fields.get("precision", "default"))
        if "image" not in files:
            raise HTTPException(400, "missing 'image' upload field")
        upload = files["image"]
        if len(upload.content) > settings.max_upload_bytes:
            raise HTTPException(
                413, f"Upload exceeds maximum allowed size of "
                     f"{settings.max_upload_bytes // (1024 * 1024)} MB")

        job_id = _new_job_id("wow_")
        output_dir = data_dir / "wow" / job_id
        upload_dir = data_dir / "uploads" / job_id
        output_dir.mkdir(parents=True, exist_ok=True)
        upload_dir.mkdir(parents=True, exist_ok=True)
        # Client-supplied filenames are untrusted: keep only the basename
        # and refuse hidden/empty names (pathlib would honour absolute
        # paths and ../ segments otherwise).
        safe_name = Path(upload.filename or "").name
        if not safe_name or safe_name.startswith("."):
            safe_name = "upload"
        uploaded_path = upload_dir / safe_name
        uploaded_path.write_bytes(upload.content)

        # submit synchronously: capacity is observed atomically with the
        # enqueue (a pre-submit has_capacity + deferred submit lets two
        # rapid uploads both report "processing" on a 1-slot runner)
        jobs.create(job_id, status="queued",
                    message="Queued due to concurrency limits",
                    input_file=str(uploaded_path), output_dir=str(output_dir),
                    model=model, precision=precision)
        started = runner.submit(
            job_id,
            lambda: run_wow_job(job_id, uploaded_path, output_dir, True,
                                auto_fetch=False, model=model,
                                precision=precision),
            # precision is part of the coalesce identity: an int8-turbo
            # job must never batch through a bfloat16 engine (or vice
            # versa) just because the model name matches
            coalesce_key=("enhance", model, precision),
            payload={"input_file": str(uploaded_path),
                     "output_dir": str(output_dir), "model": model,
                     "precision": precision},
            many_fn=run_wow_jobs_coalesced)
        status, message = "queued", "Queued due to concurrency limits"
        if started:
            status, message = "processing", "Enhancement starting"
            # CAS: never stomp the worker if it already picked the job up
            jobs.update_if(job_id, "queued", status=status, message=message)
        return {"job_id": job_id, "status": status, "message": message,
                "model": model, "precision": precision}

    @app.post("/api/decode")
    async def decode_scan_upload(request: Request):
        """QR/serial scan with SR-enhance retry — server-side port of the
        reference client's jsQR/Tesseract flow
        (`enhance.component.ts:251-359`, `qr-ocr.service.ts`)."""
        fields, files = request.multipart()
        if "image" not in files:
            raise HTTPException(400, "missing 'image' upload field")
        upload = files["image"]
        if len(upload.content) > settings.max_upload_bytes:
            raise HTTPException(
                413, f"Upload exceeds maximum allowed size of "
                     f"{settings.max_upload_bytes // (1024 * 1024)} MB")
        from ..decode.service import decode_with_retry

        try:
            img = decode_upload(upload.content, upload.filename or "upload")
        except Exception:
            raise HTTPException(400, "could not decode uploaded image")
        if img.shape[0] * img.shape[1] > 16_000_000:
            raise HTTPException(413, "image too large to scan (>16 MPix)")

        enhance_fn = None
        if fields.get("enhance_retry", "true").lower() != "false":
            def enhance_fn(arr):
                def _on_device():
                    # the job paths' engine-cache key, and the bucketed
                    # serving path
                    engine = get_engine("realesrgan_x4",
                                        weights_dir=settings.weights_dir,
                                        device=device)
                    return engine.enhance_serving(arr)

                # device work goes through the runner (sole device
                # owner) — never concurrently with a running job; on a
                # busy runner the wait bounds out and decode keeps its
                # first-pass answer
                return runner.run_sync(_on_device, timeout=240.0,
                                       label="decode_sr")

        # the scan (host locating, optional OCR, possibly an SR retry) is
        # heavy — run it off the event loop so job polling and tile
        # serving stay responsive
        result = await asyncio.to_thread(
            decode_with_retry, img, enhance_fn=enhance_fn, device=device)
        result["filename"] = Path(upload.filename or "").name or "upload"
        return result

    # ------------------------------------------------------------------
    # vectors
    # ------------------------------------------------------------------

    def run_vector_extraction_job(job_id: str, aoi_path: Path,
                                  raster_paths: list, config_dict: dict) -> None:
        try:
            jobs.update(job_id, status="processing",
                        message="Extracting field boundaries...")
            from ..vectors.extraction import ExtractionConfig, extract_field_polygons

            config = ExtractionConfig(
                ndvi_threshold=config_dict.get("ndvi_threshold", 0.3),
                min_area_ha=config_dict.get("min_area_ha", 0.1),
                max_area_ha=config_dict.get("max_area_ha", 500.0),
                simplify_tolerance_m=config_dict.get("simplify_tolerance_m", 5.0),
            )
            result = extract_field_polygons(
                aoi_geojson=aoi_path, raster_paths=raster_paths,
                out_dir=vectors_dir, config=config, device=device,
            )
            jobs.update(
                job_id, status="completed",
                message=f"Extracted {result['feature_count']} field polygons",
                result={
                    "feature_count": result["feature_count"],
                    "output_path": result["output_path"],
                    "source_method": result["source_method"],
                })
        except Exception as exc:
            logger.error("Vector extraction job %s failed: %s", job_id, exc)
            jobs.update(job_id, status="failed", message=str(exc))

    @app.get("/vectors/fields.geojson")
    async def get_fields_geojson():
        fields_path = vectors_dir / "fields.geojson"
        if not fields_path.exists():
            raise HTTPException(
                404, "Field vectors not found. Run vector extraction first: "
                     "make vectors")
        return json_response(read_json(fields_path), headers={
            **GEOJSON_HEADERS, "Content-Type": "application/geo+json"})

    @app.get("/vectors/zones.geojson")
    async def get_zones_geojson():
        zones_path = vectors_dir / "zones.geojson"
        if not zones_path.exists():
            raise HTTPException(
                404, "Management zones not found. Run v2 vector extraction "
                     "with --zones")
        return json_response(read_json(zones_path), headers={
            **GEOJSON_HEADERS, "Content-Type": "application/geo+json"})

    @app.get("/api/vectors/metadata")
    async def get_vectors_metadata():
        fields_path = vectors_dir / "fields.geojson"
        metadata_path = vectors_dir / "extraction_metadata.json"
        result = {
            "vectorsAvailable": fields_path.exists(),
            "endpoint": "/vectors/fields.geojson",
        }
        if metadata_path.exists():
            result["metadata"] = read_json(metadata_path)
        if fields_path.exists():
            try:
                geojson = read_json(fields_path)
                result["featureCount"] = len(geojson.get("features", []))
                result["properties"] = geojson.get("properties", {})
            except Exception as exc:
                logger.warning("Failed to read fields.geojson: %s", exc)
        return result

    @app.post("/api/vectors")
    async def start_vector_extraction(request: Request,
                                      background_tasks: BackgroundTasks):
        body = _validate(VectorRequest, request)
        if body.aoi_path:
            aoi_path = Path(body.aoi_path)
        else:
            aoi_path = Path(settings.aoi_path)
        if not aoi_path.exists():
            raise HTTPException(404, f"AOI file not found: {aoi_path}")

        raster_paths: list = []
        if body.raster_path:
            raster_paths.append(Path(body.raster_path))
        else:
            # the rasters the job routes write: wow, then sr, then the
            # source scene, newest first
            for search_dir in (data_dir / "wow", data_dir / "sr", source_dir):
                if search_dir.exists():
                    tifs = sorted(search_dir.rglob("*.tif"),
                                  key=lambda x: x.stat().st_mtime, reverse=True)
                    if tifs:
                        raster_paths.append(tifs[0])
                        break
        if not raster_paths:
            raise HTTPException(
                404, "No raster files found. Run the pipeline or specify "
                     "raster_path.")

        job_id = _new_job_id("vectors_")
        config = {
            "ndvi_threshold": body.ndvi_threshold,
            "min_area_ha": body.min_area_ha,
            "max_area_ha": body.max_area_ha,
            "simplify_tolerance_m": body.simplify_tolerance_m,
        }
        jobs.create(job_id, status="queued",
                    message="Vector extraction queued",
                    aoi_path=str(aoi_path),
                    raster_paths=[str(p) for p in raster_paths],
                    config=config)
        background_tasks.add_task(
            runner.submit, job_id,
            lambda: run_vector_extraction_job(job_id, aoi_path, raster_paths,
                                              config))
        return {"job_id": job_id, "status": "queued",
                "message": f"Vector extraction started from {raster_paths[0].name}"}

    @app.get("/api/vectors/{job_id}")
    async def get_vector_job_status(job_id: str):
        job = jobs.get(job_id)
        if job is None:
            raise HTTPException(404, "Job not found")
        return job

    # ------------------------------------------------------------------
    # pipeline
    # ------------------------------------------------------------------

    def run_pipeline_job(job_id: str, body: PipelineRequest) -> None:
        try:
            steps_completed: list = []

            jobs.update(job_id, status="fetching", current_step=1,
                        message=f"📡 Step 1/4: Finding best image (last "
                                f"{body.max_age_days} days, cloud "
                                f"≤{body.max_cloud_cover}%)...")
            input_file, fetch_metadata = ensure_best_image(
                source_dir=source_dir, max_age_days=body.max_age_days,
                max_cloud_cover=body.max_cloud_cover,
                force_fetch=body.force_fetch, settings=settings,
                device=device,
            )
            jobs.update(job_id, input_file=str(input_file),
                        fetch_metadata=fetch_metadata)
            steps_completed.append({
                "step": 1, "name": "fetch", "status": "completed",
                "message": f"✅ Image: {input_file.name}",
                "details": {
                    "file": str(input_file),
                    "cloud_cover": fetch_metadata.get("cloud_cover_pct"),
                    "acquisition_date": fetch_metadata.get("acquisition_date"),
                },
            })

            if body.generate_original_tiles:
                jobs.update(job_id, status="tiling_original", current_step=2,
                            message="🗺️ Step 2/4: Generating original tiles...")
                tiles_metadata = process_raster_to_tiles(
                    input_path=input_file, tiles_dir=tiles_dir,
                    min_zoom=body.min_zoom, max_zoom=body.max_zoom,
                    device=device,
                )
                steps_completed.append({
                    "step": 2, "name": "original_tiles", "status": "completed",
                    "message": f"✅ Tiles generated (z{body.min_zoom}-{body.max_zoom})",
                    "details": tiles_metadata,
                })
            else:
                steps_completed.append({
                    "step": 2, "name": "original_tiles", "status": "skipped",
                    "message": "⏭️ Skipped (generate_original_tiles=false)",
                })

            sr_output = None
            if body.run_sr:
                jobs.update(job_id, status="processing_sr", current_step=3,
                            message=f"🚀 Step 3/4: Running "
                                    f"{body.sr_type.upper()} super-resolution...")
                output_dir = data_dir / "sr" / job_id
                output_dir.mkdir(parents=True, exist_ok=True)
                if body.sr_type == "wow":
                    sr_result = process_wow_sr(
                        input_tif=input_file, output_dir=output_dir,
                        enhance_crops=body.enhance_crops,
                        weights_dir=settings.weights_dir, device=device,
                    )
                else:
                    sr_result = process_farm_sr(
                        input_tif=input_file, output_dir=output_dir, scale=4,
                        weights_dir=settings.weights_dir, device=device,
                    )
                sr_output = sr_result["outputs"].get("sr_tif")
                steps_completed.append({
                    "step": 3, "name": "super_resolution", "status": "completed",
                    "message": f"✅ SR complete ({body.sr_type.upper()} x4)",
                    "details": {"output": sr_output, "scale": 4,
                                "type": body.sr_type},
                })
            else:
                steps_completed.append({
                    "step": 3, "name": "super_resolution", "status": "skipped",
                    "message": "⏭️ Skipped (run_sr=false)",
                })

            if body.run_sr and sr_output and Path(sr_output).exists():
                jobs.update(job_id, status="tiling_sr", current_step=4,
                            message="🗺️ Step 4/4: Generating SR tiles...")
                sr_tiles_dir = (data_dir / "tiles_wow" if body.sr_type == "wow"
                                else data_dir / "tiles_sr")
                sr_tiles_metadata = process_raster_to_tiles(
                    input_path=Path(sr_output), tiles_dir=sr_tiles_dir,
                    min_zoom=body.min_zoom,
                    max_zoom=min(body.max_zoom + 2, 20),
                    device=device,
                )
                steps_completed.append({
                    "step": 4, "name": "sr_tiles", "status": "completed",
                    "message": f"✅ SR tiles generated "
                               f"(z{body.min_zoom}-{min(body.max_zoom + 2, 20)})",
                    "details": sr_tiles_metadata,
                })
            elif body.run_sr:
                steps_completed.append({
                    "step": 4, "name": "sr_tiles", "status": "failed",
                    "message": "❌ SR output not found",
                })
            else:
                steps_completed.append({
                    "step": 4, "name": "sr_tiles", "status": "skipped",
                    "message": "⏭️ Skipped (SR not run)",
                })

            jobs.update(job_id, status="completed", current_step=4,
                        message="🎉 Pipeline complete!", steps=steps_completed,
                        completed_at=datetime.now().isoformat())
        except Exception as exc:
            logger.error("Pipeline job %s failed: %s", job_id, exc)
            jobs.update(job_id, status="failed",
                        message=f"❌ Failed: {exc}", error=str(exc))

    @app.post("/api/pipeline")
    async def start_pipeline(request: Request,
                             background_tasks: BackgroundTasks):
        body = _validate(PipelineRequest, request)
        job_id = _new_job_id("pipeline_")
        jobs.create(job_id, status="queued", current_step=0,
                    message="🚀 Pipeline queued...",
                    config=dataclasses.asdict(body), steps=[])
        background_tasks.add_task(runner.submit, job_id,
                                  lambda: run_pipeline_job(job_id, body))
        return {
            "job_id": job_id, "status": "queued",
            "message": f"🚀 Pipeline started: Fetch → Tiles → "
                       f"{body.sr_type.upper()} SR → SR Tiles",
            "steps": ["fetch", "original_tiles", "super_resolution", "sr_tiles"],
        }

    @app.get("/api/pipeline/{job_id}")
    async def get_pipeline_status(job_id: str):
        job = jobs.get(job_id)
        if job is None:
            raise HTTPException(404, "Job not found")
        return job

    @app.get("/api/pipelines")
    async def list_pipelines():
        pipeline_jobs = jobs.with_prefix("pipeline_")
        return {"jobs": pipeline_jobs, "count": len(pipeline_jobs)}

    # ------------------------------------------------------------------
    # SPA fallback
    # ------------------------------------------------------------------

    @app.get("/{full_path:path}")
    async def serve_spa(full_path: str):
        # Containment check: the transport unquotes the path before
        # routing, so "../" traversal must be rejected here.
        static_root = static_dir.resolve()
        try:
            static_path = (static_dir / full_path).resolve()
        except (OSError, ValueError):
            raise HTTPException(404, "Not found")
        if not static_path.is_relative_to(static_root):
            raise HTTPException(404, "Not found")
        try:
            is_file = static_path.exists() and static_path.is_file()
        except OSError:          # e.g. ENAMETOOLONG from a hostile path
            raise HTTPException(404, "Not found")
        if is_file:
            return file_response(static_path)
        index_path = static_dir / "index.html"
        if index_path.exists():
            return file_response(index_path)
        return json_response({
            "message": "UP42 Sentinel-2 POC Server",
            "endpoints": {
                "health": "/health",
                "config": "/api/config",
                "metadata": "/api/metadata",
                "tiles": "/tiles/{z}/{x}/{y}.png",
            },
            "note": "Build Angular client and place in static/ for web UI",
        })

    return app


def start_server(device: str = "cuda") -> None:
    from .http import run

    settings = get_settings()
    app = create_app(settings, device=device)
    run(app, host=settings.server_host, port=settings.server_port)


if __name__ == "__main__":
    start_server()
