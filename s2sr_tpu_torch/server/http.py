"""Minimal asyncio HTTP/1.1 framework (FastAPI-shaped, zero deps).

The port's copy of ``s2sr_tpu/server/http.py``: a small asyncio-native
server with the pieces the API surface needs:

- route decorators with ``{param}`` path captures (int-coerced on demand),
- JSON bodies (handlers validate them, :mod:`..utils.validation`),
- multipart/form-data parsing (the ``/api/enhance`` upload),
- JSON / file / bytes responses with header control,
- ``HTTPException(status_code, detail)`` with FastAPI's error shape,
- permissive CORS headers,
- background tasks that run after the response is sent.

Single-process, single event loop; heavy work belongs on the job runner
thread (see :mod:`.jobs`), never in handlers.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import mimetypes
import re
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

from ..utils import setup_logging

logger = setup_logging("s2sr_tpu_torch.http")

_STATUS_TEXT = {
    200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
    404: "Not Found", 405: "Method Not Allowed", 413: "Payload Too Large",
    422: "Unprocessable Entity", 500: "Internal Server Error",
}


class HTTPException(Exception):
    def __init__(self, status_code: int, detail: str = ""):
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail


@dataclass
class UploadFile:
    filename: str
    content_type: str
    content: bytes


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, str]
    headers: Dict[str, str]
    body: bytes
    path_params: Dict[str, str] = field(default_factory=dict)

    def json(self) -> Any:
        try:
            return json.loads(self.body or b"{}")
        except json.JSONDecodeError as exc:
            raise HTTPException(400, f"invalid JSON body: {exc}")

    def multipart(self) -> Tuple[Dict[str, str], Dict[str, UploadFile]]:
        """Parse multipart/form-data → (fields, files)."""
        ctype = self.headers.get("content-type", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            raise HTTPException(400, "missing multipart boundary")
        boundary = b"--" + m.group(1).encode()
        fields: Dict[str, str] = {}
        files: Dict[str, UploadFile] = {}
        for part in self.body.split(boundary):
            # Strip exactly the one CRLF framing the boundary on each side;
            # a blanket strip(b"\r\n") would eat trailing 0x0D/0x0A bytes
            # that belong to binary payloads (TIFF uploads truncate).
            if part in (b"", b"\r\n") or part.startswith(b"--"):
                continue
            part = part.removeprefix(b"\r\n")
            header_blob, _, content = part.partition(b"\r\n\r\n")
            content = content.removesuffix(b"\r\n")
            headers = header_blob.decode("utf-8", "replace")
            # (?<![\w-]) keeps this from matching the 'name="..."' tail
            # of 'filename="..."' — RFC 7578 does not fix parameter
            # order, so filename may precede name
            name_m = re.search(r'(?<![\w-])name="([^"]+)"', headers)
            if not name_m:
                continue
            name = name_m.group(1)
            file_m = re.search(r'filename="([^"]*)"', headers)
            if file_m:
                ct_m = re.search(r"Content-Type:\s*([^\r\n]+)", headers, re.I)
                files[name] = UploadFile(
                    filename=file_m.group(1) or "upload",
                    content_type=ct_m.group(1).strip() if ct_m else "application/octet-stream",
                    content=content,
                )
            else:
                fields[name] = content.decode("utf-8", "replace")
        return fields, files


@dataclass
class Response:
    body: bytes = b""
    status_code: int = 200
    media_type: str = "application/json"
    headers: Dict[str, str] = field(default_factory=dict)
    # large-file serving: when set, the transport streams this file in
    # chunks instead of materialising it in `body` (a full-res x4 SR
    # GeoTIFF is hundreds of MB — read_bytes() per download would spike
    # RSS by the file size and stall the single event loop)
    stream_path: Optional[Path] = None
    stream_length: int = 0

    def content_length(self) -> int:
        return self.stream_length if self.stream_path is not None \
            else len(self.body)


def json_response(content: Any, status_code: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(
        body=json.dumps(content).encode(),
        status_code=status_code,
        media_type="application/json",
        headers=headers or {},
    )


_STREAM_THRESHOLD = 8 * 1024 * 1024   # buffer small files, stream big


def file_response(path: Path | str, media_type: Optional[str] = None,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    path = Path(path)
    if not path.exists():
        raise HTTPException(404, "File not found")
    if media_type is None:
        media_type = mimetypes.guess_type(str(path))[0] or "application/octet-stream"
    size = path.stat().st_size
    if size > _STREAM_THRESHOLD:
        return Response(media_type=media_type, headers=headers or {},
                        stream_path=path, stream_length=size)
    return Response(
        body=path.read_bytes(), media_type=media_type, headers=headers or {}
    )


class BackgroundTasks:
    """Run-after-response task list (FastAPI semantics)."""

    def __init__(self) -> None:
        self.tasks: List[Tuple[Callable, tuple, dict]] = []

    def add_task(self, fn: Callable, *args, **kwargs) -> None:
        self.tasks.append((fn, args, kwargs))


_PARAM_RE = re.compile(r"{([a-zA-Z_][a-zA-Z0-9_]*)(:path)?}")


def _compile_path(pattern: str) -> re.Pattern:
    regex = ""
    pos = 0
    for m in _PARAM_RE.finditer(pattern):
        regex += re.escape(pattern[pos:m.start()])
        if m.group(2):  # {name:path}
            regex += f"(?P<{m.group(1)}>.*)"
        else:
            regex += f"(?P<{m.group(1)}>[^/]+)"
        pos = m.end()
    regex += re.escape(pattern[pos:])
    return re.compile(f"^{regex}$")


@dataclass
class Route:
    method: str
    pattern: re.Pattern
    handler: Callable[..., Awaitable]
    raw_path: str
    # handler signature, computed once at registration: dispatch runs
    # per request and inspect.signature() builds fresh Signature/
    # Parameter objects each call
    sig: inspect.Signature = None


class App:
    """Route registry + request dispatcher."""

    def __init__(self, title: str = "", version: str = "") -> None:
        self.title = title
        self.version = version
        self.routes: List[Route] = []
        self.shutdown_hooks: List[Callable[[], Any]] = []

    def on_shutdown(self, fn: Callable[[], Any]) -> Callable[[], Any]:
        """Register a callback to run when :func:`serve` exits (uvicorn's
        lifespan shutdown: in-flight jobs get marked and the runner
        drains)."""
        self.shutdown_hooks.append(fn)
        return fn

    def _register(self, method: str, path: str):
        def deco(fn):
            self.routes.append(Route(method, _compile_path(path), fn, path,
                                     sig=inspect.signature(fn)))
            return fn
        return deco

    def get(self, path: str):
        return self._register("GET", path)

    def post(self, path: str):
        return self._register("POST", path)

    async def dispatch(self, request: Request) -> Tuple[Response, Optional[BackgroundTasks]]:
        allowed: set = set()
        for route in self.routes:
            m = route.pattern.match(request.path)
            if not m:
                continue
            if route.method != request.method:
                allowed.add(route.method)
                continue
            # NOTE: no second unquote here — the transport already
            # percent-decoded the path once (``_handle_connection``);
            # decoding again would let double-encoded ``..%252f`` smuggle
            # path separators into single-segment params (traversal).
            request.path_params = dict(m.groupdict())
            background: Optional[BackgroundTasks] = None
            try:
                kwargs: Dict[str, Any] = {}
                sig = route.sig or inspect.signature(route.handler)
                for name, param in sig.parameters.items():
                    # handlers live under `from __future__ import
                    # annotations`, so annotations arrive as STRINGS —
                    # compare against both the type and its name
                    anno = param.annotation
                    if name == "request":
                        kwargs[name] = request
                    elif (anno is BackgroundTasks or anno == "BackgroundTasks"
                          or name == "background_tasks"):
                        background = BackgroundTasks()
                        kwargs[name] = background
                    elif name in request.path_params:
                        value = request.path_params[name]
                        if anno is int or anno == "int":
                            try:
                                value = int(value)
                            except ValueError:
                                # FastAPI's 422 validation shape
                                return json_response({"detail": [{
                                    "loc": ["path", name],
                                    "msg": "value is not a valid integer",
                                    "type": "type_error.integer",
                                }]}, 422), None
                        kwargs[name] = value
                    elif name in request.query:
                        kwargs[name] = request.query[name]
                result = await route.handler(**kwargs)
                if isinstance(result, Response):
                    return result, background
                return json_response(result), background
            except HTTPException as exc:
                return json_response({"detail": exc.detail}, exc.status_code), None
            except Exception as exc:  # pragma: no cover - defensive
                logger.error("handler error on %s %s: %s\n%s", request.method,
                             request.path, exc, traceback.format_exc())
                # never echo internal exception text to the client
                return json_response({"detail": "Internal Server Error"}, 500), None
        if allowed:
            return json_response(
                {"detail": "Method Not Allowed"}, 405,
                headers={"Allow": ", ".join(sorted(allowed))}), None
        return json_response({"detail": "Not Found"}, 404), None


_CORS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "*",
    "Access-Control-Allow-Headers": "*",
}


async def _handle_connection(app: App, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
    try:
        while True:
            try:
                request_line = await asyncio.wait_for(reader.readline(), timeout=75)
            except asyncio.TimeoutError:
                break
            if not request_line or request_line == b"\r\n":
                break
            try:
                method, target, _version = request_line.decode().split()
            except ValueError:
                break
            headers: Dict[str, str] = {}
            while True:
                # headers get the same read timeout as the request line
                # (slowloris: a stalled client must not pin the task),
                # and a hard count cap (the 256 MB transport cap below
                # only bounds the body)
                line = await asyncio.wait_for(reader.readline(), timeout=75)
                if line in (b"\r\n", b"\n", b""):
                    break
                if len(headers) >= 256:
                    raise ValueError("too many request headers")
                key, _, value = line.decode("latin1").partition(":")
                headers[key.strip().lower()] = value.strip()
            if "chunked" in headers.get("transfer-encoding", "").lower():
                # chunked bodies are not implemented — refuse loudly
                # instead of silently treating the body as empty
                writer.write(
                    b"HTTP/1.1 501 Not Implemented\r\n"
                    b"Content-Length: 0\r\nConnection: close\r\n\r\n")
                await writer.drain()
                break
            try:
                length = int(headers.get("content-length", 0))
            except ValueError:
                writer.write(
                    b"HTTP/1.1 400 Bad Request\r\n"
                    b"Content-Length: 0\r\nConnection: close\r\n\r\n")
                await writer.drain()
                break
            if length < 0:
                length = 0
            if length > 256 * 1024 * 1024:  # hard transport cap (routes
                # apply their own tighter limits, e.g. the 50 MB upload)
                writer.write(
                    b"HTTP/1.1 413 Payload Too Large\r\n"
                    b"Content-Length: 0\r\nConnection: close\r\n\r\n")
                await writer.drain()
                break
            body = await reader.readexactly(length) if length else b""

            split = urlsplit(target)
            request = Request(
                # HEAD is served through the GET route (Starlette
                # semantics); the body is suppressed on the wire below
                method="GET" if method == "HEAD" else method,
                path=unquote(split.path),
                query=dict(parse_qsl(split.query)),
                headers=headers,
                body=body,
            )
            if method == "OPTIONS":
                response, background = Response(status_code=204), None
            else:
                response, background = await app.dispatch(request)

            extra = {**_CORS, **response.headers}
            # a route-supplied Content-Type (e.g. application/geo+json)
            # REPLACES the default — never emit two conflicting ones
            ctype = response.media_type
            for k in list(extra):
                if k.lower() == "content-type":
                    ctype = extra.pop(k)
            head = (
                f"HTTP/1.1 {response.status_code} "
                f"{_STATUS_TEXT.get(response.status_code, 'OK')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {response.content_length()}\r\n"
            )
            for k, v in extra.items():
                head += f"{k}: {v}\r\n"
            # RFC 9110: Connection tokens are case-insensitive
            keep_alive = headers.get("connection", "keep-alive").lower() != "close"
            head += f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n"
            if method == "HEAD" or response.stream_path is None:
                writer.write(head.encode() +
                             (b"" if method == "HEAD" else response.body))
                await writer.drain()
            else:
                # chunked file streaming with backpressure: exactly the
                # advertised byte count, even if the file grows mid-send
                writer.write(head.encode())
                remaining = response.stream_length
                with open(response.stream_path, "rb") as f:
                    while remaining > 0:
                        chunk = f.read(min(remaining, 1 << 18))
                        if not chunk:      # truncated under us: bail —
                            break          # the client sees a short read
                        remaining -= len(chunk)
                        writer.write(chunk)
                        await writer.drain()
                if remaining > 0:
                    break                  # close: never pad a short file
                await writer.drain()

            if background is not None:
                for fn, args, kwargs in background.tasks:
                    if inspect.iscoroutinefunction(fn):
                        asyncio.get_running_loop().create_task(fn(*args, **kwargs))
                    else:
                        asyncio.get_running_loop().run_in_executor(
                            None, lambda f=fn, a=args, k=kwargs: f(*a, **k))
            if not keep_alive:
                break
    except (ConnectionResetError, asyncio.IncompleteReadError,
            asyncio.TimeoutError, asyncio.LimitOverrunError, ValueError):
        # timeouts, oversized header lines (readline raises ValueError
        # past the 64 KB stream limit) and header floods end the
        # connection quietly instead of killing the task with a traceback
        pass
    finally:
        try:
            writer.close()
            await writer.wait_closed()
        except Exception:
            pass


async def serve(app: App, host: str = "0.0.0.0", port: int = 8080,
                stop: Optional[asyncio.Event] = None,
                ready: Optional[asyncio.Event] = None) -> None:
    """Run the server until cancelled or ``stop`` is set — then shut
    down *cleanly*: stop accepting, close idle/active connections, and
    run the app's shutdown hooks (which mark in-flight jobs). Safe to
    cancel at any point; never leaves the listening socket open.
    """
    conn_tasks: set[asyncio.Task] = set()

    def handler(r: asyncio.StreamReader, w: asyncio.StreamWriter):
        task = asyncio.current_task()
        if task is not None:
            conn_tasks.add(task)
            task.add_done_callback(conn_tasks.discard)
        return _handle_connection(app, r, w)

    server = await asyncio.start_server(handler, host, port)
    logger.info("Serving %s on %s:%d", app.title, host, port)
    if ready is not None:
        ready.set()
    try:
        if stop is None:
            async with server:
                await server.serve_forever()
        else:
            async with server:
                await stop.wait()
    finally:
        server.close()
        for t in list(conn_tasks):
            t.cancel()
        if conn_tasks:
            await asyncio.gather(*conn_tasks, return_exceptions=True)
        try:
            await server.wait_closed()
        except Exception:  # pragma: no cover - platform quirks
            pass
        for hook in app.shutdown_hooks:
            try:
                result = hook()
                if inspect.isawaitable(result):
                    await result
            except Exception as exc:  # noqa: BLE001 — best-effort teardown
                logger.error("shutdown hook failed: %s", exc)
        logger.info("Server %s stopped cleanly", app.title)


def run(app: App, host: str = "0.0.0.0", port: int = 8080) -> None:
    asyncio.run(serve(app, host, port))
