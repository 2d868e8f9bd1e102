"""Pure-ASGI application over :class:`SeparatorService`.

The port's own copy of ``audio_separator_tpu/remote/asgi.py``; presets come
from the port's own ``data/ensemble_presets.json``.

The reference serves its remote API through FastAPI apps embedded in the
Modal / Cloud Run deploy scripts (ref: remote/deploy_modal.py:539-830,
remote/deploy_cloudrun.py:385-700). This adapter exposes the same endpoint
surface as a dependency-free ASGI callable, so ANY ASGI server or platform
can host it — `uvicorn audio_separator_tpu_torch.remote.asgi:app` locally, or
a gunicorn+uvicorn worker on a platform. The service's device is the CUDA
device unless ``create_app(device="cpu")`` asks for the CPU.

Endpoints (reference-parity):
  POST /separate                      multipart upload (or gcs_uri field)
  GET  /status/{task_id}
  GET  /download/{task_id}/{file_hash}
  GET  /models        /models-json    model listings
  GET  /presets                       ensemble presets
  GET  /health        /               service info
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional
from urllib.parse import quote, unquote

from ..separator.registry import _load_data_json
from ..separator.separator import Separator
from .server import SeparatorService, _fetch_gcs, _parse_multipart, check_api_key

logger = logging.getLogger(__name__)


def _load_presets() -> dict:
    return _load_data_json("ensemble_presets.json")


class AsgiApp:
    """Minimal ASGI 3.0 application; one instance wraps one service."""

    def __init__(self, service: Optional[SeparatorService] = None,
                 **service_kwargs):
        self._service = service
        self._service_kwargs = service_kwargs

    @property
    def service(self) -> SeparatorService:
        # Lazy: platform entry points import this module at build time where
        # spinning up the worker thread / work dir would be wasted.
        if self._service is None:
            self._service = SeparatorService(**self._service_kwargs)
        return self._service

    async def __call__(self, scope, receive, send):
        if scope["type"] == "lifespan":
            while True:
                message = await receive()
                if message["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif message["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
            return
        if scope["type"] != "http":
            raise RuntimeError(f"unsupported ASGI scope {scope['type']!r}")

        method = scope["method"]
        path = unquote(scope["path"]) or "/"
        headers = {k.decode("latin-1").lower(): v.decode("latin-1")
                   for k, v in scope.get("headers", [])}

        try:
            if method == "GET":
                await self._get(path, headers, send)
            elif method == "POST":
                await self._post(path, headers, receive, send)
            else:
                await _json(send, {"detail": "Method not allowed"}, 405)
        except Exception as exc:  # request-level isolation
            logger.exception("request failed")
            await _json(send, {"detail": str(exc)}, 500)

    # ------------------------------------------------------------------ GET

    async def _get(self, path, headers, send):
        from .. import __version__

        if path in ("", "/"):
            await _json(send, {
                "service": "audio-separator-tpu-torch",
                "version": __version__,
                "endpoints": ["/separate", "/status/{task_id}",
                              "/download/{task_id}/{file_hash}", "/models",
                              "/models-json", "/presets", "/health"],
            })
        elif path == "/health":
            await _json(send, {"status": "healthy", "version": __version__})
        elif path == "/models-json":
            await _json(send, await asyncio.to_thread(self._list_models, True))
        elif path == "/models":
            await _json(send, await asyncio.to_thread(self._list_models, False))
        elif path == "/presets":
            await _json(send, _load_presets())
        elif path.startswith("/status/"):
            if not _authorized(headers):
                await _json(send, {"detail": "invalid or missing API key"}, 401)
                return
            data = await asyncio.to_thread(
                self.service.get_status, path[len("/status/"):])
            if data is None:
                await _json(send, {"detail": "Job not found"}, 404)
            else:
                await _json(send, data)
        elif path.startswith("/download/"):
            if not _authorized(headers):
                await _json(send, {"detail": "invalid or missing API key"}, 401)
                return
            parts = path[len("/download/"):].split("/")
            if len(parts) != 2:
                await _json(send, {"detail": "File not found"}, 404)
                return
            try:
                data, name = await asyncio.to_thread(
                    self.service.get_file_by_hash, parts[0], parts[1])
            except FileNotFoundError:
                await _json(send, {"detail": "File not found"}, 404)
                return
            ascii_name = "".join(c if ord(c) < 128 else "_" for c in name)
            await _respond(send, data, 200, [
                (b"content-type", b"application/octet-stream"),
                (b"content-disposition",
                 f"attachment; filename=\"{ascii_name}\"; "
                 f"filename*=UTF-8''{quote(name, safe='')}".encode("latin-1")),
            ])
        else:
            await _json(send, {"detail": "Not found"}, 404)

    def _list_models(self, as_json: bool):
        """Blocking model-registry read — always called via
        ``asyncio.to_thread`` so a slow registry/network merge can't stall
        the event loop (and /health) for every other client."""
        separator = Separator(info_only=True,
                              model_file_dir=self.service.model_file_dir)
        if as_json:
            return separator.list_supported_model_files()
        return separator.get_simplified_model_list()

    # ----------------------------------------------------------------- POST

    async def _post(self, path, headers, receive, send):
        if path != "/separate":
            await _json(send, {"detail": "Not found"}, 404)
            return
        if not _authorized(headers):
            await _json(send, {"detail": "invalid or missing API key"}, 401)
            return
        body = b""
        while True:
            message = await receive()
            body += message.get("body", b"")
            if not message.get("more_body"):
                break
        content_type = headers.get("content-type", "")
        if "multipart/form-data" not in content_type:
            await _json(send, {"detail": "multipart/form-data required"}, 400)
            return
        try:
            # Multipart parse and job submission both touch disk (and the GCS
            # fetch is a full object download) — keep them off the event loop
            # so concurrent /health probes stay responsive mid-upload.
            fields, files = await asyncio.to_thread(
                _parse_multipart, content_type, body)
        except Exception as exc:
            await _json(send, {"detail": f"invalid multipart body: {exc}"}, 400)
            return
        upload = files.get("file")
        if not upload or not upload[0]:
            gcs_uri = fields.get("gcs_uri")
            if gcs_uri:
                try:
                    filename, file_bytes = await asyncio.to_thread(
                        _fetch_gcs, gcs_uri)
                except PermissionError as exc:
                    await _json(send, {"detail": str(exc)}, 403)
                    return
                except Exception as exc:
                    await _json(send,
                                {"detail": f"could not fetch {gcs_uri}: {exc}"},
                                400)
                    return
                task_id = await asyncio.to_thread(
                    self.service.submit, filename, file_bytes, fields)
                await _json(send, {"task_id": task_id, "status": "queued"})
                return
            await _json(send, {"detail": "No audio file provided"}, 400)
            return
        filename, file_bytes = upload
        task_id = await asyncio.to_thread(
            self.service.submit, filename, file_bytes, fields)
        await _json(send, {"task_id": task_id, "status": "queued"})


def _authorized(headers: dict) -> bool:
    # One auth implementation for both HTTP frontends (server.check_api_key);
    # the ASGI layer lowercased the header names when building the dict.
    return check_api_key(lambda name: headers.get(name.lower()))


async def _respond(send, body: bytes, status: int, headers):
    await send({"type": "http.response.start", "status": status,
                "headers": [*headers,
                            (b"content-length", str(len(body)).encode())]})
    await send({"type": "http.response.body", "body": body})


async def _json(send, obj, status: int = 200):
    await _respond(send, json.dumps(obj).encode(), status,
                   [(b"content-type", b"application/json")])


def create_app(service: Optional[SeparatorService] = None,
               **service_kwargs) -> AsgiApp:
    return AsgiApp(service, **service_kwargs)


# Module-level default for `uvicorn audio_separator_tpu_torch.remote.asgi:app`
# (lazy service construction — imports stay cheap).
app = create_app()
