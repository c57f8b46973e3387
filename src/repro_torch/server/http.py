"""Stdlib-only asyncio HTTP/1.1 + SSE transport for the serving front door.

Twin of ``repro/server/http.py``: the same routes, status codes and JSON
shapes.  No aiohttp/uvicorn dependency, so this is a deliberately small
HTTP server over ``asyncio.start_server`` streams, serving four routes:

``POST /generate``
    Body: ``{"prompt": [token ids], "max_new": N, "seed": S?,
    "tenant": "name"?, "stream": true?}``.  With ``stream`` (the default)
    the response is ``text/event-stream`` and tokens are flushed as the
    batched scheduler decodes them::

        event: token
        data: {"index": 0, "token": 1234}

        event: done
        data: {"request_id": 7, "tenant": "default", "tokens": [...],
               "energy_j": ..., "ttft_s": ..., "latency_s": ...,
               "preemptions": 0}

    With ``"stream": false`` the server waits and returns one JSON body
    (the ``done`` payload).  Errors: 400 (malformed/unservable request),
    429 (front-door queue full — load shedding), 503 (shutting down).

``GET /stats``
    JSON: scheduler :class:`~repro_torch.serving.ServeStats` (including
    ``j_per_token`` / ``tokens_per_sec``), per-tenant admission state
    (energy buckets, fairness counters), the recent admission decisions
    and — when telemetry is on — the full metrics-registry snapshot
    under ``"metrics"``.

``GET /metrics``
    Prometheus text exposition (format 0.0.4) of the shared
    :class:`repro_torch.obs.MetricsRegistry`: decode-step latency histograms,
    TTFT/TPOT, page-pool occupancy, admission decisions, device clock,
    GDC gain, energy counters.  404 when the front door was built with
    ``enable_telemetry=False``.

``GET /healthz``
    ``{"ok": true}`` liveness probe.

Connections are ``Connection: close`` — one exchange per connection keeps
the parser trivial and makes the SSE end-of-stream unambiguous.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from repro_torch.obs import render_prometheus
from repro_torch.server.frontdoor import FrontDoor, QueueFull

MAX_BODY = 8 * 1024 * 1024
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable"}


def _response(status: int, body: bytes, content_type: str) -> bytes:
    return (
        f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\n"
        "Connection: close\r\n\r\n"
    ).encode() + body


def _json_response(status: int, payload: Dict[str, Any]) -> bytes:
    return _response(status, json.dumps(payload).encode(), "application/json")


def _sse_event(event: str, payload: Dict[str, Any]) -> bytes:
    return f"event: {event}\ndata: {json.dumps(payload)}\n\n".encode()


async def _read_request(reader: asyncio.StreamReader
                        ) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
    """Parse one HTTP/1.1 request: (method, path, headers, body)."""
    try:
        line = await reader.readline()
    except (ConnectionError, asyncio.IncompleteReadError):
        return None
    if not line:
        return None
    parts = line.decode("latin-1").strip().split()
    if len(parts) < 2:
        return None
    method, path = parts[0].upper(), parts[1]
    headers: Dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", "0") or "0")
    if n > MAX_BODY:
        return method, path, headers, b""
    body = await reader.readexactly(n) if n else b""
    return method, path, headers, body


class HttpFrontDoor:
    """The HTTP/SSE server wrapping one :class:`FrontDoor`.

    Use as an async context manager (tests) or via :meth:`serve_forever`
    (the ``repro_torch/launch/serve.py --http`` CLI)::

        async with HttpFrontDoor(front, host="127.0.0.1", port=0) as srv:
            ...  # srv.port is the bound port
    """

    def __init__(self, front: FrontDoor, *, host: str = "127.0.0.1",
                 port: int = 8000):
        self.front = front
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        await self.front.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        await self.front.stop()

    async def __aenter__(self) -> "HttpFrontDoor":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def serve_forever(self) -> None:
        await self.start()
        try:
            await self._server.serve_forever()
        finally:
            await self.stop()

    # -- request handling ----------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            parsed = await _read_request(reader)
            if parsed is None:
                return
            method, path, _headers, body = parsed
            if path == "/healthz" and method == "GET":
                writer.write(_json_response(200, {"ok": True}))
            elif path == "/stats" and method == "GET":
                writer.write(_json_response(200, self.front.stats_dict()))
            elif path == "/metrics" and method == "GET":
                if self.front.obs is None:
                    writer.write(_json_response(
                        404, {"error": "telemetry disabled"}))
                else:
                    text = render_prometheus(self.front.obs.metrics)
                    writer.write(_response(
                        200, text.encode(),
                        "text/plain; version=0.0.4; charset=utf-8"))
            elif path == "/generate":
                if method != "POST":
                    writer.write(_json_response(
                        405, {"error": "POST /generate"}))
                else:
                    await self._generate(writer, body)
            else:
                writer.write(_json_response(404, {"error": f"no route {path}"}))
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _generate(self, writer: asyncio.StreamWriter, body: bytes) -> None:
        try:
            payload = json.loads(body.decode() or "{}")
            prompt = payload["prompt"]
            max_new = int(payload.get("max_new", 16))
            seed = payload.get("seed")
            tenant = str(payload.get("tenant", "default"))
            stream = bool(payload.get("stream", True))
            if not isinstance(prompt, list):
                raise ValueError("prompt must be a list of token ids")
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            writer.write(_json_response(400, {"error": f"bad request: {e}"}))
            return
        try:
            ts = await self.front.submit(
                prompt, max_new, seed=None if seed is None else int(seed),
                tenant=tenant)
        except QueueFull as e:
            writer.write(_json_response(429, {"error": str(e)}))
            return
        except ValueError as e:
            writer.write(_json_response(400, {"error": str(e)}))
            return
        if not stream:
            try:
                await ts.tokens()
            except RuntimeError as e:
                writer.write(_json_response(503, {"error": str(e)}))
                return
            writer.write(_json_response(200, _done_payload(ts)))
            return
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n")
        await writer.drain()
        index = 0
        try:
            async for tok in ts:
                writer.write(_sse_event("token", {"index": index, "token": tok}))
                await writer.drain()
                index += 1
        except RuntimeError as e:  # front door failed/shut down mid-stream
            writer.write(_sse_event("error", {"error": str(e)}))
            return
        writer.write(_sse_event("done", _done_payload(ts)))


def _done_payload(ts) -> Dict[str, Any]:
    res = ts.result
    if res is None:  # stream drained before the pump attached the result
        return {"request_id": ts.request_id}
    return dataclasses.asdict(res)


async def read_sse(reader: asyncio.StreamReader
                   ) -> AsyncIterator[Tuple[str, Dict[str, Any]]]:
    """Client-side SSE parser: yields (event, payload) until the peer
    closes.  Skips the HTTP response headers first — feed it the reader of
    a connection that just sent ``POST /generate``."""
    while True:  # response headers
        line = await reader.readline()
        if not line or line in (b"\r\n", b"\n"):
            break
    event, data = None, None
    while True:
        line = await reader.readline()
        if not line:
            return
        line = line.decode().rstrip("\n").rstrip("\r")
        if not line:
            if event is not None and data is not None:
                yield event, json.loads(data)
            event, data = None, None
        elif line.startswith("event:"):
            event = line[len("event:"):].strip()
        elif line.startswith("data:"):
            data = line[len("data:"):].strip()


async def http_request(host: str, port: int, method: str, path: str,
                       body: Optional[Dict[str, Any]] = None) -> bytes:
    """Client side: one exchange over a fresh connection (``body`` sent
    as JSON); returns the raw response, headers included."""
    data = b"" if body is None else json.dumps(body).encode()
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write((f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
                      f"Content-Length: {len(data)}\r\n\r\n").encode()
                     + data)
        await writer.drain()
        return await reader.read()
    finally:
        writer.close()
        await writer.wait_closed()


async def generate(host: str, port: int, body: Dict[str, Any]
                   ) -> Tuple[List[int], Optional[Dict[str, Any]],
                              Optional[str]]:
    """Client side: ``POST /generate`` with ``body`` and read its SSE
    stream -> (token ids in order, the ``done`` payload or None, the
    ``error`` event's message or None)."""
    data = json.dumps(body).encode()
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write((f"POST /generate HTTP/1.1\r\nHost: {host}\r\n"
                      f"Content-Length: {len(data)}\r\n\r\n").encode()
                     + data)
        await writer.drain()
        toks: List[int] = []
        done = error = None
        async for ev, payload in read_sse(reader):
            if ev == "token":
                if payload["index"] != len(toks):
                    raise ValueError(f"SSE token {payload['index']} after "
                                     f"{len(toks)} tokens")
                toks.append(payload["token"])
            elif ev == "done":
                done = payload
            elif ev == "error":
                error = payload["error"]
        return toks, done, error
    finally:
        writer.close()
        await writer.wait_closed()
