"""OpenAI-compatible HTTP proxy over the asyncio serving driver.

Stdlib only (the container pins its dependency set): a hand-rolled
HTTP/1.1 server on ``asyncio.start_server`` — keep-alive, chunked
transfer for SSE streaming, no TLS.  Endpoints:

  POST /v1/chat/completions   OpenAI chat completions.  ``stream: true``
                              returns SSE ``chat.completion.chunk``
                              events (chunked encoding).  Headers:
                                X-Session-Id  sticky client session —
                                              later requests are hinted
                                              to the engine whose pool
                                              holds the session's KV
                                X-Task-Id     runtime session id
                                              (generated if absent)
                                X-Program-Id  AgentProgram identity for
                                              AEG pattern stats
                                X-Tenant      AFS tenant (or body
                                              ``user``, or "default")
                              Body extension ``saga``: {"tool_gap_s":
                              float, "step_tokens": int, "slo_s": float}
                              — multi-turn bodies become multi-step
                              programs that park on tool gaps between
                              user turns.
  GET  /v1/requests/{sid}     TrackedRequest lifecycle JSON.
  GET  /metrics               Prometheus text: per-engine queue depth,
                              KV pool occupancy, handoff bytes, AFS
                              deviation + runtime counters, via the
                              ``repro_torch.obs`` registry (merged with the
                              runtime's own traced registry when on).
  GET  /healthz               liveness + phase counts.

Prompts are tokenized with the same FNV-1a fold the workflow layer uses
for deterministic prompt realization; completions detokenize to
``tok<id>`` words.  The model is the repo's micro LM — the surface is
the point, not the prose.
"""
from __future__ import annotations

import asyncio
import itertools
import json
from typing import Dict, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.frontend.strategies import Strategy, get_strategy
from repro_torch.serving.frontend.tracker import RequestTracker
from repro_torch.workflow.program import AgentProgram, StepSpec, _fnv1a

_MAX_BODY = 4 << 20
_MAX_HEADERS = 64


def tokenize(text: str, vocab: int) -> list:
    """Deterministic word → token-id fold (FNV-1a, id in [1, vocab))."""
    return [1 + _fnv1a(w) % (vocab - 1) for w in text.split()]


def detokenize(ids) -> str:
    return " ".join(f"tok{int(i)}" for i in ids)


def program_from_body(body: dict, *, program_id: str, tenant: str,
                      vocab: int, seed: int = 0) -> AgentProgram:
    """Compile an OpenAI chat body to a scripted ``AgentProgram``.

    Each ``user`` turn opens a workflow step whose prompt is every
    message since the previous step; steps are separated by a tool gap
    (``saga.tool_gap_s``) so a multi-turn body exercises park/resume.
    Intermediate steps decode ``saga.step_tokens`` tokens, the final
    step ``max_tokens``."""
    msgs = body.get("messages") or []
    saga = body.get("saga") or {}
    max_tokens = int(body.get("max_tokens") or 16)
    gap_s = float(saga.get("tool_gap_s", 0.05))
    step_tokens = int(saga.get("step_tokens", min(8, max_tokens)))
    prompts, buf = [], []
    for m in msgs:
        buf.extend(tokenize(str(m.get("content", "")), vocab))
        if m.get("role") == "user":
            prompts.append(buf)
            buf = []
    if buf:
        if prompts:
            prompts[-1] = prompts[-1] + buf
        else:
            prompts.append(buf)
    if not prompts:
        prompts = [[1]]
    steps = [StepSpec(tool="http", prompt_ids=p or [1],
                      n_out=(max_tokens if i == len(prompts) - 1
                             else step_tokens),
                      tool_latency_s=(0.0 if i == len(prompts) - 1
                                      else gap_s))
             for i, p in enumerate(prompts)]
    return AgentProgram.scripted(program_id, tenant, steps, seed=seed)


# -- minimal HTTP/1.1 plumbing ------------------------------------------

class _HTTPError(Exception):
    def __init__(self, status: int, msg: str) -> None:
        super().__init__(msg)
        self.status = status


async def _read_request(reader) -> Optional[Tuple[str, str, Dict[str, str],
                                                  bytes]]:
    """One request off a keep-alive connection; None on clean EOF."""
    line = await reader.readline()
    if not line:
        return None
    try:
        method, target, _ = line.decode("latin-1").split(None, 2)
    except ValueError:
        raise _HTTPError(400, "malformed request line")
    headers: Dict[str, str] = {}
    for _ in range(_MAX_HEADERS):
        raw = await reader.readline()
        if raw in (b"\r\n", b"\n", b""):
            break
        if b":" not in raw:
            raise _HTTPError(400, "malformed header")
        k, v = raw.decode("latin-1").split(":", 1)
        headers[k.strip().lower()] = v.strip()
    else:
        raise _HTTPError(431, "too many headers")
    n = int(headers.get("content-length", 0) or 0)
    if n > _MAX_BODY:
        raise _HTTPError(413, "body too large")
    body = await reader.readexactly(n) if n else b""
    return method, target, headers, body


_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            431: "Request Header Fields Too Large",
            500: "Internal Server Error", 503: "Service Unavailable"}


def _response_bytes(status: int, body: bytes, ctype: str,
                    extra: Optional[Dict[str, str]] = None,
                    *, keep_alive: bool = True) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
             f"Content-Type: {ctype}",
             f"Content-Length: {len(body)}",
             "Connection: " + ("keep-alive" if keep_alive else "close")]
    for k, v in (extra or {}).items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


class SagaHTTPProxy:
    """Serves OpenAI-compatible traffic into an ``AsyncServingDriver``.

    ``strategy`` names a registered load balancer (or pass a
    ``Strategy`` instance).  Known ``X-Session-Id``s override the
    strategy with a hint to the session's KV home engine, so a sticky
    client session parks and resumes where its cache lives."""

    def __init__(self, driver, *, strategy="saga-affinity",
                 host: str = "127.0.0.1", port: int = 0,
                 model_name: str = "saga-micro",
                 stream_poll_s: float = 0.01) -> None:
        self.driver = driver
        self.strategy: Strategy = (get_strategy(strategy)
                                   if isinstance(strategy, str)
                                   else strategy)
        self.host, self.port = host, port
        self.model_name = model_name
        self.stream_poll_s = stream_poll_s
        self.tracker = RequestTracker(driver.wall_now)
        driver.add_listener(self._on_event)
        self.metrics = MetricsRegistry()
        self.homes: Dict[str, int] = {}        # X-Session-Id -> engine
        self._seq = itertools.count()
        self._server: Optional[asyncio.AbstractServer] = None

    # -- lifecycle -------------------------------------------------------
    async def start(self) -> "SagaHTTPProxy":
        self._server = await asyncio.start_server(self._handle_conn,
                                                  self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- driver listener -------------------------------------------------
    def _on_event(self, t: float, kind: str, args: tuple) -> None:
        self.tracker.observe(self.driver.rt)
        # remember each client session's KV home as soon as it lands
        for tr in self.tracker.live.values():
            if tr.engine >= 0 and tr.client_session:
                self.homes[tr.client_session] = tr.engine

    # -- connection handling ---------------------------------------------
    async def _handle_conn(self, reader, writer) -> None:
        try:
            while True:
                try:
                    req = await _read_request(reader)
                except _HTTPError as e:
                    writer.write(_response_bytes(
                        e.status, json.dumps({"error": str(e)}).encode(),
                        "application/json", keep_alive=False))
                    await writer.drain()
                    break
                if req is None:
                    break
                method, target, headers, body = req
                keep = headers.get("connection", "").lower() != "close"
                try:
                    await self._route(method, target, headers, body,
                                      writer, keep)
                except (ConnectionError, asyncio.IncompleteReadError):
                    raise
                except Exception as e:          # surface, don't kill conn
                    writer.write(_response_bytes(
                        500, json.dumps({"error": repr(e)}).encode(),
                        "application/json", keep_alive=False))
                    await writer.drain()
                    break
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _route(self, method, target, headers, body, writer,
                     keep) -> None:
        path = target.split("?", 1)[0]
        if method == "POST" and path == "/v1/chat/completions":
            await self._chat(headers, body, writer, keep)
        elif method == "GET" and path == "/metrics":
            writer.write(_response_bytes(
                200, self._metrics_text().encode(),
                "text/plain; version=0.0.4", keep_alive=keep))
            await writer.drain()
        elif method == "GET" and path == "/healthz":
            out = {"status": "ok", "engines": self.driver.rt.n_workers,
                   "phases": self.tracker.phase_counts()}
            writer.write(_response_bytes(
                200, json.dumps(out).encode(), "application/json",
                keep_alive=keep))
            await writer.drain()
        elif method == "GET" and path.startswith("/v1/requests/"):
            sid = path[len("/v1/requests/"):]
            tr = self.tracker.get(sid)
            status, out = (200, tr.to_dict()) if tr is not None else \
                (404, {"error": f"unknown request {sid!r}"})
            writer.write(_response_bytes(
                status, json.dumps(out).encode(), "application/json",
                keep_alive=keep))
            await writer.drain()
        else:
            writer.write(_response_bytes(
                404 if method in ("GET", "POST") else 405,
                json.dumps({"error": f"no route {method} {path}"}).encode(),
                "application/json", keep_alive=keep))
            await writer.drain()

    # -- chat completions ------------------------------------------------
    async def _chat(self, headers, raw, writer, keep) -> None:
        try:
            body = json.loads(raw.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            raise _HTTPError(400, "body is not JSON")
        n = next(self._seq)
        client_session = headers.get("x-session-id", "")
        task_id = headers.get("x-task-id") or \
            (f"{client_session}.{n}" if client_session else f"req{n}")
        program_id = headers.get("x-program-id") or f"chat:{task_id}"
        tenant = headers.get("x-tenant") or \
            str(body.get("user") or "default")
        rt = self.driver.rt
        # the runtime keys sessions by the program id, so the program
        # carries the unique X-Task-Id; X-Program-Id seeds realization
        # (identical program ids realize identical unspecified prompts)
        # and rides in the tracker for client-side correlation
        prog = program_from_body(body, program_id=task_id,
                                 tenant=tenant, vocab=rt.cfg.vocab,
                                 seed=_fnv1a(program_id) & 0xFFFFFFFF)
        hint = self.homes.get(client_session) if client_session else None
        if hint is None:
            hint = self.strategy.pick(
                client_session or task_id, [float(x) for x in rt.loads()],
                rt._alive, rt.roles)
        slo = (body.get("saga") or {}).get("slo_s")
        handle = self.driver.submit(
            prog, route_hint=hint,
            slo_s=float(slo) if slo is not None else None)
        tr = self.tracker.track(
            request_id=f"chatcmpl-{n}", session_id=handle.session_id,
            client_session=client_session, task_id=task_id,
            program_id=program_id, tenant=tenant)
        self.metrics.counter("saga_http_requests",
                             endpoint="chat.completions").inc()
        if body.get("stream"):
            await self._chat_stream(handle, tr, body, writer)
        else:
            await handle.wait()
            writer.write(_response_bytes(
                200, json.dumps(self._completion_json(handle, tr,
                                                      body)).encode(),
                "application/json",
                extra=self._echo_headers(tr), keep_alive=keep))
            await writer.drain()

    def _echo_headers(self, tr) -> Dict[str, str]:
        return {"X-Session-Id": tr.client_session or tr.session_id,
                "X-Task-Id": tr.task_id,
                "X-Program-Id": tr.program_id,
                "X-Engine": str(tr.engine)}

    def _completion_json(self, handle, tr, body) -> dict:
        outs = handle.step_outputs
        prompt_toks = sum(len(tokenize(str(m.get("content", "")),
                                       self.driver.rt.cfg.vocab))
                          for m in body.get("messages") or [])
        completion_toks = sum(len(o) for o in outs)
        return {
            "id": tr.request_id,
            "object": "chat.completion",
            "created": int(self.driver.wall_now()),
            "model": body.get("model") or self.model_name,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant",
                            "content": detokenize(outs[-1] if outs
                                                  else [])},
                "finish_reason": "stop",
            }],
            "usage": {"prompt_tokens": prompt_toks,
                      "completion_tokens": completion_toks,
                      "total_tokens": prompt_toks + completion_toks},
            "saga": {"session_id": tr.session_id,
                     "engine": tr.engine,
                     "steps": len(outs),
                     "path": handle.path},
        }

    async def _chat_stream(self, handle, tr, body, writer) -> None:
        """SSE streaming via chunked transfer: poll decoded tokens and
        emit ``chat.completion.chunk`` deltas until the workflow ends."""
        head = ("HTTP/1.1 200 OK\r\n"
                "Content-Type: text/event-stream\r\n"
                "Cache-Control: no-cache\r\n"
                "Transfer-Encoding: chunked\r\n"
                "Connection: close\r\n")
        for k, v in self._echo_headers(tr).items():
            head += f"{k}: {v}\r\n"
        writer.write((head + "\r\n").encode("latin-1"))

        def chunk(data: str) -> bytes:
            payload = f"data: {data}\n\n".encode()
            return f"{len(payload):x}\r\n".encode() + payload + b"\r\n"

        def delta(content, finish=None) -> str:
            return json.dumps({
                "id": tr.request_id, "object": "chat.completion.chunk",
                "created": int(self.driver.wall_now()),
                "model": body.get("model") or self.model_name,
                "choices": [{"index": 0,
                             "delta": ({"content": content}
                                       if content is not None else {}),
                             "finish_reason": finish}]})

        writer.write(chunk(delta("")))       # role-less prologue chunk
        sent = 0
        while True:
            toks = self._decoded_so_far(handle.session_id)
            if len(toks) > sent:
                writer.write(chunk(delta(
                    ("" if sent == 0 else " ") +
                    detokenize(toks[sent:]))))
                sent = len(toks)
                await writer.drain()
            if handle.done:
                break
            await asyncio.sleep(self.stream_poll_s)
        writer.write(chunk(delta(None, finish="stop")))
        writer.write(chunk("[DONE]"))
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    def _decoded_so_far(self, sid: str) -> list:
        """All tokens decoded so far (finished steps + the in-flight
        step's tail), read under the driver lock."""
        with self.driver._lock:
            ses = self.driver.rt.sessions[sid]
            toks = [t for out in ses.step_outputs for t in out]
            if ses.state == "decode" and ses.mid_step is False \
                    and len(ses.ctx) > ses.step_start_len:
                toks.extend(ses.ctx[ses.step_start_len:])
            return toks

    # -- metrics ---------------------------------------------------------
    def _metrics_text(self) -> str:
        """Sample live runtime state into the proxy registry and render
        Prometheus text (merged with the runtime's traced registry when
        tracing is on)."""
        reg, rt = self.metrics, self.driver.rt
        now = self.driver.wall_now()
        with self.driver._lock:
            for w in range(rt.n_workers):
                lab = {"engine": str(w)}
                reg.gauge("saga_queue_depth", **lab).set(
                    now, float(len(rt.queues[w])))
                reg.gauge("saga_engine_alive", **lab).set(
                    now, float(rt._alive[w]))
                pool = rt.engines[w].pool
                reg.gauge("saga_kv_pool_blocks_used", **lab).set(
                    now, float(pool.physical_used_blocks()))
                reg.gauge("saga_kv_pool_blocks_total", **lab).set(
                    now, float(pool.total_blocks))
                reg.gauge("saga_kv_handoff_bytes", **lab).set(
                    now, float(rt.engines[w].handoff_copy_bytes))
            reg.gauge("saga_afs_deviation_max").set(
                now, float(rt.afs_dev_max))
            reg.gauge("saga_sessions_total").set(
                now, float(len(rt.sessions)))
            reg.gauge("saga_sessions_done").set(now, float(rt.n_done))
            for k, v in rt.stats().items():
                reg.gauge(f"saga_runtime_{k}").set(now, float(v))
            obs = rt.obs_metrics
        text = reg.to_prometheus()
        if obs is not None:
            text += obs.to_prometheus()
        return text
