"""``examples/serve_frontend_torch.py`` on the CPU against
``examples/serve_frontend.py`` (both in this process), with the
reference's micro params carried over.  Held equal: the two completion
lines (engine, steps, content), and the ``done:`` line's session count
and "conservation clean".  The streamed completion is held to carry
the chunks it says it carries, at least a prologue, one delta and the
finish.  Not compared, since the wall clock drives them: the proxy's
ephemeral port; the SSE chunk count and the streamed text (the proxy
sends one chunk for each of its polls that found new tokens, the
in-flight step's tail included: the reference printed 6 chunks on two
runs, the port 10 and 7); the ``done:`` line's event count, wall and
virtual seconds; and the ``/metrics`` sample (a scrape of live
gauges)."""
import asyncio
import contextlib
import io
import json
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # micro: threads only add overhead

import torch_examples as E  # noqa: E402

DONE = re.compile(r"done: (\d+) sessions, \d+ events, \d+\.\ds wall "
                  r"\(\d+\.\ds virtual\), conservation clean")
CHUNKS = re.compile(r"streamed completion: (\d+) SSE chunks")
SSE = re.compile(rb"data: (\{.*?\})\n\n")


def held(lines):
    """The completion lines and the done line's session count."""
    out = [line for line in lines if line.startswith("completion ")]
    done = [DONE.fullmatch(line) for line in lines if line.startswith("done:")]
    assert len(out) == 2 and len(done) == 1 and done[0], lines
    return out + [f"done: {done[0].group(1)} sessions"]


def streamed(mod, monkeypatch):
    """Keep the raw bodies of the example's streamed requests."""
    bodies, real = [], mod.http

    async def http(port, method, path, body=None, headers=None):
        raw = await real(port, method, path, body, headers)
        if body and body.get("stream"):
            bodies.append(raw)
        return raw

    monkeypatch.setattr(mod, "http", http)
    return bodies


def chunks(raw):
    """The chat.completion.chunk objects of a streamed body."""
    return [json.loads(m) for m in SSE.findall(raw)]


def test_twin_completions_match_the_reference_s(monkeypatch):
    ref = E.reference_module("serve_frontend")
    ref_bodies = streamed(ref, monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        asyncio.run(ref.main())
    want = out.getvalue().splitlines()

    port = E.twin("serve_frontend")
    port_bodies = streamed(port, monkeypatch)
    got, calls, _ = E.run_twin(port, E.carried_micro_params(), monkeypatch)

    assert held(got) == held(want)
    assert got[0].startswith("proxy listening on http://127.0.0.1:")
    assert all(n > 0 for n in calls.values()), calls
    for lines, bodies in ((got, port_bodies), (want, ref_bodies)):
        (objs,) = map(chunks, bodies)
        assert all(o["object"] == "chat.completion.chunk" for o in objs)
        assert len(objs) >= 3
        assert objs[-1]["choices"][0]["finish_reason"] == "stop"
        assert [int(m.group(1)) for m in map(CHUNKS.fullmatch, lines)
                if m] == [len(objs)]
