"""The paged decode round's model body as one CUDA graph.

An eager paged round enqueues every kernel of ``lm.decode_body_paged``
from the host, ~77 a layer, and on the card the host's enqueue takes far
longer than the kernels run.  ``RoundGraph`` captures the body once (the
embedding, every layer's append and paged attention, the final norm) and
replays it each round from persistent device inputs, so a round costs
the host one input copy, one replay and the unembed.

A round's shapes are static: tokens (n_slots, 1), block tables (n_slots,
max_nb), positions, append blocks and offsets (n_slots,), idle rows
carrying the drop sentinel; ``paged_decode``'s split schedule reads only
the tables' capacity, and nothing in the body syncs with the host.  The
pools and params keep their addresses for the engine's life.  The
unembed stays outside the graph: it upcasts the unembedding to f32,
which a graph's private pool would keep reserved.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import lm

# byte alignment of each input within the staging buffer
_ALIGN = 16


class StagedInputs:
    """A paged round's five inputs as views of one host buffer (pinned
    where the device is CUDA) and of its device twin, so they reach the
    device in one copy: tokens (n, 1) int64, block tables (n, max_nb),
    positions, append blocks and append offsets (n,) int32.  ``arrays``
    are the host views (numpy), ``tensors`` the device's."""

    def __init__(self, n_slots: int, max_nb: int, device: torch.device):
        layout = ((np.int64, torch.long, (n_slots, 1)),
                  (np.int32, torch.int32, (n_slots, max_nb)),
                  *[(np.int32, torch.int32, (n_slots,))] * 3)
        spans, end = [], 0
        for npt, _, shape in layout:
            start = -(-end // _ALIGN) * _ALIGN
            end = start + int(np.prod(shape)) * np.dtype(npt).itemsize
            spans.append((start, end))
        self.host = torch.zeros(end, dtype=torch.uint8,
                                pin_memory=device.type == "cuda")
        self.dev = torch.zeros(end, dtype=torch.uint8, device=device)
        raw = self.host.numpy()
        self.arrays = tuple(raw[a:b].view(npt).reshape(shape)
                            for (a, b), (npt, _, shape) in zip(spans, layout))
        self.tensors = tuple(self.dev[a:b].view(tt).view(shape)
                             for (a, b), (_, tt, shape) in zip(spans, layout))

    def upload(self) -> Tuple[torch.Tensor, ...]:
        """Copy the host buffer to the device on the current stream and
        return the device views.  The host may write ``arrays`` again once
        the stream has passed the copy: the engine's argmax waits for it
        every step."""
        self.dev.copy_(self.host, non_blocking=True)
        return self.tensors


class RoundGraph:
    """``lm.decode_body_paged`` over an engine's pools captured as one
    CUDA graph, and its staged inputs.  Capture runs with every row idle
    (token 0 at position 0, zero tables, the drop sentinel as append
    block), so neither the warm-up nor the capture writes KV; the warm-up
    makes what the body keeps between calls (``paged_decode``'s tickets,
    its split schedule, the kernels' handles, cuBLAS's workspace) before
    the capture.  ``build.count`` stays truthful: the warm-up and the
    capture add no launches, and each replay adds those the capture
    tallied."""

    def __init__(self, params, cfg, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, n_slots: int, max_nb: int,
                 sentinel: int):
        device = k_pool.device
        self.params, self.cfg = params, cfg
        self.k_pool, self.v_pool = k_pool, v_pool
        self.inputs = StagedInputs(n_slots, max_nb, device)
        self.inputs.arrays[3].fill(sentinel)
        self.inputs.upload()
        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            with build.counted_apart():
                self._body()
            with build.counted_apart() as self.launches:
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.hidden = self._body()
                finally:
                    self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        self.kept = paged_ops.kept_buffers(device)

    def _body(self) -> torch.Tensor:
        tok, tables, pos, ablk, aoff = self.inputs.tensors
        return lm.decode_body_paged(self.params, tok, self.k_pool,
                                    self.v_pool, tables, pos, ablk, aoff,
                                    self.cfg)

    def replay(self) -> torch.Tensor:
        """Copy the staged inputs over, replay the body on the current
        stream and return the normed stream (n_slots, 1, d): the graph's
        own output, which the next replay overwrites."""
        self.inputs.upload()
        self.graph.replay()
        build.add_counts(self.launches)
        return self.hidden
