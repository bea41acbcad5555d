"""The benchmark's own weights, made on the card from ``--seed``.

The program and the plain reference both read this one tree; neither
makes weights of its own.  Every matrix is normal with the standard
deviation the configuration's ``initializer_range`` gives (0.02 in the
published configs) and every norm scale is 1, in bf16, the type the
configurations state.  All matrices are views
of one flat buffer that a few large ``normal_`` calls fill with one
``torch.Generator`` on the device, so set-up does not pay a call per leaf.

The tree's layout is the one ``repro_torch.models.lm`` serves from: layer
leaves stacked on a leading layer axis, head-factored attention
projections, and for sparse experts a stacked expert axis.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

BF16 = torch.bfloat16
CHUNK = 1 << 30          # elements a ``normal_`` call fills
ALIGN = 64               # elements: every leaf starts 128-byte aligned


def matrix_shapes(m: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, shape) of every normal leaf of a uniform decoder, from the
    harness's model sizes ``m`` (``spec.model_sizes``)."""
    L, d, H, K, dh = m["n_layers"], m["d_model"], m["n_heads"], \
        m["n_kv_heads"], m["head_dim"]
    f, V, E = m["d_ff"], m["vocab"], m["n_experts"]
    out = [("embed", (V, d)), ("unembed", (d, V)),
           ("layers.attn.wq", (L, d, H, dh)),
           ("layers.attn.wk", (L, d, K, dh)),
           ("layers.attn.wv", (L, d, K, dh)),
           ("layers.attn.wo", (L, H, dh, d))]
    if E:
        out += [("layers.mlp.router", (L, d, E)),
                ("layers.mlp.w1", (L, E, d, f)),
                ("layers.mlp.w3", (L, E, d, f)),
                ("layers.mlp.w2", (L, E, f, d))]
    else:
        out += [("layers.mlp.w1", (L, d, f)), ("layers.mlp.w3", (L, d, f)),
                ("layers.mlp.w2", (L, f, d))]
    return out


def _put(tree: Dict, path: str, leaf) -> None:
    *parents, name = path.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[name] = leaf


def make_params(m: Dict, seed: int, device) -> Dict:
    """The weights of a uniform decoder (``m``: ``spec.model_sizes``) for
    ``seed`` on ``device``."""
    shapes = matrix_shapes(m)
    sizes = [torch.Size(s).numel() for _, s in shapes]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=BF16, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for i in range(0, total, CHUNK):
        flat[i:i + CHUNK].normal_(0.0, m["init_std"], generator=gen)
    params: Dict = {}
    for (path, shape), off, n in zip(shapes, offsets, sizes):
        _put(params, path, flat[off:off + n].view(shape))
    L, d = m["n_layers"], m["d_model"]
    ones = torch.ones(2 * L + 1, d, dtype=BF16, device=device)
    params["final_norm"] = ones[0]
    params["layers"]["ln1"] = ones[1:L + 1]
    params["layers"]["ln2"] = ones[L + 1:]
    return params


def n_params(m: Dict) -> int:
    return sum(torch.Size(s).numel() for _, s in matrix_shapes(m)) \
        + (2 * m["n_layers"] + 1) * m["d_model"]
