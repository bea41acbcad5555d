"""AdamW over the port's params: f32 moments beside bf16 params, the twin
of ``repro.train.optimizer`` with its arithmetic.

The reference returns new trees; here every leaf is updated in place, in
slices of at most 2**26 elements, each slice through the reference's
expression in its order of operations.  A functional update of
llama3.2-3b's stacked ``mlp.w1`` (704 M elements) would hold about six
f32 temporaries of 2.8 GB at once.  The moments' layout sharded over a
mesh (``opt_pspecs``) comes with the sharding slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

F32 = torch.float32
CHUNK = 1 << 26


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    """The leaves of a nested dict in the reference's order (sorted keys,
    as ``jax.tree_util`` flattens a dict)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_opt_state(params) -> OptState:
    """Zero f32 moments shaped like ``params``, step 0 (int32), on the
    params' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)  # noqa
    device = tree_leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def abstract_opt_state(abstract_params) -> OptState:
    """The state's shapes and types with nothing allocated, from
    ``lm.abstract_params`` (meta tensors)."""
    return init_opt_state(abstract_params)


def _slices(t):
    flat = t.view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


@torch.no_grad()
def adamw_update(params, grads, opt: OptState, *, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step, in place.  ``grads`` is a tree like ``params``.
    The global norm is the square root of the sum over leaves of f32 sums
    of squares; the clip scale min(1, clip / max(gnorm, 1e-12)); the bias
    corrections 1 - b**step with step an f32 tensor; moments and the
    update in f32, the new param rounded to its type.  Returns (params,
    opt, gnorm), the first two the objects given, updated."""
    flat_p, flat_g = tree_leaves(params), tree_leaves(grads)
    flat_m, flat_v = tree_leaves(opt.mu), tree_leaves(opt.nu)
    if any(g is None for g in flat_g):
        raise ValueError("adamw_update: a param has no gradient")
    for t in (*flat_p, *flat_g, *flat_m, *flat_v):
        if not t.is_contiguous():
            raise ValueError("adamw_update takes contiguous tensors")
    gsq = 0
    for g in flat_g:
        gsq = gsq + sum(s.float().square().sum() for s in _slices(g))
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

    opt.step.add_(1)
    step = opt.step.to(F32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=step.device),
                         step)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=step.device),
                         step)
    for leaf in zip(flat_p, flat_g, flat_m, flat_v):
        for p, g, m, v in zip(*map(_slices, leaf)):
            g = g.float() * scale
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * torch.square(g)
            mhat = m_new / c1
            vhat = v_new / c2
            delta = mhat / (torch.sqrt(vhat) + eps) \
                + weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            m.copy_(m_new)
            v.copy_(v_new)
    return params, opt, gnorm
