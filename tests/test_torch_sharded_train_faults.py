"""Faults planted in the transposes of training on a mesh, each of which
the checks of torch_sharded_train.py must catch (some gradient leaf, or
the loss, past its limit):

- a replicated leaf's gradient left as each rank's share
  (``sharding.copies`` not summing over the axes it is copied over);
- the loss's seed counted on the data ranks only, so every computation
  the 'model' ranks duplicate is summed tp times (tp times too large);
- the FSDP gather over 'data' transposed as a cut (a weight's gradient
  misses the other data rank's rows);
- a recurrence's shift taken on the sequence shard (rwkv6's token shift,
  jamba's causal conv), on the gradient;
- the loss averaged per rank (each rank's sum over its own count) on a
  vlm batch whose data ranks hold different counts of valid labels."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from torch_sharded_train import (OPTS, S, TOL, TOL_F32, check_case,  # noqa
                                 errors, run)


def caught(name, mesh, plant, monkeypatch, opt="defaults"):
    """The case run with ``plant`` in place: some leaf's error (or the
    loss's) past the limit."""
    got = run(name, mesh, OPTS[opt], monkeypatch, wrap=plant)
    loss_err, leaf = errors(name, got)
    tol = TOL_F32 if name in ("rwkv6-tiny", "jamba-tiny") else TOL
    return loss_err >= tol or max(leaf.values()) >= tol


def unsummed_copies(mp):
    mp.setattr(tsh, "copies", lambda tree: tree)


def seed_over_data_only(mp):
    def share(t, env):
        return tsh._Share.apply(t, env.dp) if env.dp > 1 else t
    mp.setattr(tsh, "rank_share", share)


def fsdp_gather_cut(mp):
    gather = tsh._gather_mesh

    class CutBack(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, out, n, dim, rank):
            ctx.n, ctx.dim, ctx.rank = n, dim, rank
            return out

        @staticmethod
        def backward(ctx, g):
            k = g.shape[ctx.dim] // ctx.n
            return g.narrow(ctx.dim, ctx.rank * k, k), None, None, None, \
                None

    def planted(t, mesh, axis, dim):
        if axis != "data":
            return gather(t, mesh, axis, dim)
        with torch.no_grad():
            out = gather(t, mesh, axis, dim)
        return CutBack.apply(t, out, mesh.size(0), dim,
                             mesh.get_local_rank("data"))

    mp.setattr(tsh, "_gather_mesh", planted)


def shift_on_shards(tp):
    def plant(mp):
        shift = trwkv._token_shift

        def planted(x, last):
            parts = x.chunk(tp, dim=1)
            return torch.cat([shift(parts[0], last)]
                             + [shift(p, None) for p in parts[1:]], dim=1)
        mp.setattr(trwkv, "_token_shift", planted)
    return plant


def conv_on_shards(tp):
    def plant(mp):
        conv = tmamba._causal_depthwise_conv

        def planted(x, w, b):
            return torch.cat([conv(p, w, b) for p in x.chunk(tp, dim=1)],
                             dim=1)
        mp.setattr(tmamba, "_causal_depthwise_conv", planted)
    return plant


def mean_per_rank(mp):
    def planted(tot, cnt, env, axes):
        mean = tot / torch.clamp(cnt, min=1.0)
        for axis in axes:
            mean = tsh.psum(mean, env, axis) / env.axis_sizes[axis]
        return mean
    mp.setattr(tlm, "_xent_mean", planted)


@pytest.mark.parametrize("plant", [unsummed_copies, seed_over_data_only,
                                   fsdp_gather_cut],
                         ids=["unsummed", "tp_times", "fsdp_cut"])
def test_planted_transpose_is_caught(plant, monkeypatch):
    assert caught("llama3.2-tiny", (2, 2), plant, monkeypatch)


@pytest.mark.parametrize("name,plant", [
    ("rwkv6-tiny", shift_on_shards(2)), ("jamba-tiny", conv_on_shards(2))],
    ids=["rwkv6_shift", "jamba_conv"])
def test_recurrence_shift_on_the_sequence_shard_is_caught(name, plant,
                                                          monkeypatch):
    assert S % 2 == 0
    assert caught(name, (1, 2), plant, monkeypatch)


def test_loss_averaged_per_rank_is_caught(monkeypatch):
    """llava-next-tiny's row 0 holds half as many valid labels as row 1:
    on (2, 2) the two data ranks' means weigh them unequally."""
    assert caught("llava-next-tiny", (2, 2), mean_per_rank, monkeypatch)


def test_the_sound_case_passes(monkeypatch):
    """The case the plants above run, unplanted, within its limits."""
    check_case("llama3.2-tiny", (2, 2), "defaults", monkeypatch)
    assert not dist.is_initialized()
