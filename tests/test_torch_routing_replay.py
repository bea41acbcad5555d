"""``repro_torch.models.routing_replay.SameRouting``: the router replays
recorded picks, counts a differing pick only at a near-tie, and refuses
one away from it."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.routing_replay import SameRouting  # noqa: E402


def _inputs(seed, T=12, d=16, E=8):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(T, d, generator=g), torch.randn(d, E, generator=g)


def test_replay_returns_the_recorded_picks(monkeypatch):
    x, w = _inputs(0)
    routing = SameRouting(monkeypatch.setattr)
    routing.record()
    p_rec, e_rec = L.moe_router(x, w, 2)
    routing.replay()
    p, e = L.moe_router(x, w, 2)
    assert torch.equal(e, e_rec) and torch.allclose(p, p_rec)
    assert routing.flips == 0
    routing.restore()
    assert L.moe_router is routing.router


def test_replay_counts_a_near_tie_and_refuses_a_clear_pick(monkeypatch):
    x, w = _inputs(1)
    routing = SameRouting(monkeypatch.setattr)
    routing.record()
    L.moe_router(x, w, 2)
    probs, ids = routing.calls[0]
    # a recording whose row 0 took its third expert for its second, with
    # those two probabilities swapped: a near-tie of that recording
    order = probs[0].sort(descending=True).indices
    near_p, near_ids = probs.clone(), ids.clone()
    near_p[0, order[1]], near_p[0, order[2]] = probs[0, order[2]], \
        probs[0, order[1]]
    near_ids[0] = order[torch.tensor([0, 2])]
    routing.replay([(near_p, near_ids)])
    p, e = L.moe_router(x, w, 2)
    assert torch.equal(e, near_ids) and routing.flips == 1
    assert torch.allclose(p.sum(-1), torch.ones(len(x)))
    # the recording's own probabilities with picks it would not make
    routing.replay([(probs, order[-2:].expand_as(ids))])
    with pytest.raises(AssertionError, match="away from a near-tie"):
        L.moe_router(x, w, 2)


@pytest.mark.parametrize("n_dec", [0, 3])
def test_by_position_orders_prefill_then_steps(n_dec):
    B, S, E, k, layers = 2, 5, 4, 2, 3
    routing = SameRouting()
    for step in range(1 + n_dec):
        n = S if step == 0 else 1
        for layer in range(layers):
            ids = torch.full((B * n, k), 10 * layer + step)
            routing.calls.append((torch.zeros(B * n, E), ids))
    out = routing.by_position(B, S, n_dec)
    assert len(out) == layers
    for layer, (probs, ids) in enumerate(out):
        assert probs.shape == (B, S + n_dec, E)
        assert ids.shape == (B, S + n_dec, k)
        assert (ids[:, :S] == 10 * layer).all()
        for j in range(n_dec):
            assert (ids[:, S + j] == 10 * layer + 1 + j).all()
