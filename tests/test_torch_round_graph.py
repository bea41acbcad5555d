"""Where the engine replays its decode round as a CUDA graph, on the CPU.

The graph (``serving/round_graph.py``) runs only where an engine is paged,
on a CUDA device and with no ``env``: the CPU, gather and mesh engines
run the eager round they ran before, capture nothing and count no replay.
The staged inputs a replay reads equal the five tensors of the eager
round, ``lm.decode_step_paged`` is the unembed of ``lm.decode_body_paged``
(the part the graph captures) bit for bit, and ``build.counted_apart``
keeps a capture's launches out of the wrappers' counts until a replay
adds them.  The card's side is ``tests/test_torch_cuda.py``."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import llava_next_34b, mixtral_8x22b  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs.tracer import Tracer  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import Engine, uses_round_graph  # noqa: E402
from repro_torch.serving.round_graph import StagedInputs  # noqa: E402

CFG = get_config("micro")
CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.fixture(scope="module")
def params():
    return lm.init_params(CFG, seed=0, device="cpu")


@pytest.mark.parametrize("device,paged,env,used", [
    (CUDA, True, None, True),
    (CUDA, False, None, False),
    (CUDA, True, object(), False),
    (CPU, True, None, False),
])
def test_round_graph_rule(device, paged, env, used):
    """Paged, on a CUDA device, with no ``env``: nothing else."""
    assert uses_round_graph(device, paged, env) is used


def _script(eng, vocab):
    """Two sessions, two steps a call, a round one slot sits out, a park,
    a cache-hit resume and a release; returns the ids."""
    rng = np.random.RandomState(2)
    a, b, tool = (rng.randint(1, vocab, n).astype(np.int32)
                  for n in (21, 16, 7))
    sa = eng.start_session("a", a, cached_hit=False)
    sb = eng.start_session("b", b, cached_hit=False)
    out = eng.decode({sa: int(a[-1]), sb: int(b[-1])}, n_steps=2)
    ids = [out[sa], out[sb]]
    ids.append(eng.decode({sb: ids[1][-1]})[sb])
    assert eng.park_session("a")
    ctx = np.concatenate([a, np.asarray(ids[0], np.int32), tool])
    sa = eng.start_session("a", ctx, cached_hit=True)
    out = eng.decode({sa: int(ctx[-1]), sb: ids[2][-1]}, n_steps=2)
    ids += [out[sa], out[sb]]
    assert eng.release_session("b")
    ids.append(eng.decode({sa: ids[3][-1]})[sa])
    return ids


@pytest.mark.parametrize("paged", [True, False])
def test_cpu_engines_run_the_eager_round(params, paged, monkeypatch):
    """A CPU engine, paged or gather, captures no graph and counts no
    replay: each step is one call of ``lm.decode_step_paged`` (gather:
    ``lm.decode_step``), and every ``round`` span says ``graph`` False."""
    def no_graph(*a, **k):
        raise AssertionError("a CPU engine made a round graph")
    monkeypatch.setattr(engine_mod, "RoundGraph", no_graph)
    name = "decode_step_paged" if paged else "decode_step"
    calls, step = [0], getattr(lm, name)

    def counted(*a, **k):
        calls[0] += 1
        return step(*a, **k)
    monkeypatch.setattr(lm, name, counted)
    eng = Engine(CFG, params, n_slots=3, max_len=64, pool_blocks=16,
                 block_size=8, paged=paged)
    eng.wall = Tracer()
    ids = _script(eng, CFG.vocab)
    assert all(len(i) for i in ids)
    assert eng.graph_captures == eng.graph_rounds == 0
    assert eng._graph is None
    assert calls[0] == eng.decode_steps == 6
    rounds = [sp for sp in eng.wall.spans if sp.name == "round"]
    assert len(rounds) == 4
    assert all(sp.meta["graph"] is False for sp in rounds)


@pytest.mark.parametrize("block_size", [8, 16])
def test_staged_inputs_equal_the_eager_tensors(params, block_size):
    """The staging buffer's device views after ``upload`` equal the eager
    round's five tensors, dtypes and shapes included, whatever the views
    held before: an idle slot, a row whose next token opens a block, a
    row inside one."""
    eng = Engine(CFG, params, n_slots=4, max_len=64, pool_blocks=16,
                 block_size=block_size)
    rng = np.random.RandomState(block_size)
    cur = {}
    for sid, n in (("a", 2 * block_size), ("b", block_size + 3),
                   ("c", 5)):
        toks = rng.randint(1, CFG.vocab, n).astype(np.int32)
        cur[eng.start_session(sid, toks, cached_hit=False)] = int(toks[-1])
    eng.release_session("b")
    cur = {s: t for s, t in cur.items() if eng.slots[s].session_id}
    eager = eng._round_inputs(cur)
    staged = StagedInputs(eng.n_slots, eng.max_nb, eng.device)
    for a in staged.arrays:
        a.fill(7)
    eng._paged_arrays(cur, staged.arrays)
    got = staged.upload()
    assert len(got) == len(eager) == 5
    for g, e in zip(got, eager):
        assert g.dtype == e.dtype and g.shape == e.shape
        assert torch.equal(g, e)
    # the idle slot carries the drop sentinel; a fresh block was drawn
    assert int(got[3][1]) == eng.pool.total_blocks
    assert eng.pool.tail_slot("a")[1] == 0


@pytest.mark.parametrize("cfg", [CFG, mixtral_8x22b.tiny(),
                                 llava_next_34b.tiny()],
                         ids=["dense", "moe", "vlm"])
def test_decode_step_paged_is_the_unembed_of_the_body(cfg):
    """On one device ``decode_step_paged``'s logits are ``unembed`` of
    ``decode_body_paged``, bit for bit, and both write the same pools."""
    p = lm.init_params(cfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(1)
    B, nb, blk = 3, 4, 8
    shape = (cfg.n_layers, 12, blk, cfg.n_kv_heads, cfg.head_dim)
    k0, v0 = (torch.randn(*shape, generator=g).to(torch.bfloat16)
              for _ in range(2))
    tok = torch.randint(1, cfg.vocab, (B, 1), generator=g)
    tables = torch.randint(0, 12, (B, nb), generator=g, dtype=torch.int32)
    pos = torch.tensor([5, 17, 0], dtype=torch.int32)
    ablk = torch.tensor([tables[0, 0], tables[1, 2], 12], dtype=torch.int32)
    aoff = torch.tensor([5, 1, 0], dtype=torch.int32)
    kw = (tables, pos, ablk, aoff, cfg)
    k1, v1 = k0.clone(), v0.clone()
    logits, _, _ = lm.decode_step_paged(p, tok, k1, v1, *kw)
    k2, v2 = k0.clone(), v0.clone()
    body = lm.unembed(p, lm.decode_body_paged(p, tok, k2, v2, *kw), cfg)
    assert torch.equal(logits, body)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert not torch.equal(k1, k0)


class _Wrapper:
    launches = 0


def test_counted_apart_holds_launches_until_added():
    """Inside ``counted_apart`` this thread's launches go to the block's
    tally (an inner block's to its own), another thread's to the wrapper;
    ``add_counts`` adds a tally."""
    w, other = _Wrapper(), _Wrapper()
    with build.counted_apart() as outer:
        build.count(w)
        with build.counted_apart() as inner:
            build.count(w)
            build.count(other)
        build.count(w)
        t = threading.Thread(target=build.count, args=(w,))
        t.start()
        t.join()
    assert outer == {w: 2} and inner == {w: 1, other: 1}
    assert w.launches == 1 and other.launches == 0
    build.count(w)
    assert w.launches == 2
    build.add_counts(inner)
    build.add_counts(inner)
    assert w.launches == 4 and other.launches == 2
