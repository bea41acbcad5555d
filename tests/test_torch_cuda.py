"""The port's Hopper kernels against their plain PyTorch versions, on a
card.  Every test here is marked ``cuda`` and skips without one; the file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: bf16 2e-2 (tests/test_kernels.py); the append moves bits and
must match exactly."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as F  # noqa: E402
from repro_torch.kernels.paged_attention import ops as P  # noqa: E402

TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("S,window", [(256, 0), (200, 32)])
def test_flash_kernel_matches_plain_on_card(cuda, D, S, window):
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = (torch.randn(2, S, h, D, generator=g, device=cuda)
               .to(torch.bfloat16) for h in (6, 2, 2))
    before = F.flash_prefill.launches
    out = F.flash_prefill(q, k, v, causal=True, window=window)
    assert F.flash_prefill.launches == before + 1
    ref = F.flash_prefill_plain(q, k, v, causal=True, window=window)
    assert float((out.float() - ref.float()).abs().max()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("window", [0, 32])
def test_paged_kernels_match_plain_on_card(cuda, dh, window):
    g = torch.Generator(device=cuda).manual_seed(dh)
    B, H, K, blk, nb = 3, 6, 2, 16, 8
    mk = lambda *s: torch.randn(s, generator=g, device=cuda).to(  # noqa
        torch.bfloat16)
    q, kn, vn = mk(B, H, dh), mk(B, K, dh), mk(B, K, dh)
    kp, vp = mk(B * nb, blk, K, dh), mk(B * nb, blk, K, dh)
    tables = torch.arange(B * nb, device=cuda, dtype=torch.int32
                          ).reshape(B, nb)
    lens = torch.tensor([128, 45, 1], device=cuda, dtype=torch.int32)
    ablk = torch.tensor([7, 10, B * nb], device=cuda, dtype=torch.int32)
    aoff = ((lens - 1) % blk).to(torch.int32)
    kp2, vp2 = kp.clone(), vp.clone()
    P.paged_append(kp, vp, kn, vn, ablk, aoff)
    out = P.paged_decode(q, kp, vp, tables, lens, window=window)
    P.paged_append_plain(kp2, vp2, kn, vn, ablk, aoff)
    ref = P.paged_decode_plain(q, kp2, vp2, tables, lens, window=window)
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    assert float((out.float() - ref.float()).abs().max()) < TOL


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 64, 4, 16, device=cuda)               # float32
    with pytest.raises(ValueError, match="bf16"):
        F.flash_prefill(q, q[:, :, :2], q[:, :, :2])
    qb = q.to(torch.bfloat16)[..., :8].contiguous()          # head_dim 8
    with pytest.raises(ValueError, match="head_dim"):
        F.flash_prefill(qb, qb[:, :, :2], qb[:, :, :2])
    pool = torch.zeros(4, 16, 2, 16, device=cuda, dtype=torch.bfloat16)
    ids = torch.zeros(1, device=cuda, dtype=torch.int64)     # not int32
    new = torch.zeros(1, 2, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        P.paged_append(pool, pool.clone(), new, new, ids, ids)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda):
    """micro served through the kernels on the card lands the same KV in
    the same blocks as the plain versions on the CPU."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    cfg = get_config("micro")
    cpu = lm.init_params(cfg, seed=3, device="cpu")
    params = {"cpu": cpu, "cuda": _to(cpu, cuda)}
    prompt = np.random.RandomState(3).randint(1, cfg.vocab, 45)
    engines = {}
    for dev, p in params.items():
        eng = Engine(cfg, p, n_slots=2, max_len=128, pool_blocks=16)
        slot = eng.start_session("s", prompt, cached_hit=False)
        # one step: its input is fixed, so its KV must agree whatever
        # id a near-tie gives later steps
        eng.decode({slot: int(prompt[-1])}, n_steps=1)
        engines[dev] = eng
    a, b = engines["cpu"].pool, engines["cuda"].pool
    assert a.tables == b.tables and a.lens == b.lens
    assert engines["cuda"].pool.audit_blocks() == []
    for x, y in ((a.k_pool, b.k_pool), (a.v_pool, b.v_pool)):
        assert float((x.float() - y.float().cpu()).abs().max()) < TOL


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
