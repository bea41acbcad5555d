"""The port's twins of two tests of tests/test_models_smoke.py, over the
same ten architecture modules at their tiny configs: ``test_logits_shape``
(finite logits of the batch's shape) and
``test_prefill_decode_matches_full_forward`` (prefill(S-1) + one
``decode_step`` equals ``forward_logits`` on S, within the reference's
1e-2 and 2e-2).  The port runs alone on the reference's params
(``jax.random.PRNGKey(0)``, carried bit-exactly), its inputs drawn with
numpy.  The twins of its two training tests, ``test_forward_loss_finite``
and ``test_train_step_no_nans``, are tests/test_torch_forward_train.py's
parity tests."""
import importlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro.models import lm as jlm  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

ARCH_MODULES = [
    "jamba_v0_1_52b", "deepseek_v2_236b", "mixtral_8x22b",
    "command_r_35b", "mistral_nemo_12b", "qwen3_32b", "llama3_2_3b",
    "llava_next_34b", "rwkv6_7b", "seamless_m4t_large_v2",
]


def _carry(mod):
    """The port's tiny config of ``mod`` and the reference's PRNGKey(0)
    params, carried."""
    cj = importlib.import_module(f"repro.configs.{mod}").tiny()
    ct = importlib.import_module(f"repro_torch.configs.{mod}").tiny()
    pj = jlm.init_params(cj, jax.random.PRNGKey(0))
    return ct, tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                   "cpu")


def _bf16(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.02
                            ).to(torch.bfloat16)


def _batch(cfg, rng, B, S, n_frames=24):
    """tokens (or enc-dec's tgt_tokens after frames, vlm's after 8
    patches) drawn with numpy."""
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, size=(B, S)))
    if cfg.enc_dec:
        return {"frames": _bf16(rng, B, n_frames, cfg.d_model),
                "tgt_tokens": toks}
    if cfg.family == "vlm":
        return {"patches": _bf16(rng, B, 8, cfg.d_model), "tokens": toks}
    return {"tokens": toks}


@pytest.mark.parametrize("mod", ARCH_MODULES)
def test_logits_shape(mod):
    cfg, params = _carry(mod)
    batch = _batch(cfg, np.random.RandomState(0), 2, 16)
    logits = tlm.forward_logits(params, batch, cfg)
    S = 16 + (8 if cfg.family == "vlm" else 0)
    assert logits.shape == (2, S, cfg.vocab)
    assert bool(logits.isfinite().all())


@pytest.mark.parametrize("mod", ARCH_MODULES)
def test_prefill_decode_matches_full_forward(mod):
    """Serving-path correctness: prefill(S-1) + decode(1) == forward(S)."""
    cfg, params = _carry(mod)
    B, S = 2, 12
    full_batch = _batch(cfg, np.random.RandomState(1), B, S, n_frames=16)
    key = "tgt_tokens" if cfg.enc_dec else "tokens"
    toks = full_batch[key]
    P = 8 if cfg.family == "vlm" else 0
    full = tlm.forward_logits(params, full_batch, cfg)
    short = dict(full_batch, **{key: toks[:, :S - 1]})
    last, cache = tlm.prefill(params, short, cfg, max_len=P + S + 2)
    assert float((last[:, 0] - full[:, -2]).abs().max()) < 1e-2
    logits, _ = tlm.decode_step(params, toks[:, S - 1:S], cache, P + S - 1,
                                cfg)
    assert float((logits[:, 0] - full[:, -1]).abs().max()) < 2e-2
