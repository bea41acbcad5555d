"""Guards of the PyTorch port (``src/repro_torch``): it imports without
jax and without the reference package, its sources import neither, and
its entry points run on the card unless the caller asks for the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_port_imports_with_jax_and_reference_blocked():
    """Every module of the port loads with ``jax`` and ``repro`` made
    unimportable (a None entry in sys.modules raises ImportError)."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for mod in {MODULES!r}:\n"
            "    importlib.import_module(mod)\n"
            "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_neither_jax_nor_reference(path):
    text = path.read_text()
    assert not re.search(r"^\s*(from|import)\s+(jax|repro)\b(?!_torch)",
                         text, re.M), path
    assert not re.search(r"import_module\(f?[\"']repro\.", text), path


def test_init_params_default_device_is_the_card():
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_params(get_config("micro"), 0)


def test_port_refuses_what_later_slices_port():
    from repro_torch.configs import get_config
    from repro_torch.configs import mixtral_8x22b
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine
    with pytest.raises(NotImplementedError, match="later slice"):
        lm.init_params(mixtral_8x22b.tiny(), 0, device="cpu")
    params = lm.init_params(get_config("micro"), 0, device="cpu")
    with pytest.raises(NotImplementedError, match="gather oracle"):
        Engine(get_config("micro"), params, paged=False)


@pytest.mark.parametrize("mod", ["mixtral_8x22b", "deepseek_v2_236b",
                                 "seamless_m4t_large_v2", "llava_next_34b"])
def test_model_functions_still_refuse_moe_mla_encdec_vlm(mod):
    """Uniform moe (mixtral), MLA (deepseek-v2), enc-dec (seamless) and
    vlm (llava) are later slices: every model entry point raises."""
    import importlib
    from repro_torch.models import lm
    cfg = importlib.import_module(f"repro_torch.configs.{mod}").tiny()
    tokens = torch.zeros(1, 4, dtype=torch.long)
    for call in (lambda: lm.init_params(cfg, 0, device="cpu"),
                 lambda: lm.init_cache(cfg, 1, 8, device="cpu"),
                 lambda: lm.prefill({}, {"tokens": tokens}, cfg),
                 lambda: lm.forward_logits({}, {"tokens": tokens}, cfg),
                 lambda: lm.decode_step({}, tokens[:, :1], {}, 0, cfg)):
        with pytest.raises(NotImplementedError, match="later slice"):
            call()


@pytest.mark.parametrize("name", ["micro", "llama3.2-3b"])
def test_dense_decode_step_is_a_later_slice(name):
    """Dense models decode through decode_step_paged; decode_step over a
    contiguous dense cache is not ported yet and says so."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    tokens = torch.zeros(1, 1, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="decode_step_paged"):
        lm.decode_step({}, tokens, {}, 0, get_config(name))


@pytest.mark.parametrize("mod", ["rwkv6_7b", "jamba_v0_1_52b"])
def test_model_functions_take_ssm_and_hybrid(mod):
    import importlib
    from repro_torch.models import lm
    cfg = importlib.import_module(f"repro_torch.configs.{mod}").tiny()
    params = lm.init_params(cfg, 0, device="cpu")
    tokens = torch.arange(1, 7, dtype=torch.long)[None]
    last, cache = lm.prefill(params, {"tokens": tokens}, cfg, max_len=8)
    logits, _ = lm.decode_step(params, tokens[:, :1], cache, 6, cfg)
    assert last.shape == logits.shape == (1, 1, cfg.vocab)
    assert sorted(cache) == sorted(lm.init_cache(cfg, 1, 8, device="cpu"))
    with pytest.raises(ValueError, match="uniform GQA-cache"):
        lm.decode_step_paged(params, tokens[:, :1], None, None, None, None,
                             None, None, cfg)


@pytest.mark.parametrize("mod", ["rwkv6_7b", "jamba_v0_1_52b"])
def test_engine_refuses_ssm_and_hybrid_as_the_reference_does(mod):
    """The model functions take ssm and hybrid, the engine does not: the
    reference's engine asserts on them (repro/serving/engine.py:103)."""
    import importlib
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine
    cfg = importlib.import_module(f"repro_torch.configs.{mod}").tiny()
    with pytest.raises(ValueError, match="decoder-only GQA KV"):
        Engine(cfg, lm.init_params(cfg, 0, device="cpu"))
    ref_cfg = importlib.import_module(f"repro.configs.{mod}").tiny()
    from repro.serving.engine import Engine as RefEngine
    with pytest.raises(AssertionError, match="decoder-only KV"):
        RefEngine(ref_cfg, None)


def test_wrappers_raise_on_devices_they_do_not_take():
    """A tensor that is neither on the CPU nor on a card is refused, not
    quietly computed by the plain version."""
    from repro_torch.kernels.flash_attention.ops import flash_prefill
    q = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill(q, q, q)
