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
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
    ROOT / "benchmarks" / name for name in (
        "serve_bench_torch.py", "soak_bench_torch.py", "torch_common.py")] \
    + sorted((ROOT / "examples").glob("*_torch.py"))
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
    """The engine refuses MLA (deepseek-v2) as the reference's does (an
    assert there, a ``ValueError`` here): its KV paths assume the GQA
    (k, v) cache."""
    from repro.configs import deepseek_v2_236b as ref_mod
    from repro.serving.engine import Engine as RefEngine
    from repro_torch.configs import deepseek_v2_236b, get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine
    cfg = deepseek_v2_236b.tiny()
    params = lm.init_params(get_config("micro"), 0, device="cpu")
    for paged in (True, False):
        with pytest.raises(ValueError, match="GQA \\(k, v\\) cache"):
            Engine(cfg, params, paged=paged)
    with pytest.raises(AssertionError, match="GQA \\(k, v\\) cache"):
        RefEngine(ref_mod.tiny(), None)


@pytest.mark.parametrize("mod", ["deepseek_v2_236b", "seamless_m4t_large_v2"])
def test_model_functions_take_mla_and_encdec(mod):
    """MLA (deepseek-v2) and enc-dec (seamless) through every model entry
    point on the CPU: init_params, init_cache, prefill, decode_step and
    forward_logits; paged decode refuses both, as the reference's
    asserts."""
    import importlib
    from repro_torch.models import lm
    cfg = importlib.import_module(f"repro_torch.configs.{mod}").tiny()
    params = lm.init_params(cfg, 0, device="cpu")
    tokens = torch.arange(1, 7, dtype=torch.long)[None]
    key = "tgt_tokens" if cfg.enc_dec else "tokens"
    batch = {key: tokens}
    if cfg.enc_dec:
        batch["frames"] = torch.zeros(1, 5, cfg.d_model, dtype=torch.bfloat16)
    last, cache = lm.prefill(params, batch, cfg, max_len=8)
    logits, _ = lm.decode_step(params, tokens[:, :1], cache, 6, cfg)
    full = lm.forward_logits(params, batch, cfg)
    assert last.shape == logits.shape == (1, 1, cfg.vocab)
    assert full.shape == (1, 6, cfg.vocab)
    empty = lm.init_cache(cfg, 1, 8, device="cpu", src_len=5)
    assert {k: v.shape for k, v in empty.items()} == \
        {k: v.shape for k, v in cache.items()}
    with pytest.raises(ValueError, match="uniform GQA-cache"):
        lm.decode_step_paged(params, tokens[:, :1], None, None, None, None,
                             None, None, cfg)


@pytest.mark.parametrize("mod", ["rwkv6_7b", "jamba_v0_1_52b",
                                 "mixtral_8x22b", "llava_next_34b"])
def test_model_functions_take_the_ported_families(mod):
    """ssm, hybrid, moe and vlm (with an empty patch stream) through
    prefill and decode_step; paged decode takes the uniform GQA families
    and refuses the others."""
    import importlib
    from repro_torch.models import lm
    cfg = importlib.import_module(f"repro_torch.configs.{mod}").tiny()
    params = lm.init_params(cfg, 0, device="cpu")
    tokens = torch.arange(1, 7, dtype=torch.long)[None]
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros(1, 0, cfg.d_model,
                                       dtype=torch.bfloat16)
    last, cache = lm.prefill(params, batch, cfg, max_len=8)
    logits, _ = lm.decode_step(params, tokens[:, :1], cache, 6, cfg)
    assert last.shape == logits.shape == (1, 1, cfg.vocab)
    assert sorted(cache) == sorted(lm.init_cache(cfg, 1, 8, device="cpu"))
    if cfg.family in ("ssm", "hybrid"):
        with pytest.raises(ValueError, match="uniform GQA-cache"):
            lm.decode_step_paged(params, tokens[:, :1], None, None, None,
                                 None, None, None, cfg)
        return
    # the contiguous cache read as one pool block of 8: the same step again
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    out, _, _ = lm.decode_step_paged(params, tokens[:, :1], cache["k"],
                                     cache["v"], i32([0]), i32(6), i32(0),
                                     i32(6), cfg)
    assert torch.equal(out, logits)


@pytest.mark.parametrize("mod", ["llama3_2_3b", "mixtral_8x22b",
                                 "llava_next_34b"])
def test_engine_takes_the_families_the_reference_engine_takes(mod):
    """dense, moe and vlm: the port's engine admits them in both modes,
    as the reference's does."""
    import importlib
    from repro.serving.engine import Engine as RefEngine
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine
    cfg = importlib.import_module(f"repro_torch.configs.{mod}").tiny()
    params = lm.init_params(cfg, 0, device="cpu")
    for paged in (True, False):
        Engine(cfg, params, paged=paged)
    RefEngine(importlib.import_module(f"repro.configs.{mod}").tiny(), None)


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


def _meta_calls():
    """Each wrapper's call on meta inputs the kernel takes, and the
    shapes and types its CUDA path returns."""
    from repro_torch.kernels.flash_attention.ops import flash_prefill
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.paged_attention.ops import (paged_append,
                                                         paged_decode)
    from repro_torch.kernels.rwkv6.ops import wkv6

    def m(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    pool = m(3, 16, 2, 16)
    return [
        ("flash_prefill", lambda: flash_prefill(m(1, 8, 2, 16),
                                                m(1, 8, 1, 16),
                                                m(1, 8, 1, 16)),
         [((1, 8, 2, 16), bf16)]),
        ("paged_decode", lambda: paged_decode(
            m(2, 4, 16), pool, pool, m(2, 1, dtype=i32), m(2, dtype=i32)),
         [((2, 4, 16), bf16)]),
        ("paged_append", lambda: paged_append(
            pool, pool, m(2, 2, 16), m(2, 2, 16), m(2, dtype=i32),
            m(2, dtype=i32)),
         [((3, 16, 2, 16), bf16), ((3, 16, 2, 16), bf16)]),
        ("wkv6", lambda: wkv6(m(1, 4, 2, 16), m(1, 4, 2, 16),
                              m(1, 4, 2, 16), m(1, 4, 2, 16, dtype=f32),
                              m(2, 16, dtype=f32)),
         [((1, 4, 2, 16), f32), ((1, 2, 16, 16), f32)]),
        ("mamba_scan", lambda: mamba_scan(
            m(1, 4, 32), m(1, 4, 32), m(1, 4, 8), m(1, 4, 8),
            m(32, 8, dtype=f32), m(32, dtype=f32)),
         [((1, 4, 32), f32), ((1, 32, 8), f32)]),
    ]


@pytest.mark.parametrize("case", range(5), ids=lambda i: [
    "flash_prefill", "paged_decode", "paged_append", "wkv6",
    "mamba_scan"][i])
def test_wrappers_take_meta_only_inside_a_dry_run(case):
    """Inside ``build.dry_run()`` a wrapper given meta tensors returns
    meta tensors of its CUDA path's shapes and types, tallies one call and
    launches nothing; outside it, a meta tensor raises as before."""
    from repro_torch.kernels import build
    name, call, want = _meta_calls()[case]
    with build.dry_run() as tally:
        out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert [(tuple(t.shape), t.dtype) for t in outs] == want
    assert all(t.device.type == "meta" for t in outs)
    assert list(tally) == [name] and tally[name]["calls"] == 1
    assert tally[name]["bytes"] > 0
    with pytest.raises(ValueError, match="unsupported device"):
        call()


def test_dry_run_module_sets_up_no_process_group():
    """Importing ``launch.dryrun`` (the guard's import scan covers it)
    sets up no process group: its fake world is made by ``main``."""
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun\n"
            "print(dist.is_initialized())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["False"]
    assert "repro_torch.launch.dryrun" in MODULES


def test_wrappers_cpu_branch_stays_differentiable():
    """On a CPU tensor each wrapper runs its plain version, which autograd
    follows: a backward through it gives every input a finite gradient
    (the training path may reach a wrapper on the CPU; on a card the
    wrappers refuse tensors that require grad, tests/test_torch_cuda.py).
    ``paged_append`` writes its pools in place, so they enter as products
    of leaves."""
    from repro_torch.kernels.flash_attention.ops import flash_prefill
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.paged_attention.ops import (paged_append,
                                                         paged_decode)
    from repro_torch.kernels.rwkv6.ops import wkv6

    gen = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16

    def leaf(*shape, dtype=torch.float32, scale=1.0):
        x = torch.randn(*shape, generator=gen) * scale
        return x.to(dtype).requires_grad_(True)

    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    cases = []
    q, k, v = leaf(1, 8, 4, 16, dtype=bf16), leaf(1, 8, 2, 16, dtype=bf16), \
        leaf(1, 8, 2, 16, dtype=bf16)
    cases.append(("flash_prefill", flash_prefill(q, k, v), (q, k, v)))
    q, kp, vp = (leaf(2, 4, 16, dtype=bf16), leaf(3, 4, 2, 16, dtype=bf16),
                 leaf(3, 4, 2, 16, dtype=bf16))
    out = paged_decode(q, kp, vp, i32([0, 2], [1, 0]), i32(7, 3))
    cases.append(("paged_decode", out, (q, kp, vp)))
    kp, vp = leaf(3, 4, 2, 16), leaf(3, 4, 2, 16)
    kn, vn = leaf(2, 2, 16), leaf(2, 2, 16)
    ko, vo = paged_append(kp * 1, vp * 1, kn, vn, i32(1, 3), i32(2, 0))
    cases.append(("paged_append", ko.sum() + vo.sum(), (kp, vp, kn)))
    r, kk, vv = (leaf(1, 5, 2, 16, dtype=bf16) for _ in range(3))
    w = torch.rand(1, 5, 2, 16, generator=gen).requires_grad_(True)
    u, s0 = leaf(2, 16), leaf(1, 2, 16, 16, scale=0.1)
    out, s_T = wkv6(r, kk, vv, w, u, s0)
    cases.append(("wkv6", out.sum() + s_T.sum(), (r, kk, vv, w, u, s0)))
    x, dt = leaf(1, 5, 8, dtype=bf16), leaf(1, 5, 8, dtype=bf16, scale=0.1)
    Bc, Cc = leaf(1, 5, 4, dtype=bf16), leaf(1, 5, 4, dtype=bf16)
    A, D, h0 = leaf(8, 4), leaf(8), leaf(1, 8, 4)
    y, h_T = mamba_scan(x, dt, Bc, Cc, A, D, h0)
    cases.append(("mamba_scan", y.sum() + h_T.sum(),
                  (x, dt, Bc, Cc, A, D, h0)))
    for name, out, inputs in cases:
        out.float().sum().backward()
        for i, t in enumerate(inputs):
            assert t.grad is not None, f"{name}: input {i} has no gradient"
            assert bool(t.grad.float().isfinite().all()), (name, i)
            assert float(t.grad.float().abs().sum()) > 0, (name, i)


def test_refuse_autograd_raises_only_under_grad_on_tensors_that_require_it():
    """The check each wrapper makes before a CUDA launch (the launches
    themselves are card tests)."""
    from repro_torch.kernels import build
    plain, leaf = torch.zeros(2), torch.zeros(2, requires_grad=True)
    build.refuse_autograd("k", plain, None)
    with pytest.raises(RuntimeError, match="no backward"):
        build.refuse_autograd("k", plain, leaf * 2)
    with torch.no_grad():
        build.refuse_autograd("k", plain, leaf)
