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
    with pytest.raises(NotImplementedError, match="next slice"):
        lm.init_params(mixtral_8x22b.tiny(), 0, device="cpu")
    params = lm.init_params(get_config("micro"), 0, device="cpu")
    with pytest.raises(NotImplementedError, match="gather oracle"):
        Engine(get_config("micro"), params, paged=False)


def test_wrappers_raise_on_devices_they_do_not_take():
    """A tensor that is neither on the CPU nor on a card is refused, not
    quietly computed by the plain version."""
    from repro_torch.kernels.flash_attention.ops import flash_prefill
    q = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill(q, q, q)
