"""Helpers of the example twins' tests (``tests/test_torch_examples_*.py``):
run a reference example in a child process, run its port twin
(``examples/<name>_torch.py``) in this process on the CPU with the
reference's micro params carried over, count the kernel wrappers' calls,
and take the wall figures out of printed lines."""
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
KERNELS = ("flash_prefill", "paged_decode", "paged_append")
# "1.9s wall": the only wall-clock figure the virtual-time examples print
WALL = re.compile(r"\d+\.\d+s wall")


def child_env(**extra):
    """The environment of an example's child process: the reference on
    JAX's CPU backend, one thread a library (the tests run six workers)."""
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1", **extra)


def run_reference(name, *args, cwd=None, timeout=600):
    """``examples/<name>.py`` in a child; its printed lines."""
    res = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py"),
                          *args], capture_output=True, text=True,
                         env=child_env(), cwd=cwd or ROOT, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.splitlines()


def run_port_child(name, *args, cwd=None, timeout=600):
    """``examples/<name>_torch.py`` in a child; the finished process."""
    return subprocess.run([sys.executable, str(EXAMPLES / f"{name}_torch.py"),
                           *args], capture_output=True, text=True,
                          env=child_env(), cwd=cwd or ROOT, timeout=timeout)


def _load(stem):
    spec = importlib.util.spec_from_file_location(stem,
                                                  EXAMPLES / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin(name):
    """The module ``examples/<name>_torch.py``, loaded afresh."""
    return _load(f"{name}_torch")


def reference_module(name):
    """The reference's ``examples/<name>.py``, loaded afresh (it imports
    jax)."""
    return _load(name)


def carried_micro_params():
    """The reference examples' params, ``lm.init_params(micro,
    PRNGKey(0))``, carried to the port on the CPU."""
    import jax

    from repro.configs import get_config, load_all
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm
    load_all()
    params = jlm.init_params(get_config("micro"), jax.random.PRNGKey(0))
    return tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               "cpu")


@contextlib.contextmanager
def counted_kernels(monkeypatch):
    """Count the model's calls of each kernel wrapper (on the CPU a call
    runs the plain version; on the card each call is one launch)."""
    from repro_torch.models import layers
    calls = dict.fromkeys(KERNELS, 0)

    def counting(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    for name in KERNELS:
        monkeypatch.setattr(layers, name, counting(name, getattr(layers,
                                                                 name)))
    yield calls


class Printed(io.StringIO):
    """stdout that keeps, for each line printed, ``counts()`` as the line
    ended (``at[i]``: the calls made before line i was printed)."""

    def __init__(self, counts):
        super().__init__()
        self.counts, self.at = counts, []

    def write(self, s):
        self.at.extend(self.counts() for _ in range(s.count("\n")))
        return super().write(s)


def run_twin(mod, params, monkeypatch, *argv):
    """A twin's ``main`` (``mod``, from ``twin``) on the CPU with
    ``params``: (printed lines, the kernel wrappers' calls, the calls as
    each line was printed)."""
    with counted_kernels(monkeypatch) as calls:
        out = Printed(lambda: dict(calls))
        with contextlib.redirect_stdout(out):
            mod.main(["--device", "cpu", *argv], params=params)
    return out.getvalue().splitlines(), dict(calls), out.at


def no_wall(lines):
    return [WALL.sub("<wall>", line) for line in lines]


def chip_smoke():
    """``chip_smoke.py`` as a module (its top imports only the standard
    library), for the lines and launches phase 17 pins."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
