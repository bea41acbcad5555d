"""The port's twins of reference test modules, made from their source.

``twin_source("test_client.py")`` is that test module with ``repro``
renamed to ``repro_torch`` as a whole word (the rule the port's verbatim
copies follow, tests/test_torch_lockstep.py) and the JAX micro params
replaced by the port's own seeded init on the CPU: every
``lm.init_params(<cfg>, jax.random.PRNGKey(0))`` line, at module top, in
a fixture or in a child process's snippet, with every ``import jax`` line
(indented or not) dropped.  A twin module execs it, so its tests are the
reference's, run on the port's copies."""
import re
from pathlib import Path

JAX_PARAMS = re.compile(
    r"lm\.init_params\((\w+), jax\.random\.PRNGKey\(0\)\)")
TORCH_PARAMS = r'lm.init_params(\1, seed=0, device="cpu")'
JAX_IMPORT = re.compile(r"^[ \t]*import jax\n", re.M)


def twin_source(name: str) -> str:
    src = (Path(__file__).resolve().parent / name).read_text()
    src = re.sub(r"\brepro\b", "repro_torch", src)
    if JAX_IMPORT.search(src):
        src, n = JAX_PARAMS.subn(TORCH_PARAMS, src)
        assert n >= 1, f"{name}: params line moved"
        src = JAX_IMPORT.sub("", src)
    assert not re.search(r"\bjax\b", src), f"{name} still uses jax"
    return src
