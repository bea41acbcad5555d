"""The port's twins of reference test modules, made from their source.

``twin_source("test_client.py")`` is that test module with ``repro``
renamed to ``repro_torch`` as a whole word (the rule the port's verbatim
copies follow, tests/test_torch_lockstep.py) and the JAX micro params
replaced by the port's own seeded init on the CPU.  A twin module execs
it, so its tests are the reference's, run on the port's copies."""
import re
from pathlib import Path

JAX_PARAMS = "lm.init_params(CFG, jax.random.PRNGKey(0))"
TORCH_PARAMS = 'lm.init_params(CFG, seed=0, device="cpu")'


def twin_source(name: str) -> str:
    src = (Path(__file__).resolve().parent / name).read_text()
    src = re.sub(r"\brepro\b", "repro_torch", src)
    if "import jax\n" in src:
        assert src.count(JAX_PARAMS) == 1, f"{name}: params line moved"
        src = src.replace("import jax\n", "").replace(JAX_PARAMS,
                                                      TORCH_PARAMS)
    assert not re.search(r"\bjax\b", src), f"{name} still uses jax"
    return src
