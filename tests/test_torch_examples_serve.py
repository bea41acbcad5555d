"""The serving example twins ``examples/serve_agents_torch.py`` and
``examples/serve_runtime_torch.py`` on the CPU against the reference's
examples: with the reference's micro params carried over
(``lm.params_from_jax``), every printed line equals the reference's but
the wall figure.  Those lines count tokens and virtual time, which is why
``chip_smoke.py`` phase 17 pins them for the card, where the weights are
the port's own seeded init; the kernel wrappers' calls here (one launch a
call on the card) are the launches it pins."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # micro: threads only add overhead

import torch_examples as E  # noqa: E402


@pytest.fixture(scope="module")
def params():
    return E.carried_micro_params()


@pytest.mark.parametrize("name", ["serve_agents", "serve_runtime"])
def test_twin_prints_the_reference_s_lines(name, params, monkeypatch):
    want = E.run_reference(name)
    got, calls, _ = E.run_twin(E.twin(name), params, monkeypatch)
    assert E.no_wall(got) == E.no_wall(want)
    assert len(E.WALL.findall("\n".join(got))) == 2
    smoke = E.chip_smoke()
    assert E.no_wall(got) == smoke.EXAMPLE_LINES[name]
    assert calls == smoke.EXAMPLE_LAUNCHES[name]
