"""``examples/workflow_api_torch.py`` on the CPU against
``examples/workflow_api.py``: with the reference's micro params carried
over, every printed line is the reference's, the dynamic agent's steps
and ``tct`` included (it branches on decoded token values, so it needs
the same weights).  The graph's paths and its hit / regen line do not
depend on the weights: ``chip_smoke.py`` phase 17 pins them, and the
kernel wrappers' calls made before the dynamic agent, for the card."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # micro: threads only add overhead

import torch_examples as E  # noqa: E402

DYNAMIC = "== dynamic-callback program (branches on decoded tokens)"


def test_twin_prints_the_reference_s_lines(monkeypatch):
    want = E.run_reference("workflow_api")
    got, _, _ = E.run_twin(E.twin("workflow_api"), E.carried_micro_params(),
                           monkeypatch)
    assert got == want
    assert any(line.startswith("  dyn-agent: 5 steps,") and "tct=" in line
               for line in got)


def test_graph_lines_and_launches_are_phase_17_s(monkeypatch):
    """The lines before the dynamic agent, and the wrappers' calls made
    before it, are those phase 17 pins, whatever the weights (the port's
    own seeded init here)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    smoke = E.chip_smoke()
    params = lm.init_params(get_config("micro"), seed=0, device="cpu")
    lines, _, at = E.run_twin(E.twin("workflow_api"), params,
                                  monkeypatch)
    i = lines.index(DYNAMIC)
    assert lines[:i] == smoke.EXAMPLE_LINES["workflow_api"]
    assert at[i] == smoke.EXAMPLE_LAUNCHES["workflow_api graph"]
    assert smoke.EXAMPLE_DYNAMIC == DYNAMIC
