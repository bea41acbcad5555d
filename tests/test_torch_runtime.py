"""The port's serving runtime (a verbatim copy driving the PyTorch
engines) against the JAX one on ``micro`` with the same carried params:
identical ``summarize()`` repr and ``stats()``, and conservation holds.
The requests are tests/test_paged_decode.py's."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro.configs import get_config, load_all  # noqa: E402
from repro.core.coordinator import SAGAConfig as JSAGA  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.runtime import AgentRequest as JReq  # noqa: E402
from repro.serving.runtime import ServingRuntime as JRuntime  # noqa: E402
from repro.serving.server import MultiWorkerServer as JServer  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.coordinator import SAGAConfig as TSAGA  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving.runtime import AgentRequest as TReq  # noqa: E402
from repro_torch.serving.runtime import ServingRuntime as TRuntime  # noqa
from repro_torch.serving.server import MultiWorkerServer as TServer  # noqa

load_all()
CFG_J, CFG_T = get_config("micro"), tget("micro")
PARAMS_J = jlm.init_params(CFG_J, jax.random.PRNGKey(0))
PARAMS_T = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, PARAMS_J),
                               "cpu")


def _steps(n, n_steps=3, seed=0):
    """tests/test_paged_decode.py::_mk_requests, as plain step lists."""
    tools = ["code_execution", "web_api", "file_operations"]
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        steps = [(list(map(int, rng.randint(1, CFG_J.vocab, size=8))), 4,
                  tools[s % 3], float(rng.uniform(0.05, 0.5)))
                 for s in range(n_steps)]
        out.append((f"s{i}", f"t{i % 3}", steps))
    return out


@pytest.mark.parametrize("disaggregate", [False, True])
def test_runtime_matches_jax_runtime(disaggregate):
    results = []
    for Runtime, Req, SAGA, cfg, params in (
            (JRuntime, JReq, JSAGA, CFG_J, PARAMS_J),
            (TRuntime, TReq, TSAGA, CFG_T, PARAMS_T)):
        rt = Runtime(cfg, params, seed=0, n_workers=2, n_slots=2,
                     max_len=256, pool_blocks=96,
                     saga=SAGA(disaggregate=disaggregate))
        for sid, tenant, steps in _steps(5):
            rt.submit(Req(sid, tenant, steps))
        rt.run()
        rt.check_conservation()
        # summarize() and stats() count tokens and model virtual time,
        # not token values: greedy ids may part at a bf16 near-tie (a
        # top-2 logit gap below the frameworks' ~1e-3 logit difference)
        lens = {sid: len(rt.sessions[sid].ctx) for sid, _, _ in _steps(5)}
        results.append((repr(rt.summarize()), rt.stats(), lens))
    (sum_j, stats_j, lens_j), (sum_t, stats_t, lens_t) = results
    assert sum_t == sum_j
    assert stats_t == stats_j
    assert lens_t == lens_j
    assert stats_t["park_copy_bytes"] == 0
    assert stats_t["resume_copy_bytes"] == 0


def test_runtime_paged_vs_gather_summary_identical():
    """Twin of tests/test_paged_decode.py::
    test_runtime_paged_vs_gather_summary_identical on the port: paged and
    gather runtimes give the same summary; only the device-copy
    accounting differs (paged park/resume: 0).  The ids are not compared:
    a gather round writes its idle rows' K/V at position 0, into occupied
    slots too (``Engine.decode``), so the two modes may part on ids."""
    outs, stats = [], []
    for paged in (True, False):
        rt = TRuntime(CFG_T, PARAMS_T, seed=0, n_workers=2, n_slots=2,
                      max_len=256, pool_blocks=96, paged=paged)
        for sid, tenant, steps in _steps(5):
            rt.submit(TReq(sid, tenant, steps))
        rt.run()
        rt.check_conservation()
        outs.append(repr(rt.summarize()))
        stats.append(rt.stats())
    assert outs[0] == outs[1]
    p, g = stats
    assert p["park_copy_bytes"] == 0 and p["resume_copy_bytes"] == 0
    assert g["park_copy_bytes"] > 0 and g["resume_copy_bytes"] > 0
    assert p["regen_tokens"] == g["regen_tokens"]


def test_gather_runtime_matches_jax_gather_runtime():
    """The gather runtime against the reference's on the same carried
    params: the same summary, stats (copy bytes included) and context
    lengths."""
    results = []
    for Runtime, Req, cfg, params in ((JRuntime, JReq, CFG_J, PARAMS_J),
                                      (TRuntime, TReq, CFG_T, PARAMS_T)):
        rt = Runtime(cfg, params, seed=0, n_workers=2, n_slots=2,
                     max_len=256, pool_blocks=96, paged=False)
        for sid, tenant, steps in _steps(5):
            rt.submit(Req(sid, tenant, steps))
        rt.run()
        rt.check_conservation()
        lens = {sid: len(rt.sessions[sid].ctx) for sid, _, _ in _steps(5)}
        results.append((repr(rt.summarize()), rt.stats(), lens))
    assert results[1] == results[0]
    assert results[1][1]["park_copy_bytes"] > 0


def test_server_run_task_matches_jax_server():
    outs = []
    for Server, Req, cfg, params in ((JServer, JReq, CFG_J, PARAMS_J),
                                     (TServer, TReq, CFG_T, PARAMS_T)):
        srv = Server(cfg, params, n_workers=2, n_slots=2, max_len=128,
                     pool_blocks=32)
        runs = [srv.run_task(Req(sid, tenant, steps))
                for sid, tenant, steps in _steps(3, seed=1)]
        outs.append((runs, srv.stats()))
    assert outs[1] == outs[0]
