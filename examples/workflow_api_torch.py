"""AgentProgram API demo on the PyTorch port: explicit-graph and
dynamic-callback workflows on the micro model (the twin of
``examples/workflow_api.py``).

Shows the two submission flavors the unified API adds on top of
scripted requests (paper §3.1-§3.3):

  1. an explicit Agent Execution Graph with a retry loop — the branch
     structure is DECLARED to the scheduler (tier-a observability) and
     EXECUTED by a seeded resolver, so you can watch a retry edge being
     taken and the resumed step hitting its parked KV;
  2. a dynamic client callback that decides the next step from the real
     decoded tokens — the workflow's shape is not known in advance.

Both run through ``ServingRuntime.submit`` -> ``WorkflowHandle`` and,
for the graph flavor, the SAME spec also drives the discrete-event
cluster simulator — one submission API across both substrates.  The
graph's paths, hits and regenerated tokens do not depend on the weights;
the dynamic agent's steps and ``tct`` do (it branches on token values).
Params are the port's seeded init on ``--device`` (default ``cuda``; ask
for ``--device cpu`` to run on the CPU).

    PYTHONPATH=src python examples/workflow_api_torch.py [--device cpu]
"""
import argparse

from repro_torch.cluster import baselines as B
from repro_torch.cluster.simulator import ClusterSim, summarize
from repro_torch.configs import get_config, load_all
from repro_torch.models import lm
from repro_torch.serving.runtime import ServingRuntime
from repro_torch.workflow import AgentProgram, StepSpec


def make_retry_graph(i: int) -> AgentProgram:
    """plan -> edit -> test (30% fail -> back to edit) -> commit."""
    nodes = {0: StepSpec("file_operations", 14, 3, tool_latency_s=0.05),
             1: StepSpec("code_execution", 10, 3, tool_latency_s=0.10),
             2: StepSpec("code_execution", 8, 2, tool_latency_s=0.20),
             3: StepSpec("database_query", 6, 2, tool_latency_s=0.05)}
    edges = [(0, 1, 0.98), (1, 2, 0.98),
             (2, 1, 0.30),              # retry: test failed, re-edit
             (2, 3, 0.68)]              # pass: commit
    return AgentProgram.graph(f"fix-{i}", f"team{i % 2}", nodes, edges,
                              seed=i, max_steps=12)


def dynamic_agent(ctx):
    """Client-side control flow: look at the last decoded token and
    decide what to do next (ctx.rng keeps replays deterministic)."""
    if ctx.step_idx < 0:                       # first step
        return StepSpec("code_execution", prompt_ids=[7, 8, 9, 10],
                        n_out=3, tool_latency_s=0.05)
    if ctx.step_idx >= 4:
        return None                            # agent decides: done
    last = ctx.outputs[-1][-1]
    if last % 3 == 0:
        return StepSpec("web_api", prompt_ids=[(last % 60) + 1] * 6,
                        n_out=2, tool_latency_s=0.1)
    return StepSpec("file_operations", prompt_ids=[(last % 60) + 1] * 4,
                    n_out=2, tool_latency_s=0.05)


def main(argv=None, params=None) -> None:
    """``params``: a params tree to serve instead of the seeded init (the
    tests pass the reference's, carried by ``lm.params_from_jax``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    load_all()
    cfg = get_config("micro")
    if params is None:
        params = lm.init_params(cfg, seed=0, device=args.device)
    rt = ServingRuntime(cfg, params, n_workers=2, n_slots=2,
                        max_len=256, pool_blocks=96, seed=0)

    print("== explicit-graph programs (retry loop declared + executed)")
    handles = [rt.submit(make_retry_graph(i)) for i in range(6)]
    rt.run()
    rt.check_conservation()
    for h in handles:
        retried = any(b <= a for a, b in zip(h.path, h.path[1:]))
        print(f"  {h.session_id}: path={h.path}"
              f"{'  <- retry taken' if retried else ''}")
    s = rt.summarize()
    print(f"  cache hits {s['cache_hits']} (delta-only resumes), "
          f"regen {s['regen_tokens']} of {s['prefill_tokens']} "
          f"prefilled tokens")

    print("== dynamic-callback program (branches on decoded tokens)")
    h = rt.submit(AgentProgram.dynamic("dyn-agent", "team0",
                                       dynamic_agent,
                                       planned_tools=["code_execution"]))
    outs = h.result()                          # drives the virtual clock
    print(f"  {h.session_id}: {len(outs)} steps, "
          f"tools per step resolved at run time, tct={h.tct:.3f}s")

    print("== the same graph spec on the cluster simulator")
    sim = ClusterSim([make_retry_graph(i) for i in range(6)],
                     B.saga(), n_workers=2, seed=0)
    sim.run(horizon_s=3600)
    sim.check_conservation()
    ss = summarize(sim)
    same = all(sim.tasks[h.session_id].path == h.path for h in handles)
    print(f"  {ss['n_tasks']} programs finished, identical taken paths "
          f"across substrates: {same}")


if __name__ == "__main__":
    main()
