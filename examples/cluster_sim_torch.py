"""Simulate the paper's 64-GPU cluster: SAGA vs the full baseline matrix
on SWE-bench agents, with a worker crash injected mid-run.

    PYTHONPATH=src python examples/cluster_sim.py
"""
from repro_torch.cluster import baselines as B
from repro_torch.cluster.faults import crash_recover_plan
from repro_torch.cluster.simulator import ClusterSim, summarize
from repro_torch.cluster.workload import swebench_workload


def main():
    tasks = swebench_workload(n_tasks=150, rate_per_min=5.0, seed=0)
    print(f"{len(tasks)} SWE-bench agent tasks, 16 workers (64 GPUs), "
          "one worker crash at t~500s\n")
    plan = crash_recover_plan(16, horizon_s=1500.0, n_faults=1,
                              downtime_s=120.0, seed=1)
    header = (f"{'system':18s} {'TCT':>7s} {'p99':>7s} {'SLO':>5s} "
              f"{'hit':>5s} {'regen%':>7s} {'migr':>5s}")
    print(header)
    for name in ["vllm", "vllm_apc", "sglang", "llumnix",
                 "trt_scaffolding", "kvflow", "saga"]:
        sim = ClusterSim(tasks, B.ALL_BASELINES[name](), n_workers=16,
                         seed=0, fault_plan=plan)
        sim.run(horizon_s=86400)
        s = summarize(sim)
        print(f"{name:18s} {s['tct_mean']:6.0f}s {s['tct_p99']:6.0f}s "
              f"{s['slo_attainment']:5.2f} {s['cache_hit_rate']:5.2f} "
              f"{s['regen_time_frac']:7.2f} "
              f"{s['migrations_per_task']:5.2f}")
    print("\nAll tasks completed despite the crash (cache loss -> "
          "regeneration; affinity re-routes).")


if __name__ == "__main__":
    main()
