"""Runs a function on every rank of a world of thread-ranks
(``repro_torch.launch.mesh.threaded_world``) over a ("data", "model")
CPU mesh, for the sharded port tests: the ranks are threads of the test
process, so no test spawns processes or binds a port."""
import torch.distributed as dist

from repro_torch.launch.mesh import make_worker_mesh, threaded_world
from repro_torch.models.sharding import ShardingEnv, distribute


def on_mesh(dp: int, tp: int, fn, opts=None, timeout: float = 120.0):
    """``fn(env)`` on each rank of a (dp, tp) mesh; the ranks' results in
    rank order."""
    with threaded_world(dp * tp, timeout=timeout) as run:
        return run(lambda rank: fn(ShardingEnv(
            make_worker_mesh(dp * tp, tp=tp, device_type="cpu"), opts)))


def data_rows(tp: int):
    """``SameRouting``'s ``rows`` where a rank routes the tokens of its
    'data' coordinate's batch shard (all of them where the call routes
    every token)."""
    def rows(n, m):
        return 0 if n == m else (dist.get_rank() // tp) * m
    return rows


def replicated(t, env):
    """A tensor every rank holds whole as a replicated DTensor."""
    return distribute(t, env.named(t.shape, [None] * t.dim()))
