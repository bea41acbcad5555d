"""What a run reads from files: the cell's entry in ``BENCHMARK.json``, its
configuration, traffic and cell sizing, and the metric readers, all found
by the names the entry gives.

* ``configs/<config>.json``: the model's published ``config.json`` keys
  (as the file's ``source`` gives them), with the keys cut for one card
  listed under ``reduced``;
* ``traffic/<traffic>.json``: one traffic mix: the generator, the
  population of agents, and the economics of their tasks, given in full
  or as the name of a file of ``traffic/economics/`` that the mix's own
  keys then override (``traffic.py`` reads it);
* ``cells/<workload>.json``: the cell's deployment on the card: the
  population, the engine's slots and pool, the virtual clock's rates, and
  the limits ``correct`` holds the run to;
* ``metrics/<metric>.py``: one reader a metric, ``read(record)`` giving a
  number or None where the run had nothing to read.

A later cell or metric is new files and new entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, Iterable, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level modules no run may hold: JAX and the reference package the
# port was made from (compared whole: ``repro_torch`` is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> Dict:
    """The workload ``name`` of ``root``'s ``BENCHMARK.json``, with its
    config, traffic and cell files read, and the metrics it reports with
    and without a trace."""
    bench = load_json(root / "BENCHMARK.json")
    here = root / BENCH.name
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(wl)}")
    w = wl[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])

    def reports(m: Dict) -> bool:
        return name in m.get("workloads", [name])

    return {
        "workload": w,
        "config": load_json(root / entry["file"]),
        "traffic": traffic_mix(w["traffic"], root),
        "sizing": load_json(here / "cells" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def traffic_mix(name: str, root: Path = ROOT) -> Dict:
    """``traffic/<name>.json`` over the economics it names, if any."""
    here = root / BENCH.name / "traffic"
    t = load_json(here / f"{name}.json")
    if "economics" not in t:
        return t
    mix = load_json(here / "economics" / f"{t['economics']}.json")
    mix.update(t)
    return mix


def model_sizes(c: Dict) -> Dict:
    """The harness's sizes of a decoder from its published config keys."""
    H = c["num_attention_heads"]
    return {
        "name": c["name"],
        "n_layers": c["num_hidden_layers"],
        "d_model": c["hidden_size"],
        "n_heads": H,
        "n_kv_heads": c["num_key_value_heads"],
        "head_dim": c.get("head_dim") or c["hidden_size"] // H,
        "d_ff": c["intermediate_size"],
        "vocab": c["vocab_size"],
        "n_experts": c.get("num_local_experts", 0),
        "top_k": c.get("num_experts_per_tok", 0),
        "window": c.get("sliding_window") or 0,
        "rope_theta": float(c["rope_theta"]),
        "norm_eps": float(c["rms_norm_eps"]),
        "tie": bool(c.get("tie_word_embeddings", False)),
        "dtype": c["torch_dtype"],
        "init_std": float(c["initializer_range"]),
    }


def model_config(m: Dict):
    """The program's ``ModelConfig`` for sizes ``m``."""
    from repro_torch.configs.base import ModelConfig
    if m["dtype"] != "bfloat16" or m["tie"]:
        raise ValueError(f"{m['name']}: the harness serves untied bf16 "
                         f"decoders")
    return ModelConfig(
        name=m["name"], family="moe" if m["n_experts"] else "dense",
        n_layers=m["n_layers"], d_model=m["d_model"], n_heads=m["n_heads"],
        n_kv_heads=m["n_kv_heads"], head_dim=m["head_dim"], d_ff=m["d_ff"],
        vocab=m["vocab"], n_experts=m["n_experts"], top_k=m["top_k"],
        sliding_window=m["window"], rope_theta=m["rope_theta"],
        norm_eps=m["norm_eps"])


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``metrics/<metric>.py``'s ``read``."""
    path = root / BENCH.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})
