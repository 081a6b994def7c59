"""What a cell is, read from data: ``BENCHMARK.json`` names the cell's
configuration, traffic mix and metrics; each of those is a file of its own
under this directory, found by its name.

  configs/<config>.json    the model's sizes as the port's ``ArchConfig``
                           takes them ("model"), how its weights are drawn
                           ("init"), the source and every departure
  mixes/<traffic>.json     the traffic's parameters; "kind" names the
                           driver, drivers/<kind>.py
  metrics/<metric>.py      one reader a metric: ``read(run)`` -> a number,
                           or None where the run has nothing to read
  limits/<workload>.json   each number the correctness check compares,
                           with its limit and the readings it was set from
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the port's ArchConfig fields, with its defaults: the sizes a config file
# may leave out
MODEL_DEFAULTS = {
    "head_dim": 0, "qk_norm": False, "qkv_bias": False,
    "sliding_window": None, "rope_theta": 1e4, "n_experts": 0,
    "experts_per_token": 0, "moe_dense_residual": False,
    "capacity_factor": 1.25, "attn_free": False, "hybrid_ssm": False,
    "ssm_state": 0, "rwkv_head_dim": 64, "embedding_stub": False,
    "tie_embeddings": False, "norm_eps": 1e-5, "grad_accum": 1,
    "remat": True, "optimizer": "adamw", "param_dtype": "bfloat16",
    "source": "",
}


def model(sizes: dict) -> SimpleNamespace:
    """The model's sizes as attributes, the port's defaults filled in, and
    ``hd`` as the port derives it."""
    m = SimpleNamespace(**{**MODEL_DEFAULTS, **sizes})
    m.hd = m.head_dim or m.d_model // max(1, m.n_heads)
    return m


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` under ``name`` (metric files carry
    dots in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    config: dict                 # configs/<config>.json
    mix: dict                    # mixes/<traffic>.json
    limits: dict                 # limits/<workload>.json: {number: limit}
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)

    @property
    def model(self) -> SimpleNamespace:
        """The sizes the cell runs: the config's, with the mix's
        microbatches as the port's ``grad_accum``."""
        sizes = dict(self.config["model"])
        if "microbatches" in self.mix:
            sizes["grad_accum"] = self.mix["microbatches"]
        return model(sizes)

    def arch(self):
        """The port's ``ArchConfig`` for ``model``."""
        from repro_torch.configs.base import ArchConfig
        m = vars(self.model).copy()
        m.pop("hd")
        return ArchConfig(**m)


def _reported(entry: dict, workload: str, e2e_names: set) -> bool:
    if "workloads" in entry:
        return workload in entry["workloads"]
    return entry.get("moves", entry["name"]) in e2e_names


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"
              ) -> Cell:
    bench = read_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path}; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT / configs[w["config"]]["file"])
    mix = read_json(HERE / "mixes" / f"{w['traffic']}.json")
    limits = read_json(HERE / "limits" / f"{workload}.json")["limits"]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reported(m, workload, names)]
    return Cell(workload, config, mix, limits, e2e, per_layer)


def reader(metric: str):
    """metrics/<metric>.py's ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    return load_module(path, "cardbench_metric_" + metric.replace(".", "_"
                                                                  )).read
