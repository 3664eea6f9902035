"""Discrete configuration search spaces (paper §2.2, Table 2).

A :class:`ConfigSpace` is the Cartesian product of named discrete parameters.
Demeter's GPs operate on points normalized to the unit hypercube; the space
provides the bijection between raw configuration dicts, integer index tuples
and normalized vectors.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Parameter:
    """One discrete configuration parameter with an ordered value set."""

    name: str
    values: Tuple[float, ...]

    @staticmethod
    def ranged(name: str, lo: float, hi: float, step: float) -> "Parameter":
        n = int(round((hi - lo) / step)) + 1
        return Parameter(name, tuple(lo + i * step for i in range(n)))

    @property
    def cardinality(self) -> int:
        return len(self.values)

    def normalize(self, value: float) -> float:
        """Map a raw value to [0, 1] by its index (robust to uneven grids)."""
        idx = self.index_of(value)
        if self.cardinality == 1:
            return 0.0
        return idx / (self.cardinality - 1)

    def index_of(self, value: float) -> int:
        arr = np.asarray(self.values)
        idx = int(np.argmin(np.abs(arr - value)))
        if not np.isclose(arr[idx], value):
            raise ValueError(f"{value!r} not in parameter {self.name}: {self.values}")
        return idx


@dataclass(frozen=True)
class ConfigSpace:
    """Cartesian product of discrete parameters (paper Table 2 style)."""

    parameters: Tuple[Parameter, ...]
    # Optional validity predicate pruning raw combinations (e.g. slots <= cores).
    constraint: Callable[[Mapping[str, float]], bool] | None = field(default=None)

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_table(table: Mapping[str, Tuple[float, float, float]],
                   constraint: Callable[[Mapping[str, float]], bool] | None = None,
                   ) -> "ConfigSpace":
        params = tuple(Parameter.ranged(k, lo, hi, st)
                       for k, (lo, hi, st) in table.items())
        return ConfigSpace(params, constraint)

    # -- basic queries -----------------------------------------------------
    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.parameters)

    @property
    def dim(self) -> int:
        return len(self.parameters)

    def cardinality(self) -> int:
        return len(self.enumerate())

    # -- enumeration -------------------------------------------------------
    def enumerate(self) -> List[Dict[str, float]]:
        """All valid configurations as dicts (cached)."""
        cached = getattr(self, "_cache", None)
        if cached is None:
            combos = itertools.product(*(p.values for p in self.parameters))
            cached = [dict(zip(self.names, c)) for c in combos]
            if self.constraint is not None:
                cached = [c for c in cached if self.constraint(c)]
            object.__setattr__(self, "_cache", cached)
        return cached

    def matrix(self) -> np.ndarray:
        """All valid configurations, normalized, as an (n, dim) float array."""
        cached = getattr(self, "_matrix", None)
        if cached is None:
            cached = np.stack([self.encode(c) for c in self.enumerate()])
            object.__setattr__(self, "_matrix", cached)
        return cached

    # -- encode / decode ---------------------------------------------------
    def encode(self, config: Mapping[str, float]) -> np.ndarray:
        return np.array([p.normalize(config[p.name]) for p in self.parameters],
                        dtype=np.float64)

    def decode(self, x: Sequence[float]) -> Dict[str, float]:
        out = {}
        for p, v in zip(self.parameters, x):
            idx = int(round(float(v) * (p.cardinality - 1)))
            idx = min(max(idx, 0), p.cardinality - 1)
            out[p.name] = p.values[idx]
        return out

    def index(self, config: Mapping[str, float]) -> int:
        """Position of ``config`` within :meth:`enumerate` order."""
        key = tuple(config[n] for n in self.names)
        lookup = getattr(self, "_index", None)
        if lookup is None:
            lookup = {tuple(c[n] for n in self.names): i
                      for i, c in enumerate(self.enumerate())}
            object.__setattr__(self, "_index", lookup)
        return lookup[key]


def paper_flink_space() -> ConfigSpace:
    """The exact search space of paper Table 2 (2592 combinations)."""
    return ConfigSpace.from_table({
        "workers": (4, 24, 4),
        "cpu_cores": (1, 3, 1),
        "memory_mb": (1024, 4096, 1024),
        "task_slots": (1, 4, 1),
        "checkpoint_interval_s": (10, 90, 10),
    })


def tpu_serving_space(max_replicas: int = 16) -> ConfigSpace:
    """TPU-serving analogue of Table 2 (DESIGN.md §2 mapping).

    replicas×tp_degree is capped at the pod slice we control; decode slots
    and KV block budget are per replica; snapshot interval is the engine
    state checkpoint cadence.
    """
    params = (
        Parameter("replicas", tuple(range(1, max_replicas + 1))),
        Parameter("tp_degree", (1, 2, 4, 8)),
        Parameter("kv_blocks", (1024, 2048, 4096, 8192)),
        Parameter("decode_slots", (8, 16, 32, 64)),
        Parameter("snapshot_interval_s", (10, 30, 60, 90)),
    )

    def valid(c: Mapping[str, float]) -> bool:
        return c["replicas"] * c["tp_degree"] <= max_replicas * 8

    return ConfigSpace(params, valid)


def tpu_training_space(max_nodes: int = 32) -> ConfigSpace:
    """Elastic-training analogue: DP nodes, TP, microbatch, remat, ckpt."""
    params = (
        Parameter("dp_nodes", (4, 8, 12, 16, 24, 32)),
        Parameter("tp_degree", (1, 2, 4, 8)),
        Parameter("microbatch", (1, 2, 4, 8)),
        Parameter("remat", (0, 1, 2)),  # 0=none, 1=selective, 2=full
        Parameter("checkpoint_interval_s", (30, 60, 120, 240, 480)),
    )

    def valid(c: Mapping[str, float]) -> bool:
        return c["dp_nodes"] <= max_nodes

    return ConfigSpace(params, valid)
