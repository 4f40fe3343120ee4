"""Config registry and the triangle-count graph configs.

The JAX package's module of the same name registers every architecture it
dry-runs (language models, GNNs, recsys) beside the paper's graphs.  The
port carries the registry and :class:`TCGraphConfig` with the same fields
and defaults; the model configs and their shape tables come with the model
families.  :func:`get_config` of a name the port does not register raises
``KeyError`` listing the names it has.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

__all__ = ["TCGraphConfig", "register", "get_config", "list_configs"]

_REGISTRY: Dict[str, Callable[[], object]] = {}


def register(name: str):
    """Register ``fn`` (a zero-argument config factory) under ``name``."""

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _import_configs() -> None:
    from . import tc_graphs  # noqa: F401  (registers on import)


def get_config(name: str):
    """A fresh config registered under ``name``."""
    if name not in _REGISTRY:
        _import_configs()
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs():
    """Every registered config name, sorted."""
    _import_configs()
    return sorted(_REGISTRY)


@dataclasses.dataclass
class TCGraphConfig:
    """The paper's own evaluation graphs (Table 1)."""

    name: str
    n_vertices: int
    n_edges: int
    n_triangles: int
    dmax_block_est: int  # planner estimate for the analytic dry-run plan
    family: str = "tc"
