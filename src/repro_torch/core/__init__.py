"""Core: the paper's 2D distributed triangle-counting algorithm.

Public surface:

* :func:`count_triangles` — full pipeline (preprocess -> plan -> schedule).
* :class:`Graph`, generators (:func:`rmat`, :func:`erdos_renyi`, ...).
* :func:`build_plan` / :func:`plan_from_numpy` — host planner.
* schedule: :mod:`.cannon` (the paper's).
"""
from .api import (  # noqa: F401
    TCResult,
    available_schedules,
    count_triangles,
    get_schedule,
    register_schedule,
)
from .graph import Graph, triangle_count_oracle  # noqa: F401
from .generators import (  # noqa: F401
    erdos_renyi,
    graph_from_spec,
    named_graph,
    powerlaw,
    residue_cliques,
    rmat,
    star,
)
from .plan import TCPlan, as_plan, build_plan, plan_from_numpy  # noqa: F401
from .preprocess import degree_order, preprocess  # noqa: F401
