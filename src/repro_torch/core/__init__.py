"""Core: the paper's 2D distributed triangle-counting algorithm.

Public surface:

* :func:`count_triangles` — full pipeline (preprocess -> plan -> schedule);
  :func:`count_triangles_many` — many graphs in one engine call;
  :func:`count_triangles_delta` — a re-count after a batch of edge edits;
  :func:`make_grid_mesh` — a device mesh to spread the grid over.
* :class:`Graph`, generators (:func:`rmat`, :func:`erdos_renyi`, ...).
* :func:`build_plan` / :func:`plan_from_numpy` — host planner.
* schedules: :mod:`.cannon` (the paper's), :mod:`.summa` (rectangular
  grids), :mod:`.onedim` (the 1D-decomposition baseline the paper
  compares against).
"""
from .api import (  # noqa: F401
    TCResult,
    available_schedules,
    count_triangles,
    count_triangles_delta,
    count_triangles_many,
    get_schedule,
    make_grid_mesh,
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
