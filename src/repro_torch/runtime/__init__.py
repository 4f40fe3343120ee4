"""Runtime: elasticity, plan rebalancing, fault handling, deterministic
fault injection, and the restart supervisor."""
from .elastic import best_grid, replan_elastic  # noqa: F401
from .rebalance import rebalance_plan  # noqa: F401
from .fault import run_with_restarts  # noqa: F401
from .faultinject import (  # noqa: F401
    CkptCorrupt,
    DeviceLost,
    FaultPlan,
    InjectedFault,
    StageFault,
    StepFault,
)
from .supervisor import (  # noqa: F401
    BackoffPolicy,
    GridTransferRefused,
    Supervisor,
    supervised_count,
    supervise_loop,
)
