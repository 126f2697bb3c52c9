# The paper's primary contribution: hybrid offline-online scheduling for
# LLM inference under PD Competition (MIP + binpack + Algorithm 1 +
# Lagrangian iteration rule), shared by the simulator and the real engine.
# Verbatim copies of the reference package's framework-free modules (numpy
# and scipy only), kept here so the port imports nothing of the reference.
from .types import (
    Request,
    ClientState,
    StageKind,
    StageRecord,
    ScheduleTrace,
    FleetReport,
    Phase,
    make_requests,
)
from .cost_model import CostModel, PrefillLevel, PAPER_COST_MODEL
from .offline import (
    OfflineResult,
    LowerBound,
    solve_offline,
    lpt_assign,
    local_search,
    milp_assign,
    round_robin_assign,
    evaluate_assignment,
    split_requests,
    request_weights,
    theoretical_lower_bound,
)
from .hetero import (
    ReplicaSpec,
    replica_request_weight,
    hetero_weights,
    hetero_lpt_assign,
    hetero_local_search,
    hetero_lp_lower_bound,
    hetero_theoretical_lower_bound,
    solve_hetero,
    evaluate_hetero_assignment,
)
from .online import (
    RequestScheduler,
    StaticBacklogScheduler,
    SortingPreemptiveScheduler,
    GlobalQueueScheduler,
    ArrivalQueueScheduler,
    build_clients,
)
from .iteration import (
    IterationPolicy,
    PrefillFirstPolicy,
    DecodeFirstPolicy,
    LagrangianPolicy,
    BalancedLagrangianPolicy,
    AmortizedPolicy,
    UtilizationWeightedPolicy,
    DynamicBatchPolicy,
    TimedPolicy,
    SystemSnapshot,
    CandidateBatch,
    POLICIES,
    make_policy,
)
from .simulator import Simulator, SimConfig, simulate
from .mip import OriginalMIP, MIPSolution, toy_instance, recost_trace_mip_semantics
