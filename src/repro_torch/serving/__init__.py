from ..core.hetero import ReplicaSpec
from .engine import Engine, EngineConfig, SlotCheckpoint
from .fleet import (
    DISPATCH_POLICIES,
    FaultPlan,
    Fleet,
    FleetConfig,
    LeastLoadDispatch,
    ReplicaDispatchPolicy,
    ReplicaFault,
    RoundRobinDispatch,
)
from .health import (
    ALIVE,
    CONDEMNED,
    SUSPECT,
    HealthConfig,
    ReplicaHealthMonitor,
)
from .kv_slots import (
    BlockAllocator,
    PageIntegrityError,
    PagedSlotManager,
    PrefixCacheIndex,
    SlotManager,
    page_checksum,
)
from .overload import OverloadPolicy, SLOAwareOverloadPolicy
from .profiler import OnlineProfiler
from .sampler import GreedySampler, Sampler, greedy
