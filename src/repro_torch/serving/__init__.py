from .engine import Engine, EngineConfig
from .kv_slots import BlockAllocator, PagedSlotManager, PrefixCacheIndex, SlotManager
from .overload import OverloadPolicy, SLOAwareOverloadPolicy
from .profiler import OnlineProfiler
from .sampler import GreedySampler, Sampler, greedy
