"""Scheduler decision audit log.

Every priced decision the serving stack makes — the Lagrangian
``prefill_share`` evaluation, dispatch ``_placement_cost`` comparison,
steal/migration gates, replica condemnations, overload deferrals — is
recorded with the inputs it priced and the output it chose, so any
decision in a serve is explainable post-hoc ("why did the policy insert a
prefill here?") and two ablation runs diff structurally instead of by
eyeballing Gantts.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional


@dataclasses.dataclass
class AuditRecord:
    """One priced decision: what was weighed, what was chosen."""

    kind: str            # "prefill_share", "dispatch", "steal_gate", ...
    t: float             # fleet virtual time of the decision
    replica: int         # replica evaluating (or being decided about)
    inputs: Dict[str, object]   # the priced inputs, as computed
    chosen: object       # the decision output (share, replica id, verdict)


class AuditLog:
    """Append-only log of :class:`AuditRecord`."""

    def __init__(self) -> None:
        self.records: List[AuditRecord] = []

    def record(
        self,
        kind: str,
        t: float,
        replica: int,
        inputs: Dict[str, object],
        chosen: object,
    ) -> AuditRecord:
        rec = AuditRecord(
            kind=kind, t=float(t), replica=replica,
            inputs=dict(inputs), chosen=chosen,
        )
        self.records.append(rec)
        return rec

    def of_kind(self, kind: str) -> List[AuditRecord]:
        return [r for r in self.records if r.kind == kind]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.kind] = out.get(r.kind, 0) + 1
        return out

    # ---------------------------------------------------------------- #
    # Checkpointing (JSON string: survives tree_map(np.asarray))        #
    # ---------------------------------------------------------------- #
    def state_dict(self) -> str:
        return json.dumps([dataclasses.asdict(r) for r in self.records])

    def load_state_dict(self, blob: str) -> None:
        self.records = [AuditRecord(**r) for r in json.loads(blob)]
