"""Per-(arch x cell) runtime knobs for the dry-run and launchers
(counterpart of ``repro.launch.plan``, whose table is sized for a 16 GB
TPU v5e).

The port's table is its own, sized for an 80 GB H100: each train cell takes
the fewest microbatches whose per-device peak in the port's dry-run
(``python -m repro_torch.launch.dryrun --shape train_4k --microbatches N``
on the fake 16 x 16 world) stays under ``PEAK_BUDGET_BYTES``; serve cells
run unbatched. PERF.md's dry-run table gives each cell's peak.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..distributed.sharding import ShardingConfig
from .mesh import HBM_BYTES

#: the per-device peak a plan must stay under: 90% of the card's 80 GB, the
#: rest left to the CUDA context, the caching allocator's fragmentation and
#: the kernels' cached scratch
PEAK_BUDGET_BYTES = 0.9 * HBM_BYTES

# (arch, cell) -> microbatches for training: the fewest whose dry-run peak a
# device on 16 x 16 stays under PEAK_BUDGET_BYTES (global batch 256 x 4096);
# every other train cell peaks under it with one (PERF.md's dry-run table:
# Mixtral-8x22B 82.3 GB with one, 46.2 with two; Granite-3-8B 82.2 and
# 44.8, its vocabulary of 49,155 not divisible by the model axis, so its
# float32 logits are replicated over it).
MICROBATCHES: Dict[Tuple[str, str], int] = {
    ("mixtral_8x22b", "train_4k"): 2,
    ("granite_3_8b", "train_4k"): 2,
}

# Whisper serve-cell geometry, as in the reference:
# prefill_32k = 32k encoder frames + 448-token decoder prompt;
# decode_32k  = one decoder token against a 32k self-KV + 1536 cross-KV.
WHISPER_DECODER_PROMPT = 448
WHISPER_CROSS_LEN = 1536

# Serve-time weights stay FSDP-sharded only where TP-only weights do not fit
# the card. On 80 GB none of the archs needs it: Mixtral-8x22B's 282 GB of
# bf16 weights over a model axis of 16 are 17.6 GB a card, which forced FSDP
# on the 16 GB v5e and fits here.
FSDP_AT_SERVE: set = set()
# xlstm's 0.2B params never warrant FSDP (as in the reference).
NEVER_FSDP = {"xlstm_350m"}


def plan_for(arch: str, cell_name: str, multi_pod: bool = False,
             overrides: Optional[dict] = None) -> dict:
    is_serve = cell_name in ("prefill_32k", "decode_32k", "long_500k")
    fsdp = True
    if arch in NEVER_FSDP:
        fsdp = False
    elif is_serve and arch not in FSDP_AT_SERVE:
        fsdp = False
    mb = MICROBATCHES.get((arch, cell_name), 1)
    if multi_pod and mb > 1:
        # 2 pods double the DP width to 32: a microbatch's batch must stay
        # divisible by it (256 / mb % 32 == 0 -> mb <= 8), as in the reference
        mb = min(mb, 8)
    plan = {
        "microbatches": mb,
        "remat": True,
        "sharding": ShardingConfig(
            dp_axes=("pod", "data") if multi_pod else ("data",),
            fsdp_weights=fsdp,
        ),
    }
    if overrides:
        plan.update(overrides)
    return plan
