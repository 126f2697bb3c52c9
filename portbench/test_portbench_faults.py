"""Faults planted under a whole run (the look for a chip skipped) make
``correct`` come out false, once for each fault a served cell can have: a
step that leaves its state unchanged, half of the batch left out, a token
altered where it is produced. (The exchange between chips is not a fault
any cell can have: every cell runs on one chip.)"""
import pytest

from portbench import bench, smoke_cell


def _drop_kv_writes(monkeypatch):
    from repro_torch.models import transformer

    monkeypatch.setattr(transformer, "write_rows", lambda *a, **k: None)


def _drop_half_the_decode_lanes(monkeypatch):
    from repro_torch.models import transformer

    real = transformer.paged_decode_attention

    def half(q, kc, vc, tables, lengths, **kw):
        out = real(q, kc, vc, tables, lengths, **kw)
        out[out.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(transformer, "paged_decode_attention", half)


def _alter_tokens(monkeypatch):
    from repro_torch.serving.sampler import GreedySampler

    real = GreedySampler.__call__

    def altered(self, logits, keys=None):
        return (real(self, logits, keys) + 1) % logits.shape[-1]

    monkeypatch.setattr(GreedySampler, "__call__", altered)


FAULTS = {"state_unchanged": _drop_kv_writes, "half_the_batch": _drop_half_the_decode_lanes,
          "token_altered": _alter_tokens}


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, moe, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = bench.run_cell(smoke_cell.cell(moe), 2**31 + 29, 1.5, False, 0.0,
                         device="cpu", require_chip=False)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
