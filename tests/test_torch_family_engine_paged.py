"""Port parity, the paged mixed-step engine on the decoders of
``test_torch_family_engine_dense`` that the reference's paged layout takes
(all but Mixtral-8x22B): the port's ``Engine`` against the JAX ``Engine``
under hybrid scheduling — identical streams, the same stage kinds, tokens,
chunk tokens and rounds, equal counters. Mixtral's sliding window is
refused on the paged layout with the reference's error, by both engines."""
import pytest

from repro.serving.engine import Engine as RefEngine
from repro.serving.engine import EngineConfig as RefEngineConfig
from repro_torch.serving.engine import Engine, EngineConfig
from torch_port_family import both_serves, check_same_serve, engine_settings
from torch_port_helpers import PAGED_FAMILY_ARCHS, family_models


@pytest.mark.parametrize("arch", PAGED_FAMILY_ARCHS)
def test_paged_mixed_engine_matches_reference(arch):
    check_same_serve(both_serves(arch, "paged"), "paged")


def test_mixtral_paged_raises_the_reference_error():
    ref_model, ref_params, model, params = family_models("mixtral_8x22b")
    msg = "paged KV cache does not support sliding-window configs"
    with pytest.raises(NotImplementedError, match=msg):
        RefEngine(ref_model, ref_params, RefEngineConfig(**engine_settings("paged")))
    with pytest.raises(NotImplementedError, match=msg):
        Engine(model, params, EngineConfig(**engine_settings("paged")), device="cpu")
