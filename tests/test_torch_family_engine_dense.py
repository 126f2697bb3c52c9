"""Port parity, the dense-layout engine on every decoder the reference's
Engine serves beside Qwen3 (the smoke Granite-3-8B, LLaMA-65B,
StarCoder2-7B, Nemotron-4-15B, OLMoE-1B-7B, Mixtral-8x22B on its ring cache
and Qwen2-VL-7B), every parameter perturbed off its init: under hybrid
scheduling, the port's ``Engine`` against the JAX ``Engine`` — identical
``Engine.generated`` streams, the same stage kinds, tokens and rounds, equal
decode dispatches, mixed rounds, preemptions and prefill stall, and, under
the scripted clock both read, the same stage times and summary. The cost
model is pinned (no refits) and straggler mitigation is off on both engines.
Also: the port's launcher serves each arch of its ``ENGINE_ARCHS`` on the
CPU."""
import pytest

from repro_torch.launch import serve as port_launcher
from torch_port_family import both_serves, check_same_serve
from torch_port_helpers import FAMILY_ARCHS


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_dense_engine_matches_reference(arch):
    serves = both_serves(arch, "dense")
    check_same_serve(serves, "dense")
    (_, ref_trace), (_, trace) = serves
    # a prefill stage froze active decoders on both sides
    assert trace.meta["prefill_stall_time_s"] > 0 and ref_trace.meta["prefill_stall_time_s"] > 0


@pytest.mark.parametrize("arch", port_launcher.ENGINE_ARCHS)
def test_launcher_serves_each_engine_arch_on_the_cpu(arch, capsys):
    port_launcher.main(["--arch", arch, "--device", "cpu", "--requests", "4", "--slots", "2"])
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("policy=hybrid device=cpu util=") and "tok/s" in line
