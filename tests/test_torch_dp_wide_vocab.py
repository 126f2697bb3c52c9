"""The compressed data-parallel step at Qwen3's vocabulary (151,936) on the
smoke widths, float32, one rank: the port's loss trajectory equals the
reference's, compressed and plain, within 1e-5 a step over 3 steps (lr
1e-3, warmup 1, a 1 x 128 batch; the reference's ``make_dp_train_step`` on
a one-device mesh, the port's on a one-rank gloo group).

Both packages miss the reference's own bar of 0.05 between the compressed
and the plain loss after 3 steps here (about 0.07), which its test sets at
the smoke vocabulary of 256: one max-abs int8 scale a tensor rounds the
unembedding's small gradients (the columns of tokens absent from the batch)
to 0, and where AdamW moves each of those elements by lr a step, the
compressed run leaves them until their error feedback grows. So the bar is
not a test of the port at a real vocabulary; ``chip_smoke.py``'s full-width
run prints its gap beside the bar."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_ranks as ranks
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.layers import init_params
from repro.models.registry import get_model as ref_get_model
from repro.train.dp_compressed import init_error_feedback, make_dp_train_step
from repro.train.optimizer import AdamWConfig, adamw_init
from repro_torch.models.convert import params_from_numpy
from torch_port_helpers import run_ranks

LOSS_TOL = 1e-5
REFERENCE_BAR = 0.05


def test_compressed_dp_at_qwen3s_vocabulary_follows_the_reference(tmp_path):
    ref_cfg = dataclasses.replace(ref_smoke_config("qwen3_8b"), vocab_size=ranks.WIDE_VOCAB,
                                  dtype="float32")
    ref_model = ref_get_model(ref_cfg)
    params = init_params(jax.random.key(0), ref_model.param_defs())
    model = ranks.wide_vocab_model()
    params_file = tmp_path / "params.pt"
    torch.save(params_from_numpy(jax.tree_util.tree_map(np.asarray, params), model.cfg, "cpu"),
               params_file)
    run_ranks(ranks.wide_vocab_dp, 1, tmp_path, str(params_file), str(tmp_path))
    got = torch.load(tmp_path / "wide_vocab.pt")

    mesh = jax.make_mesh((1,), ("data",))
    batch = {k: jnp.asarray(v) for k, v in ranks.wide_vocab_batch().items()}
    opt = AdamWConfig(lr=ranks.DP_OPT.lr, warmup_steps=ranks.DP_OPT.warmup_steps)
    copy = lambda t: jax.tree_util.tree_map(jnp.copy, t)
    want = {}
    for compress in (True, False):
        step = make_dp_train_step(ref_model, mesh, opt, compress=compress)
        p, o, e = copy(params), adamw_init(copy(params)), init_error_feedback(params)
        run = []
        for _ in range(ranks.DP_STEPS):
            p, o, e, m = step(p, o, e, batch)
            run.append(float(m["loss"]))
        want["compressed" if compress else "plain"] = run
    for mode in want:
        np.testing.assert_allclose(got[mode], want[mode], rtol=0, atol=LOSS_TOL, err_msg=mode)
    gap = lambda r: abs(r["compressed"][-1] - r["plain"][-1])
    assert gap(want) > REFERENCE_BAR and gap(got) > REFERENCE_BAR, (gap(want), gap(got))
