"""Numpy helpers of the PyTorch port's tests (``test_torch_*.py``) that feed
the port and the reference identical inputs, and the scripted clock the
fleet tests stand in for the engines' wall clock. They import no JAX, so
the card's tests use them on a machine without it."""
import numpy as np
import torch


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32) if np.asarray(x).dtype.name == "bfloat16" else np.asarray(x)


def shuffled_tables(rng, n_rows, mb, n_pages, page_size, lengths):
    """Block tables over a shuffled pool: row i owns just enough pages for
    lengths[i] tokens (-1 past that)."""
    perm = rng.permutation(n_pages)
    tables = np.full((n_rows, mb), -1, np.int32)
    used = 0
    for i in range(n_rows):
        need = -(-int(lengths[i]) // page_size)
        assert used + need <= n_pages, "case under-provisions pages"
        tables[i, :need] = perm[used : used + need]
        used += need
    return tables


class ScriptedClock:
    """Stands in for an engine module's ``time``: every ``perf_counter``
    call advances 2**-10 s, so each stage lasts exactly that (over its
    replica's speed factor) and no decision reads the wall clock. A power of
    two keeps every clock reading exact, whatever the count of calls."""

    STEP = 2.0 ** -10

    def __init__(self):
        self.calls = 0

    def perf_counter(self):
        self.calls += 1
        return self.calls * self.STEP

