"""Numpy helpers of the PyTorch port's tests (``test_torch_*.py``) that feed
the port and the reference identical inputs. They import no JAX, so the
card's tests use them on a machine without it."""
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
