"""The port's CUDA kernels against their plain versions, on the card.

Imports no jax, so it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py`` (the suite's conftest imports jax).  Without a card
it skips."""
import pytest
import torch

from repro_torch.kernels import ops, ref as tref


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions():
    """Each CUDA kernel against its plain version on the card, at small and
    ragged shapes, with launch counting."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(0)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32).cuda()

    sel = torch.tensor([-1, 0], dtype=torch.int32, device="cuda")
    ops.reset_launches()
    for w, n_words in ((1, 1), (8, 77), (64, 300)):
        d, e, a, b, c = (words(2, w, n_words) for _ in range(5))
        assert torch.equal(ops.beaver_and(d, e, a, b, c, sel),
                           tref.beaver_and(d, e, a, b, c, sel))
        a2, b2, c2, d2, e2 = (words(2, 2 * w, n_words) for _ in range(5))
        opened = words(2, 2, 2 * w, n_words)
        for shift in (s for s in (1, 2, 32) if s < w):   # level shifts < w
            for u, v in zip(ops.ks_mask(d, e, a2, b2, shift),
                            tref.ks_mask(d, e, a2, b2, shift)):
                assert torch.equal(u, v)
        args = (d2, opened[:, 0], e2, opened[:, 1], a2, b2, c2, sel, d)
        for u, v in zip(ops.ks_combine(*args), tref.ks_combine(*args)):
            assert torch.equal(u, v)
    for m, k, n in ((1, 1, 1), (70, 33, 65), (2048, 576, 64)):
        x = torch.randint(-2 ** 63, 2 ** 63 - 1, (m, k), generator=gen,
                          dtype=torch.int64).cuda()
        wt = torch.randint(-2 ** 31, 2 ** 31 - 1, (k, n), generator=gen,
                           dtype=torch.int32).cuda()
        assert torch.equal(ops.ring_matmul(x, wt), tref.ring_matmul(x, wt))
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"beaver_and": 3, "ks_mask": 5,
                                   "ks_combine": 3, "ring_matmul": 3}
