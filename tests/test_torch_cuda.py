"""Card-only checks of the PyTorch port's CUDA kernels (marker ``cuda``).

They skip without a CUDA device (the decision is taken inside the
``cuda`` fixture, never at import).  On a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the card at
ragged shapes in fp32 and bf16 (``rtol=atol=1e-5`` on fp32 outputs; bf16
mixed outputs may round one bf16 ulp apart, ``rtol=atol=2**-7``), and a
small Algorithm-1 run on every kernel backend must launch its kernel and
agree with the plain 'einsum' backend.  The sparse (ELL) kernels also
run at a shape that splits the rows into groups (the aggregate leg's
two-pass sum), and the combine row they are fed must be bitwise the same
from run to run.
"""

from functools import partial

import numpy as np
import pytest
import torch

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,p,dtype", [
    (70, 4096, torch.float32), (13, 1001, torch.float32),
    (37, 10_003, torch.bfloat16), (130, 777, torch.float32),
    (1, 5, torch.bfloat16), (100, 256, torch.float32),
    (127, 1024, torch.bfloat16), (200, 4100, torch.float32)])
def test_kernels_match_plain_versions(cuda, n, p, dtype):
    from repro_torch.kernels.mixing import fused, mixing, ref

    g = torch.Generator(device=cuda).manual_seed(n * p)
    A = torch.rand(n, n, generator=g, device=cuda)
    w = torch.rand(n, generator=g, device=cuda)
    X = torch.randn(n, p, generator=g, device=cuda).to(dtype)
    tol = F32 if dtype == torch.float32 else BF16
    before = fused.aggregate_cuda.launches
    torch.testing.assert_close(fused.aggregate_cuda(w, X),
                               ref.aggregate_ref(w, X), **F32)
    assert fused.aggregate_cuda.launches == before + 1
    mixed, agg = fused.mix_aggregate_cuda(A, w, X)
    mixed_r, agg_r = ref.mix_aggregate_ref(A, w, X)
    assert mixed.dtype == dtype and agg.dtype == torch.float32
    torch.testing.assert_close(mixed.float(), mixed_r.float(), **tol)
    torch.testing.assert_close(agg, agg_r, **F32)
    torch.testing.assert_close(mixing.mix_cuda(A, X).float(),
                               ref.mix_ref(A, X).float(), **tol)
    torch.cuda.synchronize()


def test_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels.mixing import fused

    X = torch.randn(4, 8, device=cuda)
    with pytest.raises(TypeError):
        fused.aggregate_cuda(torch.rand(4, device=cuda), X.double())
    with pytest.raises(ValueError):
        fused.aggregate_cuda(torch.rand(4, device=cuda), X.t())
    with pytest.raises(ValueError):
        fused.aggregate_cuda(torch.rand(4), X)


def test_server_runs_every_kernel_backend_on_the_card(cuda):
    from repro_torch import topology
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.data import (FederatedBatcher, label_sorted_partition,
                                  make_classification)
    from repro_torch.fl.engine import ExecutionConfig
    from repro_torch.kernels.mixing import fused, mixing
    from repro_torch.models import cnn

    ds = make_classification(n_samples=400, image_hw=8, seed=0)
    parts = label_sorted_partition(ds, 10, rng=np.random.default_rng(0))
    spec = topology.make_spec("k_regular", n=10, c=2, k_range=(3, 4))
    loss = partial(cnn.l2_regularized_loss, cnn.cnn_apply)

    def run(backend, record_mixed):
        server = FederatedServer(
            spec.build(), loss, cnn.init_cnn(0, image_hw=8),
            FederatedBatcher(ds, parts, T=2, batch_size=4),
            ServerConfig(T=2, t_max=2, seed=1),
            execution=ExecutionConfig(backend=backend,
                                      record_mixed=record_mixed))
        server.run()
        return tree_flatten(server.params)[0]

    ref_leaves = run("einsum", False)
    for backend, record_mixed, counter in [
            ("fused", False, fused.aggregate_cuda),
            ("fused", True, fused.mix_aggregate_cuda),
            ("pallas", True, mixing.mix_cuda)]:
        counter.launches = 0
        leaves = run(backend, record_mixed)
        assert counter.launches > 0
        for a, b in zip(leaves, ref_leaves):
            assert a.is_cuda
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _ell(n, d_max, seed, device):
    """A random ELL pair: 1..d_max in-neighbours a row, padding slots
    index 0 / weight 0.0 (the ``SparseA.ell()`` layout)."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((n, d_max), np.int32)
    w = np.zeros((n, d_max), np.float32)
    for i in range(n):
        d = int(rng.integers(1, d_max + 1))
        idx[i, :d] = np.sort(rng.choice(n, size=min(d, n), replace=False))
        w[i, :d] = rng.random(d) + 0.1
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(w, device=device))


@pytest.mark.parametrize("n,p,d_max,dtype", [
    (37, 1000, 37, torch.float32), (37, 1000, 37, torch.bfloat16),
    (70, 4096, 10, torch.float32), (13, 1001, 3, torch.bfloat16),
    (9, 4096, 1, torch.float32), (3000, 100, 2, torch.float32),
    (2000, 264, 5, torch.bfloat16), (1, 5, 1, torch.float32)])
def test_sparse_kernels_match_plain_versions(cuda, n, p, d_max, dtype):
    from repro_torch.kernels.mixing import ref, sparse

    idx, w = _ell(n, d_max, n * p + d_max, cuda)
    g = torch.Generator(device=cuda).manual_seed(n + p)
    X = torch.randn(n, p, generator=g, device=cuda).to(dtype)
    wrow = torch.rand(n, generator=g, device=cuda)
    tol = F32 if dtype == torch.float32 else BF16
    before = (sparse.sparse_mix_cuda.launches,
              sparse.sparse_mix_aggregate_cuda.launches)
    got = sparse.sparse_mix_cuda(idx, w, X)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(),
                               ref.sparse_mix_ref(idx, w, X).float(), **tol)
    mixed, agg = sparse.sparse_mix_aggregate_cuda(idx, w, wrow, X)
    mixed_r, agg_r = ref.sparse_mix_aggregate_ref(idx, w, wrow, X)
    torch.testing.assert_close(mixed.float(), mixed_r.float(), **tol)
    torch.testing.assert_close(agg, agg_r, **F32)
    assert (sparse.sparse_mix_cuda.launches,
            sparse.sparse_mix_aggregate_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()


def test_sparse_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels.mixing import sparse

    idx, w = _ell(6, 3, 0, cuda)
    X = torch.randn(6, 8, device=cuda)
    with pytest.raises(TypeError):
        sparse.sparse_mix_cuda(idx.long(), w, X)
    with pytest.raises(TypeError):
        sparse.sparse_mix_cuda(idx, w.double(), X)
    with pytest.raises(ValueError):
        sparse.sparse_mix_cuda(idx.cpu(), w, X)
    with pytest.raises(ValueError):
        sparse.sparse_mix_aggregate_cuda(idx, w, torch.rand(5, device=cuda),
                                         X)
    with pytest.raises(ValueError):
        sparse.sparse_mix_cuda(idx[:4], w[:4], X)


def test_combine_row_is_bitwise_stable_on_the_card(cuda):
    from repro_torch.kernels.mixing import ops

    idx, w = _ell(5000, 12, 1, cuda)
    tau = (torch.rand(5000, device=cuda) < 0.5).float()
    rows = [ops.combine_weights_ell(idx, w, tau, torch.tensor(
        7.0, device=cuda)) for _ in range(3)]
    assert all(torch.equal(rows[0], r) for r in rows[1:])
    want = ops.combine_weights_ell(idx.cpu(), w.cpu(), tau.cpu(),
                                   torch.tensor(7.0))
    torch.testing.assert_close(rows[0].cpu(), want, rtol=1e-6, atol=1e-7)


def test_server_runs_the_sparse_backends_on_the_card(cuda):
    from repro_torch import topology
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.data import (FederatedBatcher, label_sorted_partition,
                                  make_classification)
    from repro_torch.fl.engine import ExecutionConfig
    from repro_torch.kernels.mixing import fused, sparse
    from repro_torch.models import cnn

    ds = make_classification(n_samples=400, image_hw=8, seed=0)
    parts = label_sorted_partition(ds, 12, rng=np.random.default_rng(0))
    spec = topology.make_spec("hub", n=12, c=3)
    loss = partial(cnn.l2_regularized_loss, cnn.cnn_apply)

    def run(backend, record_mixed, scan=False):
        server = FederatedServer(
            spec.build(), loss, cnn.init_cnn(0, image_hw=8),
            FederatedBatcher(ds, parts, T=2, batch_size=4),
            ServerConfig(T=2, t_max=2, seed=1),
            execution=ExecutionConfig(backend=backend, scan=scan,
                                      record_mixed=record_mixed))
        server.run()
        return tree_flatten(server.params)[0]

    ref_leaves = run("einsum", False)
    for record_mixed, counter in [(False, fused.aggregate_cuda),
                                  (True, sparse.sparse_mix_aggregate_cuda)]:
        counter.launches = 0
        seq = run("sparse", record_mixed)
        assert counter.launches == 2            # one a round, one group
        scn = run("sparse", record_mixed, scan=True)
        for a, b, c in zip(seq, scn, ref_leaves):
            assert torch.equal(a, b)
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
