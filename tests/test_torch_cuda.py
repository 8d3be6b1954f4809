"""Card-only checks of the PyTorch port's CUDA kernels (marker ``cuda``).

They skip without a CUDA device (the decision is taken inside the
``cuda`` fixture, never at import).  On a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the card at
ragged shapes in fp32 and bf16 (``rtol=atol=1e-5`` on fp32 outputs; bf16
mixed outputs may round one bf16 ulp apart, ``rtol=atol=2**-7``), and a
small Algorithm-1 run on every kernel backend must launch its kernel and
agree with the plain 'einsum' backend.
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
