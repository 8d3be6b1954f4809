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
from run to run; trailing padding slots change nothing (a controlled
round's ELL is narrower than its replay's), and small controlled runs on
the kernel backends replay bitwise from their realized plans.  The three dequant kernels run on int8, int4 and fp8
payloads made by the port's quantizer: the sparse one's mixed output
must be bitwise its plain version's, the other outputs ``rtol=atol=1e-5``
(fp32 FMA sums in another order); the dense and ELL ones take the route
the rule gives (at n = 128 / 129 and d_max = 64 / 65 too), equal the fp32
staged kernels bitwise on the dequantized payload when staged, and
decode every byte code exactly on both routes; the quantizer itself
must give on the card bitwise the containers and scales it gives on the
CPU; and a small
quantized run on every quant backend must launch its kernel, agree with
the quantized 'einsum' oracle and replay bitwise when scanned.  The
flash-attention kernel is held against its plain version at fp32 (the
CUDA-core route) and bf16 (the tensor-core route), GQA, windows,
non-causal, masked kv tails, Sq != Sk and strided views (the reference's
tolerances, 2e-5 / 2e-2), at head dims it runs zero-padded to the next
instantiated one (zamba2's 80, and 48), and a reduced qwen2-7b on the
card must launch it once a layer and agree with the 'ref' attention
path, as must a reduced zamba2 at head dim 80 once a group.  The flash
backward kernels are held against their plain version in bf16 (2e-2) at
head dims 32 / 64 / 128 and 80, GQA, windows, a ragged S and a kv tail,
and give the same bits on two calls; a reduced bf16 stablelm's client
deltas through ``chunked`` launch the forward twice and the backward
once a layer a step, replay bitwise, and agree with the plain chunk
loop's in per-leaf update norms within the LM cell's limit.  The MoE's
grouped GEMM route (``grouped_mm`` for bf16 on the card) agrees with
the per-expert loop, and a bf16 top-6 MoE layer gives the same bits on
two calls.  The two GEMVs
(aggregate, aggregate_dequant) split tall payloads into row groups (G >
1) and still agree with their plain versions and with themselves from
call to call, an unaligned payload sums in the aligned one's order, the
paper's fp32 payload keeps G = 1, and aggregate_dequant decodes every
byte code exactly.  A wall-clock ``IngestEngine`` run on the card
replays bitwise from its recording, and each overlapped payload was
computed when its future resolved.
"""

from functools import partial

import numpy as np
import pytest
import torch

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
BITWISE = dict(rtol=0, atol=0, equal_nan=True)
# the staged route's limits (csrc/mixing.cu, csrc/sparse_mixing.cu): n rows
# and, for the ELL, d_max slots; beside them whole 16-byte vectors a row
# and 16-byte aligned operands
STAGED_ROWS, STAGED_SLOTS = 128, 64


def _route(X, n, d_max=0):
    """The route the static rule gives an (n, p) payload X, or the (n,
    cols) containers of a quantized one (the outputs are fresh, so
    aligned; containers always fill whole 16-byte vectors and are
    aligned, so for them the rule is the n and d_max limits alone)."""
    vec = 16 // X.element_size()
    staged = (n <= STAGED_ROWS and d_max <= STAGED_SLOTS
              and X.shape[1] % vec == 0 and X.data_ptr() % 16 == 0)
    return "staged" if staged else "generic"


def _routed_call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` and the route its one launch was counted
    on."""
    launches, routes = fn.launches, dict(fn.routes)
    out = fn(*args, **kwargs)
    moved = {r: fn.routes[r] - routes[r] for r in routes}
    assert fn.launches == launches + 1
    assert sorted(moved.values()) == [0, 1], moved
    return out, max(moved, key=moved.get)


def _misaligned(X):
    """X's values in a contiguous view 2 or 4 bytes past a 16-byte
    boundary (a storage offset of one element)."""
    buf = torch.empty(X.numel() + 1, dtype=X.dtype, device=X.device)
    out = buf[1:].view_as(X)
    out.copy_(X)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out

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
    (127, 1024, torch.bfloat16), (200, 4100, torch.float32),
    # the staged route's n limit and one past it, ragged last tiles
    (128, 4100, torch.float32), (129, 4100, torch.float32),
    (128, 1000, torch.bfloat16), (129, 1000, torch.bfloat16),
    (8, 4096, torch.float32)])
def test_kernels_match_plain_versions(cuda, n, p, dtype):
    """mix_aggregate and mix on the route the rule gives (counted there,
    once a call), bitwise the same from call to call."""
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
    (mixed, agg), route = _routed_call(fused.mix_aggregate_cuda, A, w, X)
    assert route == _route(X, n)
    mixed_r, agg_r = ref.mix_aggregate_ref(A, w, X)
    assert mixed.dtype == dtype and agg.dtype == torch.float32
    torch.testing.assert_close(mixed.float(), mixed_r.float(), **tol)
    torch.testing.assert_close(agg, agg_r, **F32)
    again = fused.mix_aggregate_cuda(A, w, X)
    assert torch.equal(mixed, again[0]) and torch.equal(agg, again[1])
    mixed, route = _routed_call(mixing.mix_cuda, A, X)
    assert route == _route(X, n)
    torch.testing.assert_close(mixed.float(), ref.mix_ref(A, X).float(),
                               **tol)
    assert torch.equal(mixed, mixing.mix_cuda(A, X))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_payload_takes_the_generic_route(cuda, dtype):
    """A payload whose base is off a 16-byte boundary is not fit for TMA:
    all four routed kernels take the generic route and still agree with
    their plain versions (the ELL mixed output bitwise)."""
    from repro_torch.kernels.mixing import fused, mixing, ref, sparse

    n, p = 70, 4096
    g = torch.Generator(device=cuda).manual_seed(5)
    A = torch.rand(n, n, generator=g, device=cuda)
    w = torch.rand(n, generator=g, device=cuda)
    X = _misaligned(torch.randn(n, p, generator=g, device=cuda).to(dtype))
    idx, wl = _ell(n, 9, 5, cuda)
    tol = F32 if dtype == torch.float32 else BF16
    (mixed, agg), route = _routed_call(fused.mix_aggregate_cuda, A, w, X)
    mixed_r, agg_r = ref.mix_aggregate_ref(A, w, X)
    assert route == "generic"
    torch.testing.assert_close(mixed.float(), mixed_r.float(), **tol)
    torch.testing.assert_close(agg, agg_r, **F32)
    mixed, route = _routed_call(mixing.mix_cuda, A, X)
    assert route == "generic"
    torch.testing.assert_close(mixed.float(), ref.mix_ref(A, X).float(),
                               **tol)
    mixed, route = _routed_call(sparse.sparse_mix_cuda, idx, wl, X)
    assert route == "generic"
    torch.testing.assert_close(mixed, ref.sparse_mix_ref(idx, wl, X),
                               **BITWISE)
    (mixed, agg), route = _routed_call(sparse.sparse_mix_aggregate_cuda,
                                       idx, wl, w, X)
    mixed_r, agg_r = ref.sparse_mix_aggregate_ref(idx, wl, w, X)
    assert route == "generic"
    torch.testing.assert_close(mixed, mixed_r, **BITWISE)
    torch.testing.assert_close(agg, agg_r, **F32)
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
    (2000, 264, 5, torch.bfloat16), (1, 5, 1, torch.float32),
    # the staged route's n limit and one past it at d_max 1, 2, 9, 16 and
    # 37, its d_max limit and one past it, ragged last tiles
    (128, 4100, 1, torch.float32), (129, 4100, 1, torch.float32),
    (128, 2056, 2, torch.bfloat16), (129, 2056, 2, torch.bfloat16),
    (128, 4100, 9, torch.float32), (129, 4100, 9, torch.float32),
    (128, 1000, 16, torch.bfloat16), (129, 1000, 16, torch.bfloat16),
    (128, 4100, 37, torch.float32), (129, 4100, 37, torch.bfloat16),
    (128, 4100, 64, torch.float32), (128, 2056, 65, torch.bfloat16)])
def test_sparse_kernels_match_plain_versions(cuda, n, p, d_max, dtype):
    """Both ELL kernels on the route the rule gives (counted there, once a
    call): mixed bitwise the plain version's, agg within fp32 tolerance,
    both bitwise the same from call to call."""
    from repro_torch.kernels.mixing import ref, sparse

    idx, w = _ell(n, d_max, n * p + d_max, cuda)
    g = torch.Generator(device=cuda).manual_seed(n + p)
    X = torch.randn(n, p, generator=g, device=cuda).to(dtype)
    wrow = torch.rand(n, generator=g, device=cuda)
    got, route = _routed_call(sparse.sparse_mix_cuda, idx, w, X)
    assert got.dtype == dtype and route == _route(X, n, d_max)
    torch.testing.assert_close(got, ref.sparse_mix_ref(idx, w, X), **BITWISE)
    assert torch.equal(got, sparse.sparse_mix_cuda(idx, w, X))
    (mixed, agg), route = _routed_call(sparse.sparse_mix_aggregate_cuda, idx,
                                       w, wrow, X)
    assert route == _route(X, n, d_max)
    mixed_r, agg_r = ref.sparse_mix_aggregate_ref(idx, w, wrow, X)
    torch.testing.assert_close(mixed, mixed_r, **BITWISE)
    torch.testing.assert_close(agg, agg_r, **F32)
    again = sparse.sparse_mix_aggregate_cuda(idx, w, wrow, X)
    assert torch.equal(mixed, again[0]) and torch.equal(agg, again[1])
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,p,d_max,extra,dtype", [
    (70, 4096, 8, 6, torch.float32), (70, 4096, 3, 13, torch.bfloat16),
    (13, 1001, 3, 2, torch.float32), (3000, 100, 2, 14, torch.float32),
    (128, 4100, 16, 30, torch.float32)])
def test_sparse_kernels_ignore_trailing_padding_slots(cuda, n, p, d_max,
                                                      extra, dtype):
    """A controlled round's ELL is as wide as its own widest row, the
    replay of its realized plan pads every round to the plan's widest:
    extra trailing slots (index 0, weight 0.0; here across the slot
    loop's template bounds and the generic loop) leave both outputs
    bitwise the same, on the same route."""
    from repro_torch.kernels.mixing import sparse

    idx, w = _ell(n, d_max, n + d_max, cuda)
    pad = torch.zeros(n, extra, dtype=idx.dtype, device=cuda)
    idx2 = torch.cat([idx, pad], 1)
    w2 = torch.cat([w, pad.float()], 1)
    g = torch.Generator(device=cuda).manual_seed(p)
    X = torch.randn(n, p, generator=g, device=cuda).to(dtype)
    wrow = torch.rand(n, generator=g, device=cuda)
    (m1, a1), r1 = _routed_call(sparse.sparse_mix_aggregate_cuda, idx, w,
                                wrow, X)
    (m2, a2), r2 = _routed_call(sparse.sparse_mix_aggregate_cuda, idx2, w2,
                                wrow, X)
    assert r1 == r2 == _route(X, n, d_max + extra)
    assert torch.equal(m1, m2) and torch.equal(a1, a2)
    assert torch.equal(m1, sparse.sparse_mix_cuda(idx2, w2, X))


@pytest.mark.parametrize("n", [STAGED_ROWS, STAGED_ROWS + 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_kernels_propagate_row_zero_non_finite(cuda, n, dtype):
    """nan and +-inf in row 0 reach every row through its padding slots
    (index 0, weight 0.0: 0 * inf = nan), as in the plain version, on the
    staged route (n = 128) and the generic one (n = 129)."""
    from repro_torch.kernels.mixing import ref, sparse

    idx, w = _ell(n, 9, n, cuda)
    g = torch.Generator(device=cuda).manual_seed(n)
    X = torch.randn(n, 2056, generator=g, device=cuda).to(dtype)
    X[0, :7] = float("nan")
    X[0, 7:300] = float("inf")
    X[0, 300:301] = -float("inf")
    wrow = torch.rand(n, generator=g, device=cuda)
    got, route = _routed_call(sparse.sparse_mix_cuda, idx, w, X)
    assert route == _route(X, n, 9)
    want = ref.sparse_mix_ref(idx, w, X)
    assert not torch.isfinite(want[1:, :301].float()).all()
    torch.testing.assert_close(got, want, **BITWISE)
    (mixed, agg), _ = _routed_call(sparse.sparse_mix_aggregate_cuda, idx, w,
                                   wrow, X)
    mixed_r, agg_r = ref.sparse_mix_aggregate_ref(idx, w, wrow, X)
    torch.testing.assert_close(mixed, mixed_r, **BITWISE)
    torch.testing.assert_close(agg, agg_r, **F32, equal_nan=True)
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


def test_controlled_runs_replay_bitwise_on_the_card(cuda):
    """The closed loop on the card: each controlled run launches its
    kernel once a round, and its realized plan replayed through
    ``run(plan=)`` reproduces it bitwise on the same routes."""
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

    def run(backend, record_mixed, counter, **how):
        server = FederatedServer(
            spec.build(), loss, cnn.init_cnn(0, image_hw=8),
            FederatedBatcher(ds, parts, T=2, batch_size=4),
            ServerConfig(T=2, t_max=3, seed=1, phi_max=0.3),
            execution=ExecutionConfig(backend=backend,
                                      record_mixed=record_mixed))
        counter.launches = 0
        routes = dict(getattr(counter, "routes", {}))
        hist = server.run(**how)
        torch.cuda.synchronize()
        moved = {r: counter.routes[r] - routes[r] for r in routes}
        return server, hist, counter.launches, moved

    for ctl, backend, record_mixed, counter in [
            ("threshold", "fused", False, fused.aggregate_cuda),
            ("threshold:tau=2", "fused", True, fused.mix_aggregate_cuda),
            ("threshold:scheme=sampled", "sparse", True,
             sparse.sparse_mix_aggregate_cuda)]:
        live, h_live, n_live, r_live = run(backend, record_mixed, counter,
                                           controller=ctl)
        rep, h_rep, n_rep, r_rep = run(backend, record_mixed, counter,
                                       plan=live.last_plan)
        assert n_live == n_rep == 3 and r_live == r_rep
        assert all(torch.equal(a, b) for a, b in zip(
            tree_flatten(live.params)[0], tree_flatten(rep.params)[0]))
        assert [(r.m, r.d2s, r.d2d) for r in h_live.records] == \
            [(r.m, r.d2s, r.d2d) for r in h_rep.records]


STORAGES = [("int8", 128), ("int4", 256), ("fp8", 128), ("int8", 512)]


def _wire(n, p, storage, block, device, seed):
    """A payload quantized by the port's quantizer on ``device``: ``(Xq,
    S)``, one row of zero scales (a dropped client) included."""
    from repro_torch.fl import packing

    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn(n, p, generator=g, device=device)
    Xq, S = packing.quantize_group(
        X, packing.QuantSpec(storage=storage, block=block))
    S[n // 2] = 0.0
    return Xq, S


@pytest.mark.parametrize("storage,block", STORAGES)
@pytest.mark.parametrize("n,p", [(70, 4096), (13, 1024), (130, 2560),
                                 (1, 512),
                                 # the staged route's n limit, one past it
                                 (STAGED_ROWS, 1024),
                                 (STAGED_ROWS + 1, 1024)])
def test_dequant_kernels_match_plain_versions(cuda, storage, block, n, p):
    """The three dequant kernels against their plain versions; the dense
    and ELL mixes on the route the rule gives (counted there, once a
    call), bitwise the same from call to call."""
    from repro_torch.kernels.mixing import fused, ref, sparse

    p = -(-p // block) * block
    Xq, S = _wire(n, p, storage, block, cuda, n * p)
    g = torch.Generator(device=cuda).manual_seed(p)
    A = torch.rand(n, n, generator=g, device=cuda)
    w = torch.rand(n, generator=g, device=cuda)
    idx, wl = _ell(n, min(n, 5), n + p, cuda)
    q = dict(storage=storage, block=block)
    before = (fused.aggregate_dequant_cuda.launches,
              fused.mix_aggregate_dequant_cuda.launches,
              sparse.sparse_mix_aggregate_dequant_cuda.launches)
    torch.testing.assert_close(
        fused.aggregate_dequant_cuda(w, Xq, S, **q),
        ref.aggregate_dequant_ref(w, Xq, S, storage, block), **F32)
    (mixed, agg), route = _routed_call(fused.mix_aggregate_dequant_cuda, A,
                                       w, Xq, S, **q)
    assert route == _route(Xq, n)
    mixed_r, agg_r = ref.mix_aggregate_dequant_ref(A, w, Xq, S, storage,
                                                   block)
    assert mixed.dtype == agg.dtype == torch.float32
    torch.testing.assert_close(mixed, mixed_r, **F32)
    torch.testing.assert_close(agg, agg_r, **F32)
    again = fused.mix_aggregate_dequant_cuda(A, w, Xq, S, **q)
    assert torch.equal(mixed, again[0]) and torch.equal(agg, again[1])
    (mixed, agg), route = _routed_call(
        sparse.sparse_mix_aggregate_dequant_cuda, idx, wl, w, Xq, S, **q)
    assert route == _route(Xq, n, idx.shape[1])
    mixed_r, agg_r = ref.sparse_mix_aggregate_dequant_ref(idx, wl, w, Xq, S,
                                                          storage, block)
    assert torch.equal(mixed, mixed_r)
    torch.testing.assert_close(agg, agg_r, **F32)
    again = sparse.sparse_mix_aggregate_dequant_cuda(idx, wl, w, Xq, S, **q)
    assert torch.equal(mixed, again[0]) and torch.equal(agg, again[1])
    assert (fused.aggregate_dequant_cuda.launches,
            fused.mix_aggregate_dequant_cuda.launches,
            sparse.sparse_mix_aggregate_dequant_cuda.launches) == \
        (before[0] + 1, before[1] + 2, before[2] + 2)
    torch.cuda.synchronize()


def test_sparse_dequant_kernel_splits_rows_into_groups(cuda):
    from repro_torch.kernels.mixing import ref, sparse

    n, p = 5000, 2048
    Xq, S = _wire(n, p, "int8", 512, cuda, 3)
    idx, w = _ell(n, 2, 4, cuda)
    wrow = torch.rand(n, device=cuda)
    mixed, agg = sparse.sparse_mix_aggregate_dequant_cuda(
        idx, w, wrow, Xq, S, storage="int8", block=512)
    mixed_r, agg_r = ref.sparse_mix_aggregate_dequant_ref(idx, w, wrow, Xq,
                                                          S, "int8", 512)
    assert torch.equal(mixed, mixed_r)
    # fp32 sums over 5,000 rows in another order, partial sums up to ~50:
    # a few ulps there (3.8e-6 each)
    torch.testing.assert_close(agg, agg_r, rtol=1e-5, atol=1e-4)
    again = sparse.sparse_mix_aggregate_dequant_cuda(
        idx, w, wrow, Xq, S, storage="int8", block=512)[1]
    assert torch.equal(agg, again)


@pytest.mark.parametrize("storage,block", STORAGES[:3])
@pytest.mark.parametrize("d_max", [STAGED_SLOTS, STAGED_SLOTS + 1])
def test_sparse_dequant_kernel_route_follows_the_slot_limit(cuda, storage,
                                                            block, d_max):
    """At n = 128 the ELL dequant kernel is staged up to d_max = 64 and
    generic past it; mixed is bitwise its plain version's on both."""
    from repro_torch.kernels.mixing import ref, sparse

    n, p = STAGED_ROWS, 1024
    Xq, S = _wire(n, p, storage, block, cuda, d_max)
    idx, w = _ell(n, d_max, d_max, cuda)
    wrow = torch.rand(n, device=cuda)
    (mixed, agg), route = _routed_call(
        sparse.sparse_mix_aggregate_dequant_cuda, idx, w, wrow, Xq, S,
        storage=storage, block=block)
    assert route == _route(Xq, n, d_max) == \
        ("staged" if d_max <= STAGED_SLOTS else "generic")
    mixed_r, agg_r = ref.sparse_mix_aggregate_dequant_ref(idx, w, wrow, Xq,
                                                          S, storage, block)
    assert torch.equal(mixed, mixed_r)
    torch.testing.assert_close(agg, agg_r, **F32)
    torch.cuda.synchronize()


@pytest.mark.parametrize("storage,block", STORAGES[:3])
@pytest.mark.parametrize("n", [70, STAGED_ROWS])
def test_staged_dequant_kernels_equal_the_fp32_staged_kernels(cuda, storage,
                                                              block, n):
    """On the staged route both quantized kernels do the fp32 staged
    kernels' sums on the values ``dequantize_group`` gives: mixed and agg
    of each bitwise equal to ``mix_aggregate_cuda`` /
    ``sparse_mix_aggregate_cuda`` on the dequantized payload."""
    from repro_torch.fl import packing
    from repro_torch.kernels.mixing import fused, sparse

    p = 4096
    Xq, S = _wire(n, p, storage, block, cuda, n + 1)
    x = packing.dequantize_group(
        Xq, S, packing.QuantSpec(storage=storage, block=block))
    g = torch.Generator(device=cuda).manual_seed(n)
    A = torch.rand(n, n, generator=g, device=cuda)
    w = torch.rand(n, generator=g, device=cuda)
    idx, wl = _ell(n, 9, n, cuda)
    q = dict(storage=storage, block=block)
    got, route = _routed_call(fused.mix_aggregate_dequant_cuda, A, w, Xq, S,
                              **q)
    want, route_f32 = _routed_call(fused.mix_aggregate_cuda, A, w, x)
    assert route == route_f32 == "staged"
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got, route = _routed_call(sparse.sparse_mix_aggregate_dequant_cuda, idx,
                              wl, w, Xq, S, **q)
    want, route_f32 = _routed_call(sparse.sparse_mix_aggregate_cuda, idx,
                                   wl, w, x)
    assert route == route_f32 == "staged"
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


@pytest.mark.parametrize("storage,block", STORAGES[:3])
@pytest.mark.parametrize("n", [4, STAGED_ROWS + 1])
def test_dequant_kernels_decode_every_code_exactly(cuda, storage, block, n):
    """Rows holding every byte code (every nibble, in every pair, for
    int4) under scales 0, 1, 2^-20 and 1/448, through the identity ELL (one
    slot of weight 1.0), whose mixed output is then the dequantized
    payload itself: it must equal ``dequantize_group``'s value for every
    code, fp8's NaN codes 0x7F / 0xFF included, on the staged route
    (n = 4) and the generic one (n = 129)."""
    from repro_torch.fl import packing
    from repro_torch.kernels.mixing import sparse

    dtype = torch.float8_e4m3fn if storage == "fp8" else torch.int8
    codes = torch.arange(256, dtype=torch.uint8, device=cuda)
    Xq = codes.repeat(n, 1).view(dtype)          # two scale blocks a row
    scales = torch.tensor([0.0, 1.0, 2.0 ** -20, 1 / 448], device=cuda)
    rows = torch.arange(n, device=cuda)[:, None]
    S = scales[(rows + torch.arange(2, device=cuda)) % 4].contiguous()
    idx = rows.int().contiguous()
    w = torch.ones(n, 1, device=cuda)
    (mixed, _), route = _routed_call(
        sparse.sparse_mix_aggregate_dequant_cuda, idx, w,
        torch.ones(n, device=cuda), Xq, S, storage=storage, block=block)
    assert route == ("staged" if n <= STAGED_ROWS else "generic")
    want = packing.dequantize_group(
        Xq, S, packing.QuantSpec(storage=storage, block=block))
    assert torch.isnan(want).any() == (storage == "fp8")
    torch.testing.assert_close(mixed, want, **BITWISE)


@pytest.mark.parametrize("n", [STAGED_ROWS, STAGED_ROWS + 1])
def test_sparse_dequant_kernel_propagates_a_row_zero_nan_code(cuda, n):
    """fp8 NaN codes (0x7F, 0xFF) in row 0 reach every row through its
    padding slot (index 0, weight 0.0: 0 * nan = nan), as in the plain
    version, on the staged route (n = 128) and the generic one
    (n = 129)."""
    from repro_torch.kernels.mixing import ref, sparse

    Xq, S = _wire(n, 2048, "fp8", 128, cuda, n)
    Xq.view(torch.uint8)[0, :7] = 0x7F
    Xq.view(torch.uint8)[0, 7:9] = 0xFF
    idx, w = _ell(n, 9, n, cuda)
    # one more padding slot a row, so every row reads row 0
    idx = torch.cat([idx, torch.zeros_like(idx[:, :1])], 1).contiguous()
    w = torch.cat([w, torch.zeros_like(w[:, :1])], 1).contiguous()
    wrow = torch.rand(n, device=cuda)
    (mixed, agg), route = _routed_call(
        sparse.sparse_mix_aggregate_dequant_cuda, idx, w, wrow, Xq, S,
        storage="fp8", block=128)
    assert route == _route(Xq, n, idx.shape[1])
    mixed_r, agg_r = ref.sparse_mix_aggregate_dequant_ref(idx, w, wrow, Xq,
                                                          S, "fp8", 128)
    assert torch.isnan(mixed_r[:, :9]).all()
    torch.testing.assert_close(mixed, mixed_r, **BITWISE)
    torch.testing.assert_close(agg, agg_r, **F32, equal_nan=True)
    torch.cuda.synchronize()


def test_dequant_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels.mixing import fused

    Xq, S = _wire(4, 256, "int8", 128, cuda, 0)
    w = torch.rand(4, device=cuda)
    with pytest.raises(TypeError):
        fused.aggregate_dequant_cuda(w, Xq, S, storage="fp8", block=128)
    with pytest.raises(ValueError):
        fused.aggregate_dequant_cuda(w, Xq, S, storage="int4", block=128)
    with pytest.raises(ValueError):
        fused.aggregate_dequant_cuda(w, Xq[:, 16:], S, storage="int8",
                                     block=128)
    with pytest.raises(ValueError):
        fused.aggregate_dequant_cuda(w, Xq, S.cpu(), storage="int8",
                                     block=128)
    with pytest.raises(ValueError):
        fused.aggregate_dequant_cuda(w, Xq, S, storage="int8", block=256)


# the two GEMVs' payloads: (dtype or storage, block)
GEMV_KINDS = [(torch.float32, None), (torch.bfloat16, None),
              ("int8", 512), ("int4", 512), ("fp8", 512)]


def _gemv(kind, block, n, p, device, seed):
    """A payload of ``kind`` and the GEMV over it: ``(call, plain, G)``,
    ``call()`` launching aggregate_cuda or aggregate_dequant_cuda."""
    from repro_torch.kernels.mixing import fused, ref

    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.rand(n, generator=g, device=device)
    if isinstance(kind, torch.dtype):
        X = torch.randn(n, p, generator=g, device=device).to(kind)
        return (partial(fused.aggregate_cuda, w, X), ref.aggregate_ref(w, X),
                fused.aggregate_row_groups(X))
    Xq, S = _wire(n, p, kind, block, device, seed)
    q = dict(storage=kind, block=block)
    return (partial(fused.aggregate_dequant_cuda, w, Xq, S, **q),
            ref.aggregate_dequant_ref(w, Xq, S, kind, block),
            fused.aggregate_dequant_row_groups(Xq, S, **q))


@pytest.mark.parametrize("kind,block", GEMV_KINDS)
@pytest.mark.parametrize("n,p", [(5000, 2048), (5000, 512), (3000, 1024)])
def test_gemvs_split_tall_payloads_into_row_groups(cuda, kind, block, n, p):
    """Tall, narrow payloads (the scale round's shape, cut down) split the
    rows into G > 1 groups whose partial rows a second pass sums in a fixed
    order: against the plain version, and a second call bitwise equal to
    the first."""
    call, want, groups = _gemv(kind, block, n, p, cuda, n + p)
    assert groups > 1
    got = call()
    # fp32 sums over 5,000 rows in another order, partial sums up to ~50
    # (w in [0, 1), x ~ N(0, 1)): a few ulps there (3.8e-6 each)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, call())
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,p", [(5000, 2048), (70, 4096), (13, 1024)])
def test_aggregate_narrow_loads_sum_in_the_same_order(cuda, dtype, n, p):
    """An unaligned payload takes 4- or 2-byte loads but the 16-byte
    vector's plan, so its agg is bitwise the aligned payload's."""
    from repro_torch.kernels.mixing import fused

    g = torch.Generator(device=cuda).manual_seed(p)
    w = torch.rand(n, generator=g, device=cuda)
    X = torch.randn(n, p, generator=g, device=cuda).to(dtype)
    assert torch.equal(fused.aggregate_cuda(w, X),
                       fused.aggregate_cuda(w, _misaligned(X)))


def test_aggregate_keeps_one_group_at_the_paper_width(cuda):
    """The paper's fp32 payload (70 x 1,663,488) fills the card without
    row groups: G = 1, so agg is written as the first design wrote it."""
    from repro_torch.kernels.mixing import fused, ref

    g = torch.Generator(device=cuda).manual_seed(70)
    X = torch.randn(70, 1_663_488, generator=g, device=cuda)
    w = torch.rand(70, generator=g, device=cuda) / 70
    assert fused.aggregate_row_groups(X) == 1
    torch.testing.assert_close(fused.aggregate_cuda(w, X),
                               ref.aggregate_ref(w, X), **F32)


@pytest.mark.parametrize("storage,unit", [("int8", 256), ("int4", 512),
                                          ("fp8", 256)])
def test_aggregate_dequant_decodes_every_code_exactly(cuda, storage, unit):
    """One row holding every byte code (every nibble in every pair, for
    int4) four times, under scales 0, 1, 2^-20 and 1/448, with w = [1.0]:
    agg is then the dequantized row itself and must equal
    ``dequantize_group``'s value for every code, fp8's NaN codes 0x7F /
    0xFF included (a -0.0 comes out +0.0: fmaf(1, -0, +0))."""
    from repro_torch.fl import packing
    from repro_torch.kernels.mixing import fused

    dtype = torch.float8_e4m3fn if storage == "fp8" else torch.int8
    codes = torch.arange(256, dtype=torch.uint8, device=cuda)
    Xq = codes.repeat(1, 4).view(dtype)          # four scale blocks
    S = torch.tensor([[0.0, 1.0, 2.0 ** -20, 1 / 448]], device=cuda)
    agg = fused.aggregate_dequant_cuda(torch.ones(1, device=cuda), Xq, S,
                                       storage=storage, block=unit)
    want = packing.dequantize_group(
        Xq, S, packing.QuantSpec(storage=storage, block=unit))[0]
    assert torch.isnan(want).any() == (storage == "fp8")
    torch.testing.assert_close(agg, want, **BITWISE)


@pytest.mark.parametrize("storage,block", STORAGES[:3])
def test_quantizer_on_the_card_equals_the_cpu(cuda, storage, block):
    from repro_torch.fl import packing

    quant = packing.QuantSpec(storage=storage, block=block)
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((64, 256 * block))
         * 10.0 ** -rng.integers(0, 5, (64, 1))).astype(np.float32)
    X[2, :block] = 0.0
    X[3, :block] = np.arange(block) % 15 - 7 + 0.5
    X[3, 0] = quant.qmax
    got = packing.quantize_group(torch.as_tensor(X, device=cuda), quant)
    want = packing.quantize_group(torch.as_tensor(X), quant)
    for a, b in zip(got, want):
        if a.dtype == torch.float8_e4m3fn:
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        assert torch.equal(a.cpu(), b)


def test_server_runs_every_quant_backend_on_the_card(cuda):
    from repro_torch import topology
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.data import (FederatedBatcher, label_sorted_partition,
                                  make_classification)
    from repro_torch.fl.engine import ExecutionConfig
    from repro_torch.fl.packing import QuantSpec
    from repro_torch.kernels.mixing import fused, sparse
    from repro_torch.models import cnn

    ds = make_classification(n_samples=400, image_hw=8, seed=0)
    parts = label_sorted_partition(ds, 12, rng=np.random.default_rng(0))
    spec = topology.make_spec("k_regular", n=12, c=3, k_range=(3, 4))
    loss = partial(cnn.l2_regularized_loss, cnn.cnn_apply)
    quant = QuantSpec(storage="int8", block=128)

    def run(backend, record_mixed, scan=False):
        server = FederatedServer(
            spec.build(), loss, cnn.init_cnn(0, image_hw=8),
            FederatedBatcher(ds, parts, T=2, batch_size=4),
            ServerConfig(T=2, t_max=2, seed=1),
            execution=ExecutionConfig(backend=backend, scan=scan,
                                      record_mixed=record_mixed,
                                      quant=quant))
        server.run()
        return tree_flatten(server.params)[0]

    ref_leaves = run("einsum", False)
    for backend, record_mixed, counter in [
            ("fused", False, fused.aggregate_dequant_cuda),
            ("fused", True, fused.mix_aggregate_dequant_cuda),
            ("sparse", False, fused.aggregate_dequant_cuda),
            ("sparse", True, sparse.sparse_mix_aggregate_dequant_cuda)]:
        counter.launches = 0
        if hasattr(counter, "routes"):
            counter.routes = dict.fromkeys(counter.routes, 0)
        seq = run(backend, record_mixed)
        assert counter.launches == 2            # one a round, one group
        if hasattr(counter, "routes"):          # n = 12: staged
            assert counter.routes == {"generic": 0, "staged": 2}
        scn = run(backend, record_mixed, scan=True)
        for a, b, c in zip(seq, scn, ref_leaves):
            assert torch.equal(a, b)
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)


BFLOAT, FLOAT = torch.bfloat16, torch.float32
# (B, Hq, Hkv, Sq, Sk, hd, dtype, causal, window, tail, layout); Sk None
# = Sq; layout 'bshd' passes (B, S, H, hd)-contiguous tensors as their
# transposed (B, H, S, hd) views, as the model does
FLASH_CASES = [
    (1, 4, 4, 64, None, 32, FLOAT, True, None, None, "bhsd"),
    (2, 6, 2, 130, None, 64, FLOAT, True, None, None, "bhsd"),
    (1, 8, 1, 200, None, 128, FLOAT, True, 16, None, "bhsd"),
    (2, 28, 4, 257, None, 128, BFLOAT, True, None, None, "bhsd"),
    (1, 7, 1, 333, None, 128, BFLOAT, True, 100, None, "bhsd"),
    (2, 4, 2, 100, None, 64, BFLOAT, False, None, None, "bhsd"),
    (1, 4, 2, 128, None, 32, FLOAT, True, None, 100, "bhsd"),
    (1, 2, 1, 64, None, 64, FLOAT, False, None, 0, "bhsd"),
    # the tensor-core kernel: hd 32 / 64, S under one tile and ragged,
    # GQA groups 1 / 3 / 7 / 8, windows 1 / 16 / 100, kv tails, non-causal,
    # Sq != Sk, strided views
    (2, 4, 4, 1, None, 32, BFLOAT, True, None, None, "bhsd"),
    (1, 6, 2, 17, None, 64, BFLOAT, True, None, None, "bhsd"),
    (1, 8, 1, 1000, None, 32, BFLOAT, True, None, None, "bshd"),
    (2, 7, 1, 257, None, 64, BFLOAT, True, 1, None, "bhsd"),
    (1, 8, 1, 1000, None, 128, BFLOAT, True, 16, None, "bshd"),
    (1, 3, 1, 1000, None, 64, BFLOAT, True, 100, None, "bshd"),
    (1, 4, 2, 1024, None, 64, BFLOAT, True, None, 900, "bhsd"),
    (1, 4, 2, 1024, None, 128, BFLOAT, False, None, 0, "bhsd"),
    (2, 8, 2, 333, None, 128, BFLOAT, False, None, None, "bshd"),
    (1, 6, 2, 300, 517, 64, BFLOAT, False, None, None, "bshd"),
    (1, 4, 1, 517, 300, 128, BFLOAT, True, None, None, "bhsd"),
    (1, 4, 4, 200, 130, 32, FLOAT, False, None, None, "bshd"),
]


@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Sk,hd,dtype,causal,window,tail,layout", FLASH_CASES)
def test_flash_kernel_matches_its_plain_version(cuda, B, Hq, Hkv, Sq, Sk, hd,
                                                dtype, causal, window, tail,
                                                layout):
    """The reference's tolerances (tests/test_kernels.py): 2e-5 in fp32,
    2e-2 in bf16.  bf16 launches the tensor-core kernel, fp32 the CUDA-core
    one; the output is the transposed view of a (B, Sq, Hq, hd) buffer."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref

    Sk = Sq if Sk is None else Sk
    g = torch.Generator(device=cuda).manual_seed(Sq * hd + Hq)

    def draw(H, S):
        if layout == "bshd":
            return torch.randn(B, S, H, hd, generator=g,
                               device=cuda).to(dtype).transpose(1, 2)
        return torch.randn(B, H, S, hd, generator=g, device=cuda).to(dtype)

    q, k, v = draw(Hq, Sq), draw(Hkv, Sk), draw(Hkv, Sk)
    kw = dict(causal=causal, window=window, true_seq_k=tail)
    route = "tensor_cores" if dtype == BFLOAT else "cuda_cores"
    before = fa.flash_attention_cuda.launches
    routes = dict(fa.flash_attention_cuda.routes)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    assert fa.flash_attention_cuda.launches == before + 1
    assert fa.flash_attention_cuda.routes[route] == routes[route] + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    tol = 2e-5 if dtype == FLOAT else 2e-2
    assert got.dtype == dtype and got.shape == (B, Hq, Sq, hd)
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if tail == 0:
        assert not got.any()
    torch.cuda.synchronize()


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention as fa

    q = torch.randn(1, 2, 8, 32, device=cuda)
    wide = torch.randn(1, 2, 8, 160, device=cuda)
    with pytest.raises(ValueError, match="up to 128"):    # head dim 160
        fa.flash_attention_cuda(wide, wide, wide)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):                       # mixed devices
        fa.flash_attention_cuda(q, q.cpu(), q)
    with pytest.raises(ValueError):                       # not contiguous
        fa.flash_attention_cuda(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), q, q)
    with pytest.raises(ValueError):                       # base misaligned
        fa.flash_attention_cuda(
            torch.randn(513, device=cuda)[1:].view(1, 2, 8, 32), q, q)


def test_model_flash_path_runs_the_kernel_on_the_card(cuda):
    """A reduced qwen2-7b on the card: attn_impl='flash' launches the
    kernel once a layer and gives the 'ref' forward's logits (1e-4, the
    reference's own); prefill + decode match the forward (2e-3)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config("qwen2-7b", reduced=True),
                              attn_impl="flash")
    model, model_ref = Model(cfg), Model(dataclasses.replace(
        cfg, attn_impl="ref"))
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda)
    fa.flash_attention_cuda.launches = 0
    logits, _ = model.forward(params, toks)
    assert fa.flash_attention_cuda.launches == cfg.n_layers
    want, _ = model_ref.forward(params, toks)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    pre, cache = model.prefill(params, toks[:, :95], max_len=100)
    torch.testing.assert_close(pre, logits[:, 94], rtol=2e-3, atol=2e-3)
    dec, _ = model.decode(params, cache, toks[:, 95], 95)
    torch.testing.assert_close(dec, logits[:, 95], rtol=2e-3, atol=2e-3)


def test_model_bf16_flash_path_takes_the_tensor_core_route(cuda):
    """A reduced qwen2-7b in bf16: every one of its flash launches goes to
    the tensor-core kernel, and its logits are finite and close to the
    'ref' attention path's (the two differ by the rounding of the softmax
    weights, which 'ref' casts to bf16 before the PV product)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config("qwen2-7b", reduced=True),
                              attn_impl="flash", dtype="bfloat16")
    model, model_ref = Model(cfg), Model(dataclasses.replace(
        cfg, attn_impl="ref"))
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 300), device=cuda)
    fa.flash_attention_cuda.routes = dict.fromkeys(fa.ROUTES, 0)
    logits, _ = model.forward(params, toks)
    assert fa.flash_attention_cuda.routes == {"cuda_cores": 0,
                                              "tensor_cores": cfg.n_layers}
    want, _ = model_ref.forward(params, toks)
    assert bool(torch.isfinite(logits).all())
    torch.testing.assert_close(logits.float(), want.float(), rtol=0.1,
                               atol=0.1)


def test_ingest_wall_run_on_the_card_replays_bitwise(cuda):
    """A wall-clock ``IngestEngine`` run on the card under faults, with
    overlapping dispatch on 'fused' (-> the aggregate kernel, also on the
    stale path): its recording replays bitwise through ``StreamEngine``
    on the card, and every overlapped payload's event had completed when
    its future resolved."""
    from repro_torch import topology
    from repro_torch.core.server import ServerConfig
    from repro_torch.fl.engine import ExecutionConfig, make_engine
    from repro_torch.fl.faults import parse_fault_spec
    from repro_torch.fl.plan import RoundPlan
    from repro_torch.fl.stream import StreamConfig
    from repro_torch.kernels.mixing import fused
    from repro_torch.runtime import IngestEngine, RuntimeConfig

    n, T, K, p = 12, 3, 6, 300
    plan = RoundPlan.connectivity_aware(
        topology.make_spec("k_regular", n=n, c=2, k_range=(4, 6),
                           p_fail=0.1).build(),
        ServerConfig(T=T, t_max=K, phi_max=0.3, seed=3, eta=lambda t: 0.2))
    rng = np.random.default_rng(7)
    targets = rng.standard_normal((n, p)).astype(np.float32)
    batches = [(torch.as_tensor((targets[:, None, None, :] + 0.05 * rng
                                 .standard_normal((n, T, 2, p)))
                                .astype(np.float32)),) for _ in range(K)]

    def loss(params, batch):
        b, = batch
        return 0.5 * torch.sum((params["x"] - b.mean(dim=0)) ** 2)

    stream = StreamConfig(
        buffer=8, deadline=0.8, staleness="poly", max_staleness=4,
        faults=parse_fault_spec("markov:p_fail=0.2,latency=exponential,"
                                "mean=2.0,duplicate_rate=0.1"),
        fault_seed=5)
    eng = make_engine(ExecutionConfig(
        backend="fused", stream=stream,
        runtime=RuntimeConfig(clock="wall", time_scale=0.02, workers=4)),
        loss, device=cuda)
    assert isinstance(eng, IngestEngine)
    params = {"x": torch.zeros(p)}
    fused.aggregate_cuda.launches = 0
    final, hist = eng.execute(plan, params, batches)
    assert fused.aggregate_cuda.launches > 0
    assert any(r.stream for r in hist.records)
    assert final["x"].is_cuda and bool(torch.isfinite(final["x"]).all())
    assert eng.last_payload_ready == dict.fromkeys(range(K), True)
    assert eng.last_recording.verify(loss, params, batches,
                                     backend="fused", device=cuda) == []


@pytest.mark.parametrize("hd,dtype,window,layout", [
    (80, BFLOAT, None, "bshd"), (80, FLOAT, None, "bshd"),
    (80, BFLOAT, 100, "bhsd"), (48, BFLOAT, None, "bshd"),
    (48, FLOAT, 16, "bhsd")])
def test_flash_kernel_pads_head_dims_it_does_not_instantiate(
        cuda, hd, dtype, window, layout):
    """A head dim between the instantiated ones runs the kernel of the
    next one on zero-padded operands with the true scale: one launch on
    the dtype's route, the plain version's result within 2e-5 / 2e-2,
    the first hd columns of a (B, S, H, hd_pad) buffer."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops, ref

    g = torch.Generator(device=cuda).manual_seed(hd)
    B, Hq, Hkv, S = 2, 8, 4, 333

    def draw(H):
        if layout == "bshd":
            return torch.randn(B, S, H, hd, generator=g,
                               device=cuda).to(dtype).transpose(1, 2)
        return torch.randn(B, H, S, hd, generator=g, device=cuda).to(dtype)

    q, k, v = draw(Hq), draw(Hkv), draw(Hkv)
    route = "tensor_cores" if dtype == BFLOAT else "cuda_cores"
    before = fa.flash_attention_cuda.launches
    routes = dict(fa.flash_attention_cuda.routes)
    got = fa.flash_attention_cuda(q, k, v, window=window)
    assert fa.flash_attention_cuda.launches == before + 1
    assert fa.flash_attention_cuda.routes[route] == routes[route] + 1
    assert got.shape == (B, Hq, S, hd) and got.stride(3) == 1
    assert got.stride(2) == Hq * fa.padded_head_dim(hd)
    want = ref.flash_attention_ref(q, k, v, window=window)
    tol = 2e-5 if dtype == FLOAT else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), window=window)
    assert out.is_contiguous()
    torch.testing.assert_close(out, got.transpose(1, 2), rtol=0, atol=0)


def test_model_zamba2_flash_at_head_dim_80_on_the_card(cuda):
    """A reduced zamba2 at its full head dim 80, fp32: attn_impl='flash'
    launches the kernel once a group and gives the 'ref' forward's logits
    (1e-4); prefill + decode match the forward (2e-3)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config("zamba2-2.7b", reduced=True),
                              head_dim=80, attn_impl="flash")
    model, model_ref = Model(cfg), Model(dataclasses.replace(
        cfg, attn_impl="ref"))
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda)
    fa.flash_attention_cuda.launches = 0
    logits, _ = model.forward(params, toks)
    assert fa.flash_attention_cuda.launches == \
        cfg.n_layers // cfg.hybrid_attn_every
    want, _ = model_ref.forward(params, toks)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    pre, cache = model.prefill(params, toks[:, :95], max_len=100)
    torch.testing.assert_close(pre, logits[:, 94], rtol=2e-3, atol=2e-3)
    dec, _ = model.decode(params, cache, toks[:, 95], 95)
    torch.testing.assert_close(dec, logits[:, 95], rtol=2e-3, atol=2e-3)


def test_moe_grouped_gemm_route_matches_the_per_expert_loop(cuda):
    """``expert_matmul`` takes ``grouped_mm`` for bf16 on the card (one
    launch), the loop for fp32; on the same rows (empty experts among
    them) the two agree within two bf16 ulps (each rounds an fp32 sum
    once), and the fp32 loop within 1e-5 of an fp32 matmul per expert."""
    from repro_torch.models import moe

    g = torch.Generator(device=cuda).manual_seed(0)
    sizes = torch.tensor([37, 0, 129, 5, 0, 300, 1, 64], device=cuda)
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    xs = torch.randn(int(sizes.sum()), 256, generator=g, device=cuda)
    w = torch.randn(8, 256, 384, generator=g, device=cuda) / 16
    before = dict(moe.expert_matmul.routes)
    lib = moe.expert_matmul(xs.bfloat16(), w.bfloat16(), sizes, offs)
    assert moe.expert_matmul.routes["grouped_mm"] == \
        before["grouped_mm"] + 1
    loop = torch.cat([xs[a:b].bfloat16() @ w[e].bfloat16() for e, (a, b)
                      in enumerate(zip([0] + offs[:-1].tolist(),
                                       offs.tolist())) if b > a])
    torch.testing.assert_close(lib.float(), loop.float(), rtol=2 ** -6,
                               atol=2 ** -6)
    f32 = moe.expert_matmul(xs, w, sizes, offs)
    assert moe.expert_matmul.routes["loop"] == before["loop"] + 6
    torch.testing.assert_close(f32, torch.cat([
        xs[a:b] @ w[e] for e, (a, b) in enumerate(zip(
            [0] + offs[:-1].tolist(), offs.tolist())) if b > a]),
        rtol=1e-5, atol=1e-5)


def test_moe_top6_bf16_layer_is_bitwise_reproducible_on_the_card(cuda):
    """A bf16 MoE layer at deepseek-v2's routing (160 experts, top-6, 2
    shared) on 2 x 512 tokens: two calls give the same bits (the combine
    adds the six slots in a fixed order, no atomics)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), d_model=512,
                              moe_d_ff=256, moe_impl="ragged")
    p = moe.moe_init(torch.Generator(device=cuda).manual_seed(0), cfg,
                     torch.bfloat16)
    x = torch.randn(2, 512, 512, device=cuda).bfloat16()
    y1, a1 = moe.moe_apply(cfg, p, x)
    y2, a2 = moe.moe_apply(cfg, p, x)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    assert bool(torch.isfinite(y1.float()).all())


def test_lm_rounds_on_the_card(cuda):
    """A reduced bf16 stablelm trained one round through 'aggregate' (the
    'fused' upgrade) launches the kernel once (one dtype group) and
    agrees with 'einsum' within two bf16 ulps of the value or of its
    leaf's RMS, whichever is larger (einsum rounds the mixed deltas to
    bf16, the kernel never does, and the add to the params can cancel);
    remat on and off give the same bits."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.core.rounds import make_round_fn
    from repro_torch.kernels.mixing import fused
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config("stablelm-1.6b", reduced=True),
                              dtype="bfloat16", remat=True,
                              attn_impl="chunked", attn_chunk=8,
                              loss_chunk=8)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 2, 2, 17), generator=g)
    batch = (toks[..., :-1].to(cuda), toks[..., 1:].to(cuda))
    A = torch.full((4, 4), 0.25, device=cuda)
    args = (A, torch.tensor([1., 0., 1., 1.], device=cuda),
            torch.tensor(3., device=cuda), torch.tensor(0.05, device=cuda))
    outs = {}
    for remat in (True, False):
        m = Model(dataclasses.replace(cfg, remat=remat))
        p = m.init(torch.Generator(device=cuda).manual_seed(0))
        outs[remat] = make_round_fn(m.loss, "aggregate")(p, batch, *args)[0]
    ref = make_round_fn(m.loss, "einsum")(p, batch, *args)[0]
    before = fused.aggregate_cuda.launches
    got = make_round_fn(m.loss, "aggregate")(p, batch, *args)[0]
    assert fused.aggregate_cuda.launches == before + 1
    for a, b, c in zip(tree_leaves(got), tree_leaves(ref),
                       tree_leaves(outs[True])):
        a32, b32 = a.float(), b.float()
        scale = torch.maximum(b32.abs(), b32.square().mean().sqrt())
        assert bool(((a32 - b32).abs() <= 2 ** -7 * scale).all())
        assert torch.equal(a, c)
    for a, b in zip(tree_leaves(outs[True]), tree_leaves(outs[False])):
        assert torch.equal(a, b)


# (B, Hq, Hkv, S, hd, window, kv tail): GQA groups 1 / 2 / 3, ragged S,
# windows, head dims 32 / 64 / 128 and zamba2's 80 (run at 128), and a
# window past a kv tail, whose last rows see no key (lse -inf, grads 0)
FLASH_BWD_CASES = [
    (2, 4, 2, 333, 32, None, None),
    (1, 4, 4, 256, 64, None, None),
    (2, 8, 8, 517, 64, 100, None),
    (1, 6, 2, 200, 128, 50, None),
    (1, 4, 2, 190, 80, None, None),
    (1, 3, 1, 77, 128, None, None),
    (1, 2, 1, 200, 64, 16, 100),
]


@pytest.mark.parametrize("B,Hq,Hkv,S,hd,window,tail", FLASH_BWD_CASES)
def test_flash_backward_kernels_match_their_plain_version(
        cuda, B, Hq, Hkv, S, hd, window, tail):
    """bf16 in the model's strided layout: the forward's log-sum-exp
    against the plain version's (fp32 sums in another order, 1e-4); the
    backward kernels' dq, dk, dv against ``flash_attention_bwd_ref`` fed
    the kernel's o and lse (bf16 outputs, the forward's bf16 tolerance
    2e-2); one count a call; a second call gives the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref

    g = torch.Generator(device=cuda).manual_seed(S * hd + Hq)

    def draw(H):
        return torch.randn(B, S, H, hd, generator=g,
                           device=cuda).to(BFLOAT).transpose(1, 2)

    q, k, v, do = draw(Hq), draw(Hkv), draw(Hkv), draw(Hq)
    kw = dict(causal=True, window=window, true_seq_k=tail)
    o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    _, want_lse = ref.flash_attention_ref(q, k, v, with_lse=True, **kw)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    before = fa.flash_attention_bwd_cuda.launches
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    assert fa.flash_attention_bwd_cuda.launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for a, b, t in zip(got, want, (q, k, v)):
        assert a.dtype == BFLOAT and a.shape == t.shape
        if hd in fa.HEAD_DIMS:       # else a slice of a padded buffer
            assert a.transpose(1, 2).is_contiguous()
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                   atol=2e-2)
    if tail is not None:
        assert torch.isneginf(lse[..., tail + window:]).all()
        assert not got[0][..., tail + window:, :].any()
    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    torch.cuda.synchronize()


def test_flash_backward_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops

    q = torch.randn(1, 2, 8, 32, device=cuda, dtype=BFLOAT)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention_bwd_cuda(q.float(), q.float(), q.float(),
                                    q.float(), lse, q.float())
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(q, q, q, q, lse[..., :4], q)
    with pytest.raises(TypeError, match="log-sum-exp"):
        fa.flash_attention_cuda(q.float(), q.float(), q.float(),
                                with_lse=True)
    x = torch.randn(1, 8, 2, 32, device=cuda, requires_grad=True)
    with pytest.raises(TypeError, match="bf16"):           # fp32 gradient
        ops.flash_attention(x, x, x).sum().backward()


def test_lm_bf16_chunked_training_takes_the_flash_kernels(cuda, monkeypatch):
    """A reduced bf16 stablelm's client deltas (``vmap`` over 3 clients of
    ``grad``, T 2 steps, layer remat) through ``attn_impl='chunked'`` on
    the card: each step launches the forward twice a layer (the layer's
    forward and its recomputation) and the backward once, for all clients
    at once; two runs give the same bits; and the deltas' per-leaf norms
    agree with the plain chunk loop's (the kernel route turned off)
    within the training cell's ``first_update_rel`` limit."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.core.rounds import client_deltas
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import attention
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config("stablelm-1.6b", reduced=True),
                              dtype="bfloat16", remat=True,
                              attn_impl="chunked", attn_chunk=64,
                              loss_chunk=64)
    n, T, S = 3, 2, 256
    m = Model(cfg)
    p = m.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x, y = (torch.randint(0, cfg.vocab_size, (n, T, 1, S), generator=g)
            .to(cuda) for _ in range(2))
    eta = torch.tensor(0.05, device=cuda)
    fwd, bwd = fa.flash_attention_cuda.launches, \
        fa.flash_attention_bwd_cuda.launches
    got = client_deltas(m.loss, p, (x, y), eta)
    assert fa.flash_attention_cuda.launches - fwd == 2 * cfg.n_layers * T
    assert fa.flash_attention_bwd_cuda.launches - bwd == cfg.n_layers * T
    again = client_deltas(m.loss, p, (x, y), eta)
    for a, b in zip(tree_leaves(got), tree_leaves(again)):
        assert torch.equal(a, b)
    monkeypatch.setattr(attention, "_kernel_route", lambda q: False)
    fwd = fa.flash_attention_cuda.launches
    plain = client_deltas(m.loss, p, (x, y), eta)
    assert fa.flash_attention_cuda.launches == fwd
    # the benchmark's first_update_rel (chipbench/harness.py::compare):
    # the worst leaf's gap of update norms over the larger of its norm
    # and the median leaf's; the limit is the stablelm-2-1.6b training
    # cell's
    ng, nw = ([float(t.double().norm()) for t in tree_leaves(d)]
              for d in (got, plain))
    med = float(np.median(nw))
    assert max(abs(a - b) / max(b, med) for a, b in zip(ng, nw)) < 0.0034
