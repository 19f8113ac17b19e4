"""The port's CUDA kernels on the card, against their plain twins.

Marked ``cuda``: each test skips with a reason where there is no usable
GPU (decided inside the fixture, never at import).  Run on a GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances: proximity within 1e-3 degrees (the reference's ``TOL_DEG``);
tsgemm within rtol 1e-5 float32 / 2e-2 bfloat16, atol 10x rtol
(``tests/test_kernels.py``); flash attention within 2e-5 float32 / 3e-2
bfloat16 (``tests/test_kernels.py``), and bfloat16 also within 1e-2 of the
largest |output| (one bfloat16 step of it is at most 2^-7); WKV within 1e-5
of the largest |output| and |state| (the state barely decays, so the scale
grows with S), by both routes (sequences on each side of the plan's
threshold) and with fast decays (w down to ~6e-4).  The eq2 proximity
kernel and the recurrent WKV kernel (decode) are also required to give the
same bits when launched twice, and a small mix4 federation the same
labels, accuracies and parameters when run twice with one seed.  The
model-based signature families give the same bits twice on the card and
stay within chip_smoke.py's principal-angle limits of the CPU from the same
draws; the Table-6 distances within 1e-3 relative of the CPU; a drift
observation after a fused move the CPU's labels and candidates.  Above rank
8 the proximity kernel (column chunks for eq3, Gram pieces and a
runtime-rank reduce for eq2) is held to its twin at p = 9, 12, 16, 3 x 12
and 12 x 3, on column views of a wider stack, twice bitwise, square against
rectangle, and PACFL at p = 16 to the CPU's labels.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.wkv.wkv import CHUNKED_MIN_S

pytestmark = pytest.mark.cuda

TOL_DEG = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on a GPU")
    return torch.device("cuda")


def _signatures(K, n, p, seed, spread=None):
    rng = np.random.default_rng(seed)
    if spread is None:
        X = rng.normal(size=(K, n, p))
    else:
        X = rng.normal(size=(n, p))[None] + spread / np.sqrt(n) * rng.normal(size=(K, n, p))
    return torch.from_numpy(np.stack([np.linalg.qr(x)[0] for x in X]).astype(np.float32))


RANKS = [(p, q, m) for p, q in [(1, 1), (3, 3), (5, 5), (8, 8), (3, 5), (7, 2),
                                 (9, 9), (12, 12), (3, 12), (12, 5)]
         for m in ("eq3", "eq2") if m == "eq2" or p == q]


@pytest.mark.parametrize("p,q,measure", RANKS)
@pytest.mark.parametrize("Ka,Kb", [(13, 13), (70, 5), (1, 33)])
def test_proximity_kernel_matches_plain(cuda, Ka, Kb, p, q, measure):
    from repro_torch.kernels import _build
    from repro_torch.kernels.proximity import proximity_cuda, proximity_plain

    Ua = _signatures(Ka, 200, p, seed=Ka + p, spread=0.3).to(cuda)
    Ub = _signatures(Kb, 200, q, seed=Kb + q + 1, spread=0.3).to(cuda)
    before = _build.LAUNCHES["proximity"]
    got = proximity_cuda(Ua, Ub, measure)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["proximity"] == before + 1
    want = proximity_plain(Ua, Ub, measure)
    assert got.shape == (Ka, Kb) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL_DEG


def test_proximity_backends_on_cuda_go_through_the_kernel(cuda):
    from repro_torch.core import angles
    from repro_torch.kernels import _build

    U = _signatures(20, 64, 3, seed=0).to(cuda)
    before = _build.LAUNCHES["proximity"]
    A = angles.proximity_matrix(U, "eq3")
    # distinct clients only: a self-pair sits at G = I, where one float32
    # ulp of the Gram is already 0.02 degrees under arccos
    C = angles.cross_proximity(U[4:], U[:4], "eq2")
    assert _build.LAUNCHES["proximity"] == before + 2
    ref = angles.proximity_matrix(U.cpu(), "eq3", backend="torch")
    assert (A.cpu() - ref).abs().max().item() <= TOL_DEG
    assert (A == A.T).all() and (A.diagonal() == 0).all()
    ref_c = angles.cross_proximity(U[4:].cpu(), U[:4].cpu(), "eq2", backend="torch")
    assert (C.cpu() - ref_c).abs().max().item() <= TOL_DEG


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,m,k,p,transpose_a", [
    (1, 128, 128, 8, False), (3, 512, 300, 10, True), (2, 1000, 768, 13, False),
    (4, 50, 40, 3, True), (2, 11, 700, 300, False), (5, 257, 33, 20, True),
])
def test_tsgemm_kernel_matches_plain(cuda, Bt, m, k, p, transpose_a, dtype):
    from repro_torch.kernels.tsgemm import tsgemm_cuda, tsgemm_plain

    g = torch.Generator(device=cuda).manual_seed(m + k + p)
    if transpose_a:
        A = torch.randn((Bt, k, m), generator=g, device=cuda).to(dtype).transpose(1, 2)
    else:
        A = torch.randn((Bt, m, k), generator=g, device=cuda).to(dtype)
    B = torch.randn((Bt, k, p), generator=g, device=cuda).to(dtype)
    got = tsgemm_cuda(A, B)
    want = tsgemm_plain(A, B)
    rtol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=rtol, atol=10 * rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,n,M", [(64, 3072, 512), (64, 3000, 512), (7, 3072, 1024),
                                    (3, 1000, 300)])
def test_tsgemm_split_k_matches_plain(cuda, Bt, n, M, dtype):
    """The randomized SVD's short-m products D^T @ Q and Q^T @ D (split over
    k = n) with its operands: D (Bt, n, M) Gaussian, Q (Bt, n, 11) with
    orthonormal columns, as ``core/svd.py`` passes them."""
    from repro_torch.kernels.tsgemm import tsgemm_cuda, tsgemm_plain
    from repro_torch.kernels.tsgemm.tsgemm import split_k_plan

    g = torch.Generator(device=cuda).manual_seed(n + M)
    D = torch.randn((Bt, n, M), generator=g, device=cuda)
    Q = torch.linalg.qr(torch.randn((Bt, n, 11), generator=g, device=cuda))[0]
    D, Q = D.to(dtype), Q.to(dtype)
    assert split_k_plan(Bt, M, n, 11)[2] > 1
    rtol = 1e-5 if dtype == torch.float32 else 2e-2
    for A, B in ((D.transpose(1, 2), Q), (Q.transpose(1, 2), D)):
        got = tsgemm_cuda(A, B)
        torch.testing.assert_close(got, tsgemm_plain(A, B), rtol=rtol, atol=10 * rtol)
        assert torch.equal(got, tsgemm_cuda(A, B))   # fixed split order: bitwise


def test_flash_decode_split_launches_once_per_call(cuda):
    """The split-KV decode runs its split and merge steps under one wrapper
    call: the launch count rises by exactly 1 a call, also when the call is
    captured in a CUDA graph and replayed."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.kernels.flash_attention.flash_attention import split_plan

    assert split_plan(4, 1, 1056, 32, 4, 64)[0] > 1
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((4, 1, 32, 64), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((4, 1056, 4, 64), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((4, 1056, 4, 64), generator=g, device=cuda).to(torch.bfloat16)
    want = flash_attention_plain(q, k, v, q_offset=1055).float()
    for i in range(3):
        before = _build.LAUNCHES["flash_attention"]
        got = flash_attention_cuda(q, k, v, q_offset=1055)
        assert _build.LAUNCHES["flash_attention"] == before + 1
    err = (got.float() - want).abs().max().item()
    assert err <= 3e-2 and err <= 1e-2 * want.abs().max().item()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention_cuda(q, k, v, q_offset=1055)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _build.LAUNCHES["flash_attention"]
    with torch.cuda.graph(graph):
        out = flash_attention_cuda(q, k, v, q_offset=1055)
    assert _build.LAUNCHES["flash_attention"] == before + 1
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


def test_pipeline_on_cuda_matches_cpu(cuda):
    from repro_torch.core.pacfl import PACFLConfig, one_shot_clustering
    from repro_torch.kernels import _build
    from repro_torch.serving import RepresentativeCache, serve_assign

    rng = np.random.default_rng(0)
    n, p = 64, 3
    bases = [np.linalg.qr(rng.normal(size=(n, p)))[0] for _ in range(3)]
    data = []
    for k in range(18):
        Bk = np.linalg.qr(bases[k % 3] + 0.1 / np.sqrt(n) * rng.normal(size=(n, p)))[0]
        M = int(rng.integers(30, 90))
        coef = np.array([8.0, 3.0, 1.0])[:, None] * rng.normal(size=(p, M))
        data.append((Bk @ coef + 0.02 * rng.normal(size=(n, M))).astype(np.float32))
    cfg = PACFLConfig(p=p, beta=60.0, svd_method="exact")
    _build.reset_launches()
    gpu = one_shot_clustering(data, cfg, device=cuda)
    cpu = one_shot_clustering(data, cfg, device="cpu")
    assert _build.LAUNCHES["proximity"] >= 1
    np.testing.assert_array_equal(gpu.labels, cpu.labels)
    assert gpu.U.device.type == "cuda"
    ext = gpu.extend(gpu.U[:2].clone())
    cache = RepresentativeCache("medoid")
    cache.refresh(ext.engine)
    idx, d = serve_assign(gpu.U[:6], cache.rep_stack, "eq3")
    assert idx.device.type == "cuda" and torch.isfinite(d).all()


FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset
    (2, 64, 64, 4, 2, 32, True, None, 0),
    (1, 32, 128, 8, 8, 16, False, None, 0),
    (2, 64, 64, 4, 1, 32, True, 16, 0),
    (1, 16, 64, 4, 2, 32, True, None, 48),
    (1, 128, 128, 2, 2, 64, True, None, 0),
    (3, 32, 32, 6, 3, 32, True, 8, 0),
    (2, 200, 200, 32, 4, 64, True, None, 0),        # tinyllama heads, ragged tiles
    (4, 1, 1056, 32, 4, 64, True, None, 1040),      # decode against a cache
    (2, 13, 77, 8, 2, 64, True, 20, 60),            # ragged Sq and Skv, window
    (1, 5, 40, 4, 4, 128, False, 7, 50),            # rows with no valid key
    (4, 1024, 1024, 24, 8, 128, True, None, 0),     # llama3.2-3b heads, prefill
    # decode: the bfloat16 kernel splits the keys (split_plan) and merges
    (4, 1, 1000, 32, 4, 64, True, None, 999),       # Skv no multiple of the split
    (4, 1, 1056, 32, 4, 64, True, None, 300),       # trailing splits empty
    (4, 1, 1056, 32, 4, 64, True, 200, 1055),       # windowed: early splits masked
    (4, 1, 1056, 32, 4, 64, True, 100, 1356),       # no valid key in any split
    (2, 1, 700, 8, 2, 32, True, None, 650),
    (3, 2, 300, 4, 1, 16, True, 50, 298),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,hd,causal,window,qoff", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Skv, Hq, Hkv, hd, causal,
                                              window, qoff, dtype):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(Sq * 7 + Skv)
    q = torch.randn((B, Sq, Hq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Skv, Hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Skv, Hkv, hd), generator=g, device=cuda).to(dtype)
    before = _build.LAUNCHES["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=qoff)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=qoff)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol
    if dtype == torch.bfloat16:
        assert err <= 1e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,hd", [(2, 16, 4, 16), (1, 40, 2, 32), (3, 7, 1, 16),
                                      (2, 300, 8, 64), (4, 1, 32, 64), (1, 33, 2, 128)])
def test_wkv_kernel_matches_plain(cuda, B, S, H, hd, with_state):
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain

    g = torch.Generator(device=cuda).manual_seed(B * 100 + S)
    r, k, v = (torch.randn((B, S, H, hd), generator=g, device=cuda) for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, H, hd), generator=g, device=cuda))
    u = 0.1 * torch.randn((H, hd), generator=g, device=cuda)
    s0 = torch.randn((B, H, hd, hd), generator=g, device=cuda) if with_state else None
    before = _build.LAUNCHES["wkv"]
    out, sT = wkv_cuda(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wkv"] == before + 1
    want_out, want_s = wkv_plain(r, k, v, w, u, s0)
    assert (out - want_out).abs().max().item() <= 1e-5 * want_out.abs().max().item()
    assert (sT - want_s).abs().max().item() <= 1e-5 * want_s.abs().max().item()


def _wkv_operands(cuda, B, S, H, hd, seed, regime, with_state, dtype=torch.float32):
    g = torch.Generator(device=cuda).manual_seed(seed)
    r, k, v = (torch.randn((B, S, H, hd), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    if regime == "fast":   # ww ~ U[-6, 2]: w = exp(-exp(ww)) down to ~6e-4
        ww = -6.0 + 8.0 * torch.rand((B, S, H, hd), generator=g, device=cuda)
    else:                  # the model's init: w ~ exp(-exp(-6)) ~ 0.9975
        ww = -6.0 + 0.5 * torch.randn((B, S, H, hd), generator=g, device=cuda)
    w = torch.exp(-torch.exp(ww))
    u = 0.1 * torch.randn((H, hd), generator=g, device=cuda)
    s0 = 0.1 * torch.randn((B, H, hd, hd), generator=g, device=cuda) if with_state else None
    return (r, k, v, w, u), s0


def _assert_wkv_close(got, want):
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", ["slow", "fast"])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_prefill_decay_regimes_match_plain(cuda, with_state, regime, dtype):
    """rwkv6-1.6b's prefill shape by the chunked route: fast decays (whose
    cumulative products underflow within a chunk) as well as the model's
    init; bfloat16 r, k, v are read as they are."""
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain, wkv_plan

    assert wkv_plan(1024).route == "chunked"
    ops, s0 = _wkv_operands(cuda, 4, 1024, 32, 64, 11, regime, with_state, dtype)
    got = wkv_cuda(*ops, s0)
    torch.cuda.synchronize()
    _assert_wkv_close(got, wkv_plain(*(a.float() for a in ops), s0))


_WKV_ROUTE_KERNELS = {"recurrent": {"wkv_step"}, "chunked": {"wkv_chunk", "wkv_scan"}}


@pytest.fixture(scope="module")
def warm_profiler():
    """The first torch.profiler session of a process can come back without
    device events while CUPTI starts up inside it: one discarded session
    around a trivial kernel comes first."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on a GPU")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


@pytest.mark.parametrize("S", [1, CHUNKED_MIN_S - 1, CHUNKED_MIN_S, 300, 1024])
def test_wkv_routes_by_length_match_plain(cuda, warm_profiler, S):
    """Sequence lengths on each side of CHUNKED_MIN_S: one call counts one
    launch, runs the CUDA kernels of the route wkv_plan names (read from
    torch.profiler) and matches the plain twin, fast decays from a carried
    state."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain, wkv_plan

    assert (S < CHUNKED_MIN_S) == (wkv_plan(S).route == "recurrent")
    ops, s0 = _wkv_operands(cuda, 2, S, 4, 64, S, "fast", True)
    wkv_cuda(*ops, s0)   # builds and loads the library outside the trace
    torch.cuda.synchronize()
    before = _build.LAUNCHES["wkv"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = wkv_cuda(*ops, s0)
        torch.cuda.synchronize()
    assert _build.LAUNCHES["wkv"] == before + 1
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    ran = {kernel for kernel in set().union(*_WKV_ROUTE_KERNELS.values())
           if any(kernel in name for name in names)}
    assert ran == _WKV_ROUTE_KERNELS[wkv_plan(S).route]
    _assert_wkv_close(got, wkv_plain(*ops, s0))


@pytest.mark.parametrize("S", [1, 300])
def test_wkv_misaligned_state0(cuda, S):
    """A state0 view one float into its storage (not 16-byte aligned, which
    the chunked route's 16-byte loads need) gives what the aligned one does,
    on both routes."""
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain

    ops, s0 = _wkv_operands(cuda, 2, S, 4, 64, 17, "fast", True)
    shifted = torch.empty(s0.numel() + 1, device=cuda)[1:].view_as(s0)
    shifted.copy_(s0)
    assert shifted.data_ptr() % 16 != 0
    got = wkv_cuda(*ops, shifted)
    torch.cuda.synchronize()
    _assert_wkv_close(got, wkv_plain(*ops, s0))
    assert all(torch.equal(a, b) for a, b in zip(got, wkv_cuda(*ops, s0)))


def test_wkv_chunked_route_is_graph_capturable(cuda):
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import wkv_cuda

    ops, s0 = _wkv_operands(cuda, 4, 1024, 32, 64, 5, "fast", True)
    want = wkv_cuda(*ops, s0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        wkv_cuda(*ops, s0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _build.LAUNCHES["wkv"]
    with torch.cuda.graph(graph):
        out, state = wkv_cuda(*ops, s0)
    assert _build.LAUNCHES["wkv"] == before + 1
    out.zero_()
    state.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want[0]) and torch.equal(state, want[1])


@pytest.mark.parametrize("K,p", [(1000, 3), (1000, 5), (130, 1)])
def test_proximity_square_equals_clone_cross(cuda, K, p):
    """The symmetric eq3 grid (upper-triangle tiles, mirrored) gives what the
    full rectangle gives for the stack against a copy of itself, exactly
    symmetric."""
    from repro_torch.kernels.proximity import proximity_cuda, proximity_plain

    U = _signatures(K, 300, p, seed=K + p, spread=0.3).to(cuda)
    square = proximity_cuda(U, U, "eq3")
    cross = proximity_cuda(U, U.clone(), "eq3")
    torch.cuda.synchronize()
    assert torch.equal(square, square.T)
    assert torch.equal(square, cross)
    off = ~torch.eye(K, dtype=torch.bool, device=cuda)
    want = proximity_plain(U, U, "eq3")
    assert (square - want)[off].abs().max().item() <= TOL_DEG


@pytest.mark.parametrize("layout", ["transposed", "offset"])
def test_proximity_eq3_strided_stacks(cuda, layout):
    """The eq3 kernel stages a stack whose clients' rows are not contiguous
    and 16-byte aligned element by element: a stack stored transposed, and
    one starting 609 floats into its storage.  Mixed with a contiguous
    stack in a cross block, and squared (upper-triangle tiles)."""
    from repro_torch.kernels.proximity import proximity_cuda, proximity_plain

    U = _signatures(62, 203, 3, seed=3, spread=0.3).to(cuda)   # n * p = 609
    V = U.transpose(1, 2).contiguous().transpose(1, 2) if layout == "transposed" else U[1:]
    W = U[1:].contiguous() if layout == "offset" else U
    off = ~torch.eye(V.shape[0], dtype=torch.bool, device=cuda)
    for Ua, Ub in ((V, V), (V, W[:17]), (W[:17], V)):
        got = proximity_cuda(Ua, Ub, "eq3")
        want = proximity_plain(Ua, Ub, "eq3")
        torch.cuda.synchronize()
        if Ua is Ub:
            assert torch.equal(got, got.T)
            got, want = got[off], want[off]
        assert (got - want).abs().max().item() <= TOL_DEG


# (Ka, Kb, p): the eq2 plan's cases on the FL path at n = 3072 -- mix4's
# square (10 triangle tiles, split over n), the churn admission's cross
# block and square (split down to 64-row splits), PACFL's K = 1024 square
# (one kernel, no workspace) -- and a square whose Gram rows come in groups
EQ2_PLAN_SHAPES = [(97, None, 3), (93, 8, 3), (8, None, 3), (1024, None, 3), (97, None, 4)]


@pytest.mark.parametrize("Ka,Kb,p", EQ2_PLAN_SHAPES)
def test_eq2_kernel_at_plan_shapes_matches_plain_and_repeats(cuda, Ka, Kb, p):
    from repro_torch.core.angles import _hygiene
    from repro_torch.kernels import _build
    from repro_torch.kernels.proximity import proximity_cuda, proximity_plain
    from repro_torch.kernels.proximity.proximity import eq2_plan

    Ua = _signatures(Ka, 3072, p, seed=Ka + p, spread=0.3).to(cuda)
    Ub = Ua if Kb is None else _signatures(Kb, 3072, p, seed=Kb, spread=0.3).to(cuda)
    plan = eq2_plan(Ua.shape[0], Ub.shape[0], 3072, p, p, sym=Ua is Ub)
    assert plan.workspace == (Ka != 1024)
    before = _build.LAUNCHES["proximity"]
    got = proximity_cuda(Ua, Ub, "eq2")
    again = proximity_cuda(Ua, Ub, "eq2")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["proximity"] == before + 2   # one count a call, whatever the plan
    assert torch.equal(got, again)
    want = proximity_plain(Ua, Ub, "eq2")
    if Ua is Ub:
        got, want = _hygiene(got), _hygiene(want)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL_DEG


def test_eq2_square_is_the_rectangle(cuda):
    """The symmetric eq2 grid (upper-triangle tiles, both epilogues) gives
    what the full rectangle of the stack against a copy of itself gives,
    where both take one split (K = 1000: 528 and 1024 tiles)."""
    from repro_torch.kernels.proximity import proximity_cuda

    U = _signatures(1000, 300, 3, seed=5, spread=0.3).to(cuda)
    square = proximity_cuda(U, U, "eq2")
    cross = proximity_cuda(U, U.clone(), "eq2")
    torch.cuda.synchronize()
    assert torch.equal(square, cross)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd", [(4, 1, 32, 64), (2, 1, 3, 16), (2, 1, 3, 32), (2, 1, 3, 128),
                                      (4, 16, 32, 64), (2, 47, 4, 64), (3, 9, 2, 128)])
def test_wkv_recurrent_route_matches_plain_and_repeats(cuda, B, S, H, hd, dtype):
    """The recurrent kernel (decode and S < CHUNKED_MIN_S) from a carried
    state: within 1e-5 of the largest |output| and |state| of the plain
    twin, and within the same of its own emulation (wkv_recurrent_ref, the
    kernel's reduction order), the same bits twice."""
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain, wkv_plan, wkv_recurrent_ref

    assert wkv_plan(S).route == "recurrent"
    ops, s0 = _wkv_operands(cuda, B, S, H, hd, B + S + hd, "fast", True, dtype)
    got = wkv_cuda(*ops, s0)
    again = wkv_cuda(*ops, s0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = tuple(a.float() for a in ops)
    _assert_wkv_close(got, wkv_plain(*plain, s0))
    _assert_wkv_close(got, wkv_recurrent_ref(*plain, s0))


def test_mix4_federation_repeats_bitwise(cuda):
    """mix4 PACFL (eq2, LeNet-5 at 16x16x3) run twice with one seed on the
    card: the same labels, round accuracies, final accuracies and cluster
    parameters, bit for bit."""
    from repro_torch.fl import run_federation
    from repro_torch.launch.fl_train import build_clients, fl_config
    from repro_torch.models.cnn import build_model

    clients, n_classes = build_clients("mix4", 30, 768, 600)
    model = build_model("lenet5", dim=768, n_classes=n_classes)

    def run():
        res = run_federation("pacfl", clients, model, fl_config("mix4", 3), seed=3,
                             eval_every=1, device=cuda)
        st = res.strategy_obj
        return res, st.labels.copy(), {k: v.clone() for k, v in st.cluster_params.items()}

    (a, la, pa), (b, lb, pb) = run(), run()
    assert [r.mean_acc for r in a.records] == [r.mean_acc for r in b.records]
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(a.final_accs, b.final_accs)
    assert pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-1.6b"])
def test_lm_serving_on_cuda_matches_cpu(cuda, arch):
    """Reduced model in float32: the kernels on the card against the plain
    twins on the CPU, prefill and 4 decode steps, one launch per layer per
    forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config(arch).reduced()
    gpu = lm.init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    prompt = serve.random_prompt(cfg, 2, 24, seed=0, device=cuda)
    name = "wkv" if cfg.block_kind == "rwkv6" else "flash_attention"
    _build.reset_launches()
    toks, _ = serve.generate(gpu, prompt, 5)
    assert _build.LAUNCHES[name] == cfg.n_layers * 5
    with torch.inference_mode():
        got, _ = lm.forward(gpu, prompt)
        cpu = gpu.to("cpu")
        want, _ = lm.forward(cpu, prompt.cpu())
    assert (got.cpu() - want).abs().max().item() <= 1e-4
    assert toks.shape == (2, 5)


@pytest.mark.parametrize("measure", ["eq3", "eq2"])
@pytest.mark.parametrize("K", [97, 100])
@pytest.mark.parametrize("n", [256, 192, 200])
def test_proximity_at_family_dims_matches_plain_and_repeats(cuda, n, K, measure):
    """The model-based families' ambient dimensions (the weight-delta
    sketch, the inference probe, a ragged probe) at mix4's and label20's K:
    within TOL_DEG of the twin, the same bits twice."""
    from repro_torch.core.angles import _hygiene
    from repro_torch.kernels.proximity import proximity_cuda, proximity_plain

    U = _signatures(K, n, 3, seed=n + K, spread=0.3).to(cuda)
    got, again = proximity_cuda(U, U, measure), proximity_cuda(U, U, measure)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = (_hygiene(got) - _hygiene(proximity_plain(U, U, measure))).abs().max().item()
    assert err <= TOL_DEG


def _client_angles_deg(Ua, Ub):
    """Each client's largest principal angle (degrees, float64)."""
    Ua, Ub = Ua.double().cpu(), Ub.double().cpu()
    R = Ub - Ua @ (Ua.transpose(1, 2) @ Ub)
    return np.degrees(np.arcsin(np.minimum(1.0, torch.linalg.matrix_norm(R, ord=2).numpy())))


@pytest.mark.parametrize("family", ["weight_delta", "inference"])
def test_family_signatures_on_cuda_repeat_and_match_cpu(cuda, family):
    """A model family's signatures (LeNet-5 at 16x16x3, 12 mix4 clients):
    the same bits twice on the card; from one set of CPU draws, each
    client's largest principal angle to the CPU's has a median within 5
    degrees and a maximum within 20 (chip_smoke.py's limits: rounding grows
    over the warmup's SGD steps, and a gate that flips under it moves a
    client by degrees); the card's signatures clustered on the card and on
    the CPU give the same labels under each measure that resolves the
    family's distances (eq2 barely tells inference signatures apart: they
    share their leading direction, so every eq2 distance is within a degree
    of 0, where a float32 arccos near 1 resolves ~1e-3 degree)."""
    import dataclasses
    import statistics

    from repro_torch.core.pacfl import PACFLConfig, cluster_clients, compute_signatures
    from repro_torch.core.signatures import FamilyContext, get_family, payloads_from_stacked
    from repro_torch.core.signatures import inference, weight_delta
    from repro_torch.core.signatures.warmup import warmup_indices
    from repro_torch.fl.client import stack_clients
    from repro_torch.launch.fl_train import build_clients
    from repro_torch.models.cnn import build_model

    clients, n_classes = build_clients("mix4", 12, 768, 600)
    model = build_model("lenet5", dim=768, n_classes=n_classes)
    payloads = payloads_from_stacked(stack_clients(clients))
    params = {"weight_delta": {"segments": 4, "steps": 8, "sketch_dim": 256},
              "inference": {"probe_per_dataset": 48, "steps": 16}}[family]
    cfg = PACFLConfig(p=3, measure="eq2", family=family, beta_quantile=0.1,
                      family_params=params)
    ctx = get_family(family).prepare_context(payloads, cfg, FamilyContext(model=model, seed0=0))
    U = compute_signatures(payloads, cfg, seed=0, context=ctx, device=cuda)
    assert torch.equal(U, compute_signatures(payloads, cfg, seed=0, context=ctx, device=cuda))
    module = weight_delta if family == "weight_delta" else inference
    hp = module._params(cfg)
    cpu = torch.device("cpu")
    idx = warmup_indices(torch.as_tensor([len(p.y_train) for p in payloads]),
                         segments=hp.get("segments", 1), steps=hp["steps"],
                         batch_size=hp["batch_size"], seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    proj = (weight_delta.sketch_projection(n_params, 256, 0, cpu)
            if family == "weight_delta" else None)
    theta0 = model.init_params(0, cpu)

    def on(dev):
        fctx = FamilyContext(model=model, probe=ctx.probe, indices=idx.to(dev),
                             theta0={k: v.to(dev) for k, v in theta0.items()},
                             projection=None if proj is None else proj.to(dev))
        return compute_signatures(payloads, cfg, context=fctx, device=dev)

    U_card = on(cuda)
    angles = _client_angles_deg(U_card, on(cpu))
    assert statistics.median(angles.tolist()) <= 5.0 and angles.max() <= 20.0
    for measure in {"weight_delta": ("eq2", "eq3"), "inference": ("eq3",)}[family]:
        mcfg = dataclasses.replace(cfg, measure=measure)
        np.testing.assert_array_equal(cluster_clients(U_card, mcfg, device=cuda).labels,
                                      cluster_clients(U_card.cpu(), mcfg, device=cpu).labels)


def test_similarity_on_cuda_matches_cpu(cuda):
    """BD, KL and MMD at d = 256 on two synthetic datasets: the card within
    1e-3 relative of the CPU (covariance condition numbers ~1e4)."""
    from repro_torch.core import similarity
    from repro_torch.data import make_dataset

    a, b = (make_dataset(name, n_train=400, n_test=8, dim=256).x_train
            for name in ("cifar10s", "svhns"))
    for fn in (similarity.bhattacharyya_gaussian, similarity.kl_gaussian, similarity.mmd_rbf):
        got = float(fn(torch.as_tensor(a, device=cuda), torch.as_tensor(b, device=cuda)))
        want = float(fn(torch.as_tensor(a), torch.as_tensor(b)))
        assert np.isfinite(got) and abs(got - want) <= 1e-3 * abs(want)


def test_drift_after_move_on_cuda_matches_cpu(cuda):
    """A fused move on an engine on the card, then DriftTracker.observe at
    three thresholds, against the same on a CPU engine adopting the same
    matrix: two planted clusters (eq3 within <= 1.4 degrees, between >= 264;
    beta 60), 8 movers from one to the other; equal labels, sizes and
    candidates, dispersions within TOL_DEG."""
    from repro_torch.core.engine import ClusterEngine, DriftTracker, EngineConfig
    from repro_torch.kernels.proximity import proximity_plain

    U = _signatures(64, 3072, 3, seed=11, spread=0.3)
    U = torch.cat([U, _signatures(64, 3072, 3, seed=12, spread=0.3)])
    A = proximity_plain(U, U, "eq3").numpy()
    A = 0.5 * (A + A.T)
    np.fill_diagonal(A, 0.0)
    cfg = EngineConfig(beta=60.0, measure="eq3")
    gpu = ClusterEngine.from_proximity(A, U, cfg, device=cuda)
    cpu = ClusterEngine.from_proximity(A, U, cfg, device="cpu")
    movers = np.arange(4, 12, dtype=np.int64)
    U_mv = _signatures(8, 3072, 3, seed=12, spread=0.3)
    gpu.move(movers, U_mv.to(cuda))
    cpu.move(movers, U_mv)
    np.testing.assert_array_equal(gpu.labels, cpu.labels)
    assert np.bincount(gpu.labels).tolist() == [56, 72]
    for thr in (None, 1.0, 300.0):   # the engine's beta; every cluster splits; all merge
        got, want = DriftTracker(thr).observe(gpu), DriftTracker(thr).observe(cpu)
        assert [(c.label, c.size) for c in got.clusters] == [(c.label, c.size) for c in want.clusters]
        assert got.split_candidates == want.split_candidates
        assert [m[:2] for m in got.merge_candidates] == [m[:2] for m in want.merge_candidates]
        for a, b in zip(got.clusters, want.clusters):
            assert abs(a.mean_intra_deg - b.mean_intra_deg) <= TOL_DEG
            assert abs(a.max_intra_deg - b.max_intra_deg) <= TOL_DEG
    assert DriftTracker(1.0).observe(gpu).split_candidates == (0, 1)
    assert len(DriftTracker(300.0).observe(gpu).merge_candidates) == 1


# ---------------------------------------------------------------------------
# the any-rank proximity route (p or q > 8): eq3 in column chunks, eq2 in
# Gram pieces with the runtime-rank reduce
# ---------------------------------------------------------------------------

# (Ka, Kb, p, q, measure): squares (Kb None) at ragged K = 70, cross blocks
ANY_RANK_CASES = [(Ka, Kb, p, q, m)
                  for p, q in [(9, 9), (12, 12), (16, 16), (3, 12), (12, 3)]
                  for Ka, Kb in [(70, None), (70, 33), (1, 40)]
                  for m in ("eq3", "eq2")
                  if (m == "eq2" or p == q) and (Kb is not None or p == q)]


@pytest.mark.parametrize("Ka,Kb,p,q,measure", ANY_RANK_CASES)
def test_any_rank_kernel_matches_plain_and_repeats(cuda, Ka, Kb, p, q, measure):
    """Squares (ragged K = 70: upper-triangle tiles) and cross blocks, each
    one counted launch under its any-rank route key, twice bitwise equal."""
    from repro_torch.core.angles import _hygiene
    from repro_torch.kernels import _build
    from repro_torch.kernels.proximity import proximity_cuda, proximity_plain

    Ua = _signatures(Ka, 300, p, seed=Ka + p, spread=0.3).to(cuda)
    Ub = Ua if Kb is None else _signatures(Kb, 300, q, seed=Kb + q + 1, spread=0.3).to(cuda)
    _build.reset_launches()
    got = proximity_cuda(Ua, Ub, measure)
    again = proximity_cuda(Ua, Ub, measure)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["proximity"] == 2
    assert _build.ROUTE_LAUNCHES["proximity", f"{measure}_any_rank"] == 2
    assert torch.equal(got, again)
    want = proximity_plain(Ua, Ub, measure)
    if Ua is Ub:
        got, want = _hygiene(got), _hygiene(want)
    assert got.shape == (Ua.shape[0], Ub.shape[0]) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL_DEG


@pytest.mark.parametrize("measure", ["eq3", "eq2"])
def test_any_rank_column_views_match_plain(cuda, measure):
    """Column views of a p = 20 stack: p = 16 at column 4 (rows staged in
    16-byte quads) and at column 2 (element by element), squared and
    crossed."""
    from repro_torch.core.angles import _hygiene
    from repro_torch.kernels.proximity import proximity_cuda, proximity_plain

    W = _signatures(90, 256, 20, seed=20, spread=0.3).to(cuda)
    V4, V2 = W[:, :, 4:], W[:, :, 2:18]
    for Ua, Ub in ((V4, V4), (V2, V2), (V4, V2[:37]), (V2[:37], V4)):
        got = proximity_cuda(Ua, Ub, measure)
        want = proximity_plain(Ua, Ub, measure)
        torch.cuda.synchronize()
        if Ua is Ub:
            got, want = _hygiene(got), _hygiene(want)
        assert (got - want).abs().max().item() <= TOL_DEG


@pytest.mark.parametrize("measure", ["eq3", "eq2"])
def test_any_rank_square_is_the_rectangle(cuda, measure):
    """At p = 16 the square (upper-triangle tiles; eq2 in tile batches and
    with both epilogues) equals the full rectangle of the stack against its
    clone, where both take one split; eq3's square is exactly symmetric."""
    from repro_torch.kernels.proximity import proximity_cuda

    U = _signatures(300, 512, 16, seed=16, spread=0.3).to(cuda)
    square = proximity_cuda(U, U, measure)
    cross = proximity_cuda(U, U.clone(), measure)
    torch.cuda.synchronize()
    assert torch.equal(square, cross)
    if measure == "eq3":
        assert torch.equal(square, square.T)


def test_pacfl_at_p16_on_cuda_matches_cpu(cuda):
    """One-shot clustering at p = 16 through the any-rank route on the card
    gives the CPU's labels from the same data (exact SVD)."""
    from repro_torch.core.pacfl import PACFLConfig, one_shot_clustering
    from repro_torch.kernels import _build

    rng = np.random.default_rng(1)
    n, p = 96, 16
    spectrum = np.geomspace(40.0, 1.0, p)
    bases = [np.linalg.qr(rng.normal(size=(n, p)))[0] for _ in range(3)]
    data = []
    for k in range(18):
        Bk = np.linalg.qr(bases[k % 3] + 0.1 / np.sqrt(n) * rng.normal(size=(n, p)))[0]
        M = int(rng.integers(150, 250))
        coef = spectrum[:, None] * rng.normal(size=(p, M))
        data.append((Bk @ coef + 0.02 * rng.normal(size=(n, M))).astype(np.float32))
    for measure, beta in (("eq3", 700.0), ("eq2", 30.0)):
        cfg = PACFLConfig(p=p, measure=measure, beta=beta, svd_method="exact")
        _build.reset_launches()
        gpu = one_shot_clustering(data, cfg, device=cuda)
        assert _build.ROUTE_LAUNCHES["proximity", f"{measure}_any_rank"] >= 1
        cpu = one_shot_clustering(data, cfg, device="cpu")
        np.testing.assert_array_equal(gpu.labels, cpu.labels)
        assert gpu.n_clusters == 3
