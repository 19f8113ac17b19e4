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
rectangle, and PACFL at p = 16 to the CPU's labels.  Flash attention also
runs at head dims 112 and 256 (split-KV decode merged at hd 256, ring and
cache-view forms), and every LM family serves at reduced size, float32,
card against CPU.  The flash backward kernel is held to its twin within
1e-4 (float32) / 2e-2 (bfloat16) of max|plain|, launched twice and bitwise
equal (at the bf16 kernels' tile edges too); two same-seed bf16 train steps
of a reduced tinyllama repeat bit for bit; reduced models' float32 gradients on the card within 1e-4 of the
CPU's (rwkv6's through the WKV backward kernel, with exact launch counts);
the training launcher runs three reduced steps.  The WKV backward kernel is
held to its twin within 1e-4 of each gradient's max|plain| (1e-2 for
bfloat16 r, k, v's dr, dk, dv, once the Function rounds them), launched
twice and bitwise equal, at chip_smoke.py's phase-3 forms, and runs its
four kernels of the sub-block chunk form at rwkv6's training shape.  The
``"sharded"`` proximity backend's row strips, four on one card (and over
every card where there are two or more), give the kernel's own bits under
eq3, and under eq2 wherever every plan takes one split of n (else within
1e-3 degrees); ``out=`` writes only its rows.
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
    # zamba2's head dim 112 (32 / 32 heads) and gemma3's 256 (8 / 4 heads)
    (2, 300, 300, 32, 32, 112, True, None, 0),
    (4, 1, 1056, 32, 32, 112, True, None, 1055),   # decode, split
    (2, 13, 77, 8, 2, 112, True, 20, 60),
    (2, 600, 600, 8, 4, 256, True, 128, 0),        # a local (windowed) layer
    (2, 300, 300, 8, 4, 256, True, None, 0),
    (4, 1, 2080, 8, 4, 256, True, None, 2079),     # split-KV decode: flash_combine at hd 256
    (4, 1, 1024, 8, 4, 256, False, None, 0),       # decode against a wrapped ring
    (4, 1, 1024, 8, 4, 256, True, None, 500),      # ... and before it is full
    (1, 5, 40, 4, 4, 256, False, 7, 50),           # rows with no valid key
    (1, 3, 40, 128, 1, 256, True, None, 0),        # 128 query heads a KV head
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,n_keys,slots,Hq,Hkv,hd,causal", [
    (4, 1, 1500, 1536, 16, 16, 64, False),   # whisper's cross decode over its padded cache
    (2, 7, 1500, 1536, 16, 16, 64, False),
    (3, 1, 100, 129, 8, 4, 256, True),       # a ragged cache view at hd 256
])
def test_flash_attention_cache_view_matches_plain(cuda, B, Sq, n_keys, slots, Hq, Hkv, hd,
                                                  causal, dtype):
    """K and V as views of the first slots of a longer cache: the kernel
    reads them in place (batch stride) and matches the twin on copies."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(n_keys + slots)
    q = torch.randn((B, Sq, Hq, hd), generator=g, device=cuda).to(dtype)
    kc = torch.randn((B, slots, Hkv, hd), generator=g, device=cuda).to(dtype)
    vc = torch.randn((B, slots, Hkv, hd), generator=g, device=cuda).to(dtype)
    k, v = kc[:, :n_keys], vc[:, :n_keys]
    q_off = n_keys - Sq if causal else 0
    got = flash_attention_cuda(q, k, v, causal=causal, q_offset=q_off)
    want = flash_attention_plain(q, k.contiguous(), v.contiguous(), causal=causal,
                                 q_offset=q_off).float()
    err = (got.float() - want).abs().max().item()
    assert err <= (2e-5 if dtype == torch.float32 else 3e-2)
    if dtype == torch.bfloat16:
        assert err <= 1e-2 * want.abs().max().item()


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


# the real head dims of the families whose reduced config would hide them
REAL_HEAD_DIM = {"gemma3-4b": 256, "zamba2-7b": 112}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-1.6b", "gemma3-4b",
                                  "qwen2-moe-a2.7b", "zamba2-7b", "whisper-medium",
                                  "internvl2-26b", "llama4-scout-17b-a16e"])
def test_lm_serving_on_cuda_matches_cpu(cuda, arch):
    """Reduced model in float32 (gemma3 and zamba2 at their real head dims):
    the kernels on the card against the plain twins on the CPU, prefill and
    4 decode steps, exactly one launch per attention call (WKV layer)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config(arch).reduced()
    if arch in REAL_HEAD_DIM:
        cfg = dataclasses.replace(cfg, head_dim=REAL_HEAD_DIM[arch])
    gpu = lm.init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    prompt = serve.random_prompt(cfg, 2, 24, seed=0, device=cuda)
    extra = serve.model_inputs(cfg, 2, dtype=torch.float32, seed=1, device=cuda)
    name = "wkv" if cfg.block_kind == "rwkv6" else "flash_attention"
    _build.reset_launches()
    toks, _ = serve.generate(gpu, prompt, 5, **extra)
    if name == "wkv":
        assert _build.LAUNCHES[name] == cfg.n_layers * 5
    else:
        assert _build.LAUNCHES[name] == (lm.attention_calls(cfg, True)
                                         + 4 * lm.attention_calls(cfg, False))
    with torch.inference_mode():
        got, _ = lm.forward(gpu, prompt, **extra)
        cpu = gpu.to("cpu")
        want, _ = lm.forward(cpu, prompt.cpu(), **{k: v.cpu() for k, v in extra.items()})
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


# (B, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset): the training forms
# (q_offset 0) at every head dim of the zoo's training families, ragged, GQA
# up to G = 6, windowed, non-causal with Sq != Skv (whisper's cross
# attention), and a query offset.
FLASH_BWD_CASES = [
    (2, 256, 256, 32, 4, 64, True, None, 0),
    (2, 77, 77, 8, 4, 256, True, 33, 0),
    (1, 200, 200, 8, 4, 256, True, None, 0),
    (2, 100, 100, 32, 32, 112, True, None, 0),
    (1, 150, 300, 16, 16, 64, False, None, 0),
    (1, 130, 130, 24, 8, 128, True, None, 0),
    (1, 90, 90, 24, 4, 32, True, 17, 0),
    (1, 65, 65, 6, 1, 64, False, None, 0),
    (1, 50, 70, 24, 4, 16, True, None, 20),
    # the bf16 kernels' tile edges: S one below and one above a 64-key /
    # 64-row tile (hd 64, G = 1) and a 32-row / 32-key tile (hd 256), and a
    # window crossing 64-key tile edges at hd 256
    (1, 63, 63, 8, 8, 64, True, None, 0),
    (1, 65, 65, 8, 8, 64, True, None, 0),
    (1, 31, 31, 4, 4, 256, True, None, 0),
    (1, 33, 33, 4, 4, 256, True, None, 0),
    (1, 160, 160, 8, 4, 256, True, 70, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,hd,causal,window,qoff", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain_and_repeats(cuda, B, Sq, Skv, Hq, Hkv, hd,
                                                         causal, window, qoff, dtype):
    """dq, dk, dv within 1e-4 (float32) / 2e-2 (bfloat16, one rounding of
    each output) of max|plain|, the forward's lse within 1e-5 of the twin's,
    one counted launch, and two launches bitwise equal."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain, flash_attention_cuda,
        flash_attention_plain)

    g = torch.Generator(device=cuda).manual_seed(Sq * 5 + Skv)
    q, do = (torch.randn((B, Sq, Hq, hd), generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, Skv, Hkv, hd), generator=g, device=cuda).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    _, want_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    before = _build.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    again = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_bwd"] == before + 2
    want = flash_attention_bwd_plain(q, k, v, o, do, want_lse, **kw)
    assert (lse - want_lse).abs().max().item() <= 1e-5
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, c in zip(got, want, again):
        assert a.dtype == dtype and a.shape == b.shape and torch.isfinite(a).all()
        assert torch.equal(a, c)
        assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()


def test_attention_under_grad_goes_through_both_kernels(cuda):
    """flash_attention with inputs that require grad runs the FlashAttention
    Function on the card: one forward and one backward launch, gradients
    as the twin's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=cuda).requires_grad_()
               for s in ((2, 40, 8, 64), (2, 40, 2, 64), (2, 40, 2, 64)))
    _build.reset_launches()
    out = flash_attention(q, k, v)
    out.sum().backward()
    assert dict(_build.LAUNCHES) == {"flash_attention": 1, "flash_attention_bwd": 1}
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    flash_attention(qc, kc, vc).sum().backward()
    for a, b in ((q, qc), (k, kc), (v, vc)):
        assert (a.grad.cpu() - b.grad).abs().max().item() <= 1e-4 * b.grad.abs().max().item()


def test_lm_train_steps_repeat_bitwise(cuda):
    """Two make_train_step steps of a reduced tinyllama (float32 masters,
    bfloat16 compute, AdamW) from one seed, run twice on the card: the same
    losses and parameters, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw, cosine_schedule

    cfg = get_config("tinyllama-1.1b").reduced()

    def run():
        params = lm.init_params(cfg, seed=7, dtype=torch.float32,
                                compute_dtype=torch.bfloat16, device=cuda)
        opt = adamw(cosine_schedule(1e-3, warmup=2, total=10))
        state = opt.init(dict(params.named_parameters()))
        step = lm.make_train_step(opt)
        gen = torch.Generator(device=cuda).manual_seed(7)
        losses = []
        for _ in range(2):
            params, state, metrics = step(params, state, synthetic_batch(cfg, 2, 64, gen))
            losses.append(float(metrics["loss"]))
        return losses, {n: p.detach().clone() for n, p in params.named_parameters()}

    (la, pa), (lb, pb) = run(), run()
    assert la == lb and np.isfinite(la).all()
    assert pa.keys() == pb.keys() and all(torch.equal(pa[n], pb[n]) for n in pa)


def test_rwkv6_gradients_on_cuda_match_cpu(cuda):
    """Reduced rwkv6 in float32: loss and every gradient of the card (the
    WKV kernels forward and backward) within 1e-4 of the CPU's (twins), each
    leaf relative to its max |g|, the decay's and bonus's leaves nonzero;
    two forward launches (remat) and one backward launch per layer."""
    from repro_torch._device import float32_math
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import lm

    cfg = get_config("rwkv6-1.6b").reduced()
    gpu = lm.init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    batch = synthetic_batch(cfg, 2, 200, torch.Generator(device=cuda).manual_seed(0))
    _build.reset_launches()
    with float32_math():
        loss, grads = lm.value_and_grad(gpu, batch)
    assert dict(_build.LAUNCHES) == lm.train_step_launches(cfg) == {"wkv": 4, "wkv_bwd": 2}
    cpu = gpu.to("cpu")
    want_loss, want = lm.value_and_grad(cpu, {k: v.cpu() for k, v in batch.items()})
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    for name, g in want.items():
        err = (grads[name].cpu() - g).abs().max().item()
        assert err <= 1e-4 * max(g.abs().max().item(), 1e-30), name
        if name.rsplit(".", 1)[-1] in ("w_base", "w_A", "w_B", "u"):
            assert grads[name].abs().max().item() > 0, name


# The backward kernel's forms (chip_smoke.py phase 3): (B, S, H, hd), fast
# decays, r k v dtype, with state0, with dstateT
WKV_BWD_CASES = [
    ((4, 2048, 32, 64), False, torch.bfloat16, False, False),
    ((4, 2048, 8, 64), False, torch.bfloat16, False, False),   # a rank's 8 of 32 heads (1x4)
    ((4, 2048, 32, 64), True, torch.float32, True, True),
    ((2, 1, 4, 64), True, torch.float32, True, True),
    ((2, 47, 4, 64), False, torch.bfloat16, True, False),
    ((2, 1111, 4, 64), True, torch.float32, False, True),
    ((2, 300, 4, 16), True, torch.bfloat16, True, True),
    ((2, 129, 4, 32), False, torch.float32, False, False),
    ((1, 300, 4, 128), True, torch.bfloat16, True, True),
]


@pytest.mark.parametrize("dims,fast,dtype,with_state,with_dT", WKV_BWD_CASES)
def test_wkv_backward_kernel_matches_plain_and_repeats(cuda, dims, fast, dtype, with_state,
                                                       with_dT):
    """dr, dk, dv, dw, du, dstate0 of two launches (bitwise equal, one
    launch counted each) within 1e-4 of the twin's max |value|; with
    bfloat16 r, k, v, dr, dk, dv also after the rounding to bfloat16 the
    Function gives them, within 1e-2."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import wkv_bwd_cuda, wkv_bwd_plain, wkv_cuda

    B, S, H, hd = dims
    (r, k, v, w, u), s0 = _wkv_operands(cuda, B, S, H, hd, S + hd, "fast" if fast else "slow",
                                        with_state, dtype)
    g = torch.Generator(device=cuda).manual_seed(S)
    dout = torch.randn((B, S, H, hd), generator=g, device=cuda)
    dT = torch.randn((B, H, hd, hd), generator=g, device=cuda) if with_dT else None
    _, _, starts = wkv_cuda(r, k, v, w, u, s0, return_starts=True)
    before = _build.LAUNCHES["wkv_bwd"]
    got = wkv_bwd_cuda(r, k, v, w, u, dout, starts, dT)
    again = wkv_bwd_cuda(r, k, v, w, u, dout, starts, dT)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wkv_bwd"] == before + 2
    want = wkv_bwd_plain(r, k, v, w, u, dout, s0, dT)
    for i, (a, b, c) in enumerate(zip(got, want, again)):
        assert a.dtype == torch.float32 and a.shape == b.shape and torch.isfinite(a).all()
        assert torch.equal(a, c)
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-4 * scale
        if dtype == torch.bfloat16 and i < 3:
            assert (a.to(dtype).float() - b).abs().max().item() <= 1e-2 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_on_a_ranks_heads_matches_plain(cuda, dtype):
    """A rank's 8 of rwkv6's 32 heads (a model axis of 4), at the serving
    shape: the prefill and a decode step from its final state against the
    plain twin (1e-5 of max |value|, as every WKV check), one launch each."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain

    (r, k, v, w, u), _ = _wkv_operands(cuda, 4, 1024, 8, 64, 8, "slow", False, dtype)
    before = _build.LAUNCHES["wkv"]
    got = wkv_cuda(r, k, v, w, u)
    _assert_wkv_close(got, wkv_plain(r.float(), k.float(), v.float(), w, u))
    (r, k, v, w, u), _ = _wkv_operands(cuda, 4, 1, 8, 64, 9, "slow", False, dtype)
    _assert_wkv_close(wkv_cuda(r, k, v, w, u, got[1]),
                      wkv_plain(r.float(), k.float(), v.float(), w, u, got[1]))
    assert _build.LAUNCHES["wkv"] == before + 2


# The WKV backward's kernels since its redesign (csrc/wkv_bwd.cu): the
# sub-block chunk form on the tensor cores (chunk shares, gradients), the
# scan over chunks and the du sum.
_WKV_BWD_KERNELS = {"wkv_bwd_chunk_tc", "wkv_bwd_scan", "wkv_bwd_grad_tc", "wkv_bwd_du"}


def test_wkv_backward_runs_the_tensor_core_kernels(cuda):
    """At rwkv6's training shape (bfloat16 r, k, v, the model's decays)
    three backward calls run each of the four kernels of the sub-block
    chunk form exactly three times (torch.profiler, every launch's device
    record present), and not the stepwise wkv_bwd_grad / wkv_bwd_chunk they
    replace."""
    from repro_torch.launch.kernel_times import kernel_times
    from repro_torch.kernels.wkv import wkv_bwd_cuda, wkv_cuda

    (r, k, v, w, u), _ = _wkv_operands(cuda, 4, 2048, 32, 64, 7, "slow", False, torch.bfloat16)
    dout = torch.randn(r.shape, generator=torch.Generator(device=cuda).manual_seed(7),
                       device=cuda)
    _, _, starts = wkv_cuda(r, k, v, w, u, return_starts=True)
    traced = kernel_times(lambda: wkv_bwd_cuda(r, k, v, w, u, dout, starts), iters=3)
    ran = {name.split("<")[0]: n for name, n in traced.launches.items()}
    assert ran == {name: 3 for name in _WKV_BWD_KERNELS}, traced.launches


def test_wkv_under_grad_goes_through_both_kernels(cuda):
    """wkv with inputs that require grad runs the WKV Function on the card:
    one forward and one backward launch, gradients as the CPU's, in each
    operand's dtype."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import wkv

    (r, k, v, w, u), s0 = _wkv_operands(cuda, 2, 150, 4, 64, 3, "fast", True)
    leaves = [a.requires_grad_() for a in (r, k, v, w, u, s0)]
    _build.reset_launches()
    out, state = wkv(*leaves)
    (out.square().sum() + state.sum()).backward()
    assert dict(_build.LAUNCHES) == {"wkv": 1, "wkv_bwd": 1}
    cpu = [a.detach().cpu().requires_grad_() for a in leaves]
    out_c, state_c = wkv(*cpu)
    (out_c.square().sum() + state_c.sum()).backward()
    for a, b in zip(leaves, cpu):
        assert a.grad.dtype == a.dtype
        assert (a.grad.cpu() - b.grad).abs().max().item() <= 1e-4 * b.grad.abs().max().item()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-4b", "whisper-medium"])
def test_lm_gradients_on_cuda_match_cpu(cuda, arch):
    """Reduced model in float32: loss and every gradient of the card (flash
    kernels forward and backward) within 1e-4 of the CPU's (twins), each
    leaf relative to its max |g|; 2 forward launches (remat) and 1 backward
    launch per attention call."""
    from repro_torch._device import float32_math
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import lm

    cfg = get_config(arch).reduced()
    gpu = lm.init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    batch = synthetic_batch(cfg, 2, 24, torch.Generator(device=cuda).manual_seed(0))
    _build.reset_launches()
    with float32_math():
        loss, grads = lm.value_and_grad(gpu, batch)
    assert dict(_build.LAUNCHES) == lm.train_step_launches(cfg)
    cpu = gpu.to("cpu")
    want_loss, want = lm.value_and_grad(cpu, {k: v.cpu() for k, v in batch.items()})
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    for name, g in want.items():
        err = (grads[name].cpu() - g).abs().max().item()
        assert err <= 1e-4 * max(g.abs().max().item(), 1e-30), name


def test_reduced_training_runs_on_cuda(cuda):
    """Three steps of the launcher (float32 masters, bfloat16 compute) on the
    card: finite losses, the flash kernels forward and backward."""
    from repro_torch.kernels import _build
    from repro_torch.launch import train

    _build.reset_launches()
    losses = train.main(["--reduced", "--steps", "3", "--batch", "2", "--seq", "32"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert _build.LAUNCHES["flash_attention_bwd"] == 3 * 2     # 2 layers a step
    assert _build.LAUNCHES["flash_attention"] == 3 * 2 * 2     # remat: twice a layer


# ---------------------------------------------------------------------------
# the "sharded" backend: row strips of the proximity kernel's cross form
# ---------------------------------------------------------------------------


def _strip_rows(K: int, N: int) -> list:
    return [len(s) for s in torch.tensor_split(torch.arange(K), N) if len(s)]


def _strips_take_one_split(Ka, Kb, n, p, q, N, square):
    """Whether the eq2 plan of every strip and of the kernel's own call take
    one split of n (then the strips give the kernel's bits: per pair the
    same Gram sums in the same order)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.proximity.proximity import eq2_plan

    sms = _build.sm_count(0)
    plans = [eq2_plan(Ka, Kb, n, p, q, square, sms)]
    plans += [eq2_plan(rows, Kb, n, p, q, False, sms) for rows in _strip_rows(Ka, N)]
    return all(plan.splits == 1 for plan in plans)


def _check_strips(U, V, devices):
    """``_proximity_strips`` over ``devices`` against the kernel on U's card:
    the square (U against itself, after hygiene) and the cross block U x V,
    eq3 bitwise, eq2 bitwise where every plan takes one split and within
    TOL_DEG elsewhere; one launch a non-empty strip; the result on U's card."""
    from repro_torch.core import angles
    from repro_torch.kernels import _build
    from repro_torch.kernels.proximity import proximity_cross

    K, n, p = U.shape
    N = len(devices)
    for measure in ("eq3", "eq2"):
        for Ub, square in ((U, True), (V, False)):
            want = proximity_cross(U, Ub, measure)
            before = _build.LAUNCHES["proximity"]
            got = angles._proximity_strips(U, Ub, measure, devices)
            assert _build.LAUNCHES["proximity"] == before + len(_strip_rows(K, N))
            assert got.device == U.device and got.shape == want.shape
            if square:
                got, want = angles._hygiene(got), angles._hygiene(want)
            if measure == "eq3" or _strips_take_one_split(K, Ub.shape[0], n, p, Ub.shape[2],
                                                          N, square):
                assert torch.equal(got, want), (measure, square, N)
            else:
                assert (got - want).abs().max().item() <= TOL_DEG, (measure, square, N)


@pytest.mark.parametrize("K,n", [(1000, 300), (97, 3072), (3, 300)])
def test_sharded_strips_on_one_card_equal_the_kernel(cuda, K, n):
    """Four strips on one card (K = 1000: every plan one split; mix4's K =
    97 at n = 3072: the plans split n; K = 3 < 4 strips) against the
    kernel's own call, and the public backend (one strip a card)."""
    from repro_torch.core import angles

    card = torch.device("cuda", torch.cuda.current_device())
    U = _signatures(K, n, 3, seed=K, spread=0.3).to(cuda)
    V = _signatures(37, n, 3, seed=7, spread=0.3).to(cuda)
    _check_strips(U, V, [card] * 4)
    if torch.cuda.device_count() == 1:
        for measure in ("eq3", "eq2"):
            assert torch.equal(angles.proximity_matrix(U, measure, backend="sharded"),
                               angles.proximity_matrix(U, measure, backend="kernel"))
            assert torch.equal(angles.cross_proximity(U, V, measure, backend="sharded"),
                               angles.cross_proximity(U, V, measure, backend="kernel"))


def test_sharded_strips_any_rank_equal_the_kernel(cuda):
    """The any-rank route (p = 16) in four strips of one card."""
    card = torch.device("cuda", torch.cuda.current_device())
    U = _signatures(300, 512, 16, seed=16, spread=0.3).to(cuda)
    V = _signatures(40, 512, 16, seed=17, spread=0.3).to(cuda)
    _check_strips(U, V, [card] * 4)


def test_proximity_out_writes_only_its_rows(cuda):
    """``out=`` takes a row strip (or a column window) of a larger matrix:
    the kernel writes those entries, the same bits as a fresh result, and
    nothing else; an ``out`` it cannot write raises."""
    from repro_torch.kernels.proximity import proximity_cross, proximity_cuda

    U = _signatures(64, 200, 3, seed=1, spread=0.3).to(cuda)
    V = _signatures(20, 200, 3, seed=2, spread=0.3).to(cuda)
    for measure in ("eq3", "eq2"):
        C = torch.full((64, 20), float("nan"), device=cuda)
        got = proximity_cross(U[16:40], V, measure, out=C[16:40])
        assert got.data_ptr() == C[16:40].data_ptr()
        assert torch.equal(C[16:40], proximity_cuda(U[16:40], V, measure))
        assert torch.isnan(C[:16]).all() and torch.isnan(C[40:]).all()
        D = torch.full((24, 30), float("nan"), device=cuda)
        proximity_cuda(U[:24], V, measure, out=D[:, 5:25])
        assert torch.equal(D[:, 5:25], proximity_cuda(U[:24], V, measure))
        assert torch.isnan(D[:, :5]).all() and torch.isnan(D[:, 25:]).all()
    for bad in (torch.empty((24, 20)), torch.empty((24, 21), device=cuda),
                torch.empty((24, 20), dtype=torch.float64, device=cuda),
                torch.empty((20, 24), device=cuda).T):
        with pytest.raises(ValueError, match="out"):
            proximity_cuda(U[:24], V, "eq3", out=bad)


def test_strip_operands_on_two_devices_raise(cuda):
    """A strip's operands (and its devices) are on one card, or it raises."""
    from repro_torch.core import angles
    from repro_torch.kernels.proximity import proximity_cross

    U = _signatures(30, 200, 3, seed=3, spread=0.3).to(cuda)
    with pytest.raises(ValueError, match="operands on"):
        proximity_cross(U, U.cpu(), "eq3")
    with pytest.raises(ValueError, match="strips"):
        angles._proximity_strips(U, U, "eq3", [U.device, torch.device("cpu")])
    if torch.cuda.device_count() >= 2:
        with pytest.raises(ValueError, match="operands on"):
            proximity_cross(U, U.to(torch.device("cuda", 1)), "eq2")


def test_sharded_across_local_cards(cuda):
    """The public backend over every local card (peer copies of the stack,
    strips copied back to the input's card), from the first card and the
    last."""
    from repro_torch.core import angles

    N = torch.cuda.device_count()
    if N < 2:
        pytest.skip("one CUDA device: strips across cards need two or more")
    devices = [torch.device("cuda", i) for i in range(N)]
    assert angles._strip_devices(devices[0]) == devices
    for home in (devices[0], devices[-1]):
        U = _signatures(1000, 300, 3, seed=11, spread=0.3).to(home)
        V = _signatures(37, 300, 3, seed=12, spread=0.3).to(home)
        _check_strips(U, V, devices)
        A = angles.proximity_matrix(U, "eq3", backend="sharded")
        assert A.device == home
        assert torch.equal(A, angles.proximity_matrix(U, "eq3", backend="kernel"))


# ---------------------------------------------------------------------------
# Tensor- and expert-parallel serving (repro_torch.sharding)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,experts,mesh,dtype", [
    ("tinyllama-1.1b", None, (1, 2), torch.float32),
    ("qwen2-moe-a2.7b", None, (1, 4), torch.float32),
    ("llama4-scout-17b-a16e", 16, (1, 4), torch.float32),
    ("llama4-scout-17b-a16e", 16, (2, 2), torch.float32),
    ("qwen2-moe-a2.7b", None, (1, 4), torch.bfloat16),
    ("llama4-scout-17b-a16e", 16, (1, 4), torch.bfloat16),
])
def test_sharded_serving_ranks_share_the_card(cuda, arch, experts, mesh, dtype):
    """Ranks sharing the card over gloo serve reduced models (16 experts
    over the model axis for llama4) with the unsharded model's logits:
    float32 within 1e-4 of their max and every greedy token equal; bfloat16
    (the CUDA GEMMs writing float32 partials) within 2e-2 of their max at
    prefill, each row's first token equal or a tie within the difference;
    every rank launching the flash kernel once per attention call."""
    import _torch_tp_ranks as ranks
    from repro_torch._device import float32_math
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import lm

    _build.build_all(["flash_attention"])   # built once here, loaded by the ranks
    data, model = mesh
    batch, prompt, n_decode = 4, 40, 6
    out = run_ranks(ranks.card_case, data * model, arch, experts, data, model, batch, prompt,
                    n_decode, dtype, backend="gloo", devices=["cuda:0"] * (data * model),
                    timeout=300)
    cfg = ranks.config(arch, experts)
    full = lm.init_params(cfg, seed=3, dtype=dtype, device=cuda)
    with float32_math():
        want = ranks._greedy(full, {"tokens": serve.random_prompt(cfg, batch, prompt, seed=0,
                                                                  device=cuda)}, n_decode)
    calls = lm.attention_calls(cfg, True) + n_decode * lm.attention_calls(cfg, False)
    rows = batch // data
    for res in out:
        d = res["coords"]["data"][0]
        w = want["logits"][:, d * rows:(d + 1) * rows].float().cpu()
        got = res["logits"].float()
        assert res["launches"].get("flash_attention") == calls
        if dtype == torch.float32:
            assert (got - w).abs().max() <= 1e-4 * w.abs().max()
            assert torch.equal(res["tokens"], want["tokens"][d * rows:(d + 1) * rows].cpu())
            continue
        err = (got[0] - w[0]).abs().max()
        assert err <= 2e-2 * w[0].abs().max()
        top2 = w[0].topk(2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= 2 * err
        assert bool(((got[0].argmax(-1) == w[0].argmax(-1)) | tie).all())


def test_llama4_scout_over_four_cards(cuda):
    """llama4-scout-17b-a16e at full width and depth (215 GB in bfloat16)
    served by ``launch.serve --mesh 1x4`` over NCCL, a card a rank: every
    rank the same tokens (batch 4, prompt 1024, 32 tokens)."""
    import _torch_tp_ranks as ranks
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_ranks

    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"llama4-scout at full depth needs four cards (54 GB of weights each); "
                    f"this machine has {n}")
    _build.build_all(["flash_attention"])
    argv = ["--arch", "llama4-scout-17b-a16e", "--mesh", "1x4", "--batch", "4",
            "--prompt-len", "1024", "--tokens", "32"]
    out = run_ranks(ranks.cli, 4, argv, backend="nccl", devices=[f"cuda:{i}" for i in range(4)],
                    timeout=900)
    for res in out:
        assert res["tokens"].shape == (4, 32)
        assert torch.equal(res["tokens"], out[0]["tokens"])
        assert 0 <= int(res["tokens"].min()) and int(res["tokens"].max()) < 202240


def test_mesh_axis_collectives_over_gloo_on_the_card(cuda):
    """``MeshAxis``' gather and reduce-scatter (``all_gather_into_tensor``,
    ``reduce_scatter_tensor``) and its all-reduces on CUDA tensors of two
    ranks sharing the card over gloo, the calls NCCL takes a card a rank:
    pieces put together in rank order, gradients summed (both gather dims)."""
    import _torch_tp_ranks as ranks
    from repro_torch.launch.mesh import run_ranks

    out = run_ranks(ranks.collectives_case, 2, "cuda", backend="gloo",
                    devices=["cuda:0"] * 2, timeout=300)
    for dim in (0, 1):
        ranks.check_collectives(out, dim)


@pytest.mark.parametrize("arch,experts,mesh,scheme,dtype", [
    ("tinyllama-1.1b", None, (1, 2), "tp_only", torch.float32),
    ("tinyllama-1.1b", None, (2, 1), "fsdp_tp", torch.float32),
    ("qwen2-moe-a2.7b", None, (1, 2), "tp_only", torch.float32),
    ("llama4-scout-17b-a16e", 16, (2, 1), "fsdp_tp", torch.float32),
    ("tinyllama-1.1b", None, (1, 2), "tp_only", torch.bfloat16),
    ("qwen2-moe-a2.7b", None, (1, 2), "tp_only", torch.bfloat16),
    ("zamba2-7b", None, (1, 2), "tp_only", torch.float32),
    ("rwkv6-1.6b", None, (1, 2), "tp_only", torch.float32),
])
def test_sharded_train_step_ranks_share_the_card(cuda, arch, experts, mesh, scheme, dtype):
    """Two ranks sharing the card over gloo train a reduced model (16
    experts over the model axis for llama4) one step, float32 under
    float32_math, against the unsharded step on the card: the loss within
    1e-5, every gradient leaf put together from the pieces within 1e-4 of
    its max |g|, the parameters after one AdamW step within 1e-5 and inside
    the window that step allows a gradient within 1e-4 of the unsharded
    one (``first_step_windows``), every piece two ranks hold bit for bit,
    and each rank launching the flash forward and backward kernels
    ``lm.train_step_launches`` times.  In bfloat16 (float32 masters; the
    row-parallel GEMMs writing float32 partials, their backward through
    bfloat16 GEMMs) the loss within 1e-2 and each gradient leaf within 1e-1
    of its max |g|: rounding order, against a wrong sum's whole-leaf error."""
    _check_sharded_train_step(cuda, arch, experts, mesh, scheme, dtype, "gloo",
                              ["cuda:0"] * (mesh[0] * mesh[1]))


@pytest.mark.parametrize("arch,scheme", [("tinyllama-1.1b", "fsdp_tp"),
                                         ("qwen2-moe-a2.7b", "tp_only")])
def test_sharded_train_step_over_nccl(cuda, arch, scheme):
    """The same step over NCCL on a 2x2 mesh, a card a rank (FSDP's
    gathers and reduce-scatters and the model axis's all-reduces through
    NCCL), against the unsharded step on card 0 at the float32 limits."""
    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"a 2x2 mesh over NCCL needs four cards (NCCL takes one rank a card); "
                    f"this machine has {n}")
    _check_sharded_train_step(cuda, arch, None, (2, 2), scheme, torch.float32, "nccl",
                              [f"cuda:{i}" for i in range(4)])


def test_sharded_checkpoint_resumes_over_nccl(cuda, tmp_path):
    """zamba2 at reduced size on a 2x2 ``fsdp_tp`` mesh over NCCL, a card a
    rank (FSDP pieces, pieces replicated over the data axis, Mamba2's B
    and C columns, the shared block): ``ckpt.save_sharded`` gathering on
    the cards, ``ckpt.restore_sharded`` onto them.  One step, save,
    restore into a fresh model and state, a second step, against two
    steps uninterrupted: the restored state is the saved one, and after
    the second step the loss, every parameter, ``m``, ``v`` and ``step``
    are bit-equal."""
    import _torch_ckpt_ranks as ckpt_ranks
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_ranks

    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"a 2x2 mesh over NCCL needs four cards (NCCL takes one rank a card); "
                    f"this machine has {n}")
    _build.build_all(["flash_attention", "flash_attention_bwd"])   # the ranks load
    out = run_ranks(ckpt_ranks.card_ckpt_case, 4, "zamba2", "zamba2-7b", None, "fsdp_tp",
                    str(tmp_path / "zamba2"), backend="nccl",
                    devices=[f"cuda:{i}" for i in range(4)], timeout=300)
    for res in out:
        assert res["restored_differ"] == [] and res["resumed_differ"] == []
        assert res["losses"][2] == res["losses"][1] and res["meta_step"] == 1
    assert len({tuple(res["losses"]) for res in out}) == 1


def _check_sharded_train_step(cuda, arch, experts, mesh, scheme, dtype, backend, devices):
    import _torch_tp_ranks as ranks
    from repro_torch import sharding
    from repro_torch._device import float32_math
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw, cosine_schedule

    _build.build_all(["flash_attention", "flash_attention_bwd", "wkv", "wkv_bwd"])   # the ranks load
    data, model = mesh
    batch, seq = 4, 64
    out = run_ranks(ranks.card_train_case, data * model, arch, experts, data, model, scheme,
                    batch, seq, dtype, backend=backend, devices=devices, timeout=300)
    cfg = ranks.config(arch, experts)
    full = lm.init_params(cfg, seed=3, dtype=torch.float32, compute_dtype=dtype, device=cuda)
    start = {n: p.detach().clone() for n, p in full.named_parameters()}
    tokens = synthetic_batch(cfg, batch, seq, torch.Generator(device=cuda).manual_seed(3), dtype)
    opt = adamw(cosine_schedule(5e-5, warmup=10, total=100), weight_decay=0.1)
    with float32_math():
        loss, grads = lm.value_and_grad(full, tokens)
        full, _, _ = lm.make_train_step(opt)(full, opt.init(dict(full.named_parameters())),
                                             tokens)
    plan = sharding.plan_for(cfg, scheme)
    got_g, same_g = ranks.assemble(cfg, plan, out, "case", "grads")   # Mamba2 by component
    got_p, same_p = ranks.assemble(cfg, plan, out, "case", "params")
    assert same_g and same_p
    f32 = dtype == torch.float32
    for res in out:
        assert res["launches"] == lm.train_step_launches(cfg)
        loss_tol = 1e-5 if f32 else 1e-2
        assert abs(float(res["case"]["loss"]) - float(loss)) <= loss_tol * abs(float(loss))
        assert torch.equal(res["case"]["loss"], out[0]["case"]["loss"])
    for name, p in full.named_parameters():
        g = grads[name].float().cpu()
        assert torch.isfinite(got_g[name]).all(), name
        assert (got_g[name] - g).abs().max() <= (1e-4 if f32 else 1e-1) * g.abs().max(), name
        if f32:
            assert (got_p[name] - p.detach().cpu()).abs().max() <= 1e-5, name
            window = ranks.first_step_windows(opt, {name: start[name].cpu()}, {name: g},
                                              {name: 1e-4 * float(g.abs().max())})[name]
            assert ranks.outside(got_p[name], window["p"]) == 0.0, name
