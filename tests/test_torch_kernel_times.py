"""launch.kernel_times' bookkeeping of a profiler session, on made-up
records: the padding's losses are absorbed, a lost launch of the measured
call is refused, and times are split by kernel per call."""
import pytest

from repro_torch.launch.kernel_times import short_name, split_session

SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
GRAD = "void (anonymous namespace)::wkv_bwd_grad_tc<64, __nv_bfloat16>(float const*, int)"
COPY = "Memcpy DtoD (Device -> Device)"
DU = "void (anonymous namespace)::wkv_bwd_du<64>(float const*, float*, int, int, int)"


def _session(pad, calls, lose=()):
    """Records of ``pad`` padding launches, then ``calls`` calls of two
    kernels (2 ms and 0.5 ms) and a copy; correlation ids in ``lose`` get
    no device record."""
    events, cid = [], 0
    for _ in range(pad):
        cid += 1
        events.append(("cudaLaunchKernel", cid, False, 2000))
        events.append((SPIN, cid, True, 1000))
    for _ in range(calls):
        for name, ns, api in ((GRAD, 2_000_000, "cudaLaunchKernel"), (DU, 500_000, "cuLaunchKernelEx"),
                              (COPY, 100_000, "cudaMemcpyAsync")):
            cid += 1
            events.append((api, cid, False, 3000))
            events.append((name, cid, True, ns))
    return [e for e in events if not (e[2] and e[1] in lose)]


def test_split_session_times_each_kernel_per_call():
    got = split_session(_session(4, 3), pad=4, iters=3)
    assert got.launches == {short_name(GRAD): 3, short_name(DU): 3, short_name(COPY): 3}
    assert got.ms[short_name(GRAD)] == pytest.approx(2.0)
    assert got.ms[short_name(DU)] == pytest.approx(0.5)
    assert got.pad_lost == 0


def test_split_session_absorbs_lost_padding():
    """The padding's lost records are counted; a copy is timed, not checked."""
    got = split_session(_session(4, 2, lose={1, 2, 3, 10}), pad=4, iters=2)
    assert got is not None and got.pad_lost == 3
    assert got.launches == {short_name(GRAD): 2, short_name(DU): 2, short_name(COPY): 1}


@pytest.mark.parametrize("lose", [{1, 2, 3, 4, 5}, {9}, {6}],
                         ids=["past_the_padding", "late_launch", "second_kernel"])
def test_split_session_refuses_a_lost_launch(lose):
    assert split_session(_session(4, 2, lose=lose), pad=4, iters=2) is None


def test_split_session_refuses_padding_it_cannot_place():
    events = _session(4, 1)
    no_pad_api = [e for e in events if not (not e[2] and e[1] == 1)]   # an API record lost
    assert split_session(no_pad_api, pad=4, iters=1) is None
    assert split_session(_session(2, 0), pad=4, iters=1) is None


def test_short_name():
    assert short_name(GRAD) == "wkv_bwd_grad_tc<64, __nv_bfloat16>"
    assert short_name(SPIN) == "at::cuda::spin_kernel"
