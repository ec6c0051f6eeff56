"""The device-time harness (``repro_torch.devtime``) on the CPU: a
profiler window that missed calls, or saw a call's kernels partly, is
"not measured", never a smaller mean."""
import pytest

from repro_torch import devtime

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

DECODE = devtime.EXPECT["flash_attention_decode_bf16"]


def ev(name, us):
    """A device event as the Chrome trace gives it."""
    return {"name": name, "dur": us, "cat": "kernel", "ph": "X"}


def window(calls, per_call):
    """Device events of ``calls`` calls, each launching ``per_call``."""
    return [dict(e) for _ in range(calls) for e in per_call]


def decode_call(us=6.0):
    return [ev("void flash_decode_split_kernel<64>(...)", us),
            ev("flash_decode_merge_kernel(...)", us)]


def test_complete_window_gives_the_mean_per_call():
    ms, counts = devtime.count_window(window(10, decode_call()), DECODE, 10)
    assert ms == pytest.approx(0.012)
    assert counts == {"flash_decode_split_kernel": 10,
                      "flash_decode_merge_kernel": 10}


@pytest.mark.parametrize("seen", [0, 3, 5, 9])
def test_window_with_calls_missing_is_not_measured(seen):
    """The fault this harness repairs: 5 of 10 calls caught, averaged
    over 10, read half the real time."""
    ms, counts = devtime.count_window(window(seen, decode_call()), DECODE, 10)
    assert ms is None
    assert counts["flash_decode_split_kernel"] == seen


def test_window_missing_part_of_a_call_is_not_measured():
    events = window(10, decode_call())
    del events[5]  # one merge kernel dropped
    assert devtime.count_window(events, DECODE, 10)[0] is None


def test_unnamed_events_must_split_evenly_over_the_calls():
    """local_chase launches its kernel and a flag fill per call: a window
    that lost one fill is not measured either."""
    expect = devtime.EXPECT["local_chase"]
    call = [ev("chase_persistent_kernel", 460.0),
            ev("vectorized_elementwise_kernel<FillFunctor<int>>", 1.0)]
    ms, _ = devtime.count_window(window(10, call), expect, 10)
    assert ms == pytest.approx(0.461)
    assert devtime.count_window(window(10, call)[:-1], expect, 10)[0] is None


def test_extra_launches_are_not_measured():
    ssd = devtime.EXPECT["ssd_scan_bf16"]
    call = [ev(k, 30.0) for k in ssd]
    assert devtime.count_window(window(10, call), ssd, 10)[0] == \
        pytest.approx(0.12)
    assert devtime.count_window(window(11, call), ssd, 10)[0] is None


def test_kernel_names_do_not_shadow_each_other():
    """``ssd_scan_kernel`` (float32) is not counted in the bf16
    ``ssd_chunk_scan_kernel``, nor ``flash_fwd_kernel`` in the
    tensor-core ``flash_fwd_mma_kernel``."""
    events = [ev("ssd_chunk_scan_kernel<64,128>", 1.0),
              ev("flash_fwd_mma_kernel<64>", 1.0)]
    counts = devtime.kernel_counts(events, ("ssd_scan_kernel",
                                            "flash_fwd_kernel"))
    assert counts == {"ssd_scan_kernel": 0, "flash_fwd_kernel": 0}


def test_complete_checks_a_whole_solve_window():
    events = window(546, [ev("mailbox_pack_kernel<4>", 36.0)]) + \
        [ev("chase_persistent_kernel", 460.0)]
    want = {"mailbox_pack_kernel": 546, "chase_persistent_kernel": 1}
    assert devtime.complete(events, want)
    assert not devtime.complete(events[1:], want)


SOLVE = {"mailbox_pack_kernel": 3, "chase_persistent_kernel": 1}


def solve_window(fills=5):
    """A whole call's events: the named kernels and ``fills`` unnamed."""
    return (window(3, [ev("mailbox_pack_kernel<4>", 36.0)])
            + [ev("chase_persistent_kernel", 460.0)]
            + window(fills, [ev("FillFunctor<int>", 1.0)]))


def runs_of(windows):
    """A ``run`` for ``checked_window`` that returns ``windows`` in turn
    (the window's index as its result, 1.0 s as its wall)."""
    it = iter(enumerate(windows))

    def run():
        i, events = next(it)
        return i, events, 1.0
    return run


def named_check(events):
    return None if devtime.complete(events, SOLVE) else "launches missed"


def test_checked_window_retries_until_a_window_passes():
    logged = []
    missing = solve_window()[1:]  # one pack launch dropped
    result, events, _ = devtime.checked_window(
        runs_of([[], missing, solve_window()]), named_check, windows=3,
        log=logged.append)
    assert result == 2 and events == solve_window()
    assert len(logged) == 2 and all("not read" in m for m in logged)


def test_checked_window_with_no_whole_window_is_not_measured():
    result, events, wall = devtime.checked_window(
        runs_of([[], solve_window()[1:]]), named_check, windows=2,
        log=lambda m: None)
    assert events is None and result == 1 and wall == 1.0


@pytest.mark.parametrize("fills,passes_at", [
    ((5, 5), 1),           # two whole windows agree: the second is read
    ((4, 5, 5), 2),        # the first lost an unnamed fill
    ((5, 4, 5), 2),        # the second did
    ((5, 4, 4), None),     # two agree, but on fewer events than the first
    ((4, 5), None),        # only one window at the most events
])
def test_repeat_check_needs_two_whole_windows_that_agree(fills, passes_at):
    """Every named launch is there in each window; only the events no
    name counts differ, which the named check alone cannot see."""
    windows = [solve_window(f) for f in fills]
    result, events, _ = devtime.checked_window(
        runs_of(windows), devtime.repeat_check(named_check),
        windows=len(windows), log=lambda m: None)
    if passes_at is None:
        assert events is None
    else:
        assert result == passes_at and events == windows[passes_at]


def test_repeat_check_does_not_pair_with_a_window_that_missed_launches():
    windows = [solve_window()[1:], solve_window(), solve_window()]
    result, events, _ = devtime.checked_window(
        runs_of(windows), devtime.repeat_check(named_check), windows=3,
        log=lambda m: None)
    assert result == 2
