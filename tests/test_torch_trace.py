"""The port's spans and counters (zflac_tpu_torch/utils/timer.py): each
entry's `stats` hold every phase of its call, each child within its
parent; the scan's counters say how the scan ran; the spans reach a
profiler's timeline only while one is active, and only from the thread
that opened the call; and the entries keep calling the functions the
benchmark wraps through their module attributes."""

import concurrent.futures
import contextvars
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import zflac_tpu_torch  # noqa: E402
from zflac_tpu_torch.bitio import BitReader  # noqa: E402
from zflac_tpu_torch.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu_torch.index import native_indexer  # noqa: E402
from zflac_tpu_torch.oracle import parse_metadata  # noqa: E402
from zflac_tpu_torch.runtime import decode as rdec  # noqa: E402
from zflac_tpu_torch.runtime import device as rt  # noqa: E402
from zflac_tpu_torch.testing import correlated_stereo  # noqa: E402
from zflac_tpu_torch.utils import timer  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_indexer.native_available(),
    reason="native indexer unavailable")

STREAMS = ("lpc order 8", "fixed order 2", "verbatim noise", "bps 24",
           "channels 6", "variable blocksize", "unknown length",
           "hi-res 32bit mid_side")
# Slack for sums of host-clock differences against their parent's.
EPS_MS = 1e-6

# parent key -> the keys of its children.
DEVICE_TREE = {
    "scan_ms": ("scan_estimate_ms", "scan_anchors_ms", "scan_ranges_ms",
                "scan_serial_ms"),
    "enqueue_ms": ("enqueue_upload_ms", "enqueue_launch_ms"),
}
ROWS_TREE = {
    "plan_ms": ("plan_index_ms", "plan_convert_ms"),
    "reconstruct_ms": ("reconstruct_stage_ms", "reconstruct_upload_ms",
                       "reconstruct_launch_ms", "reconstruct_wait_ms",
                       "assemble_ms"),
    "finish_ms": ("finish_md5_ms", "finish_normalize_ms"),
}
SCAN_COUNTERS = ("scan_ranges", "scan_fallbacks", "scan_range_sum_ms",
                 "scan_range_max_ms", "scan_parse_ms", "scan_emit_ms")


def _pcm(dd) -> np.ndarray:
    return dd.to_host().interleaved


def _check_tree(stats: dict, tree: dict):
    for parent, children in tree.items():
        assert stats[parent] >= 0
        assert sum(stats.get(k, 0) for k in children) <= \
            stats[parent] + EPS_MS, (parent, stats)


@pytest.fixture(scope="module")
def split_stream():
    """A 64-frame stereo stream, which four scan workers split."""
    pcm = correlated_stereo(64 * 1024, 16, seed=5)
    return pcm, encode(pcm, 44100, 16, EncoderConfig(block_size=1024))


@pytest.mark.parametrize("name", STREAMS)
def test_decode_to_device_stats_hold_every_phase(name, corpus):
    data = corpus[name][0]
    st = zflac_tpu_torch.decode_to_device(data, device="cpu").stats
    # Corpus streams are under the 1 MiB split: one serial scan.
    want = {"scan_ms", "scan_estimate_ms", "scan_serial_ms",
            "enqueue_ms", "enqueue_upload_ms", "enqueue_launch_ms",
            *SCAN_COUNTERS}
    assert want <= set(st), want - set(st)
    assert "scan_ranges_ms" not in st and "scan_anchors_ms" not in st
    assert all(st[k] >= 0 for k in want)
    _check_tree(st, DEVICE_TREE)
    assert st["scan_ranges"] == 1 and st["scan_fallbacks"] == 0
    assert st["scan_range_max_ms"] == st["scan_range_sum_ms"] <= \
        st["scan_serial_ms"] + EPS_MS
    assert st["scan_parse_ms"] + st["scan_emit_ms"] > 0
    # One thread: the C++ phases lie inside the scan.
    assert st["scan_parse_ms"] + st["scan_emit_ms"] <= st["scan_ms"]


@pytest.mark.parametrize("name", STREAMS)
def test_decode_stats_hold_every_phase(name, corpus):
    data = corpus[name][0]
    st = zflac_tpu_torch.decode(data, device="cpu").stats
    want = {k for parent, kids in ROWS_TREE.items() for k in (parent, *kids)}
    assert want <= set(st), want - set(st)
    assert all(st[k] >= 0 for k in want)
    _check_tree(st, ROWS_TREE)
    assert st["engine"] == "torch" and st["path"] == "rows"


def test_parallel_scan_counts_its_ranges(split_stream, monkeypatch):
    pcm, data = split_stream
    real = native_indexer.find_anchor
    found = []

    def recorded(*a):
        found.append(real(*a))
        return found[-1]

    monkeypatch.setattr(native_indexer, "find_anchor", recorded)
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu",
                                          scan_workers=4)
    st = dd.stats
    pos = BitReader(data)
    parse_metadata(pos)
    ranges = len({pos.pos // 8} | {a for a in found if a >= 0})
    assert len(found) == 3 and ranges > 1
    assert st["scan_ranges"] == ranges and st["scan_fallbacks"] == 0
    assert "scan_serial_ms" not in st
    _check_tree(st, DEVICE_TREE)
    assert st["scan_range_max_ms"] <= st["scan_range_sum_ms"]
    assert st["scan_range_max_ms"] <= st["scan_ranges_ms"] + EPS_MS
    # Every range's C++ phases were counted, from its worker thread.
    assert st["scan_parse_ms"] > 0 and st["scan_emit_ms"] > 0
    np.testing.assert_array_equal(_pcm(dd), pcm.reshape(-1))


def test_wrong_anchor_falls_back_to_one_serial_scan(split_stream,
                                                    monkeypatch):
    pcm, data = split_stream
    real = native_indexer.find_anchor

    def wrong(*a):
        at = real(*a)
        return at + 3 if at >= 0 else at

    monkeypatch.setattr(native_indexer, "find_anchor", wrong)
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu",
                                          scan_workers=4)
    st = dd.stats
    assert st["scan_fallbacks"] == 1 and st["scan_ranges"] > 1
    assert st["scan_serial_ms"] > 0 and st["scan_ranges_ms"] > 0
    _check_tree(st, DEVICE_TREE)
    np.testing.assert_array_equal(_pcm(dd), pcm.reshape(-1))


def _annotations(prof) -> list:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().startswith("zflac.")]


def _nested(spans, child: str, parent: str) -> bool:
    """Every `child` span lies inside some `parent` span."""
    outer = [(a, b) for n, a, b in spans if n == parent]
    kids = [(a, b) for n, a, b in spans if n == child]
    return bool(kids) and all(any(a <= c and d <= b for a, b in outer)
                              for c, d in kids)


def test_spans_reach_an_active_profiler_nested(corpus, split_stream):
    from torch.profiler import ProfilerActivity, profile, record_function

    data = corpus["lpc order 8"][0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("call"):
            zflac_tpu_torch.decode(data, device="cpu")
            zflac_tpu_torch.decode_to_device(split_stream[1], device="cpu",
                                             scan_workers=4)
    spans = _annotations(prof)
    names = {n for n, _, _ in spans}
    assert {"zflac.plan", "zflac.plan.index", "zflac.plan.convert",
            "zflac.reconstruct", "zflac.reconstruct.stage",
            "zflac.reconstruct.upload", "zflac.reconstruct.launch",
            "zflac.reconstruct.wait", "zflac.assemble", "zflac.finish",
            "zflac.finish.md5", "zflac.finish.normalize", "zflac.scan",
            "zflac.scan.estimate", "zflac.scan.anchors",
            "zflac.scan.ranges", "zflac.enqueue", "zflac.enqueue.upload",
            "zflac.enqueue.launch"} <= names
    for child, parent in (("zflac.plan.index", "zflac.plan"),
                          ("zflac.reconstruct.wait", "zflac.reconstruct"),
                          ("zflac.assemble", "zflac.reconstruct"),
                          ("zflac.finish.md5", "zflac.finish"),
                          ("zflac.scan.ranges", "zflac.scan"),
                          ("zflac.enqueue.launch", "zflac.enqueue")):
        assert _nested(spans, child, parent), child
    (call,) = [(a, b) for n, a, b in
               [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()]
               if n == "call"]
    assert all(call[0] <= a and b <= call[1] for _, a, b in spans)


def test_no_record_function_without_a_profiler(corpus, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    data = corpus["lpc order 8"][0]
    assert zflac_tpu_torch.decode(data, device="cpu").stats["plan_ms"] > 0
    assert zflac_tpu_torch.decode_to_device(
        data, device="cpu").stats["scan_ms"] > 0


def _in_worker(fn):
    """fn() as a worker thread of the open call runs it: in a copy of
    the call's context, into a recorder of its own; returns its stats."""
    def run():
        with timer.recording() as rec:
            fn()
        return rec.stats
    return contextvars.copy_context().run, run


def test_worker_threads_stay_off_the_timeline(monkeypatch):
    """While a profiler is active, a span on a worker thread of the call
    adds its time to the call once merged, but opens no
    record_function: only the calling thread's spans do."""
    opened = []

    class Range:
        def __init__(self, name):
            opened.append((name, threading.get_ident()))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(timer, "_profiling", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", Range)

    def work():
        with timer.span("worker"):
            timer.count("n", 1)

    with timer.recording() as rec:
        with timer.span("main"):
            with concurrent.futures.ThreadPoolExecutor(2) as ex:
                futures = [ex.submit(*_in_worker(work)) for _ in range(4)]
                for f in futures:
                    timer.merge(f.result(timeout=60))
    assert opened == [("zflac.main", threading.get_ident())]
    assert rec.stats["n"] == 4 and rec.stats["worker_ms"] >= 0
    assert rec.stats["main_ms"] >= 0


@pytest.mark.parametrize("case", ["no call", "nested", "raises"])
def test_recorder(case):
    if case == "no call":
        with timer.span("scan"):
            timer.count("scan_ranges", 1)
        assert timer._call.get() is None
    elif case == "nested":
        with timer.recording() as outer:
            timer.count("a", 1)
            with timer.recording() as inner:
                timer.count("a", 2.5)
                with timer.span("x.y"):
                    pass
            timer.count("a", 1)
        assert outer.stats == {"a": 2}
        assert inner.stats["a"] == 2.5 and inner.stats["x_y_ms"] >= 0
    else:
        with timer.recording() as rec:
            with pytest.raises(KeyError):
                with timer.span("fails"):
                    raise KeyError("timed all the same")
        assert rec.stats["fails_ms"] >= 0


def test_worker_counts_merge_without_loss():
    """Eight worker threads, more than there are cores here, each with
    its own recorder, while the calling thread counts too: the merged
    total loses no update."""
    import sys

    def work():
        for _ in range(2000):
            timer.count("n", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timer.recording() as rec:
            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                futures = [ex.submit(*_in_worker(work)) for _ in range(8)]
                work()
                for f in futures:
                    timer.merge(f.result(timeout=60))
    finally:
        sys.setswitchinterval(old)
    assert rec.stats["n"] == 9 * 2000


@pytest.mark.parametrize("entry,attrs", [
    ("decode_to_device", ((rt, "stream_chunks"),
                          (rt, "reconstruct_chunks"))),
    ("decode", ((rdec, "build_plan"), (rdec, "_run_reconstruct"),
                (rdec, "_assemble"), (rdec, "_finish"))),
])
def test_entries_call_through_module_attributes(entry, attrs, corpus,
                                                monkeypatch):
    """A wrapper set on each module attribute the benchmark wraps is
    called once a call."""
    calls = {}
    for mod, attr in attrs:
        real = getattr(mod, attr)

        def counted(*a, _real=real, _attr=attr, **k):
            calls[_attr] = calls.get(_attr, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, attr, counted)
    data = corpus["lpc order 8"][0]
    for n in (1, 2):
        getattr(zflac_tpu_torch, entry)(data, device="cpu")
        assert calls == {attr: n for _, attr in attrs}
