"""Each roofline count on a tiny stream, the kernel names as the trace
shows them, and a share worked out by hand."""

import numpy as np
import pytest

from harness import cell, flacenc, manifest, roofline, signals, trace


def _tiny():
    cfg = manifest.config("cd16_flac5")
    fmt = cfg["format"]
    pcm = signals.make(3 * 4096 + 100, fmt, cfg["signal"],
                       signals.generator(4, "cpu"), "cpu")
    data, side = flacenc.encode(pcm, fmt, cfg["encoder"], cfg["metadata"])
    return side


def test_counts_from_the_streams_content():
    side = _tiny()
    c = side.counts
    B = np.repeat(side.block, 2)
    coded = side.kind >= flacenc.KIND_FIXED
    lpc = side.kind == flacenc.KIND_LPC
    assert c["rice_residuals"] == int((B - side.order)[coded].sum())
    assert c["lpc_residuals"] == int((B - side.order)[lpc].sum())
    assert c["lpc_macs"] == int(((B - side.order) * side.order)[lpc].sum())
    assert c["samples"] == 3 * 4096 + 100 and c["channels"] == 2
    # Side channels carry 17 bits, the others 16.
    assert 16 * B.sum() <= c["sample_bits"] <= 17 * B.sum()
    # Rice bits: at least one bit a residual, at most a verbatim sample.
    assert c["rice_residuals"] <= c["rice_bits"] <= 17 * c["rice_residuals"] + 1000


COUNTS = dict(samples=1000, channels=2, container_bytes=2, rice_bits=8000,
              rice_residuals=1900, lpc_residuals=1800, lpc_sample_bits=30000,
              lpc_macs=14400, sample_bits=32500, frame_bytes=2100)


@pytest.mark.parametrize("kernel,want", [
    ("rice16", (1000 + 7600, 0.0)),
    ("lpc2", (7200 + 3750, 2 * 14400 + 2 * 1800)),
    ("lpc", (7200 + 3750, 2 * 14400 + 2 * 1800)),
    ("packtail", (32500 / 8 + 4000, 0.0)),
])
def test_work_counts(kernel, want):
    got = manifest.module("roofline", kernel).work(COUNTS)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::rice16_rows_kernel<8>(unsigned int const*, "
     "unsigned int const*, int*, int, int)", "rice16_rows_kernel<8>"),
    ("void (anonymous namespace)::lpc2_kernel<8>(int const*, int)",
     "lpc2_kernel<8>"),
    ("void (anonymous namespace)::packtail_kernel<16>(int const*, int)",
     "packtail_kernel<16>"),
    ("void (anonymous namespace)::lpc_kernel<int>(int const*, int)",
     "lpc_kernel<int>"),
    ("Memcpy HtoD (Pinned -> Device)", "Memcpy HtoD (Pinned -> Device)"),
])
def test_kernel_names(name, short):
    assert trace.short_name(name) == short
    kernel = short.split("_")[0] if "kernel" in short else None
    if kernel in ("rice16", "lpc2", "packtail", "lpc"):
        import re
        assert re.fullmatch(manifest.module("roofline", kernel).KERNEL, short)


class _Item:
    counts = COUNTS
    samples = 2000


def test_share_by_hand_and_silence():
    tr = trace.Trace(window_s=1.0, busy_s=0.1, device_s=0.1,
                     kernel_s={"lpc2_kernel<8>": 1e-6, "lpc_kernel<long>": 1.0})
    calls = [cell.Call(0, 1.0, True, True), cell.Call(0, 1.0, True, True),
             cell.Call(0, 1.0, False, True), cell.Call(0, 1.0, True, False)]
    run = cell.Run("x", {}, {}, [_Item()], calls, 1.0, {}, tr)
    b, o = manifest.module("roofline", "lpc2").work(COUNTS)
    want = 100 * roofline.least_s(2 * b, 2 * o) / 1e-6
    assert roofline.kernel_share(run, "lpc2") == pytest.approx(want)
    assert 0 < want <= 100
    assert roofline.kernel_share(run, "rice16") is None
    assert roofline.kernel_share(run, "lpc") is None


def test_merge_and_idle_labels():
    iv = np.array([[0, 10], [5, 20], [30, 40]])
    assert trace._merge(iv).tolist() == [[0, 20], [30, 40]]
    ev = lambda name, a, b: trace._Ev(name, "CPU", a, b, 0, 0, True, [], [])
    evs = [ev("call", 100, 200), ev("rows.plan", 110, 150),
           ev("rows.finish", 170, 190)]
    busy = np.array([[120, 130], [160, 175]])
    got = dict(trace._idle_by_span(evs, busy, 90, 210))
    assert got == pytest.approx({"between calls": 20e-9, "rows.plan": 30e-9,
                                 "call": 30e-9, "rows.finish": 15e-9})


def test_h2d_bytes_from_the_issuing_copy():
    ev = lambda name, dev, corr, linked, shapes=(), dtypes=(): trace._Ev(
        name, dev, 0, 1, corr, linked, False, list(shapes), list(dtypes))
    evs = [ev("aten::copy_", "CPU", 10, 0, [[100], [100], []],
              ["int", "int", "Scalar"]),
           ev("aten::copy_", "CPU", 11, 0, [[8], [8], []],
              ["long int", "long int", "Scalar"]),
           ev("Memcpy HtoD (Pinned -> Device)", "CUDA", 22, 10),
           ev("Memcpy HtoD (Pinned -> Device)", "CUDA", 23, 11),
           ev("Memcpy HtoD (Pinned -> Device)", "CUDA", 24, 99)]
    assert trace._h2d_bytes(evs, [2, 3]) == 400 + 64
    assert trace._h2d_bytes(evs, [2, 4]) is None
