"""Playback-style consumer of stream_decode (counterpart of
examples/playback.py).

The reference ships an example app that decodes a file and pumps the
samples from an audio-device callback (a miniaudio callback repeatedly
pulling the next N frames from decoder state,
examples/example.zig:22-47,96-107 of the reference). This host is
headless, so the device is simulated: a callback thread wakes at the
audio period rate and pulls period-sized slices out of a bounded ring
buffer that the decode side fills INCREMENTALLY from the port's
stream_decode() on the card (`--device`, default cuda): decode runs
ahead of playback, blocks when the ring is full, and the callback
underruns (and reports it) if decode ever falls behind real time.

Usage:
  python3 -m zflac_tpu_torch.examples.playback [file.flac]
      [--period 512] [--out out.wav] [--realtime] [--device cuda|cpu]

With no file a demo stream is synthesized. The pulled samples are also
written to a WAV so the output is checkable; exit code 1 on underrun.
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading
import time
import wave

import numpy as np

from .. import probe, stream_decode


def make_demo_stream() -> bytes:
    from ..encoder import EncoderConfig, encode
    from ..testing import correlated_stereo

    pcm = correlated_stereo(44100 * 2, 16, seed=5)  # 2 s stereo
    return encode(pcm, 44100, 16, EncoderConfig(block_size=4096))


class Ring:
    """Bounded interleaved-PCM ring: decode side pushes arrays,
    callback side pulls exact period slices (the `PlayState.fill`
    analog, example.zig:22-47)."""

    def __init__(self, capacity_samples: int):
        self.q = queue.Queue()
        self.cap = capacity_samples
        self.size = 0
        self.lock = threading.Condition()
        self.leftover = np.zeros(0, np.int32)
        self.eof = False

    def push(self, chunk):
        # Split decoder chunks to ring granularity: a decode chunk (a
        # frame batch) can exceed the whole ring capacity.
        for at in range(0, len(chunk), self.cap // 2):
            piece = chunk[at:at + self.cap // 2]
            with self.lock:
                while self.size + len(piece) > self.cap:
                    self.lock.wait(0.05)
                self.size += len(piece)
            self.q.put(piece)

    def close(self):
        self.q.put(None)

    def pull(self, n):
        """Return exactly n values, or fewer at end of stream."""
        parts = [self.leftover]
        have = len(self.leftover)
        while have < n and not self.eof:
            chunk = self.q.get()
            if chunk is None:
                self.eof = True
                break
            parts.append(chunk)
            have += len(chunk)
            with self.lock:
                self.size -= len(chunk)
                self.lock.notify()
        buf = np.concatenate(parts) if len(parts) > 1 else parts[0]
        out, self.leftover = buf[:n], buf[n:]
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("file", nargs="?", help="FLAC file (demo if absent)")
    ap.add_argument("--period", type=int, default=512,
                    help="audio callback period in frames")
    ap.add_argument("--out", default="")
    ap.add_argument("--realtime", action="store_true",
                    help="pace the callback at the true period rate "
                    "(default: as fast as possible)")
    ap.add_argument("--device", default="cuda",
                    help="where stream_decode reconstructs (cuda, cuda:N "
                    "or cpu)")
    args = ap.parse_args(argv)

    if args.file:
        with open(args.file, "rb") as f:
            data = f.read()
    else:
        data = make_demo_stream()

    info = probe(data).streaminfo
    ch, sr = info.channel_count, info.sample_rate
    period_vals = args.period * ch
    ring = Ring(capacity_samples=period_vals * 64)
    failed = []

    def producer():
        try:
            for chunk in stream_decode(data, device=args.device):
                ring.push(np.asarray(chunk, dtype=np.int32).ravel())
        except Exception as e:  # reported below; the ring must close
            failed.append(e)
        finally:
            ring.close()

    t = threading.Thread(target=producer, daemon=True)
    t0 = time.perf_counter()
    t.start()

    wav = None
    if args.out:
        wav = wave.open(args.out, "wb")
        wav.setnchannels(ch)
        wav.setsampwidth(2)
        wav.setframerate(sr)

    pulled = 0
    underruns = 0
    callback_deadline = None
    while True:
        out = ring.pull(period_vals)
        if len(out) == 0:
            break
        if callback_deadline is None:
            # The device "opens" once the decoder has prebuffered: the
            # pacing clock starts at the first delivered period (kernel
            # build / first-chunk latency is startup, not underrun).
            callback_deadline = time.perf_counter()
        pulled += len(out)
        if wav is not None:
            wav.writeframes(
                np.clip(out, -32768, 32767).astype("<i2").tobytes())
        if args.realtime:
            callback_deadline += args.period / sr
            lag = time.perf_counter() - callback_deadline
            if lag > args.period / sr:
                underruns += 1
            elif lag < 0:
                time.sleep(-lag)
    wall = time.perf_counter() - t0
    if wav is not None:
        wav.close()
    t.join()
    if failed:
        raise failed[0]

    dur = pulled / ch / sr
    print(f"pumped {pulled // ch} frames ({dur:.2f} s audio) through "
          f"{args.period}-frame callbacks in {wall:.2f} s "
          f"({dur / wall:.1f}x realtime), underruns={underruns}")
    return 1 if underruns else 0


if __name__ == "__main__":
    sys.exit(main())
