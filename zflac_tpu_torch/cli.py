"""Command-line interface of the port: decode / inspect / verify /
encode / bench FLAC streams (counterpart of zflac_tpu/cli.py, with the
same subcommands, arguments, printed lines and WAV reader and writer).

Decode to WAV or raw PCM, print stream structure (the frame table
doubles as a seek table), and verify integrity. Every subcommand that
decodes runs on --device (default "cuda"; "cuda:N" or "cpu"): with no
card a CUDA device raises, as the library does.

Usage:
  python -m zflac_tpu_torch.cli decode  in.flac [-o out.wav] [--raw]
        [--engine torch|native|oracle] [--device cuda|cuda:N|cpu]
  python -m zflac_tpu_torch.cli inspect in.flac [--frames N]
  python -m zflac_tpu_torch.cli verify  in.flac [--crc] [--device ...]
  python -m zflac_tpu_torch.cli encode  in.wav out.flac
  python -m zflac_tpu_torch.cli bench   in.flac [--reps N] [--device ...]
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import time


def _write_wav(path: str, interleaved, channels: int, sample_rate: int,
               bits: int) -> None:
    """Minimal RIFF/WAVE writer (PCM 16/32-bit, or 8-bit unsigned)."""
    import numpy as np
    if bits == 8:
        payload = (interleaved.astype(np.int16) + 128).astype(
            np.uint8).tobytes()
        bytes_per = 1
    else:
        payload = interleaved.tobytes()
        bytes_per = interleaved.dtype.itemsize
    with open(path, "wb") as f:
        byterate = sample_rate * channels * bytes_per
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                            byterate, channels * bytes_per, 8 * bytes_per))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def cmd_decode(args) -> int:
    import zflac_tpu_torch
    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    if args.tolerant:
        r = zflac_tpu_torch.decode_tolerant(data, device=args.device)
        if not r.stats.get("md5_ok", True):
            print(f"recovered with {r.stats['resyncs']} resync(s); "
                  "MD5 mismatch (damaged stream)")
    elif args.start is not None or args.count is not None:
        start = args.start or 0
        count = args.count if args.count is not None else (1 << 62)
        r = zflac_tpu_torch.decode_range(data, start, count,
                                         device=args.device)
    elif args.engine == "oracle":
        r = zflac_tpu_torch.decode_oracle(data, check_crc=args.crc)
    else:
        r = zflac_tpu_torch.decode(data, check_crc=args.crc,
                                   engine=args.engine, device=args.device)
    dt = time.perf_counter() - t0
    print(f"{r.num_samples} samples x {r.channels} ch, "
          f"{r.sample_rate} Hz, {r.bits_per_sample} bps "
          f"({dt * 1e3:.1f} ms, "
          f"{r.num_samples * r.channels / dt / 1e6:.1f} Msamples/s)")
    if args.output:
        if args.raw:
            with open(args.output, "wb") as f:
                f.write(r.interleaved.tobytes())
        else:
            _write_wav(args.output, r.interleaved, r.channels,
                       r.sample_rate, r.bits_per_sample)
        print(f"wrote {args.output}")
    return 0


def cmd_inspect(args) -> int:
    from zflac_tpu_torch.index import build_plan
    from zflac_tpu_torch.metadata import probe
    with open(args.input, "rb") as f:
        data = f.read()
    meta = probe(data)
    if meta.vendor:
        print(f"vendor: {meta.vendor}")
    for key, vals in meta.tags.items():
        for v in vals:
            print(f"tag: {key}={v}")
    if meta.seek_points:
        print(f"seek table: {len(meta.seek_points)} points")
    for ptype, mime, desc, w, h, size in meta.pictures:
        print(f"picture: type {ptype} {mime} {w}x{h} ({size} bytes)")
    if meta.padding_bytes:
        print(f"padding: {meta.padding_bytes} bytes")
    plan = build_plan(data)
    si = plan.info
    print(f"streaminfo: {si.channel_count} ch, {si.sample_rate} Hz, "
          f"{si.bits_per_sample} bps, {si.total_samples} samples, "
          f"block {si.min_block_size}..{si.max_block_size}, "
          f"md5 {si.md5.hex()}")
    kinds = {0: "constant", 1: "verbatim", 2: "fixed", 3: "lpc"}
    import numpy as np
    hist = {kinds[k]: int(np.sum(plan.kind == k)) for k in kinds}
    print(f"{plan.num_frames} frames, {plan.num_subframes} subframes "
          f"{hist}, max block {plan.max_block}")
    n = min(args.frames, plan.num_frames)
    for f_ in range(n):
        c0 = f_ * plan.channels
        descr = ",".join(
            f"{kinds[int(plan.kind[c0 + c])]}"
            f"(o{int(plan.order[c0 + c])})"
            for c in range(plan.channels))
        print(f"  frame {f_}: byte {int(plan.frame_byte_offset[f_])}, "
              f"bs {int(plan.block_size[f_])}, "
              f"chmode {int(plan.channel_code[f_])}, [{descr}]")
    return 0


def cmd_verify(args) -> int:
    import zflac_tpu_torch
    with open(args.input, "rb") as f:
        data = f.read()
    try:
        zflac_tpu_torch.decode(data, check_crc=args.crc, verify_md5=True,
                               device=args.device)
    except zflac_tpu_torch.FlacError as e:
        print(f"FAIL: {type(e).__name__}: {e}")
        return 1
    print("OK: MD5" + (" + CRC-8/16" if args.crc else "") + " verified")
    return 0


def _read_wav(path: str):
    """Minimal RIFF/WAVE reader (PCM 8/16/24/32-bit)."""
    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE", "not a WAV"
    pos = 12
    fmt_chunk = None
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt_chunk = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    assert fmt_chunk and payload is not None, "missing fmt/data chunk"
    _, channels, rate, _, block_align, bits = fmt_chunk
    bytes_per = bits // 8
    n = len(payload) // block_align
    if bits == 8:
        pcm = np.frombuffer(payload, np.uint8).astype(np.int64) - 128
    elif bits == 16:
        pcm = np.frombuffer(payload, "<i2").astype(np.int64)
    elif bits == 24:
        raw = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        pcm = (raw[:, 0].astype(np.int64)
               | (raw[:, 1].astype(np.int64) << 8)
               | (raw[:, 2].astype(np.int64) << 16))
        pcm = (pcm ^ (1 << 23)) - (1 << 23)
    elif bits == 32:
        pcm = np.frombuffer(payload, "<i4").astype(np.int64)
    else:
        raise ValueError(f"unsupported WAV depth {bits}")
    return pcm[:n * channels].reshape(n, channels), rate, bits


def cmd_encode(args) -> int:
    """Encode WAV to FLAC with the port's copy of the encoder."""
    from zflac_tpu_torch.encoder import EncoderConfig, encode
    pcm, rate, bits = _read_wav(args.input)
    cfg = EncoderConfig(block_size=args.block_size,
                        max_lpc_order=args.lpc_order)
    if args.tag:
        cfg.tags = dict(t.split("=", 1) for t in args.tag)
    if args.seektable:
        cfg.seektable_every = args.seektable
    t0 = time.perf_counter()
    data = encode(pcm, rate, bits, cfg)
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(data)
    raw = pcm.size * (bits // 8)
    print(f"{args.output}: {len(data)} bytes "
          f"({len(data) / raw:.1%} of PCM, {dt:.1f}s)")
    return 0


def cmd_bench(args) -> int:
    import numpy as np
    import zflac_tpu_torch
    with open(args.input, "rb") as f:
        data = f.read()
    # The first call builds and loads the kernels. decode returns host
    # PCM, so every timed call has waited for the device.
    r = zflac_tpu_torch.decode(data, device=args.device)
    total = r.num_samples * r.channels
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        zflac_tpu_torch.decode(data, device=args.device)
        times.append(time.perf_counter() - t0)
    t = float(np.median(times))
    print(json.dumps({"msamples_per_s": round(total / t / 1e6, 2),
                      "median_ms": round(t * 1e3, 2),
                      "frames": r.stats.get("frames")}))
    return 0


def _add_device(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="where the decode runs: cuda (default), "
                        "cuda:N or cpu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="zflac-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="decode to WAV/raw PCM")
    d.add_argument("input")
    d.add_argument("-o", "--output")
    d.add_argument("--raw", action="store_true")
    d.add_argument("--crc", action="store_true")
    d.add_argument("--engine", choices=("torch", "native", "oracle"),
                   default="torch")
    _add_device(d)
    d.add_argument("--start", type=int, help="first sample (seek)")
    d.add_argument("--count", type=int, help="number of samples")
    d.add_argument("--tolerant", action="store_true",
                   help="recover past corrupt regions via resync")
    d.set_defaults(fn=cmd_decode)

    i = sub.add_parser("inspect", help="print stream structure")
    i.add_argument("input")
    i.add_argument("--frames", type=int, default=8)
    i.set_defaults(fn=cmd_inspect)

    v = sub.add_parser("verify", help="verify MD5 (and CRCs with --crc)")
    v.add_argument("input")
    v.add_argument("--crc", action="store_true")
    _add_device(v)
    v.set_defaults(fn=cmd_verify)

    e = sub.add_parser("encode", help="encode WAV to FLAC")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("--block-size", type=int, default=4096)
    e.add_argument("--lpc-order", type=int, default=8)
    e.add_argument("--tag", action="append", metavar="KEY=VALUE")
    e.add_argument("--seektable", type=int, metavar="N",
                   help="seek point every N samples")
    e.set_defaults(fn=cmd_encode)

    b = sub.add_parser("bench", help="time repeated decodes")
    b.add_argument("input")
    b.add_argument("--reps", type=int, default=5)
    _add_device(b)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
