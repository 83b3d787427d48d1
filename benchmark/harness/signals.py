"""Seeded PCM for the benchmark's deployments, made in torch on the
device it is given (the card in a run, the CPU in tests).

Frozen: later changes to the program's `testing.py` do not move it.
The pieces are copies of `testing.py`'s generators (`tone_mix`'s three
partials with Dirichlet gains and light noise, `noise`, the silence of
`silence_and_steps`), composed into segments that overlap by half under
a Hann window, so that spectrum, loudness and stereo width change every
segment without clicks:

- "music": per segment a coloured noise floor (resonances over a
  spectral tilt) and `tone_mix` partials, a loudness, and an L/R width
  (a share of segments near mono), with digital silence at both ends;
- "speech": per segment a voiced sound (harmonics of a pitch under three
  formants), a fricative (band-passed noise) or a pause (room noise).

Every parameter comes from the configuration's "signal" group; the
lengths come from the caller. Returns int16 PCM [n, channels].
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def _u(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                       dtype=torch.float64)


def _hann_ola(segs: torch.Tensor, hop: int, n: int) -> torch.Tensor:
    """Overlap-add segments [k, 2*hop, ch] under a periodic Hann window
    at hop `hop`; returns [n, ch]."""
    k, L, ch = segs.shape
    w = torch.hann_window(L, periodic=True, dtype=segs.dtype,
                          device=segs.device)[None, :, None]
    segs = segs * w
    out = torch.zeros((k + 1) * hop, ch, dtype=segs.dtype,
                      device=segs.device)
    out[:k * hop] += segs[:, :hop].reshape(-1, ch)
    out[hop:(k + 1) * hop] += segs[:, hop:].reshape(-1, ch)
    return out[hop // 2:hop // 2 + n]


def _shaped_noise(g, env: torch.Tensor, L: int, device) -> torch.Tensor:
    """White noise [k, L] coloured by magnitude envelope env [k, L//2+1],
    scaled to unit RMS per segment."""
    k = env.shape[0]
    x = torch.randn((k, L), generator=g, device=device, dtype=torch.float64)
    y = torch.fft.irfft(torch.fft.rfft(x) * env, n=L)
    return y / y.pow(2).mean(1, keepdim=True).sqrt().clamp_min(1e-12)


def _resonances(f, centres, widths, gains):
    """Sum of Lorentzian peaks: f [m], centres/widths/gains [k, r]."""
    d = (f[None, None, :] - centres[..., None]) / widths[..., None]
    return (gains[..., None] / (1.0 + d * d)).sum(1)


def _tone_mix(g, k: int, L: int, spec: dict, device) -> torch.Tensor:
    """`testing.tone_mix` per segment: three partials of uniform
    frequency (cycles a sample), uniform phase and Dirichlet gains, plus
    light noise; unit RMS per segment [k, L]."""
    lo, hi = spec["tone_freq"]
    freqs = _u(g, (k, 3, 1), lo, hi, device)
    phases = _u(g, (k, 3, 1), 0.0, 2 * math.pi, device)
    # Dirichlet(1, 1, 1): normalised unit exponentials.
    gains = -torch.log(_u(g, (k, 3), 1e-12, 1.0, device))
    gains = (gains / gains.sum(1, keepdim=True))[..., None]
    t = torch.arange(L, device=device, dtype=torch.float64)[None, None, :]
    x = (gains * torch.sin(2 * math.pi * freqs * t + phases)).sum(1)
    x = x + spec["tone_noise"] * torch.randn(
        (k, L), generator=g, device=device, dtype=torch.float64)
    return x / x.pow(2).mean(1, keepdim=True).sqrt().clamp_min(1e-12)


def _quantize(x: torch.Tensor, bps: int) -> torch.Tensor:
    lo, hi = -(1 << (bps - 1)), (1 << (bps - 1)) - 1
    return torch.clamp(torch.round(x), lo, hi).to(torch.int16)


def music(n: int, sample_rate: int, channels: int, bps: int, spec: dict,
          g: torch.Generator, device) -> torch.Tensor:
    """A music track of n samples a channel (stereo)."""
    if channels != 2:
        raise ValueError("the music model is stereo")
    hop = int(round(spec["segment_s"] * sample_rate))
    L = 2 * hop
    k = n // hop + 2
    f = torch.fft.rfftfreq(L, d=1.0 / sample_rate).to(device)
    fmax = sample_rate / 2
    r_lo, r_hi = spec["resonances"]
    r = r_hi
    centres = torch.exp(_u(g, (k, r), math.log(60.0), math.log(fmax * 0.7),
                           device))
    widths = centres * _u(g, (k, r), 0.05, 0.5, device)
    on = (torch.arange(r, device=device)[None, :] <
          torch.randint(r_lo, r_hi + 1, (k, 1), generator=g, device=device))
    gains = _u(g, (k, r), 0.5, 4.0, device) * on
    tilt = _u(g, (k, 1), *spec["tilt_db_per_oct"], device)
    octaves = torch.log2(f.clamp_min(20.0) / 1000.0)[None, :]
    env = 10 ** (tilt * octaves / 20) * (1.0 + _resonances(f, centres,
                                                          widths, gains))
    share = _u(g, (k, 1), *spec["tone_share"], device)
    mid = (share.sqrt() * _tone_mix(g, k, L, spec, device)
           + (1 - share).sqrt() * _shaped_noise(g, env, L, device))
    width = _u(g, (k, 1), *spec["width"], device)
    width = torch.where(torch.rand((k, 1), generator=g, device=device)
                        < spec["mono_share"], width * 0.02, width)
    side = width * _shaped_noise(g, env, L, device)
    level = 10 ** (_u(g, (k, 1), *spec["loudness_dbfs"], device) / 20)
    full = float(1 << (bps - 1))
    segs = torch.stack([mid + side, mid - side], dim=2) * (level * full)[..., None]
    x = _hann_ola(segs, hop, n)
    lead = _u(g, (2,), *spec["lead_s"], device) * sample_rate
    a, b = int(lead[0]), int(lead[1])
    x[:min(a, n)] = 0
    x[max(n - b, 0):] = 0
    return _quantize(x, bps)


def speech(n: int, sample_rate: int, channels: int, bps: int, spec: dict,
           g: torch.Generator, device) -> torch.Tensor:
    """A read-speech utterance of n samples (mono)."""
    if channels != 1:
        raise ValueError("the speech model is mono")
    hop = int(round(spec["segment_s"] * sample_rate))
    L = 2 * hop
    k = n // hop + 2
    m = L // 2 + 1
    f = torch.fft.rfftfreq(L, d=1.0 / sample_rate).to(device)
    kind = torch.rand((k,), generator=g, device=device, dtype=torch.float64)
    voiced = kind < spec["voiced_share"]
    fric = (~voiced) & (kind < spec["voiced_share"] + spec["fricative_share"])
    # Voiced: harmonics of f0 placed on the segment's bins, shaped by
    # three formants over a -12 dB/octave glottal tilt, random phases.
    f0 = _u(g, (k, 1), *spec["f0_hz"], device)
    h = torch.arange(1, int(sample_rate / 2 / spec["f0_hz"][0]) + 1,
                     device=device, dtype=torch.float64)[None, :]
    fh = f0 * h
    fc = torch.stack([_u(g, (k,), lo, hi, device)
                      for lo, hi in spec["formants_hz"]], 1)
    d = (fh[:, None, :] - fc[..., None]) / (fc[..., None] * 0.12)
    amp = 10 ** (-12 * torch.log2(h) / 20) * (1.0 + (8.0 / (1 + d * d)).sum(1))
    amp = torch.where(fh < sample_rate / 2 - 50, amp, 0.0)
    bins = torch.round(fh * L / sample_rate).long().clamp(0, m - 1)
    ph = _u(g, amp.shape, 0.0, 2 * math.pi, device)
    spec_v = torch.zeros((k, m), dtype=torch.complex128, device=device)
    spec_v.scatter_add_(1, bins, torch.polar(amp, ph))
    v = torch.fft.irfft(spec_v, n=L)
    v = v / v.pow(2).mean(1, keepdim=True).sqrt().clamp_min(1e-12)
    lo, hi = spec["fricative_band_hz"]
    band = ((f >= lo) & (f <= hi)).to(torch.float64)[None, :].expand(k, m)
    fr = _shaped_noise(g, band, L, device)
    flat = torch.ones((k, m), dtype=torch.float64, device=device)
    floor = _shaped_noise(g, flat, L, device)
    level = 10 ** (_u(g, (k, 1), *spec["loudness_dbfs"], device) / 20)
    pause = 10 ** (spec["pause_dbfs"] / 20)
    x = torch.where(voiced[:, None], level * (v + 0.05 * floor),
                    torch.where(fric[:, None], 0.5 * level * fr,
                                pause * floor))
    full = float(1 << (bps - 1))
    x = _hann_ola((x * full)[..., None], hop, n)
    return _quantize(x, bps)


MODELS = {"music": music, "speech": speech}


def make(n: int, fmt: dict, spec: dict, g: torch.Generator,
         device) -> torch.Tensor:
    """PCM [n, channels] int16 of the configuration's signal model."""
    return MODELS[spec["model"]](n, fmt["sample_rate"], fmt["channels"],
                                 fmt["bits_per_sample"], spec, g, device)
