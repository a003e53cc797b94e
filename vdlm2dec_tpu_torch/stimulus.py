"""The decode tests' and measurements' stimulus: a synthetic wideband
capture with known bursts on every channel, and its cu8 quantisation.

`make_capture` and `to_u8` are the JAX package's benchmark stimulus
(bench.py at the repository root), kept here so this package needs nothing
outside itself; `tests/test_torch_selfcontained.py` holds the two equal.
One addition: `also_active` names channels that carry bursts besides every
active_every-th one (empty by default, which is the original's plan).
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from . import modulator as mod
from .constants import DEMOD_RATE
from .io.sdr import RTL_DC_OFFSET


def active_channels(n_channels: int, active_every: int = 1,
                    also_active: tuple[int, ...] = ()) -> list[int]:
    """The channels of a plan that carry bursts: every active_every-th
    one and those named in also_active, in channel order."""
    return [ci for ci in range(n_channels)
            if ci % active_every == 0 or ci in also_active]


def make_capture(fs: int, n_channels: int, seconds: float, seed: int = 0,
                 spacing: int = 50_000, active_every: int = 1,
                 base: int | None = None, impaired: bool = True,
                 also_active: tuple[int, ...] = ()):
    """Wideband capture with periodic bursts on every active_every-th
    channel and on the channels of also_active (sync/filter cost is
    per-channel regardless of traffic, so
    sparse activity keeps large-channel-count synthesis affordable).

    impaired=True (the default) gives every burst a random
    carrier-frequency offset (uniform +-400 Hz ~ +-3 ppm of the RF
    channel, the reference's correction range at d8psk.c:302), a random
    level in an 18 dB spread, a random carrier phase and a fractional-
    sample timing phase — so the recall gate actually exercises the
    sync/CFO/timing estimators.  The spread sits
    ABOVE the old clean level: strongest 8x (18 dB), weakest 1x — the
    u8 quantizer is a hard floor (1 LSB ~ the clean amplitude; bursts
    below ~0.3 LSB vanish entirely: measured 0/9 recall at 0.126x), so
    the near-far range is placed on top of it, exactly like a real
    8-bit SDR where strong stations ride well above the ADC floor.
    impaired=False is the old clean-signal stimulus.

    Returns (wide, freqs, fc, truth) where truth is the per-burst ground
    truth [(channel_index, frame content bytes, start84, len84), ...]
    used for recall matching (positions at the 84 kHz decimated rate, so
    the matcher can exclude bursts outside a truncated decode span).  Synthesis is pure-host and slow, so the result is cached on
    disk keyed by parameters."""
    cache = os.path.join(
        tempfile.gettempdir(),
        f"vdlm2_torch_stimulus_{fs}_{n_channels}_{seconds}_{seed}_{spacing}_"
        f"{active_every}_{base}_{int(impaired)}"
        f"{''.join(f'_{ci}' for ci in also_active)}.npz",
    )
    if os.path.exists(cache):
        try:
            z = np.load(cache)
            lens = z["truth_lens"]
            blob = z["truth_blob"].tobytes()
            offs = np.concatenate(([0], np.cumsum(lens)))
            truth = [(int(c), blob[offs[i]:offs[i + 1]], int(p0), int(pl))
                     for i, (c, p0, pl) in enumerate(zip(
                         z["truth_chan"], z["truth_pos"], z["truth_len84"]))]
            return (z["wide"], [int(f) for f in z["freqs"]], int(z["fc"]),
                    truth)
        except Exception:
            pass

    rng = np.random.default_rng(seed)
    if base is None:
        base = 136_600_000 if n_channels <= 32 else 136_050_000
    freqs = [base + spacing * i for i in range(n_channels)]
    # fc on the 25 kHz raster (like chooseFc in practice): offsets stay
    # raster multiples, so the wrapped-LO modes (incl. the residue-space
    # channelizer) see a phase-continuous LO
    fc = round(((min(freqs) + max(freqs)) // 2 - 287_500) / 25_000) * 25_000
    if max(abs(fc - f) for f in freqs) > fs // 2 - 50_000:
        fc = round((min(freqs) + max(freqs)) / 2 / 25_000) * 25_000
    # every channel must fit inside Nyquist: an offset beyond fs/2 aliases
    # back by exactly fs, landing ON another channel of the raster and
    # duplicating its bursts at full strength (a 64-channel plan with a
    # 3.2 MHz span in a 2 Msps capture did exactly this: 143 frames from
    # 98 bursts — a duplicate-frame anomaly)
    worst = max(abs(fc - f) for f in freqs)
    if worst > fs // 2 - 12_500:
        raise ValueError(
            f"channel plan spans {worst} Hz from fc but Nyquist is "
            f"{fs // 2} Hz: channels would alias onto each other"
        )
    total_wide = int(fs * seconds)
    total_bb = int(DEMOD_RATE * seconds)
    wide = np.zeros(total_wide, dtype=np.complex128)
    truth: list[tuple[int, bytes, int, int]] = []
    for ci in active_channels(n_channels, active_every, also_active):
        f = freqs[ci]
        bb = np.zeros(total_bb, dtype=np.complex128)
        # stagger start positions per channel, WRAPPED into the first half
        # of the capture so every active channel gets at least one burst
        # even at thousands of channels (unwrapped, 977*ci outran short
        # captures past ci~80 and the 2000-channel recall gate degenerated
        # to 2 bursts on channel 0)
        pos = 500 + (977 * ci) % max(1, total_bb // 2)
        while pos + 3000 < total_bb:
            content = rng.integers(0, 256, int(rng.integers(20, 120))).astype(np.uint8)
            if content[0] == 0x7E:
                # a frame whose FIRST content byte is 0x7E is undecodable
                # by the reference's unstuffer (vdlm2.c flag scan: at k==1
                # an unstuffed 0x7E is indistinguishable from a repeated
                # flag and is eaten, so the CRC can never pass) — and ours
                # replicates that semantics exactly.  Interior/trailing/
                # FCS 0x7E bytes roundtrip fine (verified in
                # test_golden_codec.py); only the lead byte must be
                # excluded from synthesized truth.  Real AVLC first bytes
                # are address octets, so this matches transmitter reality.
                content[0] = 0x7D
            plan = mod.make_burst([content])
            if impaired:
                burst = mod.synthesize_baseband(
                    plan, start=0, total=None,
                    cfo_hz=float(rng.uniform(-400.0, 400.0)),
                    phase0=float(rng.uniform(0.0, 2 * np.pi)),
                    timing_frac=float(rng.uniform(0.0, 1.0)),
                    amplitude=float(
                        8.0 * 10 ** (rng.uniform(-18.0, 0.0) / 20)),
                )
            else:
                burst = mod.synthesize_baseband(plan, start=0, total=None)
            if pos + len(burst) > total_bb:
                # a clipped burst is unrecoverable by construction — it
                # must not enter the capture OR the truth list (one such
                # edge burst was the 64ch config's lone recall miss)
                break
            bb[pos : pos + len(burst)] += burst
            truth.append((ci, content.tobytes(), pos, len(burst)))
            pos += len(burst) + int(rng.integers(2000, 12000))
        wide += mod.upsample_to_wideband(bb, fs, f - fc, total=total_wide)
    noise = rng.normal(size=total_wide) + 1j * rng.normal(size=total_wide)
    wide = (wide + 0.02 * noise).astype(np.complex64)
    try:
        np.savez(cache, wide=wide, freqs=np.array(freqs), fc=fc,
                 truth_chan=np.array([t_[0] for t_ in truth], np.int32),
                 truth_lens=np.array([len(t_[1]) for t_ in truth],
                                     np.int64),
                 truth_blob=np.frombuffer(
                     b"".join(t_[1] for t_ in truth), np.uint8),
                 truth_pos=np.array([t_[2] for t_ in truth], np.int64),
                 truth_len84=np.array([t_[3] for t_ in truth], np.int64))
    except OSError:
        pass
    return wide, freqs, fc, truth


def to_u8(wide: np.ndarray) -> np.ndarray:
    inter = np.empty(2 * len(wide), dtype=np.float32)
    inter[0::2] = wide.real + RTL_DC_OFFSET
    inter[1::2] = wide.imag + RTL_DC_OFFSET
    return np.clip(np.round(inter), 0, 255).astype(np.uint8)

