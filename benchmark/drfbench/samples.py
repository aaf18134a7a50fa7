"""Samples from the seed: tones plus complex Gaussian noise, made in
blocks of ``block_rows`` rows so that any block is a pure function of
(seed, block index). The set-up, the recorder process and the reference
make the same samples without passing them between processes.

A configuration's ``signal`` entry gives, per subchannel, tones as
[frequency Hz, amplitude] or [frequency Hz, amplitude, growth per
second] (integer Hz, so a tone's phase at any sample index is exact; a
growing tone's amplitude is amplitude * (1 + growth * t), t the seconds
since the capture's start, so that a median over the newest columns
differs from one over older ones), and the noise's rms. The seed draws each tone's
phase and an offset of its frequency within +-``jitter_hz``; the sizes of
the work never depend on the seed.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: threads that make blocks in parallel (numpy's generators release the
#: interpreter lock while they fill)
THREADS = 4


class Signal:
    """The capture's samples, block by block, from one seed."""

    def __init__(self, seed: int, sr: int, nsub: int, signal: dict,
                 block_rows: int):
        self.seed = int(seed) % (1 << 64)
        self.sr = int(sr)
        self.nsub = int(nsub)
        self.block_rows = int(block_rows)
        self.noise_rms = float(signal["noise_rms"])
        tones = signal["tones"]
        if len(tones) != self.nsub:
            raise ValueError(f"signal.tones lists {len(tones)} subchannels, "
                             f"the configuration has {self.nsub}")
        rng = np.random.default_rng([self.seed, 0x70E5])
        jitter = int(signal.get("jitter_hz", 0))
        # per subchannel: [(integer frequency Hz, amplitude, phase,
        # growth per second)]
        self.tones = []
        for sub in tones:
            row = []
            for f, a, *growth in sub:
                df = int(rng.integers(-jitter, jitter + 1)) if jitter else 0
                row.append((int(f) + df, float(a),
                            float(rng.uniform(0, 2 * math.pi)),
                            float(growth[0]) if growth else 0.0))
            self.tones.append(row)
        self._tables = {}

    def _table(self, f: int, phase: float) -> np.ndarray:
        """One period of exp(i(2 pi f n / sr + phase)), complex64: the
        period is sr / gcd(f, sr) samples."""
        key = (f, phase)
        if key not in self._tables:
            n = np.arange(self._period(f), dtype=np.int64)
            ph = 2 * np.pi * ((f * n) % self.sr) / self.sr + phase
            self._tables[key] = np.exp(1j * ph).astype(np.complex64)
        return self._tables[key]

    def _period(self, f: int) -> int:
        return self.sr // math.gcd(f % self.sr, self.sr)

    def block(self, index: int) -> np.ndarray:
        """Rows [index * block_rows, (index + 1) * block_rows) as
        (block_rows, nsub) complex64."""
        rows = self.block_rows
        rng = np.random.default_rng([self.seed, int(index)])
        noise = rng.standard_normal((rows, self.nsub, 2), dtype=np.float32)
        noise *= np.float32(self.noise_rms / math.sqrt(2.0))
        out = noise.view(np.complex64)[..., 0]
        n = np.arange(index * rows, (index + 1) * rows, dtype=np.int64)
        for s, row in enumerate(self.tones):
            for f, a, ph, g in row:
                tone = self._table(f, ph)[n % self._period(f)]
                if g:
                    tone *= (a * (1.0 + g * n / self.sr)).astype(np.float32)
                else:
                    tone *= np.complex64(a)
                out[:, s] += tone
        return np.ascontiguousarray(out)

    def blocks(self, first: int, count: int) -> np.ndarray:
        """Blocks first .. first + count - 1 stacked: (count * block_rows,
        nsub) complex64, made on a few threads."""
        out = np.empty((count * self.block_rows, self.nsub), np.complex64)
        for row in self.tones:                     # tables before threads
            for f, _, ph, _ in row:
                self._table(f, ph)

        def fill(i):
            r0 = i * self.block_rows
            out[r0:r0 + self.block_rows] = self.block(first + i)

        with ThreadPoolExecutor(THREADS) as ex:
            list(ex.map(fill, range(count)))
        return out
