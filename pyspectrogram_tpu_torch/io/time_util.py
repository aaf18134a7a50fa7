"""Exact rational-rate time <-> sample-index conversions.

Digital RF addresses samples by absolute index since the Unix epoch at an
exactly rational sample rate (num/den). The reference leans on the external
``digital_rf.util`` helpers for these conversions (reference: drfProc.py:298-299,
drfProc.py:303-306, drfview.py:828-874) and keeps the rate as an exact
``Fraction`` (reference: drfProc.py:77-79). At 10^18-scale sample indices,
float math drifts; everything here is integer/Fraction-exact on the host.
Device code only ever sees relative int32/int64 offsets.

Copy of pyspectrogram_tpu/io/time_util.py: the port imports nothing of that
package.
"""

from __future__ import annotations

import datetime
from fractions import Fraction
from typing import Union

Rate = Union[int, Fraction]

_EPOCH = datetime.datetime(1970, 1, 1)


def as_fraction(rate: Union[int, float, Fraction]) -> Fraction:
    return rate if isinstance(rate, Fraction) else Fraction(rate)


def time_to_sample(time_sec: Union[int, float, Fraction, datetime.datetime],
                   sample_rate: Rate) -> int:
    """Seconds-since-epoch (or datetime) -> absolute sample index (floor).

    Exact: a binary float converts to Fraction losslessly, so there is no
    drift for any index representable by the input.
    """
    if isinstance(time_sec, datetime.datetime):
        time_sec = datetime_to_timestamp(time_sec)
    t = Fraction(time_sec)
    s = t * as_fraction(sample_rate)
    return s.numerator // s.denominator


def sample_to_time(sample: int, sample_rate: Rate) -> Fraction:
    """Absolute sample index -> exact seconds since epoch (Fraction)."""
    return Fraction(sample) / as_fraction(sample_rate)


def sample_to_datetime(sample: int, sample_rate: Rate) -> datetime.datetime:
    """Absolute sample index -> naive-UTC datetime (microsecond precision).

    Mirrors the reference's per-STI-column datetime labels
    (reference: drfProc.py:303-306).
    """
    t = sample_to_time(sample, sample_rate)
    whole = t.numerator // t.denominator
    frac = t - whole
    micros = int(round(frac * 1_000_000))
    return _EPOCH + datetime.timedelta(seconds=whole, microseconds=micros)


def samples_to_datetime64(samples, sample_rate: Rate):
    """Vectorized exact sample-index -> datetime64[us] conversion.

    Same rounding as :func:`sample_to_datetime` (round-half-even on the
    microsecond), but pure int64 vector math — the per-column Python
    Fraction loop costs ~1 s at the reference's ntime=100,000 ceiling
    (reference: drfProc.py:303-306); this is ~1000x faster. Falls back to
    the exact scalar path if the intermediate products could overflow
    int64 (never for realistic rates/indices).
    """
    import numpy as np

    sr = as_fraction(sample_rate)
    num, den = sr.numerator, sr.denominator
    s = np.asarray(samples, dtype=np.int64)
    den_us = den * 1_000_000
    if s.size:
        # overflow guards, in unbounded Python ints:
        #   base_us = (s // num) * den_us;  n = (s % num) * den_us
        qmax = max(abs(int(s.max())), abs(int(s.min()))) // num + 1
        if qmax * den_us >= 2**62 or num * den_us >= 2**62:
            return np.array(
                [np.datetime64(_us_halfeven(int(v), num, den_us), "us")
                 for v in s]
            )
    q, r = np.divmod(s, num)            # exact: s = q*num + r, 0 <= r < num
    base_us = q * den_us
    fl, rem = np.divmod(r * den_us, num)
    two = 2 * rem
    round_up = (two > num) | ((two == num) & (fl % 2 == 1))
    return (base_us + fl + round_up.astype(np.int64)).view("datetime64[us]")


def _us_halfeven(sample: int, num: int, den_us: int) -> int:
    """Exact microseconds since epoch of sample at rate num/(den_us/1e6),
    rounded half-even — unbounded Python ints (the scalar fallback for
    values whose intermediates would overflow int64)."""
    fl, rem = divmod(sample * den_us, num)
    two = 2 * rem
    if two > num or (two == num and fl & 1):
        fl += 1
    return fl


def datetime_to_timestamp(dt: datetime.datetime) -> Fraction:
    """Naive-UTC datetime -> exact seconds since epoch."""
    delta = dt - _EPOCH
    return Fraction(delta.days) * 86_400 + delta.seconds + Fraction(delta.microseconds, 1_000_000)


def sample_to_millisecond(sample: int, num: int, den: int) -> int:
    """Floor millisecond timestamp of a sample at rate num/den.

    This is the placement rule that decides which Digital RF file/subdir a
    sample lives in; integer-exact.
    """
    return (sample * 1000 * den) // num


def millisecond_to_sample_ceil(ms: int, num: int, den: int) -> int:
    """Smallest sample index whose time is >= ms milliseconds."""
    return -((-ms * num) // (1000 * den))
