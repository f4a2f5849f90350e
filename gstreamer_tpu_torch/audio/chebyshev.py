"""Chebyshev type-1/2 IIR filter design — exact port of the
reference's coefficient generators.

A host copy of the JAX package's ``audio/chebyshev.py`` (numpy).

References:
* audiocheblimit.c:204-344 (generate_biquad_coefficients) and :346-483
  (generate_coefficients): low/high-pass, biquad cascade by
  transfer-function multiplication.
* audiochebband.c:213-389 / :392-540: band-pass/band-reject via the
  z^-1 band substitution (4th-order sections).
* audiofxbaseiirfilter.c:143-181 (calculate_gain).

All math is float64 host-side (coefficient design is not hot);
filtering itself happens in the audiochebband/audiocheblimit elements.
Convention: returns (a, b) where `a` is the DENOMINATOR (feed-back)
polynomial with a[0]=1 and `b` the NUMERATOR (feed-forward), i.e.
y[n] = sum b[j] x[n-j] - sum a[j>=1] y[n-j].
"""

from __future__ import annotations

import math

import numpy as np


def calculate_gain(a, b, zr, zi):
    """|B(z)/A(z)| at z = zr + i*zi (audiofxbaseiirfilter.c:143)."""
    z = complex(zr, zi)
    sum_a = complex(a[-1])
    for c in a[-2::-1]:
        sum_a = sum_a * z + c
    sum_b = complex(b[-1])
    for c in b[-2::-1]:
        sum_b = sum_b * z + c
    return abs(sum_b / sum_a)


def _pole_1(p, np_, ripple, ftype):
    """s-plane pole (+ type-2 zero) for section p of an np_-pole
    prototype lowpass at frequency 1."""
    angle = (math.pi / 2.0) * (2.0 * p - 1) / np_
    rp = -math.sin(angle)
    ip = math.cos(angle)

    if ripple > 0 and ftype == 1:
        es = math.sqrt(10.0 ** (ripple / 10.0) - 1.0)
        vx = (1.0 / np_) * math.asinh(1.0 / es)
        rp *= math.sinh(vx)
        ip *= math.cosh(vx)
    elif ftype == 2:
        es = math.sqrt(10.0 ** (ripple / 10.0) - 1.0)
        vx = (1.0 / np_) * math.asinh(es)
        rp *= math.sinh(vx)
        ip *= math.cosh(vx)

    iz = 0.0
    if ftype == 2:
        mag2 = rp * rp + ip * ip
        rp /= mag2
        ip /= mag2
        angle = math.pi / (np_ * 2.0) + ((p - 1) * math.pi) / np_
        iz = math.cos(angle)
        iz /= iz * iz

    # bilinear transform of the prototype section
    t = 2.0 * math.tan(0.5)
    m = rp * rp + ip * ip
    d = 4.0 - 4.0 * rp * t + m * t * t
    if ftype == 1:
        x0 = (t * t) / d
        x1 = 2.0 * x0
        x2 = x0
    else:
        x0 = (t * t * iz * iz + 4.0) / d
        x1 = (-8.0 + 2.0 * iz * iz * t * t) / d
        x2 = x0
    y1 = (8.0 - 2.0 * m * t * t) / d
    y2 = (-4.0 - 4.0 * rp * t - m * t * t) / d
    return x0, x1, x2, y1, y2


def _limit_biquad(mode, ftype, poles, ripple, cutoff, rate, p):
    """One biquad of audiocheblimit (audiocheblimit.c:204-344)."""
    x0, x1, x2, y1, y2 = _pole_1(p, poles, ripple, ftype)

    omega = 2.0 * math.pi * (cutoff / rate)
    if mode == "low-pass":
        k = math.sin((1.0 - omega) / 2.0) / math.sin((1.0 + omega) / 2.0)
    else:
        k = -math.cos((omega + 1.0) / 2.0) / math.cos((omega - 1.0) / 2.0)

    d = 1.0 + y1 * k - y2 * k * k
    b0 = (x0 + k * (-x1 + k * x2)) / d
    b1 = (x1 + k * k * x1 - 2.0 * k * (x0 + x2)) / d
    b2 = (x0 * k * k - x1 * k + x2) / d
    a1 = (2.0 * k + y1 + y1 * k * k - 2.0 * y2 * k) / d
    a2 = (-k * k - y1 * k + y2) / d
    if mode == "high-pass":
        a1, b1 = -a1, -b1
    return b0, b1, b2, a1, a2


def cheb_limit_coefficients(mode, ftype, poles, cutoff, ripple, rate):
    """audiocheblimit.c generate_coefficients -> (a, b)."""
    if rate == 0:
        return np.array([1.0]), np.array([1.0])
    if cutoff >= rate / 2.0:
        return (np.array([1.0]),
                np.array([1.0 if mode == "low-pass" else 0.0]))
    if cutoff <= 0.0:
        return (np.array([1.0]),
                np.array([0.0 if mode == "low-pass" else 1.0]))

    np_ = poles
    a = np.zeros(np_ + 3)
    b = np.zeros(np_ + 3)
    a[2] = 1.0
    b[2] = 1.0
    for p in range(1, np_ // 2 + 1):
        b0, b1, b2, a1, a2 = _limit_biquad(
            mode, ftype, np_, ripple, cutoff, rate, p)
        ta, tb = a.copy(), b.copy()
        for i in range(2, np_ + 3):
            b[i] = b0 * tb[i] + b1 * tb[i - 1] + b2 * tb[i - 2]
            a[i] = ta[i] - a1 * ta[i - 1] - a2 * ta[i - 2]
    a = a[2:np_ + 3].copy()
    b = b[2:np_ + 3].copy()

    if mode == "low-pass":
        gain = calculate_gain(a, b, 1.0, 0.0)
    else:
        gain = calculate_gain(a, b, -1.0, 0.0)
    b /= gain
    return a, b


def _band_biquad(mode, ftype, poles, ripple, lower, upper, rate, p):
    """One 4th-order section of audiochebband
    (audiochebband.c:213-389). Pole prototype uses np = poles/2."""
    x0, x1, x2, y1, y2 = _pole_1(p, poles // 2, ripple, ftype)

    w0 = 2.0 * math.pi * (lower / rate)
    w1 = 2.0 * math.pi * (upper / rate)
    if mode == "band-pass":
        av = math.cos((w1 + w0) / 2.0) / math.cos((w1 - w0) / 2.0)
        bv = math.tan(1.0 / 2.0) / math.tan((w1 - w0) / 2.0)
        alpha = (2.0 * av * bv) / (1.0 + bv)
        beta = (bv - 1.0) / (bv + 1.0)
        d = 1.0 + beta * (y1 - beta * y2)
        b0 = (x0 + beta * (-x1 + beta * x2)) / d
        b1 = (alpha * (-2.0 * x0 + x1 + beta * x1 - 2.0 * beta * x2)) / d
        b2 = (-x1 - beta * beta * x1 + 2.0 * beta * (x0 + x2)
              + alpha * alpha * (x0 - x1 + x2)) / d
        b3 = (alpha * (x1 + beta * (-2.0 * x0 + x1) - 2.0 * x2)) / d
        b4 = (beta * (beta * x0 - x1) + x2) / d
        a1 = (alpha * (2.0 + y1 + beta * y1 - 2.0 * beta * y2)) / d
        a2 = (-y1 - beta * beta * y1 - alpha * alpha * (1.0 + y1 - y2)
              + 2.0 * beta * (-1.0 + y2)) / d
        a3 = (alpha * (y1 + beta * (2.0 + y1) - 2.0 * y2)) / d
        a4 = (-beta * beta - beta * y1 + y2) / d
    else:
        av = math.cos((w1 + w0) / 2.0) / math.cos((w1 - w0) / 2.0)
        bv = math.tan(1.0 / 2.0) * math.tan((w1 - w0) / 2.0)
        alpha = (2.0 * av) / (1.0 + bv)
        beta = (1.0 - bv) / (1.0 + bv)
        d = -1.0 + beta * (beta * y2 + y1)
        b0 = (-x0 - beta * x1 - beta * beta * x2) / d
        b1 = (alpha * (2.0 * x0 + x1 + beta * x1 + 2.0 * beta * x2)) / d
        b2 = (-x1 - beta * beta * x1 - 2.0 * beta * (x0 + x2)
              - alpha * alpha * (x0 + x1 + x2)) / d
        b3 = (alpha * (x1 + beta * (2.0 * x0 + x1) + 2.0 * x2)) / d
        b4 = (-beta * beta * x0 - beta * x1 - x2) / d
        a1 = (alpha * (-2.0 + y1 + beta * y1 + 2.0 * beta * y2)) / d
        a2 = -(y1 + beta * beta * y1 + 2.0 * beta * (-1.0 + y2)
               + alpha * alpha * (-1.0 + y1 + y2)) / d
        a3 = (alpha * (beta * (-2.0 + y1) + y1 + 2.0 * y2)) / d
        a4 = -(-beta * beta + beta * y1 + y2) / d
    return b0, b1, b2, b3, b4, a1, a2, a3, a4


def cheb_band_coefficients(mode, ftype, poles, lower, upper, ripple,
                           rate):
    """audiochebband.c generate_coefficients -> (a, b)."""
    if rate == 0:
        return np.array([1.0]), np.array([1.0])
    if upper <= lower:
        return (np.array([1.0]),
                np.array([0.0 if mode == "band-pass" else 1.0]))
    upper = min(upper, rate / 2)
    lower = max(lower, 0.0)

    np_ = poles
    a = np.zeros(np_ + 5)
    b = np.zeros(np_ + 5)
    a[4] = 1.0
    b[4] = 1.0
    for p in range(1, np_ // 4 + 1):
        b0, b1, b2, b3, b4, a1, a2, a3, a4 = _band_biquad(
            mode, ftype, np_, ripple, lower, upper, rate, p)
        ta, tb = a.copy(), b.copy()
        for i in range(4, np_ + 5):
            b[i] = (b0 * tb[i] + b1 * tb[i - 1] + b2 * tb[i - 2]
                    + b3 * tb[i - 3] + b4 * tb[i - 4])
            a[i] = (ta[i] - a1 * ta[i - 1] - a2 * ta[i - 2]
                    - a3 * ta[i - 3] - a4 * ta[i - 4])
    a = a[4:np_ + 5].copy()
    b = b[4:np_ + 5].copy()

    if mode == "band-reject":
        # unity gain as sqrt(H(0) * H(nyquist))
        gain = math.sqrt(calculate_gain(a, b, 1.0, 0.0)
                         * calculate_gain(a, b, -1.0, 0.0))
    else:
        # unity gain at the band center frequency
        w0 = (2.0 * math.pi * (lower / rate)
              + 2.0 * math.pi * (upper / rate)) / 2.0
        gain = calculate_gain(a, b, math.cos(w0), math.sin(w0))
    b /= gain
    return a, b
