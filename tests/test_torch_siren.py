"""The port's Siren7 (G.722.1 at 16 kHz): ``codecs/_siren_tables.py``,
``codecs/siren.py`` and ``elements/siren_elements.py`` (sirenenc, sirendec,
rtpsirenpay, rtpsirendepay) against the JAX package, bit for bit.

The JAX package's ``tests/test_siren.py`` runs again on the port's
modules (``on_port``), its oracle cases with the same ``oracle`` fixture
(the reference library compiled from its C sources, where they are
present; the fixture skips where they are not, in both packages).  Its
aptX cases are the libav family's and run in ``test_torch_libav.py``.  The codec is a copy
that keeps the JAX package's numpy dtypes: its code equals the JAX
module's statement for statement, and seeded signals give the same frames
and PCM.  The elements run the same launch strings in both packages.
"""

import ast
import inspect

import numpy as np
import pytest

from gstreamer_tpu.codecs import _siren_tables as jtables
from gstreamer_tpu.codecs import siren as jsiren
from gstreamer_tpu.elements import siren_elements as jelems

from gstreamer_tpu_torch.codecs import _siren_tables as ttables
from gstreamer_tpu_torch.codecs import siren as tsiren

import test_siren
from test_siren import oracle  # noqa: F401  (the fixture)
from test_torch_captions import pair
from test_torch_rtp import packets, reference_tests, run_on_port

REFERENCE = reference_tests(test_siren, exclude=())
ORACLE = [c for c in REFERENCE if "::TestSirenOracle::" in c[0]]
PLAIN = [c for c in REFERENCE if "::TestSirenCodec::" in c[0]
         or "::TestSirenElements::" in c[0]]


@pytest.mark.parametrize("case", PLAIN, ids=[c[0] for c in PLAIN])
def test_reference_tests_on_the_port(case, tmp_path):
    _id, fn, names, values = case
    run_on_port(fn, names, values, tmp_path)


@pytest.mark.parametrize("case", ORACLE, ids=[c[0] for c in ORACLE])
def test_oracle_tests_on_the_port(case, tmp_path, oracle):  # noqa: F811
    """The JAX package's oracle cases on the port's codec: the encoder
    bit-identical to the reference library, the decoder within 1 LSB."""
    _id, fn, names, values = case
    run_on_port(fn, names, values, tmp_path, oracle=oracle)


def _body(mod):
    """The module's code without its docstring, as an AST dump."""
    tree = ast.parse(inspect.getsource(mod))
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant))]
    return ast.dump(tree)


@pytest.mark.parametrize("pair_", [(tsiren, jsiren), (ttables, jtables)],
                         ids=["siren", "_siren_tables"])
def test_codec_is_the_references_code(pair_):
    """Statement for statement the JAX module (its docstring aside): the
    same numpy dtypes, so no float64 widening."""
    assert _body(pair_[0]) == _body(pair_[1])


def signals():
    rng = np.random.default_rng(24)
    t = np.arange(16000) / 16000.0
    yield "speechish", test_siren._speechish(16000)
    yield "noise", rng.integers(-8000, 8000, 16000).astype(np.int16)
    yield "fullscale", (np.sin(2 * np.pi * 1000 * t) * 32767).astype(
        np.int16)
    yield "chirp", np.round(12000 * np.sin(2 * np.pi * (100 + 3000 * t)
                                           * t)).astype(np.int16)
    yield "silence", np.zeros(3200, np.int16)
    yield "odd", rng.integers(-300, 300, 3333).astype(np.int16)


SIGNALS = list(signals())


@pytest.mark.parametrize("name,x", SIGNALS, ids=[s[0] for s in SIGNALS])
def test_encode_decode_match(name, x):
    coded = tsiren.encode(x)
    assert coded == jsiren.encode(x)
    y = tsiren.decode(coded)
    z = jsiren.decode(coded)
    assert y.dtype == z.dtype == np.int16
    np.testing.assert_array_equal(y, z)


def test_decoder_state_and_garbage_match():
    rng = np.random.default_rng(5)
    blob = rng.integers(0, 256, 40 * 30).astype(np.uint8).tobytes()
    td, jd = tsiren.SirenDecoder(16000), jsiren.SirenDecoder(16000)
    for k in range(0, len(blob), 40):
        np.testing.assert_array_equal(td.decode_frame(blob[k:k + 40]),
                                      jd.decode_frame(blob[k:k + 40]))


SRC = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate=16000,channels=1,"
       "layout=interleaved")


def pcm_pushes(x, block):
    return {"in": [dict(data=x[k:k + block].reshape(-1, 1),
                        pts=k * 1_000_000_000 // 16000,
                        duration=block * 1_000_000_000 // 16000)
                   for k in range(0, len(x), block)]}


@pytest.mark.parametrize("block", [320, 500, 1600])
def test_enc_dec_elements_match(block):
    x = test_siren._speechish(16000)
    _, ref, _, _ = pair(f"{SRC} ! sirenenc ! appsink name=out",
                        pcm_pushes(x, block))
    assert b"".join(p for s in ref["out"] for p in packets(s.buffer.data)) \
        == jsiren.encode(x[:len(x) // 320 * 320])
    pair(f"{SRC} ! sirenenc ! sirendec ! appsink name=out",
         pcm_pushes(x, block))


@pytest.mark.parametrize("mtu", [1400, 120, 52])
def test_rtp_elements_match(mtu):
    x = test_siren._speechish(8000)
    pair(f"{SRC} ! sirenenc ! rtpsirenpay mtu={mtu} ! appsink name=out",
         pcm_pushes(x, 960))
    _, ref, _, _ = pair(f"{SRC} ! sirenenc ! rtpsirenpay mtu={mtu} ! "
                        "rtpsirendepay ! sirendec ! appsink name=out",
                        pcm_pushes(x, 960))
    got = np.concatenate([np.asarray(s.buffer.data).reshape(-1)
                          for s in ref["out"]])
    np.testing.assert_array_equal(got, jsiren.decode(jsiren.encode(x)))


def test_rtpsiren_factories_are_siren_elements():
    """rtp_payloaders2 registers a raw rtpsirenpay pair first; the
    registry keeps siren_elements' classes, as the JAX package's does."""
    from gstreamer_tpu_torch.core.element import get_factory_class
    from gstreamer_tpu_torch.elements import siren_elements as telems
    assert get_factory_class("rtpsirenpay") is telems.RtpSirenPay
    assert get_factory_class("rtpsirendepay") is telems.RtpSirenDepay
    assert jelems.RtpSirenPay.FACTORY == "rtpsirenpay"
