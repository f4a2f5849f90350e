"""The port's ``net/clock.py`` (NetTimePacket, NetTimeProvider,
NetClientClock, SystemClock, the least-squares calibration and the PTP
pair) against the JAX package.

The JAX package's ``tests/test_net_clock.py`` runs again on the port, its
tolerances as they are (a 5 ms skew, a slope within 0.05 of 1).  The
packet and the regression are held byte for byte and value for value; the
provider and the client of one package serve the other's across
localhost UDP (sockets on port 0), and the port's PTP slave follows the
JAX package's master and the reverse.
"""

import time

import numpy as np
import pytest

import gstreamer_tpu.net as jnet
from gstreamer_tpu.net import clock as jclock

import gstreamer_tpu_torch.net as tnet
from gstreamer_tpu_torch.net import clock as tclock

import test_net_clock
from test_torch_webrtc import reference_cases, run_case

REFERENCE = reference_cases(test_net_clock)


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    run_case(case, tmp_path)


def test_package_exports_the_clock():
    assert tnet.__all__ == jnet.__all__
    for name in tnet.__all__:
        assert getattr(tnet, name) is getattr(tclock, name)


@pytest.mark.parametrize("lt,rt", [(0, 0), (2**64 - 1, 1),
                                   (0x0102030405060708, 2**63 + 9),
                                   (2**64 + 5, -1)])
def test_packets_match(lt, rt):
    t, j = tclock.NetTimePacket(lt, rt), jclock.NetTimePacket(lt, rt)
    assert t.to_bytes() == j.to_bytes()
    b = j.to_bytes()
    assert vars(tclock.NetTimePacket.from_bytes(b)) == \
        vars(jclock.NetTimePacket.from_bytes(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linear_regression_matches(seed):
    rng = np.random.default_rng(seed)
    xs = sorted(int(x) for x in rng.integers(0, 10**12, 32))
    ys = [int(2.5 * x + 7e9 + rng.normal(0, 1e4)) for x in xs]
    assert tclock.linear_regression(xs, ys) == \
        jclock.linear_regression(xs, ys)
    assert tclock.linear_regression([5, 5], [1, 9]) == \
        jclock.linear_regression([5, 5], [1, 9])


class _OffsetClock:
    def __init__(self, offset_ns):
        self.offset = offset_ns

    def get_time(self):
        return time.monotonic_ns() + self.offset


@pytest.mark.parametrize("port_serves", [False, True])
def test_client_follows_the_other_packages_provider(port_serves):
    """test_net_clock's sync case with the provider of one package and the
    client of the other; the same tolerances, the observations 20 ms apart
    (the regression's slope noise is the round trips' jitter over their
    span, and 5 ms apart it left 0.05 once under a loaded test run)."""
    offset = 5_000_000_000
    prov = (tclock if port_serves else jclock).NetTimeProvider(
        clock=_OffsetClock(offset))
    cli = (jclock if port_serves else tclock).NetClientClock(
        "127.0.0.1", prov.port)
    try:
        for _ in range(10):
            assert cli.observe()
            time.sleep(0.02)
        err = cli.get_time() - (time.monotonic_ns() + offset)
        assert abs(err) < 5_000_000, err
        assert abs(cli.calibration[0] - 1.0) < 0.05
    finally:
        cli.close()
        prov.stop()


@pytest.mark.parametrize("port_serves", [False, True])
def test_ptp_slave_follows_the_other_packages_master(port_serves):
    """The two-step PTP exchange across packages: the slave syncs and its
    time stays within 5 ms of the master's clock (both the host's
    monotonic clock here)."""
    prov = (tclock if port_serves else jclock).PtpProvider()
    prov.start()
    cli = (jclock if port_serves else tclock).PtpClock("127.0.0.1",
                                                       prov.port)
    try:
        assert cli.sync(8)
        assert abs(cli.get_time() - time.monotonic_ns()) < 5_000_000
    finally:
        cli.close()
        prov.stop()
