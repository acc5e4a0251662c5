"""The port's native host runtime bindings (nmpc_tpu_torch/io/bridge.py,
io/robot.py): tests/test_io.py's six cases on the port, on a UDP port
picked free at run time (test_io.py binds 47311 with SO_REUSEADDR: a test on
a fixed number run beside another would have its datagrams delivered to the
other socket), and the driver loop `run_realtime` against a stub solve."""

import threading
import time

import numpy as np

from nmpc_tpu_torch.io.bridge import (Bus, Rate, UdpPublisher, UdpSubscriber, ensure_built,
                                      free_udp_port)
from nmpc_tpu_torch.io.robot import CMD_BASE, RobotBridge, run_realtime


def test_build_and_load():
    lib = ensure_built()
    assert lib.nmpc_now_ns() > 0
    assert ensure_built() is lib


def test_bus_publish_latch_roundtrip():
    bus = Bus(4)
    a, stamp = bus.latch(0, 3)
    assert a is None and stamp == 0  # never published
    bus.publish(0, [1.0, 2.0, 3.0])
    a, stamp = bus.latch(0, 3)
    np.testing.assert_allclose(a, [1.0, 2.0, 3.0])
    assert stamp > 0
    bus.publish(0, [4.0, 5.0, 6.0])   # latest-value semantics
    a2, stamp2 = bus.latch(0, 3)
    np.testing.assert_allclose(a2, [4.0, 5.0, 6.0])
    assert stamp2 >= stamp
    bus.close()


def test_bus_concurrent_latch_is_tear_free():
    """A saturating writer against a reader: no torn read, neither thread
    dies, the reader makes progress."""
    bus = Bus(1)
    stop = threading.Event()
    bad, errors, reads = [], [], [0]

    def writer():
        try:
            i = 0
            while not stop.is_set():
                v = float(i % 1000)
                bus.publish(0, [v, v, v])
                i += 1
        except BaseException as e:  # noqa: BLE001 (any death must fail the test)
            errors.append(("writer", repr(e)))

    def reader():
        try:
            while not stop.is_set():
                a, _ = bus.latch(0, 3)
                if a is not None:
                    reads[0] += 1
                    if not (a[0] == a[1] == a[2]):
                        bad.append(a.copy())
        except BaseException as e:  # noqa: BLE001
            errors.append(("reader", repr(e)))

    ths = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in ths:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in ths:
        t.join()
    assert not errors, f"thread died during the window: {errors}"
    assert not bad, f"torn reads observed: {bad[:3]}"
    assert reads[0] >= 100, f"reader starved: only {reads[0]} latches in 0.5 s"
    bus.close()


def test_udp_pub_sub_loopback():
    bus, port = Bus(8), free_udp_port()
    sub = UdpSubscriber(port, bus)
    pub = UdpPublisher("127.0.0.1", port)
    try:
        for i in range(20):
            pub.send(3, [float(i), 0.5, -0.25])
            time.sleep(0.005)
        deadline = time.time() + 2.0
        while sub.received == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert sub.received > 0
        a, _ = bus.latch(3, 3)
        assert a is not None and a[1] == 0.5 and a[2] == -0.25
    finally:
        pub.close()
        sub.close()
        bus.close()


def test_rate_keeper_paces():
    r = Rate(0.02)
    t0 = time.perf_counter()
    for _ in range(5):
        r.sleep()
    assert time.perf_counter() - t0 >= 0.08  # 5 periods of 20 ms, minus scheduling slop
    r.close()


def test_robot_bridge_frame_alignment():
    bus = Bus(210)
    origins = np.array([[1.0, 2.0, np.pi / 2], [0.0, 0.0, 0.0]])
    br = RobotBridge(2, bus, frame_origins=origins)
    # robot 0 reports local pose (1, 0, 0) -> global (1, 3, pi/2)
    bus.publish(0, [1.0, 0.0, 0.0])
    x = br.latch_joint_state(np.zeros(6))
    np.testing.assert_allclose(x[:3], [1.0, 3.0, np.pi / 2], atol=1e-6)
    np.testing.assert_allclose(x[3:], 0.0)   # robot 1 never reported: keeps default
    br.send_commands([0.1, -0.2, 0.0, 0.3])
    cmd, _ = bus.latch(CMD_BASE, 2)
    np.testing.assert_allclose(cmd, [0.1, -0.2])
    bus.close()


def test_run_realtime_latches_solves_and_stops():
    """run_realtime: each period the latched, frame-aligned state goes to
    the solve and its controls to the bus; the loop stops at the goal and
    leaves zero commands behind."""
    bus = Bus(210)
    br = RobotBridge(1, bus, frame_origins=np.array([[0.5, 0.0, 0.0]]))
    seen = []

    def solve_step(x):
        seen.append(x.copy())
        bus.publish(0, [len(seen) * 0.1, 0.0, 0.0])   # the robot moves 0.1 a period
        return np.array([0.2, 0.0])

    xs, us, missed = run_realtime(solve_step, br, np.zeros(3), 0.005, 50,
                                  goal=np.array([1.0, 0.0, 0.0]), stop_tol=1e-3)
    assert len(xs) == len(us) == 5 and missed >= 0
    np.testing.assert_allclose(xs[1], [0.6, 0.0, 0.0])
    np.testing.assert_allclose(us, 0.2 * (np.arange(2) == 0)[None].repeat(5, 0))
    cmd, _ = bus.latch(CMD_BASE, 2)
    np.testing.assert_allclose(cmd, 0.0)
    bus.close()
