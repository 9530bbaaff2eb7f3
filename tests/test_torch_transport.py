"""The port's SpoolTransport (``mxnet_tpu_torch/parallel/transport.py``)
against the JAX package's: every case of ``tests/test_fleet.py``'s
transport section runs on both packages under the same seeded plans, and
each case's record (the delivered sequence and payloads, the stats, the
injected events) must be the same in both.  Spool files written by one
package are read by the other, both ways."""
import os
import time

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch
from mxnet_tpu.parallel import transport as jtransport
from mxnet_tpu_torch.parallel import transport as ptransport

PKGS = {"jax": (mxnet_tpu, jtransport), "torch": (mxnet_tpu_torch,
                                                  ptransport)}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for mx, _ in PKGS.values():
        mx.fault.uninstall()


def _pair(tr, root):
    return tr.SpoolTransport(root, 0, 2), tr.SpoolTransport(root, 1, 2)


def _drain(t, n, timeout_s=5.0):
    got = []
    deadline = time.monotonic() + timeout_s
    while len(got) < n and time.monotonic() < deadline:
        got += t.recv()
        time.sleep(0.005)
    return got


def _msgs(msgs):
    """A delivered sequence as plain data: the stripped header (no trace
    header), the ids and the payloads."""
    return [(m.sender, m.seq, m.kind,
             {k: v for k, v in m.meta.items() if k != "_trace"},
             {k: v.tolist() for k, v in sorted(m.arrays.items())})
            for m in msgs]


def _events(plan):
    return [(i["site"], i["kind"]) for i in plan.stats()["injected"]]


# each case: (mx, transport module, root) -> a record; the JAX test's
# assertions hold inside, and the two packages' records must be equal


def roundtrip(mx, tr, root):
    a, b = _pair(tr, root)
    a.send(1, "x", meta={"tag": "first"}, arrays={"v": np.arange(3.0)})
    a.send(1, "x", meta={"tag": "second"})
    got = _drain(b, 2)
    assert [m.meta["tag"] for m in got] == ["first", "second"]
    assert got[0].sender == 0 and got[0].kind == "x"
    np.testing.assert_array_equal(got[0].arrays["v"], np.arange(3.0))
    assert b.stats()["received"] == 2 and a.stats()["sent"] == 2
    return _msgs(got), a.stats(), b.stats()


def partition(mx, tr, root):
    a, b = _pair(tr, root)
    plan = mx.fault.FaultPlan({"seed": 3, "rules": [
        {"site": "transport.send", "kind": "partition", "times": 0,
         "where": {"peer": "1"}}]})
    with mx.fault.active_plan(plan):
        with pytest.raises(ConnectionError, match="peer 1"):
            a.send(1, "x")
    assert b.recv() == []
    assert a.stats()["send_failures"] == 1
    a.send(1, "x", meta={"i": 1})
    got = _drain(b, 1)
    assert got[0].meta["i"] == 1
    return _msgs(got), _events(plan), a.stats()


def slow_link(mx, tr, root):
    a, b = _pair(tr, root)
    plan = mx.fault.FaultPlan({"seed": 3, "rules": [
        {"site": "transport.send", "kind": "slow_link", "delay_s": 0.05,
         "times": 1}]})
    with mx.fault.active_plan(plan):
        t0 = time.monotonic()
        a.send(1, "x")
        assert time.monotonic() - t0 >= 0.05
    got = _drain(b, 1)
    assert len(got) == 1
    return _msgs(got), _events(plan)


def lost_ack(mx, tr, root):
    a, b = _pair(tr, root)
    plan = mx.fault.FaultPlan({"seed": 5, "rules": [
        {"site": "transport.send.ack", "kind": "lost_ack", "times": 2}]})
    with mx.fault.active_plan(plan):
        a.send_reliable(1, "grad", meta={"n": 1})
    got = b.recv()
    assert len(got) == 1 and got[0].meta["n"] == 1
    s = b.stats()
    assert s["received"] == 1 and s["duplicates_dropped"] == 2
    assert a.stats()["resent"] == 2
    return _msgs(got), _events(plan), a.stats(), s


def reorder(mx, tr, root):
    a, b = _pair(tr, root)
    plan = mx.fault.FaultPlan({"seed": 7, "rules": [
        {"site": "transport.send", "kind": "reorder", "times": 1}]})
    with mx.fault.active_plan(plan):
        a.send(1, "x", meta={"i": 1})
        assert b.recv() == []
        a.send(1, "x", meta={"i": 2})
    got = _drain(b, 2)
    assert [m.meta["i"] for m in got] == [2, 1]
    assert a.stats()["reordered"] == 1
    return _msgs(got), _events(plan), a.stats()


def reorder_last(mx, tr, root):
    a, b = _pair(tr, root)
    plan = mx.fault.FaultPlan({"seed": 7, "rules": [
        {"site": "transport.send", "kind": "reorder", "times": 1}]})
    with mx.fault.active_plan(plan):
        a.send(1, "x", meta={"i": 1})
        assert b.recv() == []
        a.close()
    got = _drain(b, 1)
    assert got[0].meta["i"] == 1
    return _msgs(got), _events(plan)


def recv_reorder(mx, tr, root):
    a, b = _pair(tr, root)
    a.send(1, "x", meta={"i": 1})
    a.send(1, "x", meta={"i": 2})
    plan = mx.fault.FaultPlan({"seed": 1, "rules": [
        {"site": "transport.recv", "kind": "reorder", "times": 1}]})
    with mx.fault.active_plan(plan):
        first = b.recv()
        assert [m.meta["i"] for m in first] == [2]
        second = b.recv()
        assert [m.meta["i"] for m in second] == [1]
    return _msgs(first), _msgs(second), _events(plan), b.stats()


def recv_partition(mx, tr, root):
    a, b = _pair(tr, root)
    a.send(1, "x", meta={"i": 1})
    a.send(1, "x", meta={"i": 2})
    plan = mx.fault.FaultPlan({"seed": 1, "rules": [
        {"site": "transport.recv", "kind": "partition", "times": 1}]})
    with mx.fault.active_plan(plan):
        assert b.recv() == []
        assert b.pending() == 2
        got = b.recv()
        assert [m.meta["i"] for m in got] == [1, 2]
    return _msgs(got), _events(plan)


def backpressure(mx, tr, root):
    a = tr.SpoolTransport(root, 0, 2, cap=1, admit_timeout=0.2)
    tr.SpoolTransport(root, 1, 2)
    a.send(1, "x")
    with pytest.raises(tr.InboxFull, match="backpressure"):
        a.send(1, "x")
    with pytest.raises(tr.InboxFull):
        a.send_reliable(1, "x", retries=5)
    assert a.stats()["resent"] == 0
    return a.stats(), a.pending(1)


def epoch(mx, tr, root):
    b = tr.SpoolTransport(root, 1, 2)
    tr.SpoolTransport(root, 0, 2, epoch=1).send(1, "x", meta={"gen": 1})
    tr.SpoolTransport(root, 0, 2, epoch=2).send(1, "x", meta={"gen": 2})
    got = _drain(b, 2)
    assert sorted(m.meta["gen"] for m in got) == [1, 2]
    assert {(m.sender, m.seq) for m in got} == {(0, 1)}
    assert b.stats()["duplicates_dropped"] == 0
    return sorted((m.epoch, m.meta["gen"]) for m in got)


def replay(mx, tr, root):
    plan = mx.fault.FaultPlan({"seed": 11, "rules": [
        {"site": "transport.send", "kind": "partition", "p": 0.2,
         "times": 0},
        {"site": "transport.send", "kind": "slow_link", "delay_s": 0.0,
         "p": 0.2, "times": 0},
        {"site": "transport.send.ack", "kind": "lost_ack", "p": 0.2,
         "times": 0},
        {"site": "transport.recv", "kind": "reorder", "p": 0.2,
         "times": 0}]}, trace=True)
    a, b = _pair(tr, root)
    delivered = []
    with mx.fault.active_plan(plan):
        for i in range(40):
            try:
                a.send(1, "x", meta={"i": i})
            except ConnectionError:
                pass
            delivered += [m.meta["i"] for m in b.recv()]
        delivered += [m.meta["i"] for m in b.recv()]
    injected = plan.stats()["injected"]
    assert {i["kind"] for i in injected} == {"partition", "slow_link",
                                            "lost_ack", "reorder"}
    assert plan.replay() == injected
    return [(i["site"], i["kind"], i.get("hit")) for i in injected], \
        delivered


def a_torch_tensor_crosses_as_numpy(mx, tr, root):
    """The port's own case: a torch tensor (or an NDArray) goes to the
    host once at send and arrives as numpy; the JAX package sends numpy."""
    a, b = _pair(tr, root)
    v = np.arange(6, dtype=np.float32).reshape(2, 3)
    payload = torch.from_numpy(v) if mx is mxnet_tpu_torch else v
    a.send_reliable(1, "x", arrays={"v": payload})
    got = _drain(b, 1)
    assert isinstance(got[0].arrays["v"], np.ndarray)
    return _msgs(got)


CASES = [roundtrip, partition, slow_link, lost_ack, reorder, reorder_last,
         recv_reorder, recv_partition, backpressure, epoch, replay,
         a_torch_tensor_crosses_as_numpy]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_the_port_transport_matches_the_jax_package(case, tmp_path):
    recs = {}
    for name, (mx, tr) in PKGS.items():
        root = str(tmp_path / name)
        os.makedirs(root)
        recs[name] = case(mx, tr, root)
        mx.fault.uninstall()
    assert recs["torch"] == recs["jax"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_spool_files_cross_between_the_packages(writer, reader, tmp_path):
    """A message one package publishes (npz payload, JSON meta, the
    frame's name) is delivered by the other, ids and dedup included, and
    a custom inbox map (the kvstore's push/) is the same path."""
    root = str(tmp_path)
    w = PKGS[writer][1].SpoolTransport(root, 0, 2, epoch=7)
    r = PKGS[reader][1].SpoolTransport(root, 1, 2)
    v = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    w.send(1, "grad", meta={"key": "w", "n": 3}, arrays={"grad": v})
    got = _drain(r, 1)
    assert _msgs(got) == [(0, 1, "grad", {"key": "w", "n": 3},
                           {"grad": v.tolist()})]
    assert got[0].epoch == 7
    w.send(1, "grad", meta={"key": "w", "n": 4}, _seq=1)   # a resend
    assert r.recv() == [] and r.stats()["duplicates_dropped"] == 1
    names = {}
    for pkg in PKGS:
        t = PKGS[pkg][1].SpoolTransport(root, 0, 1, inbox=lambda k: "push")
        names[pkg] = t.inbox_dir(0)
    assert names["jax"] == names["torch"] == os.path.join(root, "push")
