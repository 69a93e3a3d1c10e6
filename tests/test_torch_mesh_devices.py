"""The worker mesh on a node's devices: which device each worker runs on.

``repro_torch.device.worker_devices`` maps N workers onto the cards a
session sees, as the JAX package's ``worker_mesh`` takes
``jax.devices()[:n]``: worker i on card i while there are cards enough,
contiguous groups of logical workers on a card beyond that, every worker
on the CPU there; a card the machine does not have raises. The map is
pure, so these tests hand it a card count and need no card. The staged
runs here are on the CPU, where every worker is the CPU: they hold every
shard of every value to its worker's device, and the result to the
one-worker session's. The runs across cards are in
``tests/test_torch_gpu.py`` (marked ``gpu``; they skip below two cards).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import spmd
from repro_torch.core.api import Matrix, Session
from repro_torch.core.expr import Leaf, MergeFn
from repro_torch.core.partitioner import worker_mesh
from repro_torch.device import card_count, worker_devices


def _cards(*idx):
    return tuple(torch.device("cuda", i) for i in idx)


@pytest.mark.parametrize("n,cards,want", [
    (1, 4, (0,)),
    (2, 4, (0, 1)),
    (4, 4, (0, 1, 2, 3)),
    (3, 8, (0, 1, 2)),
    (8, 4, (0, 0, 1, 1, 2, 2, 3, 3)),
    (6, 4, (0, 0, 1, 2, 2, 3)),
    (5, 2, (0, 0, 0, 1, 1)),
    (4, 1, (0, 0, 0, 0)),
    (1, 1, (0,)),
])
def test_worker_to_card_map(n, cards, want):
    assert worker_devices(n, "cuda", cards=cards) == _cards(*want)
    # a session named on one of the cards maps its workers the same way
    assert worker_devices(n, f"cuda:{cards - 1}", cards=cards) == \
        _cards(*want)


@pytest.mark.parametrize("cards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 16])
def test_worker_to_card_map_fills_the_cards_in_order(n, cards):
    """Up to the card count one worker a card, the first n cards (the
    reference's ``jax.devices()[:n]``); beyond it every card holds a
    contiguous group and the groups differ by at most one worker."""
    idx = [d.index for d in worker_devices(n, "cuda", cards=cards)]
    assert len(idx) == n and idx == sorted(idx)
    if n <= cards:
        assert idx == list(range(n))
    else:
        sizes = np.bincount(idx, minlength=cards)
        assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_every_worker_is_the_cpu_on_the_cpu(n):
    cpu = torch.device("cpu")
    assert worker_devices(n, "cpu") == (cpu,) * n
    assert worker_devices(n, cpu, cards=0) == (cpu,) * n
    assert worker_mesh(n, "cpu").devices == (cpu,) * n
    assert card_count("cpu") == 1


def test_an_absent_card_raises():
    with pytest.raises(RuntimeError, match="card 4 requested but only 4"):
        worker_devices(2, "cuda:4", cards=4)
    with pytest.raises(RuntimeError, match="card 1 requested but only 1"):
        worker_devices(4, "cuda:1", cards=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker_devices(2, "cuda", cards=0)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="n >= 1"):
            worker_devices(bad, "cuda", cards=4)
    with pytest.raises(ValueError, match="unsupported device"):
        worker_devices(2, "meta")


@pytest.fixture
def four_cards(monkeypatch):
    """A machine with four cards, as the session and the map see it; no
    test using it touches a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


def test_session_on_four_cards_takes_one_worker_a_card(four_cards):
    s = Session(mode="dense", device="cuda")
    assert s.workers == card_count("cuda") == 4
    assert s.mesh.devices == _cards(0, 1, 2, 3)
    assert s.mesh.device == torch.device("cuda", 0)
    x = Matrix(s, Leaf("X", (16, 8), 1.0))
    assert s.physical_plan(x.t().multiply(x).plan).n_workers == 4
    s.n_workers = 8
    assert s.mesh.devices == _cards(0, 0, 1, 1, 2, 2, 3, 3)
    s.n_workers = 1
    assert s.mesh is None and s.workers == 1
    with pytest.raises(RuntimeError, match="card 5 requested"):
        Session(device="cuda:5", n_workers=2).mesh


def test_mesh_key_changes_with_the_devices(four_cards, monkeypatch):
    """Two sessions of four workers, one a card and all on one card: the
    keys differ, so neither reuses a plan staged for the other."""
    spread = Session(mode="dense", device="cuda", n_workers=4)
    assert spread.mesh.devices == _cards(0, 1, 2, 3)   # built once, here
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    packed = Session(mode="dense", device="cuda", n_workers=4)
    assert packed.mesh.devices == _cards(0, 0, 0, 0)
    assert spread._mesh_key() != packed._mesh_key()
    assert spread._mesh_key()[0] == ("cuda:0", "cuda:1", "cuda:2", "cuda:3")
    cpu = Session(mode="dense", device="cpu", n_workers=4)
    assert cpu._mesh_key() not in (spread._mesh_key(), packed._mesh_key())


def test_session_workers_default_to_the_reference_on_the_cpu():
    from repro.core.api import Session as RefSession
    assert Session(device="cpu").workers == RefSession().workers == 1
    assert Session(device="cpu").mesh is None


# ---------------------------------------------------------------------------
# Staged runs: every shard of every value on its worker's device.
# ---------------------------------------------------------------------------

@pytest.fixture
def shard_log(monkeypatch):
    """Every ``Sharded`` value made while the test runs."""
    log = []
    init = spmd.Sharded.__init__

    def record(self, *args, **kw):
        init(self, *args, **kw)
        log.append(self)
    monkeypatch.setattr(spmd.Sharded, "__init__", record)
    return log


def _pipeline(s, x, y):
    """``benchmarks/bench_dist_comm.py``'s ((σ(XᵀX) ⋈ Y) ⋈ Y) ⋈ Y."""
    k = y.shape[0]
    xm, ym = s.load(x, "X"), s.load(y, "Y")
    add = MergeFn("mesh_add", lambda a, b: a + b)
    mul = MergeFn("mesh_mul", lambda a, b: a * b)
    return (xm.t().multiply(xm).select(f"RID>=0 AND RID<={k - 1}")
            .join(ym, "RID=RID AND CID=CID", add)
            .join(ym, "RID=RID AND CID=CID", mul)
            .join(ym, "RID=CID AND CID=RID", add))


def _sparse_queries(s, rng, m=64, bs=8):
    """An overlay, a masked product, a masked aggregation and a V2V join
    (the COO root on operands gathered to worker 0)."""
    g = m // bs

    def blocky(live):
        keep = np.kron(rng.uniform(size=(g, g)) < live, np.ones((bs, bs)))
        v = np.where(rng.uniform(size=(m, m)) < 0.2,
                     np.round(rng.normal(size=(m, m)), 1), 0)
        return (v * keep).astype(np.float32)
    a = s.load(blocky(0.6), "A")
    b = s.load(blocky(0.7), "B")
    p = s.load(np.abs(blocky(0.4)), "P")
    w = s.load(np.abs(rng.normal(size=(m, 4))).astype(np.float32), "W")
    h = s.load(np.abs(rng.normal(size=(4, m))).astype(np.float32), "H")
    mul = MergeFn("mesh_prod", lambda x, y: x * y)
    return {"overlay": a.join(b, "RID=RID AND CID=CID", mul),
            "masked": p.emul(w.multiply(h)),
            "masked_agg": p.emul(w.multiply(h)).sum("r"),
            "v2v": a.join(b, "VAL=VAL", mul)}


def _value(out):
    return out.value if hasattr(out, "value") else out.to_dense()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_every_shard_lives_on_its_workers_device(shard_log, n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    y = rng.normal(size=(32, 32)).astype(np.float32)
    one = Session(block_size=8, mode="dense", device="cpu", n_workers=1)
    want = _pipeline(one, x, y).collect().value
    s = Session(block_size=8, mode="dense", device="cpu", n_workers=n)
    got = _pipeline(s, x, y).collect()
    assert s.mesh.devices == worker_devices(n, "cpu")
    dense = list(shard_log)
    torch.testing.assert_close(got.value, want, rtol=1e-5, atol=1e-4)

    one = Session(block_size=8, device="cpu", n_workers=1)
    wants = {k: _value(q.collect()) for k, q in
             _sparse_queries(one, np.random.default_rng(7)).items()}
    s = Session(block_size=8, device="cpu", n_workers=n)
    for name, q in _sparse_queries(s, np.random.default_rng(7)).items():
        got = _value(q.collect())
        if name in ("overlay", "v2v"):
            assert torch.equal(torch.as_tensor(got),
                               torch.as_tensor(wants[name])), name
        else:
            torch.testing.assert_close(got, wants[name], rtol=1e-5,
                                       atol=1e-5)
    assert dense and len(shard_log) > len(dense)
    for sh in shard_log:
        assert sh.n == n and sh.devices == s.mesh.devices, sh.shape
