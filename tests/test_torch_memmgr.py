"""The memory manager and spill tiers of auron_tpu_torch against
auron_tpu's, on the CPU.

- A scripted sequence of consumers, updates, reservations and
  unregistrations (seeded) under the `largest` victim strategy gives,
  in the JAX `MemManager` and in the port's, the same victims in order,
  spill records (all but their times), `num_spills`, consumer and pool
  peaks, per-name totals, watermark crossings, reservations and
  spill-size histogram.
- The `rate` strategy ranks by wall time, so it is held to the JAX
  tests' own assertions
  (`test_memory_observability.py::test_spill_victim_ranked_by_freed_rate`,
  `::test_spill_victim_learns_from_history_end_to_end`).
- Both spill tiers round-trip flat and string columns bit for bit, and
  the file tier leaves no file behind after `release()` or garbage
  collection; a missing codec module raises, naming it.
- The per-query ledger's settings raise; an operator's peak lands in its
  counters; a task runs under the process's manager.
"""

import gc
import os
import sys

import numpy as np
import pytest
import torch

from auron_tpu import config as jconfig
from auron_tpu.memmgr import manager as jmm
from auron_tpu_torch.columnar.batch import from_numpy
from auron_tpu_torch.config import conf
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.memmgr import manager as pmm
from auron_tpu_torch.memmgr.spill import (
    FileSpill, HostMemSpill, SpillManager,
)

TINY_TRIGGER = {"auron.memory.spill.min.trigger.bytes": 1}


@pytest.fixture(autouse=True)
def _fresh_managers():
    yield
    jmm.reset_manager()
    pmm.reset_manager()


def _fake(base):
    class FakeConsumer(base):
        """Spill releases everything (or nothing, when sticky) and logs
        the reported freed bytes."""

        def __init__(self, name, spillable=True, sticky=False):
            super().__init__(name, spillable)
            self.freed_log = []
            self.sticky = sticky

        def spill(self):
            if self.sticky:
                self.freed_log.append(0)
                return 0
            freed = self.mem_used
            self.freed_log.append(freed)
            self.update_mem_used(0)
            return freed
    return FakeConsumer


def _script(seed: int, steps: int = 400):
    """A seeded sequence of manager operations."""
    rng = np.random.default_rng(seed)
    ops = []
    names = [f"C{i}" for i in range(6)]
    for i, name in enumerate(names):
        ops.append(("register", name, i % 5 != 4, i == 2))
    for _ in range(steps):
        r = rng.random()
        if r < 0.8:
            ops.append(("update", names[int(rng.integers(0, 6))],
                        int(rng.integers(0, 4000))))
        elif r < 0.87:
            ops.append(("reserve", f"r{int(rng.integers(0, 3))}",
                        int(rng.integers(0, 2000))))
        elif r < 0.92:
            ops.append(("release", None if rng.random() < 0.5
                        else f"r{int(rng.integers(0, 3))}"))
        else:
            name = names[int(rng.integers(0, 6))]
            ops += [("unregister", name), ("register", name, True, False)]
    return ops


def _replay(mm, ops):
    fake = _fake(mm.MemConsumer)
    mgr = mm.reset_manager(10_000)
    live = {}
    effective = []
    for op in ops:
        if op[0] == "register":
            _, name, spillable, sticky = op
            live[name] = mgr.register_consumer(
                fake(name, spillable, sticky))
        elif op[0] == "update":
            live[op[1]].update_mem_used(op[2])
        elif op[0] == "reserve":
            effective.append(mgr.add_reservation(op[1], op[2]))
        elif op[0] == "release":
            mgr.release_reservations(op[1])
        elif op[0] == "unregister":
            mgr.unregister_consumer(live[op[1]])
    drop = ("at", "wall_ns")
    stats = mgr.stats()
    return {
        "records": [{k: v for k, v in r.items() if k not in drop}
                    for r in mgr.spill_records()],
        "num_spills": mgr.num_spills,
        "peaks": {n: (c.mem_used, c.mem_peak) for n, c in live.items()},
        "totals": {n: {k: v for k, v in t.items() if k != "wall_ns"}
                   for n, t in mgr.consumer_totals().items()},
        "pool": (mgr.total_used, mgr.peak_used),
        "crossings": [{k: v for k, v in c.items() if k != "at"}
                      for c in stats["watermarks_crossed"]],
        "stats": {k: v for k, v in stats.items()
                  if k not in ("watermarks_crossed", "spill_wall_ns")},
        "reservations": effective,
        "histogram": mgr.spill_histogram(),
        "snapshot": mgr.consumer_snapshot(),
        "freed": {n: c.freed_log for n, c in live.items()},
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_arbitration_matches_the_reference(seed):
    kv = {"auron.memory.spill.victim.strategy": "largest",
          "auron.memory.spill.min.trigger.bytes": 500,
          "auron.memory.watermark.fractions": "0.3,0.6,0.9"}
    ops = _script(seed)
    with jconfig.conf.scoped(kv):
        want = _replay(jmm, ops)
    with conf.scoped(kv):
        got = _replay(pmm, ops)
    assert want["num_spills"] > 10 and want["crossings"]
    for key in want:
        assert got[key] == want[key], key


def test_spill_victim_ranked_by_freed_rate():
    """The JAX test of the same name, on the port's manager."""
    fake = _fake(pmm.MemConsumer)
    with conf.scoped(TINY_TRIGGER):
        mgr = pmm.reset_manager(10_000)
        mgr._by_name["Slow"] = {"registrations": 1, "peak": 0, "spills": 2,
                                "freed_bytes": 1000,
                                "wall_ns": 1_000_000_000}
        mgr._by_name["Fast"] = {"registrations": 1, "peak": 0, "spills": 2,
                                "freed_bytes": 1_000_000,
                                "wall_ns": 1_000_000}
        slow = mgr.register_consumer(fake("Slow"))
        fast = mgr.register_consumer(fake("Fast"))
        slow.mem_used = 5000
        fast.mem_used = 2000
        assert mgr._pick_spill_victim([slow, fast]) is fast
        new = mgr.register_consumer(fake("Fresh"))
        new.mem_used = 1500
        assert mgr._pick_spill_victim([slow, fast, new]) is new
        new2 = mgr.register_consumer(fake("Fresh2"))
        new2.mem_used = 1600
        assert mgr._pick_spill_victim([slow, new, new2]) is new2
        with conf.scoped({"auron.memory.spill.victim.strategy":
                          "largest"}):
            assert mgr._pick_spill_victim([slow, fast, new]) is slow


def test_spill_victim_learns_from_history_end_to_end():
    """The JAX test of the same name, on the port's manager."""
    fake = _fake(pmm.MemConsumer)
    with conf.scoped(TINY_TRIGGER):
        mgr = pmm.reset_manager(1000)
        sticky = mgr.register_consumer(fake("Sticky", sticky=True))
        sticky.update_mem_used(900)
        good = mgr.register_consumer(fake("Good"))
        good.update_mem_used(500)
        assert [r["consumer"] for r in mgr.spill_records()] == \
            ["Sticky", "Good"]
        assert [r["path"] for r in mgr.spill_records()] == \
            ["arbitration", "fallback"]
        good.update_mem_used(600)
        assert mgr.spill_records()[-1]["consumer"] == "Good"
        assert mgr.consumer_totals()["Sticky"]["spills"] == 1


def test_the_per_query_ledger_settings_raise():
    for kv in ({"auron.memory.query.budget.bytes": 1 << 20},
               {"auron.memory.spill.victim.strategy": "query"}):
        with conf.scoped(kv):
            with pytest.raises(NotImplementedError, match="items 16 and 18"):
                pmm.MemManager(1000)


def test_default_budget_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pmm.MemManager().budget == int(4 * (1 << 30) * 0.6)
    with conf.scoped({"auron.memory.budget.bytes": 12345}):
        assert pmm.MemManager().budget == 12345


# -- the spill tiers -------------------------------------------------------------

SCHEMA = Schema.of(Field("k", DataType.int64()), Field("x", DataType.float64()),
                   Field("s", DataType.string()), Field("b", DataType.bool_()),
                   Field("d", DataType.int32()))


def _batch(seed: int, n: int, width: int):
    rng = np.random.default_rng(seed)
    strs = np.array([bytes(rng.integers(0, 256, int(rng.integers(0, width)))
                           .astype(np.uint8)).decode("latin-1")
                     for _ in range(n)], dtype=object)
    arrays = [rng.integers(-2**62, 2**62, n), rng.normal(size=n), strs,
              rng.random(n) < 0.5, rng.integers(-2**31, 2**31, n,
                                                dtype=np.int32)]
    valid = [rng.random(n) >= 0.2 for _ in arrays]
    return from_numpy(SCHEMA, arrays, valid, device="cpu")


def _bits(b):
    out = [b.num_rows, b.capacity]
    for c in b.columns:
        out.append(c.data.numpy().tobytes())
        out.append(c.validity.numpy().tobytes())
        if hasattr(c, "lengths"):
            out.append(c.lengths.numpy().tobytes())
    return out


@pytest.mark.parametrize("tier,codec", [("host", None), ("file", "none"),
                                        ("file", "zlib")])
def test_spill_tiers_round_trip_bit_for_bit(tier, codec, tmp_path):
    batches = [_batch(1, 700, 12), _batch(2, 3000, 60), _batch(3, 1, 3)]
    sp = HostMemSpill() if tier == "host" else \
        FileSpill(str(tmp_path), codec)
    size = sp.write_batches(iter(batches))
    assert size == sp.size_bytes > 0
    for _ in range(2):      # a cross product reads a spill more than once
        back = list(sp.read_batches())
        assert [_bits(b) for b in back] == [_bits(b) for b in batches]
        assert [b.columns[2].width for b in back] == \
            [b.columns[2].width for b in batches]
    sp.release()
    assert not os.listdir(tmp_path)


def test_file_spill_is_removed_by_release_and_by_collection(tmp_path):
    with conf.scoped({"auron.spill.dir": str(tmp_path),
                      "auron.spill.host.memory.first": False}):
        mgr = SpillManager("t")
        a, b = mgr.new_spill(), mgr.new_spill()
        assert a.tier == b.tier == "file"
        for s in (a, b):
            s.write_batches([_batch(4, 100, 8)])
        assert len(os.listdir(tmp_path)) == 2
        mgr.release_all()
        assert not os.listdir(tmp_path) and len(mgr) == 0
        c = FileSpill()
        c.write_batches([_batch(5, 10, 8)])
        assert len(os.listdir(tmp_path)) == 1
        del c
        gc.collect()
        assert not os.listdir(tmp_path)


def test_host_tier_is_the_default():
    assert SpillManager().new_spill().tier == "host"
    assert conf.get("auron.spill.compression.codec") == "none"


def test_codecs_raise_and_never_fall_back(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="lz4"):
        FileSpill(str(tmp_path), "lz4")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        FileSpill(str(tmp_path), "zstd")
    assert not os.listdir(tmp_path)


# -- operators and tasks -----------------------------------------------------------

def test_a_task_runs_under_the_process_manager():
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.runtime.executor import execute_plan
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    schema = Schema.of(Field("k", DataType.int64()))
    res = ResourceRegistry()
    res.put("src", [([np.arange(5000)[::-1].copy()], [np.ones(5000, bool)])])
    plan = P.Sort(child=P.FFIReader(schema=schema, resource_id="src"),
                  sort_exprs=(E.SortExpr(child=E.col("k")),))
    mgr = pmm.reset_manager()
    out = execute_plan(plan, resources=res, device="cpu")
    assert out.metrics["mem_peak"] == 8192 * (8 + 1)   # capacity 8192
    assert mgr.peak_used == out.metrics["mem_peak"] and mgr.total_used == 0
    assert mgr.consumer_totals()["SortExec"]["registrations"] == 1
    assert [n for n, _ in out.operator_metrics] == ["SortExec",
                                                    "FFIReaderExec"]


def test_concurrent_updates_keep_the_pool_total():
    """Eight threads, each with its own consumer, update under a budget
    that forces spills (each thread may spill only its own consumer):
    the pool's total stays the sum of the consumers' usage."""
    import threading
    fake = _fake(pmm.MemConsumer)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with conf.scoped(TINY_TRIGGER):
            mgr = pmm.reset_manager(50_000)
            consumers = [mgr.register_consumer(fake(f"T{i}"))
                         for i in range(8)]

            def work(c, seed):
                rng = np.random.default_rng(seed)
                c._owner_thread = threading.get_ident()
                for n in rng.integers(0, 20_000, 2000):
                    c.update_mem_used(int(n))
            threads = [threading.Thread(target=work, args=(c, i))
                       for i, c in enumerate(consumers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert mgr.total_used == sum(c.mem_used for c in consumers)
            assert mgr.num_spills > 0
            assert all(r["consumer"] == r["requested_by"]
                       for r in mgr.spill_records())
    finally:
        sys.setswitchinterval(old)
