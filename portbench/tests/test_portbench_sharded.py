"""The ``sharded`` driver on the CPU: two gloo ranks (this process and one
spawned) at a tiny size, past the harness's look for cards. Sound, a run is
correct with both numbers at 0 and its readers find what they read; with a
fault planted in the ranks, correct comes out false; a rank that raises
ends the run with its traceback and leaves no process behind. The cell
waits outside BENCHMARK.json (``portbench/waiting/shell10-sharded.json``):
the tests add its entries to the file's as the change that adds it will."""

import os
import time

import pytest
import torch

import sharded_ranks
from portbench import harness, yardstick
from portbench.drivers import sharded

CPU = torch.device("cpu")
WAITING = harness.load_json(os.path.join(harness.BENCH_DIR, "waiting", "shell10-sharded.json"))
CELL = WAITING["workload"]["name"]
NEW = [m["name"] for m in WAITING["per_layer"]]


def bench() -> dict:
    """BENCHMARK.json with the waiting cell's entries added, as the change
    that adds the cell will add them."""
    b = harness.benchmark()
    b["workloads"].append(WAITING["workload"])
    for m in b["end_to_end"]:
        if m["name"] in WAITING["end_to_end"] and "workloads" in m:
            m["workloads"].append(CELL)
    b["per_layer"] += WAITING["per_layer"]
    return b


END_TO_END = [m["name"] for m in harness.cell_spec(bench(), CELL)["end_to_end"]]


def test_waiting_cell_is_whole():
    """Every reader of the waiting cell is there, every metric it names
    exists, and no entry of it is in BENCHMARK.json yet."""
    b = harness.benchmark()
    assert CELL not in {w["name"] for w in b["workloads"]}
    assert set(WAITING["end_to_end"]) <= {m["name"] for m in b["end_to_end"]}
    assert not set(NEW) & {m["name"] for m in b["per_layer"]}
    for m in WAITING["per_layer"]:
        assert m["workloads"] == [CELL] and m["moves"] in WAITING["end_to_end"]
        assert callable(harness.reader(m["name"]))
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "limits", CELL + ".json"))


@pytest.fixture
def spec(tiny):
    """The cell on 2 ranks at the tiny size (36 rows, 18 a rank), a flag
    every 4 frames."""
    spec = tiny(CELL, bench())
    spec["cell"]["chips"] = 2
    spec["traffic"].update(flag_every=4)
    return spec


def spawned_ranks() -> list[int]:
    """This process's children that are spawned ranks (not the resource
    tracker), alive or not yet reaped."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if ppid == os.getpid() and b"spawn_main" in cmd:
            out.append(int(pid))
    return out


def execute(spec, trace=False, seconds=0.6):
    return harness.execute(spec, 2**31 + 77, seconds, trace, CPU, time.perf_counter())


def line_of(spec, run, trace=False):
    return harness.result_line(spec, run, trace, {"platform": "cpu", "kind": "cpu", "count": 2})


def with_fault(spec, monkeypatch, fault, ranks):
    spec["traffic"].update(test_fault=fault, test_fault_ranks=list(ranks))
    monkeypatch.setattr(sharded, "HELPER", sharded_ranks.faulty_helper)
    if 0 in ranks:
        sharded_ranks.plant(fault, monkeypatch.setattr)
    return spec


def test_sound_run_is_correct(spec):
    run = execute(spec)
    line = line_of(spec, run)
    assert line["correct"], line["checks"]
    assert line["checks"]["frame_diff_pct"]["value"] == 0
    assert line["checks"]["rank_frame_off"]["value"] == 0
    assert line["attempted"] == run.window.count and line["attempted"] % 4 == 0
    assert [d["frames"] for d in run.details] == [line["attempted"]] * 2
    assert set(line["metrics"]) == set(END_TO_END) == {"frame_ms", "setup_s"}
    assert list(line)[-1] == "checks"
    assert not spawned_ranks()


def test_traced_run_feeds_every_reader(spec):
    run = execute(spec, trace=True)
    assert line_of(spec, run, trace=True)["correct"]
    assert harness.reader("frame_ms")(run) == pytest.approx(
        1e3 * run.window.length / run.window.count)
    assert len(run.rank_traces) == 2 and run.rank_traces[1]["ops"] == spec["traffic"]["profile_ops"]
    # The CPU's trace holds no device kernel: nothing for the kernel readers.
    for name in (n for n in NEW if not n.startswith("device_idle")):
        assert harness.reader(name)(run) is None
    # A card's: K1 and NCCL's all-gather on each rank, ms a frame.
    k1 = "void (anonymous namespace)::trace_kernel<true, 1, 2, false, false>(Args)"
    gather = "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
    ops = spec["traffic"]["profile_ops"]
    for t, (k1_ms, gather_ms) in zip(run.rank_traces, [(0.1, 0.5), (0.3, 0.2)]):
        t["by_name"] = {k1: k1_ms * ops * 1e-3, gather: gather_ms * ops * 1e-3, "other": 1.0}
    run.trace["busy_s"] = 0.25 * run.trace["window_s"]
    bound_ms = 1e3 * yardstick.gather_frame_bytes(64 * 36, 2) / yardstick.NVLINK_BYTES_PER_S
    want = {"gather_ms.sharded": 0.2, "gather_roofline.sharded": 100 * bound_ms / 0.2,
            "k1_ms.sharded": 0.3, "k1_imbalance.sharded": 150.0, "device_idle.sharded": 75.0}
    got = line_of(spec, run, trace=True)["metrics"]
    assert set(got) == set(NEW)
    for name, value in want.items():
        assert got[name]["value"] == pytest.approx(value), name


def test_ranks_start_the_traced_stretch_together(spec, monkeypatch):
    """Rank 1's profiler is ready 2 s after rank 0's: rank 0's stretch
    starts only then, and does not count the wait in its first gather."""
    run = execute(with_fault(spec, monkeypatch, "late_profiler", (1,)), trace=True)
    assert line_of(spec, run, trace=True)["correct"]
    assert all(t["window_s"] < 1.0 for t in run.rank_traces), \
        [t["window_s"] for t in run.rank_traces]


@pytest.mark.parametrize("fault,ranks", [("altered", (0, 1)), ("half", (0, 1)),
                                         ("no_exchange", (0, 1))])
def test_broken_frames_are_caught(spec, monkeypatch, fault, ranks):
    line = line_of(spec, execute(with_fault(spec, monkeypatch, fault, ranks)))
    assert not line["correct"] and line["checks"]["frame_diff_pct"]["value"] > 5
    if fault == "no_exchange":
        assert line["checks"]["rank_frame_off"]["value"] > 0


def test_one_ranks_altered_gather_is_caught(spec, monkeypatch):
    line = line_of(spec, execute(with_fault(spec, monkeypatch, "alter_gathered", (1,))))
    checks = line["checks"]
    assert not line["correct"] and checks["rank_frame_off"]["value"] > 0
    assert checks["frame_diff_pct"]["value"] == 0  # rank 0's frames are sound


def test_a_rank_that_raises_ends_the_run(spec, monkeypatch):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        execute(with_fault(spec, monkeypatch, "raise", (1,)), seconds=30.0)
    assert "Traceback" in str(err.value) and "planted fault" in str(err.value)
    assert not spawned_ranks()
    assert not torch.distributed.is_initialized()


def test_a_rank_that_loads_the_jax_package_ends_the_run(spec, monkeypatch):
    with pytest.raises(RuntimeError, match="JAX or the JAX package loaded on ranks"):
        execute(with_fault(spec, monkeypatch, "forbidden", (1,)))
    assert not spawned_ranks()


def test_gather_frame_bytes_by_hand():
    # 1080p over 4 ranks: each receives the other 3 ranks' 518,400 rays,
    # 42 B of result and 3 B of u8 pixel each.
    assert yardstick.gather_frame_bytes(1920 * 1080, 4) == 3 * 518_400 * 45 == 69_984_000
    assert yardstick.gather_frame_bytes(10, 1) == 0
    assert yardstick.gather_frame_bytes(8, 2) == 4 * 45
    assert abs(69_984_000 / yardstick.NVLINK_BYTES_PER_S - 155.52e-6) < 1e-12


def test_control_fails_the_check(spec):
    """The reference in bfloat16 in the program's place fails
    ``frame_diff_pct`` on the frames that the sound run passes with."""
    from portbench import control

    run = execute(spec)
    assert all(v <= lim for v, lim in run.checks.values()), run.checks
    assert control.control(run)["frame_diff_pct"] > run.checks["frame_diff_pct"][1]
