"""The probes' gathers and adds in the port: the plain versions of kernels K8
(``gather_rows``) and K9 (``add_scalar``) against each probe's own reference
construction, the wrappers' checks, and the probe entry point on the CPU at
reduced table and index counts."""

import re

import numpy as np
import pytest
import torch

from octree_tracer_tpu_torch import state
from octree_tracer_tpu_torch.probes import gather, gather_probe

W = 1 << 10  # the probes' 2^18 indices, reduced


def _arange(rows, width):
    return np.arange(rows * width, dtype=np.uint32).reshape(rows, width)


def _gather(table, starts, rows=1):
    return state.to_numpy_u32(gather.gather_rows(state.u32_to_device(table, "cpu"),
                                                 np.asarray(starts), rows))


def _rng():
    return np.random.default_rng(0)


def _p4(g=1 << 12):
    """gather_probe.py:183-186 (and :359-362 of P5): table[idx] of an
    arange table."""
    table = _arange(g, 8)
    idx = _rng().integers(0, g, W, dtype=np.int32)
    return _gather(table, idx), table[idx]


def _t5():
    """pallas_min_probe.py:100-113: 128-row blocks by index."""
    x = _arange(1024, 128)
    s = np.asarray([3, 1, 7, 0, 2, 2, 5, 4], np.int32)
    return _gather(x, s * 128, 128), x.reshape(8, 128, 128)[s].reshape(1024, 128)


def _t9():
    """pallas_min_probe.py:211-226: 64 random 8-word rows."""
    x = _arange(1024, 8)
    s = _rng().integers(0, 1024, 64, dtype=np.int32)
    return _gather(x, s), x[s]


def _t11():
    """pallas_min_probe.py:314-332: the sum of column 0 of the gathered rows
    of a row-filled table is the sum of the indices."""
    g = 1 << 10
    x = np.repeat(np.arange(g, dtype=np.uint32)[:, None], 128, axis=1)
    idx = _rng().integers(0, g, W, dtype=np.int32)
    got = _gather(x, idx)
    want = np.uint32(idx.astype(np.uint64).sum() & 0xFFFFFFFF)
    return np.asarray([got[:, 0].sum(dtype=np.uint32)]), np.asarray([want])


GATHERS = {
    "p4 A/B/D": _p4,
    "p4 C": lambda: _p4(1 << 7),
    "t5": _t5,
    "t6": lambda: (_gather(_arange(1024, 128), [0], 128), _arange(1024, 128)[:128]),
    "t7": lambda: (_gather(_arange(1024, 128), [256], 128), _arange(1024, 128)[256:384]),
    "t8": lambda: (_gather(_arange(1024, 8), [77])[0], _arange(1024, 8)[77]),
    "t9": _t9,
    "t10": lambda: (_gather(_arange(1024, 128), [77])[0], _arange(1024, 128)[77]),
    "t10b": lambda: (_gather(_arange(1024, 128), [77], 8), _arange(1024, 128)[77:85]),
    "t11": _t11,
}


@pytest.mark.parametrize("case", sorted(GATHERS))
def test_gather_rows_equals_probe_reference(case):
    got, want = GATHERS[case]()
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


ADDS = {
    "t1": (np.zeros((8, 128), np.float32), 1.0, np.ones((8, 128), np.float32)),
    "t2": (np.zeros((8, 128), np.uint32), 1, np.ones((8, 128), np.uint32)),
    "t3": (np.zeros((1024, 128), np.uint32), 1, np.ones((1024, 128), np.uint32)),
    "u32 wrap": (np.full((4, 4), 0xFFFFFFFF, np.uint32), 2, np.ones((4, 4), np.uint32)),
    "u32 high c": (np.ones((4, 4), np.uint32), 0x80000000, np.full((4, 4), 0x80000001, np.uint32)),
}


def _device_x(x):
    return state.u32_to_device(x, "cpu") if x.dtype == np.uint32 else torch.from_numpy(x)


def _host(t, like):
    return state.to_numpy_u32(t) if like.dtype == np.uint32 else t.numpy()


@pytest.mark.parametrize("case", sorted(ADDS))
def test_add_scalar_equals_probe_reference(case):
    x, c, want = ADDS[case]
    np.testing.assert_array_equal(_host(gather.add_scalar(_device_x(x), c), x), want)


def test_add_scalar_device_scalar_t4():
    """pallas_min_probe.py:75-91: x + s[0] with s a prefetched i32[8]."""
    s = torch.arange(8, dtype=torch.int32) + 5
    x = np.arange(1024 * 128, dtype=np.uint32).reshape(1024, 128)
    got = gather.add_scalar(_device_x(x), s[:1])
    np.testing.assert_array_equal(state.to_numpy_u32(got), x + np.uint32(5))
    f = gather.add_scalar(torch.zeros(8, 128), torch.tensor([2.5]))
    assert torch.equal(f, torch.full((8, 128), 2.5))


def test_upload_starts_once_launch_many():
    table = state.u32_to_device(_arange(64, 8), "cpu")
    st = gather.upload_starts(np.asarray([3, 60], np.int64), "cpu")
    assert (st.lo, st.hi) == (3, 60) and st.tensor.dtype == torch.int32
    out = gather.gather_rows(table, st, rows=4)
    np.testing.assert_array_equal(state.to_numpy_u32(out),
                                  _arange(64, 8)[[3, 4, 5, 6, 60, 61, 62, 63]])
    assert gather.gather_rows(table, np.zeros(0, np.int32)).shape == (0, 8)


REJECTS = {
    "start past the table": (ValueError, lambda t: gather.gather_rows(t, [64])),
    "block past the table": (ValueError, lambda t: gather.gather_rows(t, [60], rows=5)),
    "negative start": (ValueError, lambda t: gather.gather_rows(t, [-1])),
    "float starts": (TypeError, lambda t: gather.gather_rows(t, np.asarray([1.0]))),
    "zero rows": (ValueError, lambda t: gather.gather_rows(t, [1], rows=0)),
    "i64 table": (TypeError, lambda t: gather.gather_rows(t.long(), [1])),
    "1-D table": (ValueError, lambda t: gather.gather_rows(t.reshape(-1), [1])),
    "strided table": (ValueError, lambda t: gather.gather_rows(t[:, ::2], [1])),
    "starts on another device": (ValueError, lambda t: gather.gather_rows(
        t, gather.Starts(torch.zeros(1, dtype=torch.int32, device="meta"), 0, 0))),
    "f64 add": (TypeError, lambda t: gather.add_scalar(t.double(), 1)),
    "u8 add": (TypeError, lambda t: gather.add_scalar(t.to(torch.uint8), 1)),
    "two-element c": (ValueError, lambda t: gather.add_scalar(t, t[0, :2].contiguous())),
    "f32 c for int32 x": (TypeError, lambda t: gather.add_scalar(t, torch.ones(1))),
    "c past 32 bits": (ValueError, lambda t: gather.add_scalar(t, 1 << 33)),
}


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_wrappers_reject(case):
    exc, call = REJECTS[case]
    table = state.u32_to_device(_arange(64, 8), "cpu")
    with pytest.raises(exc):
        call(table)


def test_gather_probe_main_on_cpu():
    lines = []
    results = gather_probe.main(device="cpu", shrink=8, log=lines.append)
    assert len(results) == 31
    assert {r["kernel"] for r in results} == {"gather_rows", "add_scalar"}
    ok_lines = [ln for ln in lines if "OK=" in ln]
    assert len(ok_lines) == len(results)
    assert all("OK=True plain=True" in ln for ln in ok_lines), ok_lines
    assert all(r["bound_ms"] > 0 and "ms" not in r for r in results)
    assert lines[0] == "device: cpu"


def test_gather_probe_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gather_probe.main(["t1"])
    with pytest.raises(ValueError, match="unknown"):
        gather_probe.main(["p2"], device="cpu")


def test_trace_steps_needs_the_card(monkeypatch, capsys):
    """The cross-tree K1 timer measures only on a card: without one it
    exits 1 before it starts a worker."""
    from octree_tracer_tpu_torch.probes import trace_steps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trace_steps.main(["no_such_tree"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_gather_trees_needs_the_card(monkeypatch, capsys):
    """The cross-tree K8/K9 timer, like K1's, exits 1 without a card."""
    from octree_tracer_tpu_torch.probes import gather_trees

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert gather_trees.main(["no_such_tree"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_kernel_steps_needs_the_card(monkeypatch, capsys):
    """The cross-tree K7/K3 timer, like K1's, exits 1 without a card."""
    from octree_tracer_tpu_torch.probes import kernel_steps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_steps.main(["no_such_tree"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_kernel_steps_k2_choice(monkeypatch, capsys):
    """The K2 choice times level 7 on two pools and reports the K2 source's
    ptxas lines; chosen alone it too exits 1 without a card, and a name
    outside the choices is refused."""
    from octree_tracer_tpu_torch.probes import kernel_steps

    assert kernel_steps.METRICS["k2"] == ("k2", "k2_chunk", "k2_l1", "k2_fill")
    assert kernel_steps.SOURCES["k2"] == "warp_occupancy"
    assert "k2" in kernel_steps.setup.__defaults__[0].split(",")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_steps.main(["no_such_tree", "--kernels", "k2"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        kernel_steps.main(["no_such_tree", "--kernels", "k2,k8"])


_PAYLOAD = """
import os, time
import marker

def setup(tag):
    def serve(request):
        return {"tree": marker.NAME, "request": request, "ns": time.monotonic_ns()}
    return {"tree": marker.NAME, "tag": tag, "cwd": os.path.basename(os.getcwd())}, serve
"""


def test_trees_run_times_each_tree_in_turn(tmp_path):
    """Each worker imports its own tree's code, and the trees answer every
    request in turn, in reverse order on alternate rounds."""
    from octree_tracer_tpu_torch.probes import trees

    dirs = []
    for name in ("old", "new"):
        d = tmp_path / name
        d.mkdir()
        (d / "marker.py").write_text(f"NAME = {name!r}\n")
        dirs.append(str(d))
    payload = tmp_path / "payload.py"
    payload.write_text(_PAYLOAD)
    ready, replies = trees.run(dirs, str(payload), ("x",), ("a", "b"), rounds=3)
    assert ready == [{"tree": "old", "tag": "x", "cwd": "old"},
                     {"tree": "new", "tag": "x", "cwd": "new"}]
    assert list(replies) == ["a", "b"]
    for request, per_tree in replies.items():
        assert [[r["tree"] for r in rounds] for rounds in per_tree] == [["old"] * 3, ["new"] * 3]
        assert all(r["request"] == request for rounds in per_tree for r in rounds)
        old, new = ([r["ns"] for r in rounds] for rounds in per_tree)
        assert old[0] < new[0] and new[1] < old[1] and old[2] < new[2]
    assert max(r["ns"] for r in replies["a"][0] + replies["a"][1]) < min(
        r["ns"] for r in replies["b"][0] + replies["b"][1])


def test_probe_retimes_only_on_the_card():
    """On the CPU the probe times nothing, so it re-times nothing either."""
    results = gather_probe.main(["t3", "t6"], device="cpu", shrink=8, log=lambda m: None,
                                retimed=("t3", "t6"), samples=3)
    assert [r["name"] for r in results] == ["t3", "t6"]
    assert all(r["ok"] and r["plain_ok"] and "retimed" not in r for r in results)


def _lines(names):
    return {r["name"]: r for r in gather_probe.main(names, device="cpu", shrink=8,
                                                    log=lambda m: None)}


def test_gather_bound_counts_distinct_rows():
    """K8's bytes: each distinct table row its starts reach read once, each
    output row written once, 4 bytes a start (t11g draws 1,024 rows of a
    128-row table at shrink 8; t5's starts repeat one 128-row block)."""
    lines = _lines(["t11g", "t5", "p1"])
    idx = np.random.default_rng(0).integers(0, 128, 1024, dtype=np.int32)
    distinct = np.unique(idx).size  # every row of the table is drawn
    assert lines["t11g"]["bytes"] == (distinct + 1024) * 128 * 4 + 4 * 1024
    assert lines["t11g"]["bytes"] < 2 * 1024 * 128 * 4  # not a table read a row
    assert lines["t5"]["bytes"] == (7 * 128 + 8 * 128) * 128 * 4 + 4 * 8
    # P1 takes its 16 sets in turn: a call's bytes are their mean.
    p1 = [r for name, r in lines.items() if name.startswith("P1")]
    assert len(p1) == 6
    g = p1[0]["table_rows"]
    rng = np.random.default_rng(0)
    sets = [rng.integers(0, g, 1024, dtype=np.int32) for _ in range(gather_probe.P1_SETS)]
    want = np.mean([(np.unique(s).size + 1024) * 32 + 4 * 1024 for s in sets])
    assert p1[0]["bytes"] == pytest.approx(want)


@pytest.mark.parametrize("starts, rows, w, distinct", [
    ([5, 5, 5], 1, 8, 1),
    ([0, 1, 2], 2, 8, 4),
    ([10, 3], 4, 128, 8),
])
def test_gather_bytes(starts, rows, w, distinct):
    n = len(starts)
    assert gather.gather_bytes(np.asarray(starts), rows, w) == (distinct + n * rows) * w * 4 + 4 * n


GATHER_PLANS = {
    # name: (g, w, n_starts, rows, table_addr, out_addr) -> fields
    "P4 A: 8-word rows of a 32 MiB table": (
        (1 << 20, 8, 1 << 18, 1, 0, 0),
        dict(design="tile", vector=True, row_units=2, seg=2, log_seg=1,
             blocks=(1 << 19) // (64 * 8), wide=False)),
    "P4 C: a 1 MiB table sits in the L2": (
        (1 << 15, 8, 1 << 18, 1, 0, 0),
        dict(design="flat", vector=True, seg=2, log_seg=1, blocks=(1 << 19) // 256)),
    "t11: 128-word rows": (
        (1 << 18, 128, 1 << 18, 1, 0, 0),
        dict(design="tile", row_units=32, seg=32, log_seg=5, wide=False,
             blocks=(1 << 23) // 512)),
    "t11g: a 16 MiB table is past a sixteenth of the L2": (
        (1 << 15, 128, 1 << 18, 1, 0, 0), dict(design="tile", seg=32)),
    "t13: 2^17 rows": ((1 << 18, 128, 1 << 17, 1, 0, 0), dict(design="tile", blocks=1 << 13)),
    "t10b: one block of 8 rows": (
        (1024, 128, 1, 8, 0, 0),
        dict(design="flat", seg=256, log_seg=8, blocks=1)),
    "t6: 128 rows": ((1024, 128, 1, 128, 0, 0), dict(design="flat", seg=4096, blocks=16)),
    "t9: 64 rows, one wave": ((1024, 8, 64, 1, 0, 0), dict(design="flat", seg=2, blocks=1)),
    "P1 128 MiB: 16 index sets of 8-word rows": (
        (1 << 22, 8, 1 << 18, 1, 0, 0), dict(design="tile", log_seg=1, wide=False)),
    "4-word rows: one vector a segment stays flat": (
        (1 << 22, 4, 1 << 20, 1, 0, 0), dict(design="flat", vector=True, seg=1, log_seg=0)),
    "width 3: words, no power of two": (
        (4000, 3, 777, 5, 0, 0),
        dict(design="flat", vector=False, row_units=3, seg=15, log_seg=-1,
             blocks=-(-777 * 15 // 256))),
    "misaligned table: words": (
        (4000, 4, 777, 5, 4, 0), dict(design="flat", vector=False, seg=20, log_seg=-1)),
    "misaligned output: words": ((4000, 4, 8, 4, 0, 8), dict(vector=False, log_seg=4)),
    "2^31 table vectors: 64-bit": ((1 << 30, 8, 1 << 18, 1, 0, 0), dict(wide=True)),
    "2^31 output vectors: 64-bit": ((1 << 20, 128, 1 << 26, 1, 0, 0),
                                    dict(design="tile", wide=True)),
}


@pytest.mark.parametrize("case", sorted(GATHER_PLANS))
def test_gather_plan(case):
    args, want = GATHER_PLANS[case]
    plan = gather.gather_plan(*args)
    assert {k: getattr(plan, k) for k in want} == want


@pytest.mark.parametrize("w, rows, table_addr", [
    (3, 1, 0),  # width 3 has no 16-byte vectors
    (8, 3, 0),  # a segment of 6 vectors is no power of two
    (8, 1, 4),  # a table off 16 bytes
])
def test_gather_plan_tiles_only_power_of_two_vector_segments(w, rows, table_addr):
    """A large gather out of a large table still takes the flat kernel where
    the tile kernel's shifts and 16-byte loads do not apply."""
    plan = gather.gather_plan(1 << 22, w, 1 << 18, rows, table_addr, 0)
    assert plan.design == "flat" and plan.blocks * gather.BLOCK >= (1 << 18) * plan.seg


ADD_PLANS = {
    # name: (n, addr) -> (head, n_vec, tail, blocks, wide)
    "t3": ((1024 * 128, 0), (0, 32768, 0, 128, False)),
    "t1": ((8 * 128, 0), (0, 256, 0, 1, False)),
    "odd length": ((4 * 4000 + 3, 0), (0, 4000, 3, 16, False)),
    "one element off 16 bytes": ((4 * 4000 + 3, 4), (3, 4000, 0, 16, False)),
    "two elements off, odd length": ((4 * 4000 + 1, 8), (2, 3999, 3, 16, False)),
    "three elements off": ((4 * 4000 + 1, 12), (1, 4000, 0, 16, False)),
    "shorter than the head": ((2, 8), (2, 0, 0, 1, False)),
    "empty": ((0, 0), (0, 0, 0, 0, False)),
    "one vector past a block": ((4 * 257, 0), (0, 257, 0, 2, False)),
    "2^31 elements: 64-bit": ((1 << 31, 0), (0, 1 << 29, 0, 1 << 21, True)),
}


@pytest.mark.parametrize("case", sorted(ADD_PLANS))
def test_add_plan(case):
    (n, addr), want = ADD_PLANS[case]
    assert tuple(gather.add_plan(n, addr)) == want


@pytest.mark.parametrize("addr", [1, 2, 3, 6])
def test_add_plan_rejects_unaligned(addr):
    """A 4-byte tensor lies on a 4-byte boundary; no plan serves another."""
    with pytest.raises(ValueError, match="4-byte"):
        gather.add_plan(100, addr)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_output_keeps_the_input_alignment(offset):
    x = torch.zeros(64, dtype=torch.int32)[offset:offset + 37]
    out = gather._empty_like_aligned_as(x)
    assert out.shape == x.shape and out.is_contiguous()
    assert out.data_ptr() % 16 == x.data_ptr() % 16


@pytest.mark.parametrize("dtype", ["f32", "u32"])
@pytest.mark.parametrize("view", ["odd length", "offset by one", "offset by two, odd"])
@pytest.mark.parametrize("on_device", [False, True])
def test_add_scalar_edges_match_numpy(dtype, view, on_device):
    """The K9 edge shapes chip_smoke.py checks on the card (a length that is
    no multiple of 4, views off a 16-byte boundary), here against NumPy."""
    rng = np.random.default_rng(7)
    n = 4 * 4000 + 4
    if dtype == "f32":
        base_np = rng.standard_normal(n).astype(np.float32)
        c = np.float32(0.75)
    else:
        base_np = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        c = np.uint32(0xFFFFFFFD)  # -3 modulo 2^32
    lo, hi = {"odd length": (0, n - 1), "offset by one": (1, n),
              "offset by two, odd": (2, n - 1)}[view]
    base = _device_x(base_np)
    x = base[lo:hi]
    scalar = (torch.tensor([c.view(np.int32) if dtype == "u32" else c]) if on_device
              else int(c) if dtype == "u32" else float(c))
    got = _host(gather.add_scalar(x, scalar), base_np)
    np.testing.assert_array_equal(got, base_np[lo:hi] + c)
    assert torch.equal(gather.add_scalar(x, scalar), gather.add_scalar_plain(x, scalar))


_PTXAS = """ptxas info    : Function properties for _ZN12_GLOBAL__N_112trace_kernelILb1ELi0ELi1ELb0ELb1ELb0EEEvNS_9TraceArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 58 registers, used 0 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_112trace_kernelILb1ELi2ELi0ELb0ELb0ELb0EEEvNS_9TraceArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 46 registers, used 0 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_112trace_kernelILb0ELi0ELi0ELb1ELb0ELb1EEEvNS_9TraceArgsE
    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 49 registers, used 0 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_112trace_kernelILb1ELi1ELi0ELb0ELb1ELb0EEEvNS_9TraceArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
"""


def test_trace_steps_forms_registers_and_summary():
    """The cross-tree K1 timer's host side: its metrics (the combined-table
    frame, the root form's four passes with and without the table, each
    scene's no-table, table and brick passes), the form names it reads
    from ptxas (also a tree's from before the root and brick flags), the
    registers it shows (the root form's counting and flag forms and the
    brick forms; the others as their largest), and one summary line a
    metric."""
    from octree_tracer_tpu_torch.probes import trace_steps as ts

    assert len(set(ts.METRICS)) == len(ts.METRICS) == 7 + 8 + 2 * 9
    assert {"root_none_counts", "root_comb_shadow_counts", "terrain_bricks_k4",
            "deep10_no_table", "terrain_bricks_root_counts"} <= set(ts.METRICS)
    assert ts.form_name("_ZN12_GLOBAL__N_112trace_kernelILb1ELi2ELi1ELb0ELb1ELb0EEEvNS_9Trace"
                        "ArgsE") == "s1t2v1h0r1b0"
    assert ts.form_name("_Z12trace_kernelILb0ELi1ELi2ELb1EEv9TraceArgs") == "s0t1v2h1"
    assert ts.form_name("_Z8k2_levelv") == "_Z8k2_levelv"
    shown, others = ts.register_lines(_PTXAS.splitlines())
    assert shown == {"s1t0v1h0r1b0": "58r/0+0s", "s0t0v0h1r0b1": "49r/4+8s"}
    assert others == 46
    samples = {"a": {m: [1.0, 3.0, 2.0] for m in ts.METRICS},
               "b": {m: [0.5] for m in ts.METRICS}}
    lines = ts.summary_lines(samples, ["a", "b"])
    assert len(lines) == len(ts.METRICS)
    assert lines[0] == "primary: a 2.0000 [1.0000, 3.0000]; b 0.5000 [0.5000, 0.5000]"
    combined, brick = ts.SASS_FORMS
    assert re.search(combined, "_ZN12_GLOBAL__N_112trace_kernelILb1ELi2ELi0ELb0ELb0ELb0EEEvNS_9"
                               "TraceArgsE")
    assert re.search(combined, "_Z12trace_kernelILb1ELi2ELi0ELb0EEv9TraceArgs")
    assert re.search(brick, "_ZN12_GLOBAL__N_112trace_kernelILb1ELi0ELi0ELb0ELb0ELb1EEEvNS_9"
                            "TraceArgsE")
    assert not re.search(brick, "_ZN12_GLOBAL__N_112trace_kernelILb1ELi0ELi1ELb0ELb0ELb1EEEv")


def test_trace_steps_digest_and_marks_by_depth():
    """Digests hash the tensors' bytes in order; marks by depth sum a visit
    array over the depth of each slot, slots no descent reaches left out."""
    from octree_tracer_tpu_torch.probes import trace_steps as ts

    a, b = torch.arange(6, dtype=torch.int32), torch.ones(3, dtype=torch.bool)
    assert ts.digest(a, b) == ts.digest(a.clone(), b.clone()) != ts.digest(b, a)
    assert len(ts.digest(a)) == 16
    counts = torch.tensor([3, 1, 0, 5, 7, 2], dtype=torch.int32)
    depths = np.array([0, 0, 1, 1, -1, 3], np.int32)
    assert ts.marks_by_depth(counts, depths) == [4, 5, 0, 2]
    assert ts.marks_by_depth(counts, np.full(6, -1, np.int32)) == []


def test_k1_counters_patch_and_card():
    """K1's counters patch the kernel's source at its anchors: the counters
    once after the include, the trip count at the top of the trip loop,
    every visit atomic counted (the kernel's atomics into the visit array);
    a source without the anchors is refused; the probe needs a card."""
    import os

    from octree_tracer_tpu_torch import kernels
    from octree_tracer_tpu_torch.probes import k1_counters

    with open(os.path.join(kernels.CSRC_DIR, "trace.cu")) as f:
        src = f.read()
    out = k1_counters.instrumented_source(src)
    assert out.count("__device__ unsigned long long g_k1_counters[8];") == 1
    assert out.count("k1_count_atomic(), atomicAdd(") == len(
        re.findall(r"atomicAdd\((a\.)?visits \+ ", src)) == 2
    assert out.count("k1_count_shared(), atomicAdd(top.count + ") == 1
    loop = out.index("    for (int it = 0; it < a.max_iters; ++it) {\n")
    assert out.index("atomicAdd(&g_k1_counters[0], 1ull);") > loop
    assert out.rstrip().endswith("}") and 'extern "C" int ot_k1_counters(' in out
    with pytest.raises(ValueError, match="anchors"):
        k1_counters.instrumented_source(src.replace('#include "common.cuh"\n', ""))
    assert k1_counters.split_share({"warp_trips": 8, "split_warp_trips": 2}) == 0.25
    assert k1_counters.split_share({"warp_trips": 0, "split_warp_trips": 0}) == 0.0


def test_k1_counters_needs_the_card(monkeypatch, capsys):
    from octree_tracer_tpu_torch.probes import k1_counters

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k1_counters.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


_START_PTXAS = _PTXAS + """ptxas info    : Function properties for _ZN12_GLOBAL__N_118trace_start_kernelILb1ELi2ELi0ELb0ELb0EEEvNS_9TraceArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_117trace_seed_kernelILb1ELi1ELb1ELb0EEEvNS_9TraceArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_113raygen_kernelENS_4Mat4EiiPfS1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 34 registers, used 0 barriers
"""


def test_k1_registers_forms_and_compare():
    """The cross-tree register check's host side: K1's forms by kernel and
    flags (the start and seed forms apart, other kernels left out), and the shared
    forms that differ between two trees' reports."""
    from octree_tracer_tpu_torch.probes import k1_registers as kr

    base, new = kr.forms(_PTXAS), kr.forms(_START_PTXAS)
    assert base["trace_kernel<1,0,1,0,1,0>"] == (58, 0, 0)
    assert base["trace_kernel<0,0,0,1,0,1>"] == (49, 4, 8)
    assert len(base) == 4 and len(new) == 6
    assert new["trace_start_kernel<1,2,0,0,0>"] == (48, 0, 0)
    assert new["trace_seed_kernel<1,1,1,0>"] == (40, 0, 0)
    assert kr.form("_ZN12_GLOBAL__N_113raygen_kernelENS_4Mat4EiiPfS1_") is None
    assert kr.compare(base, new) == ({}, ["trace_seed_kernel<1,1,1,0>",
                                          "trace_start_kernel<1,2,0,0,0>"])
    moved = dict(new, **{"trace_kernel<1,2,0,0,0,0>": (47, 0, 0)})
    assert kr.compare(base, moved)[0] == {"trace_kernel<1,2,0,0,0,0>": ((46, 0, 0), (47, 0, 0))}
