"""The probes' gathers and adds in the port: the plain versions of kernels K8
(``gather_rows``) and K9 (``add_scalar``) against each probe's own reference
construction, the wrappers' checks, and the probe entry point on the CPU at
reduced table and index counts."""

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


def test_probe_retimes_only_on_the_card():
    """On the CPU the probe times nothing, so it re-times nothing either."""
    results = gather_probe.main(["t3", "t6"], device="cpu", shrink=8, log=lambda m: None,
                                retimed=("t3", "t6"), samples=3)
    assert [r["name"] for r in results] == ["t3", "t6"]
    assert all(r["ok"] and r["plain_ok"] and "retimed" not in r for r in results)
