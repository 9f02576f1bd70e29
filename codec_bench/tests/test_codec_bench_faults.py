"""The comparison that decides ``correct`` fails what it must: each cell
run whole on the CPU at a tiny size with the timed path broken underneath
(the card's look skipped), and each cell's control, the reference with a
guarantee broken, in the program's place.

The faults a cell of one card can have: a step that leaves its output as
it found it, half of the batch left out, a byte or a bit altered where it
is produced.  (No cell exchanges anything between cards.)
"""

import json
import os

import pytest

from codec_bench import control, run
from codec_bench.tests import tiny

ROOT = tiny.ROOT
B = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in B["workloads"]]
WRONG = {"inflate": "lanes_wrong", "deflate": "streams_wrong"}


def _entry(name):
    import importlib

    wl = run.load_json(os.path.join(ROOT, "codec_bench", "workloads",
                                    name + ".json"))
    return wl, importlib.import_module(f"codec_bench.entries.{wl['entry']}")


def _break_output(monkeypatch, name, how):
    """Patch the stage that writes the cell's output: the host resolver,
    the card's resolver or the bit-pack.  ``how``: "unwritten" or
    "altered"."""
    from defl_tpu_torch.ops import huffman_pack
    from defl_tpu_torch.runtime import native, session

    wl, _ = _entry(name)
    if wl["entry"] == "device_deflate":
        orig = huffman_pack.pack_fields

        def pack(*a, **k):
            words, rest = orig(*a, **k)
            if how == "unwritten":
                words.zero_()
            else:
                words[0, 1] ^= 1 << 20
            return words, rest
        monkeypatch.setattr(huffman_pack, "pack_fields", pack)
    elif wl["params"].get("resolve") == "device":
        orig = session.resolve_tokens

        def resolve(*a, **k):
            out = orig(*a, **k)
            if how == "unwritten":
                out.zero_()
            else:
                out[0, 0] ^= 1
            return out
        monkeypatch.setattr(session, "resolve_tokens", resolve)
    else:
        orig = native.native_resolve_tokens

        def resolve(*a, **k):
            out = orig(*a, **k)
            if how == "unwritten":
                out[:] = 0
            else:
                out[0, 0] ^= 1
            return out
        monkeypatch.setattr(native, "native_resolve_tokens", resolve)


def _half(result):
    """The first half of every batch of a result, the rest left out."""
    if isinstance(result, tuple):
        h = len(result[0]) // 2
        return tuple(x[:h] for x in result)
    if result and isinstance(result[0], tuple):
        return [_half(b) for b in result]
    return result[: len(result) // 2]


def _run(name):
    r = run.run_cell(B, name, tiny.SEED, 0.3, False, device="cpu",
                     shrink=tiny.shrink_for(name))
    assert r is not None, "a forbidden module is loaded in this process"
    return r


@pytest.mark.parametrize("how", ["unwritten", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_an_output_broken_where_it_is_made_is_not_correct(
        monkeypatch, name, how):
    _break_output(monkeypatch, name, how)
    r = _run(name)
    assert r["correct"] is False
    wrong = WRONG[_entry(name)[1].KIND]
    assert r["checks"][wrong]["value"] > r["checks"][wrong]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_is_not_correct(monkeypatch, name):
    _, entry = _entry(name)
    call = entry.call
    monkeypatch.setattr(entry, "call", lambda *a: _half(call(*a)))
    r = _run(name)
    assert r["correct"] is False
    wrong = WRONG[entry.KIND]
    assert r["checks"][wrong]["value"] > 0


def test_the_cells_are_correct_unbroken():
    for name in CELLS:
        assert _run(name)["correct"] is True, name


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    r = control.readings(B, name, tiny.SEED, tiny.shrink_for(name))
    assert r["correct"] is False
    failed = [n for n, c in r["checks"].items() if c["value"] > c["limit"]]
    wl, _ = _entry(name)
    assert failed == (["size_vs_zlib6_pct"] if wl["entry"] == "device_deflate"
                      else ["lanes_wrong", "window_lanes_not_ok"])
