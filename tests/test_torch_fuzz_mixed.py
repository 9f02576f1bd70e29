"""``defl_tpu_torch.malformed`` on the kernels' plain versions: what
chip_smoke.py [11] and ``tests/soak_torch_differential.py --sanitizer``
run on the card, at a small size on the CPU.

A batch of the bench corpus with every 8th lane swapped for a malformed
stream goes through ``device_inflate(device="cpu")`` with either resolver:
every lane must have the port oracle's class and, when OK, its bytes
(the oracle is held against ``defl_tpu``'s by tests/test_torch_fuzz.py),
and the corpus lanes must end where they end in the clean batch.  The
stream of the payloads joined, with bit flips and a cut tail, goes through
``inflate_large(use_device=True, device="cpu")`` and the host-parallel
engine: the same class.  Exact comparisons.
"""

import pytest

from defl_tpu_torch import corpus, malformed
from defl_tpu_torch.errors import Result


@pytest.mark.parametrize("seed", [11, 12])
def test_malformed_check_holds_on_the_plain_versions(seed):
    rec = malformed.run(lanes=16, block=1024, seed=seed, device="cpu")
    assert rec["ok"], rec
    assert rec["malformed_lanes"] == 2
    for resolve in ("resolve_host", "resolve_device"):
        r = rec[resolve]
        assert r["n_differ"] == 0 and r["corpus_lanes_moved"] == []
        assert r["classes"]["0"] >= 14 and r["host_fallbacks"] == 0
    assert rec["large"]["same"] and rec["large"]["class"] != int(Result.OK)


def test_a_corpus_lane_that_moved_fails_the_check(monkeypatch):
    """The check is no tautology: a decode that leaves one corpus lane of
    the mixed batch short of where the clean batch ends it is reported."""
    from defl_tpu_torch.runtime import session

    real = session.device_inflate
    calls = []

    def short_one_lane(streams, *a, **k):
        res, outs, st = real(streams, *a, **k)
        calls.append(len(streams))
        if len(calls) > 1:                  # the mixed batch, not the clean
            st = dict(st, bitpos=st["bitpos"].copy())
            st["bitpos"][1] -= 8
        return res, outs, st

    monkeypatch.setattr(session, "device_inflate", short_one_lane)
    rec = malformed.run(lanes=16, block=1024, seed=11, device="cpu")
    assert not rec["ok"]
    assert rec["resolve_host"]["corpus_lanes_moved"] == [1]


def test_mutate_is_seeded_and_cuts_in_the_second_half():
    data = bytes(range(256)) * 8
    a = malformed.mutate(data, 5, 4, cut=True)
    assert a == malformed.mutate(data, 5, 4, cut=True)
    assert len(data) // 2 <= len(a) < len(data) and a[:2] == data[:2]
    b = malformed.mutate(data, 5, 4, cut=False)
    assert len(b) == len(data) and 1 <= sum(x != y for x, y in
                                            zip(b, data)) <= 4
    assert corpus.VALID == 0
