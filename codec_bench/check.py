"""The comparison that decides ``correct``: the kept calls' answers against
the reference, and every call's lane statuses, each number beside its
limit."""

from __future__ import annotations

from codec_bench.reference import deflate as ref_deflate
from codec_bench.reference import inflate as ref_inflate


def expected_inflate(pool) -> list[list[bytes]]:
    """The reference's output for every batch of the pool.  The traffic
    holds valid streams only: a stream the reference refuses, or whose
    output is not its payload, is a fault of the generator and raises."""
    out = []
    for j, b in enumerate(pool):
        exp = ref_inflate.inflate_all(b.streams)
        if exp != b.raw:
            raise RuntimeError(f"pool batch {j}: the reference's output is "
                               f"not the generated payloads")
        out.append(exp)
    return out


def numbers(kind, entry, pool, kept, not_ok: int, level: int) -> dict:
    """{name: value} of the numbers compared.  ``kept``: [(call, result)]
    sampled from the window; ``not_ok``: the window's lanes whose status
    was not OK (every stream of the traffic is valid); ``level``: the zlib
    level whose size an encode is held to."""
    got = {"window_lanes_not_ok": not_ok}
    if kind == "inflate":
        exp = expected_inflate(pool)
        got["lanes_wrong"] = sum(
            ref_inflate.lanes_wrong(ok, outs, exp[i])
            for c, r in kept for i, ok, outs in entry.lanes(c, r))
        return got
    sizes: dict[int, int] = {}
    wrong = out_bytes = ref_bytes = 0
    for c, r in kept:
        for i, _, outs in entry.lanes(c, r):
            if i not in sizes:
                sizes[i] = sum(ref_deflate.zlib_sizes(pool[i].raw, level))
            wrong += ref_deflate.streams_wrong(outs, pool[i].raw)
            out_bytes += sum(map(len, outs))
            ref_bytes += sizes[i]
    got["streams_wrong"] = wrong
    got["size_vs_zlib6_pct"] = (100.0 * (out_bytes / ref_bytes - 1.0)
                                if ref_bytes else None)
    return got


def judge(got: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit; a number without one, or not read, fails."""
    checks = {}
    ok = True
    for name in sorted(set(got) | set(limits)):
        v, lim = got.get(name), limits.get(name)
        checks[name] = {"value": v, "limit": lim}
        ok = ok and v is not None and lim is not None and v <= lim
    return ok, checks
