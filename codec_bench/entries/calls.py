"""The call record every entry hands the harness."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Call:
    """The argument of one call, built in set-up.  ``ids``: the pool
    batches it carries, in order; ``data``: what the entry is handed;
    ``bytes_in``: the bytes it is handed (compressed for an inflate,
    payloads for an encode)."""
    ids: list
    data: object
    bytes_in: int
