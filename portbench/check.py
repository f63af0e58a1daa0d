"""The decision of ``correct``, the same for every cell.

A driver (``drivers/<name>.py``) works out its own reference and reads each
item of the window against it (``reference``, ``readings``); the numbers it
reads are the keys of the configuration's ``"check"``, each with its limit.
``judge`` keeps each number's worst reading over the items and passes the
run when every one stays within its limit.  The control goes through the
same ``judge``.
"""

from __future__ import annotations


def judge(readings: list[dict], limits: dict) -> tuple[bool, dict]:
    """The worst reading of each number beside its limit, and whether all
    stay within; a run with no item to read is not correct."""
    worst = {name: 0.0 for name in limits}
    for r in readings:
        for name in limits:
            worst[name] = max(worst[name], r[name])
    ok = bool(readings) and all(worst[name] <= limits[name] for name in limits)
    return ok, {name: {"value": worst[name], "limit": limits[name]} for name in limits}
