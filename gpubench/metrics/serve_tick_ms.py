"""The timed window over the engine's ticks in it (``stats()["ticks"]``),
ms."""

from gpubench.readers import serve_summary


def read(record):
    if not serve_summary(record) or not record.get("tick_s"):
        return None
    return 1e3 * record["tick_s"]
