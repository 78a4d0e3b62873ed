"""The timed window's useful positions' operations (prompt tokens fed
and tokens generated, not the tick's padding) over the window's
host-clock time and the card's bf16 peak, %."""

from gpubench.readers import serve_summary


def read(record):
    if not serve_summary(record) or not record.get("peaks"):
        return None
    return (100.0 * record["work"]["flops"] / record["window_s"]
            / record["peaks"][0])
