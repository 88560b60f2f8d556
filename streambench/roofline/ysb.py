"""The least bytes the YSB cell's data needs, per kernel, counted from the
data (the reference's counts), never from a kernel's layout: each
aggregated record's key and event time read once (4 bytes each; a count
reads no value), each result cell (a count of a campaign in a window)
written once (4 bytes)."""

KEY_BYTES = 4
TIME_BYTES = 4
CELL_BYTES = 4


def least_bytes(kernel: str, data: dict):
    if kernel == "k1":
        return (data["aggregated_records"] * (KEY_BYTES + TIME_BYTES)
                + data["result_cells"] * CELL_BYTES)
    return None
